"""CurveZMQ (ZMTP CURVE mechanism) server-side security for the ZMQ output.

The reference enables ZMQ_CURVE_SERVER + ZMQ_CURVE_SECRETKEY on its PUB
socket (Outputs.cpp:75-93, key file read by encryption.c:26-40).  This
environment has no libzmq/libsodium, so the primitives are implemented here
from their specifications:

- X25519 (RFC 7748) with python integers - handshake only;
- Salsa20/HSalsa20/XSalsa20 (Bernstein's spec), numpy-vectorised over
  64-byte blocks for the per-message stream cipher;
- Poly1305 (RFC 8439) with python 130-bit integer arithmetic;
- crypto_box = XSalsa20-Poly1305 with an HSalsa20-derived precomputed key
  (NaCl construction);
- the CURVE handshake per rfc.zeromq.org/spec:25 (HELLO/WELCOME/INITIATE/
  READY) and MESSAGE encryption per spec:26;
- Z85 key encoding (rfc.zeromq.org/spec:32) - 40-char key files hold
  Z85-encoded 32-byte keys, exactly what libzmq accepts from the
  reference's key files.

All primitives are checked against published test vectors in
tests/test_curve.py.
"""
import os
import struct

import numpy as np

# ---------------- X25519 (RFC 7748) ----------------
_P = 2 ** 255 - 19
_A24 = 121665


def _clamp(k):
    k = bytearray(k)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return int.from_bytes(bytes(k), "little")


def x25519(k_bytes, u_bytes):
    """Scalar multiplication k*u -> 32 bytes (RFC 7748 section 5)."""
    k = _clamp(k_bytes)
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


def x25519_base(k_bytes):
    return x25519(k_bytes, (9).to_bytes(32, "little"))


def keypair():
    sk = os.urandom(32)
    return x25519_base(sk), sk


# ---------------- Salsa20 family ----------------
_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4").copy()


def _rotl(x, n):
    return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))).astype(np.uint32)


def _salsa20_rounds(state):
    """state: [n, 16] uint32; 20 rounds in place; returns worked copy."""
    x = state.copy()
    idx = [(4, 0, 12, 8), (9, 5, 1, 13), (14, 10, 6, 2), (3, 15, 11, 7),
           (1, 0, 3, 2), (6, 5, 4, 7), (11, 10, 9, 8), (12, 15, 14, 13)]
    for _ in range(10):
        for half in (idx[:4], idx[4:]):
            for a, b, c, d in half:
                x[:, a] ^= _rotl(x[:, b] + x[:, c], 7)
                x[:, d] ^= _rotl(x[:, a] + x[:, b], 9)
                x[:, c] ^= _rotl(x[:, d] + x[:, a], 13)
                x[:, b] ^= _rotl(x[:, c] + x[:, d], 18)
    return x


def _salsa20_blocks(key32, nonce8, counter0, nblocks):
    k = np.frombuffer(key32, dtype="<u4")
    n = np.frombuffer(nonce8, dtype="<u4")
    state = np.zeros((nblocks, 16), np.uint32)
    state[:, 0] = _SIGMA[0]
    state[:, 5] = _SIGMA[1]
    state[:, 10] = _SIGMA[2]
    state[:, 15] = _SIGMA[3]
    state[:, 1:5] = k[:4]
    state[:, 11:15] = k[4:]
    state[:, 6:8] = n
    ctr = counter0 + np.arange(nblocks, dtype=np.uint64)
    state[:, 8] = (ctr & 0xFFFFFFFF).astype(np.uint32)
    state[:, 9] = (ctr >> np.uint64(32)).astype(np.uint32)
    out = _salsa20_rounds(state) + state
    return out.astype("<u4").tobytes()


def hsalsa20(key32, in16):
    k = np.frombuffer(key32, dtype="<u4")
    n = np.frombuffer(in16, dtype="<u4")
    state = np.zeros((1, 16), np.uint32)
    state[0, 0] = _SIGMA[0]
    state[0, 5] = _SIGMA[1]
    state[0, 10] = _SIGMA[2]
    state[0, 15] = _SIGMA[3]
    state[0, 1:5] = k[:4]
    state[0, 11:15] = k[4:]
    state[0, 6:10] = n
    z = _salsa20_rounds(state)[0]
    out = np.empty(8, np.uint32)
    out[0], out[1], out[2], out[3] = z[0], z[5], z[10], z[15]
    out[4:8] = z[6:10]
    return out.astype("<u4").tobytes()


def xsalsa20_xor(data, nonce24, key32, counter0=0):
    subkey = hsalsa20(key32, nonce24[:16])
    nb = (len(data) + 63) // 64
    stream = _salsa20_blocks(subkey, nonce24[16:24], counter0, nb)
    d = np.frombuffer(data, np.uint8)
    s = np.frombuffer(stream[:len(data)], np.uint8)
    return (d ^ s).tobytes()


# ---------------- Poly1305 (RFC 8439) ----------------
def poly1305(msg, key32):
    r = int.from_bytes(key32[:16], "little") & 0x0ffffffc0ffffffc0ffffffc0fffffff
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        n = int.from_bytes(blk, "little") + (1 << (8 * len(blk)))
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


# ---------------- NaCl secretbox / box ----------------
def secretbox(m, nonce24, key32):
    """crypto_secretbox: returns 16-byte tag || ciphertext."""
    first = xsalsa20_xor(b"\x00" * 32 + m, nonce24, key32)
    mac_key, c = first[:32], first[32:]
    return poly1305(c, mac_key) + c


def secretbox_open(boxed, nonce24, key32):
    tag, c = boxed[:16], boxed[16:]
    subkey = hsalsa20(key32, nonce24[:16])
    block0 = _salsa20_blocks(subkey, nonce24[16:24], 0, 1)
    if poly1305(c, block0[:32]) != tag:
        raise ValueError("poly1305 tag mismatch")
    m = xsalsa20_xor(b"\x00" * 32 + c, nonce24, key32)[32:]
    return m


def box_beforenm(pk, sk):
    return hsalsa20(x25519(sk, pk), b"\x00" * 16)


def box_afternm(m, nonce24, k):
    return secretbox(m, nonce24, k)


def box_open_afternm(c, nonce24, k):
    return secretbox_open(c, nonce24, k)


# ---------------- Z85 (spec:32) ----------------
_Z85 = ("0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
        ".-:+=^!/*?&<>()[]{}@%$#")
_Z85_REV = {c: i for i, c in enumerate(_Z85)}


def z85_decode(s):
    if isinstance(s, bytes):
        s = s.decode("ascii")
    if len(s) % 5:
        raise ValueError("z85 length must be a multiple of 5")
    out = bytearray()
    for i in range(0, len(s), 5):
        v = 0
        for c in s[i:i + 5]:
            v = v * 85 + _Z85_REV[c]
        out += v.to_bytes(4, "big")
    return bytes(out)


def z85_encode(b):
    if len(b) % 4:
        raise ValueError("z85 input must be a multiple of 4")
    out = []
    for i in range(0, len(b), 4):
        v = int.from_bytes(b[i:i + 4], "big")
        chunk = [""] * 5
        for j in range(4, -1, -1):
            chunk[j] = _Z85[v % 85]
            v //= 85
        out.append("".join(chunk))
    return "".join(out)


def read_curve_keyfile(path):
    """The reference's key files hold the 40-char Z85 secret key
    (encryption.c reads CURVE_KEYLEN=40 bytes)."""
    with open(path, "rb") as f:
        data = f.read(40)
    if len(data) != 40:
        raise ValueError("CURVE key file must hold 40 Z85 characters")
    return z85_decode(data)


# ---------------- CURVE mechanism (spec:25/spec:26) ----------------
def _nonce_l(prefix, short8):
    assert len(prefix) + len(short8) == 24
    return prefix + short8


class CurveServerSession:
    """Server side of the ZMTP CURVE handshake + message en/decryption.

    Usage: feed the client's HELLO body to hello() -> WELCOME body; feed
    INITIATE body to initiate() -> READY body; then encrypt()/decrypt()
    handle MESSAGE command bodies."""

    def __init__(self, server_sk):
        self.sk = server_sk
        self.pk = x25519_base(server_sk)
        self.spub_t, self.ssec_t = keypair()   # server transient pair
        self.cookie_key = os.urandom(32)
        self.client_t = None
        self.precious = None                   # beforenm(C', s')
        self.send_nonce = 1
        self.recv_nonce = 0

    def hello(self, body):
        if len(body) != 194:
            raise ValueError("bad HELLO length")
        if body[0] != 1:
            raise ValueError("unsupported CURVE version")
        self.client_t = body[74:106]
        nonce = _nonce_l(b"CurveZMQHELLO---", body[106:114])
        k = box_beforenm(self.client_t, self.sk)
        sig = box_open_afternm(body[114:194], nonce, k)
        if sig != b"\x00" * 64:
            raise ValueError("bad HELLO signature")
        # WELCOME: box(S' + cookie) under (C', s) with 16-byte long nonce
        cookie_nonce = os.urandom(16)
        cookie_box = secretbox(self.client_t + self.ssec_t,
                               _nonce_l(b"COOKIE--", cookie_nonce),
                               self.cookie_key)
        cookie = cookie_nonce + cookie_box          # 16 + 96 = 112? no: 16+80
        welcome_nonce = os.urandom(16)
        welcome_box = box_afternm(self.spub_t + cookie,
                                  _nonce_l(b"WELCOME-", welcome_nonce), k)
        return welcome_nonce + welcome_box

    def initiate(self, body):
        # cookie = 16-byte nonce + 80-byte box (96 total), then 8-byte short
        # nonce and the initiate box
        cookie_nonce, cookie_box = body[:16], body[16:96]
        nonce8 = body[96:104]
        content = secretbox_open(cookie_box,
                                 _nonce_l(b"COOKIE--", cookie_nonce),
                                 self.cookie_key)
        c_t, s_sec_t = content[:32], content[32:64]
        if c_t != self.client_t:
            raise ValueError("cookie does not match HELLO client key")
        self.ssec_t = s_sec_t
        self.precious = box_beforenm(self.client_t, self.ssec_t)
        plain = box_open_afternm(body[104:],
                                 _nonce_l(b"CurveZMQINITIATE", nonce8),
                                 self.precious)
        client_pk = plain[:32]
        vouch_nonce, vouch_box = plain[32:48], plain[48:128]
        vouch = secretbox_open(vouch_box, _nonce_l(b"VOUCH---", vouch_nonce),
                               box_beforenm(client_pk, self.ssec_t))
        if vouch != self.client_t + self.pk:
            raise ValueError("bad INITIATE vouch")
        self.metadata = plain[128:]
        # READY with our metadata
        n8 = struct.pack(">Q", self.send_nonce)
        self.send_nonce += 1
        meta = b"\x0bSocket-Type" + struct.pack(">I", 3) + b"PUB"
        return n8 + box_afternm(meta, _nonce_l(b"CurveZMQREADY---", n8),
                                self.precious)

    def encrypt(self, payload, flags=0):
        n8 = struct.pack(">Q", self.send_nonce)
        self.send_nonce += 1
        boxed = box_afternm(bytes([flags]) + payload,
                            _nonce_l(b"CurveZMQMESSAGES", n8), self.precious)
        return n8 + boxed

    def decrypt(self, body):
        n8 = body[:8]
        n = struct.unpack(">Q", n8)[0]
        if n <= self.recv_nonce:
            raise ValueError("replayed MESSAGE nonce")
        self.recv_nonce = n
        plain = box_open_afternm(body[8:],
                                 _nonce_l(b"CurveZMQMESSAGEC", n8),
                                 self.precious)
        return plain[0], plain[1:]


class CurveClientSession:
    """Client side (the subscriber role, e.g. ODR-DabMux's input) - used by
    the loopback tests to validate the server implementation end-to-end."""

    def __init__(self, server_pk):
        self.server_pk = server_pk
        self.pk, self.sk = keypair()
        self.cpub_t, self.csec_t = keypair()
        self.precious = None
        self.send_nonce = 1
        self.recv_nonce = 0

    def hello(self):
        n8 = struct.pack(">Q", 1)
        sig = box_afternm(b"\x00" * 64, _nonce_l(b"CurveZMQHELLO---", n8),
                          box_beforenm(self.server_pk, self.csec_t))
        return bytes([1, 0]) + b"\x00" * 72 + self.cpub_t + n8 + sig

    def welcome(self, body):
        nonce16, boxed = body[:16], body[16:]
        plain = box_open_afternm(boxed, _nonce_l(b"WELCOME-", nonce16),
                                 box_beforenm(self.server_pk, self.csec_t))
        self.spub_t = plain[:32]
        self.cookie = plain[32:]
        self.precious = box_beforenm(self.spub_t, self.csec_t)

    def initiate(self):
        vouch_nonce = os.urandom(16)
        vouch = secretbox(self.cpub_t + self.server_pk,
                          _nonce_l(b"VOUCH---", vouch_nonce),
                          box_beforenm(self.spub_t, self.sk))
        meta = b"\x0bSocket-Type" + struct.pack(">I", 3) + b"SUB"
        n8 = struct.pack(">Q", self.send_nonce)
        self.send_nonce += 1
        content = self.pk + vouch_nonce + vouch + meta
        boxed = box_afternm(content, _nonce_l(b"CurveZMQINITIATE", n8),
                            self.precious)
        return self.cookie + n8 + boxed

    def ready(self, body):
        n8 = body[:8]
        return box_open_afternm(body[8:], _nonce_l(b"CurveZMQREADY---", n8),
                                self.precious)

    def decrypt(self, body):
        n8 = body[:8]
        plain = box_open_afternm(body[8:],
                                 _nonce_l(b"CurveZMQMESSAGES", n8),
                                 self.precious)
        return plain[0], plain[1:]

    def encrypt(self, payload, flags=0):
        n8 = struct.pack(">Q", self.send_nonce)
        self.send_nonce += 1
        boxed = box_afternm(bytes([flags]) + payload,
                            _nonce_l(b"CurveZMQMESSAGEC", n8), self.precious)
        return n8 + boxed
