"""ZeroMQ PUB output with the ODR-DabMux frame header.

This environment has no libzmq, so a minimal ZMTP 3.0 implementation (PUB
socket, connect mode) is provided in pure Python - enough for ODR-DabMux's
SUB input.  Frame header layout matches src/Outputs.h:76-99 (packed
little-endian: u16 version, u16 encoder, u32 datasize, i16 L, i16 R).

Security mechanisms: NULL, or CURVE acting as server with the secret key
from the reference-format key file (Outputs.cpp:75-93 sets
ZMQ_CURVE_SERVER + ZMQ_CURVE_SECRETKEY; encryption.c reads the 40-char Z85
key) - implemented in curve.py without libzmq/libsodium.
"""
import socket
import struct
import threading
from urllib.parse import urlparse

from .base import Output

ZMQ_ENCODER_AACPLUS = 1
ZMQ_ENCODER_MPEG_L2 = 2


def _greeting(mechanism, as_server):
    mech = mechanism.encode().ljust(20, b"\x00")
    return (b"\xff" + b"\x00" * 8 + b"\x7f" + bytes([3, 0]) + mech
            + bytes([1 if as_server else 0]) + b"\x00" * 31)


def _metadata(props):
    out = b""
    for k, v in props.items():
        out += bytes([len(k)]) + k.encode() + struct.pack(">I", len(v)) + v.encode()
    return out


def _command(name, body):
    payload = bytes([len(name)]) + name.encode() + body
    if len(payload) < 256:
        return bytes([0x04, len(payload)]) + payload
    return b"\x06" + struct.pack(">Q", len(payload)) + payload


def _message(data):
    if len(data) < 256:
        return bytes([0x00, len(data)]) + data
    return b"\x02" + struct.pack(">Q", len(data)) + data


class ZmtpPubConnection(threading.Thread):
    """One outgoing PUB connection with auto-reconnect; NULL or CURVE
    (server role) security."""

    def __init__(self, host, port, curve_secret=None):
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.curve_secret = curve_secret
        self.session = None
        self.sock = None
        self.lock = threading.Lock()
        self._connect()

    def _connect(self):
        try:
            s = socket.create_connection((self.host, self.port), timeout=2.0)
            s.settimeout(5.0)
            if self.curve_secret is None:
                s.sendall(_greeting("NULL", False))
                self._recv_exact(s, 64)  # peer greeting
                s.sendall(_command("READY", _metadata({"Socket-Type": "PUB"})))
                self._read_frame(s)      # peer READY
            else:
                from .curve import CurveServerSession
                self.session = CurveServerSession(self.curve_secret)
                s.sendall(_greeting("CURVE", True))
                self._recv_exact(s, 64)
                name, body = self._read_command(s)
                if name != b"HELLO":
                    raise OSError(f"expected HELLO, got {name!r}")
                s.sendall(_command("WELCOME", self.session.hello(body)))
                name, body = self._read_command(s)
                if name != b"INITIATE":
                    raise OSError(f"expected INITIATE, got {name!r}")
                s.sendall(_command("READY", self.session.initiate(body)))
            s.settimeout(0.0)        # non-blocking from here (dontwait)
            self.sock = s
        except (OSError, ValueError):
            self.sock = None
            self.session = None

    @staticmethod
    def _recv_exact(s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise OSError("peer closed")
            buf += chunk
        return buf

    def _read_frame(self, s):
        flags = self._recv_exact(s, 1)[0]
        if flags & 0x02:
            size = struct.unpack(">Q", self._recv_exact(s, 8))[0]
        else:
            size = self._recv_exact(s, 1)[0]
        return flags, self._recv_exact(s, size)

    def _read_command(self, s):
        flags, payload = self._read_frame(s)
        if not flags & 0x04:
            raise OSError("expected command frame")
        nlen = payload[0]
        return payload[1:1 + nlen], payload[1 + nlen:]

    def send(self, data):
        with self.lock:
            if self.sock is None:
                self._connect()
                if self.sock is None:
                    return False
            try:
                # drain pending subscribe messages (non-blocking)
                try:
                    while True:
                        if not self.sock.recv(4096):
                            raise OSError
                except BlockingIOError:
                    pass
                if self.session is not None:
                    self.sock.sendall(
                        _command("MESSAGE", self.session.encrypt(data)))
                else:
                    self.sock.sendall(_message(data))
                return True
            except OSError:
                try:
                    self.sock.close()
                except OSError:
                    pass
                self.sock = None
                self.session = None
                return False


class ZmqOutput(Output):
    def __init__(self, uri, keyfile=None):
        super().__init__()
        secret = None
        if keyfile:
            from .curve import read_curve_keyfile
            secret = read_curve_keyfile(keyfile)
        u = urlparse(uri)
        if u.scheme != "tcp":
            raise ValueError(f"only tcp:// ZMQ outputs supported, got {uri}")
        self.conn = ZmtpPubConnection(u.hostname, u.port, curve_secret=secret)
        self.encoder = ZMQ_ENCODER_AACPLUS

    def set_encoder_type(self, is_dabplus):
        self.encoder = ZMQ_ENCODER_AACPLUS if is_dabplus else ZMQ_ENCODER_MPEG_L2

    def write_frame(self, buf):
        hdr = struct.pack("<HHIhh", 1, self.encoder, len(buf),
                          self.audio_left, self.audio_right)
        return self.conn.send(hdr + buf)
