"""Reed-Solomon over GF(256), vectorised with numpy.

Same code parameters as the reference's libfec usage:
  DAB+ superframe: RS(120,110) = init_rs_char(8, 0x11d, fcr=0, prim=1,
                   nroots=10, pad=135)            (odr-audioenc.cpp:769)
  EDI PFT:         RS(255,207) shortened, gfpoly 0x11d, firstRoot=1
                   (contrib/edioutput/PFT.cpp:102-109, ReedSolomon.h:37-56)

Systematic encoding is linear over GF(256), so parity = data x G with G a
precomputed [K, nroots] generator-product table; the batched encode is then
K*nroots table-lookup XOR accumulations over any number of codewords at once.
"""
import numpy as np


class GF256:
    def __init__(self, poly=0x11D):
        exp = np.zeros(512, np.uint8)
        log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= poly
        exp[255:510] = exp[:255]
        self.exp, self.log = exp, log

    def mul(self, a, b):
        a = np.asarray(a, np.uint8)
        b = np.asarray(b, np.uint8)
        out = self.exp[(self.log[a] + self.log[b]) % 255]
        return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


class ReedSolomon:
    def __init__(self, nroots, kk, poly=0x11D, fcr=0, prim=1):
        """Shortened RS with kk data symbols and nroots parity symbols."""
        self.gf = GF256(poly)
        self.nroots = nroots
        self.kk = kk
        self.fcr = fcr
        self.prim = prim
        # generator polynomial with roots alpha^(fcr+prim*i)
        g = np.zeros(nroots + 1, np.uint8)
        g[0] = 1
        for i in range(nroots):
            root = self.gf.exp[(fcr + prim * i) % 255]
            ng = np.zeros(nroots + 1, np.uint8)
            ng[1:] = g[:-1]
            ng ^= self.gf.mul(g, root)
            g = ng
        self.genpoly = g  # ascending degree: g[nroots] = 1 (monic leading)
        # LFSR tap for parity slot j (degree nroots-1-j) is g[nroots-1-j]
        self._taps = g[:-1][::-1].copy()
        # parity of unit data vectors -> linear map G [kk, nroots]
        G = np.zeros((kk, nroots), np.uint8)
        for i in range(kk):
            d = np.zeros(kk, np.uint8)
            d[i] = 1
            G[i] = self._encode_lfsr(d)
        self.G = G
        self.Glog = self.gf.log[G]  # [kk, nroots], log form (log 0 meaningless)
        self.Gzero = G == 0

    def _encode_lfsr(self, data):
        """Scalar LFSR systematic encode (Phil Karn's encode_rs semantics)."""
        gf = self.gf
        par = np.zeros(self.nroots, np.uint8)
        for d in data:
            fb = d ^ par[0]
            par[:-1] = par[1:]
            par[-1] = 0
            if fb:
                par ^= gf.mul(self._taps, fb)
        return par

    def encode(self, data):
        """data: [..., kk] uint8 -> parity [..., nroots] uint8 (vectorised)."""
        data = np.asarray(data, np.uint8)
        gf = self.gf
        logd = gf.log[data]  # [..., kk]
        out = np.zeros(data.shape[:-1] + (self.nroots,), np.uint8)
        for i in range(self.kk):
            prod = gf.exp[(logd[..., i, None] + self.Glog[i]) % 255]
            prod = np.where((data[..., i, None] == 0) | self.Gzero[i], 0, prod)
            out ^= prod.astype(np.uint8)
        return out

    def syndromes_ok(self, codeword):
        """codeword: [..., kk+nroots]; True where all syndromes vanish."""
        cw = np.asarray(codeword, np.uint8)
        n = cw.shape[-1]
        ok = np.ones(cw.shape[:-1], bool)
        # S_j = sum_i c_i * alpha^((fcr+prim*j)*(n-1-i))
        for j in range(self.nroots):
            root = (self.fcr + self.prim * j) % 255
            powers = (root * (np.arange(n)[::-1].astype(np.int64))) % 255
            terms = self.gf.mul(cw, self.gf.exp[powers])
            s = np.bitwise_xor.reduce(terms, axis=-1)
            ok &= s == 0
        return ok


_RS_DAB = None


def rs_dab():
    """RS(120,110) used on DAB+ superframes."""
    global _RS_DAB
    if _RS_DAB is None:
        _RS_DAB = ReedSolomon(nroots=10, kk=110, poly=0x11D, fcr=0, prim=1)
    return _RS_DAB


def superframe_add_rs(superframes):
    """superframes: [..., subch*110] uint8 -> [..., subch*120] with the
    column-interleaved RS parity (odr-audioenc.cpp:1189-1206): byte p of the
    stream sits at (col=p//subch, row=p%subch); each row is one codeword."""
    sf = np.asarray(superframes, np.uint8)
    lead = sf.shape[:-1]
    subch = sf.shape[-1] // 110
    rows = sf.reshape(*lead, 110, subch)          # [.., col, row]
    data = np.moveaxis(rows, -1, -2)              # [.., row, col=110]
    parity = rs_dab().encode(data)                # [.., row, 10]
    out = np.concatenate([rows, np.moveaxis(parity, -1, -2)], axis=-2)
    return out.reshape(*lead, 120 * subch)


def superframe_check_rs(frames):
    """frames: [..., subch*120]; True where every row's RS syndromes vanish."""
    fr = np.asarray(frames, np.uint8)
    lead = fr.shape[:-1]
    subch = fr.shape[-1] // 120
    cw = np.moveaxis(fr.reshape(*lead, 120, subch), -1, -2)
    return rs_dab().syndromes_ok(cw).all(axis=-1)
