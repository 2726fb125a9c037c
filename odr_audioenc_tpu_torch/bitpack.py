"""Device-side bitstream packing and CRC primitives (port of
odr_audioenc_tpu/bitpack.py).

 - ``pack_groups``: (width, value) slots in exact serialization order; bit
   offsets are an exclusive cumsum, each slot adds its <= `spans`
   overlapping bytes into the buffer with an integer scatter-add.  Distinct
   slots never share bits, so integer add == bitwise or.
 - GF(2) CRCs (``CrcTable``/``crc_device``/``crc_fixed``): for a message of L bits
   left-aligned in a P-bit buffer, crc = (M(x)*x^w mod g) * x^(L-P)
   + init*x^L (mod g).  The fixed-alignment reduction is an integer
   bit-matrix product reduced mod 2 (sums are at most P, exact in int32);
   the per-length shift and init terms are one row of a table picked by
   index.  ``crc_fixed`` (a whole buffer of fixed length) and the RS parity of
   ``rs_bit_matrix`` take the same reduction as a float32 matmul of 0/1
   bits against a 0/1 matrix: both operands are exact in any float format
   and the sums stay below 2^24, so the product is exact whatever the
   matmul precision.

These mirror the byte formats of libtoolame-dab/bitstream.c:46-150.
"""
import numpy as np
import torch


def _mask_to_width(values, widths):
    """Mask each value to its width, as the host BitWriter truncates."""
    w = widths.clamp_max(24)
    return torch.where(widths > 0, values & ((1 << w) - 1), 0)


def pack_groups(groups, n_bytes, raw=None, bit_base=None):
    """Serialize slot groups into a byte buffer on device.

    groups: list of (widths [..,k_i] int, values [..,k_i] int, spans_i) in
      exact serialization order; spans_i = max bytes any slot of the group
      can touch.  Max width 24 bits.
    raw: optional (byte_idx [..,m], byte_val [..,m]) pairs placed directly;
      indices outside [0, n_bytes) are dropped.
    bit_base: optional [..] starting bit offset (default 0).  A slot that
      starts before bit 0 is dropped whole, one that runs past the end loses
      the bytes past it.
    Returns (payload [.., n_bytes] int64 0..255, total_bits [..] int64)."""
    widths = torch.cat([g[0].long() for g in groups], dim=-1)
    values = torch.cat([_mask_to_width(g[1].long(), g[0].long()) for g in groups], dim=-1)
    end = torch.cumsum(widths, dim=-1)
    if bit_base is not None:
        end = end + bit_base[..., None]
    start = end - widths
    total_bits = end[..., -1]
    lead = widths.shape[:-1]
    # one spill row past the end catches dropped contributions
    out = torch.zeros((*lead, n_bytes + 1), dtype=torch.int64, device=widths.device)

    off = 0
    for g_w, _, spans in groups:
        sl = slice(off, off + g_w.shape[-1])
        off += g_w.shape[-1]
        w, v, e = widths[..., sl], values[..., sl], end[..., sl]
        b0 = start[..., sl] >> 3
        last_b = (e - 1) >> 3
        for t in range(spans):
            bt = b0 + t
            sh = e - 8 * (bt + 1)
            c = torch.where(sh >= 0, (v >> sh.clamp(0, 24)) & 0xFF,
                            (v << (-sh).clamp(0, 8)) & 0xFF)
            ok = (w > 0) & (bt <= last_b) & (b0 >= 0) & (bt < n_bytes)
            out.scatter_add_(-1, torch.where(ok, bt, n_bytes), torch.where(ok, c, 0))
    if raw:
        idx = torch.cat([r[0].long() for r in raw], dim=-1)
        con = torch.cat([r[1].long() & 0xFF for r in raw], dim=-1)
        ok = (idx >= 0) & (idx < n_bytes)
        out.scatter_add_(-1, torch.where(ok, idx, n_bytes), torch.where(ok, con, 0))
    return out[..., :n_bytes], total_bits


def bytes_to_bits(x):
    """[..., B] integer bytes -> [..., 8B] int64 bits, MSB first."""
    sh = torch.arange(7, -1, -1, device=x.device)
    bits = (x[..., None].long() >> sh) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)


def _crc_ref(msb_val, length, crc, poly, width):
    """Bit-serial reference (update_crc16/update_crc8 semantics, crc.c)."""
    mask = (1 << width) - 1
    for i in range(length - 1, -1, -1):
        bit = (msb_val >> i) & 1
        carry = (crc >> (width - 1)) & 1
        crc = (crc << 1) & mask
        if carry ^ bit:
            crc ^= poly & mask
    return crc


def _xmul(a, b):
    """carry-less multiply."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
    return r


def _xmod(a, m):
    db = m.bit_length() - 1
    while a.bit_length() - 1 >= db:
        a ^= m << (a.bit_length() - 1 - db)
    return a


class CrcTable:
    """Host-precomputed tables (numpy) for a (poly, width, init) CRC over
    messages of up to p_bits bits, left-aligned in a fixed p_bits buffer."""

    def __init__(self, poly, width, init, p_bits):
        self.poly, self.width, self.init, self.p = poly, width, init, p_bits
        w, g = width, poly | (1 << width)

        # R[p] = x^(w + P-1-p) mod g  (fixed-alignment reduction matrix)
        R = np.zeros((p_bits, w), np.int8)
        cur = _xmod(1 << w, g)  # x^w mod g, i.e. exponent for p = P-1
        for p in range(p_bits - 1, -1, -1):
            R[p] = [(cur >> (w - 1 - j)) & 1 for j in range(w)]
            cur = _xmod(cur << 1, g)
        self.R = R

        # x^{-1} mod g: g = x*q + 1  =>  x^{-1} = q = (g-1)/x
        xinv = (g ^ 1) >> 1
        # per-length tables: MUL[L][i][:] = x^i * x^(L-P) mod g; INIT[L]
        lut = np.zeros((p_bits + 1, w * w + w), np.int8)
        tL = 1  # x^(L-P) at L = P
        for L in range(p_bits, -1, -1):
            initL = _xmod(_xmul(init, self._xpow(L, g)), g)
            for i in range(w):
                # c0[i] holds the coefficient of x^(w-1-i)
                m = _xmod(_xmul(1 << (w - 1 - i), tL), g)
                lut[L, i * w:(i + 1) * w] = [(m >> (w - 1 - j)) & 1 for j in range(w)]
            lut[L, w * w:] = [(initL >> (w - 1 - j)) & 1 for j in range(w)]
            tL = _xmod(_xmul(tL, xinv), g)
        self.lut = lut

    @staticmethod
    def _xpow(n, g):
        """x^n mod g by square-and-multiply (carry-less)."""
        r, base = 1, 2  # x
        while n:
            if n & 1:
                r = _xmod(_xmul(r, base), g)
            base = _xmod(_xmul(base, base), g)
            n >>= 1
        return r

    def device_tables(self, device):
        return {"R": torch.as_tensor(self.R, dtype=torch.int32, device=device),
                "lut": torch.as_tensor(self.lut, dtype=torch.int32, device=device)}


def crc_device(buf, nbits, tabs, width):
    """buf: [.., nb] integer bytes with the message left-aligned in the first
    `nbits` bits (rest zero); nbits: [..]; tabs: CrcTable.device_tables for
    P = 8*nb.  Returns crc [..] int64."""
    bits = bytes_to_bits(buf).to(torch.int32)                 # [.., P]
    c0 = (bits[..., :, None] * tabs["R"]).sum(dim=-2) & 1     # [.., w]
    row = tabs["lut"][nbits.long()]                           # [.., w*w + w]
    mul = row[..., :width * width].reshape(*row.shape[:-1], width, width)
    initv = row[..., width * width:]
    out = ((c0[..., :, None] * mul).sum(dim=-2) + initv) & 1
    sh = torch.arange(width - 1, -1, -1, device=buf.device)
    return (out.long() << sh).sum(dim=-1)


def crc_fixed(buf, tab_R, width, init_contrib):
    """CRC over a fixed-length message (the whole buffer): one product of
    its bits with tab_R, a float32 tensor of CrcTable(poly, width, ., P).R
    with P = 8*nb; init_contrib = _crc_ref(0, P, init, poly, width) (a host
    scalar).  buf: [.., nb] integer bytes.  Returns crc [..] int32.  The
    operands are 0/1 and the sums at most P < 2^24, so the float product
    is exact; no [.., P, width] intermediate is built."""
    sh = torch.arange(7, -1, -1, device=buf.device, dtype=torch.int32)
    bits = ((buf[..., None].to(torch.int32) >> sh) & 1).to(torch.float32)
    c0 = torch.round(bits.reshape(*buf.shape[:-1], -1) @ tab_R).to(torch.int32) & 1
    wsh = torch.arange(width - 1, -1, -1, device=buf.device, dtype=torch.int32)
    return (c0 << wsh).sum(dim=-1, dtype=torch.int32) ^ init_contrib


def rs_bit_matrix(rs):
    """GF(2) bit matrix [kk*8, nroots*8] (numpy int8) of a ReedSolomon
    instance: parity bits as a linear function of data bits (GF(256)-linear
    => GF(2)-linear).  Data bit (i, b) = byte i bit b (MSB-first); parity
    likewise."""
    kk, nr = rs.kk, rs.nroots
    M = np.zeros((kk * 8, nr * 8), np.int8)
    for b in range(8):
        v = 1 << (7 - b)  # MSB-first bit b of a byte
        par = rs.gf.mul(rs.G, v)  # [kk, nroots] parity bytes for data=v at i
        bits = ((par[:, :, None] >> np.arange(7, -1, -1)) & 1)  # [kk, nr, 8]
        M[np.arange(kk) * 8 + b] = bits.reshape(kk, nr * 8)
    return M
