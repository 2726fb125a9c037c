"""Device-side DAB+ AU bitstream + superframe emission (port of
odr_audioenc_tpu/dabplus/aupack.py).

Slot-grid re-expression of the host writer (host/aacpack.py `write_au` /
`SuperframePacker.assemble`, which match fdk bitenc.cpp / bit_cnt.cpp /
tpenc_dab.cpp:154-466 semantics): every AU is a static grid of
(width, value) bit slots whose offsets are a cumsum in serialization
order, packed by the integer byte scatter of bitpack.pack_groups.  All the
data-dependent syntax (section runs, scalefactor DPCM chains, Huffman
codewords with signs/escapes, TNS filters, DSE, FIL fill) is expressed
as masked slots so one sequence of tensor ops serves every stream.

Every table lookup is an integer gather with its index clamped and the
result masked to 0 outside the table (a stream whose AU overflows must
corrupt only itself, never fault the batch).  CRCs are GF(2)-linear, so
the per-AU CRC16 (0x1021, inverted), the firecode (0x782d) and the
RS(120,110) column parity are products of 0/1 bits with 0/1 matrices
(exact in float32, bitpack.crc_fixed); the AU CRC over a *variable-length*
byte range is assembled from a fixed-alignment reduction plus per-length
multiplier tables (x^{8k} mod g), and the last AU's deterministic FIL-fill
tail contributes via a host-precomputed table indexed by the fill width.

The host tables are numpy under lru_cache; AuPackCtx turns them into
tensors once, on the encoder's device.
"""
from functools import lru_cache

import numpy as np
import torch

from .. import bitpack as BP
from . import tables as AT

NB = AT.MAX_SFB_LONG

# CCITT CRC16 modulus (AU CRCs, tpenc_dab.cpp:407-423)
G_CRC = 0x11021

# ---------------------------------------------------------------------------
# host-precomputed GF(2) tables
# ---------------------------------------------------------------------------


def _mulmod_int(a, b, g=G_CRC):
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
    db = g.bit_length() - 1
    while r.bit_length() > db:
        r ^= g << (r.bit_length() - 1 - db)
    return r


@lru_cache(maxsize=None)
def _xpow8(max_bytes):
    """x^(8j) mod g for j in 0..max_bytes."""
    xp = np.zeros(max_bytes + 1, np.int64)
    cur = 1
    x8 = _mulmod_int(1 << 8, 1)
    for j in range(max_bytes + 1):
        xp[j] = cur
        cur = _mulmod_int(cur, x8)
    return xp


@lru_cache(maxsize=None)
def _xinv():
    """x^{-1} mod g: g = x*q + 1 => x^{-1} = (g ^ 1) >> 1."""
    return (G_CRC ^ 1) >> 1


@lru_cache(maxsize=None)
def _xpow8_inv(max_bytes):
    """x^(-8j) mod g for j in 0..max_bytes."""
    xi = _xinv()
    x8i = 1
    for _ in range(8):
        x8i = _mulmod_int(x8i, xi)
    xp = np.zeros(max_bytes + 1, np.int64)
    cur = 1
    for j in range(max_bytes + 1):
        xp[j] = cur
        cur = _mulmod_int(cur, x8i)
    return xp


def _fill_slots_host(fill_bits):
    """(width, value) slots of dabWrite_FillRawDataBlock for `fill_bits`
    (host/aacpack.py _fill_raw_data_block, tpenc_dab.cpp:312-360), plus the
    trailing ID_END.  Zero spans are slots too (they advance the offset)."""
    slots = []
    pb = fill_bits
    while pb >= 7:
        pb -= 7
        esc = -1
        if pb >= 15 * 8:
            pb -= 8
            esc = 0
        cnt = min(269, pb >> 3)
        if cnt >= 15:
            esc = cnt - 15 + 1
        if esc >= 0:
            slots.append((15, (6 << 12) | (15 << 8) | esc))
        else:
            slots.append((7, (6 << 4) | cnt))
        cnt_bits = min(cnt * 8, pb)
        if cnt_bits:
            slots.append((cnt_bits, 0))  # EXT_FIL + fill nibble + zero bytes
        pb -= cnt_bits
    slots.append((3, 7))  # ID_END
    return slots


@lru_cache(maxsize=None)
def _tail_tables(max_d):
    """For every tail width D (= fill_bits + 3) in 0..max_d: the slot list
    (padded to a common count) and the tail's CRC contribution
    R(tail_poly * x^16) where the tail occupies the last D bits of the AU."""
    # x^j mod g for arbitrary bit shifts
    maxbits = max_d + 16
    xpb = np.zeros(maxbits + 1, np.int64)
    cur = 1
    for j in range(maxbits + 1):
        xpb[j] = cur
        cur = _mulmod_int(cur, 2)
    all_slots = {d: _fill_slots_host(d - 3) for d in range(3, max_d + 1)}
    n_slots = max(len(s) for s in all_slots.values())
    slots_tab = np.zeros((max_d + 1, n_slots, 2), np.int32)
    crc_tab = np.zeros(max_d + 1, np.int32)
    for d in range(3, max_d + 1):
        slots = all_slots[d]
        pos = 0
        crc = 0
        for k, (w, v) in enumerate(slots):
            slots_tab[d, k] = (w, v)
            pos += w
            if v:
                # value ends (d - pos) bits before the AU end
                vm = _mulmod_int(v, xpb[16])
                crc ^= _mulmod_int(vm, xpb[d - pos])
        # host consumes fill in whole elements; a <7-bit remainder becomes
        # BitWriter alignment zeros - the slot offsets stop short of d, fine
        crc_tab[d] = crc
    return slots_tab, crc_tab


@lru_cache(maxsize=None)
def _crc_shift_tables(maxcb, total):
    """shiftlut[Pb] = x^(8*(Pb - maxcb)) mod g for Pb in 0..total (the
    alignment factor turning the left-aligned content reduction into the
    AU-end-aligned contribution), and ilut[Pb] = init 0xFFFF shifted through
    8*Pb message bits (= crc16_ccitt of Pb zero bytes)."""
    xp = _xpow8(total)
    xpi = _xpow8_inv(maxcb)
    shift = np.zeros(total + 1, np.int64)
    for pb in range(total + 1):
        if pb >= maxcb:
            shift[pb] = xp[pb - maxcb]
        else:
            shift[pb] = xpi[maxcb - pb]
    ilut = np.array([_mulmod_int(0xFFFF, xp[j]) for j in range(total + 1)],
                    np.int64)
    return shift.astype(np.int32), ilut.astype(np.int32)


@lru_cache(maxsize=None)
def _crc16_R_np(p_bits):
    return BP.CrcTable(0x1021, 16, 0, p_bits).R


@lru_cache(maxsize=None)
def _fire_R_np(p_bits):
    return BP.CrcTable(0x782D, 16, 0, p_bits).R


@lru_cache(maxsize=None)
def _rs_M_np():
    from ..fec.rs import rs_dab
    return BP.rs_bit_matrix(rs_dab())


# ---------------------------------------------------------------------------
# device lookups and GF(2) helpers
# ---------------------------------------------------------------------------


def _lut16(idx, table):
    """table[idx] for idx [..] in [0, n); 0 for an index outside (as a
    one-hot row of an index outside is zero).  table: [n] tensor."""
    n = table.shape[0]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, table[idx.clamp(0, n - 1).long()], 0)


def _mulmod_dev(a, b):
    """Carry-less multiply mod G_CRC of two <=16-bit device ints."""
    acc = torch.zeros_like(a)
    t = b
    for i in range(16):
        acc = acc ^ torch.where((a >> i) & 1 > 0, t, 0)
        t = ((t << 1) ^ torch.where((t >> 15) & 1 > 0, G_CRC, 0)) & 0xFFFF
    return acc


def _lut_cols(idx, tab):
    """Rows tab[idx] of a [n, C] table as a list of C tensors shaped like
    idx; zeros for an index outside [0, n)."""
    n = tab.shape[0]
    ok = (idx >= 0) & (idx < n)
    out = torch.where(ok[..., None], tab[idx.clamp(0, n - 1).long()], 0)
    return list(out.unbind(-1))


def _lut_cols2(ia, ib, tab):
    """Rows tab[ia, ib] of a [n, n, C] table as a list of C tensors; zeros
    where either index lies outside [0, n)."""
    n = tab.shape[0]
    ok = (ia >= 0) & (ia < n) & (ib >= 0) & (ib < n)
    out = torch.where(ok[..., None],
                      tab[ia.clamp(0, n - 1).long(), ib.clamp(0, n - 1).long()], 0)
    return list(out.unbind(-1))


# ---------------------------------------------------------------------------
# spectral codeword tables (values; lengths live in encode.py)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _code_tables():
    """Per codebook-group stacked (len, code) int32 column pairs for the
    value lookups, mirroring bit_cnt.cpp codeword emission.  The reference
    splits each code into 8-bit chunks for its one-hot products; an integer
    gather carries the whole code (scf codes reach 19 bits)."""
    def cols(b, n):
        return [AT.HUFF_LEN[b].reshape(-1)[:n], AT.HUFF_CODE[b].reshape(-1)[:n]]

    def stack(cs):
        return np.stack([np.asarray(c).astype(np.int32) for c in cs], -1)

    return {
        "q12": stack(cols(1, 81) + cols(2, 81)),         # [81, 4]; books 1..4 are [3,3,3,3]
        "q34": stack(cols(3, 81) + cols(4, 81)),
        "p56": stack(cols(5, 81) + cols(6, 81)),
        "p78": stack(cols(7, 64) + cols(8, 64)),
        "p910": stack(cols(9, 169) + cols(10, 169)),
        "p11": stack(_p11_cols()),                       # [289, 2]
        "scf": stack([AT.HUFF_LEN_SCF, AT.HUFF_CODE_SCF]),
    }


def _p11_cols():
    return [AT.HUFF_LEN[11][:17, :17].reshape(-1), AT.HUFF_CODE[11][:17, :17].reshape(-1)]


@lru_cache(maxsize=None)
def _pair_tables_np():
    """Books 7..11's (len, code) columns folded onto book-11's 17x17 clipped
    index domain and merged, so ONE two-index lookup serves all five tables
    (entries past a book's limit are never selected - the band's book is
    only chosen when its magnitude limit holds)."""
    tabs = _code_tables()

    def fold(t, lim):
        m = np.asarray(t).reshape(lim + 1, lim + 1, -1)
        a = np.minimum(np.arange(17), lim)
        return m[np.ix_(a, a)].reshape(289, -1)

    return np.concatenate([fold(tabs["p78"], 7), fold(tabs["p910"], 12),
                           np.asarray(tabs["p11"]).reshape(289, -1)],
                          axis=-1)  # [289, 10]


# ---------------------------------------------------------------------------
# static per-config context
# ---------------------------------------------------------------------------


class AuPackCtx:
    """Static tables for one DabPlusEncoder config, as tensors built once on
    the encoder's device."""

    def __init__(self, enc):
        self.enc = enc
        cfg = enc.cfg
        pk = enc.packer
        self.device = dev = enc.device
        self.total = pk.total
        self.nau = pk.num_aus
        self.header_bytes = pk.header_bytes
        self.flags_byte = ((pk.dac_rate << 6) | (pk.sbr << 5)
                           | (pk.ch_mode << 4) | (pk.ps << 3))
        self.hdr_pad4 = (pk.dac_rate == 0 or pk.sbr == 0)
        self.n_ch = enc.core_channels
        self.max_sfb = enc.max_sfb
        self.sfb_off = np.asarray(enc.sfb_off)
        self.msfb_s = enc.max_sfb_short
        self.nsfb_s = enc.nsfb_short
        self.sfb_off_s = np.asarray(enc.sfb_off_short)
        self.tns_cfg = enc.tns_cfg
        # content-buffer byte bound per AU (host-asserted at emission)
        hard = self.total - self.header_bytes - 2 * self.nau
        soft = (2 * enc.budget_au + enc.bitres_max) // 8 \
            + 283 + cfg.pad_len + 64
        self.maxcb = min(hard, soft)
        self.maxcb = -(-self.maxcb // 32) * 32
        # Static proof that the model.pack_superframes overflow warning is
        # unreachable: the rate loop's crash recovery (encode.py _recover)
        # guarantees every AU's counted bits <= budget_au + allow, and the
        # model caps the reservoir draw at allow <= budget_au + bitres_max
        # (model.py _superframe_step); the content buffer additionally
        # carries the X-PAD DSE ((pad_len+3) bytes framing) and byte
        # alignment.  If this worst case ever exceeded the pack bound the
        # encoder could emit a corrupt superframe, so fail at construction.
        pad_bits = (cfg.pad_len + 3) * 8 if cfg.pad_len else 0
        worst_au_bits = 2 * enc.budget_au + enc.bitres_max + pad_bits + 8
        if worst_au_bits > 8 * self.maxcb:
            raise AssertionError(
                f"device-pack AU bound {8 * self.maxcb} bits < worst-case "
                f"recovered AU {worst_au_bits} bits for subch={cfg.subch} "
                f"ch={enc.core_channels} aot={cfg.aot} pad={cfg.pad_len}")

        def ten(a, dtype=None):
            t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
            return t.to(dtype) if dtype is not None else t

        # long layout: tx band b < max_sfb; band of pair
        bol_l = np.asarray(AT.band_of_line(cfg.core_rate))
        bol_s = np.asarray(AT.short_band_of_line(cfg.core_rate))
        idxs = np.arange(NB)
        gstart_long = np.zeros(NB, bool)
        gstart_long[0] = True            # section restarts: long, band 0 only
        tx_short = (idxs < AT.N_GROUPS * self.nsfb_s) & (idxs % self.nsfb_s < self.msfb_s)
        gstart_short = (idxs % self.nsfb_s == 0) & (idxs < AT.N_GROUPS * self.nsfb_s)
        # bands past n_tx are transmitted in neither layout
        self.n_tx = min(NB, max(self.max_sfb, AT.N_GROUPS * self.nsfb_s))
        # spectral pair emission order: per tx grouped band, per window
        # of its group, the sfb's pairs (host _write_ics short path)
        wpg = 8 // AT.N_GROUPS
        order = []
        for g in range(AT.N_GROUPS):
            for b in range(self.msfb_s):
                for w in range(g * wpg, (g + 1) * wpg):
                    lo = w * AT.NS + int(self.sfb_off_s[b])
                    hi = w * AT.NS + int(self.sfb_off_s[b + 1])
                    order.extend(range(lo // 2, hi // 2))
        seen = set(order)
        rest = [p for p in range(480) if p not in seen]

        self.bop_long = ten(bol_l[::2].astype(np.int64))            # [480] band of pair
        self.bop_short = ten(bol_s[::2].astype(np.int64))
        self.tx_long = ten(idxs < self.max_sfb)
        self.tx_short = ten(tx_short)
        self.gstart_long = ten(gstart_long)
        self.gstart_short = ten(gstart_short)
        self.perm_short = ten(np.asarray(order + rest, np.int64))
        self.band_idx = ten(idxs.astype(np.int32))
        self.pair_even = ten(np.arange(480) % 2 == 0)

        tabs = _code_tables()
        self.scf_tab = ten(tabs["scf"])                              # [121, 2]
        self.q12 = ten(tabs["q12"].reshape(9, 9, 4))
        self.q34 = ten(tabs["q34"].reshape(9, 9, 4))
        self.p56 = ten(tabs["p56"].reshape(9, 9, 4))
        self.pair_tab = ten(_pair_tables_np().reshape(17, 17, 10))
        self.sbr_tabs = {k: ten(v) for k, v in _sbr_tabs().items()} if enc.is_sbr else None

        tail_slots, tail_crc = _tail_tables(self.total * 8)
        self.tail_w = ten(tail_slots[..., 0])                        # [max_d + 1, n_tail]
        self.tail_v = ten(tail_slots[..., 1])
        self.tail_crc = ten(tail_crc)
        crc_shift, crc_init = _crc_shift_tables(self.maxcb, self.total)
        self.crc_shift, self.crc_init = ten(crc_shift), ten(crc_init)
        self.crc16_R = ten(_crc16_R_np(self.maxcb * 8), torch.float32)
        self.fire_R = ten(_fire_R_np(72), torch.float32)
        self.rs_M = ten(_rs_M_np(), torch.float32)


# ---------------------------------------------------------------------------
# AU content slots (called per AU inside the model's AU loop)
# ---------------------------------------------------------------------------

I32 = torch.int32


def _ics_info_slot(ctx, wseq, is_short):
    """ics_info() (host _write_ics_info)."""
    w = torch.where(is_short, 15, 11).to(I32)
    v_long = (wseq.to(I32) << 8) | (ctx.max_sfb << 1)
    v_short = (2 << 12) | (ctx.msfb_s << 7) | AT.SCF_GROUPING
    return w, torch.where(is_short, v_short, v_long)


def _tx_mask(ctx, is_short):
    return torch.where(is_short[:, None], ctx.tx_short, ctx.tx_long)


def _section_slots(ctx, books, is_short):
    """section_data() runs of equal codebook, restarting per group.
    books: [S, NB]; returns (w, v) [S, NB]."""
    idx = ctx.band_idx
    txm = _tx_mask(ctx, is_short)
    gstart = torch.where(is_short[:, None], ctx.gstart_short, ctx.gstart_long)
    prev_books = torch.cat([books[:, :1], books[:, :-1]], dim=1)
    change = txm & (gstart | (books != prev_books))
    # run end: next change or first non-tx band
    stop = change | ~txm
    nxt = torch.cat([torch.where(stop[:, 1:], idx[1:], 2 * NB),
                     torch.full_like(books[:, :1], NB)], dim=1)
    # suffix-min from the right (inclusive) gives the next stop > b
    nc = nxt.flip(1).cummin(1).values.flip(1)
    run = (nc - idx).clamp(1, NB)
    esc = torch.where(is_short, 7, 31).to(I32)[:, None]
    bits = torch.where(is_short, 3, 5).to(I32)[:, None]
    nesc = torch.div(run, esc, rounding_mode="floor")
    v = books
    for k in range(2):
        v = torch.where(nesc > k, (v << bits) | esc, v)
    v = (v << bits) | (run - nesc * esc)
    w = torch.where(change, 4 + bits * (nesc + 1), 0)
    return w, torch.where(change, v, 0)


def _scf_slots(ctx, books, gains, is_short):
    """scale_factor_data(): regular dpcm chain + PNS noise chain
    (host _write_ics scf loop).  Returns (w, v) [S, NB] and global_gain."""
    txm = _tx_mask(ctx, is_short)
    reg = txm & (books > 0) & (books != 13)
    pns = txm & (books == 13)
    idx = ctx.band_idx
    first_reg = torch.where(reg, idx, NB).amin(dim=1)
    gg = torch.where(idx[None] == first_reg[:, None], gains, 0).sum(dim=1, dtype=I32) + 100
    gg = torch.where(first_reg < NB, gg, 100).clamp(0, 255)

    # the chains carry their predecessors band to band; bands past n_tx are
    # members of neither chain and keep zero slots
    prev, nprev = gg - 100, gg - 90
    nfirst = torch.ones_like(gg, dtype=torch.bool)
    delta = torch.zeros_like(gains)
    use0 = torch.zeros_like(reg)
    for b in range(ctx.n_tx):
        g, is_reg, is_pns = gains[:, b], reg[:, b], pns[:, b]
        dd = g - nprev
        d0, dn = dd.clamp(-256, 255), dd.clamp(-60, 60)
        u0 = is_pns & nfirst
        delta[:, b] = torch.where(is_reg, g - prev, torch.where(u0, d0, dn))
        use0[:, b] = u0
        prev = torch.where(is_reg, g, prev)
        nprev = torch.where(u0, nprev + d0, torch.where(is_pns, nprev + dn, nprev))
        nfirst = nfirst & ~is_pns
    ln, code = _lut_cols((delta + 60).clamp(0, 120), ctx.scf_tab)
    w = torch.where(use0, 9, ln)
    v = torch.where(use0, delta + 256, code)
    member = reg | pns
    return torch.where(member, w, 0), torch.where(member, v, 0), gg


def _tns_groups(ctx, tns_en, tns_order, tns_idx, tns_en_lo, tns_order_lo,
                tns_idx_lo, tns_len=None):
    """[pulse+tns_present], tns_data slots (host _write_tns_data).
    tns_len: [S] per-AU filter-1 length in bands (dynamic: the merged
    filter spans the whole TNS range, encode.py tns_analysis_fdk)."""
    S = tns_en.shape[0]
    cfgd = ctx.tns_cfg
    groups = [(torch.full((S, 1), 2, dtype=I32, device=tns_en.device),
               tns_en.to(I32)[:, None], 2)]
    if cfgd is None:
        return groups
    en = tns_en
    en_lo = tns_en_lo & en
    n_filt = torch.where(en_lo, 2, 1).to(I32)
    order = tns_order.to(I32)
    length = cfgd["length_code"] if tns_len is None else tns_len.to(I32)
    # n_filt(2) coef_res(1) length(6) order(5) dir(1) compress(1)
    v1 = (((((n_filt << 1) | 1) << 6) | length) << 5 | order) << 2
    groups.append((torch.where(en, 16, 0)[:, None].to(I32), v1[:, None], 3))
    k = torch.arange(tns_idx.shape[-1], device=en.device)
    wc = torch.where(en[:, None] & (k[None] < order[:, None]), 4, 0)
    groups.append((wc.to(I32), tns_idx.to(I32) & 0xF, 2))
    order_lo = tns_order_lo.to(I32)
    v2 = ((cfgd["length_code_lo"] << 5 | order_lo) << 2)
    groups.append((torch.where(en_lo, 13, 0)[:, None].to(I32), v2[:, None], 3))
    k2 = torch.arange(tns_idx_lo.shape[-1], device=en.device)
    wc2 = torch.where(en_lo[:, None] & (k2[None] < order_lo[:, None]), 4, 0)
    groups.append((wc2.to(I32), tns_idx_lo.to(I32) & 0xF, 2))
    return groups


def _spectral_groups(ctx, q, books, is_short):
    """spectral_data(): codeword+signs slot and two escape slots per line
    pair, permuted into the short emission order when is_short.
    q: [S, 960] int32; books: [S, NB]."""
    S = q.shape[0]
    aq = q.abs()
    txm = _tx_mask(ctx, is_short)
    bk_band = torch.where(txm & (books != 13), books, 0)  # [S, NB]
    # band-of-pair expansion: a gather by the constant band of each pair
    bk = torch.where(is_short[:, None], bk_band.index_select(1, ctx.bop_short),
                     bk_band.index_select(1, ctx.bop_long))          # [S, 480]

    q4 = q.reshape(S, 240, 4)
    aq4 = aq.reshape(S, 240, 4)
    q2 = q.reshape(S, 480, 2)
    aq2 = aq.reshape(S, 480, 2)

    # quad indices/codes (books 1..4) at quad granularity; the quad index
    # i = ((c0*3+c1)*3+c2)*3+c3 factors as (c0*3+c1)*9 + (c2*3+c3)
    c1 = (q4 + 1).clamp(0, 2)
    a1 = c1[..., 0] * 3 + c1[..., 1]
    b1 = c1[..., 2] * 3 + c1[..., 3]
    c3 = aq4.clamp(0, 2)
    a3 = c3[..., 0] * 3 + c3[..., 1]
    b3 = c3[..., 2] * 3 + c3[..., 3]
    l1, cw1, l2, cw2 = _lut_cols2(a1, b1, ctx.q12)
    l3, cw3, l4, cw4 = _lut_cols2(a3, b3, ctx.q34)

    # pair indices/codes; books 7..11 share one 17-wide index pair
    c5 = (q2 + 4).clamp(0, 8)
    l5, cw5, l6, cw6 = _lut_cols2(c5[..., 0], c5[..., 1], ctx.p56)
    c11 = aq2.clamp(0, 16)
    (l7, cw7, l8, cw8, l9, cw9, l10, cw10, l11, cw11) = _lut_cols2(
        c11[..., 0], c11[..., 1], ctx.pair_tab)

    # sign packing: signs of nonzero values in line order
    def pack_signs(vals, nzs):
        acc = torch.zeros(vals.shape[:-1], dtype=I32, device=vals.device)
        n = torch.zeros_like(acc)
        for j in range(vals.shape[-1]):
            nz = nzs[..., j]
            acc = torch.where(nz, (acc << 1) | (vals[..., j] < 0), acc)
            n = n + nz
        return acc, n

    s4, n4 = pack_signs(q4, aq4 != 0)
    s2, n2 = pack_signs(q2, aq2 != 0)

    # assemble per-pair (cw+signs) width/value by the band's book
    p_even = ctx.pair_even[None]

    def rep(x):
        return x.repeat_interleave(2, dim=1)

    def quad_sel(lq, cwq, signed):
        # valid only at even pairs; widths include sign bits for 3/4
        if signed:
            w = rep(lq + n4)
            v = rep((cwq << n4) | s4)
        else:
            w, v = rep(lq), rep(cwq)
        return torch.where(p_even, w, 0), torch.where(p_even, v, 0)

    w1, v1 = quad_sel(l1, cw1, False)
    w2, v2 = quad_sel(l2, cw2, False)
    w3, v3 = quad_sel(l3, cw3, True)
    w4, v4 = quad_sel(l4, cw4, True)
    w7, v7 = l7 + n2, (cw7 << n2) | s2
    w8, v8 = l8 + n2, (cw8 << n2) | s2
    w9, v9 = l9 + n2, (cw9 << n2) | s2
    w10, v10 = l10 + n2, (cw10 << n2) | s2
    w11, v11 = l11 + n2, (cw11 << n2) | s2

    zero = torch.zeros_like(l5)
    ws = torch.stack([zero, w1, w2, w3, w4, l5, l6, w7, w8, w9, w10, w11], dim=-1)
    vs = torch.stack([zero, v1, v2, v3, v4, cw5, cw6, v7, v8, v9, v10, v11], dim=-1)
    # a book past 11 selects nothing (a one-hot row of zeros)
    sel = bk.clamp(0, 11).long()[..., None]
    has = bk < 12
    w_cw = torch.where(has, ws.gather(-1, sel)[..., 0], 0)
    v_cw = torch.where(has, vs.gather(-1, sel)[..., 0], 0)

    # book-11 escapes per line of the pair: prefix (n-3 ones, one zero) then
    # a - 2^n in n bits, n = bit_length(a) - 1 (host _write_spectrum)
    is11 = bk == 11
    # floor(log2) via the f32 exponent field (exact for ints < 2^24)
    n_esc = (aq2.clamp(min=16).to(torch.float32).view(I32) >> 23) - 127
    esc_on = is11[..., None] & (aq2 >= 16)
    one = torch.ones_like(n_esc)
    w_esc = torch.where(esc_on, 2 * n_esc - 3, 0)
    v_esc = torch.where(esc_on,
                        ((torch.bitwise_left_shift(one, (n_esc - 3).clamp(min=0)) - 2) << n_esc)
                        | (aq2 - torch.bitwise_left_shift(one, n_esc)), 0)

    # interleave [cw+signs, esc0, esc1] per pair -> [S, 480, 3]
    w = torch.stack([w_cw, w_esc[..., 0], w_esc[..., 1]], dim=-1)
    v = torch.stack([v_cw, v_esc[..., 0], v_esc[..., 1]], dim=-1)
    # short emission order: permute pairs (slots ride along)
    short3 = is_short[:, None, None]
    w = torch.where(short3, w.index_select(1, ctx.perm_short), w)
    v = torch.where(short3, v.index_select(1, ctx.perm_short), v)
    return [(w.reshape(S, -1), v.reshape(S, -1), 4)]


def au_content_groups(ctx, o, is_last, pad_buf=None, pad_len=None,
                      sbr_group=None):
    """Slot groups for one AU's content in exact serialization order.

    o: per-AU dict with q [S,ch,960], gains [S,ch,NB], books [S,ch,NB],
    ms_used [S,NB], tns_* per channel, wseq [S] (any integer/bool dtypes);
    is_last: bool, or [S] bool tensor (END is folded into the tail table for
    the last AU); sbr_group: optional (w, v, spans) emitted after the DSE.
    Returns list of (widths, values, spans) with leading dim S."""
    S = o["q"].shape[0]
    dev = o["q"].device
    wseq = o["wseq"].to(I32)
    is_short = wseq == 2
    groups = []

    def const(w, v):
        return (torch.full((S, 1), w, dtype=I32, device=dev),
                torch.full((S, 1), v, dtype=I32, device=dev), 3)

    iw, iv = _ics_info_slot(ctx, wseq, is_short)
    if ctx.n_ch == 2:
        groups.append(const(8, (1 << 5) | 1))         # CPE id+tag+common
        groups.append((iw[:, None], iv[:, None], 3))
        groups.append(const(2, 1))                    # ms_mask_present = 1
        groups.append((_tx_mask(ctx, is_short).to(I32), o["ms_used"].to(I32), 1))
    else:
        groups.append(const(7, 0))                    # SCE id+tag

    tns_len = o.get("tns_len")
    for c in range(ctx.n_ch):
        books = o["books"][:, c].to(I32)
        gains = o["gains"][:, c].to(I32)
        sw, sv = _section_slots(ctx, books, is_short)
        fw, fv, gg = _scf_slots(ctx, books, gains, is_short)
        groups.append((torch.full((S, 1), 8, dtype=I32, device=dev), gg[:, None], 2))
        if ctx.n_ch == 1:
            groups.append((iw[:, None], iv[:, None], 3))
        groups.append((sw, sv, 3))
        groups.append((fw, fv, 4))
        groups.extend(_tns_groups(
            ctx, o["tns_en"][:, c], o["tns_order"][:, c],
            o["tns_idx"][:, c], o["tns_en_lo"][:, c],
            o["tns_order_lo"][:, c], o["tns_idx_lo"][:, c],
            tns_len=tns_len[:, c] if tns_len is not None else None))
        groups.append(const(1, 0))                    # gain_control
        groups.extend(_spectral_groups(ctx, o["q"][:, c].to(I32), books, is_short))

    if pad_buf is not None:
        cnt = pad_len.to(I32)
        has = cnt > 0
        # ID_DSE(3) tag(4) align(1) count(8)  (host write_dse, cnt < 255)
        hv = (4 << 13) | cnt
        groups.append((torch.where(has, 16, 0)[:, None].to(I32), hv[:, None], 3))
        k = torch.arange(pad_buf.shape[1], device=dev)
        wb = torch.where(has[:, None] & (k[None] < cnt[:, None]), 8, 0)
        groups.append((wb.to(I32), pad_buf.to(I32), 2))

    if sbr_group is not None:
        groups.append(sbr_group)

    if isinstance(is_last, torch.Tensor):
        end_w = torch.where(is_last.expand(S), 0, 3)[:, None].to(I32)
    else:
        end_w = torch.full((S, 1), 0 if is_last else 3, dtype=I32, device=dev)
    groups.append((end_w, torch.full((S, 1), 7, dtype=I32, device=dev), 2))  # ID_END (non-last)
    return groups


def pack_au_content(ctx, groups):
    """Pack one AU's content into a left-aligned [S, maxcb] byte buffer and
    return (buf, content_bits [S] int32, crc_part [S] int32) where crc_part
    is the fixed-alignment CRC16 reduction R(buf * x^16)."""
    buf, bits = BP.pack_groups(groups, ctx.maxcb)
    c1 = BP.crc_fixed(buf, ctx.crc16_R, 16, 0)
    return buf, bits.to(I32), c1


# ---------------------------------------------------------------------------
# SBR / PS FIL-element slots (built before the AU loop, over [S, nau])
# ---------------------------------------------------------------------------


def _tab3(code, ln):
    """(len, code) int32 columns for the up-to-24-bit SBR / PS codes (three
    8-bit chunks in the reference)."""
    return np.stack([ln.astype(np.int32), code.astype(np.int32)], -1)


def _delta_chain(vals, start_bits, tab, lav, active):
    """Start + FREQ-delta slot chain mirroring sbr._write_env/_write_noise:
    d = clip(v[i]-prev, +-lav); prev += d.  vals: [..., n] int32; tab: the
    [2 lav + 1, 2] (len, code) tensor; active: [...] bool gating the whole
    chain.  Returns (w, v) [..., n]."""
    n = vals.shape[-1]
    prev = vals[..., 0]
    ds = []
    for i in range(1, n):
        d = (vals[..., i] - prev).clamp(-lav, lav)
        prev = prev + d
        ds.append(d)
    w0 = torch.where(active, start_bits, 0)[..., None].to(I32)
    v0 = torch.where(active, vals[..., 0], 0)[..., None]
    if not ds:
        return w0, v0
    ln, code = _lut_cols(torch.stack(ds, -1) + lav, tab)
    act = active[..., None]
    return (torch.cat([w0, torch.where(act, ln, 0)], -1),
            torch.cat([v0, torch.where(act, code, 0)], -1))


@lru_cache(maxsize=None)
def _sbr_tabs():
    from . import sbr as SB
    return {
        "env60": _tab3(SB.ENV_CODE_F, SB.ENV_LEN_F),
        "env31": _tab3(SB.ENV3_CODE_F, SB.ENV3_LEN_F),
        "noise31": _tab3(SB.NOISE_CODE_F, SB.NOISE_LEN_F),
        "iid14": _tab3(SB.IID_CODE_F, SB.IID_LEN_F),
        "iid30": _tab3(SB.IID_CODE_FF, SB.IID_LEN_FF),
        "icc7": _tab3(SB.ICC_CODE_F, SB.ICC_LEN_F),
        "bal24": _tab3(SB.ENVBAL_CODE_F, SB.ENVBAL_LEN_F),
        "bal12": _tab3(SB.ENVBAL3_CODE_F, SB.ENVBAL3_LEN_F),
        "nbal12": _tab3(SB.NOISEBAL_CODE_F, SB.NOISEBAL_LEN_F),
        "grid": np.stack([np.asarray([m[1] for m in SB.GRID_MENU], np.int32),
                          np.asarray([m[2] for m in SB.GRID_MENU], np.int32)],
                         -1),
    }


def _ps_slot_groups(ctx, side):
    """ps_data slots (sbr._write_ps_data order): header, per-env IID chains,
    per-env ICC chains.  All [S, nau]; returns (groups, ps_bits)."""
    tabs = ctx.sbr_tabs
    iid = side["ps_iid"].to(I32)                    # [S, nau, ne, 20]
    iidf = side["ps_iid_fine"].to(I32)
    icc = side["ps_icc"].to(I32)
    fine = side["ps_fine"].to(torch.bool)           # [S, nau]
    S, nau, ne, nb = iid.shape
    dev = iid.device
    mode = torch.where(fine, 4, 1).to(I32)
    nei = {1: 1, 2: 2, 4: 3}[ne]
    hdr_v = ((((((((3 << 3) | mode) << 1) | 1) << 3) | 1) << 4) | nei)
    groups = [(torch.full((S, nau, 1), 13, dtype=I32, device=dev), hdr_v[..., None], 3)]

    def chains(vals, tab, lav, active):
        out = []
        act1 = active.to(I32)[..., None]
        for e in range(ne):
            # the dt flag: 0 (frequency deltas) on the first envelope
            out.append((act1, act1 * (0 if e == 0 else 1), 2))
            if e == 0:
                base = torch.cat([torch.zeros_like(vals[..., 0, :1]), vals[..., 0, :-1]], -1)
            else:
                base = vals[..., e - 1, :]
            d = (vals[..., e, :] - base).clamp(-lav, lav)
            ln, code = _lut_cols(d + lav, tab)
            out.append((torch.where(active[..., None], ln, 0), code, 4))
        return out

    groups.extend(chains(iid, tabs["iid14"], 14, ~fine))
    groups.extend(chains(iidf, tabs["iid30"], 30, fine))
    groups.extend(chains(icc, tabs["icc7"], 7, torch.ones_like(fine)))
    bits = sum(w.sum(-1) for w, _, _ in groups)
    return groups, bits


def sbr_slot_groups(ctx, side):
    """FIL(EXT_SBR_DATA) slots per AU, [S, nau] leading dims, mirroring
    sbr.write_sbr_payload bit-for-bit: the header is the 22-bit slot plus
    bs_data_extra, as the host writer writes it.  side: the step's sbr_* and
    ps_* outputs as tensors on ctx's device.  Returns (w, v) [S, nau, K]
    int32."""
    enc = ctx.enc
    p = enc.sbr_params
    tabs = ctx.sbr_tabs
    env = side["sbr_env"].to(I32)                   # [S, nau, ch, n_hi]
    env2 = side["sbr_env2"].to(I32)                 # [S, nau, ch, 2, n_hi]
    tr = side["sbr_transient"].to(torch.bool)       # [S, nau, ch]
    nq = side["sbr_noise_q"].to(I32)                # [S, nau, ch, n_q]
    invf = side["sbr_invf"].to(I32)
    ah = side["sbr_addharm"].to(torch.bool)         # [S, nau, ch, n_hi]
    tg = side["sbr_tgrid"].to(I32)
    S, nau, n_ch, n_hi = env.shape
    dev = env.device
    n_q = p.n_q
    au0 = (torch.arange(nau, device=dev) == 0)[None, :, None]     # header on AU 0

    def full(v):
        return torch.full((S, nau, 1), v, dtype=I32, device=dev)

    def const(w, v):
        return (full(w), full(v), 3)

    groups = []
    # bs_header_flag (+ header, AU 0): 1+1+4+4+3+2+1+1+2+1+2 = 22 bits
    hdr_v = (1 << 21) | (1 << 20) | (p.bs_start_freq << 16) \
        | (p.bs_stop_freq << 12) | (p.bs_xover_band << 9) | (0 << 7) \
        | (1 << 6) | (0 << 5) | (p.bs_freq_scale << 3) \
        | (p.bs_alter_scale << 2) | p.bs_noise_bands
    hw = torch.where(au0, 22, 1).to(I32).expand(S, nau, 1)
    hv = torch.where(au0, int(hdr_v), 0).to(I32).expand(S, nau, 1)
    groups.append((hw, hv, 4))
    groups.append(const(1, 0))                      # bs_data_extra
    cpl = side.get("sbr_cpl")
    if n_ch == 2:
        cpl = torch.zeros((S, nau), dtype=torch.bool, device=dev) if cpl is None \
            else cpl.to(torch.bool)
        groups.append((full(1), cpl[..., None].to(I32), 2))       # bs_coupling
    on_all = torch.ones((S, nau), dtype=torch.bool, device=dev)

    def grid(c, gate=None):
        fcl, rel = _lut_cols(tg[..., c], tabs["grid"])
        v12 = (fcl << 10) | (0 << 8) | (1 << 6) | (rel << 4) | (0 << 2) | 3
        t = tr[..., c]
        g = on_all if gate is None else gate
        # else FIXFIX, 1 env, hi-res
        return (torch.where(g, torch.where(t, 12, 5), 0)[..., None].to(I32),
                torch.where(t, v12, 1)[..., None].to(I32), 3)

    def dtdf(c):
        return (torch.where(tr[..., c], 4, 2)[..., None].to(I32), full(0), 2)

    def invf_g(c, gate=None):
        v = torch.zeros((S, nau), dtype=I32, device=dev)
        for i in range(n_q):
            v = (v << 2) | invf[..., c, i]
        g = on_all if gate is None else gate
        return (torch.where(g, 2 * n_q, 0)[..., None].to(I32), v[..., None], 3)

    def env_g(c, gate=None, balance=False):
        t = tr[..., c]
        g = on_all if gate is None else gate
        if balance:
            # coupled channel-1: balance start widths + EnvBalance books
            w1, v1 = _delta_chain(env[..., c, :], 6, tabs["bal24"], 24, ~t & g)
            w2a, v2a = _delta_chain(env2[..., c, 0, :], 5, tabs["bal12"], 12, t & g)
            w2b, v2b = _delta_chain(env2[..., c, 1, :], 5, tabs["bal12"], 12, t & g)
        else:
            w1, v1 = _delta_chain(env[..., c, :], 7, tabs["env60"], 60, ~t & g)
            w2a, v2a = _delta_chain(env2[..., c, 0, :], 6, tabs["env31"], 31, t & g)
            w2b, v2b = _delta_chain(env2[..., c, 1, :], 6, tabs["env31"], 31, t & g)
        return [(w1, v1, 4), (w2a, v2a, 4), (w2b, v2b, 4)]

    def noise_g(c, gate=None, balance=False):
        t = tr[..., c]
        g = on_all if gate is None else gate
        tab, lav = (tabs["nbal12"], 12) if balance else (tabs["noise31"], 31)
        wa, va = _delta_chain(nq[..., c, :], 5, tab, lav, g)
        wb, vb = _delta_chain(nq[..., c, :], 5, tab, lav, t & g)
        return [(wa, va, 4), (wb, vb, 4)]

    def ah_g(c):
        flags = ah[..., c, :]
        anyf = flags.any(-1)
        v = torch.zeros((S, nau), dtype=I32, device=dev)
        for i in range(n_hi):
            v = (v << 1) | flags[..., i].to(I32)
        w = torch.where(anyf, 1 + n_hi, 1)
        return (w[..., None].to(I32), torch.where(anyf, (1 << n_hi) | v, 0)[..., None], 4)

    if n_ch == 2:
        # per-AU layouts: LR = gridL gridR dtdfL dtdfR invfL invfR envL
        # envR noiseL noiseR; COUPLED = gridL dtdfL dtdfR invfL envL
        # noiseL envR(bal) noiseR(bal).  Complementary-gated groups in a
        # merged order keep every slot static-shaped.
        groups.append(grid(0))
        groups.append(grid(1, gate=~cpl))
        groups.append(dtdf(0))
        groups.append(dtdf(1))
        groups.append(invf_g(0))
        groups.append(invf_g(1, gate=~cpl))
        groups.extend(env_g(0))
        groups.extend(noise_g(0, gate=cpl))          # coupled: noise L here
        groups.extend(env_g(1, gate=~cpl))
        groups.extend(env_g(1, gate=cpl, balance=True))
        groups.extend(noise_g(0, gate=~cpl))
        groups.extend(noise_g(1, gate=~cpl))
        groups.extend(noise_g(1, gate=cpl, balance=True))
        groups.append(ah_g(0))
        groups.append(ah_g(1))
    else:
        groups.append(grid(0))
        groups.append(dtdf(0))
        groups.append(invf_g(0))
        groups.extend(env_g(0))
        groups.extend(noise_g(0))
        groups.append(ah_g(0))

    if enc.is_ps:
        ps_groups, ps_bits = _ps_slot_groups(ctx, side)
        ext_bits = 2 + ps_bits                      # ext id + ps data
        ext_sz = torch.div(ext_bits + 7, 8, rounding_mode="floor")
        esc = ext_sz >= 15
        # bs_extended(1) + size(4) [+ esc(8)]
        w = torch.where(esc, 13, 5)
        v = torch.where(esc, (1 << 12) | (15 << 8) | (ext_sz - 15), (1 << 4) | ext_sz)
        groups.append((w[..., None].to(I32), v[..., None].to(I32), 3))
        groups.append(const(2, 2))                  # bs_extension_id = PS
        groups.extend(ps_groups)
        pad = ext_sz * 8 - ext_bits
        groups.append((pad[..., None].to(I32), full(0), 1))
    else:
        groups.append(const(1, 0))                  # bs_extended_data

    sbr_bits = sum(w.sum(-1) for w, _, _ in groups)
    cnt = torch.div(4 + sbr_bits + 7, 8, rounding_mode="floor")
    esc = cnt >= 15
    # FIL hdr: ID_FIL(3) cnt(4) [esc(8)] EXT_SBR_DATA(4)
    fw = torch.where(esc, 19, 11)
    fv = torch.where(esc, (6 << 16) | (15 << 12) | ((cnt - 14) << 4) | 13,
                     (6 << 8) | (cnt << 4) | 13)
    head = (fw[..., None].to(I32), fv[..., None].to(I32), 4)
    tail_pad = cnt * 8 - 4 - sbr_bits
    tailg = (tail_pad[..., None].to(I32), full(0), 1)
    groups = [head] + groups + [tailg]
    w = torch.cat([g[0].to(I32) for g in groups], dim=-1)
    v = torch.cat([g[1].to(I32) for g in groups], dim=-1)
    return w, v


CORE_KEYS = ("q", "gains", "books", "ms_used", "tns_en", "tns_order", "tns_idx", "tns_en_lo",
              "tns_order_lo", "tns_idx_lo", "tns_len", "wseq")


def pad_arrays(pads, S, nau, padmax):
    """[S][nau] X-PAD byte strings (or None) -> (pad_buf [S, nau, padmax],
    pad_len [S, nau]) int32 numpy, as the step's pad arguments."""
    pb = np.zeros((S, nau, padmax), np.int32)
    pl = np.zeros((S, nau), np.int32)
    if pads is not None:
        for s in range(S):
            for a, p in enumerate(pads[s]):
                if p:
                    pb[s, a, :len(p)] = np.frombuffer(p, np.uint8)
                    pl[s, a] = len(p)
    return pb, pl


def pack_from_outputs(enc, out, pads=None, add_rs=True, ctx=None):
    """Validation entry: host-mode step outputs [S, nau, ...] (tensors on any
    device, or numpy) -> device-packed superframes [S, bytes] uint8 (numpy),
    packed on the encoder's device.  The production path packs inside the
    model's AU loop; this one lets tests compare the device packer against
    the host packer on the *same* encoder decisions.  ctx: the tables to
    use (default: the encoder's, or ones built for this call)."""
    if ctx is None:
        ctx = enc.aupack_ctx if enc.aupack_ctx is not None else AuPackCtx(enc)
    dev = ctx.device
    out = {k: torch.as_tensor(v).to(dev) for k, v in out.items()}
    S, nau = out["q"].shape[:2]
    pb = pl = None
    if pads is not None:
        pb, pl = (torch.as_tensor(x, device=dev)
                  for x in pad_arrays(pads, S, nau, max(1, enc.cfg.pad_len)))
    sw = sv = None
    if enc.is_sbr:
        sw, sv = sbr_slot_groups(ctx, {k: v for k, v in out.items()
                                       if k.startswith(("sbr_", "ps_"))})
    bufs, bits, crcs = [], [], []
    for a in range(nau):
        fr = {k: out[k][:, a] for k in CORE_KEYS}
        groups = au_content_groups(
            ctx, fr, a == nau - 1,
            pad_buf=pb[:, a] if pb is not None else None,
            pad_len=pl[:, a] if pl is not None else None,
            sbr_group=(sw[:, a], sv[:, a], 4) if sw is not None else None)
        buf, b, c = pack_au_content(ctx, groups)
        bufs.append(buf)
        bits.append(b)
        crcs.append(c)
    sf, _ = assemble_superframes(ctx, torch.stack(bufs, 1), torch.stack(bits, 1),
                                 torch.stack(crcs, 1), add_rs=add_rs)
    return sf.cpu().numpy()


# ---------------------------------------------------------------------------
# superframe assembly (after the AU loop)
# ---------------------------------------------------------------------------


def assemble_superframes(ctx, aubuf, au_bits, crc_part, add_rs=True):
    """aubuf: [S, nau, maxcb] integer bytes; au_bits/crc_part: [S, nau].
    Returns ([S, total(+parity)] uint8, au_len_bytes [S, nau] int32)."""
    S, nau, maxcb = aubuf.shape
    dev = aubuf.device
    total = ctx.total
    hb = ctx.header_bytes
    au_bits = au_bits.to(I32)
    crc_part = crc_part.to(I32)

    # AU byte lengths and starts (tpenc_dab.cpp:361-433 semantics)
    lens = torch.div(au_bits + 7, 8, rounding_mode="floor")     # non-last, incl. END
    start_list = [torch.full((S,), hb, dtype=I32, device=dev)]
    for a in range(nau - 1):
        start_list.append(start_list[-1] + lens[:, a] + 2)
    starts = torch.stack(start_list, dim=1)         # [S, nau]
    last_len = total - 2 - starts[:, -1]
    lens = lens.clone()
    lens[:, -1] = last_len
    tail_d = last_len * 8 - au_bits[:, -1]          # fill + END + align bits

    # AU CRCs: ilut[Pb] ^ mulmod(c1, shiftlut[Pb]) (+ tail term, last AU);
    # a length or tail width outside its table (an AU past the pack bound)
    # reads 0 and corrupts that stream alone
    shift = _lut16(lens, ctx.crc_shift)
    init = _lut16(lens, ctx.crc_init)
    crc = init ^ _mulmod_dev(crc_part, shift)
    n_d = ctx.tail_crc.shape[0]
    crc[:, -1] = crc[:, -1] ^ _lut16(tail_d, ctx.tail_crc)
    crc = crc ^ 0xFFFF

    # tail slots (last AU): the host-simulated fill+END of this tail width
    d_ok = ((tail_d >= 0) & (tail_d < n_d))[:, None]
    d_idx = tail_d.clamp(0, n_d - 1).long()
    tw = torch.where(d_ok, ctx.tail_w[d_idx], 0)
    tv = torch.where(d_ok, ctx.tail_v[d_idx], 0)

    def full(n, v):
        return torch.full((S, n), v, dtype=I32, device=dev)

    # superframe header fields
    fields = [(full(1, 16), full(1, 0), 3),         # firecode placeholder
              (full(1, 8), full(1, ctx.flags_byte), 2)]
    if nau > 1:
        fields.append((full(nau - 1, 12), starts[:, 1:], 3))
    if ctx.hdr_pad4:
        fields.append((full(1, 4), full(1, 0), 2))

    # raw byte placements: AU content bytes + CRC bytes
    k = torch.arange(maxcb, device=dev, dtype=I32)
    au_idx = starts[:, :, None] + k[None, None]
    au_ok = k[None, None] < lens[:, :, None]
    au_idx = torch.where(au_ok, au_idx, total + 31).reshape(S, -1)
    au_val = torch.where(au_ok, aubuf.to(I32), 0).reshape(S, -1)
    crc_idx = torch.stack([starts + lens, starts + lens + 1], -1).reshape(S, -1)
    crc_val = torch.stack([crc >> 8, crc & 0xFF], -1).reshape(S, -1)

    core, _ = BP.pack_groups(fields, total, raw=[(au_idx, au_val), (crc_idx, crc_val)])
    # last AU's fill tail at bit offset start*8 + content_bits
    tail_base = starts[:, -1] * 8 + au_bits[:, -1]
    tail_buf, _ = BP.pack_groups([(tw, tv, 3)], total, bit_base=tail_base.long())
    core = core + tail_buf

    # firecode over bytes 2..10 (tpenc_dab.cpp:200-201,436-451)
    fc = BP.crc_fixed(core[:, 2:11], ctx.fire_R, 16, 0).to(core.dtype)
    core = torch.cat([(fc >> 8)[:, None], (fc & 0xFF)[:, None], core[:, 2:]], dim=1)
    if not add_rs:
        return core.to(torch.uint8), lens
    # RS(120,110) column interleave (odr-audioenc.cpp:1189-1206): byte p at
    # (col p//subch, row p%subch); each row is one codeword
    subch = total // 110
    rows = core.reshape(S, 110, subch).to(torch.uint8)
    data = rows.movedim(1, 2)                        # [S, subch, 110]
    sh = torch.arange(7, -1, -1, device=dev, dtype=I32)
    bits = ((data[..., None].to(I32) >> sh) & 1).reshape(S, subch, 880).to(torch.float32)
    par_bits = torch.round(bits @ ctx.rs_M).to(I32) & 1          # 0/1 operands: exact
    parity = (par_bits.reshape(S, subch, 10, 8) << sh).sum(-1).to(torch.uint8)
    out = torch.cat([rows, parity.movedim(1, 2)], dim=1)
    return out.reshape(S, 120 * subch), lens
