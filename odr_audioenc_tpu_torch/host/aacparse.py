"""AAC LC (960-frame) AU syntax parser: the bit-exact inverse of the AU
writer (aacpack.py), able to read BOTH our streams and the reference
encoder's (fdk-aac bitenc.cpp output) down to per-band decisions.

Purpose: diagnostics and parity checks - given any DAB+ AU this recovers
window sequence, grouping, section codebooks (incl. ZERO/NOISE/INTENSITY),
scalefactors / PNS noise energies, M/S mask, TNS filters and the raw
quantized spectrum, so encoder decisions can be compared on the wire
(syntax per ISO 14496-3 4.4.2; reference reader libAACdec
src/channelinfo.cpp + block.cpp).
"""
import numpy as np

from ..dabplus import tables as AT

ZERO_HCB = 0
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15
QUAD_BOOKS = (1, 2, 3, 4)
SIGNED_BOOKS = (1, 2, 5, 6)

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)


class BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0          # bit position

    def get(self, n):
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def bits_left(self):
        return len(self.data) * 8 - self.pos


def _build_decoder(code, length):
    """(code, len) arrays -> dict[(len, code)] = flat index."""
    code = np.asarray(code)
    length = np.asarray(length)
    if code.shape != length.shape:       # book 11 code table has pad rows
        sl = tuple(slice(0, min(a, b)) for a, b in zip(code.shape, length.shape))
        code, length = code[sl], length[sl]
    code = code.reshape(-1)
    length = length.reshape(-1)
    return {(int(length[i]), int(code[i])): i for i in range(code.size)}


class _Tables:
    _inst = None

    def __init__(self):
        self.dec = {}
        for b in range(1, 12):
            self.dec[b] = _build_decoder(AT.HUFF_CODE[b], AT.HUFF_LEN[b])
        self.dec_scf = _build_decoder(AT.HUFF_CODE_SCF, AT.HUFF_LEN_SCF)
        self.dims = {b: np.asarray(AT.HUFF_LEN[b]).shape for b in range(1, 12)}
        self.maxlen = {b: int(np.asarray(AT.HUFF_LEN[b]).max())
                       for b in range(1, 12)}
        self.maxlen_scf = int(np.asarray(AT.HUFF_LEN_SCF).max())

    @classmethod
    def get(cls):
        if cls._inst is None:
            cls._inst = cls()
        return cls._inst


def _huff(br, dec, maxlen):
    code = 0
    for ln in range(1, maxlen + 1):
        code = (code << 1) | br.get(1)
        v = dec.get((ln, code))
        if v is not None:
            return v
    raise ValueError("invalid Huffman codeword")


def _decode_tuple(br, book, t):
    """One spectral codeword -> list of quantized values."""
    dims = t.dims[book]
    flat = _huff(br, t.dec[book], t.maxlen[book])
    idx = list(np.unravel_index(flat, dims))
    if book in (1, 2):
        vals = [i - 1 for i in idx]
    elif book in (5, 6):
        vals = [i - 4 for i in idx]
    else:
        vals = idx            # magnitudes (book 11: 16 = escape flag)
        signs = [br.get(1) if v else 0 for v in vals]
        if book == ESC_HCB:
            out = []
            for v in vals:
                if v >= 16:
                    c = 0
                    while br.get(1):
                        c += 1
                    n = c + 4
                    v = (1 << n) + br.get(n)
                out.append(v)
            vals = out
        vals = [-v if s else v for v, s in zip(vals, signs)]
    return vals


def _parse_ics_info(br):
    br.get(1)                              # ics_reserved
    wseq = br.get(2)
    wshape = br.get(1)
    if wseq == 2:
        max_sfb = br.get(4)
        grouping = br.get(7)
    else:
        max_sfb = br.get(6)
        grouping = None
        br.get(1)                          # predictor_data_present (0 in LC)
    return dict(window_sequence=wseq, window_shape=wshape,
                max_sfb=max_sfb, grouping=grouping)


def _groups_of(grouping):
    """scale_factor_grouping (7 bits, window 8..2) -> list of group lengths."""
    lens = [1]
    for i in range(7):
        if (grouping >> (6 - i)) & 1:
            lens[-1] += 1
        else:
            lens.append(1)
    return lens


def _sect_offsets(info, rate):
    """Per-group sfb line-offset table (coding order)."""
    if info["window_sequence"] == 2:
        swb = np.asarray(AT.SFB_SHORT[rate])
        w = np.concatenate([swb, [AT.NS - swb.sum()]]) if swb.sum() < AT.NS \
            else swb
        off = np.concatenate([[0], np.cumsum(w)])
        glens = _groups_of(info["grouping"])
        return [off * g for g in glens], glens
    off = AT.sfb_offsets(rate)
    return [np.asarray(off)], [1]


def _parse_section_data(br, info):
    long_win = info["window_sequence"] != 2
    bits, esc = (5, 31) if long_win else (3, 7)
    n_groups = 1 if long_win else len(_groups_of(info["grouping"]))
    sects = []
    for g in range(n_groups):
        k = 0
        gs = []
        while k < info["max_sfb"]:
            cb = br.get(4)
            ln = 0
            while True:
                inc = br.get(bits)
                ln += inc
                if inc != esc:
                    break
            gs.append((cb, k, k + ln))
            k += ln
        sects.append(gs)
    return sects


def _parse_scale_factors(br, info, sects, global_gain, t):
    n_groups = len(sects)
    sf = [[None] * info["max_sfb"] for _ in range(n_groups)]
    books = [[ZERO_HCB] * info["max_sfb"] for _ in range(n_groups)]
    last_sf = global_gain
    last_nrg = global_gain - 90
    last_is = 0
    noise_first = True
    for g in range(n_groups):
        for cb, lo, hi in sects[g]:
            for b in range(lo, hi):
                books[g][b] = cb
                if cb == ZERO_HCB:
                    continue
                if cb in (INTENSITY_HCB, INTENSITY_HCB2):
                    last_is += _huff(br, t.dec_scf, t.maxlen_scf) - 60
                    sf[g][b] = last_is
                elif cb == NOISE_HCB:
                    if noise_first:
                        last_nrg += br.get(9) - 256
                        noise_first = False
                    else:
                        last_nrg += _huff(br, t.dec_scf, t.maxlen_scf) - 60
                    sf[g][b] = last_nrg
                else:
                    last_sf += _huff(br, t.dec_scf, t.maxlen_scf) - 60
                    sf[g][b] = last_sf
    return sf, books


def _parse_tns(br, info):
    long_win = info["window_sequence"] != 2
    n_windows = 1 if long_win else 8
    filters = []
    for _ in range(n_windows):
        n_filt = br.get(2 if long_win else 1)
        wf = []
        coef_res = br.get(1) if n_filt else 0
        for _ in range(n_filt):
            length = br.get(6 if long_win else 4)
            order = br.get(5 if long_win else 3)
            f = dict(length=length, order=order, coefs=[])
            if order:
                f["direction"] = br.get(1)
                compress = br.get(1)
                nb = coef_res + 3 - compress
                f["coefs"] = [br.get(nb) for _ in range(order)]
            wf.append(f)
        filters.append(wf)
    return filters


def _parse_spectral(br, info, sects, rate, t):
    offs, glens = _sect_offsets(info, rate)
    n_groups = len(sects)
    qs = []
    for g in range(n_groups):
        off = offs[g]
        width = int(off[-1]) if info["window_sequence"] == 2 else AT.N
        q = np.zeros(max(width, int(off[min(info["max_sfb"], len(off) - 1)])),
                     np.int32)
        for cb, lo, hi in sects[g]:
            if cb == ZERO_HCB or cb >= NOISE_HCB:
                continue
            step = 4 if cb in QUAD_BOOKS else 2
            a, b = int(off[lo]), int(off[hi])
            for i in range(a, b, step):
                q[i:i + step] = _decode_tuple(br, cb, t)
        qs.append(q)
    return qs


def _parse_ics(br, info, rate, t, common_info=None):
    global_gain = br.get(8)
    if info is None:
        info = _parse_ics_info(br)
    sects = _parse_section_data(br, info)
    sf, books = _parse_scale_factors(br, info, sects, global_gain, t)
    out = dict(global_gain=global_gain, info=info, sections=sects,
               sf=sf, books=books, tns=None)
    if br.get(1):                          # pulse_data_present
        n_pulse = br.get(2)
        br.get(6)
        for _ in range(n_pulse + 1):
            br.get(5), br.get(4)
    if br.get(1):                          # tns_data_present
        out["tns"] = _parse_tns(br, info)
    assert br.get(1) == 0, "gain_control unsupported"
    out["q"] = _parse_spectral(br, info, sects, rate, t)
    return out


def parse_au(data, rate=48000):
    """Parse one AU (raw_data_block).  Returns list of element dicts."""
    t = _Tables.get()
    br = BitReader(data)
    elements = []
    while br.bits_left() >= 3:
        eid = br.get(3)
        if eid == ID_END:
            elements.append(dict(id="END"))
            break
        if eid == ID_SCE:
            br.get(4)                      # element_instance_tag
            ch = _parse_ics(br, None, rate, t)
            elements.append(dict(id="SCE", channels=[ch],
                                 info=ch["info"], ms_used=None))
        elif eid == ID_CPE:
            br.get(4)
            common = br.get(1)
            ms_used = None
            info = None
            if common:
                info = _parse_ics_info(br)
                n_groups = 1 if info["window_sequence"] != 2 \
                    else len(_groups_of(info["grouping"]))
                msp = br.get(2)
                if msp == 1:
                    ms_used = [[br.get(1) for _ in range(info["max_sfb"])]
                               for _ in range(n_groups)]
                elif msp == 2:
                    ms_used = [[1] * info["max_sfb"]
                               for _ in range(n_groups)]
                else:
                    ms_used = [[0] * info["max_sfb"]
                               for _ in range(n_groups)]
            ch0 = _parse_ics(br, info, rate, t)
            ch1 = _parse_ics(br, info if common else None, rate, t)
            elements.append(dict(id="CPE", channels=[ch0, ch1],
                                 info=ch0["info"], ms_used=ms_used))
        elif eid == ID_DSE:
            br.get(4)
            align = br.get(1)
            cnt = br.get(8)
            if cnt == 255:
                cnt += br.get(8)
            if align:
                br.pos = (br.pos + 7) & ~7
            payload = bytes(br.get(8) for _ in range(cnt))
            elements.append(dict(id="DSE", payload=payload))
        elif eid == ID_FIL:
            cnt = br.get(4)
            if cnt == 15:
                cnt += br.get(8) - 1
            for _ in range(cnt):
                br.get(8)
            elements.append(dict(id="FIL", count=cnt))
        else:
            raise ValueError(f"unsupported element id {eid}")
    return elements
