"""Host-side DAB+ AU bitstream writer and superframe assembly.

AU syntax: MPEG-4 AAC-LC raw_data_block (SCE/CPE, long windows), matching the
bit packing of the reference writer (bit_cnt.cpp:725-938 codeword/sign/escape
order, bitenc.cpp element layout).  Superframe: ETSI TS 102 563 as produced by
tpenc_dab.cpp (header, au_start back-patch, inverted AU CRC16 0x1021, FIL
padding, firecode 0x782d) plus the RS(120,110) column interleave from
odr-audioenc.cpp:1189-1206.
"""
import numpy as np

from ..dabplus import tables as AT
from ..fec.rs import superframe_add_rs
from .bitwriter import BitWriter

SIGNED_BOOKS = {1, 2, 5, 6}
QUAD_BOOKS = {1, 2, 3, 4}


def crc16_ccitt(data, init=0xFFFF, poly=0x1021):
    crc = init
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def firecode_crc(data):
    """CRC16 poly 0x782d, init 0 (tpenc_dab.cpp:200)."""
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x782D) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _write_spectrum(bw, q, book, lo, hi):
    step = 4 if book in QUAD_BOOKS else 2
    code = AT.HUFF_CODE[book]
    ln = AT.HUFF_LEN[book]
    for i in range(lo, hi, step):
        vals = [int(v) for v in q[i:i + step]]
        if book in (1, 2):
            idx = tuple(v + 1 for v in vals)
            bw.put(int(code[idx]), int(ln[idx]))
        elif book in (3, 4):
            idx = tuple(abs(v) for v in vals)
            bw.put(int(code[idx]), int(ln[idx]))
            for v in vals:
                if v:
                    bw.put(1 if v < 0 else 0, 1)
        elif book in (5, 6):
            idx = (vals[0] + 4, vals[1] + 4)
            bw.put(int(code[idx]), int(ln[idx]))
        elif book in (7, 8, 9, 10):
            idx = (abs(vals[0]), abs(vals[1]))
            bw.put(int(code[idx]), int(ln[idx]))
            for v in vals:
                if v:
                    bw.put(1 if v < 0 else 0, 1)
        else:  # book 11 with escapes
            a0, a1 = abs(vals[0]), abs(vals[1])
            idx = (min(a0, 16), min(a1, 16))
            bw.put(int(code[idx]), int(ln[idx]))
            for v in vals:
                if v:
                    bw.put(1 if v < 0 else 0, 1)
            for a in (a0, a1):
                if a >= 16:
                    n = a.bit_length() - 1
                    bw.put((((1 << (n - 3)) - 2) << n) | (a - (1 << n)), 2 * n - 3)


def _write_tns_data(bw, order, coefs, length_code,
                    order_lo=0, coefs_lo=None, length_code_lo=0):
    """tns_data(), long window, one or two filters (14496-3; parsed by the
    reference decoder at aacdec_tns.cpp:142-240): coef_res=1 (4-bit),
    forward direction, no compression.  Filter 0 covers the TOP
    `length_code` bands, the optional LO filter the next `length_code_lo`
    below (fdk's HIFILT/LOFILT split, aacenc_tns.cpp:440-452)."""
    n_filt = 2 if order_lo > 0 else 1
    bw.put(n_filt, 2)            # n_filt
    bw.put(1, 1)                 # coef_res -> resolution 4
    bw.put(length_code, 6)       # length (bands, from the top)
    bw.put(order, 5)             # order
    bw.put(0, 1)                 # direction: forward
    bw.put(0, 1)                 # coef_compress
    for i in range(order):
        bw.put(int(coefs[i]) & 0xF, 4)
    if n_filt == 2:
        bw.put(length_code_lo, 6)
        bw.put(order_lo, 5)
        bw.put(0, 1)
        bw.put(0, 1)
        for i in range(order_lo):
            bw.put(int(coefs_lo[i]) & 0xF, 4)


def _short_bands(short_info):
    """Transmitted grouped bands for the fixed {4,4} grouping:
    [(band_index_in_device_layout, group, sfb), ...] in coding order."""
    nsfb, max_sfb_s = short_info["nsfb"], short_info["max_sfb"]
    return [(g * nsfb + b, g, b)
            for g in range(AT.N_GROUPS) for b in range(max_sfb_s)]


def _write_ics(bw, q, gains, books, max_sfb, sfb_off, include_info, tns=None,
               short_info=None, wseq=0):
    """individual_channel_stream (no pulse/gain_control).  Long windows, or
    EIGHT_SHORT with the fixed {4,4} grouping when short_info is given."""
    if short_info is None:
        tx = [(b, 0, b) for b in range(max_sfb)]
        sect_len_bits, sect_esc = 5, 31
    else:
        tx = _short_bands(short_info)
        sect_len_bits, sect_esc = 3, 7
    nz = [gb for gb, _, _ in tx if books[gb] > 0 and books[gb] != 13]
    global_gain = int(gains[nz[0]]) + 100 if nz else 100
    global_gain = min(max(global_gain, 0), 255)
    bw.put(global_gain, 8)
    if include_info:
        _write_ics_info(bw, max_sfb, short_info, wseq)
    # section_data: runs of equal codebook; sections restart at each group
    n_per_group = max_sfb if short_info is None else short_info["max_sfb"]
    for g0 in range(0, len(tx), n_per_group):
        grp = tx[g0:g0 + n_per_group]
        i = 0
        while i < len(grp):
            j = i
            while j < len(grp) and books[grp[j][0]] == books[grp[i][0]]:
                j += 1
            bw.put(int(books[grp[i][0]]), 4)
            ln = j - i
            while ln >= sect_esc:
                bw.put(sect_esc, sect_len_bits)
                ln -= sect_esc
            bw.put(ln, sect_len_bits)
            i = j
    # scale_factor_data: regular dpcm chain over spectral bands; PNS bands
    # (NOISE_HCB=13) carry noise energies in their own chain - 9-bit PCM for
    # the first, scf-huffman deltas after (aacdec_pns.cpp CPns_Read)
    prev = global_gain - 100
    noise_prev = None
    for gb, _, _ in tx:
        bk = int(books[gb])
        if bk == 13:
            v = int(gains[gb])
            if noise_prev is None:
                delta0 = max(-256, min(255, v - (global_gain - 90)))
                bw.put(delta0 + 256, 9)
                noise_prev = (global_gain - 90) + delta0
            else:
                d = max(-60, min(60, v - noise_prev))
                bw.put(int(AT.HUFF_CODE_SCF[d + 60]), int(AT.HUFF_LEN_SCF[d + 60]))
                noise_prev += d
        elif bk > 0:
            delta = int(gains[gb]) - prev
            assert -60 <= delta <= 60, f"scf delta {delta} out of range"
            bw.put(int(AT.HUFF_CODE_SCF[delta + 60]), int(AT.HUFF_LEN_SCF[delta + 60]))
            prev = int(gains[gb])
    bw.put(0, 1)  # pulse_data_present
    if tns is not None and tns[0]:
        bw.put(1, 1)  # tns_data_present
        if len(tns) > 4 and tns[4]:
            _write_tns_data(bw, tns[1], tns[2], tns[3],
                            order_lo=tns[5], coefs_lo=tns[6],
                            length_code_lo=tns[7])
        else:
            _write_tns_data(bw, tns[1], tns[2], tns[3])
    else:
        bw.put(0, 1)  # tns_data_present
    bw.put(0, 1)  # gain_control_data_present
    # spectral_data: long = contiguous sfb ranges; short = per grouped band,
    # the sfb's lines from each window of the group in order (the window-
    # major device layout is chunked per window; widths %4 keep codewords
    # from straddling chunks, so per-chunk emission is the transmitted order)
    if short_info is None:
        for b in range(max_sfb):
            if books[b] > 0 and books[b] != 13:
                bw_book = int(books[b])
                _write_spectrum(bw, q, bw_book, int(sfb_off[b]), int(sfb_off[b + 1]))
    else:
        off = short_info["sfb_off"]
        wpg = 8 // AT.N_GROUPS
        for gb, g, b in tx:
            if books[gb] > 0 and books[gb] != 13:
                for w in range(g * wpg, (g + 1) * wpg):
                    _write_spectrum(bw, q, int(books[gb]),
                                    w * AT.NS + int(off[b]),
                                    w * AT.NS + int(off[b + 1]))


def _write_ics_info(bw, max_sfb, short_info=None, wseq=0):
    bw.put(0, 1)            # ics_reserved
    if short_info is None:
        bw.put(wseq, 2)     # window_sequence (LONG/START/STOP)
        bw.put(0, 1)        # window_shape = sine
        bw.put(max_sfb, 6)
        bw.put(0, 1)        # predictor_data_present
    else:
        bw.put(2, 2)        # window_sequence = EIGHT_SHORT
        bw.put(0, 1)        # window_shape = sine
        bw.put(short_info["max_sfb"], 4)
        bw.put(AT.SCF_GROUPING, 7)


def write_au(q, gains, books, max_sfb, sfb_off, n_ch, ms_used=None, tns=None,
             wseq=0, short_info=None):
    """q: [ch, 960] int; gains/books: [ch, NB]; ms_used: [NB] bool or None;
    tns: per-channel (enabled, order, coef indices, length_code) or None;
    wseq: window sequence (0 LONG / 1 START / 2 EIGHT_SHORT / 3 STOP) -
    START/STOP share the long syntax (they differ only in the analysis
    window, which is signalled by window_sequence for the decoder's
    overlap-add); short_info: dict(nsfb, max_sfb, sfb_off) when wseq == 2.
    Returns the AU's BitWriter (content bits only - no END/align/CRC)."""
    si = short_info if wseq == 2 else None
    bw = BitWriter()
    if n_ch == 1:
        bw.put(0, 3)  # id_syn_ele SCE
        bw.put(0, 4)  # instance tag
        _write_ics(bw, q[0], gains[0], books[0], max_sfb, sfb_off,
                   include_info=True, tns=tns[0] if tns else None,
                   short_info=si, wseq=wseq)
    else:
        bw.put(1, 3)  # CPE
        bw.put(0, 4)
        bw.put(1, 1)  # common_window
        _write_ics_info(bw, max_sfb, si, wseq)
        bw.put(1, 2)  # ms_mask_present = 1 (per-band flags)
        if si is None:
            for b in range(max_sfb):
                bw.put(1 if (ms_used is not None and ms_used[b]) else 0, 1)
        else:
            for gb, _, _ in _short_bands(si):
                bw.put(1 if (ms_used is not None and ms_used[gb]) else 0, 1)
        for c in range(2):
            _write_ics(bw, q[c], gains[c], books[c], max_sfb, sfb_off,
                       include_info=False, tns=tns[c] if tns else None,
                       short_info=si)
    return bw


def write_dse(bw, payload, instance_tag=0):
    """data_stream_element carrying ancillary data (X-PAD), as
    FDKaacEnc_writeDataStreamElement (bitenc.cpp:725-800) emits it."""
    data = bytes(payload)
    while data:
        cnt = min(510, len(data))
        bw.put(4, 3)  # ID_DSE
        bw.put(instance_tag, 4)
        bw.put(0, 1)  # data_byte_align_flag
        if cnt >= 255:
            bw.put(255, 8)
            bw.put(cnt - 255, 8)
        else:
            bw.put(cnt, 8)
        for b in data[:cnt]:
            bw.put(b, 8)
        data = data[cnt:]


def _fill_raw_data_block(bw, payload_bits):
    """dabWrite_FillRawDataBlock (tpenc_dab.cpp:312-360), bit-faithful."""
    while payload_bits >= 7:
        payload_bits -= 7
        esc_count = -1
        if payload_bits >= 15 * 8:
            payload_bits -= 8
            esc_count = 0
        cnt = min(269, payload_bits >> 3)
        if cnt >= 15:
            esc_count = cnt - 15 + 1
        bw.put(6, 3)  # ID_FIL
        if esc_count >= 0:
            bw.put(15, 4)
            bw.put(esc_count, 8)
        else:
            bw.put(cnt, 4)
        cnt_bits = min(cnt * 8, payload_bits)
        # extension payload: EXT_FIL type + fill nibble + zero bytes
        if cnt_bits >= 4:
            bw.put(0, 4)  # EXT_FIL
            wb = cnt_bits - 8
            bw.put(0, 4)  # fill nibble
            while wb >= 8:
                bw.put(0x00, 8)
                wb -= 8
        payload_bits -= cnt_bits


class SuperframePacker:
    """Assemble DAB+ superframes from per-AU writer outputs.

    One instance per stream config (channels, rate, subchannel index, flags).
    """

    def __init__(self, subch, sample_rate=48000, channels=2, sbr=False, ps=False):
        self.subch = subch
        self.total = subch * 110
        self.dac_rate = 1 if sample_rate in (24000, 48000) else 0
        self.sbr = 1 if sbr else 0
        self.ps = 1 if ps else 0
        self.ch_mode = 1 if channels == 2 else 0
        self.num_aus = {(1, 0): 6, (0, 0): 4, (1, 1): 3, (0, 1): 2}[
            (self.dac_rate, self.sbr)]
        hdr_bits = 16 + 8 + (self.num_aus - 1) * 12
        if self.dac_rate == 0 or self.sbr == 0:
            hdr_bits += 4
        assert hdr_bits % 8 == 0
        self.header_bytes = hdr_bits // 8

    def payload_bits(self):
        """usable AU payload bits per superframe (before FIL padding)."""
        return (self.total - self.header_bytes - 2 * self.num_aus) * 8 \
            - 3 * self.num_aus  # ID_END per AU

    def assemble(self, au_writers, add_rs=True):
        """au_writers: list of num_aus BitWriter objects (AU content).
        Returns superframe bytes ([subch*120] if add_rs else [subch*110])."""
        assert len(au_writers) == self.num_aus
        hdr = BitWriter()
        hdr.put(0, 16)  # firecode placeholder
        hdr.put(0, 1)
        hdr.put(self.dac_rate, 1)
        hdr.put(self.sbr, 1)
        hdr.put(self.ch_mode, 1)
        hdr.put(self.ps, 1)
        hdr.put(0, 3)   # mpeg_surround_config
        for _ in range(self.num_aus - 1):
            hdr.put(0, 12)  # au_start placeholders
        if self.dac_rate == 0 or self.sbr == 0:
            hdr.put(0, 4)
        buf = bytearray(hdr.bytes())
        assert len(buf) == self.header_bytes

        au_start = []
        for i, bw in enumerate(au_writers):
            au_start.append(len(buf))
            nbits = len(bw.buf) * 8 + bw.nbits
            if i == self.num_aus - 1:
                offset_end = self.total * 8 - 2 * 8 - 3
                fill = offset_end - (len(buf) * 8 + nbits)
                assert fill >= 0, f"superframe overflow by {-fill} bits"
                _fill_raw_data_block(bw, fill)
            bw.put(7, 3)  # ID_END
            if bw.nbits:
                bw.put(0, 8 - bw.nbits)
            au = bw.bytes()
            crc = crc16_ccitt(au) ^ 0xFFFF
            buf += au
            buf += bytes([crc >> 8, crc & 0xFF])
        assert len(buf) == self.total, f"{len(buf)} != {self.total}"

        # au_start back-patch (12-bit fields at bit 24)
        bitpos = 24
        for i in range(1, self.num_aus):
            v = au_start[i]
            byte, off = bitpos >> 3, bitpos & 7
            # write 12 bits MSB-first at bit offset
            cur = (buf[byte] << 16) | (buf[byte + 1] << 8) | buf[byte + 2]
            shift = 24 - off - 12
            mask = 0xFFF << shift
            cur = (cur & ~mask) | (v << shift)
            buf[byte], buf[byte + 1], buf[byte + 2] = (cur >> 16) & 0xFF, (cur >> 8) & 0xFF, cur & 0xFF
            bitpos += 12

        fc = firecode_crc(buf[2:11])
        buf[0], buf[1] = fc >> 8, fc & 0xFF
        frame = bytes(buf)
        if add_rs:
            frame = bytes(superframe_add_rs(np.frombuffer(frame, np.uint8)))
        return frame
