"""MP2/DAB frame parser & structural validator.

Decoder-side reimplementation of the Layer II frame syntax (for tests and the
--validate path): parses header/bit_alloc/scfsi/scalefactors and checks the
header CRC.  Used to localise divergence when comparing against reference
streams.
"""
import numpy as np

from .. import tables as T
from . import mp2crc


class BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def get(self, n):
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def pick_tablenum(version, sfreq_idx, bitrate_idx, nch):
    br_per_ch = int(T.BITRATE_TABLE[version][bitrate_idx]) // nch
    sfrq = T.S_FREQ_KHZ[version][sfreq_idx]
    if version == 1:
        if (sfrq == 48 and br_per_ch >= 56) or (56 <= br_per_ch <= 80):
            return 0
        if sfrq != 48 and br_per_ch >= 96:
            return 1
        if sfrq != 32 and br_per_ch <= 48:
            return 2
        return 3
    return 4


def parse_frame(buf):
    br = BitReader(buf)
    out = {}
    assert br.get(12) == 0xFFF, "bad syncword"
    version = br.get(1)
    lay = 4 - br.get(2)
    assert lay == 2
    noprot = br.get(1)
    h = dict(bitrate_index=br.get(4), sampling_frequency=br.get(2),
             padding=br.get(1), extension=br.get(1), mode=br.get(2),
             mode_ext=br.get(2), copyright=br.get(1), original=br.get(1),
             emphasis=br.get(2))
    out["version"], out["header"] = version, h
    crc = br.get(16) if not noprot else None
    nch = 1 if h["mode"] == 3 else 2
    tablenum = pick_tablenum(version, h["sampling_frequency"], h["bitrate_index"], nch)
    sblimit = int(T.TABLE_SBLIMIT[tablenum])
    jsbound = int(T.JSB_TABLE[h["mode_ext"]]) if h["mode"] == 1 else sblimit
    line_row = T.LINE[tablenum]
    nbal_row = np.where(line_row >= 0, T.NBAL[np.maximum(line_row, 0)], 0)

    bit_alloc = np.zeros((2, 32), np.int32)
    for sb in range(sblimit):
        for ch in range(nch if sb < jsbound else 1):
            bit_alloc[ch, sb] = br.get(int(nbal_row[sb]))
        if sb >= jsbound:
            bit_alloc[1, sb] = bit_alloc[0, sb]
    scfsi = np.zeros((2, 32), np.int32)
    for sb in range(sblimit):
        for ch in range(nch):
            if bit_alloc[ch, sb]:
                scfsi[ch, sb] = br.get(2)
    sf = np.zeros((2, 3, 32), np.int32)
    for sb in range(sblimit):
        for ch in range(nch):
            if bit_alloc[ch, sb]:
                code = scfsi[ch, sb]
                if code == 0:
                    for gr in range(3):
                        sf[ch, gr, sb] = br.get(6)
                elif code in (1, 3):
                    sf[ch, 0, sb] = br.get(6)
                    sf[ch, 2, sb] = br.get(6)
                else:
                    sf[ch, 0, sb] = br.get(6)
    samples = np.zeros((2, 3, 12, 32), np.int64)
    for gr in range(3):
        for j in (0, 3, 6, 9):
            for sb in range(sblimit):
                for ch in range(nch if sb < jsbound else 1):
                    ba = int(bit_alloc[ch, sb])
                    if ba:
                        sidx = int(T.STEP_INDEX[line_row[sb]][ba])
                        nbits = int(T.BITS[sidx])
                        if T.GROUP[sidx] == 3:
                            for x in range(3):
                                samples[ch, gr, j + x, sb] = br.get(nbits)
                        else:
                            v = br.get(nbits)
                            y = int(T.STEPS[sidx])
                            samples[ch, gr, j, sb] = v % y
                            samples[ch, gr, j + 1, sb] = (v // y) % y
                            samples[ch, gr, j + 2, sb] = v // (y * y)

    out.update(bit_alloc=bit_alloc, scfsi=scfsi, sf=sf, samples=samples,
               crc=crc, nch=nch, sblimit=sblimit, jsbound=jsbound,
               tablenum=tablenum, audio_end_bits=br.pos)
    if crc is not None:
        calc = mp2crc.header_crc(h, bit_alloc, scfsi, nbal_row, nch, sblimit, jsbound)
        out["crc_ok"] = calc == crc
    return out


def frame_length_bytes(version, bitrate_idx, sfreq_idx, padding=0):
    br = int(T.BITRATE_TABLE[version][bitrate_idx])
    sf = T.S_FREQ_KHZ[version][sfreq_idx]
    return int((1152.0 / sf) * (br / 8.0)) + padding


def split_frames(stream):
    """Split a concatenated mp2 byte stream into frames via header parsing."""
    frames = []
    pos = 0
    while pos + 4 <= len(stream):
        assert stream[pos] == 0xFF and (stream[pos + 1] >> 4) == 0xF, "lost sync"
        version = (stream[pos + 1] >> 3) & 1
        bitrate_idx = stream[pos + 2] >> 4
        sfreq_idx = (stream[pos + 2] >> 2) & 3
        padding = (stream[pos + 2] >> 1) & 1
        ln = frame_length_bytes(version, bitrate_idx, sfreq_idx, padding)
        frames.append(bytes(stream[pos:pos + ln]))
        pos += ln
    return frames
