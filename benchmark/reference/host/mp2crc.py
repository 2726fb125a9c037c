"""MPEG CRC16 and DAB ScF-CRC8 (libtoolame-dab/crc.c)."""

CRC16_POLY = 0x8005
CRC8_POLY = 0x1D


def update_crc16(data, length, crc):
    masking = 1 << length
    while True:
        masking >>= 1
        if not masking:
            break
        carry = crc & 0x8000
        crc = (crc << 1) & 0xFFFF
        if (not carry) ^ (not (data & masking)):
            crc ^= CRC16_POLY
    return crc & 0xFFFF


def update_crc8(data, length, crc):
    masking = 1 << length
    while True:
        masking >>= 1
        if not masking:
            break
        carry = crc & 0x80
        crc = (crc << 1) & 0xFF
        if (not carry) ^ (not (data & masking)):
            crc ^= CRC8_POLY
    return crc & 0xFF


def header_crc(h, bit_alloc, scfsi, nbal_row, nch, sblimit, jsbound):
    """CRC_calc (crc.c:12-41). h: dict of header fields."""
    crc = 0xFFFF
    crc = update_crc16(h["bitrate_index"], 4, crc)
    crc = update_crc16(h["sampling_frequency"], 2, crc)
    crc = update_crc16(h["padding"], 1, crc)
    crc = update_crc16(h["extension"], 1, crc)
    crc = update_crc16(h["mode"], 2, crc)
    crc = update_crc16(h["mode_ext"], 2, crc)
    crc = update_crc16(h["copyright"], 1, crc)
    crc = update_crc16(h["original"], 1, crc)
    crc = update_crc16(h["emphasis"], 2, crc)
    for sb in range(sblimit):
        for ch in range(nch if sb < jsbound else 1):
            crc = update_crc16(int(bit_alloc[ch, sb]), int(nbal_row[sb]), crc)
    for sb in range(sblimit):
        for ch in range(nch):
            if bit_alloc[ch, sb]:
                crc = update_crc16(int(scfsi[ch, sb]), 2, crc)
    return crc


SCF_RANGES = [0, 4, 8, 16, 30]


def scf_crc(bit_alloc, scfsi, sf_index, nch, sblimit, packed):
    """CRC_calcDAB (crc.c:58-98): CRC8 over transmitted scalefactor MSBs in
    subband range `packed`."""
    first = SCF_RANGES[packed]
    last = min(SCF_RANGES[packed + 1], sblimit)
    crc = 0x0
    for sb in range(first, last):
        for ch in range(nch):
            if bit_alloc[ch, sb]:
                code = int(scfsi[ch, sb])
                if code == 0:
                    for gr in range(3):
                        crc = update_crc8(int(sf_index[ch, gr, sb]) >> 3, 3, crc)
                elif code in (1, 3):
                    crc = update_crc8(int(sf_index[ch, 0, sb]) >> 3, 3, crc)
                    crc = update_crc8(int(sf_index[ch, 2, sb]) >> 3, 3, crc)
                else:
                    crc = update_crc8(int(sf_index[ch, 0, sb]) >> 3, 3, crc)
    return crc
