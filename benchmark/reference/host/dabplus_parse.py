"""DAB+ superframe parser & structural validator (the encoder-side equivalent
of src/AACDecoder.cpp:35-128 plus firecode/AU-CRC/RS checks).

Used by the CLI --decode QA path and the test suite."""
import numpy as np

from ..fec.rs import superframe_check_rs
from .aacpack import crc16_ccitt, firecode_crc


def parse_superframe(data):
    """data: 110*subch bytes (no RS).  Returns dict with header flags and AU
    payloads; raises on structural violations (AU ordering - the reference's
    hard error, odr-audioenc.cpp:1165-1173)."""
    out = {
        "dac_rate": bool(data[2] & 0x40),
        "sbr": bool(data[2] & 0x20),
        "chmode": bool(data[2] & 0x10),
        "ps": bool(data[2] & 0x08),
    }
    out["firecode_ok"] = firecode_crc(data[2:11]) == (data[0] << 8 | data[1])
    num_aus = (3 if out["sbr"] else 6) if out["dac_rate"] else \
        (2 if out["sbr"] else 4)
    au_start = [0] * (num_aus + 1)
    au_start[0] = (6 if out["sbr"] else 11) if out["dac_rate"] else \
        (5 if out["sbr"] else 8)
    au_start[1] = data[3] << 4 | data[4] >> 4
    if num_aus >= 3:
        au_start[2] = (data[4] & 0x0F) << 8 | data[5]
    if num_aus >= 4:
        au_start[3] = data[6] << 4 | data[7] >> 4
    if num_aus == 6:
        au_start[4] = (data[7] & 0x0F) << 8 | data[8]
        au_start[5] = data[9] << 4 | data[10] >> 4
    au_start[num_aus] = len(data)
    for i in range(num_aus):
        if au_start[i] >= au_start[i + 1]:
            raise ValueError(f"AU ordering check failed: {au_start}")
    out["au_start"] = au_start
    out["aus"] = []
    out["au_crc_ok"] = []
    for i in range(num_aus):
        au = data[au_start[i]:au_start[i + 1] - 2]
        crc = data[au_start[i + 1] - 2] << 8 | data[au_start[i + 1] - 1]
        out["aus"].append(au)
        out["au_crc_ok"].append((crc16_ccitt(au) ^ 0xFFFF) == crc)
    return out


def validate_superframe(frame_with_rs):
    """Full structural validation of a subch*120-byte RS-coded superframe.
    Returns (ok, detail dict)."""
    arr = np.frombuffer(bytes(frame_with_rs), np.uint8)
    rs_ok = bool(superframe_check_rs(arr))
    subch = len(arr) // 120
    parsed = parse_superframe(bytes(arr[: 110 * subch]))
    ok = rs_ok and parsed["firecode_ok"] and all(parsed["au_crc_ok"])
    return ok, {"rs_ok": rs_ok, **parsed}
