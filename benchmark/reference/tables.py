"""Constant tables for the DAB MP2 encoder.

Loaded from data/mp2_tables.npz (extracted from the ISO/ETSI tables embedded in
the reference implementation by tools/gen_tables.py) plus a few matrices derived
at import time with the reference's exact constant choices (truncated PI, 1e-9
coefficient rounding) so that the float64 validation path is bit-exact.

Reference provenance (for parity checking):
  enwindow ............ libtoolame-dab/enwindow.h (ISO 11172-3 Table C.1)
  DCT matrix .......... libtoolame-dab/subband.c:125-137 (create_dct_matrix)
  scalefactor/snr/a/b . libtoolame-dab/encode_new.c:65-100,448-462
  alloc line tables ... libtoolame-dab/encode_new.c:16-62
  psy-1 tables ........ libtoolame-dab/critband.h, freqtable.h
"""
from pathlib import Path

import numpy as np

# The reference uses this truncated value of pi everywhere (common.h:26).
PI_REF = 3.14159265358979
SCALE = 32768.0
SBLIMIT = 32
SCALE_BLOCK = 12
FFT_SIZE = 1024
HAN_SIZE = 512
POWERNORM = 90.3090
DBMIN = -200.0
CF = 1073741824.0  # pow(10, 0.1*POWERNORM) as the reference hardcodes it
DBM = 1e-20

_npz = np.load(Path(__file__).parent / "data" / "mp2_tables.npz")

ENWINDOW = _npz["enwindow"]            # [512]
STEP_INDEX = _npz["step_index"]        # [9, 16]
NBAL = _npz["nbal"]                    # [9]
STEPS = _npz["steps"]                  # [18]
STEPS2N = _npz["steps2n"]              # [18]
BITS = _npz["bits"]                    # [18]
GROUP = _npz["group"]                  # [18]
TABLE_SBLIMIT = _npz["table_sblimit"]  # [5]
LINE = _npz["line"]                    # [5, 32] (-1 above sblimit)
SCALEFACTOR = _npz["scalefactor"]      # [64]
SNR = _npz["snr"]                      # [18]
QUANT_A = _npz["quant_a"]              # [18]
QUANT_B = _npz["quant_b"]              # [18]

# psy model 1 per-samplerate-index tables (index: 0=44.1k 1=48k 2=32k,
# 4=22.05k 5=24k 6=16k; 3 unused)
CRIT_BAND_COUNT = _npz["crit_band_count"]  # [7]
CBOUND = _npz["cbound"]                    # [7, 27]
FREQ_ENTRIES = _npz["freq_entries"]        # [7]
FREQ_LINE = _npz["freq_line"]              # [7, 132]
FREQ_BARK = _npz["freq_bark"]              # [7, 132]
FREQ_HEAR = _npz["freq_hear"]              # [7, 132]

# 1: MPEG-1, 0: MPEG-2 LSF (common.c:26-32)
S_FREQ_KHZ = np.array([[22.05, 24.0, 16.0, 0.0], [44.1, 48.0, 32.0, 0.0]])
BITRATE_TABLE = np.array([
    [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
    [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384],
], np.int32)
JSB_TABLE = np.array([4, 8, 12, 16], np.int32)
SFS_PER_SCFSI = np.array([3, 2, 1, 2], np.int32)

# scfsi transmission pattern (encode_new.c:296-301), indexed [class0][class1]
SCFSI_PATTERN = np.array([
    [0x123, 0x122, 0x122, 0x133, 0x123],
    [0x113, 0x111, 0x111, 0x444, 0x113],
    [0x111, 0x111, 0x111, 0x333, 0x113],
    [0x222, 0x222, 0x222, 0x333, 0x123],
    [0x123, 0x122, 0x122, 0x133, 0x123],
])


def dct_matrix():
    """16x32 DCT matrix with coefficients decimal-rounded to 1e-9, exactly as
    create_dct_matrix does (subband.c:125-137)."""
    i = np.arange(16)[:, None].astype(np.float64)
    k = np.arange(32)[None, :].astype(np.float64)
    m = 1e9 * np.cos((2 * i + 1) * k * (PI_REF / 64.0))
    m = np.where(m >= 0, np.floor(m + 0.5), np.ceil(m - 0.5))
    return m * 1e-9


DCT16x32 = dct_matrix()

# Full 32x32 synthesis of the even/odd split in WindowFilterSubband's final
# loop: s[i] = sum_k m[i,k] yprime[k]; s[31-i] = sum_even - sum_odd.
# We build D[32, 32] such that s = yprime @ D.T .
_D = np.zeros((32, 32))
for _i in range(16):
    _D[_i, :] = DCT16x32[_i, :]
    sign = np.where(np.arange(32) % 2 == 0, 1.0, -1.0)
    _D[31 - _i, :] = DCT16x32[_i, :] * sign
DCT_FULL = _D

# Map y[64] -> yprime[32]: yprime[0]=y[16]; yprime[i]=y[i+16]+y[16-i] (1<=i<=16);
# yprime[i]=y[i+16]-y[80-i] (17<=i<=31).  (subband.c:260-291)
YPRIME_A = np.zeros((32,), dtype=np.int32)  # index of positive term
YPRIME_B = np.zeros((32,), dtype=np.int32)  # index of +/- second term
YPRIME_S = np.zeros((32,))                  # sign of second term (0 for none)
for _i in range(32):
    YPRIME_A[_i] = _i + 16
    if 1 <= _i <= 16:
        YPRIME_B[_i] = 16 - _i
        YPRIME_S[_i] = 1.0
    elif _i >= 17:
        YPRIME_B[_i] = 80 - _i
        YPRIME_S[_i] = -1.0

# add_db lookup table (psycho_1.c:170-178)
_x = np.arange(1000) / 10.0
ADD_DB_TABLE = 10.0 * np.log10(1.0 + np.power(10.0, _x / 10.0)) - _x

# psy-1 Hann window (psycho_1.c:225-235), exact reference constants
_i = np.arange(FFT_SIZE).astype(np.float64)
PSY1_WINDOW = np.sqrt(8.0 / 3.0) * 0.5 * (1 - np.cos(2.0 * PI_REF * _i / FFT_SIZE)) / FFT_SIZE

# tonal-label `run` per bin (psycho_1.c:288-298)
_runs = np.zeros(HAN_SIZE, dtype=np.int32)
for _b in range(HAN_SIZE):
    if _b < 3 or _b > 500:
        _runs[_b] = 0
    elif _b < 63:
        _runs[_b] = 2
    elif _b < 127:
        _runs[_b] = 3
    elif _b < 255:
        _runs[_b] = 6
    else:
        _runs[_b] = 12
TONAL_RUN = _runs


def make_map(rate_idx):
    """power[].map per bin for a samplerate table index (psycho_1.c:160-168)."""
    sub_size = int(FREQ_ENTRIES[rate_idx]) + 1
    line = np.concatenate([[0], FREQ_LINE[rate_idx][: sub_size - 1]])
    m = np.zeros(HAN_SIZE, dtype=np.int32)
    for i in range(1, sub_size):
        m[line[i - 1] : line[i] + 1] = i
    return m
