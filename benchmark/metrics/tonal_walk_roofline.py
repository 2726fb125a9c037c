"""tonal_walk's share of its roofline (%): the least time its bytes take at
the card's memory rate over its mean device time per call, from the traced
slice.  It reads [B, 512] float32 power and uint8 candidates and writes
[B, 512] float32 power and two uint8 masks, B = 2 S rows (each station's
two channels); each byte counted once, 11 bytes per bin (the count of the
port's bench_psy1_kernels.py).  Bound by bytes: it does a few compares per
bin."""
from benchmark.peaks import HBM_BYTES_PER_S

KERNEL = "tonal_walk_kernel"
BYTES_PER_BIN = 4 + 1 + 4 + 1 + 1
BINS = 512


def bytes_per_call(rows):
    return BYTES_PER_BIN * BINS * rows


def read(run):
    t = run["trace"]
    if t is None:
        return None
    calls = sum(v["calls"] for n, v in t["device_by_name"].items() if KERNEL in n)
    secs = sum(v["s"] for n, v in t["device_by_name"].items() if KERNEL in n)
    if not calls or not secs:
        return None
    return 100.0 * bytes_per_call(2 * run["S"]) / HBM_BYTES_PER_S / (secs / calls)
