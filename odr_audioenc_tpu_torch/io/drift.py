"""Drift-compensation helpers (odr-audioenc.cpp:342-396)."""
import numpy as np


def expand_missing_samples(buf, channels, valid_bytes):
    """Distribute missing samples over the whole buffer by duplicating source
    samples at regular spots (bug-compatible with expand_missing_samples,
    odr-audioenc.cpp:342-373).  buf: bytearray; modified in place."""
    bytes_per_sample = 2 * channels
    assert len(buf) % bytes_per_sample == 0
    assert len(buf) > valid_bytes
    valid_samples = valid_bytes // bytes_per_sample
    missing_samples = len(buf) // bytes_per_sample - valid_samples

    if missing_samples * bytes_per_sample > len(buf) // 10 or valid_samples == 0:
        for i in range(valid_samples * bytes_per_sample, len(buf)):
            buf[i] = 0
        return

    source = bytes(buf)
    step = valid_samples // missing_samples
    src_ix = 0
    for i in range(len(buf) // bytes_per_sample):
        buf[bytes_per_sample * i:bytes_per_sample * (i + 1)] = \
            source[src_ix:src_ix + bytes_per_sample]
        if not (i > 0 and step > 0 and i % step == 0):
            src_ix += bytes_per_sample
