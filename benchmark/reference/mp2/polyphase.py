"""Batched 32-band polyphase analysis filterbank (port of
odr_audioenc_tpu/mp2/polyphase.py; libtoolame-dab/subband.c:201-310).

All 36 sliding windows of the time-reversed input are materialised and
reduced as in the reference: the f64 path keeps the C accumulation order bit
for bit; the f32 path collapses window + fold + DCT into one dense
[1632, 36*32] matmul (TF32 is pinned off in device.py).
"""
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from ..device import const

# window m of block t reads x[511 + 32 t - m] of concat(hist[480], frame[1152])
_IDX = (511 + 32 * np.arange(36)[:, None] - np.arange(512)[None, :]).astype(np.int64)


@lru_cache(maxsize=None)
def _dense_weights():
    """The filterbank is linear in its 1632 input samples: window, fold and
    DCT as ONE [1632, 36*32] f32 matrix (numpy, built once)."""
    acc = np.zeros((1632, 36, 64))
    C = np.asarray(T.ENWINDOW, np.float64)
    t_idx = np.arange(36)
    for i in range(512):
        acc[511 + 32 * t_idx - i, t_idx, i % 64] += C[i]
    K = np.zeros((64, 32))
    ya, yb, ys = (np.asarray(T.YPRIME_A), np.asarray(T.YPRIME_B),
                  np.asarray(T.YPRIME_S, np.float64))
    for k in range(32):
        K[ya[k], k] += 1.0
        K[yb[k], k] += ys[k]
    K = K @ np.asarray(T.DCT_FULL, np.float64).T        # [64, 32]
    return np.einsum("nti,is->nts", acc, K).reshape(1632, 36 * 32) \
        .astype(np.float32)


def polyphase_frame(hist, frame, exact_order=None):
    """hist: [..., 480] previous samples (already /32768); frame: [..., 1152].
    Returns (sb_sample [..., 36, 32], new_hist [..., 480]) in frame's dtype.

    exact_order (default: True for float64) replicates the C accumulation
    order; False is the dense matmul of the throughput path."""
    dtype, dev = frame.dtype, frame.device
    if exact_order is None:
        exact_order = dtype == torch.float64
    x = torch.cat([hist, frame], dim=-1)
    if not exact_order:
        W = const(_dense_weights(), dev, dtype)
        s = (x @ W).reshape(*x.shape[:-1], 36, 32)
        return s, x[..., 1152:]
    u = x[..., const(_IDX, dev)]                         # [..., 36, 512]
    z8 = (u * const(T.ENWINDOW, dev, dtype)).reshape(*u.shape[:-1], 8, 64)
    # t = d0*e0; t += d1*e1; ... (subband.c:249-257, sequential over j)
    y = z8[..., 0, :]
    for j in range(1, 8):
        y = y + z8[..., j, :]
    yp = y[..., const(T.YPRIME_A, dev)] + \
        y[..., const(T.YPRIME_B, dev)] * const(T.YPRIME_S, dev, dtype)
    # s0/s1 accumulate over even/odd k ascending (subband.c:293-305)
    m = const(T.DCT16x32, dev, dtype)                    # [16, 32]
    s0 = yp[..., 0, None] * m[:, 0]
    s1 = yp[..., 1, None] * m[:, 1]
    for k in range(2, 32, 2):
        s0 = s0 + yp[..., k, None] * m[:, k]
        s1 = s1 + yp[..., k + 1, None] * m[:, k + 1]
    s = torch.cat([s0 + s1, (s0 - s1).flip(-1)], dim=-1)  # s[i], s[31-i]
    return s, x[..., 1152:]
