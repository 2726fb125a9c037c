"""Null psychoacoustic model (port of odr_audioenc_tpu/mp2/psycho_n1.py;
psycho_n1.c): canned per-subband SNR values, no modelling.

Unreachable from the reference's public API (toolame_set_psy_model clamps
the model to 0..3, toolame.c:202-210); kept for inventory completeness and
as a zero-cost smoke model for throughput runs.
"""
import numpy as np
import torch

from ..device import const

# "From Castanets.wav" (psycho_n1.c:14-17)
SNRDEF = np.array([
    30, 17, 16, 10, 3, 12, 8, 2.5, 5, 5, 6, 6, 5, 6, 10, 6, -4,
    -10, -21, -30, -42, -55, -68, -75, -75, -75, -75, -75, -91, -107,
    -110, -108], np.float64)


def psycho_n1(n_streams, dtype=torch.float64, device="cpu"):
    """smr [S, 2, 32]: the canned table broadcast (psycho_n1 writes
    ltmin = snrdef per channel; the null model's smr is ltmin itself)."""
    return const(SNRDEF, device, dtype).expand(n_streams, 2, 32).contiguous()
