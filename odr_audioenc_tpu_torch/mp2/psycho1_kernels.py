"""Hand-written CUDA kernel of the psy-1 fast path (the counterpart of
odr_audioenc_tpu/mp2/psycho1_pallas.py).

tonal_walk: csrc/tonal_walk.cu, which replaces the TPU kernel
`_tonal_kernel` (psycho1_pallas.py:140, called through tonal_relax_pallas /
tonal_pallas).  Its plain version is psycho1_fast.tonal_fast.  The fused
tonal+noise kernel (`_tonal_noise_kernel`) is not ported yet.
"""
import ctypes

import torch

from odr_audioenc_tpu import tables as T

from ..device import const
from ..kernels import build

NBINS = 512

launches = 0   # tonal_walk kernel launches since the last reset


def _lib():
    lib = build.load("tonal_walk")
    if lib.tonal_walk_launch.argtypes is None:
        lib.tonal_walk_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                                  ctypes.c_void_p]
        lib.tonal_walk_launch.restype = ctypes.c_int
    return lib


def tonal_walk(power, cand):
    """power [B, 512] f32, cand [B, 512] bool -> (power' [B,512], member
    [B,512] bool, typ [B,512] bool): the whole tonal walk, list surgery
    included.  A CPU tensor goes through the plain version
    (psycho1_fast.tonal_fast); a CUDA tensor launches the kernel, or
    raises on what the kernel does not take."""
    global launches
    if power.device.type == "cpu":
        from .psycho1_fast import tonal_fast
        return tonal_fast(power, cand)
    if power.device.type != "cuda" or cand.device != power.device:
        raise ValueError(f"tonal_walk: power on {power.device}, cand on {cand.device}")
    if power.dtype != torch.float32 or cand.dtype != torch.bool:
        raise TypeError(f"tonal_walk takes f32 power and bool cand, got "
                        f"{power.dtype}, {cand.dtype}")
    if power.ndim != 2 or power.shape[1] != NBINS or cand.shape != power.shape:
        raise ValueError(f"tonal_walk takes [B, {NBINS}], got {tuple(power.shape)}, "
                         f"{tuple(cand.shape)}")
    if not (power.is_contiguous() and cand.is_contiguous()):
        raise ValueError("tonal_walk takes contiguous tensors")
    B = power.shape[0]
    runs = const(T.TONAL_RUN, power.device, torch.int32)
    pw = torch.empty_like(power)
    member = torch.empty_like(cand)
    typ = torch.empty_like(cand)
    with torch.cuda.device(power.device):
        rc = _lib().tonal_walk_launch(
            power.data_ptr(), cand.data_ptr(), runs.data_ptr(), pw.data_ptr(),
            member.data_ptr(), typ.data_ptr(), B,
            torch.cuda.current_stream(power.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tonal_walk launch failed: cudaError {rc}")
    launches += 1
    return pw, member, typ
