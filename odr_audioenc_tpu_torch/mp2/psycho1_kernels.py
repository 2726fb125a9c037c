"""Hand-written CUDA kernels of the psy-1 fast path (the counterpart of
odr_audioenc_tpu/mp2/psycho1_pallas.py).

tonal_walk: csrc/tonal_walk.cu, which replaces the TPU kernel
`_tonal_kernel` (psycho1_pallas.py:140, called through tonal_relax_pallas /
tonal_pallas).  Its plain version is psycho1_fast.tonal_fast.

tonal_noise: csrc/tonal_noise.cu, which replaces `_tonal_noise_kernel`
(psycho1_pallas.py:151, called through tonal_noise_pallas): the tonal walk
and the noise labelling in one kernel.  Its plain version is
psycho1_fast.tonal_noise_fast.

Each wrapper counts its launches (`launches`, `noise_launches`); a CPU tensor
takes the plain version and counts nothing.
"""
import ctypes

import torch

from odr_audioenc_tpu import tables as T

from ..device import const
from ..kernels import build

NBINS = 512
NBANDS = 32    # the band geometry's padded width (26 critical bands at most)

launches = 0         # tonal_walk kernel launches since the last reset
noise_launches = 0   # tonal_noise kernel launches since the last reset

_ARGTYPES = {
    "tonal_walk": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p],
    "tonal_noise": [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_UNIFORM_OK = set()   # (pointers, versions) of band geometries checked once


def _launcher(name):
    lib = build.load(name)
    fn = getattr(lib, name + "_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(name, power, cand, *more):
    """Raises on what the kernels do not take: [B, 512] contiguous f32
    spectra (and more of them) and a bool candidate mask on one CUDA device."""
    if power.device.type != "cuda" or any(t.device != power.device for t in (cand, *more)):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in (power, cand, *more)]}")
    if power.dtype != torch.float32 or cand.dtype != torch.bool or \
            any(t.dtype != torch.float32 for t in more):
        raise TypeError(f"{name} takes f32 spectra and a bool cand, got "
                        f"{[t.dtype for t in (power, cand, *more)]}")
    if power.ndim != 2 or power.shape[1] != NBINS or \
            any(t.shape != power.shape for t in (cand, *more)):
        raise ValueError(f"{name} takes [B, {NBINS}], got "
                         f"{[tuple(t.shape) for t in (power, cand, *more)]}")
    if not all(t.is_contiguous() for t in (power, cand, *more)):
        raise ValueError(f"{name} takes contiguous tensors")


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
    _check_rows("tonal_walk", power, cand)
    B = power.shape[0]
    runs = const(T.TONAL_RUN, power.device, torch.int32)
    pw = torch.empty_like(power)
    member = torch.empty_like(cand)
    typ = torch.empty_like(cand)
    with torch.cuda.device(power.device):
        rc = _launcher("tonal_walk")(
            power.data_ptr(), cand.data_ptr(), runs.data_ptr(), pw.data_ptr(),
            member.data_ptr(), typ.data_ptr(), B,
            torch.cuda.current_stream(power.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tonal_walk launch failed: cudaError {rc}")
    launches += 1
    return pw, member, typ


def _check_uniform(bmt, base, span):
    """The kernel sums each band over [base, base + span) itself; bmt must
    be exactly the one-hot of that geometry (as make_fast_tables builds it).
    Checked once per geometry tensor (keyed by storage and version)."""
    key = tuple((t.data_ptr(), t._version) for t in (bmt, base, span))
    if key in _UNIFORM_OK:
        return
    if bmt.shape != (NBINS, NBANDS) or base.shape != (NBANDS,) or span.shape != (NBANDS,):
        raise ValueError(f"tonal_noise: geometry shapes {tuple(bmt.shape)}, "
                         f"{tuple(base.shape)}, {tuple(span.shape)}")
    bins = torch.arange(NBINS, device=bmt.device)[:, None]
    want = (bins >= base[None, :]) & (bins < (base + span)[None, :])
    if not torch.equal(bmt != 0, want) or not bool(((bmt == 0) | (bmt == 1)).all()):
        raise ValueError("tonal_noise: bmt is not the one-hot of (base, span)")
    _UNIFORM_OK.add(key)


def tonal_noise(power, cand, energy, bmt, base, span):
    """The tonal walk fused with the noise labelling (homogeneous sample
    rate).  power/energy [B, 512] f32, cand [B, 512] bool; bmt [512, 32],
    base/span [32] the uniform band geometry (make_fast_tables'
    static_noise_uniform).  Returns (power' [B,512], tone member [B,512]
    bool, noise member [B,512] bool).  A CPU tensor goes through the plain
    version (psycho1_fast.tonal_noise_fast); a CUDA tensor launches the
    kernel, or raises on what the kernel does not take."""
    global noise_launches
    if power.device.type == "cpu":
        from .psycho1_fast import tonal_noise_fast
        return tonal_noise_fast(power, cand, energy, bmt, base, span)
    _check_rows("tonal_noise", power, cand, energy)
    if any(t.device != power.device for t in (bmt, base, span)):
        raise ValueError("tonal_noise: the band geometry is on another device")
    _check_uniform(bmt, base, span)
    B = power.shape[0]
    runs = const(T.TONAL_RUN, power.device, torch.int32)
    base32, span32 = base.to(torch.int32).contiguous(), span.to(torch.int32).contiguous()
    pw = torch.empty_like(power)
    tone_m = torch.empty_like(cand)
    noise_m = torch.empty_like(cand)
    with torch.cuda.device(power.device):
        rc = _launcher("tonal_noise")(
            power.data_ptr(), cand.data_ptr(), energy.data_ptr(), runs.data_ptr(),
            base32.data_ptr(), span32.data_ptr(), pw.data_ptr(), tone_m.data_ptr(),
            noise_m.data_ptr(), float(T.CF), B,
            torch.cuda.current_stream(power.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tonal_noise launch failed: cudaError {rc}")
    noise_launches += 1
    return pw, tone_m, noise_m
