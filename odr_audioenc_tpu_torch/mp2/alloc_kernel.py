"""The MP2 bit allocation as one hand-written CUDA kernel (csrc/mp2_alloc.cu).

It replaces no TPU kernel: the JAX package's allocator is plain jnp code with
a lax.while_loop tail.  On the card the vectorised allocator
(allocate.js_mode_select and allocate.a_bit_allocation) cost ~1,000 small
launches per frame and one host sync per pass of its tail; the kernel runs
the joint-stereo walk-down and the C greedy of every station in one launch,
one warp per station.  Its plain version is that vectorised code;
allocate.bit_allocation routes a CUDA tensor here and a CPU tensor there.

The kernel carries its own copy of the allocation tables (tables.LINE,
NBAL, STEP_INDEX, SNR, SFS_PER_SCFSI, JSB_TABLE and allocate._GBQ).

`launches` counts the kernel's launches.
"""
import ctypes

import torch

from ..kernels import build

SBLIMIT = 32

launches = 0     # mp2_alloc kernel launches since the last reset

_PTRS = ("smr", "scfsi", "tablenum", "sblimit", "nch", "adb", "is_joint", "stereo",
         "mode_ext", "jsbound", "bit_alloc", "adb_left")
# the per-station columns and the dtype each must have
COLUMNS = (("tablenum", torch.int64), ("sblimit", torch.int64), ("nch", torch.int64),
           ("is_joint", torch.bool), ("adb", torch.int64))


class _Args(ctypes.Structure):
    """csrc/mp2_alloc.cu's AllocArgs, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in ("S", "f64")]


_LAUNCHER = []


def _launcher():
    if not _LAUNCHER:
        fn = build.load("mp2_alloc").mp2_alloc_launch
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def check_inputs(smr, scfsi, **columns):
    """Raises on inputs the kernel does not take: smr other than float32 or
    float64 [S, 2, 32], scfsi other than int32 [S, 2, 32], a column of
    COLUMNS in another dtype or shape than [S] (TypeError on a dtype,
    ValueError on the rest), a tensor that is not contiguous, or tensors on
    more than one device or off a CUDA card.  Returns S."""
    ts = dict(smr=smr, scfsi=scfsi, **columns)
    if smr.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mp2_alloc takes float32 or float64 smr, got {smr.dtype}")
    if scfsi.dtype != torch.int32:
        raise TypeError(f"mp2_alloc: scfsi is {scfsi.dtype}, not int32")
    S = smr.shape[0] if smr.ndim == 3 else -1
    want = {"smr": (S, 2, SBLIMIT), "scfsi": (S, 2, SBLIMIT)}
    for k, dtype in COLUMNS:
        if columns[k].dtype != dtype:
            raise TypeError(f"mp2_alloc: {k} is {columns[k].dtype}, not {dtype}")
        want[k] = (S,)
    for k, t in ts.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"mp2_alloc: {k} is {tuple(t.shape)}, not {want[k]}")
        if not t.is_contiguous():
            raise ValueError(f"mp2_alloc: {k} is not contiguous")
    devs = {t.device for t in ts.values()}
    if len(devs) != 1:
        raise ValueError(f"mp2_alloc: tensors on {sorted(str(d) for d in devs)}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"mp2_alloc: the kernel takes CUDA tensors, got {dev}")
    return S


def bound_bytes(S):
    """Bytes the kernel must move for S stations in float32: smr and scfsi
    read once (64 each), the columns (four int64 and a bool), the allocation
    written as int64 (64) and the four outputs per station (three int64, a
    bool)."""
    return S * (2 * SBLIMIT * (4 + 4) + 4 * 8 + 1 + 2 * SBLIMIT * 8 + 3 * 8 + 1)


def allocate(smr, scfsi, tablenum, sblimit, nch, is_joint, adb):
    """js_mode_select then a_bit_allocation (allocate.py) on CUDA tensors in
    one launch.  smr [S, 2, 32] float32 or float64; scfsi [S, 2, 32] int32;
    tablenum, sblimit, nch, adb [S] int64; is_joint [S] bool.  Returns
    (mode_is_stereo [S] bool, mode_ext [S], jsbound [S], bit_alloc [S, 2, 32],
    adb_left [S]), the integers int64, or raises on what the kernel does
    not take."""
    global launches
    cols = dict(tablenum=tablenum, sblimit=sblimit, nch=nch, is_joint=is_joint, adb=adb)
    S = check_inputs(smr, scfsi, **cols)
    dev = smr.device
    out = dict(stereo=torch.empty((S,), dtype=torch.bool, device=dev),
               mode_ext=torch.empty((S,), dtype=torch.int64, device=dev),
               jsbound=torch.empty((S,), dtype=torch.int64, device=dev),
               bit_alloc=torch.empty((S, 2, SBLIMIT), dtype=torch.int64, device=dev),
               adb_left=torch.empty((S,), dtype=torch.int64, device=dev))
    if S:
        ptrs = dict(smr=smr, scfsi=scfsi, **cols, **out)
        args = _Args(**{k: ptrs[k].data_ptr() for k in _PTRS}, S=S,
                     f64=int(smr.dtype == torch.float64))
        with build.on_device(dev):
            rc = _launcher()(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mp2_alloc launch failed: cudaError {rc}")
        launches += 1
    return out["stereo"], out["mode_ext"], out["jsbound"], out["bit_alloc"], out["adb_left"]
