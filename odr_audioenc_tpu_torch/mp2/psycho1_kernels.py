"""Hand-written CUDA kernels of the psy-1 fast path (the counterpart of
odr_audioenc_tpu/mp2/psycho1_pallas.py).

tonal_walk: csrc/tonal_walk.cu, which replaces the TPU kernel
`_tonal_kernel` (psycho1_pallas.py:140, called through tonal_relax_pallas /
tonal_pallas).  Its plain version is psycho1_fast.tonal_fast.

tonal_noise: csrc/tonal_noise.cu, which replaces `_tonal_noise_kernel`
(psycho1_pallas.py:151, called through tonal_noise_pallas): the tonal walk
and the noise labelling in one kernel.  Its plain version is
psycho1_fast.tonal_noise_fast.

Both kernels take the walk's static table `walk_table()`: TONAL_RUN and the
reach mask of every bin, with which the kernel tests an accepted bin's
zeroing by bit operations on the accept words (`zeroing_from_words` is that
arithmetic in numpy, held against the plain version's min_zeroer by the
tests).  The fused kernel also takes `noise_tables()` of its band geometry,
the static layout of its band sums (`band_sums_lanes` is that arithmetic
in numpy).

Each wrapper counts its launches (`launches`, `noise_launches`); a CPU tensor
takes the plain version and counts nothing.  The bound launcher, the table
on each device and the int32 band geometry are cached, so a call on the
current device does three allocations and one ctypes call.
"""
import ctypes

import numpy as np
import torch

from .. import tables as T
from ..device import const
from ..kernels import build

NBINS = 512
NBANDS = 32    # the band geometry's padded width (26 critical bands at most)
PAD = 12       # the longest tonal run

launches = 0         # tonal_walk kernel launches since the last reset
noise_launches = 0   # tonal_noise kernel launches since the last reset

_ARGTYPES = {
    "tonal_walk": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p],
    "tonal_noise": [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_LAUNCHERS = {}
_GEOMETRY = {}   # (pointers, versions) of a checked band geometry -> its kernel tables


def reach_masks(runs):
    """[512] int64: bit d of reach[b] is set iff a = b + d - 12 is a bin,
    a != b and runs[a] >= |a - b| (accepted, a would zero b)."""
    b = np.arange(NBINS)[:, None]
    d = np.arange(2 * PAD + 1)[None, :]
    a = b + d - PAD
    ok = (a >= 0) & (a < NBINS) & (a != b) & (runs[np.clip(a, 0, NBINS - 1)] >= np.abs(a - b))
    return (ok.astype(np.int64) << d).sum(axis=1)


RUNS = (0, 2, 3, 6, 12)   # the run lengths the kernels take (TONAL_RUN's)


def walk_table(runs=T.TONAL_RUN):
    """[2, 512] int32: the run lengths, then the reach masks (< 2^25)."""
    if not np.isin(runs, RUNS).all():
        raise ValueError(f"the kernels take run lengths {RUNS}")
    return np.stack([np.asarray(runs, np.int64), reach_masks(runs)]).astype(np.int32)


_WALK_TABLE = walk_table()


def noise_tables(base, span):
    """[2, 512] int32 of the fused kernel's band sums, for the band geometry
    base/span [32] (disjoint bands).  Row 0: the band of each bin (-1:
    none).  Row 1, for lane l (which owns bins 16 l .. 16 l + 15): entry l
    holds the lane's cross-lane scan flags in bits 0-4 (bit s: band[16 (l -
    2^s) + 15] == band[16 l + 15] >= 0, so lanes l - 2^s .. l end in one
    band), in bit 5 whether the lane's first band came in from lane l - 1,
    and in bits 8-23 which of its bins continue the band of the bin before
    (within the lane); entry 32 + l which of its bins end a band, entry
    64 + l which of its bins lie in a band."""
    base, span = np.asarray(base, np.int64), np.asarray(span, np.int64)
    bins = np.arange(NBINS)
    inside = (bins[:, None] >= base[None, :]) & (bins[:, None] < (base + span)[None, :])
    band = np.where(inside.any(1), inside.argmax(1), -1)
    bl = band.reshape(32, 16)
    last = bl[:, 15]                                      # trailing band of each lane
    lanes = np.arange(32)
    flags = np.zeros(32, np.int64)
    for s in range(5):
        d = 1 << s
        ok = (lanes >= d) & (last >= 0) & (last[np.clip(lanes - d, 0, None)] == last)
        flags |= ok.astype(np.int64) << s
    carried = (lanes > 0) & (bl[:, 0] >= 0) & (np.concatenate([[-2], last[:-1]]) == bl[:, 0])
    nxt = np.concatenate([band[1:], [-2]]).reshape(32, 16)
    cont = np.concatenate([np.zeros((32, 1), bool), bl[:, 1:] == bl[:, :-1]], 1)
    end = (bl >= 0) & (bl != nxt)
    weights = 1 << np.arange(16)
    row1 = np.zeros(NBINS, np.int64)
    row1[:32] = flags | carried.astype(np.int64) << 5 | (cont @ weights) << 8
    row1[32:64] = end @ weights
    row1[64:96] = (bl >= 0) @ weights
    return np.stack([band, row1]).astype(np.int32)


def band_sums_lanes(x, tables):
    """The fused kernel's band sums in numpy, in its order and from its
    tables: lane l sums its 16 bins band by band (the continue bits); a
    band ending in the lane is written there, unless it came in from the
    left (the carried bit) - then it gets the sum of the lanes before it, a
    segmented scan over the lanes' trailing sums (the scan flags).  x [B,
    512] -> [B, 32], in x's dtype."""
    band, row1 = np.asarray(tables)
    flags, carried = row1[:32] & 31, (row1[:32] >> 5) & 1 == 1
    cont, end = (row1[:32] >> 8) & 0xFFFF, row1[32:64] & 0xFFFF
    B = x.shape[0]
    xs = x.reshape(B, 32, 16)
    bl = band.reshape(32, 16)
    out = np.zeros((B, 32), x.dtype)
    s = np.zeros((B, 32), x.dtype)
    first_sum = np.zeros((B, 32), x.dtype)
    first_end = np.zeros(32, bool)
    for i in range(16):
        s = np.where((cont >> i) & 1 == 1, s + xs[:, :, i], xs[:, :, i])
        ends = (end >> i) & 1 == 1
        first = carried & (bl[:, i] == bl[:, 0])
        for lane in np.flatnonzero(ends & ~first):
            out[:, bl[lane, i]] = s[:, lane]
        first_sum = np.where(ends & first, s, first_sum)
        first_end |= ends & first
    v = s.copy()
    for k in range(5):
        d = 1 << k
        up = np.concatenate([v[:, :d], v[:, :-d]], 1)
        v = np.where((flags >> k) & 1 == 1, v + up, v)
    carry = np.concatenate([np.zeros((B, 1), x.dtype), v[:, :-1]], 1)
    for lane in np.flatnonzero(first_end):
        out[:, bl[lane, 0]] = first_sum[:, lane] + carry[:, lane]
    return out


def zeroing_from_words(accept, reach=None):
    """The kernels' zeroing arithmetic (psy1_tonal.cuh `walk16`), in numpy
    on the CPU: for accept [B, 512] bool, each row's 16 accept words; for bin
    b = 32 j + l the window of bins from b-13 cut from words j-1, j, j+1;
    then mz[b] = b - 12 + (lowest set bit of (window >> 1) & reach[b]), or
    513 where none is set, and whether b-1 and b+1 were zeroed by an
    accepted bin left of b (the window against reach[b-1], reach[b+1]).
    Returns (mz, left_zeroed, right_zeroed) as [B, 512] tensors."""
    reach = reach_masks(T.TONAL_RUN) if reach is None else np.asarray(reach)
    reach = reach.astype(np.uint64)
    acc = np.asarray(accept, bool)
    B = acc.shape[0]
    words = (acc.reshape(B, NBINS // 32, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1, dtype=np.uint64)     # [B, 16]
    zero = np.zeros((B, 1), np.uint64)
    prev_w = np.concatenate([zero, words[:, :-1]], 1)[:, :, None]
    next_w = np.concatenate([words[:, 1:], zero], 1)[:, :, None]
    s = np.arange(32, dtype=np.uint64) + np.uint64(19)
    lo = (words[:, :, None] << np.uint64(32)) | prev_w
    win = ((lo >> s) | (next_w << (np.uint64(64) - s))).reshape(B, NBINS)
    own = ((win >> np.uint64(1)) & reach).astype(np.int64)
    first = np.log2((own & -own).clip(1)).astype(np.int64)
    mz = np.where(own != 0, np.arange(NBINS) - PAD + first, NBINS + 1)
    reach_l = np.concatenate([[0], reach[:-1]]).astype(np.uint64)
    reach_r = np.concatenate([reach[1:], [0]]).astype(np.uint64)
    left = (win & reach_l & np.uint64(0x1FFF)) != 0
    right = ((win >> np.uint64(2)) & reach_r & np.uint64(0x7FF)) != 0
    return torch.as_tensor(mz), torch.as_tensor(left), torch.as_tensor(right)


def _launcher(name):
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = getattr(build.load(name), name + "_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
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
    if any(t.data_ptr() % 16 for t in (power, cand, *more)):
        raise ValueError(f"{name} takes 16-byte aligned rows (the kernel copies 16 B at a time)")


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
    tab = const(_WALK_TABLE, power.device)
    pw = torch.empty_like(power)
    member = torch.empty_like(cand)
    typ = torch.empty_like(cand)
    with build.on_device(power.device):
        rc = _launcher("tonal_walk")(
            power.data_ptr(), cand.data_ptr(), tab.data_ptr(), pw.data_ptr(),
            member.data_ptr(), typ.data_ptr(), power.shape[0],
            torch.cuda.current_stream(power.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tonal_walk launch failed: cudaError {rc}")
    launches += 1
    return pw, member, typ


def _geometry(bmt, base, span):
    """The kernel sums each band over [base, base + span) itself; bmt must
    be exactly the one-hot of that geometry (as make_fast_tables builds it)
    and the bands disjoint.  Checked once per geometry (keyed by storage and
    version); returns the kernel's table (the walk's two rows and
    noise_tables' two) and the int32 base and span, made once too."""
    key = tuple((t.data_ptr(), t._version) for t in (bmt, base, span))
    hit = _GEOMETRY.get(key)
    if hit is not None:
        return hit
    if bmt.shape != (NBINS, NBANDS) or base.shape != (NBANDS,) or span.shape != (NBANDS,):
        raise ValueError(f"tonal_noise: geometry shapes {tuple(bmt.shape)}, "
                         f"{tuple(base.shape)}, {tuple(span.shape)}")
    bins = torch.arange(NBINS, device=bmt.device)[:, None]
    want = (bins >= base[None, :]) & (bins < (base + span)[None, :])
    if not torch.equal(bmt != 0, want) or not bool(((bmt == 0) | (bmt == 1)).all()):
        raise ValueError("tonal_noise: bmt is not the one-hot of (base, span)")
    if bool((want.sum(1) > 1).any()):
        raise ValueError("tonal_noise: the bands overlap")
    tab = np.concatenate([_WALK_TABLE, noise_tables(base.cpu().numpy(), span.cpu().numpy())])
    hit = _GEOMETRY[key] = (torch.as_tensor(tab, device=bmt.device),
                            base.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
                            (bmt, base, span))   # the last keeps the keyed storages alive
    return hit


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
    tab, base32, span32, _ = _geometry(bmt, base, span)
    pw = torch.empty_like(power)
    tone_m = torch.empty_like(cand)
    noise_m = torch.empty_like(cand)
    with build.on_device(power.device):
        rc = _launcher("tonal_noise")(
            power.data_ptr(), cand.data_ptr(), energy.data_ptr(), tab.data_ptr(),
            base32.data_ptr(), span32.data_ptr(), pw.data_ptr(), tone_m.data_ptr(),
            noise_m.data_ptr(), float(T.CF), power.shape[0],
            torch.cuda.current_stream(power.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tonal_noise launch failed: cudaError {rc}")
    noise_launches += 1
    return pw, tone_m, noise_m
