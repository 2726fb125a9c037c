"""The DAB+ rate loop as one hand-written CUDA kernel (csrc/rate_loop.cu).

It replaces no TPU kernel: the JAX package's rate loop is plain jnp code
that XLA fuses.  On the card the eager loop (encode.rate_loop_plain) cost
some 7,000 small launches per AU; the kernel runs the whole loop of one AU,
the integer and fractional bisect, the final DP count and the afterburner
rounds, in one launch, one block per station.  Its plain version is
encode.rate_loop_plain; encode.rate_loop routes a CUDA tensor here and a CPU
tensor there.

The kernel takes two tables: encode._RATE_TABLE (the Huffman lengths and
the books' magnitude limits, TABLE_LAYOUT) and the encoder's two band ladders
in the form `ladder_table` makes of them (each line's band, the quads in
band order, each band's first quad), made once per pair of ladders.

`launches` counts the kernel's launches.
"""
import ctypes

import numpy as np
import torch

from ..device import const
from ..kernels import build
from . import tables as AT

N = AT.N                    # lines per channel
NB = AT.MAX_SFB_LONG        # padded bands
NQ = N // 4                 # quads per channel
LADDER = 1280               # uint8 per ladder: band of each line [960], quads [240], first quad [50]
# encode._RATE_TABLE: (name, entries); the kernel's T_* offsets follow this order
TABLE_LAYOUT = (("quad", 81 * 4), ("pair56", 81 * 2), ("pair17", 289 * 5), ("scf", 121),
                ("book_lim", 12))
TABLE_LEN = sum(n for _, n in TABLE_LAYOUT)

launches = 0     # rate_loop kernel launches since the last reset

_PTRS = ("mag075", "absx", "neg", "pns_line", "thr4", "cap_thr", "floor29", "hole_rank",
         "hole_thr", "wgt", "log_ffak", "scf_corr", "thr", "no_ah", "pns_mask", "pns_nrg",
         "bsel", "force_break", "is_short", "sect_hdr", "tns_bits", "elem_fixed",
         "budget_bits", "ladders", "table", "q", "gains", "books", "bits")
_INTS = ("S", "C", "refine_rounds", "sect_bits", "o_lo", "o_hi", "bisect_steps",
         "frac_steps", "hole_o", "spill_o", "refine_bands", "table_len", "f64")
_DOUBLES = ("hole_rate", "p4", "p43")


class _Args(ctypes.Structure):
    """csrc/rate_loop.cu's RateArgs, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_double) for k in _DOUBLES])


_LAUNCHER = []
_LADDERS = {}    # (pointer, version) of each ladder -> (kernel table, the keyed tensors)


def _launcher():
    if not _LAUNCHER:
        fn = build.load("rate_loop").rate_loop_launch
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def ladder_table(long_bol, short_bol=None):
    """[2, LADDER] uint8 of the long and short ladders (line -> band, [960]
    each; the long one stands for both where there are no short blocks):
    per ladder the band of each line, the quads (4 lines, which never
    straddle a band) sorted by band in line order, and the first quad of
    each band, NB + 1 entries."""
    out = np.zeros((2, LADDER), np.uint8)
    for r, bol in enumerate((long_bol, long_bol if short_bol is None else short_bol)):
        bol = np.asarray(bol, np.int64)
        if bol.shape != (N,) or bol.min() < 0 or bol.max() >= NB:
            raise ValueError(f"a ladder maps {N} lines to bands 0..{NB - 1}, got shape "
                             f"{bol.shape}, bands {bol.min()}..{bol.max()}")
        quad = bol.reshape(NQ, 4)
        if (quad != quad[:, :1]).any():
            raise ValueError("a quad of lines straddles two bands")
        order = np.argsort(quad[:, 0], kind="stable")
        out[r, :N] = bol
        out[r, N:N + NQ] = order
        out[r, N + NQ:N + NQ + NB + 1] = np.searchsorted(quad[order, 0], np.arange(NB + 1))
    return out


def _ladders(ladders, device):
    long_bol, short_bol = ladders
    keyed = (long_bol, long_bol if short_bol is None else short_bol)
    key = tuple((t.data_ptr(), t._version) for t in keyed) + (str(device),)
    hit = _LADDERS.get(key)
    if hit is None:
        tab = ladder_table(*(t.cpu().numpy() for t in keyed))
        hit = _LADDERS[key] = (torch.as_tensor(tab, device=device), keyed)
    return hit[0]


def check_inputs(inp):
    """Raises on RateInputs the kernel does not take: float fields other
    than float32 or float64 (one dtype throughout), bool masks and the int32
    noise energies in their dtypes, other shapes than [S, C, 960] per line,
    [S, C, NB] per band, [S, 1, NB] and [S] per station, C other than 1 or 2,
    a non-contiguous tensor, or tensors on more than one device."""
    ts = inp.tensors()
    if len({t.device for t in ts.values()}) != 1:
        raise ValueError(f"rate_loop: tensors on {sorted({str(t.device) for t in ts.values()})}")
    fdt = inp.mag075.dtype
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"rate_loop takes float32 or float64, got {fdt}")
    for k in ("absx", "thr4", "cap_thr", "floor29", "hole_rank", "hole_thr", "wgt",
              "log_ffak", "scf_corr", "thr"):
        if k in ts and ts[k].dtype != fdt:
            raise TypeError(f"rate_loop: {k} is {ts[k].dtype}, mag075 {fdt}")
    for k in ("neg", "pns_line", "no_ah", "pns_mask", "bsel", "force_break", "is_short"):
        if k in ts and ts[k].dtype != torch.bool:
            raise TypeError(f"rate_loop: {k} is {ts[k].dtype}, not bool")
    if inp.pns_nrg.dtype != torch.int32:
        raise TypeError(f"rate_loop: pns_nrg is {inp.pns_nrg.dtype}, not int32")
    for k in ("sect_hdr", "tns_bits", "elem_fixed", "budget_bits"):
        if k in ts and (ts[k].dtype.is_floating_point or ts[k].dtype == torch.bool):
            raise TypeError(f"rate_loop: {k} is {ts[k].dtype}, not an integer")
    if inp.mag075.ndim != 3:
        raise ValueError(f"rate_loop: mag075 is {tuple(inp.mag075.shape)}, not [S, C, {N}]")
    S, C = inp.mag075.shape[:2]
    if C not in (1, 2):
        raise ValueError(f"rate_loop takes 1 or 2 channels, got {C}")
    want = {k: (S, C, N) for k in inp.LINE}
    want.update({k: (S, C, NB) for k in inp.BAND})
    want.update(bsel=(S, 1, NB), force_break=(S, 1, NB), is_short=(S,), sect_hdr=(S,),
                tns_bits=(S, C), elem_fixed=(S,), budget_bits=(S,))
    for k, t in ts.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"rate_loop: {k} is {tuple(t.shape)}, not {want[k]} "
                             f"(S={S}, C={C}, NB={NB})")
        if not t.is_contiguous():
            raise ValueError(f"rate_loop: {k} is not contiguous")


def bound_bytes(S, C, itemsize=4):
    """Bytes the kernel must move for S stations of C channels: each input
    read once (per line two floats and two bools, per band nine floats, two
    bools and an int32, per station its masks and integers), each output
    written once (q int32, gains and books int32, bits int64)."""
    read = S * (C * N * (2 * itemsize + 2) + C * NB * (9 * itemsize + 2 + 4)
                + 2 * NB + 1 + 4 + 4 * C + 4 + 4)
    written = S * (C * N * 4 + 2 * C * NB * 4 + 8)
    return read + written


def rate_loop(inp, refine_rounds, table, params):
    """The rate loop of encode.rate_loop_plain on CUDA tensors: one launch
    for the whole AU.  inp: encode.RateInputs on one CUDA device; table:
    encode._RATE_TABLE; params: encode._RATE_PARAMS.  Returns (q int32
    [S,C,960], gains int32 [S,C,NB], books int32 [S,C,NB], bits int64 [S]),
    or raises on what the kernel does not take."""
    global launches
    check_inputs(inp)
    dev = inp.mag075.device
    if dev.type != "cuda":
        raise ValueError(f"rate_loop: the kernel takes CUDA tensors, got {dev}")
    if table.shape != (TABLE_LEN,):
        raise ValueError(f"rate_loop: table of {table.shape}, not ({TABLE_LEN},)")
    S, C = inp.mag075.shape[:2]
    i32 = {k: getattr(inp, k).to(torch.int32).contiguous() for k in
           ("tns_bits", "elem_fixed", "budget_bits")}
    if inp.is_short is not None:
        i32["sect_hdr"] = inp.sect_hdr.to(torch.int32).contiguous()
    out = dict(q=torch.empty((S, C, N), dtype=torch.int32, device=dev),
               gains=torch.empty((S, C, NB), dtype=torch.int32, device=dev),
               books=torch.empty((S, C, NB), dtype=torch.int32, device=dev),
               bits=torch.empty((S,), dtype=torch.int64, device=dev))
    if S == 0:
        return out["q"], out["gains"], out["books"], out["bits"]
    ptrs = dict(inp.tensors(), **i32, **out, ladders=_ladders(inp.ladders, dev),
                table=const(table, dev))
    args = _Args(**{k: (ptrs[k].data_ptr() if k in ptrs else None) for k in _PTRS},
                 S=S, C=C, refine_rounds=int(refine_rounds), table_len=TABLE_LEN,
                 f64=int(inp.mag075.dtype == torch.float64), p4=4.0, p43=4.0 / 3.0,
                 **params)
    with build.on_device(dev):
        rc = _launcher()(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rate_loop launch failed: cudaError {rc}")
    launches += 1
    return out["q"], out["gains"], out["books"], out["bits"]
