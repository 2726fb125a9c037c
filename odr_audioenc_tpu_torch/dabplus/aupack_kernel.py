"""The DAB+ AU content pack as one hand-written CUDA kernel (csrc/au_pack.cu).

It replaces no TPU kernel: the JAX package's device pack is plain jnp code
that XLA fuses.  On the card the eager slot-grid pack (aupack.au_content_groups
and aupack.pack_au_content) cost some 4,000 small launches per AU; the kernel
writes one AU's content bytes, its bit count and its CRC reduction for every
station in one launch, one block per station.  Its plain version is that
eager pack; aupack.pack_au routes a CUDA tensor here and a CPU tensor there.

The kernel takes one int32 table per AuPackCtx (`table`, TABLE_LAYOUT then
x^(8j) mod g for j in 0..maxcb), made when the context is built.

`launches` counts the kernel's launches.
"""
import ctypes

import numpy as np
import torch

from ..kernels import build
from . import tables as AT

N = AT.N                    # lines per channel
NB = AT.MAX_SFB_LONG        # padded bands
NP = N // 2                 # line pairs per channel
THREADS = 256               # csrc/au_pack.cu THREADS: the CRC's byte slices follow it
# the table's parts in order (name, int32 entries); the kernel's T_* offsets
# follow it, and the powers x^(8j) mod g, j in 0..maxcb, come last
TABLE_LAYOUT = (("q12", 81 * 4), ("q34", 81 * 4), ("p56", 81 * 4), ("pair", 289 * 10),
                ("scf", 121 * 2), ("bop_long", NP), ("bop_short", NP), ("perm_short", NP),
                ("tx_long", NB), ("tx_short", NB), ("gstart_long", NB), ("gstart_short", NB),
                ("crc16", 256))
TABLE_FIXED = sum(n for _, n in TABLE_LAYOUT)

BOOL_KEYS = ("ms_used", "tns_en", "tns_en_lo")
INT_KEYS = ("q", "gains", "books", "tns_order", "tns_idx", "tns_order_lo", "tns_idx_lo",
            "tns_len", "wseq")

launches = 0     # au_pack kernel launches since the last reset

_PTRS = ("q", "gains", "books", "ms_used", "tns_en", "tns_order", "tns_idx", "tns_en_lo",
         "tns_order_lo", "tns_idx_lo", "tns_len", "wseq", "pad_buf", "pad_len", "sbr_w",
         "sbr_v", "is_last", "table", "aubuf", "au_bits", "crc_part")
_INTS = ("S", "C", "K", "K_lo", "pad_max", "pad_stride", "pad_len_stride", "n_sbr",
         "sbr_stride", "last", "last_stride", "max_sfb", "msfb_s", "has_tns", "length_code",
         "length_code_lo", "maxcb", "table_len")


class _Args(ctypes.Structure):
    """csrc/au_pack.cu's PackArgs, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]


_LAUNCHER = []


def _launcher():
    if not _LAUNCHER:
        fn = build.load("au_pack").au_pack_launch
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def table(parts, xpow8):
    """The kernel's int32 table: `parts` (name -> array, TABLE_LAYOUT's names
    and sizes) flattened in TABLE_LAYOUT's order, then xpow8 (x^(8j) mod g,
    j in 0..maxcb)."""
    out = []
    for name, n in TABLE_LAYOUT:
        a = np.asarray(parts[name]).astype(np.int64).reshape(-1)
        if a.shape != (n,):
            raise ValueError(f"au_pack table: {name} has {a.size} entries, not {n}")
        out.append(a)
    out.append(np.asarray(xpow8, np.int64).reshape(-1))
    return np.concatenate(out).astype(np.int32)


def crc_model(buf, tab, threads=THREADS):
    """Numpy model of the kernel's CRC reduction: each of `threads` slices of
    the [.., maxcb] byte buffer through the byte table from init 0, shifted
    by x^(8 * bytes after the slice) (a carry-less product mod g), XORed
    together.  Equals bitpack.crc_fixed(buf, R(8 maxcb)) with init 0."""
    buf = np.asarray(buf, np.int64)
    maxcb = buf.shape[-1]
    crc_t = np.asarray(tab[TABLE_FIXED - 256:TABLE_FIXED], np.int64)
    xp8 = np.asarray(tab[TABLE_FIXED:], np.int64)
    cb = -(-maxcb // threads)
    out = np.zeros(buf.shape[:-1], np.int64)
    for t in range(threads):
        b0, b1 = min(t * cb, maxcb), min(t * cb + cb, maxcb)
        r = np.zeros(buf.shape[:-1], np.int64)
        for i in range(b0, b1):
            r = ((r << 8) & 0xFFFF) ^ crc_t[((r >> 8) ^ buf[..., i]) & 0xFF]
        b = np.broadcast_to(xp8[maxcb - b1], r.shape).copy()
        acc = np.zeros_like(r)
        for i in range(16):
            acc ^= np.where((r >> i) & 1, b, 0)
            b = ((b << 1) ^ np.where((b >> 15) & 1, 0x11021, 0)) & 0xFFFF
        out ^= acc
    return out.astype(np.int32)


def check_inputs(n_ch, o, is_last, pad_buf=None, pad_len=None, sbr_group=None):
    """Raises on one AU's inputs that the kernel does not take: other dtypes
    than int32 (INT_KEYS, pad_buf, pad_len, the FIL group) and bool
    (BOOL_KEYS, a tensor is_last), other shapes than [S, n_ch, 960] (q),
    [S, n_ch, NB] (gains, books), [S, NB] (ms_used), [S, n_ch] (the TNS flags,
    orders and lengths; tns_len may be None), [S, n_ch, K] (the TNS
    coefficients), [S] (wseq, pad_len, a tensor is_last of more than one
    element) and [S, P] (pad_buf, each of the FIL group's two, alike in shape
    and row stride), a core tensor that is not contiguous, a row-strided one
    whose rows are not, pad_buf without pad_len, or tensors on more than one
    device.  Returns the device."""
    ts = {k: o[k] for k in BOOL_KEYS + INT_KEYS if o.get(k) is not None}
    rows = {}
    if (pad_buf is None) != (pad_len is None):
        raise ValueError("au_pack: pad_buf and pad_len come together")
    if pad_buf is not None:
        rows.update(pad_buf=pad_buf, pad_len=pad_len)
    if sbr_group is not None:
        rows.update(sbr_w=sbr_group[0], sbr_v=sbr_group[1])
    if isinstance(is_last, torch.Tensor):
        rows["is_last"] = is_last
    every = {**ts, **rows}
    if len({t.device for t in every.values()}) != 1:
        raise ValueError(f"au_pack: tensors on {sorted({str(t.device) for t in every.values()})}")
    for k, t in every.items():
        want = torch.bool if k in BOOL_KEYS or k == "is_last" else torch.int32
        if t.dtype != want:
            raise TypeError(f"au_pack: {k} is {t.dtype}, not {want}")
    if o["q"].ndim != 3:
        raise ValueError(f"au_pack: q is {tuple(o['q'].shape)}, not [S, {n_ch}, {N}]")
    S = o["q"].shape[0]
    want = dict(q=(S, n_ch, N), gains=(S, n_ch, NB), books=(S, n_ch, NB), ms_used=(S, NB),
                tns_en=(S, n_ch), tns_order=(S, n_ch), tns_en_lo=(S, n_ch),
                tns_order_lo=(S, n_ch), tns_len=(S, n_ch), wseq=(S,), pad_len=(S,))
    # a free last dimension: the TNS coefficients, the DSE's bytes, the FIL group's slots
    for k, lead in (("tns_idx", (S, n_ch)), ("tns_idx_lo", (S, n_ch)), ("pad_buf", (S,)),
                    ("sbr_w", (S,)), ("sbr_v", (S,))):
        if k in every:
            t = every[k]
            want[k] = lead + (t.shape[-1] if t.ndim == len(lead) + 1 else "P",)
    if "is_last" in rows:
        want["is_last"] = (S,) if is_last.numel() != 1 else tuple(is_last.shape)
    for k, t in every.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"au_pack: {k} is {tuple(t.shape)}, not {want[k]} (S={S}, "
                             f"C={n_ch}, NB={NB})")
        if k in ts and not t.is_contiguous():
            raise ValueError(f"au_pack: {k} is not contiguous")
        if k in ("pad_buf", "sbr_w", "sbr_v") and t.stride(-1) != 1:
            raise ValueError(f"au_pack: {k}'s rows are not contiguous")
    if sbr_group is not None and (sbr_group[0].shape != sbr_group[1].shape
                                  or sbr_group[0].stride(0) != sbr_group[1].stride(0)):
        raise ValueError("au_pack: the FIL group's widths and values differ in shape or stride")
    return o["q"].device


def bound_bytes(S, C, maxcb, n_sbr=0, K=12):
    """Bytes the kernel must move for S stations of C channels without
    X-PAD: each input read once (q, gains, books and the TNS fields as
    int32, K coefficients per filter, the masks as bytes, wseq, the FIL
    group's n_sbr slots), each output written once (the maxcb content bytes,
    the bit count and the CRC)."""
    read = S * (4 * C * (N + 2 * NB + 3 + 2 * K) + NB + 2 * C + 4 + 8 * n_sbr)
    return read + S * (maxcb + 8)


def pack_au(ctx, o, is_last, pad_buf=None, pad_len=None, sbr_group=None):
    """aupack.au_content_groups + pack_au_content on CUDA tensors: one launch
    for the AU.  o: the AU's decisions (aupack.CORE_KEYS) as check_inputs
    takes them; is_last: bool or a bool tensor ([S] or one element);
    pad_buf [S, P] / pad_len [S]: the AU's X-PAD bytes; sbr_group: (widths,
    values) [S, K] of its FIL element.  Returns (aubuf [S, maxcb] uint8,
    au_bits [S] int32, crc_part [S] int32), or raises on what the kernel does
    not take."""
    global launches
    dev = check_inputs(ctx.n_ch, o, is_last, pad_buf, pad_len, sbr_group)
    if dev.type != "cuda":
        raise ValueError(f"au_pack: the kernel takes CUDA tensors, got {dev}")
    S, C = o["q"].shape[:2]
    maxcb = ctx.maxcb
    tab = ctx.kernel_table
    if tab.device != dev or tab.shape != (TABLE_FIXED + maxcb + 1,):
        raise ValueError(f"au_pack: table of {tuple(tab.shape)} on {tab.device}, not "
                         f"({TABLE_FIXED + maxcb + 1},) on {dev}")
    out = dict(aubuf=torch.empty((S, maxcb), dtype=torch.uint8, device=dev),
               au_bits=torch.empty((S,), dtype=torch.int32, device=dev),
               crc_part=torch.empty((S,), dtype=torch.int32, device=dev))
    if S == 0:
        return out["aubuf"], out["au_bits"], out["crc_part"]
    K, K_lo = o["tns_idx"].shape[-1], o["tns_idx_lo"].shape[-1]
    has_tns = ctx.tns_cfg is not None
    ptrs = {k: o[k] for k in BOOL_KEYS + INT_KEYS if o.get(k) is not None}
    ptrs.update(out, table=tab)
    ints = dict(S=S, C=C, K=K, K_lo=K_lo, max_sfb=ctx.max_sfb, msfb_s=ctx.msfb_s,
                has_tns=int(has_tns),
                length_code=ctx.tns_cfg["length_code"] if has_tns else 0,
                length_code_lo=ctx.tns_cfg["length_code_lo"] if has_tns else 0,
                maxcb=maxcb, table_len=tab.shape[0])
    if pad_buf is not None:
        ptrs.update(pad_buf=pad_buf, pad_len=pad_len)
        ints.update(pad_max=pad_buf.shape[1], pad_stride=pad_buf.stride(0),
                    pad_len_stride=pad_len.stride(0))
    if sbr_group is not None:
        ptrs.update(sbr_w=sbr_group[0], sbr_v=sbr_group[1])
        ints.update(n_sbr=sbr_group[0].shape[1], sbr_stride=sbr_group[0].stride(0))
    if isinstance(is_last, torch.Tensor):
        ptrs["is_last"] = is_last
        ints["last_stride"] = 0 if is_last.numel() == 1 else is_last.stride(0)
    else:
        ints["last"] = int(bool(is_last))
    args = _Args(**{k: (ptrs[k].data_ptr() if k in ptrs else None) for k in _PTRS}, **ints)
    with build.on_device(dev):
        rc = _launcher()(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"au_pack launch failed: cudaError {rc}")
    launches += 1
    return out["aubuf"], out["au_bits"], out["crc_part"]
