"""Vectorised psy model 1 for the f32 throughput path (port of
odr_audioenc_tpu/mp2/psycho1_fast.py).

Same masking model as psycho1.py, with the sequential list walks expressed
as data-parallel passes:

  tonal labeling  -> bounded relaxation; on CUDA the hand-written kernel
                     (psycho1_kernels.tonal_walk), on the CPU tonal_fast
  noise labeling  -> independent per-critical-band reductions; with
                     use_kernel="fused-noise" fused with the tonal walk in
                     one CUDA kernel (psycho1_kernels.tonal_noise), on the
                     CPU tonal_noise_fast
  0.5-bark merge  -> bounded pairwise relaxation over compacted maskers
  thresholds      -> linear-domain accumulation over compacted maskers

The reference's 0.1 dB add_db table is replaced by exact linear-domain sums,
so SMRs differ from the exact path by well under the table's own error.
"""
import numpy as np
import torch

from .. import tables as T
from ..device import const
from . import psycho1_kernels
from .psycho1 import DBMIN, NBINS, PAD, minimum_mask, power_spectrum, smr_from, \
    subsample, tonal_candidates

_RELAX_ROUNDS = 1
_MERGE_ROUNDS = 1
MAX_TONE = 64


def _lin(x):
    return torch.pow(10.0, 0.1 * x)


def _db(p):
    return 10.0 * torch.log10(p.clamp_min(1e-37))


def min_zeroer(accept):
    """mz[b] = the smallest accepted bin a != b with |a - b| <= TONAL_RUN[a]
    (it zeroes b), NBINS + 1 where there is none; accept [B, 512] bool."""
    B, dev = accept.shape[0], accept.device
    runs = const(T.TONAL_RUN, dev, torch.int64)
    bins = torch.arange(NBINS, device=dev)
    mz = torch.full((B, NBINS), NBINS + 1, dtype=torch.int64, device=dev)
    for d in range(1, PAD + 1):
        src = accept & (runs >= d)
        zr = torch.roll(src, d, 1) & (bins >= d)            # accepter at b-d
        zl = torch.roll(src, -d, 1) & (bins < NBINS - d)    # accepter at b+d
        mz = torch.where(zr, torch.minimum(mz, bins - d), mz)
        mz = torch.where(zl, torch.minimum(mz, bins + d), mz)
    return mz


def tonal_fast(power, cand):
    """Left-causal relaxation version of the tonal walk - the plain version
    of the CUDA kernel in psycho1_kernels.

    The sequential walk processes candidates in bin order, so a candidate's
    decision depends only on mutations from ACCEPTED candidates strictly to
    its left: min_zeroer[b] = smallest accepted bin that zeroes b, and bin b
    reads as DBMIN for an observer at c iff min_zeroer[b] < c.  Shifts are
    torch.roll, wrapping at the edges as jnp.roll does (the wrapped lanes
    are masked or never read at accepted bins).
    Returns (power', member, typ)."""
    B = power.shape[0]
    dev = power.device
    runs = const(T.TONAL_RUN, dev, torch.int64)                       # [512]
    bins = torch.arange(NBINS, device=dev)
    BIG = NBINS + 1

    def boost_values(mz):
        """boosted dB of each bin as if accepted at its own turn (neighbours
        read DBMIN if zeroed before that turn)."""
        def nb(shift):
            v = torch.roll(power, shift, 1)
            m = torch.roll(mz, shift, 1)
            return torch.where(m < bins, 0.0, _lin(v))
        return _db(_lin(power) + nb(1) + nb(-1))

    def decide(accept):
        mz = min_zeroer(accept)
        boost = boost_values(mz)
        excluded = mz < bins
        maxv = power - 7.0
        viol = torch.zeros_like(cand)
        for o in list(range(-PAD, -1)) + list(range(2, PAD + 1)):
            b_ok = (bins + o >= 0) & (bins + o < NBINS)
            mz_o = torch.roll(mz, -o, 1)
            acc_o = torch.roll(accept, -o, 1)
            val = torch.where(mz_o < bins, DBMIN, torch.where(
                acc_o & (o < 0), torch.roll(boost, -o, 1), torch.roll(power, -o, 1)))
            viol = viol | ((runs >= abs(o)) & b_ok & (maxv < val))
        return cand & ~excluded & ~viol

    accept = decide(torch.zeros_like(cand))
    for _ in range(_RELAX_ROUNDS - 1):
        accept = decide(accept)

    mz = min_zeroer(accept)
    boost = boost_values(mz)
    # list surgery (psycho_1.c:313-315): member `prev` is dropped when the
    # next accepted `b` is within run(b), provided prev has a predecessor
    midx = torch.where(accept, bins, -1)
    prev_inc = torch.cummax(midx, dim=1).values
    prev = torch.cat([torch.full((B, 1), -1, dtype=prev_inc.dtype, device=dev),
                      prev_inc[:, :-1]], dim=1)
    pprev = torch.gather(prev, 1, prev.clamp_min(0))
    drop_prev_at = accept & (prev >= 0) & ((bins - prev) <= runs) & (pprev >= 0)
    dropped = torch.zeros((B, NBINS + 1), dtype=torch.int64, device=dev)
    # one drop target per accepted bin; the rest land in the dump column
    dropped.scatter_add_(1, torch.where(drop_prev_at, prev, NBINS),
                         drop_prev_at.long())
    member = accept & (dropped[:, :NBINS] == 0)

    zeroed = mz < BIG
    power = torch.where(zeroed, DBMIN, torch.where(accept, boost, power))
    typ = accept & ~zeroed  # type==TONE after the walk (zeroing clears it)
    return power, member, typ


def noise_fast(power, is_tone, energy, band_matrix, centre_base, centre_span):
    """Independent per-band noise maskers.

    band_matrix: [NBANDS, 512] (shared) or [B, NBANDS, 512] 0/1 rows per
    critical band; centre_base/centre_span: [B, NBANDS] cbound[k], width.
    Returns (power', noise_member)."""
    dtype, dev = power.dtype, power.device
    usable = (~is_tone) & (power != DBMIN)
    p_lin = _lin(power) * usable
    bins = torch.arange(NBINS, device=dev, dtype=dtype)

    def bandsum(x):
        if band_matrix.ndim == 2:
            return x @ band_matrix.T                            # [B, NBANDS]
        return torch.einsum("bn,bkn->bk", x, band_matrix)

    # CF*energy weighting with the in-band position fraction
    sums = bandsum(p_lin)
    wsum = bandsum(T.CF * energy * usable)
    wpos = bandsum(T.CF * energy * usable * bins)
    span = centre_span.clamp_min(1).to(dtype)
    weight = (wpos - centre_base.to(dtype) * wsum) / span
    no_comp = sums <= 0.0
    sum_db = _db(sums)
    index = weight / sums.clamp_min(1e-37)
    centre = centre_base.long() + (index * span).to(torch.int32).long()   # trunc
    centre = torch.where(no_comp, (centre_base + centre_span // 2).long(), centre)
    centre = centre.clamp(0, NBINS - 1)
    # Iwadare adjust: tone flags at centre / centre+1
    t_c = torch.gather(is_tone, 1, centre)
    tone_next = torch.cat([is_tone[:, 1:], torch.zeros_like(is_tone[:, :1])], dim=1)
    t_c1 = torch.gather(tone_next, 1, centre)
    centre = torch.where(t_c, torch.where(t_c1, centre + 1, centre - 1), centre)
    centre = centre.clamp(0, NBINS - 1)
    valid = centre_span > 0
    sum_db = torch.where(no_comp, DBMIN, sum_db)
    # consumed lines -> DBMIN; then the centre writes in band order (a later
    # band's centre can overwrite an earlier masker - noise_label mutates in
    # place, psycho_1.c:390-397): the last valid band writing a bin wins
    if band_matrix.ndim == 2:
        inband = (band_matrix.sum(0) > 0)[None, :]
    else:
        inband = band_matrix.sum(1) > 0
    power = torch.where(usable & inband, DBMIN, power)
    nb = centre.shape[1]
    kidx = torch.arange(nb, device=dev).expand_as(centre)
    winner = torch.full((power.shape[0], NBINS + 1), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, torch.where(valid, centre, NBINS),
                           torch.where(valid, kidx, -1), reduce="amax")
    winner = winner[:, :NBINS]
    member = winner >= 0
    won = torch.gather(sum_db, 1, winner.clamp_min(0))
    return torch.where(member, won, power), member


def tonal_noise_fast(power, cand, energy, bmt, base, span):
    """The plain version of the fused tonal+noise CUDA kernel in
    psycho1_kernels: tonal_fast, then noise_fast on the uniform band
    geometry (one sample rate per batch).  bmt [512, 32] is the transposed,
    zero-padded band matrix; base/span [32] the bands' first bin and width
    (span 0 = no band).  Returns (power', tone member, noise member)."""
    pw, tone_m, typ = tonal_fast(power, cand)
    B = power.shape[0]
    pw, noise_m = noise_fast(pw, typ, energy, bmt.T, base.expand(B, -1), span.expand(B, -1))
    return pw, tone_m, noise_m


def compact_maskers(member, power, bark_of_bin, kmax):
    """Compact the sparse masker set to its first `kmax` members (bin
    order).  Returns (m [B,K] valid, x [B,K] dB, bk [B,K] bark at the masker
    bin).  Each member's rank is its slot; members past kmax and non-members
    are written to a dump column."""
    B = member.shape[0]
    rank = torch.cumsum(member, dim=1) - 1                      # [B, N]
    slot = torch.where(member & (rank < kmax), rank, kmax)
    x = torch.zeros((B, kmax + 1), dtype=power.dtype, device=power.device)
    bk = torch.zeros_like(x)
    m = torch.zeros((B, kmax + 1), dtype=torch.bool, device=power.device)
    x.scatter_(1, slot, power)
    bk.scatter_(1, slot, bark_of_bin.expand_as(power).to(power.dtype))
    m.scatter_(1, slot, member)
    return m[:, :kmax], x[:, :kmax], bk[:, :kmax]


def merge_compact(m, x, bk):
    """Bounded-relaxation 0.5-bark pairwise merge in the compact [B,K]
    masker domain (entries are in ascending-bin order, so the previous list
    member is the previous valid compact slot)."""
    B, K = m.shape
    ks = torch.arange(K, device=m.device)
    for _ in range(_MERGE_ROUNDS):
        prev_inc = torch.cummax(torch.where(m, ks, -1), dim=1).values
        prev = torch.cat([torch.full((B, 1), -1, dtype=prev_inc.dtype, device=m.device),
                          prev_inc[:, :-1]], dim=1)
        pc = prev.clamp_min(0)
        bk_p, x_p = torch.gather(bk, 1, pc), torch.gather(x, 1, pc)
        close = m & (prev >= 0) & ((bk - bk_p) < 0.5)
        drop_self = close & (x <= x_p)
        drop_prev_at = close & (x > x_p)
        dropped = torch.zeros((B, K + 1), dtype=torch.int64, device=m.device)
        dropped.scatter_add_(1, torch.where(drop_prev_at, prev, K), drop_prev_at.long())
        m = m & ~drop_self & (dropped[:, :K] == 0)
    return m


def threshold_fast(tone_c, noise_c, bark_line, hear_line, sub_size, low_rate):
    """Linear-domain global threshold over pre-compacted masker sets.
    tone_c/noise_c: (m [B,K], x [B,K], bark_t [B,K]) from compact_maskers."""
    B, nline = bark_line.shape
    dev = bark_line.device
    ks = torch.arange(nline, device=dev)
    kvalid = (ks[None, :] >= 1) & (ks[None, :] < sub_size[:, None])
    m = torch.cat([tone_c[0], noise_c[0]], dim=1)
    x_t = torch.cat([tone_c[1], noise_c[1]], dim=1)
    bark_t = torch.cat([tone_c[2], noise_c[2]], dim=1)
    kt = tone_c[0].shape[1]
    c_bark = torch.full((m.shape[1],), -0.175, dtype=x_t.dtype, device=dev)
    c_off = torch.full((m.shape[1],), -0.5, dtype=x_t.dtype, device=dev)
    c_bark[:kt], c_off[:kt] = -0.275, -4.5
    # one [B, K_tone+K_noise, NLINE] pass for both masker types
    dz = bark_line[:, None, :] - bark_t[:, :, None]
    in_rng = (dz >= -3.0) & (dz < 8.0)
    tmps = -1.525 + c_bark * bark_t + c_off + x_t              # [B, K]
    xt = x_t[:, :, None]
    vf = torch.where(dz < -1.0, 17.0 * (dz + 1.0) - (0.4 * xt + 6.0),
         torch.where(dz < 0.0, (0.4 * xt + 6.0) * dz,
         torch.where(dz < 1.0, -17.0 * dz,
                     -(dz - 1.0) * (17.0 - 0.15 * xt) - 17.0)))
    acc = (_lin(tmps[:, :, None] + vf) * (in_rng & m[:, :, None])).sum(dim=1)
    base = torch.where(low_rate[:, None], hear_line, hear_line - 12.0)
    return torch.where(kvalid, _db(_lin(base) + acc), DBMIN)


def minimum_mask_fast(ltg_x, hear_line, static_mm):
    """minimum_mask with the config-static structure (homogeneous sample
    rate) precomputed: one masked min-reduce and one gather."""
    mask, tail, j_idx, has_match, ss = static_mm
    min_match = torch.where(mask[None], ltg_x[:, :, None],
                            float(np.finfo(np.float32).max)).amin(dim=1)
    x_at_j = ltg_x[:, j_idx]                                    # [B, 32]
    out = torch.where(has_match[None], min_match, x_at_j)
    return torch.where(tail[None], hear_line[:, ss - 1][:, None], out)


def psycho_1_fast(samples, scale_max, psy_tabs, low_rate, use_kernel="tonal"):
    """psycho1.psycho_1 on the fast path.  use_kernel="tonal" runs the
    tonal walk through psycho1_kernels.tonal_walk and the noise labelling as
    torch ops; "fused-noise" runs both through psycho1_kernels.tonal_noise.
    Each wrapper launches its CUDA kernel for a CUDA tensor and takes its
    plain version for a CPU tensor.  The fused kernel needs the uniform
    band geometry (`static_noise_uniform`), which exists only when every
    row has the same sample rate; for a mixed batch it is None, and
    "fused-noise" runs the tonal walk and then noise_fast, as the JAX
    package dispatches on that geometry."""
    if use_kernel not in ("tonal", "fused-noise"):
        raise ValueError(f"use_kernel must be 'tonal' or 'fused-noise', not {use_kernel!r}")
    dtype = samples.dtype
    power, energy, spike = power_spectrum(samples)
    cand = tonal_candidates(power)
    # the CUDA kernels take f32 (an f64 run on the card rounds here)
    to_kernel = (lambda t: t.float()) if power.is_cuda else (lambda t: t)
    uniform = psy_tabs.get("static_noise_uniform")
    if use_kernel == "fused-noise" and uniform is not None:
        pw, tone_m, noise_m = psycho1_kernels.tonal_noise(to_kernel(power), cand,
                                                          to_kernel(energy), *uniform)
        power = pw.to(dtype)
    else:
        pw, tone_m, tone_typ = psycho1_kernels.tonal_walk(to_kernel(power), cand)
        power, noise_m = noise_fast(pw.to(dtype), tone_typ, energy, psy_tabs["band_matrix"],
                                    psy_tabs["centre_base"], psy_tabs["centre_span"])
    hear_of_bin = psy_tabs["hear_of_bin"]
    power, tone_m = subsample(power, tone_m, hear_of_bin)
    power, noise_m = subsample(power, noise_m, hear_of_bin)

    # compact both masker sets once; merge + threshold run in [B,K] domain
    bark_of_bin = psy_tabs["bark_of_bin"]
    m_t, x_t, bk_t = compact_maskers(tone_m, power, bark_of_bin, MAX_TONE)
    m_t = merge_compact(m_t, x_t, bk_t)
    m_n, x_n, bk_n = compact_maskers(noise_m, power, bark_of_bin, 32)
    ltg = threshold_fast((m_t, x_t, bk_t), (m_n, x_n, bk_n), psy_tabs["bark_line"],
                         psy_tabs["hear_line"], psy_tabs["sub_size"], low_rate)
    if psy_tabs.get("static_mm") is not None:
        ltmin = minimum_mask_fast(ltg, psy_tabs["hear_line"], psy_tabs["static_mm"])
    else:
        ltmin = minimum_mask(ltg, psy_tabs["line_sb"], psy_tabs["hear_line"],
                             psy_tabs["sub_size"])
    return smr_from(ltmin, spike, scale_max)


def make_fast_tables(psy_tabs_np, dtype=np.float32):
    """Extend make_psy1_tables output (numpy) with the per-band 0/1 matrix
    (shared [NBANDS, 512] when all rows agree, else [B, NBANDS, 512]), the
    band geometry, the fused kernel's uniform geometry and the static
    minimum_mask structure (homogeneous rate only)."""
    cb = psy_tabs_np["cbound"]          # [B, 27]
    nc = psy_tabs_np["n_cband"]         # [B]
    B = cb.shape[0]
    NBANDS = 26
    base = np.zeros((B, NBANDS), np.int32)
    span = np.zeros((B, NBANDS), np.int32)
    for b in range(B):
        n = int(nc[b])
        for k in range(min(n - 1, NBANDS)):
            base[b, k] = cb[b, k]
            span[b, k] = cb[b, k + 1] - cb[b, k]
    uniq = np.unique(np.concatenate([base, span], 1), axis=0)
    if len(uniq) == 1:
        bm = np.zeros((NBANDS, 512), dtype)
        for k in range(NBANDS):
            if span[0, k] > 0:
                bm[k, base[0, k]: base[0, k] + span[0, k]] = 1.0
        band_matrix = bm
    else:
        bm = np.zeros((B, NBANDS, 512), dtype)
        for b in range(B):
            for k in range(NBANDS):
                if span[b, k] > 0:
                    bm[b, k, base[b, k]: base[b, k] + span[b, k]] = 1.0
        band_matrix = bm

    out = {"band_matrix": band_matrix, "centre_base": base, "centre_span": span}
    if band_matrix.ndim == 2 and len(np.unique(np.concatenate([base, span], 1), axis=0)) == 1:
        bmt = np.zeros((512, 32), dtype)
        bmt[:, :NBANDS] = band_matrix.T
        base32 = np.zeros(32, np.int32)
        span32 = np.zeros(32, np.int32)
        base32[:NBANDS] = base[0]
        span32[:NBANDS] = span[0]
        out["static_noise_uniform"] = (bmt, base32, span32)
    else:
        out["static_noise_uniform"] = None

    ls_rows = psy_tabs_np["line_sb"]
    ss_rows = psy_tabs_np["sub_size"]
    if len(np.unique(ls_rows, axis=0)) == 1 and len(np.unique(ss_rows)) == 1:
        NLINE = ls_rows.shape[1]
        ss = int(ss_rows[0])
        ls = ls_rows[0]
        valid = (np.arange(NLINE) >= 1) & (np.arange(NLINE) < ss)
        sbl = np.where(valid, ls, 999)
        j_raw = 1 + (sbl[None, :] < np.arange(32)[:, None]).sum(1)
        j_i = np.clip(j_raw, 0, NLINE - 1)
        tail = j_raw >= ss - 1
        mask = sbl[:, None] == np.arange(32)[None, :]           # [NLINE, 32]
        has_match = mask.any(0)
        j_onehot = np.zeros((NLINE, 32), dtype)
        j_onehot[j_i, np.arange(32)] = 1.0
        out["static_mm"] = (mask, tail, j_onehot, has_match, ss)
    else:
        out["static_mm"] = None
    return out
