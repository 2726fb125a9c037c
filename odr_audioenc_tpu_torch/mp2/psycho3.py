"""Batched psy model 3 (port of odr_audioenc_tpu/mp2/psycho3.py;
libtoolame-dab/psycho_3.c): the cleaner reimplementation of ISO model 1.

Per channel (psycho_3.c:71-127): hann + FFT power spectrum -> per-subband
SPL -> tonal labeling (range-wise 7 dB-over-neighbours test with neighbour
zeroing) -> per-critical-band noise grouping -> ATH decimation -> masking
thresholds on a 136-line frequency subset -> min per subband -> SMR.

The JAX package runs the tonal walk and the two masker passes as
`lax.scan`s; here they are Python loops over the bins where something can
happen (a candidate, a masker in some row), batched over the rows, as the
port's exact psy-1 path does.  The same code serves f64 and f32.
"""
import numpy as np
import torch

from .. import tables as T
from ..device import const
from .psycho1 import _add_db

HBLK = 513
NBINS = 513  # psy3 arrays span bins 0..512 (bin 512 is a real masker here)
PAD = 12
DBMIN = T.DBMIN
SUBSIZE = 136

# srange per bin (psycho_3_tonal_label ranges, :206-215)
_RUN3 = np.zeros(NBINS, np.int32)
_RUN3[2:63] = 2
_RUN3[63:127] = 3
_RUN3[127:255] = 6
_RUN3[255:500] = 12

# 136-line frequency subset (psycho_3_init, :494-513)
_SUBSET = []
_i = 1
while _i < 3 * 16 + 1:
    _SUBSET.append(_i)
    _i += 1
while _i < 6 * 16 + 1:
    _SUBSET.append(_i)
    _i += 2
while _i < 12 * 16 + 1:
    _SUBSET.append(_i)
    _i += 4
while _i < 32 * 16 + 1:
    _SUBSET.append(_i)
    _i += 8
FREQ_SUBSET = np.asarray(_SUBSET, np.int32)
assert len(FREQ_SUBSET) == SUBSIZE
_SUBSET_SB = np.eye(32, dtype=bool)[FREQ_SUBSET >> 4]           # [136, 32]


def make_psy3_tables(sfreq_hz):
    """bark/ath per line + critical band boundaries (psycho_3_init)."""
    i = np.arange(HBLK).astype(np.float64)
    freq = i * sfreq_hz / 1024.0
    f = np.where(freq < -0.3, 3410.0, freq)
    f = np.clip(f / 1000.0, 0.01, 18.0)
    bark = 13.0 * np.arctan(0.76 * f) + 3.5 * np.arctan((f / 7.5) ** 2)
    # NB: the reference computes freq2bark on the raw freq (no clipping):
    fr = freq * 0.001
    bark = 13.0 * np.arctan(0.76 * fr) + 3.5 * np.arctan((fr / 7.5) ** 2)
    ath = (3.640 * np.power(f, -0.8)
           - 6.800 * np.exp(-0.6 * (f - 3.4) ** 2)
           + 6.000 * np.exp(-0.15 * (f - 8.7) ** 2)
           + 0.6e-3 * np.power(f, 4.0))
    cband = [1]
    cbase = 0
    for k in range(1, HBLK):
        if bark[k] - bark[cbase] > 1.0:
            cbase = k
            cband.append(k)
    cband.append(513)
    return dict(bark=bark, ath=ath, cbandindex=np.asarray(cband, np.int32))


def tonal_label3(power, dbtab):
    """Range-wise tonal labeling with neighbour zeroing (psycho_3.c:186-247).
    power: [B, 513].  Returns (power', xtm [B, 513], tone mask).

    Candidates are the strict local maxima of the ORIGINAL spectrum (strictly
    greater than both neighbours, :85-92) and are never cleared; an accepted
    candidate sets every line within +-srange, itself included, to DBMIN, so
    a later candidate reads the zeroed lines.  Only candidate bins are
    visited: elsewhere no row accepts and nothing changes."""
    B = power.shape[0]
    dev, dtype = power.device, power.dtype
    cand = torch.zeros_like(power, dtype=torch.bool)
    cand[:, 1:-1] = (power[:, 1:-1] > power[:, :-2]) & (power[:, 1:-1] > power[:, 2:])
    cand &= const(_RUN3, dev) > 0
    ppad = torch.full((B, NBINS + 2 * PAD), DBMIN, dtype=dtype, device=dev)
    ppad[:, PAD:PAD + NBINS] = power
    # bin 0 is never written by the reference (uninitialised stack); the
    # neighbour test at k=2, j=-2 reads it.  Modelled as 0.0 dB.
    ppad[:, PAD] = 0.0
    xtm = torch.full((B, NBINS), DBMIN, dtype=dtype, device=dev)
    tone = torch.zeros((B, NBINS), dtype=torch.bool, device=dev)

    for k in torch.nonzero(cand.any(dim=0)).flatten().tolist():
        run = int(_RUN3[k])
        c = k + PAD                                      # centre, padded coords
        x_c = ppad[:, c]
        side = torch.cat([ppad[:, c - run:c - 1], ppad[:, c + 2:c + run + 1]], dim=1)
        viol = ((x_c[:, None] - side) < 7.0).any(dim=1)
        accept = cand[:, k] & ~viol
        x = _add_db(_add_db(ppad[:, c - 1], x_c, dbtab), ppad[:, c + 1], dbtab)
        xtm[:, k] = torch.where(accept, x, xtm[:, k])
        tone[:, k] |= accept
        # zero ALL lines within +-srange including itself (:240-242)
        zs = slice(c - run, c + run + 1)
        ppad[:, zs] = torch.where(accept[:, None], DBMIN, ppad[:, zs])
    out = ppad[:, PAD:PAD + NBINS].clone()
    out[:, 0] = power[:, 0]
    return out, xtm, tone


def noise_label3(power, energy, cbandindex, dbtab):
    """Independent per-critical-band noise grouping (psycho_3.c:264-307).
    cbandindex: numpy band boundaries (make_psy3_tables).
    Returns (xnm [B, 513], noise mask)."""
    B = power.shape[0]
    dev, dtype = power.device, power.dtype
    ar = torch.arange(B, device=dev)
    xnm = torch.full((B, NBINS), DBMIN, dtype=dtype, device=dev)
    noise = torch.zeros((B, NBINS), dtype=torch.bool, device=dev)
    for c in range(len(cbandindex) - 1):
        lo, hi = int(cbandindex[c]), int(min(cbandindex[c + 1], NBINS))
        if lo >= NBINS:
            break
        seg_p = power[:, lo:hi]
        seg_e = energy[:, lo:hi]
        use = seg_p != DBMIN
        # sequential add_db over the band (ascending bins)
        s = torch.full((B,), DBMIN, dtype=dtype, device=dev)
        for j in range(hi - lo):
            s = torch.where(use[:, j], _add_db(seg_p[:, j], s, dbtab), s)
        esum = (seg_e * use).sum(dim=-1)
        cw = (seg_e * use * torch.arange(hi - lo, device=dev, dtype=dtype)).sum(dim=-1)
        no_comp = s <= DBMIN
        # the empty band's centre counts its end at most at 513
        centre = torch.where(no_comp, (lo + min(int(cbandindex[c + 1]), 513)) // 2,
                             lo + (cw / esum.clamp_min(1e-30)).to(torch.int32))
        centre = centre.long().clamp(0, NBINS - 1)
        xnm[ar, centre] = s
        noise[ar, centre] = True
    return xnm, noise


def masker_pass(member, xvals, bark, c_bark, c_off, dbtab):
    """Masking threshold over the 136-line subset from one masker type
    (psycho_3.c:318-394), in bin order 1..512.  Only bins that are a masker
    in some row are visited."""
    B = member.shape[0]
    dev, dtype = xvals.device, xvals.dtype
    bark_sub = bark[const(FREQ_SUBSET, dev, torch.int64)]       # [136]
    lt = torch.full((B, SUBSIZE), DBMIN, dtype=dtype, device=dev)
    for k in (torch.nonzero(member[:, 1:].any(dim=0)).flatten() + 1).tolist():
        xk = xvals[:, k]
        dz = bark_sub - bark[k]                                 # [136]
        in_rng = (dz >= -3.0) & (dz < 8.0)
        av = -1.525 + c_bark * bark[k] + c_off + xk             # [B]
        xkb = xk[:, None]
        vf = torch.where(dz < -1.0, 17.0 * (dz + 1.0) - (0.4 * xkb + 6.0),
             torch.where(dz < 0.0, (0.4 * xkb + 6.0) * dz,
             torch.where(dz < 1.0, -17.0 * dz,
                         -(dz - 1.0) * (17.0 - 0.15 * xkb) - 17.0)))
        newv = _add_db(lt, av[:, None] + vf, dbtab)
        lt = torch.where(member[:, k, None] & in_rng, newv, lt)
    return lt


def psycho_3(samples, scale_max, p3, low_rate):
    """samples: [B, 1024] in +-1; scale_max: [B, 32]; p3: make_psy3_tables
    with bark/ath as tensors in samples' dtype and cbandindex as numpy (one
    sample rate per batch); low_rate: [B] bool.  Returns smr [B, 32]."""
    dtype, dev = samples.dtype, samples.device
    dbtab = const(T.ADD_DB_TABLE, dev, dtype)
    # full 513-bin power spectrum (psycho_1_fft computes energy[512] too)
    spec = torch.fft.rfft(samples * const(T.PSY1_WINDOW, dev, dtype))
    energy = spec.real ** 2 + spec.imag ** 2                    # [B, 513]
    power = torch.where(energy < 1e-20, DBMIN + T.POWERNORM,
                        10.0 * torch.log10(energy.clamp_min(1e-300)) + T.POWERNORM)
    power[:, 0] = 0.0  # bin 0 "uninitialised" in the reference

    # SPL per subband (psycho_3_spl): bins 1..511 (bin 512's Xmax[32] write
    # is out of bounds in the reference and dropped here)
    spl = power[:, :512].clone()
    spl[:, 0] = DBMIN
    xmax = spl.reshape(-1, 32, 16).amax(dim=-1)
    lsb = torch.maximum(xmax, 20.0 * torch.log10(scale_max * 32768.0) - 10.0)

    power, xtm, tone = tonal_label3(power, dbtab)
    xnm, noise = noise_label3(power, energy, p3["cbandindex"], dbtab)

    # decimation vs ATH (psycho_3_decimation)
    ath = p3["ath"]
    drop_n = noise & (xnm < ath)
    noise = noise & ~drop_n
    xnm = torch.where(drop_n, DBMIN, xnm)
    drop_t = tone & (xtm < ath)
    tone = tone & ~drop_t
    xtm = torch.where(drop_t, DBMIN, xtm)

    bark = p3["bark"]
    lttm = masker_pass(tone, xtm, bark, -0.275, -4.5, dbtab)
    ltnm = masker_pass(noise, xnm, bark, -0.175, -0.5, dbtab)
    ltg = _add_db(ltnm, lttm, dbtab)
    ath_sub = ath[const(FREQ_SUBSET, dev, torch.int64)]
    base = torch.where(low_rate[:, None], ath_sub, ath_sub - 12.0)
    ltg = _add_db(base, ltg, dbtab)

    # min per subband over the subset (psycho_3_minimummasking)
    oh = const(_SUBSET_SB, dev)
    ltmin = torch.where(oh[None], ltg[:, :, None], 999999.9).amin(dim=1)
    return lsb - ltmin
