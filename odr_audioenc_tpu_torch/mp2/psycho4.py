"""Psy model 4 (port of odr_audioenc_tpu/mp2/psycho4.py; libtoolame-dab/
psycho_4.c): the cleaner reimplementation of model 2 with LAME's ATH
formula, freq2bark, and an isolated spreading function.

The runtime is psycho_2's (same ring, FFT, unpredictability, partitions,
spreading, tonality -> SNR, 17-line subband translation, psycho_4.c:124-325);
only the init tables differ (psycho_4_init, :330-430):

- bark per line from freq2bark (ath.c:73-79) instead of the CRIT_BAND
  interpolation;
- ATH per line from ATH_energy (dB formula + 41.837375 dB energy-domain
  offset, ath.c:7-69);
- minval (the per-partition SNR floor) indexed by the TRUNCATED central
  bark value (psycho_4.c:51-68, :276);
- the spreading function keeps the -60 dB cutoff and no LAME
  normalisation (psycho_4.c:435-470).

Unreachable from the reference's public API (toolame_set_psy_model clamps
models to 0..3, toolame.c:202-210); kept for inventory completeness.
"""
import numpy as np

from .psycho2 import BLKSIZE, CB, HBLK, LN_TO_LOG10, init_psy2_state, psycho_2

# minval[27], index = bark value (psycho_4.c:51-68)
_MINVAL = np.array([
    0.0, 20.0, 20.0, 20.0, 20.0, 20.0, 17.0, 15.0, 10.0, 7.0, 4.4,
    4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5,
    4.5, 4.5, 3.5], np.float64)


def _freq2bark(freq):
    freq = np.maximum(freq, 0.0) * 0.001
    return 13.0 * np.arctan(0.76 * freq) + 3.5 * np.arctan(freq * freq / 56.25)


def _ath_db(f, value):
    f = np.where(f < -0.3, 3410.0, f)
    f = np.clip(f / 1000.0, 0.01, 18.0)
    ath = (3.640 * np.power(f, -0.8)
           - 6.800 * np.exp(-0.6 * (f - 3.4) ** 2)
           + 6.000 * np.exp(-0.15 * (f - 8.7) ** 2)
           + 0.6e-3 * np.power(f, 4.0))
    return ath + value


def _ath_energy(freq, value):
    return np.power(10.0, (_ath_db(freq, 0.0) + value + 41.837375) * 0.1)


def _spreading(bark):
    """psycho_4_spreading_function (no LAME define)."""
    tempx = bark
    if 0.5 <= tempx <= 2.5:
        temp = tempx - 0.5
        x = 8.0 * (temp * temp - 2.0 * temp)
    else:
        x = 0.0
    tempx = tempx + 0.474
    tempy = 15.811389 + 7.5 * tempx - 17.5 * np.sqrt(1.0 + tempx * tempx)
    if tempy <= -60.0:
        return 0.0
    return np.exp((x + tempy) * LN_TO_LOG10)


def make_psy4_tables(sfreq, athlevel=0.0):
    """psycho_4_init (psycho_4.c:330-430), emitting the table dict shape
    psycho2's runtime consumes."""
    freqs = np.arange(HBLK) * sfreq / BLKSIZE
    bark = _freq2bark(freqs)
    ath = _ath_energy(freqs, athlevel)

    window = 0.5 * (1.0 - np.cos(2.0 * np.pi *
                                 (np.arange(BLKSIZE) - 0.5) / BLKSIZE))

    # partitions: new partition when > 0.33 bark from the partition's first
    # line (psycho_4.c:367-384)
    partition = np.zeros(HBLK, np.int32)
    numlines = np.zeros(CB, np.int32)
    pcount = 0
    cbase = 0
    for i in range(HBLK):
        if (bark[i] - bark[cbase]) > 0.33:
            cbase = i
            pcount += 1
        partition[i] = pcount
        numlines[pcount] += 1
    cbval = np.zeros(CB)
    for i in range(HBLK):
        cbval[partition[i]] += bark[i]
    nz = numlines != 0
    cbval[nz] = cbval[nz] / numlines[nz]

    s = np.zeros((CB, CB))
    for i in range(CB):
        for j in range(CB):
            s[i][j] = _spreading(1.05 * (cbval[i] - cbval[j]))
    rnorm = s.sum(axis=1)
    tmn = np.maximum(15.5 + cbval, 24.5)
    bmax_k = _MINVAL[cbval.astype(np.int32)]  # truncation, psycho_4.c:276

    ncb = int(partition[-1]) + 1
    P = np.zeros((CB, HBLK))
    P[partition, np.arange(HBLK)] = 1.0
    maxlines = int(numlines.max())
    seg_idx = np.zeros((CB, maxlines), np.int32)
    seg_msk = np.zeros((CB, maxlines), bool)
    for p in range(ncb):
        lines = np.nonzero(partition == p)[0]
        seg_idx[p, :len(lines)] = lines
        seg_msk[p, :len(lines)] = True

    denom_ok = (rnorm > 0) & (numlines > 0)
    nb_scale = np.where(denom_ok,
                        1.0 / np.where(denom_ok, rnorm * numlines, 1.0), 0.0)
    return {
        "absthr": ath, "window": window, "partition": partition,
        "P": P, "s": s, "tmn": tmn, "rnorm": rnorm, "bmax_k": bmax_k,
        "numlines": numlines, "ncb": ncb, "nb_scale": nb_scale,
        "seg_idx": seg_idx, "seg_msk": seg_msk,
    }


# the runtime is psycho_2's: same state shape, same granule math
init_psy4_state = init_psy2_state
psycho_4 = psycho_2
