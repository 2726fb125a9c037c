"""AAC constant tables for the DAB+ encoder (960 transform).

Loaded from data/aac_tables.npz (MPEG-4 standard tables extracted by
tools/gen_aac_tables.py from the reference fdk-aac ROMs: sfb widths
psy_configuration.cpp:238-260, Huffman books aacEnc_rom.cpp)."""
from pathlib import Path

import numpy as np

_npz = np.load(Path(__file__).parent.parent / "data" / "aac_tables.npz")

SFB_LONG = {r: _npz[f"sfb_long_{r}"] for r in [16000, 22050, 24000, 32000, 44100, 48000]}
SFB_SHORT = {r: _npz[f"sfb_short_{r}"] for r in [16000, 22050, 24000, 32000, 44100, 48000]}

HUFF_LEN = {b: _npz[f"huff_len{b}"] for b in range(1, 12)}
HUFF_CODE = {b: _npz[f"huff_code{b}"] for b in range(1, 12)}
HUFF_LEN_SCF = _npz["huff_lenscf"]    # [121] index = delta + 60
HUFF_CODE_SCF = _npz["huff_codescf"]  # [121]

MAX_SFB_LONG = 49  # padded band count used on device
N = 960


def sfb_offsets(rate):
    w = SFB_LONG[rate]
    off = np.zeros(len(w) + 1, np.int32)
    off[1:] = np.cumsum(w)
    return off


def band_matrix(rate, nbands=MAX_SFB_LONG):
    """[nbands, 960] one-hot rows for per-band reductions."""
    off = sfb_offsets(rate)
    m = np.zeros((nbands, N), np.float32)
    for b in range(len(off) - 1):
        m[b, off[b]:off[b + 1]] = 1.0
    return m


def band_of_line(rate):
    off = sfb_offsets(rate)
    out = np.zeros(N, np.int32)
    for b in range(len(off) - 1):
        out[off[b]:off[b + 1]] = b
    return out


def mdct_matrix(n=N, dtype=np.float64):
    """[2n, n] windowed forward MDCT basis (sine window), scaled so that the
    ISO IMDCT + overlap-add reconstructs unity."""
    ns = np.arange(2 * n)[:, None].astype(np.float64)
    ks = np.arange(n)[None, :].astype(np.float64)
    win = np.sin(np.pi / (2 * n) * (ns + 0.5))
    basis = np.cos(np.pi / n * (ns + 0.5 + n / 2.0) * (ks + 0.5))
    # x2: the decoder's IMDCT convention is x[n] = (2/N) sum spec cos(...);
    # forward must carry the 2 so the windowed overlap-add is unity
    # (calibrated against the fdk decoder loopback)
    return (2.0 * win * basis).astype(dtype)


NS = 120           # short transform length (960/8)
N_GROUPS = 2       # fixed {4,4} window grouping (the reference's sync
                   # fallback grouping, block_switch.cpp:526-530); groups are
                   # static so the grouped-band structure is batch-uniform
GROUP_OF_WINDOW = np.repeat(np.arange(N_GROUPS), 8 // N_GROUPS)
SCF_GROUPING = 0b1110111  # 7 bits: window i+1 in same group as window i


def sfb_short_offsets(rate):
    w = SFB_SHORT[rate]
    off = np.zeros(len(w) + 1, np.int32)
    off[1:] = np.cumsum(w)
    return off


def short_band_matrix(rate, nbands=MAX_SFB_LONG):
    """[nbands, 960] one-hot rows for grouped short-block bands over the
    WINDOW-MAJOR short spectrum layout [8 windows x 120 lines].  Band
    (g, b) -> row g*nsfb + b covers sfb b's lines in each window of group g.
    All sfb widths are %4 == 0 and windows start at %4 offsets, so Huffman
    quads/pairs never straddle window chunks and device-side bit counts over
    this layout equal counts over the transmitted (interleaved) order."""
    off = sfb_short_offsets(rate)
    nsfb = len(off) - 1
    m = np.zeros((nbands, N), np.float32)
    for w in range(8):
        g = GROUP_OF_WINDOW[w]
        for b in range(nsfb):
            m[g * nsfb + b, w * NS + off[b]: w * NS + off[b + 1]] = 1.0
    return m


def short_band_of_line(rate):
    off = sfb_short_offsets(rate)
    nsfb = len(off) - 1
    out = np.zeros(N, np.int32)
    for w in range(8):
        g = GROUP_OF_WINDOW[w]
        for b in range(nsfb):
            out[w * NS + off[b]: w * NS + off[b + 1]] = g * nsfb + b
    return out


def long_cos_basis(dtype=np.float64):
    """Unwindowed [1920, 960] forward MDCT basis (factor 2 as mdct_matrix);
    the window is applied per stream as a [1920] vector so START/STOP/LONG
    shapes share one matmul."""
    ns = np.arange(2 * N)[:, None].astype(np.float64)
    ks = np.arange(N)[None, :].astype(np.float64)
    return (2.0 * np.cos(np.pi / N * (ns + 0.5 + N / 2.0) * (ks + 0.5))).astype(dtype)


def short_cos_basis(dtype=np.float64):
    """Windowed [240, 120] short MDCT basis (sine window, factor 2)."""
    ns = np.arange(2 * NS)[:, None].astype(np.float64)
    ks = np.arange(NS)[None, :].astype(np.float64)
    win = np.sin(np.pi / (2 * NS) * (ns + 0.5))
    return (2.0 * win * np.cos(np.pi / NS * (ns + 0.5 + NS / 2.0) * (ks + 0.5))).astype(dtype)


SHORT_OFFSET = (N - NS) // 2  # 420: first short window start in [prev||cur]


def window_vectors(dtype=np.float64):
    """[4, 1920] analysis windows for LONG/START/SHORT/STOP sequences (sine
    shape throughout; window_shape=0 is signalled for every frame).  The
    SHORT row is unused (the short path has its own windowed basis)."""
    n = np.arange(2 * N)
    long_rise = np.sin(np.pi / (2 * N) * (n[:N] + 0.5))
    short_rise = np.sin(np.pi / (2 * NS) * (np.arange(NS) + 0.5))
    w = np.zeros((4, 2 * N))
    w[0] = np.sin(np.pi / (2 * N) * (n + 0.5))
    # START: long rise | flat | short fall | zeros
    w[1, :N] = long_rise
    w[1, N:N + SHORT_OFFSET] = 1.0
    w[1, N + SHORT_OFFSET:N + SHORT_OFFSET + NS] = short_rise[::-1]
    # STOP: zeros | short rise | flat | long fall
    w[3, SHORT_OFFSET:SHORT_OFFSET + NS] = short_rise
    w[3, SHORT_OFFSET + NS:N] = 1.0
    w[3, N:] = long_rise[::-1]
    return w.astype(dtype)


def short_band_count(rate):
    return N_GROUPS * (len(SFB_SHORT[rate]))


# per-line PCM quantization noise power in int16-scaled MDCT energy units:
# 10^-2 * ABS_LOW(=16887.8/4) per the reference's PCM_QUANT_NOISE constant
# (psy_configuration.cpp:493-495; the 2^-30 fraction scale cancels against
# our 2^30 energy-domain offset, measured with tools/diag_lc_thr.py)
PCM_FLOOR_PER_LINE = 42.22


def bark(f_hz):
    f = np.maximum(f_hz, 0.0) * 0.001
    return 13.0 * np.arctan(0.76 * f) + 3.5 * np.arctan((f / 7.5) ** 2)


def ath_db(f_hz):
    f = np.where(f_hz < -0.3, 3410.0, f_hz)
    f = np.clip(f / 1000.0, 0.01, 18.0)
    return (3.640 * np.power(f, -0.8)
            - 6.800 * np.exp(-0.6 * (f - 3.4) ** 2)
            + 6.000 * np.exp(-0.15 * (f - 8.7) ** 2)
            + 0.6e-3 * np.power(f, 4.0))


def band_psy_tables(rate, nbands=MAX_SFB_LONG):
    """Per-band bark centres, masking slopes and absolute thresholds (energy
    domain, int16-scaled MDCT units)."""
    off = sfb_offsets(rate)
    nb = len(off) - 1
    centers = 0.5 * (off[:-1] + off[1:]) * rate / (2.0 * N)
    bk = bark(centers)
    dbark = np.diff(bk)
    # spreading slopes: 30 dB/bark toward lower, 15 dB/bark toward higher freqs
    f_low = 10.0 ** (-3.0 * dbark)   # applied walking downward (b+1 -> b)
    f_high = 10.0 ** (-1.5 * dbark)  # applied walking upward (b -> b+1)
    # absolute threshold: full-scale sine (+-32768) ~ 96 dB SPL; a single MDCT
    # line of amplitude a has band energy ~ (N/2) * a^2 -- calibration constant
    # chosen so ath(0 dB) corresponds to ~1 LSB line energy
    ath = 10.0 ** (ath_db(centers) / 10.0) * 480.0
    out = dict(nbands=nb, f_low=np.zeros(nbands), f_high=np.zeros(nbands),
               ath=np.full(nbands, 1e30), pcm_floor=np.full(nbands, 1e30))
    out["f_low"][:nb - 1] = f_low
    out["f_high"][:nb - 1] = f_high
    out["ath"][:nb] = ath
    # PCM quantization noise floor (FDKaacEnc_InitMinPCMResolution,
    # psy_configuration.cpp:491-501): width * 10^-2 * ABS_LOW in int16-scaled
    # energy units (our MDCT energies equal fdk's fractional ones x 2^30,
    # measured via tools/diag_lc_thr.py) - this, not a hearing curve, is the
    # reference's absolute threshold and sits ~20 dB above our old ATH
    out["pcm_floor"][:nb] = PCM_FLOOR_PER_LINE * np.diff(off)
    return out


def short_band_psy_tables(rate, nbands=MAX_SFB_LONG):
    """Short-block analogue of band_psy_tables over the grouped band layout
    (N_GROUPS repeats of the short sfb ladder).  Spreading never crosses a
    group boundary (groups are temporal segments)."""
    off = sfb_short_offsets(rate)
    nsfb = len(off) - 1
    centers = 0.5 * (off[:-1] + off[1:]) * rate / (2.0 * NS)
    bk = bark(centers)
    dbark = np.diff(bk)
    f_low1 = 10.0 ** (-3.0 * dbark)
    f_high1 = 10.0 ** (-1.5 * dbark)
    # short transform: a line of amplitude a has band energy ~ (NS/2) * a^2
    ath1 = 10.0 ** (ath_db(centers) / 10.0) * (NS / 2.0)
    out = dict(nbands=N_GROUPS * nsfb, f_low=np.zeros(nbands),
               f_high=np.zeros(nbands), ath=np.full(nbands, 1e30),
               pcm_floor=np.full(nbands, 1e30))
    # grouped band energies sum 8/N_GROUPS windows of NS-length transforms:
    # white PCM noise lands NS/N of the long path's per-line energy, summed
    # over the group's windows
    floor1 = PCM_FLOOR_PER_LINE * (8 // N_GROUPS) * (NS / N) * np.diff(off)
    for g in range(N_GROUPS):
        b0 = g * nsfb
        out["f_low"][b0:b0 + nsfb - 1] = f_low1
        out["f_high"][b0:b0 + nsfb - 1] = f_high1
        out["ath"][b0:b0 + nsfb] = ath1
        out["pcm_floor"][b0:b0 + nsfb] = floor1
        if g + 1 < N_GROUPS:  # no spreading across the group boundary
            out["f_low"][b0 + nsfb - 1] = 0.0
            out["f_high"][b0 + nsfb - 1] = 0.0
    return out


def fdk_bark(f_hz):
    """fdk's bark approximation (FDKaacEnc_BarcLineValue,
    psy_configuration.cpp): 13.3*atan(0.00076 f) + 3.5*atan(1.333e-4 f)^2."""
    f = np.asarray(f_hz, np.float64)
    return 13.3 * np.arctan(0.00076 * f) + \
        3.5 * np.arctan(4.0 / 3.0e4 * f) ** 2


def min_snr_ladder(ch_bitrate, rate, short=False, nbands=MAX_SFB_LONG):
    """Per-band minimum-SNR ratios (noise may not exceed en*minSnr in coded
    bands), the bitrate-aware avoid-holes floor (FDKaacEnc_initMinSnr,
    psy_configuration.cpp:586-706 / 3GPP TS 26.403).  Returns [nbands]
    ratios in (0, 1]; padded bands get 1.0 (no constraint)."""
    n_lines = NS if short else N
    off = sfb_short_offsets(rate) if short else sfb_offsets(rate)
    nsfb = len(off) - 1
    line_bark = fdk_bark(off * rate / (2.0 * n_lines))
    # pe budget per window, distributed over active barks
    pe_per_window = 1.18 * 0.024 * n_lines * ch_bitrate / rate
    if short:
        pe_per_window *= 1.5
    barc_factor = min(line_bark[nsfb], 24.0) / 25.0
    pe_const = pe_per_window / barc_factor
    out = np.ones(nbands)
    for sfb in range(nsfb):
        barc_w = line_bark[sfb + 1] - line_bark[sfb]
        pe_part = pe_const * barc_w / (off[sfb + 1] - off[sfb])
        snr = max(2.0 ** pe_part / 2.0 - 1.5, 1.0)
        out[sfb] = np.clip(1.0 / snr, 0.003, 0.8)
    if short:  # replicate over the grouped layout
        grouped = np.ones(nbands)
        for g in range(N_GROUPS):
            grouped[g * nsfb:(g + 1) * nsfb] = out[:nsfb]
        return grouped
    return out


def spread_energy_tables(rate, ch_bitrate, short=False, nbands=MAX_SFB_LONG):
    """Spread-ENERGY slope factors (sfbMask*FactorSprEn,
    psy_configuration.cpp initSpreading): long 30 dB/bark down, 20 (15 below
    20 kbps) up; short 20 down, 15 up.  Used for avoid-hole detection, not
    masking."""
    if short:
        lo_db, hi_db = 2.0, 1.5
        off = sfb_short_offsets(rate)
        n_lines = NS
    else:
        lo_db = 3.0
        hi_db = 2.0 if ch_bitrate > 20000 else 1.5
        off = sfb_offsets(rate)
        n_lines = N
    nsfb = len(off) - 1
    centers = 0.5 * (off[:-1] + off[1:]) * rate / (2.0 * n_lines)
    dbark = np.diff(bark(centers))
    f_low1 = 10.0 ** (-lo_db * dbark)
    f_high1 = 10.0 ** (-hi_db * dbark)
    out = dict(f_low=np.zeros(nbands), f_high=np.zeros(nbands))
    if short:
        for g in range(N_GROUPS):
            b0 = g * nsfb
            out["f_low"][b0:b0 + nsfb - 1] = f_low1
            out["f_high"][b0:b0 + nsfb - 1] = f_high1
            if g + 1 < N_GROUPS:
                out["f_low"][b0 + nsfb - 1] = 0.0
                out["f_high"][b0 + nsfb - 1] = 0.0
    else:
        out["f_low"][:nsfb - 1] = f_low1
        out["f_high"][:nsfb - 1] = f_high1
    return out
