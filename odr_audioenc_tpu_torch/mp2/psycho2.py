"""Batched psy model 2 (port of odr_audioenc_tpu/mp2/psycho2.py; AT&T / ISO
model 2, libtoolame-dab/psycho_2.c).

The model is stateful: a 1056-sample ring buffer per channel (psycho_2.c:76-88)
plus two ages of FFT magnitude/phase per channel for the unpredictability
measure's linear prediction (psycho_2.c:110-141).  Two granules of 576
samples are processed per frame and the SMR is the per-subband max of the
two (psycho_2.c:247-250).

There are no sequential list walks: everything is per-line / per-partition
dense math, so one code serves both paths.  ``exact_order=True`` (the f64
path) accumulates the partition, spreading and subband sums in the C loop
order, as the JAX package does; otherwise they are matmuls and reductions.

The reference FHT packing (fft.c:1230-1275) maps to the rFFT as
  energy[k] = |X_k|^2,  phi[k] = atan2(Im X_k, Re X_k),
with phi[0] never written (always 0.0, fft.c:1248) and phi[512] =
atan2(0, H[512]), i.e. pi where Re X_512 < 0.
"""
import numpy as np
import torch

from .. import tables as T

BLKSIZE = 1024
HBLK = 513
CB = 64          # CBANDS (encoder.h:42)
NMT = 5.5        # noise-masking-tone offset (psycho_2.c:21)
LN_TO_LOG10 = 0.2302585093  # common.h:31

_CRIT_BAND = np.array([0, 100, 200, 300, 400, 510, 630, 770,
                       920, 1080, 1270, 1480, 1720, 2000, 2320, 2700,
                       3150, 3700, 4400, 5300, 6400, 7700, 9500, 12000,
                       15500, 25000, 30000], np.float64)
_BMAX = np.array([20.0, 20.0, 20.0, 20.0, 20.0, 17.0, 15.0,
                  10.0, 7.0, 4.4, 4.5, 4.5, 4.5, 4.5,
                  4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5,
                  4.5, 4.5, 4.5, 3.5, 3.5, 3.5], np.float64)


def make_psy2_tables(sfreq):
    """psycho_2_init (psycho_2.c:258-438) in numpy f64."""
    i = int(sfreq + 0.5)
    if i in (32000, 16000):
        sfreq_idx = 0
    elif i in (44100, 22050):
        sfreq_idx = 1
    elif i in (48000, 24000):
        sfreq_idx = 2
    else:
        raise ValueError(f"psy model 2: invalid sample rate {sfreq}")
    absthr = np.asarray(T.ABSTHR[sfreq_idx], np.float64)

    window = 0.5 * (1.0 - np.cos(2.0 * T.PI_REF *
                                 (np.arange(BLKSIZE) - 0.5) / BLKSIZE))

    # line -> bark value, then partitions of <= 0.33 bark
    freq_mult = sfreq / BLKSIZE
    bval = np.zeros(HBLK)
    for k in range(HBLK):
        f = k * freq_mult
        j = 1
        while f > _CRIT_BAND[j]:
            j += 1
        bval[k] = j - 1 + (f - _CRIT_BAND[j - 1]) / (_CRIT_BAND[j] - _CRIT_BAND[j - 1])

    partition = np.zeros(HBLK, np.int32)
    cbval = np.zeros(CB)
    numlines = np.zeros(CB, np.int32)
    cbval[0] = bval[0]
    bval_lo = bval[0]
    cnt = 1
    for k in range(1, HBLK):
        if (bval[k] - bval_lo) > 0.33:
            partition[k] = partition[k - 1] + 1
            cbval[partition[k - 1]] /= cnt
            cbval[partition[k]] = bval[k]
            bval_lo = bval[k]
            numlines[partition[k - 1]] = cnt
            cnt = 1
        else:
            partition[k] = partition[k - 1]
            cbval[partition[k]] += bval[k]
            cnt += 1
    numlines[partition[-1]] = cnt
    cbval[partition[-1]] /= cnt

    # spreading function s[i][j] (psycho_2.c:385-407): row index i is the
    # OUTER loop variable named j in C; replicate the exact index roles
    s = np.zeros((CB, CB))
    for j in range(CB):
        for i in range(CB):
            t1 = (cbval[i] - cbval[j]) * 1.05
            t2 = 8.0 * ((t1 - 0.5) ** 2 - 2.0 * (t1 - 0.5)) \
                if (0.5 <= t1 <= 2.5) else 0.0
            t1b = t1 + 0.474
            t3 = 15.811389 + 7.5 * t1b - 17.5 * np.sqrt(1.0 + t1b * t1b)
            s[i][j] = 0.0 if t3 <= -100 else np.exp((t2 + t3) * LN_TO_LOG10)

    tmn = np.maximum(15.5 + cbval, 24.5)
    rnorm = s.sum(axis=1)  # rnorm[j] = sum_i s[j][i] (psycho_2.c:411-417)
    bmax_k = _BMAX[(cbval + 0.5).astype(np.int32)]

    ncb = int(partition[-1]) + 1
    P = np.zeros((CB, HBLK))
    P[partition, np.arange(HBLK)] = 1.0
    # ordered per-partition line indices (exact f64 accumulation order)
    maxlines = int(numlines.max())
    seg_idx = np.zeros((CB, maxlines), np.int32)
    seg_msk = np.zeros((CB, maxlines), bool)
    for p in range(ncb):
        lines = np.nonzero(partition == p)[0]
        seg_idx[p, :len(lines)] = lines
        seg_msk[p, :len(lines)] = True

    denom_ok = (rnorm > 0) & (numlines > 0)
    nb_scale = np.where(denom_ok, 1.0 / np.where(denom_ok, rnorm * numlines, 1.0), 0.0)
    return {
        "absthr": absthr, "window": window, "partition": partition,
        "P": P, "s": s, "tmn": tmn, "rnorm": rnorm, "bmax_k": bmax_k,
        "numlines": numlines, "ncb": ncb, "nb_scale": nb_scale,
        "seg_idx": seg_idx, "seg_msk": seg_msk,
    }


def init_psy2_state(B, dtype=torch.float64, device="cpu"):
    """savebuf ring + two ages of (r, phi) per channel slot (zero-filled, as
    mem_alloc does, psycho_2.c:199/mem.c:21)."""
    def z(*sh):
        return torch.zeros(sh, dtype=dtype, device=device)
    return {"savebuf": z(B, 1056),
            "r_m1": z(B, HBLK), "r_m2": z(B, HBLK),
            "p_m1": z(B, HBLK), "p_m2": z(B, HBLK)}


def _granule(savebuf, r_m1, r_m2, p_m1, p_m2, tabs, exact_order):
    """One 1024-point analysis of the ring buffer.  tabs: make_psy2_tables /
    make_psy4_tables as tensors in savebuf's dtype (indices int64), with
    `ncb` a Python int.  Returns (smr [B, 32], r, phi)."""
    dtype, dev = savebuf.dtype, savebuf.device
    B = savebuf.shape[0]
    spec = torch.fft.rfft(savebuf[:, :BLKSIZE] * tabs["window"])
    re, im = spec.real, spec.imag
    energy = re * re + im * im
    phi = torch.atan2(im, re)
    # floor + phi conventions (fft.c:1248-1274)
    lines = torch.arange(HBLK, device=dev)
    small = (lines >= 1) & (lines < 512) & (energy < 0.0005)
    energy = torch.where(small, 0.0005, energy)
    phi = torch.where(small, 0.0, phi)
    phi[:, 0] = 0.0
    phi[:, 512] = (re[:, 512] < 0).to(dtype) * np.pi

    # unpredictability (psycho_2.c:110-141)
    r_new = torch.sqrt(energy)
    r_pr = 2.0 * r_m1 - r_m2
    phi_pr = 2.0 * p_m1 - p_m2
    t1 = r_new * torch.cos(phi) - r_pr * torch.cos(phi_pr)
    t2 = r_new * torch.sin(phi) - r_pr * torch.sin(phi_pr)
    t3 = r_new + torch.abs(r_pr)
    nz = t3 != 0
    c = torch.where(nz, torch.sqrt(t1 * t1 + t2 * t2) / torch.where(nz, t3, 1.0), 0.0)

    # partition grouping (psycho_2.c:146-155)
    ec = energy * c
    s = tabs["s"]
    if exact_order:
        seg_idx, seg_msk = tabs["seg_idx"], tabs["seg_msk"].to(dtype)
        ge = torch.zeros((B, CB), dtype=dtype, device=dev)
        gc = torch.zeros_like(ge)
        for t in range(seg_idx.shape[1]):
            ge = ge + energy[:, seg_idx[:, t]] * seg_msk[:, t]
            gc = gc + ec[:, seg_idx[:, t]] * seg_msk[:, t]
        # spreading convolution (psycho_2.c:160-175): ecb[j] = sum_k s[j][k] ge[k]
        ecb = torch.zeros_like(ge)
        cbv = torch.zeros_like(ge)
        for k in range(tabs["ncb"]):
            ecb = ecb + ge[:, k:k + 1] * s[:, k]
            cbv = cbv + gc[:, k:k + 1] * s[:, k]
    else:
        P = tabs["P"]
        ge = energy @ P.T
        gc = ec @ P.T
        ecb = ge @ s.T
        cbv = gc @ s.T
    nz = ecb != 0
    cb = torch.where(nz, cbv / torch.where(nz, ecb, 1.0), 0.0)

    # required SNR per partition (psycho_2.c:180-193)
    cb = cb.clamp(0.05, 0.5)
    tb = -0.434294482 * torch.log(cb) - 0.301029996
    bc = tabs["tmn"] * tb + NMT * (1.0 - tb)
    bc = torch.maximum(bc, tabs["bmax_k"])
    bc = torch.exp(-bc * LN_TO_LOG10)

    # permissible noise energy -> per-line threshold (psycho_2.c:199-222)
    nb = ecb * bc * tabs["nb_scale"]
    fthr = torch.maximum(nb[:, tabs["partition"]], tabs["absthr"])

    # translate to the 32 subbands (psycho_2.c:227-245): both loops cover
    # 17-line windows starting at 16*sb (208 == 16*13); the first 13
    # subbands take the window's min, the rest its sum
    win_f = fthr.unfold(1, 17, 16)                              # [B, 32, 17]
    win_e = energy.unfold(1, 17, 16)
    if exact_order:
        se = torch.zeros_like(win_e[..., 0])
        sf = torch.zeros_like(win_f[..., 0])
        for k in range(17):
            se = se + win_e[..., k]
            sf = sf + win_f[..., k]
    else:
        se, sf = win_e.sum(dim=-1), win_f.sum(dim=-1)
    low = torch.arange(32, device=dev) < 13
    den = torch.where(low, win_f.amin(dim=-1) * 17.0, sf)
    return 4.342944819 * torch.log(se / den), r_new, phi


def psycho_2(frame, state, tabs, exact_order=None):
    """frame: [B, 1152] raw sample-valued floats (psy model 2 windows the
    unscaled shorts, psycho_2.c:81-87); state from init_psy2_state; tabs as
    in _granule.  exact_order defaults to True in float64.
    Returns (smr [B, 32], state')."""
    if exact_order is None:
        exact_order = frame.dtype == torch.float64
    savebuf = state["savebuf"]
    r_m1, r_m2 = state["r_m1"], state["r_m2"]
    p_m1, p_m2 = state["p_m1"], state["p_m2"]
    smrs = []
    for g in range(2):
        savebuf = torch.cat([savebuf[:, 576:], frame[:, g * 576:(g + 1) * 576]], dim=1)
        smr_g, r_new, phi_new = _granule(savebuf, r_m1, r_m2, p_m1, p_m2, tabs,
                                         exact_order)
        r_m2, p_m2 = r_m1, p_m1
        r_m1, p_m1 = r_new, phi_new
        smrs.append(smr_g)
    smr = torch.maximum(smrs[0], smrs[1])
    state = {"savebuf": savebuf, "r_m1": r_m1, "r_m2": r_m2,
             "p_m1": p_m1, "p_m2": p_m2}
    return smr, state
