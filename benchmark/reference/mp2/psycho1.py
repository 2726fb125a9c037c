"""Batched ISO psychoacoustic model 1, exact path (port of
odr_audioenc_tpu/mp2/psycho1.py; libtoolame-dab/psycho_1.c).

The reference walks mutable linked lists over the 513-bin spectrum.  Here
each walk is a Python loop over bins, batched over [B] = streams x channels,
that visits only the bins where something can happen (candidates, band
ends, list members).  The f64 path reproduces the reference bit for bit up
to FFT reduction order (an rFFT replaces the Mayer FHT; differences are ~1
ulp and only observable through the 0.1 dB add_db quantisation).

Sequence (psycho_1.c:22-87):
  hann window + FFT + power spectrum + per-subband "spike" levels
  tonal labeling (local maxima, run check, neighbor absorption)   :267-340
  noise labeling (per critical band geometric-mean centre)        :350-400
  subsampling (drop below-ATH maskers, 0.5-bark merge)            :409-470
  thresholds per freq line (masking functions + add_db)           :480-532
  minimum mask per subband -> SMR                                 :541-581
"""
from functools import lru_cache

import numpy as np
import torch

from .. import tables as T
from ..device import const

DBMIN = T.DBMIN
NBINS = 512
PAD = 12  # padding for windowed neighbor access
NLINE = 133


def _add_db(a, b, dbtab):
    """Order-sensitive dB-domain addition via the reference's 0.1 dB lookup
    table (psycho_1.c:180-205)."""
    fdiff = 10.0 * (a - b)
    idiff = torch.trunc(fdiff).to(torch.int64)
    tab = dbtab[idiff.abs().clamp(0, 999)]
    out = torch.where(idiff >= 0, a + tab, b + tab)
    out = torch.where(fdiff > 990.0, a, out)
    return torch.where(fdiff < -990.0, b, out)


@lru_cache(maxsize=None)
def _dft_basis():
    """[1024, 1024] rDFT basis (numpy f32): columns 0..511 = cos(2pi k n/N),
    columns 512..1023 = -sin(2pi k n/N) for bins k = 0..511."""
    n = np.arange(1024)[:, None]
    k = np.arange(512)[None, :]
    ang = 2.0 * np.pi * n * k / 1024.0
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def power_spectrum(samples):
    """samples: [B, 1024] already scaled to +-1.  Returns (power_db [B,512],
    energy [B,512], spike [B,32]) in samples' dtype
    (psycho_1_hann_fft_pickmax, :215-258)."""
    dtype, dev = samples.dtype, samples.device
    xr = samples * const(T.PSY1_WINDOW, dev, dtype)
    if dtype == torch.float64:
        spec = torch.fft.rfft(xr)
        energy = (spec.real ** 2 + spec.imag ** 2)[:, :NBINS]
    else:
        # f32 path: the 1024-point rDFT as one [1024, 1024] matmul
        ri = xr @ const(_dft_basis(), dev, dtype)
        energy = ri[:, :NBINS] ** 2 + ri[:, NBINS:] ** 2
    # reference: energy[i] = (a^2+b^2)/2 with a,b the FHT pair; for a real
    # signal that equals |X_k|^2 for 0<i<512, and X_0^2 at 0
    power = torch.where(energy < 1e-20, DBMIN + T.POWERNORM,
                        10.0 * torch.log10(energy.clamp_min(1e-300)) + T.POWERNORM)
    # spike: sequential sum of CF*energy within each 16-bin group, seeded DBM
    e16 = energy.reshape(-1, 32, 16)
    acc = torch.full(e16.shape[:2], T.DBM, dtype=dtype, device=dev)
    for j in range(16):
        acc = acc + T.CF * e16[:, :, j]
    return power, energy, 10.0 * torch.log10(acc)


def tonal_candidates(power):
    """Pass-1 local maxima over bins 2..499 (psycho_1.c:274-284)."""
    cand = torch.zeros_like(power, dtype=torch.bool)
    cand[:, 1:-1] = (power[:, 1:-1] > power[:, :-2]) & (power[:, 1:-1] >= power[:, 2:])
    cand[:, :2] = False
    cand[:, NBINS - PAD:] = False
    return cand


def tonal_label(power, cand, dbtab):
    """Sequential tonal-component walk (psycho_1.c:267-340).

    power: [B, 512] dB spectrum; cand: [B, 512] bool pass-1 local-max flags.
    Returns (power', is_tone [B,512], member [B,512]): `is_tone` is the final
    type==TONE flag and `member` the surviving tone-list membership.  Bins
    that are no candidate in any row change nothing, so only the initial
    candidate bins are visited (a candidate flag can only be cleared), and
    a bin whose flag is already cleared in every row is skipped."""
    B = power.shape[0]
    dev, dtype = power.device, power.dtype
    ar = torch.arange(B, device=dev)
    ppad = torch.full((B, NBINS + 2 * PAD), DBMIN, dtype=dtype, device=dev)
    ppad[:, PAD:PAD + NBINS] = power
    tpad = torch.zeros((B, NBINS + 2 * PAD), dtype=torch.bool, device=dev)
    tpad[:, PAD:PAD + NBINS] = cand
    member = torch.zeros((B, NBINS), dtype=torch.bool, device=dev)
    last = torch.full((B,), -1, dtype=torch.int64, device=dev)
    lbo = last.clone()

    visit = torch.nonzero(cand[:, 2:NBINS - PAD].any(dim=0)).flatten() + 2
    for i in visit.tolist():
        run = int(T.TONAL_RUN[i])
        c = i + PAD                                     # centre in padded coords
        is_cand = tpad[:, c].clone()
        if not bool(is_cand.any()):   # cleared by an earlier accept
            continue
        x = ppad[:, c].clone()
        maxv = x - 7.0
        # violation: any j in 2..run with max < w[+-j]
        if run >= 2:
            side = torch.cat([ppad[:, c - run:c - 1], ppad[:, c + 2:c + run + 1]], dim=1)
            viol = (maxv[:, None] < side).any(dim=1)
        else:
            viol = torch.zeros_like(is_cand)
        accept = is_cand & ~viol
        reject = is_cand & viol
        # boost: x = add_db(x, add_db(x[i-1], x[i+1])), from the window as
        # it stands before this bin's zeroing
        boosted = _add_db(x, _add_db(ppad[:, c - 1], ppad[:, c + 1], dbtab), dbtab)
        if run >= 1:
            # zero neighbors 1..run both sides
            for sl in (slice(c - run, c), slice(c + 1, c + run + 1)):
                ppad[:, sl] = torch.where(accept[:, None], DBMIN, ppad[:, sl])
                tpad[:, sl] = tpad[:, sl] & ~accept[:, None]
        ppad[:, c] = torch.where(accept, boosted, x)
        tpad[:, c] = is_cand & ~reject

        # list surgery: if (i - last) <= run and last_but_one exists, the
        # previous accepted component is dropped from the list
        drop_last = accept & (last >= 0) & ((i - last) <= run) & (lbo >= 0)
        lc = last.clamp_min(0)
        member[ar, lc] = member[ar, lc] & ~drop_last
        member[:, i] = member[:, i] | accept
        lbo = torch.where(accept, last, lbo)
        last = torch.where(accept, i, last)
    return ppad[:, PAD:PAD + NBINS], tpad[:, PAD:PAD + NBINS], member


def _band_plan(cbound, n_cband):
    """Static band walk of noise_label per row (numpy): for each bin b the
    band k it accumulates into after any band switch at b, that band's
    [lo, hi), and whether a band ends at b."""
    B = cbound.shape[0]
    cb_full = np.concatenate([cbound, np.full((B, 1), NBINS + 1, cbound.dtype)], 1)
    lo = np.zeros((NBINS, B), np.int64)
    hi = np.zeros((NBINS, B), np.int64)
    ends = np.zeros((NBINS, B), bool)
    elo = np.zeros((NBINS, B), np.int64)
    ehi = np.zeros((NBINS, B), np.int64)
    inband = np.zeros((NBINS, B), bool)
    for r in range(B):
        k = 0
        for b in range(NBINS):
            if k < n_cband[r] - 1 and b == cb_full[r, k + 1]:
                ends[b, r] = True
                elo[b, r], ehi[b, r] = cb_full[r, k], cb_full[r, k + 1]
                k += 1
            lo[b, r], hi[b, r] = cb_full[r, k], cb_full[r, k + 1]
            inband[b, r] = k < n_cband[r] - 1 and lo[b, r] <= b < hi[b, r]
    return lo, hi, ends, elo, ehi, inband


def noise_label_scan(power, is_tone, energy, cbound, n_cband, dbtab):
    """Single forward scan over bins implementing noise_label.

    When the scan crosses into a new band it finalises the previous band
    (computes the centre, writes sum/type), then processes the current bin
    with the updated arrays - reproducing the reference's in-order
    mutation including centre spill into the next band.
    Returns (power', noise_type, noise_member)."""
    B = power.shape[0]
    dev, dtype = power.device, power.dtype
    ar = torch.arange(B, device=dev)
    lo, hi, ends, elo, ehi, inband = _band_plan(
        cbound.cpu().numpy(), n_cband.cpu().numpy())
    t = {k: torch.as_tensor(v, device=dev)
         for k, v in dict(lo=lo, hi=hi, ends=ends, elo=elo, ehi=ehi, inband=inband).items()}
    power = power.clone()
    member = torch.zeros((B, NBINS), dtype=torch.bool, device=dev)
    sum_db = torch.full((B,), DBMIN, dtype=dtype, device=dev)
    weight = torch.zeros((B,), dtype=dtype, device=dev)
    ten = torch.tensor(10.0, dtype=dtype, device=dev)

    for b in range(NBINS):
        if ends[b].any():
            e, blo, bhi = t["ends"][b], t["elo"][b], t["ehi"][b]
            # close the band: centre, Iwadare fix, write sum/type
            no_comp = sum_db <= DBMIN
            index = weight * torch.pow(ten, -0.1 * sum_db)
            centre_n = blo + (index * (bhi - blo).to(dtype)).to(torch.int64)
            centre = torch.where(no_comp, (bhi + blo) // 2, centre_n).clamp(0, NBINS - 2)
            t_c = is_tone[ar, centre]
            t_c1 = is_tone[ar, (centre + 1).clamp_max(NBINS - 1)]
            centre = torch.where(t_c, torch.where(t_c1, centre + 1, centre - 1), centre)
            centre = centre.clamp(0, NBINS - 1)
            power[ar, centre] = torch.where(e, sum_db, power[ar, centre])
            member[ar, centre] = member[ar, centre] | e
            sum_db = torch.where(e, DBMIN, sum_db)
            weight = torch.where(e, 0.0, weight)
        if not inband[b].any():
            continue
        x_b = power[:, b]
        use = t["inband"][b] & ~is_tone[:, b] & (x_b != DBMIN)
        if not bool(use.any()):
            continue
        blo, bhi = t["lo"][b], t["hi"][b]
        new_sum = _add_db(x_b, sum_db, dbtab)
        new_w = weight + T.CF * energy[:, b] * (b - blo).to(dtype) / (bhi - blo).to(dtype)
        sum_db = torch.where(use, new_sum, sum_db)
        weight = torch.where(use, new_w, weight)
        # reference zeroes consumed lines: power[j].x = DBMIN
        power[:, b] = torch.where(use, DBMIN, x_b)
    return power, member.clone(), member


def subsample(power, member, hear_of_bin):
    """Drop maskers below the absolute hearing threshold
    (psycho_1_subsampling first two loops, :409-442).  Order-independent."""
    drop = member & (power < hear_of_bin)
    return torch.where(drop, DBMIN, power), member & ~drop


def bark_merge(power, member, bark_of_bin):
    """0.5-bark pairwise merge over the tone list (psycho_1.c:443-469):
    keeps the larger of two tonal neighbours closer than 0.5 bark.  Only
    member bins change anything, and membership is only ever cleared, so
    the walk visits the initial members in bin order."""
    B = power.shape[0]
    dev = power.device
    ar = torch.arange(B, device=dev)
    power, member = power.clone(), member.clone()
    anchor = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for b in torch.nonzero(member.any(dim=0)).flatten().tolist():
        m_b = member[:, b].clone()
        x_b = power[:, b].clone()
        a_idx = anchor.clamp_min(0)
        x_a = power[ar, a_idx]
        close = m_b & (anchor >= 0) & ((bark_of_bin[:, b] - bark_of_bin[ar, a_idx]) < 0.5)
        drop_anchor = close & (x_b > x_a)
        drop_b = close & ~drop_anchor
        member[ar, a_idx] = member[ar, a_idx] & ~drop_anchor
        power[ar, a_idx] = torch.where(drop_anchor, DBMIN, x_a)
        member[:, b] = m_b & ~drop_b
        power[:, b] = torch.where(drop_b, DBMIN, x_b)
        # anchor advances to b unless b was dropped
        anchor = torch.where(m_b & ~drop_b, b, anchor)
    return power, member


def threshold(power, tone_member, noise_member, map_of_bin, bark_line, hear_line,
              sub_size, low_rate, dbtab):
    """Global masking threshold per frequency line (psycho_1.c:480-532).

    bark_line/hear_line: [B, NLINE] per-line bark/hear (index 0 is the dummy
    ltg[0]); sub_size: [B]; low_rate: [B] bool (per-channel bitrate < 96).
    Returns ltg_x [B, NLINE].  Each masker pass visits the member bins in
    bin order (non-members change nothing)."""
    B, nline = bark_line.shape
    dev, dtype = power.device, power.dtype
    ar = torch.arange(B, device=dev)
    ks = torch.arange(nline, device=dev)
    kvalid = (ks[None, :] >= 1) & (ks[None, :] < sub_size[:, None])

    def masker_pass(ltg_x, member, c_bark, c_off):
        for t in torch.nonzero(member.any(dim=0)).flatten().tolist():
            x_t = power[:, t]
            bark_t = bark_line[ar, map_of_bin[:, t].long()]
            dz = bark_line - bark_t[:, None]                    # [B, NLINE]
            in_range = (dz >= -3.0) & (dz < 8.0)
            tmps = -1.525 + c_bark * bark_t + c_off + x_t      # [B]
            xt = x_t[:, None]
            vf = torch.where(dz < -1.0, 17.0 * (dz + 1.0) - (0.4 * xt + 6.0),
                 torch.where(dz < 0.0, (0.4 * xt + 6.0) * dz,
                 torch.where(dz < 1.0, -17.0 * dz,
                             -(dz - 1.0) * (17.0 - 0.15 * xt) - 17.0)))
            newv = _add_db(ltg_x, tmps[:, None] + vf, dbtab)
            upd = member[:, t, None] & in_range & kvalid
            ltg_x = torch.where(upd, newv, ltg_x)
        return ltg_x

    ltg_x = torch.full((B, nline), DBMIN, dtype=dtype, device=dev)
    ltg_x = masker_pass(ltg_x, tone_member, -0.275, -4.5)
    ltg_x = masker_pass(ltg_x, noise_member, -0.175, -0.5)
    base = torch.where(low_rate[:, None], hear_line, hear_line - 12.0)
    return torch.where(kvalid, _add_db(base, ltg_x, dbtab), ltg_x)


def minimum_mask(ltg_x, line_sb, hear_line, sub_size, sblimit_max=32):
    """ltmin per subband with the reference's pointer-walk quirks
    (psycho_1.c:541-559).  line_sb: [B, NLINE] = line>>4 per entry."""
    B, nline = ltg_x.shape
    dev = ltg_x.device
    ls = torch.arange(nline, device=dev)[None, :]
    valid_line = (ls >= 1) & (ls < sub_size[:, None])
    sbl = torch.where(valid_line, line_sb.long(), 999)
    sbs = torch.arange(sblimit_max, device=dev)
    # j pointer at the start of subband i: 1 + #lines with sb < i
    j_i = 1 + (sbl[:, :, None] < sbs[None, None, :]).sum(dim=1)   # [B, 32]
    tail = j_i >= (sub_size[:, None] - 1)
    # min of ltg_x over lines with sb == i
    match = sbl[:, :, None] == sbs[None, None, :]                # [B, NLINE, 32]
    min_match = torch.where(match, ltg_x[:, :, None], torch.inf).amin(dim=1)
    x_at_j = torch.gather(ltg_x, 1, j_i.clamp(0, nline - 1))
    hear_last = torch.gather(hear_line, 1, (sub_size.long() - 1)[:, None])
    return torch.where(tail, hear_last,
                       torch.where(match.any(dim=1), min_match, x_at_j))


def smr_from(ltmin, spike, scale_max):
    """SMR per subband (psycho_1_smr, :568-581)."""
    sc = 20.0 * torch.log10(scale_max * 32768.0) - 10.0
    return torch.maximum(sc, spike) - ltmin


def psycho_1(samples, scale_max, psy_tabs, low_rate):
    """Full model-1 SMR computation, exact path.

    samples:   [B, 1024] float in +-1 (the FFT window, see model.py)
    scale_max: [B, 32] `multiple[min sf index]` per subband (find_sf_max)
    psy_tabs:  dict of per-B tables (make_psy1_tables, as tensors)
    low_rate:  [B] bool, per-channel bitrate < 96 kbps
    Returns smr [B, 32]."""
    dbtab = const(T.ADD_DB_TABLE, samples.device, samples.dtype)
    power, energy, spike = power_spectrum(samples)
    cand = tonal_candidates(power)
    power, is_tone, tone_m = tonal_label(power, cand, dbtab)
    power, _, noise_m = noise_label_scan(power, is_tone, energy, psy_tabs["cbound"],
                                         psy_tabs["n_cband"], dbtab)
    hear_of_bin = psy_tabs["hear_of_bin"]
    power, tone_m = subsample(power, tone_m, hear_of_bin)
    power, noise_m = subsample(power, noise_m, hear_of_bin)
    power, tone_m = bark_merge(power, tone_m, psy_tabs["bark_of_bin"])
    ltg_x = threshold(power, tone_m, noise_m, psy_tabs["map"], psy_tabs["bark_line"],
                      psy_tabs["hear_line"], psy_tabs["sub_size"], low_rate, dbtab)
    ltmin = minimum_mask(ltg_x, psy_tabs["line_sb"], psy_tabs["hear_line"],
                         psy_tabs["sub_size"])
    return smr_from(ltmin, spike, scale_max)


def make_psy1_tables(rate_indices, dtype=np.float64):
    """Per-B psy-1 tables (numpy).  rate_indices: [B] int in {0,1,2,4,5,6}
    (MPEG1: sfreq idx; MPEG2: sfreq idx + 4)."""
    B = len(rate_indices)
    out = {
        "map": np.zeros((B, NBINS), np.int32),
        "bark_line": np.zeros((B, NLINE), dtype),
        "hear_line": np.zeros((B, NLINE), dtype),
        "line_sb": np.zeros((B, NLINE), np.int32),
        "sub_size": np.zeros((B,), np.int32),
        "cbound": np.zeros((B, 27), np.int32),
        "n_cband": np.zeros((B,), np.int32),
    }
    out["hear_of_bin"] = np.zeros((B, NBINS), dtype)
    out["bark_of_bin"] = np.zeros((B, NBINS), dtype)
    for b, ri in enumerate(rate_indices):
        ri = int(ri)
        sub_size = int(T.FREQ_ENTRIES[ri]) + 1
        out["sub_size"][b] = sub_size
        out["map"][b] = T.make_map(ri)
        out["bark_line"][b, 1:sub_size] = T.FREQ_BARK[ri][: sub_size - 1]
        out["hear_line"][b, 1:sub_size] = T.FREQ_HEAR[ri][: sub_size - 1]
        out["line_sb"][b, 1:sub_size] = T.FREQ_LINE[ri][: sub_size - 1] >> 4
        nc = int(T.CRIT_BAND_COUNT[ri])
        out["n_cband"][b] = nc
        out["cbound"][b, :nc] = T.CBOUND[ri][:nc]
        out["hear_of_bin"][b] = out["hear_line"][b][out["map"][b]]
        out["bark_of_bin"][b] = out["bark_line"][b][out["map"][b]]
    return out
