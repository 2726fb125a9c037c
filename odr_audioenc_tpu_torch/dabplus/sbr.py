"""SBR (HE-AAC) and parametric stereo (HE-AAC v2) side analysis, payload
size and writer (port of odr_audioenc_tpu/dabplus/sbr.py).

The 64-band complex QMF analysis is one [.., T, 640] x [640, 128] product
over a strided view of the carried history and the new samples; the
estimators (envelopes, transient grid, tonality quotas, noise floors,
inverse filtering, missing harmonics), the stereo coupling choice, the PS
IID/ICC parameters and the exact payload sizes are elementwise torch ops
over the resulting subband matrix.  The header and band tables are host
numpy, derived as the decoder derives them (sbrdec_freq_sca.cpp); the
writer is host Python over the port's BitWriter.

Integer counts are integer gathers from the Huffman length tables; the
one-hot selections of the reference become gathers (exact on every
device).  Constants the JAX package rounds to float32 before casting to
the working dtype (the QMF matrix, the band-mean weights, the IID and ICC
grids) are rounded the same way here, and log2/exp2/log10 go through
log/exp as JAX lowers them (encode._log2, _exp2, _log10).
"""
import numpy as np
import torch

from .. import obs
from ..device import const
from ..host.bitwriter import BitWriter
from . import tables as AT
from .encode import _exp2, _log10, _log2

_npz = AT._npz
ENV_CODE_F = _npz["sbr_v_Huff_envelopeLevelC10F"]  # LAV 60 (amp res 1.5)
ENV_LEN_F = _npz["sbr_v_Huff_envelopeLevelL10F"]
ENV_CODE_T = _npz["sbr_v_Huff_envelopeLevelC10T"]
ENV_LEN_T = _npz["sbr_v_Huff_envelopeLevelL10T"]
ENV3_CODE_F = _npz["sbr_v_Huff_envelopeLevelC11F"]  # LAV 31 (amp res 3.0)
ENV3_LEN_F = _npz["sbr_v_Huff_envelopeLevelL11F"]
NOISE_CODE_T = _npz["sbr_v_Huff_NoiseLevelC11T"]   # LAV 31
NOISE_LEN_T = _npz["sbr_v_Huff_NoiseLevelL11T"]
NOISE_CODE_F = _npz["sbr_v_Huff_envelopeLevelC11F"]
NOISE_LEN_F = _npz["sbr_v_Huff_envelopeLevelL11F"]
START_BAND = {16000: _npz["sbr_start_band_16"], 22050: _npz["sbr_start_band_22"],
              24000: _npz["sbr_start_band_24"], 32000: _npz["sbr_start_band_32"],
              44100: _npz["sbr_start_band_44"], 48000: _npz["sbr_start_band_48"]}
QMF_PROTO = _npz["sbr_qmf_proto640"]               # ISO Table 4.A.87 window

EXT_SBR_DATA = 13

# Header fields the reference encoder transmits per operating point,
# observed on the wire (fs_out, sbr channels) -> [(min_bitrate,
# (bs_start_freq, bs_stop_freq, bs_freq_scale, bs_noise_bands)), ...];
# the highest matching row wins.  PS uses the mono row (mono SBR core).
_HEADER_MAP = {
    (48000, 1): [(0, (7, 8, 2, 2)), (28000, (10, 9, 2, 2)),
                 (44000, (13, 11, 1, 2))],
    (48000, 2): [(0, (10, 9, 2, 2)), (56000, (14, 12, 1, 3))],
    (32000, 1): [(0, (12, 13, 2, 2)), (44000, (14, 13, 1, 2))],
    (32000, 2): [(0, (12, 13, 2, 2)), (56000, (14, 13, 1, 3))],
    (24000, 1): [(0, (7, 8, 2, 2)), (28000, (10, 9, 2, 2))],
    (24000, 2): [(0, (10, 9, 2, 2))],
    (16000, 1): [(0, (7, 8, 2, 2))],
    (16000, 2): [(0, (7, 8, 2, 2))],
}


def _number_of_bands(bpo, start, stop, warp):
    """sbrdec_freq_sca.cpp numberOfBands (float form + the 1/128 round-to-
    even bias)."""
    n = np.log2(stop / start) / 8.0 * (bpo / 16.0)
    if warp:
        n *= 25200.0 / 32768.0
    return 2 * int(np.floor((n + 1.0 / 128.0) * 64.0))


def _calc_bands(start, stop, num):
    """sbrdec_freq_sca.cpp CalcBands: geometric band widths, built top-down
    with Q8 rounding."""
    bf = (start / stop) ** (1.0 / num)
    diff = np.zeros(num, int)
    previous = stop
    exact = float(stop)
    for i in range(num - 1, -1, -1):
        exact *= bf
        current = int(np.floor(exact + 0.5))
        diff[i] = previous - current
        previous = current
    return diff


def _modify_bands(max_band_previous, diff):
    change = max_band_previous - diff[0]
    if change > (diff[-1] - diff[0]) // 2:
        change = (diff[-1] - diff[0]) // 2
    diff[0] += change
    diff[-1] -= change
    return np.sort(diff)


def _stop_band(fs, stop_freq, k0):
    """sbrdec_freq_sca.cpp getStopBand (dual rate)."""
    if stop_freq < 14:
        if fs < 32000:
            stop_min = ((2 * 6000 * 128 // fs) + 1) >> 1
        elif fs < 64000:
            stop_min = ((2 * 8000 * 128 // fs) + 1) >> 1
        else:
            stop_min = ((2 * 10000 * 128 // fs) + 1) >> 1
        stop_min = min(stop_min, 64)
        diff = np.sort(_calc_bands(stop_min, 64, 13))
        borders = np.concatenate([[stop_min], stop_min + np.cumsum(diff)])
        k2 = int(borders[stop_freq])
    elif stop_freq == 14:
        k2 = 2 * k0
    else:
        k2 = 3 * k0
    return min(k2, 64)


def _master_table(k0, k2, freq_scale, alter_scale):
    """sbrdecUpdateFreqScale: log-scale (freq_scale 1..3) or linear (0)."""
    if freq_scale > 0:
        bpo = {1: 12.0, 2: 10.0, 3: 8.0}[freq_scale]
        if 1000 * k2 > 2245 * k0:       # two regions
            k1 = 2 * k0
            nb0 = _number_of_bands(bpo, k0, k1, False)
            nb1 = _number_of_bands(bpo, k1, k2, alter_scale)
            d0 = np.sort(_calc_bands(k0, k1, nb0))
            d1 = np.sort(_calc_bands(k1, k2, nb1))
            if d0[-1] > d1[0]:
                d1 = _modify_bands(d0[-1], d1)
            master = np.concatenate([[k0], k0 + np.cumsum(d0),
                                     k1 + np.cumsum(d1)])
        else:
            nb0 = _number_of_bands(bpo, k0, k2, False)
            d0 = np.sort(_calc_bands(k0, k2, nb0))
            master = np.concatenate([[k0], k0 + np.cumsum(d0)])
    else:
        dk = 2 if alter_scale else 1
        nb = (((k2 - k0) >> 1) + 1) & 254 if alter_scale else (k2 - k0) & 254
        diff = np.full(nb, dk, int)
        k2_diff = k2 - (k0 + nb * dk)
        i, incr = (0, 1) if k2_diff < 0 else (nb - 1, -1)
        while k2_diff != 0:
            diff[i] -= incr
            i += incr
            k2_diff += incr
        master = np.concatenate([[k0], k0 + np.cumsum(diff)])
    return master.astype(int)


def _down_sample_lo_res(ref_table, num_result):
    """sbrdecDownSampleLoRes: pick num_result borders from ref_table."""
    org = len(ref_table) - 1
    idx = [0]
    result = num_result
    while org > 0:
        step = org // result
        org -= step
        result -= 1
        idx.append(idx[-1] + step)
    return np.asarray([ref_table[i] for i in idx], int)


def _patch_source_map(k0, k2, fs):
    """Decoder LPP transposer patch structure (lpp_tran.cpp
    resetLppTransposer): maps each HF QMF channel in [k0, k2) to the low
    band channel the patch copies from."""
    goal_sb = int(round(2.048e6 / fs))           # ~ 21.3 kHz in QMF bands
    src = np.arange(64)
    usb = k2
    x_over = k0
    if goal_sb < x_over:
        goal_sb = x_over
    lsb = x_over
    patches = []
    # ISO 4.6.18.6.3 patch construction
    msb = lsb
    while msb < usb:
        num_bands = min(usb - msb, max(goal_sb - msb, 0))
        if num_bands <= 0:
            num_bands = usb - msb
        start_src = lsb - num_bands
        if start_src < 1:
            num_bands = lsb - 1
            start_src = 1
        patches.append((msb, start_src, num_bands))
        msb += num_bands
    for tgt, s0, n in patches:
        for j in range(n):
            if tgt + j < 64:
                src[tgt + j] = s0 + j
    return src


class SbrParams:
    """Header choices + derived band tables, mirroring the decoder's
    sbrdecUpdateFreqScale (sbrdec_freq_sca.cpp:300-560) so encoder band
    grouping and decoder parsing agree exactly."""

    def __init__(self, fs_out, bitrate=48000, channels=1):
        self.fs_out = fs_out
        rows = _HEADER_MAP[(fs_out, channels)]
        sel = rows[0][1]
        for thr, fields in rows:
            if bitrate >= thr:
                sel = fields
        self.bs_start_freq, self.bs_stop_freq, self.bs_freq_scale, \
            self.bs_noise_bands = sel
        self.bs_xover_band = 0
        self.bs_alter_scale = 1
        self.amp_res = 3.0                        # header bs_amp_res = 1
        k0 = int(START_BAND[fs_out][self.bs_start_freq])
        k2 = _stop_band(fs_out, self.bs_stop_freq, k0)
        self.k0, self.k2 = k0, k2
        self.master = _master_table(k0, k2, self.bs_freq_scale,
                                    self.bs_alter_scale)
        hi = self.master[self.bs_xover_band:]
        self.f_hi = hi
        n_hi = len(hi) - 1
        # lo-res table (sbrdecUpdateLoRes)
        if n_hi % 2 == 0:
            lo = hi[::2]
        else:
            lo = np.concatenate([[hi[0]], hi[1::2]])
        self.f_lo = lo
        self.n_hi, self.n_lo = n_hi, len(lo) - 1
        # noise bands: Nq = round(bands/octave * octaves), >= 1
        nq = max(1, int(round(self.bs_noise_bands * np.log2(k2 / k0))))
        self.n_q = min(nq, 5)
        self.noise_table = _down_sample_lo_res(self.f_lo, self.n_q)
        self.patch_src = _patch_source_map(k0, k2, fs_out)
        self.band_hz = fs_out / 128.0


# ---- QMF analysis (ISO/IEC 14496-3 4.6.18.4 as one dense matmul) ----
#
# Per slot t the bank consumes 64 new samples; with the 640-tap window c
# the whole slot is linear in the last 640 samples, so folding the window,
# the fold and the modulation into A[640, 128] makes the slot a
# [640] x [640, 128] product, and T slots one matmul.  The numpy matrix is
# cached; tensors are made from it by the caller (the encoder registers it
# as a buffer).
_QMF_MAT = None


def _qmf_matrix():
    """Exact composition of the fdk analysis flow as one [640, 128] float32
    matrix (all stages are linear in the 640-sample state buffer, forward
    time order with the newest sample at index 639):

      1. polyphase FIR fold   u[127-k] = sum_p proto[k+128p]*x[k+128p]
      2. +- fold to 64        r[0]=u[1]+u[0], i[0]=u[1]-u[0],
                              r[n]=u[n+1]-u[128-n], i[n]=u[n+1]+u[128-n]
      3. DCT-IV / DST-IV      Wr = DCT4(r), Wi = DST4(i)

    then scaled so a unit-variance white input yields unit mean subband
    energy."""
    global _QMF_MAT
    if _QMF_MAT is None:
        c = np.asarray(QMF_PROTO, np.float64)
        M1 = np.zeros((640, 128))
        for k in range(128):
            for p in range(5):
                M1[k + 128 * p, 127 - k] = c[k + 128 * p]
        M2 = np.zeros((128, 128))
        M2[1, 0] += 1.0
        M2[0, 0] += 1.0          # r[0] = u[1] + u[0]
        M2[1, 64] += 1.0
        M2[0, 64] -= 1.0         # i[0] = u[1] - u[0]
        for n in range(1, 64):
            M2[n + 1, n] += 1.0
            M2[128 - n, n] -= 1.0         # r[n] = u[n+1] - u[128-n]
            M2[n + 1, 64 + n] += 1.0
            M2[128 - n, 64 + n] += 1.0    # i[n] = u[n+1] + u[128-n]
        n = np.arange(64)
        k = np.arange(64)
        D = np.pi / 64.0 * (n[:, None] + 0.5) * (k[None, :] + 0.5)
        M3 = np.zeros((128, 128))
        M3[:64, :64] = np.cos(D)
        M3[64:, 64:] = np.sin(D)
        A = M1 @ M2 @ M3
        # white-noise energy normalisation: E[|W(k)|^2] = sum_j Ar^2 + Ai^2
        g2 = (A[:, :64] ** 2 + A[:, 64:] ** 2).sum(0).mean()
        _QMF_MAT = (A / np.sqrt(g2)).astype(np.float32)
    return _QMF_MAT


def qmf_analysis(x, hist, A=None):
    """x: [..., n] full-rate samples (n a multiple of 64); hist: [..., 576];
    A: the [640, 128] analysis matrix in x's dtype (made from _qmf_matrix
    when None).  Returns (Wr, Wi [..., T, 64], new_hist [..., 576])."""
    if A is None:
        A = const(_qmf_matrix(), x.device, x.dtype)
    xx = torch.cat([hist, x], -1)
    W = xx.unfold(-1, 640, 64) @ A                # [..., T, 128]: slot t = xx[64t:64t+640]
    return W[..., :64], W[..., 64:], xx[..., -576:]


def _band_mean_mat(borders, n=64):
    """[64, NB] float32 matrix averaging QMF subbands into bands."""
    nb = len(borders) - 1
    m = np.zeros((n, nb), np.float32)
    for b in range(nb):
        lo, hi = int(borders[b]), int(borders[b + 1])
        m[lo:hi, b] = 1.0 / max(hi - lo, 1)
    return m


def _band_sum_max(borders):
    """[64, NB] float32 0/1 matrix summing the subbands of each band (the
    missing-harmonics tonality, where one dominant subband must not be
    averaged away)."""
    nb = len(borders) - 1
    m = np.zeros((64, nb), np.float32)
    for b in range(nb):
        lo, hi = int(borders[b]), int(borders[b + 1])
        m[lo:hi, b] = 1.0
    return m


def side_tables(params, dtype, device):
    """The tensors sbr_side_analysis reads, made from `params` on `device`:
    the QMF matrix, the hi-res and noise band-mean matrices, the band-sum
    matrix, the SBR-range mask (float, in `dtype`) and the patch source map
    (int64).  The encoder registers them as buffers."""
    def f(a):
        return torch.as_tensor(a, device=device).to(dtype)
    sbr_mask = (np.arange(64) >= params.k0) & (np.arange(64) < params.k2)
    return {"qmf": f(_qmf_matrix()), "bh": f(_band_mean_mat(params.f_hi)),
            "bn": f(_band_mean_mat(params.noise_table)),
            "bmax": f(_band_sum_max(params.f_hi)), "sbr_mask": f(sbr_mask),
            "patch_src": torch.as_tensor(params.patch_src.astype(np.int64), device=device)}


def tonality_quotas(Wr, Wi):
    """Per-subband tonality-to-noise quota from 2nd-order complex LPC
    across time slots (ton_corr.cpp:133-300 covariance method, float
    semantics): q = E_pred / (E_tot - E_pred)."""
    def corr(ar, ai, br, bi):
        # sum_t a_t * conj(b_t) over the slot axis
        return (ar * br + ai * bi).sum(-2), (ai * br - ar * bi).sum(-2)

    x0r, x0i = Wr[..., 2:, :], Wi[..., 2:, :]
    x1r, x1i = Wr[..., 1:-1, :], Wi[..., 1:-1, :]
    x2r, x2i = Wr[..., :-2, :], Wi[..., :-2, :]
    r00 = (x0r * x0r + x0i * x0i).sum(-2)
    r11 = (x1r * x1r + x1i * x1i).sum(-2)
    r22 = (x2r * x2r + x2i * x2i).sum(-2)
    r01r, r01i = corr(x0r, x0i, x1r, x1i)
    r02r, r02i = corr(x0r, x0i, x2r, x2i)
    r12r, r12i = corr(x1r, x1i, x2r, x2i)
    tiny = 1e-20
    # every correlation normalised by r00: scale-invariant and safe in f32
    s = 1.0 / r00.clamp(min=tiny)
    r11n, r22n = r11 * s, r22 * s
    r01r, r01i = r01r * s, r01i * s
    r02r, r02i = r02r * s, r02i * s
    r12r, r12i = r12r * s, r12i * s
    det = r11n * r22n - (r12r * r12r + r12i * r12i)
    # AR(2) solve of [[r11, r12], [conj(r12), r22]] a = [r01, r02]
    safe_det = torch.where(det > tiny, det, torch.ones_like(det))
    a1r = (r01r * r22n - (r02r * r12r - r02i * r12i)) / safe_det
    a1i = (r01i * r22n - (r02i * r12r + r02r * r12i)) / safe_det
    a2r = (r02r * r11n - (r01r * r12r + r01i * r12i)) / safe_det
    a2i = (r02i * r11n - (r01i * r12r - r01r * r12i)) / safe_det
    e2 = a1r * r01r + a1i * r01i + a2r * r02r + a2i * r02i
    # AR(1) fallback where the 2x2 system is near singular (pure tones) or
    # the AR(2) fit is implausible
    e1 = ((r01r * r01r + r01i * r01i) / r11n.clamp(min=tiny)).clamp(0.0, 1.0)
    valid = (det > 1e-5 * r11n * r22n) & (e2 >= 0.0) & (e2 <= 1.0)
    e_pred = torch.where(valid, e2, e1)
    return e_pred / (1.0 - e_pred).clamp(min=1e-3)


# Envelope semantics (the fdk decoder's requantizeEnvelopeData,
# env_dec.cpp:585-650): v = 2*log2(E) at 1.5 dB resolution (v = log2(E) at
# 3.0 dB), E the MEAN energy of one QMF subband sample in the band, PCM in
# int16 units.
ENV_BIAS = 0.5  # log2 units; decoder-loopback calibrated
# slot-to-slot energy contrast that switches an AU to a 2-envelope grid
TRANSIENT_RATIO = 6.0
# Variable-grid menu for transient AUs: (border_ts, frame_class, R), the
# mid border at `ts` time slots of 2 QMF slots (numberTimeSlots=15);
# VARFIX (class 2): borders [aL, aL + 2R+2, 15]; FIXVAR (class 1):
# borders [0, 15 - (2R+2), 15] (env_extr.cpp:1460-1543).
GRID_MENU = [
    (2, 2, 0),
    (4, 2, 1),
    (6, 2, 2),
    (7, 1, 3),
    (8, 2, 3),
    (9, 1, 2),
    (11, 1, 1),
    (13, 1, 0),
]
_MENU2 = np.asarray([2 * m[0] for m in GRID_MENU], np.int64)   # borders in QMF slots


def quantize_envelope(energies, amp15=True):
    lg = _log2(energies.clamp(min=1e-9)) + ENV_BIAS
    if amp15:
        return torch.round(2.0 * lg).clamp(0, 127).to(torch.int32)
    return torch.round(lg).clamp(0, 63).to(torch.int32)


def sbr_side_analysis(x, hist, params, nau, tabs=None):
    """SBR side data of one superframe.

    x: [S, ch, nau*1920] full-rate (delayed) signal; hist: [S, ch, 576];
    tabs: side_tables(params, ...) (made when None).  Returns (side dict,
    new hist); the side leaves are [S, nau, ch, ...]:
      sbr_env   [.., n_hi]     1-envelope values (1.5 dB units)
      sbr_env2  [.., 2, n_hi]  2-envelope values (3.0 dB units)
      sbr_transient [..]       bool, selects the 2-envelope variable grid
      sbr_noise_q [.., n_q]    5-bit noise floors
      sbr_invf  [.., n_q]      bs_invf_mode 0..3
      sbr_addharm [.., n_hi]   missing-harmonic flags
      sbr_tgrid [..]           GRID_MENU index of the border
    """
    if tabs is None:
        tabs = side_tables(params, x.dtype, x.device)
    S, ch, n = x.shape
    with obs.span("dabplus.sbr.qmf"):
        Wr, Wi, hist = qmf_analysis(x, hist, tabs["qmf"])
    with obs.span("dabplus.sbr.env"):
        ts = n // 64 // nau                            # 30 QMF slots per AU
        Wr = Wr.reshape(S, ch, nau, ts, 64)
        Wi = Wi.reshape(S, ch, nau, ts, 64)
        E = Wr * Wr + Wi * Wi                          # [S, ch, nau, ts, 64]

        Eb = E @ tabs["bh"]                            # [S, ch, nau, ts, n_hi]
        env = quantize_envelope(Eb.mean(-2), amp15=True)

        # transient detection + border placement (tran_det.cpp + fram_gen.cpp
        # roles): the largest slot-to-slot level change of the SBR-range energy;
        # a large one switches the AU to a 2-envelope grid with the border at
        # the nearest menu position, after a rising edge and before a falling one
        es = (E * tabs["sbr_mask"]).sum(-1)            # [S, ch, nau, ts]
        les = _log2(es + 1.0)
        dlt = les[..., 1:] - les[..., :-1]
        d = dlt.abs()
        t0 = d.argmax(-1) + 1                          # first index of the max
        transient = d.amax(-1) > float(np.log2(TRANSIENT_RATIO))
        rising = dlt.gather(-1, (t0 - 1)[..., None])[..., 0] > 0
        t0b = torch.where(rising, t0 + 2, t0 - 2)
        menu2 = const(_MENU2, x.device)
        # |t0b/2 - ts_m| scaled by 2 (exact in integers; ties to the first entry)
        gi = (t0b[..., None] - menu2).abs().argmin(-1)  # [S, ch, nau]
        B = menu2[gi]                                  # border in QMF slots
        # segment stats via prefix sums selected at the border (a gather where
        # the reference sums a one-hot product; both exact); the quieter
        # segment uses the geometric mean
        lEb = _log2(Eb + 1e-6)
        zrow = torch.zeros_like(Eb[..., :1, :])
        cum = torch.cat([zrow, Eb.cumsum(-2)], -2)     # [.., ts+1, n_hi]
        cuml = torch.cat([zrow, lEb.cumsum(-2)], -2)
        at_b = B[..., None, None].expand(*B.shape, 1, cum.shape[-1])
        cum_b = cum.gather(-2, at_b)[..., 0, :]
        cuml_b = cuml.gather(-2, at_b)[..., 0, :]
        bf = B.to(x.dtype)[..., None]
        na, nb = bf.clamp(min=1.0), (ts - bf).clamp(min=1.0)
        aa = cum_b / na
        ab = (cum[..., -1, :] - cum_b) / nb
        ga = _exp2(cuml_b / na)
        gb = _exp2((cuml[..., -1, :] - cuml_b) / nb)
        a_quiet = aa.sum(-1, keepdim=True) < ab.sum(-1, keepdim=True)
        env2 = torch.stack([quantize_envelope(torch.where(a_quiet, ga, aa), amp15=False),
                            quantize_envelope(torch.where(a_quiet, ab, gb), amp15=False)], -2)

        # tonality quotas per subband (2nd-order LPC over the AU's slots)
        q = tonality_quotas(Wr, Wi)                    # [S, ch, nau, 64]
        q_src = q.index_select(-1, tabs["patch_src"])  # patch-source quotas

        # noise floors per noise band (nf_est.cpp float semantics):
        #   NSR = max(1, mean(q_src)/mean(q_orig)) / mean(q_orig), Q = 6 - log2(NSR)
        bn = tabs["bn"]
        qo = q @ bn
        qs = q_src @ bn
        qo_c = qo.clamp(min=1e-3)
        nsr = ((1.0 * qs) / qo_c).clamp(min=1.0) / qo_c
        nsr = nsr.clamp(2.0 ** -24, 2.0)               # ana_max_level ladder cap
        noise_q = torch.round(6.0 - _log2(nsr)).clamp(0, 30).to(torch.int32)
        # silent-passage fix (nf_est.cpp:266-272): no noise on inaudible bands
        en_nq = E.mean(-2) @ bn
        noise_q = torch.where(en_nq < 100.0, 30, noise_q).to(torch.int32)

        # inverse filtering per noise band (invf_est.cpp ladder)
        rho = (qs + 1.0) / (qo + 1.0)
        invf = torch.where(rho > 10.0, 3, torch.where(rho > 3.0, 2,
                           torch.where(rho > 0.8, 1, 0))).to(torch.int32)

        # missing harmonics per hi band (mh_det.cpp role)
        qh = q @ tabs["bmax"]
        qhs = q_src @ tabs["bmax"]
        add_harm = (qh > 30.0) & (qh > 10.0 * qhs)

        def mv(a):
            return a.movedim(1, 2)                     # [S, ch, nau, ..] -> [S, nau, ch, ..]
        side = {"sbr_env": mv(env), "sbr_env2": mv(env2), "sbr_transient": mv(transient),
                "sbr_noise_q": mv(noise_q), "sbr_invf": mv(invf), "sbr_addharm": mv(add_harm),
                "sbr_tgrid": mv(gi.to(torch.int32))}
    return side, hist


ENVBAL_CODE_F = _npz["sbr_bookSbrEnvBalanceC10F"]   # LAV 24 (amp res 1.5)
ENVBAL_LEN_F = _npz["sbr_bookSbrEnvBalanceL10F"]
ENVBAL3_CODE_F = _npz["sbr_bookSbrEnvBalanceC11F"]  # LAV 12 (amp res 3.0)
ENVBAL3_LEN_F = _npz["sbr_bookSbrEnvBalanceL11F"]
# noise balance FREQ deltas use the envelope-balance-3.0 book (decoder
# env_extr.cpp:880: hcb_noiseF = EnvBalance11F)
NOISEBAL_CODE_F = ENVBAL3_CODE_F
NOISEBAL_LEN_F = ENVBAL3_LEN_F

# encoder pan quantization tables (FDKsbrEnc mapPanorama,
# env_est.cpp:119-121): nearest entry, offset = last entry; wire values are
# the halved domain (the decoder applies <<1)
_PAN15 = np.asarray([0, 2, 4, 6, 8, 12, 16, 20, 24])  # amp res 1.5, offset 24
_PAN30 = np.asarray([0, 2, 4, 8, 12])                  # amp res 3.0, offset 12

# Header bits per AU (AU 0, later AUs) as the reference's payload_bits
# counts them, and as write_sbr_payload writes them: bs_header_flag, the 21
# header bits and bs_data_extra on AU 0; the flag and bs_data_extra later.
# The count is 6 bits over on AU 0 and 1 bit under on the others, so the
# written FIL element can be a byte shorter or longer than the count (two
# where its length crosses the escape at 15 bytes).  The
# port keeps the reference's count: the core budget, and so the bitstream,
# stay the JAX encoder's.
HDR_BITS = (29, 1)
HDR_BITS_WRITTEN = (23, 2)



def _pan_tx(diff, table, offset):
    """Quantize a level-index difference L-R to the nearest pan-table entry
    (the first on ties) and return the WIRE value (halved domain):
    (offset + sign*pan) // 2.  diff: [...] int."""
    tab = const(table, diff.device)
    idx = (diff.abs()[..., None] - tab).abs().argmin(-1)
    pan = tab[idx] * diff.sign()
    return ((offset + pan) // 2).to(torch.int32)


def _delta_bits(v, lens, lav):
    """Huffman bits of v's FREQ deltas (clamped to +-lav) over the last axis."""
    d = (v[..., 1:] - v[..., :-1]).clamp(-lav, lav) + lav
    return lens[d].sum(-1)


def apply_coupling(side, params):
    """Stereo SBR channel coupling (FDKsbrEnc SBR_SWITCH_LRC analogue,
    env_est.cpp:1376-1770): channel 0 carries the per-band average of the
    two channels' quantized envelope levels, channel 1 the pan/balance
    indices; noise floors couple in the linear domain (coupleNoiseFloor).
    Both codings are exactly bit-counted and the cheaper one is chosen per
    AU; coupling needs a common time grid, so it is only tried where the
    channels' framing agrees.  Returns the side dict with the channel-1
    slots rewritten (balance wire values) where coupled, and sbr_cpl
    [S, nau] bool."""
    env = side["sbr_env"]            # [S, nau, 2, n_hi] (1.5 dB indices)
    env2 = side["sbr_env2"]          # [S, nau, 2, 2, n_hi] (3.0 dB indices)
    tr = side["sbr_transient"]       # [S, nau, 2] bool
    nq = side["sbr_noise_q"]         # [S, nau, 2, n_q] ints 0..30
    tg = side["sbr_tgrid"]           # [S, nau, 2]
    n_q = params.n_q
    dev = env.device

    grids_ok = (tr[..., 0] == tr[..., 1]) & (~tr[..., 0] | (tg[..., 0] == tg[..., 1]))

    env_cl = (env[..., 0, :] + env[..., 1, :] + 1) >> 1
    env_bal = _pan_tx(env[..., 0, :] - env[..., 1, :], _PAN15, 24)
    env2_cl = (env2[..., 0, :, :] + env2[..., 1, :, :] + 1) >> 1
    env2_bal = _pan_tx(env2[..., 0, :, :] - env2[..., 1, :, :], _PAN30, 12)
    # noise couples in the linear domain (q = 30 - log2(nf)), in float32 as
    # the reference computes it whatever the working dtype
    qmin = torch.minimum(nq[..., 0, :], nq[..., 1, :]).to(torch.float32)
    dq = (nq[..., 0, :] - nq[..., 1, :]).abs().to(torch.float32)
    nq_cl = torch.round(qmin + 1.0 - _log2(1.0 + _exp2(-dq))).clamp(0, 30).to(torch.int32)
    nq_bal = _pan_tx(nq[..., 1, :] - nq[..., 0, :], _PAN30, 12)

    lenf, len3, lenn = const(ENV_LEN_F, dev), const(ENV3_LEN_F, dev), const(NOISE_LEN_F, dev)
    lbal, lbal3 = const(ENVBAL_LEN_F, dev), const(ENVBAL3_LEN_F, dev)
    lnbal = const(NOISEBAL_LEN_F, dev)
    db_ = _delta_bits

    tr0 = tr[..., 0]
    # LR: grids both + dtdf both + invf both + env both + noise both
    env1_lr = 7 + db_(env[..., 0, :], lenf, 60) + 7 + db_(env[..., 1, :], lenf, 60)
    env2_lr = sum(6 + db_(env2[..., c, e, :], len3, 31) for c in (0, 1) for e in (0, 1))
    noise_lr1 = 5 + db_(nq[..., 0, :], lenn, 31) + 5 + db_(nq[..., 1, :], lenn, 31)
    bits_lr = torch.where(tr0, env2_lr + 2 * noise_lr1 + 24 + 8,
                          env1_lr + noise_lr1 + 10 + 4) + 4 * n_q
    # coupled: grid ch0 only + dtdf both + invf once + env/noise pairs
    env1_cp = 7 + db_(env_cl, lenf, 60) + 6 + db_(env_bal, lbal, 24)
    env2_cp = sum(6 + db_(env2_cl[..., e, :], len3, 31)
                  + 5 + db_(env2_bal[..., e, :], lbal3, 12) for e in (0, 1))
    noise_cp1 = 5 + db_(nq_cl, lenn, 31) + 5 + db_(nq_bal, lnbal, 12)
    bits_cp = torch.where(tr0, env2_cp + 2 * noise_cp1 + 12 + 8,
                          env1_cp + noise_cp1 + 5 + 4) + 2 * n_q

    cpl = grids_ok & (bits_cp < bits_lr)
    c2 = cpl[..., None]
    c3 = cpl[..., None, None]
    side = dict(side)
    side["sbr_env"] = torch.stack([torch.where(c2, env_cl, env[..., 0, :]),
                                   torch.where(c2, env_bal, env[..., 1, :])], -2)
    side["sbr_env2"] = torch.stack([torch.where(c3, env2_cl, env2[..., 0, :, :]),
                                    torch.where(c3, env2_bal, env2[..., 1, :, :])], -3)
    side["sbr_noise_q"] = torch.stack([torch.where(c2, nq_cl, nq[..., 0, :]),
                                       torch.where(c2, nq_bal, nq[..., 1, :])], -2)
    # coupled AUs share ch0's framing on the wire
    side["sbr_transient"] = torch.stack([tr0, torch.where(cpl, tr0, tr[..., 1])], -1)
    side["sbr_tgrid"] = torch.stack([tg[..., 0], torch.where(cpl, tg[..., 0], tg[..., 1])], -1)
    side["sbr_cpl"] = cpl
    return side


def payload_bits(side, params, nau, ps_bits=None, hdr_bits=HDR_BITS):
    """SBR FIL element size per AU [S, nau] int32 in bits, as the reference
    counts it for the core rate loop.  It mirrors write_sbr_payload except
    for the header bits (`hdr_bits`, see HDR_BITS): with
    hdr_bits=HDR_BITS_WRITTEN it is the written FIL length exactly."""
    env = side["sbr_env"]            # [S, nau, ch, n_hi] 1.5 dB
    env2 = side["sbr_env2"]          # [S, nau, ch, 2, n_hi] 3 dB
    tr = side["sbr_transient"]       # [S, nau, ch]
    nq = side["sbr_noise_q"]         # [S, nau, ch, n_q]
    ah = side["sbr_addharm"]         # [S, nau, ch, n_hi]
    n_hi, n_q = params.n_hi, params.n_q
    dev = env.device
    lenf, len3, lenn = const(ENV_LEN_F, dev), const(ENV3_LEN_F, dev), const(NOISE_LEN_F, dev)
    db_ = _delta_bits

    env1_bits = 7 + db_(env, lenf, 60)                     # [S, nau, ch]
    env2_bits = 6 + db_(env2[..., 0, :], len3, 31) + 6 + db_(env2[..., 1, :], len3, 31)
    noise1_bits = 5 + db_(nq, lenn, 31)
    env_bits = torch.where(tr, env2_bits, env1_bits)
    noise_bits = torch.where(tr, 2 * noise1_bits, noise1_bits)
    dtdf = torch.where(tr, 4, 2)
    grid = torch.where(tr, 12, 5)        # variable grid vs FIXFIX 1-env
    addharm = 1 + torch.where(ah.any(-1), n_hi, 0)
    ch_bits = grid + dtdf + 2 * n_q + env_bits + noise_bits + addharm
    n_ch = env.shape[2]
    body = ch_bits.sum(2) + (1 if n_ch == 2 else 0) + 1    # coupling + extra
    if n_ch == 2 and "sbr_cpl" in side:
        # coupled AUs: one grid + one invf, balance books and start widths
        # for channel 1
        lbal, lbal3 = const(ENVBAL_LEN_F, dev), const(ENVBAL3_LEN_F, dev)
        lnbal = const(NOISEBAL_LEN_F, dev)
        ch1e1 = 6 + db_(env[..., 1, :], lbal, 24)
        ch1e2 = 5 + db_(env2[..., 1, 0, :], lbal3, 12) + 5 + db_(env2[..., 1, 1, :], lbal3, 12)
        ch1n1 = 5 + db_(nq[..., 1, :], lnbal, 12)
        tr0 = tr[..., 0]
        body_cpl = (ch_bits[..., 0]
                    + torch.where(tr0, 4, 2)                       # dtdf ch1
                    + torch.where(tr0, ch1e2, ch1e1)
                    + torch.where(tr0, 2 * ch1n1, ch1n1)
                    + 1 + torch.where(ah[..., 1, :].any(-1), n_hi, 0)
                    + 1 + 1)                                       # coupling + extra
        body = torch.where(side["sbr_cpl"], body_cpl, body)
    if ps_bits is not None:
        # the bs_extended_data bit becomes the PS extension: flag(1) + size
        # (4[+8]) + ext payload (ext id(2) + ps data, whole bytes)
        ext_sz = (2 + ps_bits + 7) // 8
        body = body + 4 + torch.where(ext_sz >= 15, 8, 0) + 8 * ext_sz
    # header on AU 0 only (the reference sends it once per superframe)
    sbr_bits = body + hdr_bits[1]
    sbr_bits[:, 0] += hdr_bits[0] - hdr_bits[1]
    # FIL element: 3 id + 4 cnt (+8 esc if cnt >= 15) + 4 ext type, padded
    cnt = (4 + sbr_bits + 7) // 8
    return (3 + 4 + torch.where(cnt >= 15, 8, 0) + 8 * cnt).to(torch.int32)


# ---- Parametric Stereo (HE-AAC v2) ----
IID_CODE_F = _npz["ps_iidDeltaFreqCoarse_Code"]
IID_LEN_F = _npz["ps_iidDeltaFreqCoarse_Length"]
IID_CODE_FF = _npz["ps_iidDeltaFreqFine_Code"]
IID_LEN_FF = _npz["ps_iidDeltaFreqFine_Length"]
# coarse IID quantisation grid in dB (ps_encode.cpp iidQuant_fx)
IID_GRID_DB = np.array([-25, -18, -14, -10, -7, -4, -2, 0, 2, 4, 7, 10, 14, 18, 25],
                       np.float32)
# fine grid (iidQuantFine_fx, ps_encode.cpp:154-165)
IID_GRID_FINE_DB = np.array(
    [-50, -45, -40, -35, -30, -25, -22, -19, -16, -13, -10, -8, -6, -4, -2,
     0, 2, 4, 6, 8, 10, 13, 16, 19, 22, 25, 30, 35, 40, 45, 50], np.float32)
PS_NBANDS = 20
# parameter-band borders in QMF-band units: the 20-band "LoRes" grid of
# ps_encode.cpp:123-138 (the first 8 bins are the hybrid filterbank's
# sub-QMF splits of QMF bands 0-2)
PS_BORDER_QMF = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0,
                          4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 11.0, 14.0, 18.0,
                          23.0, 35.0, 64.0])
ICC_CODE_F = _npz["ps_iccDeltaFreq_Code"]
ICC_LEN_F = _npz["ps_iccDeltaFreq_Length"]
# ICC quantisation grid (correlation values, ps_encode quantized_RHO)
ICC_GRID = np.array([1.0, 0.937, 0.84118, 0.60092, 0.36764, 0.0, -0.589, -1.0],
                    np.float32)


def ps_num_env(bitrate):
    """Envelopes per PS frame by bitrate: 1 below 28 kbps, else 2."""
    return 1 if bitrate < 28000 else 2


def ps_data_bits(iid, iid_fine, use_fine, icc):
    """Exact ps_data size in bits [S, nau], mirroring _write_ps_data.
    iid/iid_fine/icc: [S, nau, n_env, 20]; use_fine: [S, nau] bool."""
    dev = iid.device
    lf, lff, lic = const(IID_LEN_F, dev), const(IID_LEN_FF, dev), const(ICC_LEN_F, dev)
    n_env = iid.shape[-2]

    def dsum(v, table, lav):
        # env 0: FREQ deltas from 0; env e > 0: TIME deltas vs env e-1
        v0 = v[..., 0, :]
        df = torch.diff(v0, dim=-1, prepend=torch.zeros_like(v0[..., :1]))
        bits = table[df.clamp(-lav, lav) + lav].sum(-1)
        if n_env > 1:
            dt = (v[..., 1:, :] - v[..., :-1, :]).clamp(-lav, lav) + lav
            bits = bits + table[dt].sum((-1, -2))
        return bits

    # fixed fields: hdr+iid_en+mode3+icc_en+mode3+ext+class+numenv2, plus
    # one dt flag per envelope for iid and for icc
    return (13 + 2 * n_env + torch.where(use_fine, dsum(iid_fine, lff, 30), dsum(iid, lf, 14))
            + dsum(icc, lic, 7)).to(torch.int32)


def ps_band_masks(n, fs_out):
    """[20, n//2+1] float64 0/1 masks of the rFFT bins in each PS band."""
    freqs = np.arange(n // 2 + 1) * fs_out / n
    borders = PS_BORDER_QMF * fs_out / 128.0
    return np.stack([(freqs >= borders[b]) & (freqs < borders[b + 1])
                     for b in range(PS_NBANDS)]).astype(np.float64)


def iid_parameters(au_l, au_r, fs_out, win=None, masks=None):
    """Per-AU IID and ICC parameters from L/R band cross-spectra.

    au_l, au_r: [..., n] windows; win: np.hanning(n) and masks:
    ps_band_masks(n, fs_out), both in the working dtype (made when None).
    Returns (iid_coarse [.., 20] in [-7..7], icc [.., 20] in [0..7],
    iid_fine [.., 20] in [-15..15], use_fine [..] bool).  The fine ladder is
    chosen when it cuts the total quantisation error meaningfully
    (selectIidBits, ps_encode.cpp:333-365); ICC is pooled over the envelope
    axis and over band pairs."""
    dt, dev = au_l.dtype, au_l.device
    n = au_l.shape[-1]
    if win is None:
        win = torch.as_tensor(np.hanning(n), device=dev).to(dt)
    if masks is None:
        masks = torch.as_tensor(ps_band_masks(n, fs_out), device=dev).to(dt)
    sl = torch.fft.rfft(au_l * win)
    sr = torch.fft.rfft(au_r * win)
    pl = sl.real * sl.real + sl.imag * sl.imag
    pr = sr.real * sr.real + sr.imag * sr.imag
    cross = sl.real * sr.real + sl.imag * sr.imag  # Re(L * conj(R))
    grid = const(IID_GRID_DB, dev, dt)
    fgrid = const(IID_GRID_FINE_DB, dev, dt)
    icc_grid = const(ICC_GRID, dev, dt)
    idxs, fidxs, errc, errf, els, ers, crs = [], [], [], [], [], [], []
    for b in range(PS_NBANDS):
        m = masks[b]
        el = (pl * m).sum(-1) + 1e-6
        er = (pr * m).sum(-1) + 1e-6
        iid_db = 10.0 * _log10(el / er)
        dc = (iid_db[..., None] - grid).abs()
        errc.append(dc.amin(-1))
        idxs.append((dc.argmin(-1) - 7).to(torch.int32))
        df = (iid_db[..., None] - fgrid).abs()
        errf.append(df.amin(-1))
        fidxs.append((df.argmin(-1) - 15).to(torch.int32))
        els.append(el)
        ers.append(er)
        crs.append((cross * m).sum(-1))
    use_fine = (sum(errc) - sum(errf)) > 0.5 * PS_NBANDS
    iccs = []
    for j in range(PS_NBANDS // 2):
        el2 = (els[2 * j] + els[2 * j + 1]).sum(-1, keepdim=True)
        er2 = (ers[2 * j] + ers[2 * j + 1]).sum(-1, keepdim=True)
        cr2 = (crs[2 * j] + crs[2 * j + 1]).sum(-1, keepdim=True)
        rho = (cr2 / torch.sqrt(el2 * er2)).clamp(-1.0, 1.0)
        qi = (rho[..., None] - icc_grid).abs().argmin(-1).to(torch.int32)
        qi = qi.expand(els[0].shape)
        iccs.extend([qi, qi])
    return (torch.stack(idxs, -1), torch.stack(iccs, -1), torch.stack(fidxs, -1), use_fine)


# ---- the writer (host numpy + BitWriter) ----

def _write_ps_data(bw, iid_idx, icc_idx=None, fine=False):
    """ps_data with IID (20-band coarse mode 1 / fine mode 4) + 20-band ICC
    over the envelopes (ps_bitenc.cpp:555-623; parse order psbitdec.cpp:
    449-575).  iid_idx/icc_idx: [n_env, 20]; envelope 0 FREQ-delta coded,
    later envelopes TIME-delta coded against the previous one.  Returns the
    bit count."""
    n0 = len(bw.buf) * 8 + bw.nbits
    has_icc = icc_idx is not None
    n_env = len(iid_idx)
    bw.put(1, 1)   # enable_ps_header
    bw.put(1, 1)   # enable_iid
    bw.put(4 if fine else 1, 3)  # iid_mode: 20 bands, fine/coarse quant
    bw.put(1 if has_icc else 0, 1)  # enable_icc
    if has_icc:
        bw.put(1, 3)  # icc_mode 1 = 20 bands
    bw.put(0, 1)   # enable_ext
    bw.put(0, 1)   # frame_class FIX
    bw.put({1: 1, 2: 2, 4: 3}[n_env], 2)  # num_env_idx (psbitdec table)
    code, ln, lav = (IID_CODE_FF, IID_LEN_FF, 30) if fine else \
        (IID_CODE_F, IID_LEN_F, 14)

    def deltas(vals, e, table, lens, dlav):
        bw.put(0 if e == 0 else 1, 1)
        for b in range(PS_NBANDS):
            ref = (int(vals[e][b - 1]) if b else 0) if e == 0 \
                else int(vals[e - 1][b])
            d = max(-dlav, min(dlav, int(vals[e][b]) - ref))
            bw.put(int(table[d + dlav]), int(lens[d + dlav]))

    for e in range(n_env):
        deltas(iid_idx, e, code, ln, lav)
    if has_icc:
        for e in range(n_env):
            deltas(icc_idx, e, ICC_CODE_F, ICC_LEN_F, 7)
    return len(bw.buf) * 8 + bw.nbits - n0


def _write_grid(sbr, n_env, grid_idx=None):
    """Frame grid for one channel: FIXFIX for 1 envelope (env_extr.cpp
    extractFrameInfo case 0); 2 envelopes: the GRID_MENU variable grid
    (FIXVAR/VARFIX, cases 1/2) with the border at the detected transient."""
    if n_env == 1 or grid_idx is None:
        sbr.put(0, 2)                     # bs_frame_class FIXFIX
        sbr.put(0 if n_env == 1 else 1, 2)
        sbr.put(1, 1)                     # bs_freq_res = high resolution
        return
    _, fclass, rel = GRID_MENU[int(grid_idx)]
    sbr.put(fclass, 2)                    # FIXVAR (1) / VARFIX (2)
    sbr.put(0, 2)                         # A / aL = 0
    sbr.put(1, 2)                         # one relative border
    sbr.put(rel, 2)                       # R code: width = 2R+2
    sbr.put(0, 2)                         # pointer p = 0
    sbr.put(1, 1)                         # freq res env 0 = high
    sbr.put(1, 1)                         # freq res env 1 = high


def _write_dtdf(sbr, n_env):
    n_noise = 1 if n_env == 1 else 2
    for _ in range(n_env):
        sbr.put(0, 1)                     # bs_df_env = FREQ
    for _ in range(n_noise):
        sbr.put(0, 1)                     # bs_df_noise = FREQ


def _write_invf(sbr, params, modes):
    """bs_invf_mode per noise band."""
    for i in range(params.n_q):
        m = int(modes[i]) if hasattr(modes, "__len__") else int(modes)
        sbr.put(m, 2)


def _write_env(sbr, envs, params, balance=False):
    """Envelope data, FREQ delta coding, hi-res bands.  FIXFIX 1-envelope
    frames use 1.5 dB (7-bit start + LAV 60 books), 2-envelope frames the
    header's 3.0 dB (6-bit start + LAV 31 books), as the decoder expects
    (env_extr.cpp; code_env.cpp:123-185).  balance: coupled channel-1
    values (halved wire domain) with the balance start widths (6/5 bits)
    and EnvBalance books (env_extr.cpp:1072-1090)."""
    amp15 = len(envs) == 1
    if balance:
        start_bits = 6 if amp15 else 5
        code, ln, lav = (ENVBAL_CODE_F, ENVBAL_LEN_F, 24) if amp15 else \
            (ENVBAL3_CODE_F, ENVBAL3_LEN_F, 12)
    else:
        start_bits = 7 if amp15 else 6
        code, ln, lav = (ENV_CODE_F, ENV_LEN_F, 60) if amp15 else \
            (ENV3_CODE_F, ENV3_LEN_F, 31)
    for env_vals in envs:
        v0 = int(env_vals[0])
        sbr.put(v0, start_bits)
        prev = v0
        for i in range(1, params.n_hi):
            d = int(env_vals[i]) - prev
            d = max(-lav, min(lav, d))
            sbr.put(int(code[d + lav]), int(ln[d + lav]))
            prev = prev + d


def _write_noise(sbr, noise_vals, params, n_env, balance=False):
    """Noise floor data: per noise envelope, first band 5 bits then FREQ
    deltas with the LAV 31 book (bit_sbr.cpp:751-830); balance channels use
    the EnvBalance11 book (LAV 12)."""
    code, ln, lav = (NOISEBAL_CODE_F, NOISEBAL_LEN_F, 12) if balance else \
        (NOISE_CODE_F, NOISE_LEN_F, 31)
    for _ in range(1 if n_env == 1 else 2):
        v0 = int(noise_vals[0])
        sbr.put(v0, 5)
        prev = v0
        for i in range(1, params.n_q):
            d = int(noise_vals[i]) - prev
            d = max(-lav, min(lav, d))
            sbr.put(int(code[d + lav]), int(ln[d + lav]))
            prev = prev + d


def write_sbr_payload(bw_target, envs, noise_vals, params, write_header=True,
                      ps_iid=None, envs_r=None, ps_icc=None,
                      invf=1, invf_r=1, noise_vals_r=None, add_harm=None,
                      add_harm_r=None, ps_fine=False,
                      grid_idx=None, grid_idx_r=None, coupled=False):
    """Append a FIL element with EXT_SBR_DATA carrying one SBR frame.

    bw_target: the AU BitWriter (after the SCE/CPE).  envs: list of 1 or 2
    [n_hi] envelope arrays (1-env values in 1.5 dB units, 2-env values in
    3.0 dB units); noise_vals: [n_q] ints 0..30; invf: [n_q] modes; ps_iid /
    ps_icc: [n_env, 20] PS indices or None; envs_r: right-channel envelopes
    for stereo SBR (the sbr_channel_pair_element layout of env_extr.cpp:
    617-820), coupled or not.  Returns the FIL element's byte count cnt."""
    cpe = envs_r is not None
    nl, nr = len(envs), len(envs_r) if cpe else 0
    if noise_vals_r is None:
        noise_vals_r = noise_vals

    def _write_add_harm(sbr_bw, flags):
        if flags is None or not any(bool(f) for f in flags):
            sbr_bw.put(0, 1)              # bs_add_harmonic_flag
        else:
            sbr_bw.put(1, 1)
            for b in range(params.n_hi):  # bs_add_harmonic per hi band
                sbr_bw.put(1 if flags[b] else 0, 1)
    sbr = BitWriter()
    sbr.put(1 if write_header else 0, 1)  # bs_header_flag
    if write_header:
        sbr.put(1, 1)                     # bs_amp_res = 3.0 dB
        sbr.put(params.bs_start_freq, 4)
        sbr.put(params.bs_stop_freq, 4)
        sbr.put(params.bs_xover_band, 3)
        sbr.put(0, 2)                     # bs_reserved
        sbr.put(1, 1)                     # header_extra_1
        sbr.put(0, 1)                     # header_extra_2
        sbr.put(params.bs_freq_scale, 2)
        sbr.put(params.bs_alter_scale, 1)
        sbr.put(params.bs_noise_bands, 2)
    sbr.put(0, 1)                         # bs_data_extra
    if cpe and coupled:
        # coupled layout (env_extr.cpp:637-810): one grid + one invf;
        # env/noise per channel; ch1 = balance values
        sbr.put(1, 1)                     # bs_coupling on
        _write_grid(sbr, nl, grid_idx)    # grid L only (R copies)
        _write_dtdf(sbr, nl)              # dtdf L
        _write_dtdf(sbr, nr)              # dtdf R
        _write_invf(sbr, params, invf)    # invf L only (R copies)
        _write_env(sbr, envs, params)
        _write_noise(sbr, noise_vals, params, nl)
        _write_env(sbr, envs_r, params, balance=True)
        _write_noise(sbr, noise_vals_r, params, nr, balance=True)
        _write_add_harm(sbr, add_harm)    # sinusoidal coding L
        _write_add_harm(sbr, add_harm_r)  # sinusoidal coding R
    elif cpe:
        sbr.put(0, 1)                     # bs_coupling off
        _write_grid(sbr, nl, grid_idx)    # grid L
        _write_grid(sbr, nr, grid_idx_r)  # grid R
        _write_dtdf(sbr, nl)              # dtdf L
        _write_dtdf(sbr, nr)              # dtdf R
        _write_invf(sbr, params, invf)    # invf L
        _write_invf(sbr, params, invf_r)  # invf R
        _write_env(sbr, envs, params)
        _write_env(sbr, envs_r, params)
        _write_noise(sbr, noise_vals, params, nl)    # noise L
        _write_noise(sbr, noise_vals_r, params, nr)  # noise R
        _write_add_harm(sbr, add_harm)    # sinusoidal coding L
        _write_add_harm(sbr, add_harm_r)  # sinusoidal coding R
    else:
        _write_grid(sbr, nl, grid_idx)
        _write_dtdf(sbr, nl)
        _write_invf(sbr, params, invf)
        _write_env(sbr, envs, params)
        _write_noise(sbr, noise_vals, params, nl)
        _write_add_harm(sbr, add_harm)
    if ps_iid is None:
        sbr.put(0, 1)                     # bs_extended_data
    else:
        # extended data with PS (encodeExtendedData, bit_sbr.cpp)
        ps = BitWriter()
        ps_bits = 2 + _write_ps_data(ps, ps_iid, ps_icc, fine=ps_fine)  # + ext id
        ext_size = (ps_bits + 7) // 8
        sbr.put(1, 1)                     # bs_extended_data
        if ext_size < 15:
            sbr.put(ext_size, 4)
        else:
            sbr.put(15, 4)
            sbr.put(ext_size - 15, 8)
        sbr.put(2, 2)                     # bs_extension_id = EXTENSION_ID_PS
        for byte in ps.buf:
            sbr.put(byte, 8)
        if ps.nbits:
            sbr.put(ps.acc, ps.nbits)
        pad = ext_size * 8 - ps_bits
        if pad:
            sbr.put(0, pad)

    n_payload = len(sbr.buf) * 8 + sbr.nbits
    # FIL element: id(3) + cnt(4)[+esc(8)] then extension_payload(cnt bytes)
    total_ext_bits = 4 + n_payload         # extension_type + sbr bits
    cnt = (total_ext_bits + 7) // 8
    bw = bw_target
    bw.put(6, 3)                           # ID_FIL
    if cnt >= 15:
        bw.put(15, 4)
        bw.put(cnt - 14, 8)
    else:
        bw.put(cnt, 4)
    bw.put(EXT_SBR_DATA, 4)
    for byte in sbr.buf:
        bw.put(byte, 8)
    if sbr.nbits:
        bw.put(sbr.acc, sbr.nbits)
    pad = cnt * 8 - total_ext_bits
    if pad:
        bw.put(0, pad)
    return cnt
