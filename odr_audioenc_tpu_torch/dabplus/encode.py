"""DAB+ AAC-LC core in PyTorch (port of odr_audioenc_tpu/dabplus/encode.py):
window-switched 960-MDCT, masking thresholds, TNS, M/S, PNS, the avoid-hole
and weighting machinery, the rate loop (integer and fractional bisect,
afterburner refinement, crash recovery) and the exact Huffman bit count.

Every integer quantity is computed with integer ops: Huffman lengths are
int32 gathers from the flat codebook tables, band sums of integers are
segment sums over the band index of each line (`scatter_add_`), and
floor(log2) reads the float32 exponent field.  The JAX package computes
these through one-hot matmuls, exact only while every operand is a small
integer in the matmul's precision; on CUDA a TF32 or bf16 matmul would
corrupt them.  Float band sums stay matmuls with the 0/1 band matrix (TF32
is pinned off in device.py).

encode_au is the psy stage (`au_psy`, which ends by building the loop's
`RateInputs`), the rate loop (`rate_loop`: on a CUDA card one launch of the
hand-written kernel per AU, rate_kernel.py; on the CPU `rate_loop_plain`)
and the crash-recovery check.

The reference's diagnostic surface is not ported: its environment A/B knobs
(the production values are the constants below), the threshold-override
transplant and the delivered-distortion tap.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..device import const
from . import rate_kernel
from . import tables as AT

NB = AT.MAX_SFB_LONG  # 49 padded bands
HOLE_O = 8            # rate-loop offset where allowMoreHoles band erasure opens
HOLE_RATE = 14.0      # priority ranks opened per offset step past HOLE_O
SPILL_O = 40          # rate-loop offset where uniform spill-degradation starts
O_LO, O_HI = 0, 63    # integer offset range of the rate-loop bisect
BISECT_STEPS = 6      # ceil(log2(O_HI - O_LO + 1))
FRAC_BISECT_STEPS = 5
REFINE_ROUNDS = 4     # afterburner refinement rounds (0 with -A)
REFINE_BANDS = 8      # worst-NMR bands refined per round

TNS_MAX_ORDER = 12       # LC long windows (14496-3 table 4.156)
TNS_GAIN_THRESH = 1.437  # aacenc_tns.cpp:447 threshOn[HIFILT]
TNS_LO_ORDER = 5         # aacenc_tns.cpp:451 tnsLimitOrder[LOFILT]
# 4-bit arcsine quantizer: positive indices reconstruct as sin(i/iqfac),
# negative ones with iqfac_m (asymmetric per 14496-3)
_TNS_IQFAC4 = (8.0 - 0.5) / (np.pi / 2.0)
_TNS_IQFAC4_M = (8.0 + 0.5) / (np.pi / 2.0)

SECT_BITS = 4 + 5        # sect_cb + sect_len (long windows)
SECT_BITS_SHORT = 4 + 3  # sect_len is 3 bits for EIGHT_SHORT
PNS_HCB = 13             # NOISE_HCB
WEIGHT_FS2 = 2.0 ** 31   # full-scale reference of the threshold weighting

_BIG = 1 << 20           # cost of an invalid codebook
# the rate loop's constants as the kernel takes them (rate_kernel.rate_loop)
_RATE_PARAMS = dict(sect_bits=SECT_BITS, o_lo=O_LO, o_hi=O_HI, bisect_steps=BISECT_STEPS,
                    frac_steps=FRAC_BISECT_STEPS, hole_o=HOLE_O, spill_o=SPILL_O,
                    refine_bands=REFINE_BANDS, hole_rate=HOLE_RATE)

# flat Huffman length tables, stacked per codeword group (int32)
_LEN_QUAD = np.stack([AT.HUFF_LEN[b].reshape(-1) for b in (1, 2, 3, 4)]).astype(np.int32)
_LEN_PAIR56 = np.stack([AT.HUFF_LEN[5].reshape(-1),
                        AT.HUFF_LEN[6].reshape(-1)]).astype(np.int32)


def _fold17(table, lim):
    """Fold a (lim+1)^2 pair length table into 17x17 over book 11's clipped
    index domain (entries past lim are unreachable while the book is
    valid, so their value is free)."""
    t = np.asarray(table).reshape(lim + 1, lim + 1)
    a = np.minimum(np.arange(17), lim)
    return t[np.ix_(a, a)].reshape(-1)


# books 7..11 over one 17x17 index: [289, 5]
_LEN_PAIR17 = np.stack([_fold17(AT.HUFF_LEN[7], 7), _fold17(AT.HUFF_LEN[8], 7),
                        _fold17(AT.HUFF_LEN[9], 12), _fold17(AT.HUFF_LEN[10], 12),
                        AT.HUFF_LEN[11].reshape(-1)], -1).astype(np.int32)
_LEN_QUAD_T = np.ascontiguousarray(_LEN_QUAD.T)            # [81, 4]
_LEN_PAIR56_T = np.ascontiguousarray(_LEN_PAIR56.T)        # [81, 2]
_LEN_SCF = np.asarray(AT.HUFF_LEN_SCF, np.int32)           # [121]
for _t in (_LEN_QUAD, _LEN_PAIR56, _LEN_PAIR17, _LEN_SCF):
    assert _t.max() < 32
_LAV = np.array([0, 1, 2, 4, 7, 12], np.int32)             # distinct book limits
# book -> distinct-limit column (book 11 always valid: q is clipped to its escape limit)
_BOOK_LAV = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, -1])
_FAST_BOOKS = np.array([0, 1, 3, 5, 7, 9, 11])
_PNS_TAPS = [float(t) for t in (0.75 * 0.25 ** np.arange(12)).astype(np.float32)]
_HOLE_FR = [(2 * k + 1) / 15.0 for k in range(8)]

# the rate-loop kernel's one table (rate_kernel.TABLE_LAYOUT): the Huffman
# lengths above and the largest magnitude each book codes (book 11: all)
_RATE_TABLE = np.concatenate([_LEN_QUAD_T.ravel(), _LEN_PAIR56_T.ravel(), _LEN_PAIR17.ravel(),
                              _LEN_SCF, _LAV[_BOOK_LAV[:-1]], [8191]]).astype(np.int32)


# log10, log2 and exp2 as JAX lowers them (through log and exp): XLA's f64
# log agrees with torch's nearly always, its log10/exp2 decompositions with
# torch.log10/exp2 far less often
_INV_LN10 = 0.4342944819032518
_LN2 = float(np.log(2.0))


def _log10(x):
    return torch.log(x) * _INV_LN10


def _log2(x):
    return torch.log(x) / _LN2


def _exp2(x):
    return torch.exp(_LN2 * x)


def _tensor(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _where_f(cond, a, b, like):
    """torch.where over two Python floats, in the working dtype (a bare
    torch.where(c, 0.63, 0.5) would be float32)."""
    return torch.where(cond, torch.tensor(a, dtype=like.dtype, device=like.device),
                       torch.tensor(b, dtype=like.dtype, device=like.device))


def _floor_int(x, lo, hi):
    """floor(x) clipped to [lo, hi] as int32, clamped in floating point
    before the cast (never relying on an out-of-range conversion)."""
    return torch.floor(x).clamp(lo, hi).to(torch.int32)


def _bview(t, ndim):
    """[S] -> [S, 1, ..., 1] with ndim dims."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 1))


def _shift_right(x, fill):
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _shift_left(x, fill):
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], -1)


# ---- TNS -------------------------------------------------------------------

def _acf_norm(x, lags):
    """Energy-normalized autocorrelation of the trailing axis, [..., lags+1]
    with r[0] == 1 (0 for a silent segment)."""
    L = x.shape[-1]
    r0 = (x * x).sum(-1)
    ok = r0 > 0
    inv = torch.where(ok, 1.0 / r0.clamp(min=1e-30), 0.0)
    rs = [ok.to(x.dtype)]
    for k in range(1, lags + 1):
        rs.append((x[..., k:] * x[..., :L - k]).sum(-1) * inv)
    return torch.stack(rs, -1)


def _step_up(a, k_m, m):
    """One Levinson step-up on the coefficient list a (a[0] == 1)."""
    if m > 1:
        a = [a[0]] + [a[i] + k_m * a[m - i] for i in range(1, m)] + a[m:]
    a[m] = k_m
    return a


def _levinson(r, order):
    """Levinson-Durbin: autocorrelation [..., >=order+1] -> reflection
    coefficients [..., order] and prediction gain r0/err."""
    r0 = r[..., 0].clamp(min=1e-30)
    a = [torch.ones_like(r0)] + [torch.zeros_like(r0)] * order
    err = r0
    ks = []
    for m in range(1, order + 1):
        acc = sum(a[i] * r[..., m - i] for i in range(m))
        k_m = (-acc / err.clamp(min=1e-30)).clamp(-0.999, 0.999)
        ks.append(k_m)
        a = _step_up(a, k_m, m)
        err = err * (1.0 - k_m * k_m)
    return torch.stack(ks, -1), r0 / err.clamp(min=1e-30)


def _last_true(mask):
    """Index of the last True along -1 (mask.any(-1) must be checked)."""
    n = mask.shape[-1]
    return n - 1 - mask.flip(-1).to(torch.int32).argmax(-1)


def _quant_stepup(ks, out_order=TNS_MAX_ORDER):
    """4-bit arcsine index quantization + step-up of the QUANTIZED
    reflection coefficients to direct form.  Returns (idx [..., out_order],
    order, sum_sqr, a_hat [..., out_order])."""
    max_order = ks.shape[-1]
    asn = torch.asin(ks)
    idx = torch.where(ks >= 0, torch.round(asn * _TNS_IQFAC4).clamp(0, 7),
                      torch.round(asn * _TNS_IQFAC4_M).clamp(-8, 0)).to(torch.int32)
    nz = idx != 0
    order = torch.where(nz.any(-1), _last_true(nz) + 1, 0).to(torch.int32)
    sum_sqr = (idx * idx).sum(-1)
    pos = torch.arange(max_order, device=ks.device)
    idx = torch.where(pos < order[..., None], idx, 0)
    idx_f = idx.to(ks.dtype)
    khat = torch.where(idx >= 0, torch.sin(idx_f / _TNS_IQFAC4),
                       torch.sin(idx_f / _TNS_IQFAC4_M))
    ah = [torch.ones_like(ks[..., 0])] + [torch.zeros_like(ks[..., 0])] * max_order
    for m in range(1, max_order + 1):
        ah = _step_up(ah, khat[..., m - 1], m)
    ah = torch.stack(ah[1:], -1)
    pad = out_order - max_order
    return F.pad(idx, (0, pad)), order, sum_sqr, F.pad(ah, (0, pad))


def tns_analysis_fdk(spec, lo_start, hi_start, stop):
    """fdk TnsDetect analogue (aacenc_tns.cpp:638-964, long windows): the HI
    range's autocorrelation is normalized per third and summed; the LO range
    gets its own order-5 filter; similar filters merge into one HI filter
    over the whole range.  Returns a dict of per-[S, ch] leaves: en, idx
    [..,12], order, merged, en_lo, idx_lo [..,12], order_lo, ah_hi [..,12],
    ah_lo [..,12], pred_gain."""
    third = (stop - hi_start) // 3
    segs = [(hi_start, hi_start + third), (hi_start + third, hi_start + 2 * third),
            (hi_start + 2 * third, stop)]
    r_hi = sum(_acf_norm(spec[..., a:b], TNS_MAX_ORDER) for a, b in segs)
    r_lo = _acf_norm(spec[..., lo_start:hi_start], TNS_LO_ORDER)

    ks_hi, pg_hi = _levinson(r_hi, TNS_MAX_ORDER)
    idx_hi, order_hi, ssq_hi, ah_hi = _quant_stepup(ks_hi)
    en_hi = ((pg_hi > TNS_GAIN_THRESH) | (ssq_hi > TNS_MAX_ORDER // 2 + 2)) & (order_hi > 0)

    ks_lo, pg_lo = _levinson(r_lo, TNS_LO_ORDER)
    idx_lo, order_lo, ssq_lo, ah_lo = _quant_stepup(ks_lo)
    # filter the lower quarter if the gain is high enough, but not too high
    # (aacenc_tns.cpp:920-925)
    lo_quality = (((pg_lo > 1.5) & (pg_lo < 16.0 * TNS_LO_ORDER))
                  | ((ssq_lo > 9) & (ssq_lo < 22 * TNS_LO_ORDER))) & (order_lo > 0)
    en_lo = en_hi & lo_quality

    # merge when the two filters agree on the first LO-order indices
    dsum = (idx_hi[..., :TNS_LO_ORDER] - idx_lo[..., :TNS_LO_ORDER]).abs().sum(-1)
    merged = en_lo & (dsum < 2)
    # merged order trim (aacenc_tns.cpp:940-952)
    pos = torch.arange(TNS_MAX_ORDER, device=spec.device)
    big = (idx_hi.abs() > 1) & (pos >= TNS_LO_ORDER)
    first_big = torch.where(big.any(-1), big.to(torch.int32).argmax(-1), order_hi)
    below = (idx_hi != 0) & (pos < first_big[..., None])
    last_nz = torch.where(below.any(-1), _last_true(below), -1)
    order_trim = torch.minimum(order_hi, last_nz + 1)
    order_hi = torch.where(merged, order_trim.clamp(min=0), order_hi).to(torch.int32)
    idx_hi = torch.where(pos < order_hi[..., None], idx_hi, 0)
    en_lo = en_lo & ~merged
    return dict(en=en_hi, idx=idx_hi, order=order_hi, merged=merged,
                en_lo=en_lo, idx_lo=idx_lo, order_lo=order_lo,
                ah_hi=ah_hi, ah_lo=ah_lo, pred_gain=pg_hi)


def tns_sync(t):
    """Cross-channel HI-filter sync (FDKaacEnc_TnsSync, aacenc_tns.cpp:
    980-1051): channel 1 adopts channel 0's configuration when their indices
    are similar.  t: dict from tns_analysis_fdk with leading dims [S, 2]."""
    d = (t["idx"][:, 0] - t["idx"][:, 1]).abs()
    do_sync = (t["en"][:, 0] | t["en"][:, 1]) & (d.amax(-1) <= 1) & (d.sum(-1) <= 2)

    def adopt(v):
        return torch.cat([v[:, :1], torch.where(_bview(do_sync, v.ndim), v[:, :1],
                                                v[:, 1:2])], 1)
    return {k: adopt(v) for k, v in t.items()}


def _fir_range(spec, a_hat, start, stop):
    """A(z) = 1 + sum a_k z^-k over [start, stop) with zero history."""
    x = spec[..., start:stop]
    y = x
    for k in range(1, TNS_MAX_ORDER + 1):
        y = y + a_hat[..., k - 1:k] * F.pad(x[..., :-k], (k, 0))
    return y


def tns_filter_fdk(spec, t, lo_start, hi_start, stop):
    """The TnsEncode filter layout (aacenc_tns.cpp:1070-1111): merged, ONE
    HI filter over [lo_start, stop); otherwise the HI filter over
    [hi_start, stop) and the optional LO filter over [lo_start, hi_start)."""
    y_m = _fir_range(spec, t["ah_hi"], lo_start, stop)
    y_h = _fir_range(spec, t["ah_hi"], hi_start, stop)
    y_l = _fir_range(spec, t["ah_lo"], lo_start, hi_start)
    en, mg, lo = t["en"][..., None], t["merged"][..., None], t["en_lo"][..., None]
    seg_lo = torch.where(en & mg, y_m[..., :hi_start - lo_start],
                         torch.where(en & lo, y_l, spec[..., lo_start:hi_start]))
    seg_hi = torch.where(en & mg, y_m[..., hi_start - lo_start:],
                         torch.where(en, y_h, spec[..., hi_start:stop]))
    return torch.cat([spec[..., :lo_start], seg_lo, seg_hi, spec[..., stop:]], -1)


# ---- transform and band domain -----------------------------------------------

def mdct_frame_switched(prev, cur, cos_basis, wvecs, short_basis, seq):
    """Window-switched MDCT.  prev/cur: [S, ch, 960]; cos_basis [1920, 960]
    unwindowed long basis; wvecs [4, 1920] LONG/START/SHORT/STOP windows;
    short_basis [240, 120] windowed; seq [S].  The short path's 8 strided
    240-frames are emitted window-major [8*120]; selected per stream."""
    x = torch.cat([prev, cur], -1)                               # [S, ch, 1920]
    spec_long = (x * wvecs[seq.long()][:, None, :]) @ cos_basis
    frames = x[..., AT.SHORT_OFFSET:AT.SHORT_OFFSET + 9 * AT.NS].unfold(-1, 2 * AT.NS, AT.NS)
    spec_short = (frames @ short_basis).reshape(spec_long.shape)
    return torch.where((seq == 2)[:, None, None], spec_short, spec_long)


def band_energy(spec, band_m):
    """spec [..., 960], band_m [NB, 960] -> [..., NB]"""
    return (spec * spec) @ band_m.T


class BandCtx:
    """Per-stream long/short band-domain dispatch.  Every ladder the encoder
    uses covers all 960 lines (checked by the encoder), so one band index
    per line and stream (`bol`, [S or 1, 960]) serves every integer segment
    sum and every band-to-line broadcast; float band sums are one matmul
    with both 0/1 band matrices, selected per stream."""

    def __init__(self, band_m, bol, short_ctx=None, is_short=None):
        if short_ctx is not None and is_short is not None:
            self.t = is_short
            self.bol = torch.where(is_short[:, None], short_ctx["bol"], bol).long()
            self.band_mt = torch.cat([band_m, short_ctx["band_m"]], 0).T
        else:
            self.t = None
            self.bol = bol.long()[None]
            self.band_mt = band_m.T

    def _idx(self, shape, stride=1):
        """bol[..., ::stride] broadcast to `shape` ([S, .., n] lines)."""
        b = self.bol[..., ::stride]
        return b.reshape(b.shape[:1] + (1,) * (len(shape) - 2) + b.shape[1:]).expand(shape)

    def reduce_f(self, x):
        """float band sums: x [..., 960] -> [..., NB]."""
        out = x @ self.band_mt
        if self.t is None:
            return out
        return torch.where(_bview(self.t, x.ndim), out[..., NB:], out[..., :NB])

    def energy(self, spec):
        return self.reduce_f(spec * spec)

    def bsum(self, x, stride):
        """int band sums per column: x [S, ch, 960//stride, K] -> [S, ch, NB, K]."""
        idx = self._idx(x.shape[:-1], stride)[..., None].expand(x.shape)
        out = torch.zeros(x.shape[:-2] + (NB, x.shape[-1]), dtype=x.dtype, device=x.device)
        return out.scatter_add_(-2, idx, x)

    def bmax(self, x, stride):
        """per-band max of nonnegative ints: x [S, ch, 960//stride] -> [S, ch, NB]."""
        out = torch.zeros(x.shape[:-1] + (NB,), dtype=x.dtype, device=x.device)
        return out.scatter_reduce_(-1, self._idx(x.shape, stride), x, "amax")

    def to_lines(self, band_vals):
        """band_vals [..., NB] -> [..., 960]: each line takes its band's value."""
        return band_vals.gather(-1, self._idx(band_vals.shape[:-1] + (AT.N,)))


def spread_thresholds(en, pt, clamp_en=None):
    """Two-pass bark-domain spreading + ATH (psy_main.cpp:950-1014
    analogue).  en: [..., NB]; pt: f_low/f_high/ath, each [NB] or
    broadcastable; clamp_en: thresholds clamped to these energies."""
    thr = _spread(en * 10.0 ** (-2.9), pt["f_low"], pt["f_high"])
    thr = torch.maximum(thr, pt["ath"])
    if clamp_en is not None:
        thr = torch.minimum(thr, clamp_en + 1e30 * (clamp_en == 0).to(en.dtype))
    return thr


def _spread(x, f_low, f_high):
    """Max-spreading over the bands: upward with f_high, then downward with
    f_low (one column at a time, as the reference walks them)."""
    cols = list(x.unbind(-1))
    fh = f_high.expand(x.shape).unbind(-1)
    fl = f_low.expand(x.shape).unbind(-1)
    for b in range(1, NB):
        cols[b] = torch.maximum(cols[b], cols[b - 1] * fh[b - 1])
    for b in range(NB - 2, -1, -1):
        cols[b] = torch.maximum(cols[b], cols[b + 1] * fl[b])
    return torch.stack(cols, -1)


def spread_energy(en, f_low, f_high):
    """Max-spreading of band ENERGIES with the SprEn slopes (avoid-hole
    detection input, FDKaacEnc_SpreadingMax on sfbSpreadEnergy)."""
    return _spread(en, f_low, f_high)


# ---- minimum SNR, M/S, weighting ---------------------------------------------

def adapt_min_snr(minsnr, en, bandsel):
    """Relax minSnr for bands far below the channel's average energy
    (FDKaacEnc_adaptMinSnr, adj_thr.cpp:465-556)."""
    nb_act = bandsel.sum(-1, keepdim=True).clamp(min=1)
    avg_en = (en * bandsel).sum(-1, keepdim=True) / nb_act.to(en.dtype)
    r = _log2(avg_en.clamp(min=1e-30)) - _log2(en.clamp(min=1e-30))
    expo = (1.375 - 0.375 * 0.30103 * r).clamp(min=0.25)
    red = torch.pow(minsnr.clamp(min=1e-30), expo).clamp(max=0.8)
    return torch.where(r > np.log2(10.0), red, minsnr)


def modify_min_snr(minsnr, en, bandsel, grp_start, grp_end, is_short_b):
    """Tighten minSnr on local spectral peaks, relax it in valleys
    (adj_thr.cpp:569-640); neighbours never cross a short-block group."""
    # edge replication at group boundaries and ladder ends
    last_act = grp_end | ~_shift_left(bandsel, False)
    en_m1 = torch.where(grp_start, en, torch.cat([en[..., :1], en[..., :-1]], -1))
    en_p1 = torch.where(last_act, en, torch.cat([en[..., 1:], en[..., -1:]], -1))
    avg = 0.5 * (en_m1 + en_p1)
    en_s = en.clamp(min=1e-30)
    floor_pk = _where_f(is_short_b, 0.5, 0.316, en)
    tmp_pk = torch.maximum(0.8 * avg / en_s, floor_pk)
    minsnr = torch.where((en > avg) & bandsel, torch.minimum(minsnr, tmp_pk), minsnr)
    tmp_vl = torch.minimum((avg / (2.0 * en_s) * minsnr).clamp(max=0.8), minsnr * 3.16)
    valley = (2.0 * en < avg) & (en > 0) & bandsel
    return torch.where(valley, tmp_vl, minsnr)


def ms_adapt_min_snr(minsnr, en, spr_en, ms_used):
    """Stereo M/S minSnr + spread-energy coupling (adj_thr.cpp:642-694).
    minsnr/en/spr_en: [S, 2, NB]; ms_used: [S, NB]."""
    en_m, en_s = en[:, 0], en[:, 1]
    max_thr = 0.25 * torch.maximum(en_m, en_s) * minsnr[:, 0]
    out = []
    for c, en_c in ((0, en_m), (1, en_s)):
        cand = torch.where(en_c > 0, max_thr / en_c.clamp(min=1e-30), 0.0)
        snr = torch.maximum(minsnr[:, c], cand)
        snr = torch.where(snr <= 1.0, snr.clamp(max=0.8), snr)
        out.append(torch.where(ms_used, snr, minsnr[:, c]))
    spr_s = torch.where(ms_used & (en_m > spr_en[:, 0]), 0.9 * en_s, spr_en[:, 1])
    spr_m = torch.where(ms_used & (en_s > spr_s), 0.9 * en_m, spr_en[:, 0])
    return torch.stack(out, 1), torch.stack([spr_m, spr_s], 1)


def ms_stereo(spec, en, thr, bctx, bandsel):
    """Per-band mid/side decision + transform + psy-data substitution
    (FDKaacEnc_MsStereoProcessing, ms_stereo.cpp:109-240).  On MS bands both
    channels take min(thrL, thrR).  spec/en/thr: [S, 2, 960]/[S, 2, NB]
    L/R domain -> (spec', en', thr', ms_used [S, NB])."""
    m = 0.5 * (spec[:, 0] + spec[:, 1])
    s = 0.5 * (spec[:, 0] - spec[:, 1])
    en_m, en_s = bctx.energy(m), bctx.energy(s)
    thr_l, thr_r = thr[:, 0], thr[:, 1]
    en_l, en_r = en[:, 0], en[:, 1]
    min_thr = torch.minimum(thr_l, thr_r)
    pnlr = (thr_l / torch.maximum(en_l, thr_l)) * (thr_r / torch.maximum(en_r, thr_r))
    pnms = (min_thr / torch.maximum(en_m, min_thr)) * (min_thr / torch.maximum(en_s, min_thr))
    use = (pnms > pnlr) & bandsel
    use_l = bctx.to_lines(use)
    out = torch.stack([torch.where(use_l, m, spec[:, 0]), torch.where(use_l, s, spec[:, 1])], 1)
    en2 = torch.stack([torch.where(use, en_m, en_l), torch.where(use, en_s, en_r)], 1)
    thr2 = torch.stack([torch.where(use, min_thr, thr_l), torch.where(use, min_thr, thr_r)], 1)
    return out, en2, thr2, use


def calc_weighting(en, thr, ffak, nlines, bandsel, is_short, last_patch, ms_used):
    """Threshold/energy weighting for noise-like long frames
    (FDKaacEnc_calcWeighting, adj_thr.cpp:755-880).  en/thr/ffak: [S, ch,
    NB] (post-MS); last_patch: [S, ch] bool carried state.  Returns (w,
    new_last_patch)."""
    act = (en > thr) & bandsel
    width = nlines.expand(en.shape)
    nl = torch.minimum(width, ffak * torch.pow(width / en.clamp(min=1e-30), 0.25))
    nl = torch.where(act, nl, 0.0)
    chaos = (nl.sum(-1) / float(AT.N)).clamp(min=0.1875)
    long_frame = (torch.ones(en.shape[0], dtype=torch.bool, device=en.device)
                  if is_short is None else ~is_short)
    use_patch = (chaos > 0.78125) & long_frame[:, None]
    exe = (use_patch & last_patch)[..., None].expand(en.shape)
    if en.shape[1] == 2 and ms_used is not None:
        # MS-coupled bands follow the mid channel's decision (per band)
        exe = torch.stack([exe[:, 0], torch.where(ms_used, exe[:, 0], exe[:, 1])], 1)
    en_n = (en / WEIGHT_FS2).clamp(min=1e-30)
    zero = torch.zeros((), dtype=en.dtype, device=en.device)

    def tot(v):
        return torch.where(bandsel, v, zero).sum(-1, keepdim=True)
    e_tot = tot(en_n).clamp(min=1e-30)
    e14, e12, e34 = tot(torch.pow(en_n, 0.25)), tot(torch.sqrt(en_n)), tot(torch.pow(en_n, 0.75))
    w1 = torch.sqrt(torch.pow(en_n, 1.5) * e14 / e_tot)
    w2 = torch.sqrt(en_n * e12 / e_tot)
    w3 = torch.sqrt(torch.sqrt(en_n) * e34 / e_tot)
    c = chaos[..., None]
    w = torch.where(c > 0.8125, w1, torch.where(c > 0.796875, w2, w3)).clamp(max=1.0)
    w = torch.where(exe & (en > 0.0) & bandsel, w, 1.0)
    # short frames leave the chain armed (adj_thr.cpp:878-882)
    new_last = torch.where(long_frame[:, None], use_patch, True)
    return w, new_last


def pre_echo_control(thr, thr_nm1, pre_flag, seq, short_ctx, is_short):
    """Limit the frame-to-frame masking-threshold increase to 2x
    (FDKaacEnc_PreEchoControl, pre_echo_control.cpp:103-180, with the
    psy_main STOP/START skip logic).  EIGHT_SHORT AUs run it group by group
    on the grouped {4,4} ladder.  Returns (thr', thr_nm1', pre_flag')."""
    def cap(t, prev):
        return torch.maximum(torch.minimum(t, 2.0 * prev), 0.01 * t)
    flag_eff = (pre_flag & (seq != 3))[:, None, None]
    ctl = cap(thr, thr_nm1)
    no_hist = thr
    if short_ctx is not None:
        gmap = short_ctx["prev_grp_map"]
        g1 = short_ctx["g1_mask"]
        ctl_g2 = cap(thr, thr[..., gmap])
        ctl_short = torch.where(g1, cap(thr, thr_nm1[..., gmap]), ctl_g2)
        is_short_b = is_short[:, None, None]
        ctl = torch.where(is_short_b, ctl_short, ctl)
        # group-2 control is within the AU and applies without history
        no_hist = torch.where(is_short_b, torch.where(g1, thr, ctl_g2), thr)
    return torch.where(flag_eff, ctl, no_hist), thr, seq != 1


def pns_detect(spec, en, thr, bctx, eligible, pns_tabs=None):
    """Perceptual noise substitution detection (the fdk LC chain,
    noisedet.cpp:150-240 + aacenc_pns.cpp:218-285): quarter power
    distribution, chaos-measure tonality, audibility, gap fill and isolated
    band removal.  Returns (mask [S, ch, NB], noise energies int32)."""
    p = spec * spec
    if pns_tabs is not None:
        qmask = pns_tabs["qmask"]
        qe = torch.stack([bctx.reduce_f(p * qmask[i]) for i in range(4)], -1)
        noise_pd = qe.amax(-1) * pns_tabs["curve"] < qe.amin(-1)
        eligible = eligible & pns_tabs["width_ok"]
        ton_ref = pns_tabs["ton_thresh"]
    else:
        noise_pd = torch.ones(en.shape, dtype=torch.bool, device=en.device)
        ton_ref = 10.0 ** -0.10
    # chaos measure (chaosmeasure.cpp PeakFast), then the 0.75/0.25 IIR
    # smoothing along frequency as a 12-tap FIR
    a = spec.abs()
    left2 = torch.cat([a[..., :1], a[..., :1], a[..., :-2]], -1)
    right2 = torch.cat([a[..., 2:], a[..., -1:], a[..., -1:]], -1)
    pred = 0.5 * (left2 + right2)
    chaos = torch.where(pred < a, (pred / a.clamp(min=1e-20)) ** 2, 1.0)
    L = chaos.shape[-1]
    ch_s = sum(k * (chaos if i == 0 else torch.cat(
        [chaos[..., :1].expand(chaos.shape[:-1] + (i,)), chaos[..., :L - i]], -1))
        for i, k in enumerate(_PNS_TAPS))
    c_ratio = 2.0 * bctx.reduce_f(p * ch_s) / en.clamp(min=1e-20)
    fuzzy = noise_pd & (c_ratio > ton_ref)
    mask = eligible & fuzzy & (en > 1.5 * thr)
    # gap fill, then drop isolated PNS bands
    mask = mask | (eligible & fuzzy & _shift_right(mask, False) & _shift_left(mask, False))
    mask = mask & (_shift_right(mask, False) | _shift_left(mask, False))
    nrg = torch.round(2.0 * _log2(en.clamp(min=1e-10))).clamp(-100, 155).to(torch.int32)
    return mask, nrg


# ---- bit counting ----------------------------------------------------------

def spectral_bits_and_books(q, bctx, bandsel, return_cost=False, fast=False):
    """Per-band best codebook + bit cost (bit_cnt.cpp re-expression).
    q: [S, ch, 960] int32; bandsel: [.., NB] valid-band mask.  Returns
    (books [.., NB], bits [.., NB]); with return_cost the [.., NB, 12] cost
    table (invalid books cost 2^20) for the sectioning DP.  fast=True counts
    only the odd codebooks {1,3,5,7,9,11} (a tight upper bound the rate
    loop's bisect uses)."""
    dev = q.device
    shp = q.shape[:-1]
    aq = q.abs()
    q4, aq4 = q.reshape(*shp, 240, 4), aq.reshape(*shp, 240, 4)
    q2, aq2 = q.reshape(*shp, 480, 2), aq.reshape(*shp, 480, 2)
    # quads/pairs never straddle bands (sfb widths and window starts % 4 == 0)

    # book validity from each band's largest magnitude
    bmax = bctx.bmax(aq4.amax(-1), 4)                             # [.., NB]
    ok = bmax[..., None] <= const(_LAV, dev)                      # [.., NB, 6]
    ok = torch.cat([ok[..., _BOOK_LAV[:-1]], torch.ones_like(ok[..., :1])], -1)  # [.., NB, 12]

    signs4 = (aq4 != 0).sum(-1, dtype=torch.int32)
    signs2 = (aq2 != 0).sum(-1, dtype=torch.int32)
    c1 = (q4 + 1).clamp(0, 2)
    i1 = (c1[..., 0] * 3 + c1[..., 1]) * 9 + c1[..., 2] * 3 + c1[..., 3]
    c3 = aq4.clamp(0, 2)
    i3 = (c3[..., 0] * 3 + c3[..., 1]) * 9 + c3[..., 2] * 3 + c3[..., 3]
    c5 = (q2 + 4).clamp(0, 8)
    i5 = c5[..., 0] * 9 + c5[..., 1]
    c11 = aq2.clamp(0, 16)
    i11 = c11[..., 0] * 17 + c11[..., 1]
    # floor(log2(a)) from the float32 exponent field (exact for a < 2^24)
    n_esc = (aq2.clamp(min=16).to(torch.float32).view(torch.int32) >> 23) - 127
    esc = torch.where(aq2 >= 16, 2 * n_esc - 3, 0).sum(-1, dtype=torch.int32)

    quad_t, pair56_t, pair17_t = (const(t, dev) for t in (_LEN_QUAD_T, _LEN_PAIR56_T,
                                                          _LEN_PAIR17))
    if fast:
        l1 = quad_t[i1.long(), 0]
        l3 = quad_t[i3.long(), 2] + signs4
        l5 = pair56_t[i5.long(), 0]
        l7_9_11 = pair17_t[i11.long()][..., 0::2] + signs2[..., None]
        l7_9_11[..., 2] += esc
        b4 = bctx.bsum(torch.stack([l1, l3], -1), 4)
        b2 = bctx.bsum(torch.cat([l5[..., None], l7_9_11], -1), 2)
        bits = torch.cat([torch.zeros_like(b4[..., :1]), b4, b2], -1)   # books 0,1,3,5,7,9,11
        cost = torch.where(ok[..., _FAST_BOOKS], bits, _BIG)
        bbits, sel = cost.min(-1)
        books = const(_FAST_BOOKS, dev)[sel].to(torch.int32)
        return torch.where(bandsel, books, 0), torch.where(bandsel, bbits, 0)

    l14 = quad_t[i1.long()]                                       # [.., 240, 4]
    l34 = quad_t[i3.long()]
    l_quad = torch.cat([l14[..., :2], l34[..., 2:] + signs4[..., None]], -1)
    l_pair = torch.cat([pair56_t[i5.long()], pair17_t[i11.long()] + signs2[..., None]], -1)
    l_pair[..., 6] += esc                                         # book 11's escapes
    b4 = bctx.bsum(l_quad, 4)                                     # books 1-4
    b2 = bctx.bsum(l_pair, 2)                                     # books 5-11
    bits = torch.cat([torch.zeros_like(b4[..., :1]), b4, b2], -1)  # [.., NB, 12]
    cost = torch.where(ok, bits, _BIG)
    if return_cost:
        return cost
    bbits, books = cost.min(-1)
    return (torch.where(bandsel, books.to(torch.int32), 0),
            torch.where(bandsel, bbits, 0))


def optimal_books(cost, bandsel, sect_bits=SECT_BITS, force_break=None):
    """Jointly optimal per-band codebooks under sectioning (dyn_bits.cpp
    noiseless-coder analogue): a DP over the bands, forward then backward,
    where staying in the previous section is free and a new one costs a
    section header.  cost: [S, ch, NB, 12] (invalid = big); sect_bits: int
    or [S, 1, 1]; force_break: optional [S, 1, NB] bool (short-block group
    starts).  Returns books [S, ch, NB] int32."""
    nb = cost.shape[-2]
    dp = cost[..., 0, :] + sect_bits
    stayed, bestj = [], []
    for b in range(1, nb):
        best, bj = dp.min(-1, keepdim=True)
        new = best + sect_bits
        c_b, sel_b = cost[..., b, :], bandsel[..., b:b + 1]
        if force_break is None:
            st = dp <= new
            dp2 = c_b + torch.minimum(dp, new)
        else:
            fb_b = force_break[..., b:b + 1]
            st = (dp <= new) & ~fb_b
            dp2 = c_b + torch.where(fb_b, new, torch.minimum(dp, new))
        dp = torch.where(sel_b, dp2, dp)
        stayed.append(st)
        bestj.append(bj)
    k = dp.argmin(-1, keepdim=True)
    books = [None] * nb
    for b in range(nb - 1, 0, -1):
        books[b] = k
        k_prev = torch.where(stayed[b - 1].gather(-1, k), k, bestj[b - 1])
        k = torch.where(bandsel[..., b:b + 1], k_prev, k)
    books[0] = k
    return torch.cat(books, -1).to(torch.int32)


def _dpcm_chain_bits(member, values, first_cost=None):
    """Bit cost of a dpcm chain over `member` bands in band order:
    lenscf[delta+60] between consecutive members; the first member costs
    `first_cost` bits (None = lenscf[60], the global-gain reference)."""
    nb = member.shape[-1]
    idx = torch.arange(nb, device=member.device)
    prev_i = _shift_right(torch.where(member, idx, -1).cummax(-1).values, -1)
    v_prev = values.gather(-1, prev_i.clamp(min=0).expand(values.shape))
    delta = (values - v_prev).clamp(-60, 60)
    lens_t = const(_LEN_SCF, member.device)
    lens = lens_t[(delta + 60).long()]
    bits = torch.where(member & (prev_i >= 0), lens, 0).sum(-1, dtype=torch.int32)
    fc = int(_LEN_SCF[60]) if first_cost is None else first_cost
    return bits + torch.where(member.any(-1), fc, 0)


def side_info_bits(books, gains, bandsel, sect_hdr=SECT_BITS, force_break=None,
                   is_short=None):
    """Section + scalefactor-dpcm + fixed ICS bits for one channel's ICS.
    bandsel: [.., NB]; sect_hdr: int or per-stream [S, 1]; force_break:
    bands where a new section must start; is_short: [S, 1] bool selecting
    the 3-bit sect_len escape rule."""
    nb = books.shape[-1]
    books_m = torch.where(bandsel, books, -1)
    new_sect = (books_m != _shift_right(books_m, -2)) & bandsel
    if force_break is not None:
        new_sect = new_sect | (force_break & bandsel)
    sect_bits = new_sect.sum(-1, dtype=torch.int32) * sect_hdr
    # a run adds one escape field each time its length reaches the escape value
    idxs = torch.arange(nb, device=books.device)
    run_start = torch.where(new_sect, idxs, -1).cummax(-1).values
    d = idxs - run_start
    started = bandsel & (run_start >= 0)
    esc_l = (started & (d % 31 == 30)).sum(-1, dtype=torch.int32)
    if is_short is not None:
        esc_s = (started & (d % 7 == 6)).sum(-1, dtype=torch.int32)
        sect_bits = sect_bits + torch.where(is_short, 3 * esc_s, 5 * esc_l)
    else:
        sect_bits = sect_bits + 5 * esc_l
    # scalefactor dpcm over the non-zero spectral bands; PNS bands carry
    # their noise energies in a separate chain (9-bit PCM start)
    scf_bits = _dpcm_chain_bits((books_m > 0) & (books_m != PNS_HCB), gains)
    noise_bits = _dpcm_chain_bits(books_m == PNS_HCB, gains, first_cost=9)
    # global_gain(8) + pulse/tns/gain_control flags(3); ics_info by the caller
    return sect_bits + scf_bits + noise_bits + (8 + 3)


# ---- the rate-controlled AU --------------------------------------------------

class RateInputs:
    """What the rate loop reads of one AU of S stations of C channels, built
    at the end of the psy stage (`au_psy`); every tensor contiguous.

    per line, [S, C, 960]: mag075 (|spec|^0.75) and absx (|spec|), float;
      neg (spec < 0) and pns_line (the line's band is coded by PNS), bool.
    per band, [S, C, NB]: thr4, cap_thr, floor29, hole_rank, hole_thr, wgt
      (None without threshold weighting), log_ffak, scf_corr and thr, float;
      no_ah and pns_mask, bool; pns_nrg, int32.
    per station: bsel [S, 1, NB] bool (the coded bands); force_break
      [S, 1, NB] bool (short-block group starts), is_short [S] bool and
      sect_hdr [S] int32, or None, None and the int SECT_BITS where the
      encoder has no short blocks; tns_bits [S, C], elem_fixed [S] and
      budget_bits [S], integer.
    ladders: the encoder's line -> band indices, long and short ([960]
      each; short None without short blocks): is_short picks a station's.
    bctx: the BandCtx the plain version's band sums go through.
    """
    LINE = ("mag075", "absx", "neg", "pns_line")
    BAND = ("thr4", "cap_thr", "floor29", "hole_rank", "hole_thr", "wgt", "log_ffak",
            "scf_corr", "thr", "no_ah", "pns_mask", "pns_nrg")
    STATION = ("bsel", "force_break", "is_short", "sect_hdr", "tns_bits", "elem_fixed",
               "budget_bits")

    def __init__(self, bctx, ladders, **fields):
        self.bctx, self.ladders = bctx, ladders
        for k in self.LINE + self.BAND + self.STATION:
            v = fields.pop(k)
            setattr(self, k, v.contiguous() if isinstance(v, torch.Tensor) else v)
        if fields:
            raise TypeError(f"RateInputs: unknown fields {sorted(fields)}")

    def tensors(self):
        """{name: tensor} of every field that holds one."""
        return {k: getattr(self, k) for k in self.LINE + self.BAND + self.STATION
                if isinstance(getattr(self, k), torch.Tensor)}

    # the shapes the plain version's side-info count and DP broadcast with
    @property
    def sect_hdr_c(self):
        return self.sect_hdr[:, None] if self.is_short is not None else self.sect_hdr

    @property
    def is_short_c(self):
        return self.is_short[:, None] if self.is_short is not None else None


def au_psy(spec, pt, band_m, bol, max_sfb, budget_bits, n_ch, tns_cfg=None,
           short_ctx=None, is_short=None, modify_minsnr=True, pre_state=None, seq=None,
           weight_state=None):
    """The psy stage of one AU for all streams (encode_au's arguments less
    refine_rounds): TNS, thresholds, PNS, M/S, avoid-hole, weighting and the
    scalefactor-estimate correction.  Returns (RateInputs, dict of thr, en,
    en_pre, minsnr, ms_used, the TNS decisions and, with
    pre_state/weight_state, the carried thr_nm1, pre_flag and last_patch)."""
    S, n_ch_s, _ = spec.shape
    dtype, dev = spec.dtype, spec.device
    if short_ctx is None:
        is_short = None
    bctx = BandCtx(band_m, bol, short_ctx, is_short)
    ar = torch.arange(NB, device=dev)

    bandsel_l = ar < max_sfb[:, None]                                 # [S, NB]
    if short_ctx is not None:
        t1 = is_short[:, None]
        bandsel = torch.where(t1, short_ctx["bandsel"], bandsel_l)
        force_break = t1 & short_ctx["force_break"]
        sect_hdr = torch.where(is_short, SECT_BITS_SHORT, SECT_BITS)   # [S]
        nbands_tx = torch.where(is_short, short_ctx["nbands_tx"], max_sfb)
        ics_fixed = torch.where(is_short, 15, 11)   # short ics_info: +4-bit max_sfb +7 grouping
        is_short_b = is_short[:, None, None]
        pt_sel = {k: torch.where(is_short_b, short_ctx["pt"][k], pt[k])
                  for k in ("f_low", "f_high", "ath", "minsnr", "f_low_spr", "f_high_spr")}
        nlines = torch.where(t1, short_ctx["nlines"], band_m.sum(-1).clamp(min=1.0))[:, None]
    else:
        bandsel = bandsel_l
        force_break = None
        sect_hdr = SECT_BITS
        nbands_tx = max_sfb
        ics_fixed = 11
        is_short_b = torch.zeros((S, 1, 1), dtype=torch.bool, device=dev)
        pt_sel = pt
        nlines = band_m.sum(-1).clamp(min=1.0)

    # pre-TNS energies: the psy threshold source (fdk ordering); post-TNS
    # energies feed the minSnr caps and the MS/PNS decisions
    en_pre = bctx.energy(spec)

    # split-range TNS (aacenc_tns.cpp:440-452, 875-935), on L/R before M/S
    if tns_cfg is not None:
        start, mid, stop = tns_cfg["start_line"], tns_cfg["mid_line"], tns_cfg["stop_line"]
        t = tns_analysis_fdk(spec, start, mid, stop)
        if n_ch_s == 2:
            t = tns_sync(t)
        if is_short is not None:
            off = ~is_short[:, None]     # the TNS syntax here is long-window only
            t["en"], t["en_lo"], t["merged"] = \
                t["en"] & off, t["en_lo"] & off, t["merged"] & off
        spec = tns_filter_fdk(spec, t, start, mid, stop)
        tns = {k: t[k] for k in ("en", "order", "idx", "en_lo", "order_lo", "idx_lo")}
        tns["len"] = torch.where(t["merged"], tns_cfg["length_code_merged"],
                                 tns_cfg["length_code"]).to(torch.int32)
        # tns_data: n_filt 2 + coef_res 1, then per filter 6+5+1+1 + 4/coef
        tns_bits = (torch.where(tns["en"], 16 + 4 * tns["order"], 0)
                    + torch.where(tns["en_lo"], 13 + 4 * tns["order_lo"], 0))
    else:
        zi = torch.zeros((S, n_ch_s), dtype=torch.int32, device=dev)
        zb = zi.to(torch.bool)
        zidx = torch.zeros((S, n_ch_s, TNS_MAX_ORDER), dtype=torch.int32, device=dev)
        tns = dict(en=zb, order=zi, idx=zidx, en_lo=zb, order_lo=zi, idx_lo=zidx, len=zi)
        tns_bits = zi

    # psy on the L/R domain; thresholds from the PRE-TNS energies, not
    # clamped to the coded (post-TNS) energy: the elevation is the TNS
    # prediction gain, as in fdk (psy_main.cpp:702, 844-905)
    en = bctx.energy(spec)
    thr = spread_thresholds(en_pre, pt_sel, clamp_en=en_pre)
    pre_out = {}
    if pre_state is not None:
        thr, thr_nm1, pre_flag = pre_echo_control(thr, pre_state[0], pre_state[1], seq,
                                                  short_ctx, is_short)
        pre_out = dict(thr_nm1=thr_nm1, pre_flag=pre_flag)
    en_lr = en

    # PNS detection on the PRE-MS L/R spectra (psy_main.cpp:1144 before :1190)
    bsel_c = bandsel[:, None]                                       # [S, 1, NB]
    pns_start = pt.get("pns_start")
    if pns_start is not None:
        eligible = bsel_c & (ar >= pns_start) & ~is_short_b
        pns_mask, pns_nrg = pns_detect(spec, en, thr, bctx, eligible, pt.get("pns_tabs"))
    else:
        pns_mask = torch.zeros(en.shape, dtype=torch.bool, device=dev)
        pns_nrg = torch.zeros(en.shape, dtype=torch.int32, device=dev)

    ms_used = torch.zeros((S, NB), dtype=torch.bool, device=dev)
    if n_ch_s == 2:
        # normalized noise correlation (PreProcessPnsChannelPair:441-480)
        ccf = bctx.reduce_f(spec[:, 0] * spec[:, 1]) / torch.sqrt(
            (en[:, 0] * en[:, 1]).clamp(min=1e-20))
        spec, en, thr, ms_used = ms_stereo(spec, en, thr, bctx, bandsel)
        # PNS/MS reconciliation (PostProcessPnsChannelPair:498-541)
        pair = pns_mask[:, 0] & pns_mask[:, 1]
        pns_mask = pns_mask & ~(ms_used & ~pair)[:, None]
        ms_used = torch.where(pair, ccf > 0.36, ms_used)
    # CPE: +1 common_window, +2 ms_mask_present, + per-band ms_used bits
    elem_fixed = torch.where(n_ch == 2, 3 + 4 + 1 + 2 + ics_fixed + nbands_tx,
                             3 + 4 + ics_fixed)

    # ---- avoid-hole machinery (adj_thr.cpp initAvoidHoleFlag/adaptMinSnr)
    spr_en = spread_energy(en_lr, pt_sel["f_low_spr"], pt_sel["f_high_spr"])
    if short_ctx is not None:
        spr_en = spr_en * _where_f(is_short_b, 0.63, 0.5, en)   # -3 dB long / -2 dB short
        grp_start = torch.where(is_short_b, short_ctx["grp_start"], ar == 0)
        grp_end = is_short_b & short_ctx["grp_end"]
    else:
        spr_en = spr_en * 0.5
        grp_start = ar == 0
        grp_end = torch.zeros(NB, dtype=torch.bool, device=dev)
    minsnr = pt_sel["minsnr"].expand(en.shape)
    minsnr = adapt_min_snr(minsnr, en, bsel_c)
    if modify_minsnr:
        minsnr = modify_min_snr(minsnr, en, bsel_c, grp_start, grp_end, is_short_b)
    if n_ch_s == 2:
        minsnr, spr_en = ms_adapt_min_snr(minsnr, en, spr_en, ms_used)
    no_ah = (spr_en > en) | (minsnr > 1.0)
    ffak = bctx.reduce_f(torch.sqrt(spec.abs()))
    log_ffak = _log10(ffak.clamp(min=1e-30))

    # ---- threshold weighting (calcWeighting): the reduction loop and the
    # caps below run in the weighted domain (adj_thr.cpp:905-941)
    w_out, wgt = {}, None
    en_w, thr_w = en, thr
    if weight_state is not None:
        wgt, last_patch = calc_weighting(en, thr, ffak, nlines, bsel_c, is_short,
                                         weight_state, ms_used)
        en_w, thr_w = en / wgt, thr / wgt
        w_out = dict(last_patch=last_patch)
    cap_thr = torch.maximum(en_w * minsnr, thr_w)
    floor29 = en_w * 10.0 ** -2.9
    thr4 = torch.pow(thr_w.clamp(min=1e-30), 0.25)

    # ---- allowMoreHoles priority (adj_thr.cpp:1690-1930): past HOLE_O the
    # offset erases whole bands, lowest (pre-TNS) energy first and from the
    # highest sfb down, never below startSfb (15 long / 3 per short group)
    pos = ar.expand(1, 1, NB)
    start_b = 15 if modify_minsnr else 0
    if short_ctx is not None:
        pos = torch.where(is_short_b, ar % short_ctx["nsfb"], pos)
        start_b = torch.where(is_short_b, 3 if modify_minsnr else 0, start_b)
    hole_cand = bsel_c & ~no_ah & (en_w > thr_w) & (pos >= start_b)
    en_hole = torch.maximum(en, en_pre)
    ld_en = _log2(en_hole.clamp(min=1e-30))
    mn = torch.where(hole_cand, ld_en, 1e30).amin((-2, -1), keepdim=True)
    n_cand = hole_cand.sum((-2, -1), keepdim=True).clamp(min=1)
    avg = _log2((torch.where(hole_cand, en_hole, 0.0).sum((-2, -1), keepdim=True)
                 / n_cand).clamp(min=1e-30))
    borders = mn[..., None] + (avg - mn)[..., None] * _tensor(_HOLE_FR, en)
    k0 = (ld_en[..., None] > borders).sum(-1)                        # [S, ch, NB] 0..8
    # ranks 0..NB-1 are the MS quieter-channel holes (opened first)
    hole_rank = torch.where(hole_cand & (k0 < 8), NB + k0 * NB + (NB - 1 - pos), 1 << 20)
    if n_ch_s == 2:
        en0, en1 = en_w[:, 0], en_w[:, 1]
        quiet1 = en1 <= en0
        en_q, en_l = torch.where(quiet1, en1, en0), torch.where(quiet1, en0, en1)
        msnr_l = torch.where(quiet1, minsnr[:, 0], minsnr[:, 1])
        pref = ms_used & (en_q < 0.4 * msnr_l * en_l)
        pref_c = pref[:, None, :] & (torch.arange(2, device=dev)[None, :, None]
                                     == quiet1.long()[:, None, :])
        hole_rank = torch.where(hole_cand & pref_c, NB - 1 - pos, hole_rank)
    hole_rank_f = hole_rank.to(dtype)
    hole_thr = 2.0 * en_w
    # (the reference's region-B reduceMinSnr path opens at offset 10000 and
    # its sub-demand o < 0 branch below O_LO = 0: neither is reachable from
    # the offset range [0, 63], so neither is ported)

    mag075 = torch.pow(spec.abs(), 0.75)
    neg = spec < 0
    pns_line = bctx.to_lines(pns_mask)

    # ---- scalefactor-estimate correction (FDKaacEnc_improveScf): probe at
    # the threshold target, measure the real distortion, fold the bias in
    spec_abs0 = spec.abs()
    log_thr = _log10(thr.clamp(min=1e-30))
    scf_thr = 8.8585 * (_log10(6.75 * thr) - log_ffak)

    def band_dist(gains):
        gf = gains.to(dtype)
        qq = torch.floor(mag075 * bctx.to_lines(_exp2(-0.1875 * gf))
                         + 0.4054).clamp(0.0, 8191.0)
        deq = torch.pow(qq, 4.0 / 3.0) * bctx.to_lines(_exp2(0.25 * gf))
        return bctx.reduce_f((spec_abs0 - deq) ** 2)

    scf_corr = torch.zeros(en.shape, dtype=dtype, device=dev)
    for _ in range(2):
        dist = band_dist(_floor_int(scf_thr + scf_corr, -100, 155))
        # one-directional: only lower scfs whose distortion overshoots
        scf_corr = (scf_corr + torch.round(8.8585 * (log_thr - _log10(
            dist.clamp(min=1e-30))))).clamp(-16.0, 0.0)

    inp = RateInputs(
        bctx, (bol, short_ctx["bol"] if short_ctx is not None else None),
        mag075=mag075, absx=spec_abs0, neg=neg, pns_line=pns_line,
        thr4=thr4, cap_thr=cap_thr, floor29=floor29, hole_rank=hole_rank_f,
        hole_thr=hole_thr, wgt=wgt, log_ffak=log_ffak, scf_corr=scf_corr, thr=thr,
        no_ah=no_ah, pns_mask=pns_mask, pns_nrg=pns_nrg,
        bsel=bsel_c, force_break=force_break[:, None] if force_break is not None else None,
        is_short=is_short, sect_hdr=sect_hdr, tns_bits=tns_bits, elem_fixed=elem_fixed,
        budget_bits=budget_bits)
    return inp, dict(thr=thr, en=en, en_pre=en_pre, minsnr=minsnr, ms_used=ms_used,
                     tns_en=tns["en"], tns_order=tns["order"], tns_idx=tns["idx"],
                     tns_en_lo=tns["en_lo"], tns_order_lo=tns["order_lo"],
                     tns_idx_lo=tns["idx_lo"], tns_len=tns["len"], **pre_out, **w_out)


def count_for_gains(inp, gains, use_dp=True, keep=None):
    """Quantize + exact bit count at explicit per-band gains.  With use_dp
    the sectioning DP finds jointly optimal codebooks; without it the
    per-band argmin of the odd books is a safe upper bound.  keep: optional
    [S, ch, NB] bool - bands outside it are zeroed (crash recovery).
    Returns (total, q, books, g_tx, bbits)."""
    bctx, bsel_c, fb_c = inp.bctx, inp.bsel, inp.force_break
    scale = bctx.to_lines(_exp2(-0.1875 * gains.to(inp.mag075.dtype)))
    q = (inp.mag075 * scale + 0.4054).floor().clamp(0, 8191).to(torch.int32)
    q = torch.where(inp.neg, -q, q)
    q = torch.where(inp.pns_line, 0, q)                 # no spectral data for PNS
    pns_eff = inp.pns_mask
    if keep is not None:
        q = torch.where(bctx.to_lines(keep), q, 0)
        pns_eff = inp.pns_mask & keep
    if use_dp:
        cost = spectral_bits_and_books(q, bctx, bsel_c, return_cost=True)
        sb = inp.sect_hdr_c[..., None] if inp.is_short is not None else SECT_BITS
        books = optimal_books(cost, bsel_c & ~pns_eff, sect_bits=sb, force_break=fb_c)
        bbits = cost.gather(-1, books.long()[..., None])[..., 0]
        books = torch.where(bsel_c, books, 0)
        bbits = torch.where(bsel_c, bbits, 0)
    else:
        books, bbits = spectral_bits_and_books(q, bctx, bsel_c, fast=True)
    books = torch.where(pns_eff, PNS_HCB, books)
    bbits = torch.where(pns_eff, 0, bbits)
    # all-zero bands may still get a book > 0 from the DP, so their scf
    # enters the dpcm chain: clamp those into the nonzero bands' window
    nzb = bctx.bsum((q != 0).to(torch.int32)[..., None], 1)[..., 0] > 0
    gmax_nz = torch.where(nzb, gains, -100).amax(-1, keepdim=True)
    gmax_nz = torch.where(nzb.any(-1, keepdim=True), gmax_nz, 100)
    g_safe = torch.minimum(torch.maximum(gains, gmax_nz - 60), gmax_nz)
    g_tx = torch.where(pns_eff, inp.pns_nrg, torch.where(nzb, gains, g_safe))
    side = side_info_bits(books, g_tx, bsel_c, sect_hdr=inp.sect_hdr_c,
                          force_break=fb_c, is_short=inp.is_short_c)
    ch_bits = bbits.sum(-1) + side + inp.tns_bits
    total = ch_bits.sum(-1) + inp.elem_fixed + 3 + 7      # + ID_END + byte-align worst case
    return total, q, books, g_tx, bbits


def try_offset(inp, o, use_dp=True):
    """Threshold-reduction step (reduceThresholdsCBR, adj_thr.cpp:
    988-1053): thr_red = (thr^1/4 + 2^(o/2))^4, capped at en*minSnr on
    avoid-hole bands, floored at en-29dB; holes and spill past their
    offsets.  o: [S] offsets."""
    o = o.to(inp.mag075.dtype)[:, None, None]
    thr_red = torch.pow(inp.thr4 + _exp2(0.5 * o), 4.0)
    thr_red = torch.where(inp.no_ah, thr_red, torch.minimum(thr_red, inp.cap_thr))
    thr_red = torch.maximum(thr_red, inp.floor29)
    hole = inp.hole_rank < (o - HOLE_O) * HOLE_RATE
    thr_red = torch.where(hole, torch.maximum(thr_red, inp.hole_thr), thr_red)
    if inp.wgt is not None:
        thr_red = thr_red * inp.wgt          # un-weight (adj_thr.cpp:2888-2899)
    spill = (o - SPILL_O).clamp(min=0.0)
    scf = torch.floor(8.8585 * (_log10(6.75 * thr_red) - inp.log_ffak) + inp.scf_corr + spill)
    # padded/inactive bands carry huge thresholds: exclude them before
    # the window clamp
    gains = torch.where(inp.bsel, scf.clamp(-100, 155).to(torch.int32), -100)
    gmax = gains.amax(-1, keepdim=True)
    gains = torch.minimum(torch.maximum(gains, gmax - 60), gmax)
    total, q, books, g_tx, _ = count_for_gains(inp, gains, use_dp)
    return total, q, g_tx, books


def rate_loop_plain(inp, refine_rounds=REFINE_ROUNDS):
    """The rate loop in PyTorch: the bisect of the reduction offset, the
    final DP count and the afterburner.  Returns (q [S,C,960], gains
    [S,C,NB] (the transmitted values: scalefactors on spectral bands, noise
    energies on PNS bands), books [S,C,NB], bits [S])."""
    budget_bits = inp.budget_bits
    dtype = inp.mag075.dtype
    # bisect the reduction exponent (bits(o) is monotone non-increasing in
    # o): the smallest fitting integer offset, then a fractional bisect over
    # (hi-1, hi]; the final DP count never exceeds the upper-bound count
    with obs.span("dabplus.rate.bisect"):
        lo = torch.full_like(budget_bits, O_LO)
        hi = torch.full_like(budget_bits, O_HI)
        for _ in range(BISECT_STEPS):
            mid = (lo + hi) // 2
            fit = try_offset(inp, mid, use_dp=False)[0] <= budget_bits
            lo, hi = torch.where(fit, lo, mid + 1), torch.where(fit, mid, hi)
        fhi = hi.to(dtype)
        flo = (fhi - 1.0).clamp(min=float(O_LO))
        for _ in range(FRAC_BISECT_STEPS):
            fmid = 0.5 * (flo + fhi)
            fit = try_offset(inp, fmid, use_dp=False)[0] <= budget_bits
            flo, fhi = torch.where(fit, flo, fmid), torch.where(fit, fmid, fhi)
    with obs.span("dabplus.rate.final"):
        bits, q, gains, books = try_offset(inp, fhi)

    # afterburner refinement: one gain step down on the worst-NMR bands,
    # kept only while the AU still fits
    with obs.span("dabplus.rate.refine"):
        bctx, bsel_c = inp.bctx, inp.bsel
        x_abs = inp.absx
        thr_f = inp.thr.clamp(min=1e-10)
        for _ in range(refine_rounds):
            deq = torch.pow(q.abs().to(dtype), 4.0 / 3.0) * bctx.to_lines(
                _exp2(0.25 * gains.to(dtype)))
            nmr = bctx.reduce_f((x_abs - deq) ** 2) / thr_f
            can = bsel_c & (gains > gains.amax(-1, keepdim=True) - 60)
            nmr = torch.where(can, nmr, -torch.inf)
            # lax.top_k order: a stable descending sort puts the lower index first among ties
            ti = torch.sort(nmr, stable=True, dim=-1, descending=True).indices[..., :REFINE_BANDS]
            dec = torch.zeros_like(gains).scatter_(-1, ti, 1)
            gains2 = torch.where(inp.pns_mask, gains, gains - dec)
            total2, q2, books2, gains2, _ = count_for_gains(inp, gains2)
            ok = (total2 <= budget_bits)[:, None, None]
            q, gains, books = torch.where(ok, q2, q), torch.where(ok, gains2, gains), \
                torch.where(ok, books2, books)
            bits = torch.where(ok[:, 0, 0], total2, bits)
    return q, gains, books, bits


def rate_loop(inp, refine_rounds=REFINE_ROUNDS):
    """The rate loop of one AU (see rate_loop_plain).  CPU tensors take the
    plain version; CUDA tensors the hand-written kernel (one launch, one
    block per station; rate_kernel.py), which raises on what it does not
    take.  Returns (q, gains, books, bits) in the plain version's dtypes."""
    dev = inp.mag075.device
    if dev.type == "cpu":
        return rate_loop_plain(inp, refine_rounds)
    if dev.type != "cuda":
        raise ValueError(f"rate_loop: tensors on {dev}; the CPU or a CUDA card")
    with obs.span("dabplus.rate.kernel") as sp:
        sp.add("aus", 1)
        return rate_kernel.rate_loop(inp, refine_rounds, _RATE_TABLE, _RATE_PARAMS)


def encode_au(spec, pt, band_m, bol, max_sfb, budget_bits, n_ch, tns_cfg=None,
              short_ctx=None, is_short=None, refine_rounds=REFINE_ROUNDS,
              modify_minsnr=True, pre_state=None, seq=None, weight_state=None):
    """Rate-controlled quantization of one AU for all streams.

    spec: [S, ch, 960] (window-major [8x120] for short-block streams);
    pt: band tables (f_low, f_high, ath, minsnr, f_low_spr, f_high_spr
    [NB], optional pns_start int and pns_tabs); max_sfb, budget_bits, n_ch:
    [S]; short_ctx: the encoder's short-block tables; is_short: [S] bool.
    Returns dict(q [S,ch,960], gains, books [S,ch,NB], bits [S], ms_used
    [S,NB], the TNS decisions, thr, en, en_pre, minsnr, recovered (a Python
    bool: whether crash recovery ran) and, with pre_state/weight_state, the
    carried thr_nm1, pre_flag and last_patch)."""
    with obs.span("dabplus.psy"):
        inp, out = au_psy(spec, pt, band_m, bol, max_sfb, budget_bits, n_ch, tns_cfg=tns_cfg,
                          short_ctx=short_ctx, is_short=is_short,
                          modify_minsnr=modify_minsnr, pre_state=pre_state, seq=seq,
                          weight_state=weight_state)
    q, gains, books, bits = rate_loop(inp, refine_rounds)

    # per-stream crash recovery (FDKaacEnc_crashRecovery, qc_main.cpp:1149,
    # 1398): a stream still over its budget loses spectral bands from the top
    # sfb down (both channels), falling back to the all-zero AU.  The check
    # is one host sync per AU; the recount runs only when a stream is over.
    with obs.span("dabplus.recover.sync"):
        recovered = bool((bits > budget_bits).any())
    if recovered:
        with obs.span("dabplus.rate.recover"):
            q, gains, books, bits = _recover(inp, q, gains, books, bits)
    return dict(q=q, gains=gains, books=books, bits=bits, recovered=recovered, **out)


def _recover(inp, q, gains, books, bits):
    budget_bits = inp.budget_bits
    over = bits > budget_bits
    t_full, _, _, _, bb = count_for_gains(inp, gains)
    bb_t = bb.sum(-2)                                         # [S, NB]
    cs = bb_t.flip(-1).cumsum(-1).flip(-1)
    cs = torch.cat([cs, torch.zeros_like(cs[..., :1])], -1)   # [S, NB+1]
    fit = (t_full[:, None] - cs + 64) <= budget_bits[:, None]
    k_est = (fit.sum(-1) - 1).clamp(min=0)
    keep_n = torch.where(over, k_est, NB)
    ar = torch.arange(NB, device=q.device)
    keep = ar[None, None, :] < keep_n[:, None, None]
    t1_, q1, books1, g1, _ = count_for_gains(inp, gains, keep=keep)
    books_z = torch.zeros_like(books1)
    g_z = torch.zeros_like(g1)
    side_z = side_info_bits(books_z, g_z, inp.bsel, sect_hdr=inp.sect_hdr_c,
                            force_break=inp.force_break, is_short=inp.is_short_c)
    t_z = (side_z + inp.tns_bits).sum(-1) + inp.elem_fixed + 3 + 7
    use_zero = t1_ > budget_bits
    uz = use_zero[:, None, None]
    q1, g1, books1 = torch.where(uz, 0, q1), torch.where(uz, g_z, g1), \
        torch.where(uz, books_z, books1)
    t1_ = torch.where(use_zero, t_z, t1_)
    ov = over[:, None, None]
    q, gains, books = torch.where(ov, q1, q), torch.where(ov, g1, gains), \
        torch.where(ov, books1, books)
    bits = torch.where(over, t1_, bits)
    return q, gains, books, bits
