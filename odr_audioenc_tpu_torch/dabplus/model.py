"""Batched DAB+ encoder: per-stream config, carried state, the superframe
step and the host packing glue (port of odr_audioenc_tpu/dabplus/model.py):
AAC-LC, HE-AAC (SBR) and HE-AAC v2 (PS).

One step advances S streams by one superframe (num_aus AUs of 960 core
samples): block switching on the undelayed input; for HE-AAC v2 the PS
parameters and the energy-compensated mono downmix; for HE-AAC the SBR side
analysis of the delayed full-rate stream, its payload size and the
2:1 decimation to the core rate; then per AU the switched MDCT and the
rate-controlled quantization of encode.encode_au, carrying the bit
reservoir, the pre-echo history and the weighting flag from AU to AU.  The
integer decisions go to the port's host packer (host/: the native batch
packer, or the Python AU writer) exactly as the JAX encoder's do; with
pack_on_device=True the step packs every AU, the superframe, its CRCs and
the RS parity itself (aupack.py) and returns the wire bytes as one tensor.
"""
import sys
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import convert, obs
from ..device import default_device, default_dtype
from ..host import native
from ..host.aacpack import SuperframePacker, write_au, write_dse
from . import aupack
from . import blockswitch as BS
from . import encode as E
from . import sbr as SBR
from . import tables as AT

# Full-rate samples the decoder's SBR envelope application leads the decoded
# core by: the envelope of AU n is measured over core samples
# [n*au - SBR_SHIFT, (n+1)*au - SBR_SHIFT), the span whose patch the decoder
# scales with it.
SBR_SHIFT = 2304
# PS parameter application span lead (SBR_SHIFT - au/2: the decoder
# interpolates each parameter set from the previous one across the span)
PS_SHIFT = 1344
DS_TAPS = 127          # the half-band decimator's length


@dataclass
class DabPlusConfig:
    sample_rate: int
    subch: int           # subchannel index = bitrate / 8000
    channels: int
    aot: str = "lc"      # "lc" (AAC-LC) | "sbr" (HE-AAC) | "ps" (HE-AAC v2)
    pad_len: int = 0     # max X-PAD bytes per AU (DSE ancillary data)
    bandwidth: int = 0   # -B core-coder bandwidth override in Hz
    afterburner: bool = True  # -A disables: no quantization refinement rounds

    @property
    def has_sbr(self):
        return self.aot in ("sbr", "ps")

    @property
    def num_aus(self):
        return self.sample_rate // (16000 if self.has_sbr else 8000)

    @property
    def au_samples(self):
        """full-rate samples per AU."""
        return 1920 if self.has_sbr else 960

    @property
    def core_rate(self):
        return self.sample_rate // 2 if self.has_sbr else self.sample_rate

    @property
    def bitrate(self):
        return self.subch * 8000


# CBR bandwidth table for 960/1024 frames (bandwidth.cpp:114-118,
# GetBandwidthEntry: bracket entry, no interpolation at 960):
# (bitrate per channel, mono Hz, stereo Hz)
_BW_TAB = [(0, 3700, 5000), (12000, 5000, 6400), (20000, 6900, 9640),
           (28000, 9600, 13050), (40000, 12060, 14260), (56000, 13950, 15500),
           (72000, 14200, 16120), (96000, 17000, 17000), (576001, 17000, 17000)]
# tns_max_bands_tbl (aac_rom.cpp:3179)
_TNS_MAX = {96000: 31, 88200: 31, 64000: 34, 48000: 40, 44100: 42,
            32000: 51, 24000: 46, 22050: 46, 16000: 42}
_PT_KEYS = ("f_low", "f_high", "ath", "minsnr", "f_low_spr", "f_high_spr")
_SHORT_KEYS = ("band_m", "bol", "bandsel", "force_break", "grp_start", "grp_end",
               "prev_grp_map", "g1_mask", "nlines")
_PNS_KEYS = ("qmask", "curve", "width_ok", "ton_thresh")


class DabPlusEncoder(nn.Module):
    """One instance per homogeneous stream batch (same rate, channels and
    bitrate).  The transform bases and band tables are registered buffers."""

    def __init__(self, cfg: DabPlusConfig, n_streams=1, dtype=None, device=None,
                 pack_on_device=False):
        """device: the card by default (device.default_device raises where
        there is none; the CPU takes device="cpu").  dtype: float64 (the
        exact path) or float32; defaults by device (device.default_dtype).
        pack_on_device: the step emits the packed superframes (one `wire`
        output) in place of the decisions for the host packer."""
        super().__init__()
        if cfg.aot not in ("lc", "sbr", "ps"):
            raise ValueError(f"unknown aot {cfg.aot!r}")
        self.is_sbr = cfg.has_sbr
        self.is_ps = cfg.aot == "ps"
        if self.is_ps and cfg.channels != 2:
            raise ValueError("HE-AAC v2 (PS) requires stereo input")
        device = torch.device(device) if device is not None else default_device()
        dtype = dtype if dtype is not None else default_dtype(device)
        self.cfg = cfg
        self.S = n_streams
        self.dtype = dtype
        # PS downmixes to mono; plain SBR keeps the channel count (stereo
        # SBR = CPE core + sbr_channel_pair_element)
        self.core_channels = 1 if self.is_ps else cfg.channels
        self.ps_nenv = SBR.ps_num_env(cfg.bitrate) if self.is_ps else 0
        self.recover_checks = 0     # host syncs of the crash-recovery check (one per AU)
        self.recoveries = 0         # AUs where crash recovery ran
        rate = cfg.core_rate

        def buf(name, arr, dt=dtype):
            t = torch.as_tensor(np.asarray(arr), device=device)
            self.register_buffer(name, t.to(dt) if dt is not None else t)

        buf("cos_basis", AT.long_cos_basis())
        buf("wvecs", AT.window_vectors())
        buf("short_basis", AT.short_cos_basis())
        band_m = AT.band_matrix(rate)
        buf("band_m", band_m)
        buf("bol", AT.band_of_line(rate).astype(np.int64), None)
        pt_np = AT.band_psy_tables(rate)
        self.nbands = pt_np["nbands"]
        # avoid-hole tables: bitrate-aware minimum-SNR ladder + spread-energy
        # slopes (adj_thr.cpp / psy_configuration.cpp)
        ch_bitrate = cfg.bitrate // (1 if self.is_ps else cfg.channels)
        self.modify_minsnr = ch_bitrate >= 20000
        spr_np = AT.spread_energy_tables(rate, ch_bitrate)
        pt_np.update(minsnr=AT.min_snr_ladder(ch_bitrate, rate),
                     f_low_spr=spr_np["f_low"], f_high_spr=spr_np["f_high"])
        for k in _PT_KEYS:
            buf("pt_" + k, pt_np[k])
        self.sfb_off = AT.sfb_offsets(rate)
        self.sfb_off_short = AT.sfb_short_offsets(rate)
        self.nsfb_short = len(self.sfb_off_short) - 1

        br_per_ch = cfg.bitrate / cfg.channels
        if self.is_sbr:
            self.sbr_params = SBR.SbrParams(cfg.sample_rate, bitrate=cfg.bitrate,
                                            channels=self.core_channels)
            bw_hz = self.sbr_params.k0 * self.sbr_params.band_hz   # the crossover
            for k, v in SBR.side_tables(self.sbr_params, dtype, device).items():
                self.register_buffer("sbr_" + k, v)
            # 127-tap Kaiser(12) half-band for the 2:1 decimation (~-119 dB stopband)
            n = np.arange(DS_TAPS) - (DS_TAPS - 1) / 2
            buf("ds_filter", np.sinc(n / 2.0) / 2.0 * np.kaiser(DS_TAPS, 12.0))
            if self.is_ps:
                sub = cfg.au_samples // self.ps_nenv
                buf("ps_win", np.hanning(sub))
                buf("ps_masks", SBR.ps_band_masks(sub, cfg.sample_rate))
        else:
            self.sbr_params = None
            # bandwidth limit by per-channel bitrate (bandwidth.cpp analogue)
            col = 1 if cfg.channels == 1 else 2
            bw_hz = _BW_TAB[0][col]
            for i in range(len(_BW_TAB) - 1):
                if _BW_TAB[i][0] <= br_per_ch < _BW_TAB[i + 1][0]:
                    bw_hz = _BW_TAB[i][col]
                    break
            bw_hz = min(float(bw_hz), rate * 0.5)
        if cfg.bandwidth > 0:
            bw_hz = min(float(cfg.bandwidth), rate * 0.5)
        self.max_sfb = int(np.searchsorted(self.sfb_off * rate / (2 * AT.N), bw_hz)) - 1
        self.max_sfb = max(4, min(self.max_sfb, self.nbands))

        # PNS by per-channel bitrate (pnsparam.cpp:354-404: refPower 0.05 for
        # 28-48 kbps/ch, 0.20 at 48; off otherwise)
        ref_power = 0.05 if 28000 <= br_per_ch < 48000 else (0.20 if br_per_ch == 48000 else None)
        self.pns_start = None
        if ref_power is not None:
            self.pns_start = int(np.searchsorted(self.sfb_off * rate / (2 * AT.N), 4100.0))
            widths = np.diff(self.sfb_off)
            qmask = np.zeros((4, AT.N), np.float32)
            for b in range(len(widths)):
                lo, k = self.sfb_off[b], widths[b] // 4
                for qq in range(4):
                    qmask[qq, lo + qq * k: lo + (qq + 1) * k] = 1.0
            # built in float32 and then cast, as the JAX encoder does
            curve = np.full(E.NB, 1e30, np.float32)
            curve[:len(widths)] = ref_power ** (widths / 32.0)
            width_ok = np.zeros(E.NB, bool)
            width_ok[:len(widths)] = widths >= 16            # minSfbWidth (long)
            buf("pns_qmask", qmask)
            buf("pns_curve", curve)
            buf("pns_width_ok", width_ok, None)
            # refTonality 0.10: noise-like iff the chaos ratio > 10^-0.10
            buf("pns_ton_thresh", 10.0 ** -0.10)

        # short-block context: the grouped {4,4} band ladder
        self.max_sfb_short = int(np.searchsorted(self.sfb_off_short * rate / (2 * AT.NS),
                                                 bw_hz)) - 1
        self.max_sfb_short = max(2, min(self.max_sfb_short, self.nsfb_short))
        nsfb, msfb = self.nsfb_short, self.max_sfb_short
        nbb = AT.N_GROUPS * nsfb
        idxs = np.arange(E.NB)
        band_m_s = AT.short_band_matrix(rate)
        for m in (band_m, band_m_s):
            if not (m.sum(0) == 1).all():
                raise ValueError(f"the sfb ladder at {rate} Hz does not cover every line once")
        pt_s_np = AT.short_band_psy_tables(rate)
        spr_s_np = AT.spread_energy_tables(rate, ch_bitrate, short=True)
        pt_s_np.update(minsnr=AT.min_snr_ladder(ch_bitrate, rate, short=True),
                       f_low_spr=spr_s_np["f_low"], f_high_spr=spr_s_np["f_high"])
        for k in _PT_KEYS:
            buf("ptS_" + k, pt_s_np[k])
        short_np = {
            "band_m": band_m_s,
            "bol": AT.short_band_of_line(rate).astype(np.int64),
            "bandsel": (idxs < nbb) & (idxs % nsfb < msfb),
            "force_break": (idxs % nsfb == 0) & (idxs > 0) & (idxs < nbb),
            "grp_start": idxs % nsfb == 0,
            "grp_end": idxs % nsfb == nsfb - 1,
            # pre-echo control swap map between the two groups' positions
            "prev_grp_map": np.where(idxs < nsfb, idxs + nsfb,
                                     np.where(idxs < 2 * nsfb, idxs - nsfb, idxs)),
            "g1_mask": idxs < nsfb,
            "nlines": np.maximum(band_m_s.sum(-1), 1.0),
        }
        for k in _SHORT_KEYS:
            arr = short_np[k]
            buf("sc_" + k, arr, dtype if arr.dtype.kind == "f" else None)
        self.nbands_tx_short = AT.N_GROUPS * msfb

        # TNS static config (aacenc_tns.cpp:434-445; decoder aacdec_tns.cpp:180-348)
        start_band = 2 if rate < 9391 else (4 if rate < 18783 else 8)
        stop_band = min(self.nbands, _TNS_MAX.get(rate, 40), self.max_sfb)
        self.tns_cfg = None
        if stop_band - start_band >= 4:
            mid_target = (self.sfb_off[start_band]
                          + (self.sfb_off[stop_band] - self.sfb_off[start_band]) // 4)
            mid_band = stop_band
            while mid_band > start_band + 1 and self.sfb_off[mid_band] > mid_target:
                mid_band -= 1
            self.tns_cfg = {
                "start_line": int(self.sfb_off[start_band]),
                "mid_line": int(self.sfb_off[mid_band]),
                "stop_line": int(self.sfb_off[stop_band]),
                "length_code": self.nbands - mid_band,
                "length_code_lo": mid_band - start_band,
                "length_code_merged": self.nbands - start_band,
            }
        self.packer = SuperframePacker(cfg.subch, cfg.sample_rate, self.core_channels,
                                       sbr=self.is_sbr, ps=self.is_ps)
        # the superframe is a hard byte budget; a 1/16 slice of every AU's
        # share is withheld as the cross-superframe reservoir (FIL when unused).
        # The SBR FIL element of every AU is counted on the device
        # (sbr.payload_bits) and taken from the superframe's core budget.
        pad_bits = (cfg.pad_len + 3) * 8 if cfg.pad_len else 0
        base_au = self.packer.payload_bits() // cfg.num_aus - pad_bits
        reserve_au = base_au // 16
        self.budget_au = base_au - reserve_au
        self.bitres_max = reserve_au * cfg.num_aus
        # the device pack's tables, built once on the encoder's device (its
        # construction checks the pack bound against the worst recovered AU)
        self.aupack_ctx = aupack.AuPackCtx(self) if pack_on_device else None

    @property
    def device(self):
        return self.cos_basis.device

    def tables(self):
        """(pt, short_ctx) dicts for encode.encode_au, over the buffers."""
        pt = {k: getattr(self, "pt_" + k) for k in _PT_KEYS}
        if self.pns_start is not None:
            pt["pns_start"] = self.pns_start
            pt["pns_tabs"] = {k: getattr(self, "pns_" + k) for k in _PNS_KEYS}
        short_ctx = {k: getattr(self, "sc_" + k) for k in _SHORT_KEYS}
        short_ctx["pt"] = {k: getattr(self, "ptS_" + k) for k in _PT_KEYS}
        short_ctx["nbands_tx"] = self.nbands_tx_short
        short_ctx["nsfb"] = self.nsfb_short
        return pt, short_ctx

    def init_state(self):
        S, ch, dt, dev = self.S, self.core_channels, self.dtype, self.device
        st = {"prev": torch.zeros((S, ch, AT.N), dtype=dt, device=dev),
              "pend": torch.zeros((S, self.cfg.channels, self.cfg.au_samples), dtype=dt,
                                  device=dev),
              "bitres": torch.zeros((S,), dtype=torch.int32, device=dev),
              # pre-echo control history and its skip flag
              "thr_nm1": torch.full((S, ch, E.NB), 1e30, dtype=dt, device=dev),
              "pre_flag": torch.zeros((S,), dtype=torch.bool, device=dev),
              # calcWeighting's per-channel lastEnFacPatch
              "wgt_last": torch.zeros((S, ch), dtype=torch.bool, device=dev)}
        if self.is_sbr:
            # decimator, QMF and SBR-delay histories of the (downmixed) stream
            st["ds_hist"] = torch.zeros((S, ch, DS_TAPS - 1), dtype=dt, device=dev)
            st["qmf_hist"] = torch.zeros((S, ch, 576), dtype=dt, device=dev)
            st["sbr_hist"] = torch.zeros((S, ch, SBR_SHIFT), dtype=dt, device=dev)
        if self.is_ps:
            st["ps_hist"] = torch.zeros((S, 2, PS_SHIFT), dtype=dt, device=dev)
        st.update(BS.init_state(S, self.cfg.channels, dt, dev))
        return st

    def sbr_tables(self):
        """The side_tables of sbr_side_analysis, over the buffers."""
        return {k: getattr(self, "sbr_" + k)
                for k in ("qmf", "bh", "bn", "bmax", "sbr_mask", "patch_src")}

    def _ps_analysis(self, x, state):
        """HE-AAC v2: the IID/ICC parameters of each AU's application span
        (PS_SHIFT ahead of the coded AU, ps_nenv sub-windows) and the
        energy-compensated mono downmix.  x: [S, 2, n] delayed stream.
        Returns (mono [S, 1, n], state', PS outputs [S, nau, ...])."""
        S, _, n = x.shape
        nau, ne = self.cfg.num_aus, self.ps_nenv
        x_ps = torch.cat([state["ps_hist"], x[..., :-PS_SHIFT]], -1)
        state = dict(state, ps_hist=x[..., -PS_SHIFT:])
        aus = x_ps.reshape(S, 2, nau, ne, n // (nau * ne)).permute(2, 0, 3, 1, 4)
        with obs.span("dabplus.ps.iid"):
            iid, icc, iid_fine, use_fine = SBR.iid_parameters(
                aus[..., 0, :], aus[..., 1, :], self.cfg.sample_rate, self.ps_win,
                self.ps_masks)                                # [nau, S, ne, 20]
            if ne > 1:
                # static-image stabilisation: per band, envelope estimates that
                # agree within `tol` steps collapse to their rounded mean
                def stab(v, tol):
                    spread = v.amax(-2, keepdim=True) - v.amin(-2, keepdim=True)
                    mean = torch.round(v.to(self.dtype).mean(-2, keepdim=True)).to(v.dtype)
                    return torch.where(spread <= tol, mean.expand(v.shape), v)
                iid = stab(iid, 1)
                iid_fine = stab(iid_fine, 2)
        out = {"ps_iid": iid.movedim(0, 1), "ps_icc": icc.movedim(0, 1),
               "ps_iid_fine": iid_fine.movedim(0, 1),
               # one iid_mode per frame: fine when any envelope needs the range
               "ps_fine": use_fine.any(-1).movedim(0, 1)}
        with obs.span("dabplus.ps.downmix"):
            m = 0.5 * (x[:, 0:1] + x[:, 1:2])
            e_lr = (x[:, 0:1] * x[:, 0:1] + x[:, 1:2] * x[:, 1:2]).sum(-1, keepdim=True)
            e_m = (m * m).sum(-1, keepdim=True)
            g = torch.sqrt(0.5 * e_lr / e_m.clamp(min=1e-3)).clamp(1.0, 2.0)
            return m * g, state, out

    def _sbr_analysis(self, x, state, ps_out):
        """HE-AAC: the SBR side data of the stream delayed by SBR_SHIFT
        (stereo coupling chosen per AU), the FIL size of every AU as the
        reference counts it (with the PS extension when ps_out holds one;
        sbr.HDR_BITS) and the 2:1 half-band
        decimation with carried history (a stride-2 conv1d: no gathered
        copy of the input).  x: [S, ch, n].  Returns (core-rate x
        [S, ch, n/2], state', side outputs, FIL bits [S, nau] int32)."""
        S, ch, n = x.shape
        nau = self.cfg.num_aus
        x_sbr = torch.cat([state["sbr_hist"], x[..., :-SBR_SHIFT]], -1)
        # spans dabplus.sbr.qmf and dabplus.sbr.env inside
        side, qmf_hist = SBR.sbr_side_analysis(x_sbr, state["qmf_hist"], self.sbr_params,
                                               nau, self.sbr_tables())
        with obs.span("dabplus.sbr.bits"):
            if ch == 2:
                side = SBR.apply_coupling(side, self.sbr_params)
            ps_bits = None
            if ps_out:
                ps_bits = SBR.ps_data_bits(ps_out["ps_iid"], ps_out["ps_iid_fine"],
                                           ps_out["ps_fine"], ps_out["ps_icc"])
            sbr_bits = SBR.payload_bits(side, self.sbr_params, nau, ps_bits=ps_bits)
        with obs.span("dabplus.sbr.decimate"):
            # y[m] = sum_k h[k] xx[2m + k]
            xx = torch.cat([state["ds_hist"], x], -1)
            y = F.conv1d(xx.reshape(S * ch, 1, -1), self.ds_filter.view(1, 1, -1), stride=2)
        state = dict(state, sbr_hist=x[..., -SBR_SHIFT:], qmf_hist=qmf_hist,
                     ds_hist=xx[..., -(DS_TAPS - 1):])
        return y.reshape(S, ch, n // 2), state, side, sbr_bits

    def forward(self, state, pcm, pad_buf=None, pad_len=None):
        return self._superframe_step(state, pcm, pad_buf, pad_len)

    @obs.spanned("dabplus.step")
    def _superframe_step(self, state, pcm, pad_buf=None, pad_len=None):
        """pcm: [S, ch, num_aus*au_samples] int16 -> (state', outputs
        [S, nau, ...]).  One AU of delay (state["pend"]) gives block
        switching a true look-ahead granule.  With the device pack the
        outputs are the single leaf `wire` [S, 120*subch + 4*nau] uint8 (the
        superframe, then each AU's byte length and content bits as low and
        high bytes); pad_buf [S, nau, pad_len] / pad_len [S, nau] are its
        X-PAD bytes per AU (the host pack takes them in pack_superframes)."""
        cfg, dt = self.cfg, self.dtype
        S = pcm.shape[0]
        nau, N = cfg.num_aus, AT.N
        x_new = pcm.to(dt)
        with obs.span("dabplus.blockswitch"):
            wseq, state = BS.block_switch(x_new, state, cfg.au_samples // 8)   # [nau, S]
        x = torch.cat([state["pend"], x_new[..., :-cfg.au_samples]], -1)
        state = dict(state, pend=x_new[..., -cfg.au_samples:])
        sbr_out, total = {}, nau * self.budget_au
        if self.is_ps:
            with obs.span("dabplus.ps") as ps:
                ps.add("aus", nau)
                ps.add("envelopes", self.ps_nenv)
                x, state, sbr_out = self._ps_analysis(x, state)
        if self.is_sbr:
            with obs.span("dabplus.sbr"):
                x, state, side, sbr_bits = self._sbr_analysis(x, state, sbr_out)
            sbr_out.update(side, sbr_bits=sbr_bits)
            total = total - sbr_bits.sum(1)          # the core's share of the superframe
        ch = x.shape[1]
        grans = x.reshape(S, ch, nau, N).permute(2, 0, 1, 3)              # [nau, S, ch, 960]
        prevs = torch.cat([state["prev"][None], grans[:-1]], 0)
        max_sfb = torch.full((S,), self.max_sfb, dtype=torch.int32, device=x.device)
        nch = torch.full((S,), self.core_channels, dtype=torch.int32, device=x.device)

        # intra-superframe bit distribution: high-contrast AUs (attacks and
        # offsets over the coded window) get 1.5x the share
        se_au = (grans * grans).reshape(nau, S, ch, 8, N // 8).sum(-1)
        se_prev = torch.cat([(state["prev"] * state["prev"]).reshape(1, S, ch, 8, N // 8)
                             .sum(-1), se_au[:-1]], 0)
        se_win = torch.cat([se_prev, se_au], -1)
        hard_au = (se_win.amax(-1) > 32.0 * (se_win.amin(-1) + 1.0)).any(-1)
        w = 1.0 + 0.5 * hard_au.to(dt)                                     # [nau, S]
        budgets = (total * (w / w.sum(0))).to(torch.int32)

        pt, short_ctx = self.tables()
        ctx = self.aupack_ctx
        sbr_w = sbr_v = None
        if ctx is not None and self.is_sbr:
            with obs.span("dabplus.sbr.pack"):
                sbr_w, sbr_v = aupack.sbr_slot_groups(ctx, sbr_out)     # [S, nau, K]
        leftover = state["bitres"].clamp(max=self.bitres_max)
        thr_nm1, pre_flag, wgt_last = state["thr_nm1"], state["pre_flag"], state["wgt_last"]
        outs = []
        for a in range(nau):
            with obs.span("dabplus.au") as au:
                au.add("a", a)
                prev, cur, seq = prevs[a], grans[a], wseq[a]
                with obs.span("dabplus.mdct"):
                    spec = E.mdct_frame_switched(prev, cur, self.cos_basis, self.wvecs,
                                                 self.short_basis, seq)
                # reservoir spending: ordinary AUs may draw a quarter of the
                # reservoir, high-contrast ones all of it, capped per AU
                sub = torch.cat([prev, cur], -1).reshape(S, ch, 16, N // 8)
                se = (sub * sub).sum(-1)
                hard = (se.amax(-1) > 32.0 * (se.amin(-1) + 1.0)).any(-1)
                allow = torch.where(hard, leftover, leftover // 4)
                allow = allow.clamp(max=self.budget_au + self.bitres_max)
                budget = budgets[a] + allow
                o = E.encode_au(spec, pt, self.band_m, self.bol, max_sfb, budget, nch,
                                tns_cfg=self.tns_cfg, short_ctx=short_ctx, is_short=seq == 2,
                                refine_rounds=E.REFINE_ROUNDS if cfg.afterburner else 0,
                                modify_minsnr=self.modify_minsnr,
                                pre_state=(thr_nm1, pre_flag), seq=seq, weight_state=wgt_last)
                self.recover_checks += 1
                self.recoveries += o["recovered"]
                leftover = ((budget - o["bits"]).clamp(min=0)
                            + (leftover - allow)).to(torch.int32)
                thr_nm1, pre_flag, wgt_last = o["thr_nm1"], o["pre_flag"], o["last_patch"]
                if ctx is not None:
                    # pack the whole AU on the device: the loop keeps only the
                    # content bytes, the bit count and the CRC reduction
                    with obs.span("dabplus.aupack"):
                        fr = {k: o[k] for k in aupack.CORE_KEYS if k != "wseq"}
                        fr["wseq"] = seq
                        aubuf, abits, c1 = aupack.pack_au(
                            ctx, fr, a == nau - 1,
                            pad_buf=pad_buf[:, a] if pad_buf is not None else None,
                            pad_len=pad_len[:, a] if pad_len is not None else None,
                            sbr_group=(sbr_w[:, a], sbr_v[:, a]) if sbr_w is not None
                            else None)
                        outs.append({"aubuf": aubuf, "au_bits": abits, "crc_part": c1})
                    continue
                # narrow dtypes for the device-to-host copy; the packer widens
                outs.append({"q": o["q"].to(torch.int16), "gains": o["gains"].to(torch.int16),
                             "books": o["books"].to(torch.uint8),
                             "bits": o["bits"].to(torch.int32),
                             "ms_used": o["ms_used"], "tns_en": o["tns_en"],
                             "tns_order": o["tns_order"].to(torch.int8),
                             "tns_idx": o["tns_idx"].to(torch.int8), "tns_en_lo": o["tns_en_lo"],
                             "tns_order_lo": o["tns_order_lo"].to(torch.int8),
                             "tns_idx_lo": o["tns_idx_lo"].to(torch.int8),
                             "tns_len": o["tns_len"].to(torch.int8), "wseq": seq.to(torch.int8)})
        out = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}   # [S, nau, ...]
        if ctx is not None:
            with obs.span("dabplus.assemble"):
                sf, lens = aupack.assemble_superframes(ctx, out["aubuf"], out["au_bits"],
                                                       out["crc_part"])
                # one output leaf, one device-to-host copy: superframe bytes |
                # au_len lo, hi | au_bits lo, hi, [S, 120*subch + 4*nau] uint8
                ab = out["au_bits"]
                tail = torch.cat([lens & 0xFF, (lens >> 8) & 0xFF, ab & 0xFF, (ab >> 8) & 0xFF],
                                 dim=1).to(torch.uint8)
                out = {"wire": torch.cat([sf, tail], dim=1)}
        else:
            out.update(sbr_out)
        new_state = dict(state, prev=grans[-1], bitres=leftover.clamp(max=self.bitres_max),
                         thr_nm1=thr_nm1, pre_flag=pre_flag, wgt_last=wgt_last)
        return new_state, out

    def take_state(self, state, idx):
        """Per-stream state rows for churn (every leaf is [S, ...])."""
        i = torch.as_tensor(np.asarray(idx), device=self.device)
        return {k: v[i] for k, v in state.items()}

    def put_state(self, state, idx, rows):
        """Write rows (from take_state, or the JAX encoder's as numpy
        through convert.dabplus_state_from_numpy) at stream indices idx."""
        i = torch.as_tensor(np.asarray(idx), device=self.device)
        out = {}
        for k, v in state.items():
            v = v.clone()
            v[i] = torch.as_tensor(rows[k], device=v.device).to(v.dtype)
            out[k] = v
        return out

    def encode_superframes(self, state, pcm, add_rs=True, pads=None, pack=True):
        """pcm: [S, ch, num_aus*au_samples] int16 (numpy or tensor); pads:
        optional [S][num_aus] X-PAD byte strings (sent as DSE ancillary
        data).  Returns (state, [S] superframe bytes); with pack=False the
        second element is the step's output dict, for pack_superframes."""
        args = ()
        if self.aupack_ctx is not None and self.cfg.pad_len:
            args = tuple(torch.as_tensor(x, device=self.device) for x in aupack.pad_arrays(
                pads, self.S, self.cfg.num_aus, self.cfg.pad_len))
        state, out = self._superframe_step(state, torch.as_tensor(pcm, device=self.device),
                                           *args)
        if not pack:
            self._pack_args = (add_rs, pads)
            return state, out
        return state, self.pack_superframes(out, add_rs=add_rs, pads=pads)

    @obs.spanned("dabplus.slice")
    def pack_superframes(self, out, add_rs=None, pads=None, use_native=True):
        """Host half of encode_superframes (AU syntax + superframe + RS)
        through the port's host packers: the native batch packer (built at
        first use; a failed build raises), or with use_native=False the
        Python AU writer, its validation twin."""
        if add_rs is None:
            add_rs, pads = getattr(self, "_pack_args", (True, None))
        out = convert.to_numpy(out)
        if "wire" in out:
            # device-packed superframes: slice the rows; the core only when
            # add_rs is off
            nau = self.cfg.num_aus
            w = out["wire"]
            t = w[:, -4 * nau:].astype(np.int32)
            ab = t[:, 2 * nau:3 * nau] | (t[:, 3 * nau:] << 8)
            over = ab > 8 * self.aupack_ctx.maxcb
            if over.any():
                # unreachable while the rate loop's crash recovery holds its
                # bound (AuPackCtx checks it at construction).  If it ever
                # fires, that stream's superframe is corrupt (a decoder drops
                # it on its AU CRC): warn and keep the batch alive.
                print(f"dabplus: AU content exceeds the device pack bound "
                      f"({8 * self.aupack_ctx.maxcb} bits) on streams "
                      f"{np.flatnonzero(over.any(axis=1)).tolist()} - emitting corrupt "
                      f"superframes for those streams", file=sys.stderr)
            n = self.packer.total if not add_rs else w.shape[1] - 4 * nau
            return [w[s, :n].tobytes() for s in range(self.S)]
        if use_native:
            return native.dabplus_pack_batch(self, out, pads, add_rs)
        frames = []
        for s in range(self.S):
            aus = [self.write_au(out, s, a, pads[s][a] if pads is not None else None)
                   for a in range(self.cfg.num_aus)]
            frames.append(self.packer.assemble(aus, add_rs=add_rs))
        return frames

    def write_au(self, out, s, a, pad=None, sbr=True):
        """Stream s's AU a of the numpy step outputs through the Python AU
        writer: the core (SCE/CPE), the X-PAD bytes `pad` as a DSE, and for
        HE-AAC the SBR FIL element (with PS) unless sbr=False.  Returns the
        bit writer.  The core alone, in bits plus 10 (ID_END and the
        byte-align allowance), is what the rate loop counted in
        out["bits"][s, a]; the FIL element is sbr.payload_bits with
        hdr_bits=sbr.HDR_BITS_WRITTEN (out["sbr_bits"] is the reference's
        count, which can be a byte or two off it)."""
        bw = self._write_core(out, s, a)
        if pad:
            write_dse(bw, pad)
        if self.is_sbr and sbr:
            self._write_sbr(bw, out, s, a)
        return bw

    def _write_sbr(self, bw, out, s, a):
        env, env2 = out["sbr_env"][s, a], out["sbr_env2"][s, a]
        tr, nq, tg = out["sbr_transient"][s, a], out["sbr_noise_q"][s, a], out["sbr_tgrid"][s, a]
        invf, ah = out["sbr_invf"][s, a], out["sbr_addharm"][s, a]
        stereo = self.core_channels == 2

        def envs(c):
            # transient AUs: 2-envelope grid at 3.0 dB; else one envelope at 1.5 dB
            return [env2[c, 0], env2[c, 1]] if tr[c] else [env[c]]
        kw = {}
        if self.is_ps:
            fine = bool(out["ps_fine"][s, a])
            kw = {"ps_iid": out["ps_iid_fine" if fine else "ps_iid"][s, a],
                  "ps_icc": out["ps_icc"][s, a], "ps_fine": fine}
        if stereo:
            kw = {"envs_r": envs(1), "invf_r": invf[1], "noise_vals_r": nq[1],
                  "add_harm_r": ah[1], "grid_idx_r": int(tg[1]) if tr[1] else None,
                  "coupled": bool(out["sbr_cpl"][s, a])}
        SBR.write_sbr_payload(bw, envs(0), noise_vals=nq[0], params=self.sbr_params,
                              write_header=a == 0, invf=invf[0], add_harm=ah[0],
                              grid_idx=int(tg[0]) if tr[0] else None, **kw)

    def _write_core(self, out, s, a):
        tns = None
        if self.tns_cfg is not None:
            tns = [(bool(out["tns_en"][s, a, c]), int(out["tns_order"][s, a, c]),
                    out["tns_idx"][s, a, c], int(out["tns_len"][s, a, c]),
                    bool(out["tns_en_lo"][s, a, c]), int(out["tns_order_lo"][s, a, c]),
                    out["tns_idx_lo"][s, a, c], self.tns_cfg["length_code_lo"])
                   for c in range(self.core_channels)]
        return write_au(out["q"][s, a], out["gains"][s, a], out["books"][s, a], self.max_sfb,
                        self.sfb_off, self.core_channels, ms_used=out["ms_used"][s, a], tns=tns,
                        wseq=int(out["wseq"][s, a]),
                        short_info={"nsfb": self.nsfb_short, "max_sfb": self.max_sfb_short,
                                    "sfb_off": self.sfb_off_short})
