"""The benchmark's plain MP2 reference: a frozen copy of the port's batched
MP2 encoder (odr_audioenc_tpu_torch/mp2/model.py) through psycho-acoustic
model 1 alone, without its fast psy-1 path, its CUDA kernels, its device
packers and its stream churn.

The step advances all S streams by one 1152-sample frame and emits the
integer coding decisions (scalefactors, scfsi, allocations, quantized
codewords) for the host packer (host/mp2pack.py), mirroring the split where
toolame.c:267-553 drives DSP then bit-packs.  In float64 it is the exact
path (the C accumulation orders), which reproduces toolame bit for bit.
"""
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import convert
from .. import tables as T
from . import allocate, polyphase, psycho1

MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO = 0, 1, 2, 3
_MODE_OF = {"s": MODE_STEREO, "j": MODE_JOINT, "d": MODE_DUAL, "m": MODE_MONO}


@dataclass
class Mp2Config:
    """Per-stream static configuration (numpy arrays of shape [S])."""
    version: np.ndarray        # 1=MPEG-1, 0=MPEG-2 LSF
    sfreq_idx: np.ndarray      # header sampling_frequency index
    bitrate_idx: np.ndarray
    mode: np.ndarray           # header mode at init (0..3)
    nch: np.ndarray
    tablenum: np.ndarray
    sblimit: np.ndarray
    dab_ext: np.ndarray        # 2 or 4 scf-crc bytes
    dab_length: np.ndarray     # xpad buffer length (0 if no PAD)
    adb_full: np.ndarray       # frame bits before DAB reservation
    lg_frame: np.ndarray       # frame bytes
    low_rate: np.ndarray       # per-channel bitrate < 96 (psy1 hear offset)
    psy_rate_idx: np.ndarray   # psy-1 table index (sfreq_idx [+4 for MPEG-2])
    bitrate_kbps: np.ndarray
    slots_frac: np.ndarray     # fractional slots/frame (44.1k family padding)

    @property
    def n_streams(self):
        return len(self.version)


def make_config(streams):
    """streams: list of dicts {rate, bitrate, mode, pad_len(optional)}.
    Mirrors toolame_set_* + encode_init (toolame.c:212-262,
    encode_new.c:104-156, odr-audioenc.cpp:686-735)."""
    n = len(streams)
    f = {k: np.zeros(n, np.int32) for k in
         ["version", "sfreq_idx", "bitrate_idx", "mode", "nch", "tablenum",
          "sblimit", "dab_ext", "dab_length", "adb_full", "lg_frame",
          "psy_rate_idx", "bitrate_kbps"]}
    low_rate = np.zeros(n, bool)
    slots_frac = np.zeros(n, np.float64)
    for i, s in enumerate(streams):
        rate, br, mode = s["rate"], s["bitrate"], s["mode"]
        version, sfidx = {44100: (1, 0), 48000: (1, 1), 32000: (1, 2),
                          22050: (0, 0), 24000: (0, 1), 16000: (0, 2)}[rate]
        br_idx = list(T.BITRATE_TABLE[version]).index(br)
        m = _MODE_OF[mode]
        nch = 1 if m == MODE_MONO else 2
        br_per_ch = br // nch
        dab_ext = 4
        if version == 1 and br_per_ch < 56:
            dab_ext = 2
        sfrq = T.S_FREQ_KHZ[version][sfidx]
        if version == 1:
            if (sfrq == 48 and br_per_ch >= 56) or (56 <= br_per_ch <= 80):
                tablenum = 0
            elif sfrq != 48 and br_per_ch >= 96:
                tablenum = 1
            elif sfrq != 32 and br_per_ch <= 48:
                tablenum = 2
            else:
                tablenum = 3
        else:
            tablenum = 4
        average = (1152.0 / sfrq) * (br / 8.0)
        whole = int(average)
        slots_frac[i] = average - whole  # padding-slot lag (availbits.c:40-62)
        f["version"][i] = version
        f["sfreq_idx"][i] = sfidx
        f["bitrate_idx"][i] = br_idx
        f["mode"][i] = m
        f["nch"][i] = nch
        f["tablenum"][i] = tablenum
        f["sblimit"][i] = T.TABLE_SBLIMIT[tablenum]
        f["dab_ext"][i] = dab_ext
        f["dab_length"][i] = s.get("pad_len", 0)
        f["adb_full"][i] = whole * 8
        f["lg_frame"][i] = whole
        f["psy_rate_idx"][i] = sfidx + (0 if version == 1 else 4)
        f["bitrate_kbps"][i] = br
        low_rate[i] = br_per_ch < 96
    return Mp2Config(low_rate=low_rate, slots_frac=slots_frac, **f)


_CFG_COLS = ["sblimit", "nch", "mode", "dab_ext", "adb_full", "tablenum", "low_rate",
             "version", "bitrate_idx", "sfreq_idx", "lg_frame", "dab_length"]


class Mp2Encoder(nn.Module):
    """Stream-batched MP2 encoder through psy model 1.  The config columns
    and the psy-1 tables are registered buffers; `.to(device)` moves them."""

    def __init__(self, config: Mp2Config, dtype=torch.float64, device="cpu"):
        """dtype: float64 (the exact path) or float32 (the dense polyphase
        and DFT matmuls)."""
        super().__init__()
        device = torch.device(device)
        self.cfg = config
        self.dtype = dtype
        for k in _CFG_COLS:
            col = np.asarray(getattr(config, k))
            self.register_buffer("cfg_" + k, torch.as_tensor(
                col if col.dtype == bool else col.astype(np.int64), device=device))
        tabs = convert.tables_from_numpy(
            psycho1.make_psy1_tables(np.repeat(config.psy_rate_idx, 2)), device, self.dtype)
        self._psy_keys = list(tabs)
        for k, v in tabs.items():
            self.register_buffer("psy_" + k, v)
        # 44.1k-family padding-slot lag, advanced host-side in f64 exactly as
        # the reference's static struct (availbits.c:27-62)
        self.pad_lag = np.zeros(config.n_streams, np.float64)

    @property
    def device(self):
        return self.cfg_sblimit.device

    def _col(self, k):
        return getattr(self, "cfg_" + k)

    def psy_tabs(self):
        return {k: getattr(self, "psy_" + k) for k in self._psy_keys}

    def init_state(self):
        S = self.cfg.n_streams
        return {"hist": torch.zeros((S, 2, 480), dtype=self.dtype, device=self.device)}

    def next_padding(self):
        """Advance the padding-slot lag one frame; returns extra slots [S]
        (available_bits, availbits.c:51-62; usepadbit TRUE, vbr FALSE)."""
        frac = self.cfg.slots_frac
        m = frac != 0
        nopad = self.pad_lag > (frac - 1.0)
        extra = (m & ~nopad).astype(np.int32)
        self.pad_lag = np.where(m, np.where(nopad, self.pad_lag - frac,
                                            self.pad_lag + (1.0 - frac)),
                                self.pad_lag)
        return extra

    def forward(self, state, pcm, xpad_len, extra_slots=None):
        return self._encode_step(state, pcm, xpad_len, extra_slots)

    def _encode_step(self, state, pcm, xpad_len, extra_slots=None):
        """pcm: [S, 2, 1152] int16; xpad_len: [S]; extra_slots: [S] padding
        slots this frame (44.1k family; None = no padding).  Returns
        (state', outputs); see host/mp2pack.py for the consumer."""
        dtype = self.dtype
        S = pcm.shape[0]
        sblimit, nch, mode = self._col("sblimit"), self._col("nch"), self._col("mode")
        frame = pcm.to(dtype) / T.SCALE

        sb_s, hist = polyphase.polyphase_frame(state["hist"], frame)
        sb_sample = sb_s.reshape(S, 2, 3, 12, 32)
        sbmask = torch.arange(32, device=frame.device)[None, :] < sblimit[:, None]

        sf_index = allocate.scalefactor_calc(sb_sample)
        sf_index = torch.where(sbmask[:, None, None, :], sf_index, 0)
        scale_max = allocate.find_sf_max(sf_index, sblimit, dtype)
        j_sample = allocate.combine_lr(sb_sample)               # [S,3,12,32]
        j_scale = torch.where(sbmask[:, None, :], allocate.scalefactor_calc(j_sample), 0)

        # psy 1's 1024-sample FFT window
        window = torch.cat([state["hist"][..., 288:], frame[..., :832]],
                           dim=-1).reshape(S * 2, 1024)
        smr = psycho1.psycho_1(window, scale_max.reshape(S * 2, 32), self.psy_tabs(),
                               self._col("low_rate").repeat_interleave(2)).reshape(S, 2, 32)
        new_state = {"hist": hist}

        sf_adj, scfsi = allocate.sf_transmission_pattern(sf_index)
        sf_adj = torch.where(sbmask[:, None, None, :], sf_adj, 0)
        ft = allocate._frame_tables(self._col("tablenum"))
        xpad_len = xpad_len.long()
        adb = self._col("adb_full") - self._col("dab_ext") * 8 - \
            torch.where(xpad_len > 0, xpad_len, 2) * 8
        if extra_slots is not None:
            adb = adb + extra_slots.long() * 8

        is_joint = mode == MODE_JOINT
        stereo_sel, mode_ext, jsbound = allocate.js_mode_select(
            smr, scfsi, ft, sblimit, nch, is_joint, adb)
        mode_final = torch.where(is_joint, torch.where(stereo_sel, MODE_STEREO, MODE_JOINT),
                                 mode)
        bit_alloc, adb_left = allocate.a_bit_allocation(
            smr, scfsi, ft, sblimit, nch, jsbound, adb)
        sbband = allocate.quantize(sf_adj, sb_sample, j_scale, j_sample, bit_alloc, ft,
                                   sblimit, nch, jsbound)

        out = {
            "sf_index": sf_adj.to(torch.uint8),
            "scfsi": scfsi.to(torch.uint8),
            "bit_alloc": bit_alloc.to(torch.uint8),
            "mode": mode_final.to(torch.int32),
            "mode_ext": mode_ext.to(torch.int32),
            "jsbound": jsbound.to(torch.int32),
            "adb_left": adb_left.to(torch.int32),
            "smr": smr,
        }
        # int32, where the JAX step narrows to uint16 (torch's uint16
        # support is thin); the host packer widens either
        out["sbband"] = sbband.to(torch.int32)
        if extra_slots is not None:
            out["extra"] = extra_slots.to(torch.int32)
        return new_state, out

    def encode_step(self, state, pcm, xpad_len=None):
        """One frame for every stream; host inputs (numpy or tensors) are
        moved to the encoder's device."""
        S, dev = self.cfg.n_streams, self.device
        xpad_len = (torch.zeros((S,), dtype=torch.int64, device=dev) if xpad_len is None
                    else torch.as_tensor(xpad_len, device=dev))
        extra = None
        if (self.cfg.slots_frac != 0).any():
            extra = torch.as_tensor(self.next_padding(), device=dev)
        return self._encode_step(state, torch.as_tensor(pcm, device=dev), xpad_len, extra)
