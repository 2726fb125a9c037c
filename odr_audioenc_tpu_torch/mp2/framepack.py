"""Device-side emission of COMPLETE MP2/DAB frames (port of
odr_audioenc_tpu/mp2/framepack.py).

Produces, per stream, the exact bytes of libtoolame-dab's frame
(toolame.c:467-553 order: header, CRC16, bit allocation, scfsi,
scalefactors, sample codewords, zero stuffing, X-PAD, ScF-CRC
placeholders, F-PAD), so the host only patches the 2-4 ScF-CRC bytes into
the PREVIOUS frame (the one-frame DAB back-patch delay, toolame.c:527-542)
and slices off lg_frame(+padding) bytes.

Header CRC16 (crc.c:12-41, poly 0x8005 init 0xFFFF over the header's last
16 bits + alloc + scfsi) and the four ScF-CRC8s (crc.c:58-98, poly 0x1D over
transmitted scalefactor MSB triples per subband range) are GF(2) bit-matrix
products (bitpack.CrcTable) over mini message buffers packed on device.
"""
from functools import lru_cache

import numpy as np
import torch

from odr_audioenc_tpu import tables as T

from .. import bitpack as BP
from . import binpack

SBLIMIT = 32
SCF_RANGES = [0, 4, 8, 16, 30]


@lru_cache(maxsize=None)
def _crc16_tab():
    return BP.CrcTable(0x8005, 16, 0xFFFF, 52 * 8)


@lru_cache(maxsize=None)
def _crc8_tab():
    return BP.CrcTable(0x1D, 8, 0x0, 32 * 8)


_CRC_TABS = {}


def _crc_tabs(tab, device):
    """CrcTable device tables, made once per (table, device)."""
    key = (id(tab), torch.device(device))
    if key not in _CRC_TABS:
        _CRC_TABS[key] = tab.device_tables(device)
    return _CRC_TABS[key]


def nbal_rows(config):
    """Static per-stream nbal[32] from the allocation table choice."""
    line = T.LINE[config.tablenum]                      # [S, 32]
    return np.where(line >= 0, T.NBAL[np.maximum(line, 0)], 0).astype(np.int32)


def _scf_slots(sf, scfsi, active, width, shift):
    """Scalefactor slot grid [S, 32, 2, 3] in (sb, ch, emission) order.

    code 0 -> sf[0],sf[1],sf[2]; 1/3 -> sf[0],sf[2]; 2 -> sf[0]
    (write_scalefactors, encode_new.c:288-354 emission order).
    sf: [S,2,3,32]; active: [S,32,2]; returns (widths, values) [S, 192]."""
    S = sf.shape[0]
    code = scfsi.transpose(1, 2)                        # [S, 32, 2]
    sfv = (sf.long() >> shift).permute(0, 3, 1, 2)      # [S, 32, 2, 3(gr)]
    n_tx = torch.where(code == 0, 3, torch.where(code == 2, 1, 2))
    slot = torch.arange(3, device=sf.device)
    w = torch.where((slot < n_tx[..., None]) & active[..., None], width, 0)
    # slot 1 carries gr1 for code 0 but gr2 for codes 1/3
    v1 = torch.where((code == 1) | (code == 3), sfv[..., 2], sfv[..., 1])
    v = torch.stack([sfv[..., 0], v1, sfv[..., 2]], dim=-1)
    return w.reshape(S, -1), v.reshape(S, -1)


def pack_full_frame(cfgd, out, sbband, ft, xpad_len, xpad_buf, n_bytes):
    """Emit complete frames [S, n_bytes] u8 + ScF-CRC values [S, 4] u8.

    cfgd: dict of device config columns (version, bitrate_idx, sfreq_idx,
      nbal [S,32], dab_ext, dab_length, lg_frame, sblimit, nch);
    out: dict with sf_index [S,2,3,32], scfsi, bit_alloc, mode, mode_ext,
      jsbound, optional extra;
    sbband: [S,2,3,12,32]; xpad_buf: [S, padmax] or None."""
    S = sbband.shape[0]
    dev = sbband.device
    sblimit, nch = cfgd["sblimit"], cfgd["nch"]
    jsbound = out["jsbound"].long()
    bit_alloc = out["bit_alloc"].long()
    scfsi = out["scfsi"].long()
    sf = out["sf_index"]
    extra = out.get("extra")
    if extra is None:
        extra = torch.zeros((S,), dtype=torch.int64, device=dev)
    extra = extra.long()

    sb = torch.arange(SBLIMIT, device=dev)
    in_lim = sb[None, :] < sblimit[:, None]
    # alloc/scf channel activity (write order: sb outer, ch inner)
    ch_tx = torch.stack([in_lim, in_lim & (sb[None, :] < jsbound[:, None])
                         & (nch[:, None] == 2)], dim=2)         # [S,32,2]
    ch_scf = torch.stack([in_lim, in_lim & (nch[:, None] == 2)], dim=2)
    alloc_t = bit_alloc.transpose(1, 2)                         # [S,32,2]
    active_scf = (alloc_t > 0) & ch_scf

    # --- header slots ---
    hdr1 = ((0xFFF << 4) | (cfgd["version"].long() << 3) | (2 << 1))[:, None]
    hdr2 = ((cfgd["bitrate_idx"].long() << 12) | (cfgd["sfreq_idx"].long() << 10)
            | (extra << 9) | (out["mode"].long() << 6)
            | (out["mode_ext"].long() << 4))[:, None]
    w16 = torch.full((S, 1), 16, dtype=torch.int64, device=dev)

    # --- alloc + scfsi slots ---
    w_alloc = torch.where(ch_tx, cfgd["nbal"].long()[..., None], 0).reshape(S, -1)
    v_alloc = torch.where(ch_tx, alloc_t, 0).reshape(S, -1)
    w_scfsi = torch.where(active_scf, 2, 0).reshape(S, -1)
    v_scfsi = torch.where(active_scf, scfsi.transpose(1, 2), 0).reshape(S, -1)

    # --- header CRC16 over hdr2 + alloc + scfsi (crc.c:12-41) ---
    msg, msg_bits = BP.pack_groups(
        [(w16, hdr2, 3), (w_alloc, v_alloc, 2), (w_scfsi, v_scfsi, 2)], 52)
    crc = BP.crc_device(msg, msg_bits, _crc_tabs(_crc16_tab(), dev), 16)[:, None]

    # --- scalefactor slots ---
    w_scf, v_scf = _scf_slots(sf, scfsi, active_scf, 6, 0)

    # --- sample slots (binpack grid) ---
    w_smp, v_smp = binpack.sample_slots(sbband, bit_alloc, ft, sblimit, nch, jsbound)

    # --- ScF-CRC8 values (crc.c:58-98): 3-bit MSB chunks per range ---
    scf_vals = []
    for k in range(4):
        last = sblimit.clamp_max(SCF_RANGES[k + 1])
        rng_mask = (sb[None, :] >= SCF_RANGES[k]) & (sb[None, :] < last[:, None])
        wk, vk = _scf_slots(sf, scfsi, active_scf & rng_mask[..., None], 3, 3)
        mk, mbits = BP.pack_groups([(wk, vk, 2)], 32)
        scf_vals.append(BP.crc_device(mk, mbits, _crc_tabs(_crc8_tab(), dev), 8))
    scf_vals = torch.stack(scf_vals, dim=1)                     # [S, 4]

    # --- tail raw bytes at end-of-frame positions (out of range = dropped) ---
    lg = cfgd["lg_frame"].long() + extra
    dab_ext = cfgd["dab_ext"].long()
    raw = []
    if xpad_buf is not None and xpad_buf.shape[1] > 0:
        padmax = xpad_buf.shape[1]
        k = torch.arange(padmax, device=dev)[None, :]
        dl = cfgd["dab_length"].long()[:, None]
        xl = xpad_len.long()[:, None]
        xb = xpad_buf.long()
        use = (k >= dl - xl) & (k < dl - 2) & (xl > 0)
        raw.append((torch.where(use, lg[:, None] - dab_ext[:, None] - dl + k, -1),
                    torch.where(use, xb, 0)))
        # F-PAD: last two xpad bytes, or zeros (zeros need no slots)
        fpad = torch.gather(xb, 1, (dl - 2 + torch.arange(2, device=dev)).clamp(0, padmax - 1))
        has = (xl > 0) & (dl >= 2)
        raw.append((torch.where(has, lg[:, None] - 2 + torch.arange(2, device=dev), -1),
                    torch.where(has, fpad, 0)))
    # ScF-CRC placeholders: crc[k] at byte lg-3-k for k < dab_ext
    kk = torch.arange(4, device=dev)[None, :]
    use = kk < dab_ext[:, None]
    raw.append((torch.where(use, lg[:, None] - 3 - kk, -1), torch.where(use, scf_vals, 0)))

    frame, _ = BP.pack_groups(
        [(w16, hdr1, 3), (w16, hdr2, 3), (w16, crc, 3),
         (w_alloc, v_alloc, 2), (w_scfsi, v_scfsi, 2),
         (w_scf, v_scf, 2), (w_smp, v_smp, binpack.SAMPLE_SPANS)],
        n_bytes, raw=raw)
    return frame.to(torch.uint8), scf_vals.to(torch.uint8)
