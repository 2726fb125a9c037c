"""Host-side MP2 frame packing with the DAB ScF-CRC one-frame delay (a
frozen copy of the port's host/mp2pack.py, its Python packer alone).

Consumes the device step outputs (model.py) and emits the byte stream
identical to libtoolame-dab (toolame.c:467-553 + bitstream.c semantics: the
ScF-CRC bytes of frame n are back-patched into frame n-1, so emission lags one
frame; finish() flushes the last frame with its own CRCs, matching
close_bit_stream_w).
"""
import numpy as np

from .. import tables as T
from . import mp2crc
from .bitwriter import BitWriter


class Mp2Packer:
    """One packer per stream batch; emit() returns a list of per-stream byte
    chunks for this frame (empty on the very first frame)."""

    def __init__(self, config):
        self.cfg = config
        self._pending = [None] * config.n_streams  # (bytearray frame, scf byte offset)

    def _pack_one(self, i, out, xpad):
        cfg = self.cfg
        bw = BitWriter()
        nch = int(cfg.nch[i])
        sblimit = int(cfg.sblimit[i])
        jsbound = int(out["jsbound"][i])
        mode = int(out["mode"][i])
        mode_ext = int(out["mode_ext"][i])
        bit_alloc = out["bit_alloc"][i]
        scfsi = out["scfsi"][i]
        sf = out["sf_index"][i]
        sbband = out["sbband"][i] if "sbband" in out else None
        line_row = T.LINE[int(cfg.tablenum[i])]
        nbal_row = np.where(line_row >= 0, T.NBAL[np.maximum(line_row, 0)], 0)

        extra = int(out["extra"][i]) if "extra" in out else 0
        h = dict(bitrate_index=int(cfg.bitrate_idx[i]),
                 sampling_frequency=int(cfg.sfreq_idx[i]),
                 padding=extra, extension=0, mode=mode, mode_ext=mode_ext,
                 copyright=0, original=0, emphasis=0)

        # header (write_header, encode_new.c:356-373)
        bw.put(0xFFF, 12)
        bw.put(int(cfg.version[i]), 1)
        bw.put(4 - 2, 2)  # layer II
        bw.put(0, 1)      # error protection on
        bw.put(h["bitrate_index"], 4)
        bw.put(h["sampling_frequency"], 2)
        bw.put(h["padding"], 1)
        bw.put(h["extension"], 1)
        bw.put(h["mode"], 2)
        bw.put(h["mode_ext"], 2)
        bw.put(h["copyright"], 1)
        bw.put(h["original"], 1)
        bw.put(h["emphasis"], 2)

        crc = mp2crc.header_crc(h, bit_alloc, scfsi, nbal_row, nch, sblimit, jsbound)
        bw.put(crc, 16)

        # bit allocation (write_bit_alloc)
        for sb in range(sblimit):
            for ch in range(nch if sb < jsbound else 1):
                bw.put(int(bit_alloc[ch, sb]), int(nbal_row[sb]))

        # scfsi + scalefactors (write_scalefactors)
        for sb in range(sblimit):
            for ch in range(nch):
                if bit_alloc[ch, sb]:
                    bw.put(int(scfsi[ch, sb]), 2)
        for sb in range(sblimit):
            for ch in range(nch):
                if bit_alloc[ch, sb]:
                    code = int(scfsi[ch, sb])
                    if code == 0:
                        for gr in range(3):
                            bw.put(int(sf[ch, gr, sb]), 6)
                    elif code in (1, 3):
                        bw.put(int(sf[ch, 0, sb]), 6)
                        bw.put(int(sf[ch, 2, sb]), 6)
                    else:
                        bw.put(int(sf[ch, 0, sb]), 6)

        # samples (write_samples_new, encode_new.c:560-598); when the device
        # step already serialized them (mp2/binpack.py), splice the payload
        if "payload" in out:
            pay = out["payload"][i]
            pbits = int(out["payload_bits"][i])
            for k in range(pbits // 8):
                bw.put(int(pay[k]), 8)
            if pbits % 8:
                bw.put(int(pay[pbits // 8]) >> (8 - pbits % 8), pbits % 8)
        else:
            step_index = T.STEP_INDEX
            for gr in range(3):
                for j in (0, 3, 6, 9):
                    for sb in range(sblimit):
                        for ch in range(nch if sb < jsbound else 1):
                            ba = int(bit_alloc[ch, sb])
                            if ba:
                                sidx = int(step_index[line_row[sb]][ba])
                                nbits = int(T.BITS[sidx])
                                if T.GROUP[sidx] == 3:
                                    for x in range(3):
                                        bw.put(int(sbband[ch, gr, j + x, sb]), nbits)
                                else:
                                    y = int(T.STEPS[sidx])
                                    v = (int(sbband[ch, gr, j, sb])
                                         + int(sbband[ch, gr, j + 1, sb]) * y
                                         + int(sbband[ch, gr, j + 2, sb]) * y * y)
                                    bw.put(v, nbits)

        # zero-stuff leftover audio bits (toolame.c:510-512)
        left = int(out["adb_left"][i])
        assert left >= 0, "bit allocation overran the frame budget"
        for _ in range(left // 8):
            bw.put(0, 8)
        if left % 8:
            bw.put(0, left % 8)

        # X-PAD insert (toolame.c:515-524); xpad may be (full_buffer, used_len)
        dab_length = int(cfg.dab_length[i])
        if isinstance(xpad, tuple):
            xpad, xpad_len = xpad
        else:
            xpad_len = len(xpad) if xpad else 0
        if xpad_len:
            for k in range(dab_length - xpad_len, dab_length - 2):
                bw.put(xpad[k], 8)

        # ScF-CRC placeholders: current frame's own CRCs; the emitter patches
        # the previous frame with these values (toolame.c:527-542)
        dab_ext = int(cfg.dab_ext[i])
        scf_vals = []
        for k in range(dab_ext - 1, -1, -1):
            c = mp2crc.scf_crc(bit_alloc, scfsi, sf, nch, sblimit, k)
            scf_vals.append(c)
            bw.put(c, 8)

        # F-PAD (toolame.c:544-551)
        if xpad_len:
            bw.put(xpad[dab_length - 2], 8)
            bw.put(xpad[dab_length - 1], 8)
        else:
            bw.put(0, 16)

        frame_bytes = bytearray(bw.bytes())
        want_len = int(cfg.lg_frame[i]) + extra
        assert len(frame_bytes) == want_len, \
            f"frame length {len(frame_bytes)} != {want_len}"
        scf_off = len(frame_bytes) - 2 - dab_ext
        return frame_bytes, scf_off, scf_vals

    def emit(self, out, xpads=None):
        """out: device outputs as numpy (dict of [S, ...] arrays).
        xpads: optional list of per-stream xpad byte buffers (length
        dab_length each) or None.  Returns list of per-stream bytes emitted
        for this call (the previous frame, patched)."""
        S = self.cfg.n_streams
        emitted = []
        for i in range(S):
            xpad = xpads[i] if xpads else None
            frame, scf_off, scf_vals = self._pack_one(i, out, xpad)
            prev = self._pending[i]
            if prev is None:
                emitted.append(b"")
            else:
                pframe, poff, _ = prev
                for k, v in enumerate(scf_vals):
                    pframe[poff + k] = v
                emitted.append(bytes(pframe))
            self._pending[i] = (frame, scf_off, scf_vals)
        return emitted

    def finish(self):
        """Flush the delayed last frame (own CRCs), per close_bit_stream_w."""
        S = self.cfg.n_streams
        emitted = []
        for i in range(S):
            prev = self._pending[i]
            emitted.append(bytes(prev[0]) if prev is not None else b"")
            self._pending[i] = None
        return emitted
