"""Host-side MP2 frame packing with the DAB ScF-CRC one-frame delay.

Consumes the device step outputs (model.py) and emits the byte stream
identical to libtoolame-dab (toolame.c:467-553 + bitstream.c semantics: the
ScF-CRC bytes of frame n are back-patched into frame n-1, so emission lags one
frame; finish() flushes the last frame with its own CRCs, matching
close_bit_stream_w).
"""
import numpy as np

from .. import obs
from .. import tables as T
from . import mp2crc
from .bitwriter import BitWriter


class Mp2Packer:
    """One packer per stream batch; emit() returns a list of per-stream byte
    chunks for this frame (empty on the very first frame)."""

    def __init__(self, config):
        self.cfg = config
        S = config.n_streams
        self._pending = [None] * S  # (bytearray frame, scf byte offset)
        self._pf = None  # device-frame pending: (frames[S,L], off[S], lg[S])
        # vectorized ScF-CRC patch indices: stream i contributes dab_ext[i]
        # patched bytes (emission order k=0.. is crc[dab_ext-1-k])
        dab_ext = np.asarray(config.dab_ext, np.int64)
        self._dab_ext = dab_ext
        self._lg_base = np.asarray(config.lg_frame, np.int64)
        self._patch_rows = np.repeat(np.arange(S), dab_ext)
        self._patch_ks = np.concatenate(
            [np.arange(d) for d in dab_ext]) if S else np.zeros(0, np.int64)
        self._patch_ks = self._patch_ks.astype(np.int64)

    def take_pending(self, idx):
        """Carry the one-frame ScF-CRC delay line across a churn rebuild."""
        rows = []
        for i in idx:
            if self._pending[i] is None and self._pf is not None:
                pf, poff, plg = self._pf
                rows.append((bytearray(pf[i, :plg[i]].tobytes()),
                             int(poff[i]), []))
            else:
                rows.append(self._pending[i])
        return rows

    def put_pending(self, idx, rows):
        for i, r in zip(idx, rows):
            self._pending[i] = r

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

    def _cfg_cols(self):
        """Per-stream config columns for the native packer."""
        if not hasattr(self, "_cc"):
            c = self.cfg
            self._cc = np.stack([
                c.version, c.bitrate_idx, c.sfreq_idx, c.nch, c.sblimit,
                c.tablenum, c.dab_ext, c.dab_length, c.lg_frame,
            ], axis=1).astype(np.int32)
        return self._cc

    def _pack_all_native(self, out, xpads):
        """Batch-pack all streams via the C++ library (native/mp2pack.cpp),
        built at first use; raises if it cannot be built."""
        from . import native
        xp = None
        if xpads:
            xp = []
            for x in xpads:
                if x is None:
                    xp.append((b"", 0))
                elif isinstance(x, tuple):
                    xp.append(x)
                else:
                    xp.append((x, len(x) if x else 0))
        max_frame = int((self.cfg.lg_frame + 1).max())
        frames, lens, offs, vals = native.mp2_pack_batch(self._cfg_cols(), out, xp, max_frame)
        dab_ext = self.cfg.dab_ext
        return [(bytearray(frames[i, :lens[i]].tobytes()), int(offs[i]),
                 list(vals[i, :int(dab_ext[i])]))
                for i in range(self.cfg.n_streams)]

    def _emit_device_frames(self, out):
        """Fast path for device-packed complete frames (mp2/framepack.py):
        patch the previous frame's ScF-CRC bytes and slice lengths.  The
        patch is one vectorized scatter over all streams (the per-stream
        bytearray loop measured 14.9 ms at S=2048 - the full-path
        bottleneck after the device pack landed)."""
        cfg = self.cfg
        S = cfg.n_streams
        frames = np.ascontiguousarray(out["frame"])
        if not frames.flags.writeable:
            frames = frames.copy()
        scf_vals = np.asarray(out["scf_vals"])
        extra = out.get("extra")
        lg = self._lg_base + (np.asarray(extra, np.int64)
                              if extra is not None else 0)
        scf_off = lg - 2 - self._dab_ext
        # emission order matches _pack_one: crc[dab_ext-1] first
        rows, ks = self._patch_rows, self._patch_ks
        vals_flat = scf_vals[rows, self._dab_ext[rows] - 1 - ks]
        if self._pf is None:
            emitted = [b""] * S
            # streams seeded via put_pending (churn migration into a fresh
            # packer): patch + emit their carried frame tuple
            for i in range(S):
                if self._pending[i] is not None:
                    pframe, poff, _ = self._pending[i]
                    for k in range(int(self._dab_ext[i])):
                        pframe[poff + k] = int(
                            scf_vals[i, int(self._dab_ext[i]) - 1 - k])
                    emitted[i] = bytes(pframe)
                    self._pending[i] = None
        else:
            pf, poff, plg = self._pf
            pf[rows, poff[rows] + ks] = vals_flat
            emitted = [pf[i, :plg[i]].tobytes() for i in range(S)]
        self._pf = (frames, scf_off, lg)
        return emitted

    @obs.spanned("mp2.emit")
    def emit(self, out, xpads=None, use_native=True):
        """out: device outputs as numpy (dict of [S, ...] arrays).
        xpads: optional list of per-stream xpad byte buffers (length
        dab_length each) or None.  Returns list of per-stream bytes emitted
        for this call (the previous frame, patched)."""
        S = self.cfg.n_streams
        if "wire" in out:
            # single-buffer device frames: [S, n_bytes + 6] uint8 =
            # frame | scf_vals[4] | mode | extra (see mp2/model.py)
            w = np.asarray(out["wire"])
            d = {"frame": np.ascontiguousarray(w[:, :-6]),
                 "scf_vals": w[:, -6:-2].astype(np.int32)}
            if (self.cfg.slots_frac != 0).any():
                d["extra"] = w[:, -1].astype(np.int32)
            return self._emit_device_frames(d)
        if "frame" in out:
            return self._emit_device_frames(out)
        packed = self._pack_all_native(out, xpads) if use_native else None
        emitted = []
        for i in range(S):
            xpad = xpads[i] if xpads else None
            if packed is not None:
                frame, scf_off, scf_vals = packed[i]
            else:
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
            if prev is not None:
                emitted.append(bytes(prev[0]))
            elif self._pf is not None:
                pf, _, plg = self._pf
                emitted.append(pf[i, :plg[i]].tobytes())
            else:
                emitted.append(b"")
            self._pending[i] = None
        self._pf = None
        return emitted
