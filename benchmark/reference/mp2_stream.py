"""What an MP2 station emits, from its audio alone.

The MP2 step's only state is the filterbank history, the last 480 samples
of the previous frame, and the packer patches frame n's ScF-CRC into frame
n - 1.  So the bytes that the window's drain of step k emits for station i
(its frame k - 1) follow from its audio of steps k - 2 .. k: the reference
encodes those three frames of every sampled (k, i) in one batch, in blocks
of rows, through the exact float64 encoder and the Python frame packer.
"""
import numpy as np
import torch

from benchmark.reference.convert import to_numpy
from benchmark.reference.host.mp2crc import scf_crc
from benchmark.reference.host.mp2pack import Mp2Packer
from benchmark.reference.host.mp2parse import parse_frame
from benchmark.reference.mp2.model import Mp2Encoder, make_config
from benchmark.stations import station_specs

UNIT = "frames"
BLOCK = 4096


def valid(frame):
    """The frame's own integrity: its syncword and header CRC (its ScF-CRC
    protects the next frame's scalefactors, which a sample need not hold)."""
    if len(frame) < 6 or frame[0] != 0xFF or frame[1] >> 4 != 0xF:
        return False
    try:
        return bool(parse_frame(frame).get("crc_ok"))
    except (AssertionError, IndexError, KeyError, ValueError):
        return False


def frame_bytes(packer, prev, out, i):
    """Station i's frame of the step outputs `prev`, its ScF-CRC bytes
    those of the next frame's outputs `out` (as Mp2Packer.emit patches)."""
    frame, off, _ = packer._pack_one(i, prev, None)
    cfg = packer.cfg
    nch, sblimit, ext = int(cfg.nch[i]), int(cfg.sblimit[i]), int(cfg.dab_ext[i])
    frame[off:off + ext] = bytes(
        scf_crc(out["bit_alloc"][i], out["scfsi"][i], out["sf_index"][i], nch, sblimit, k)
        for k in range(ext - 1, -1, -1))
    return bytes(frame)


def expected(config, workload, prog, keys, device, dtype=torch.float64):
    """{(k, i): bytes} of the drains `keys` (k >= 2)."""
    if config["encoder"]["psy_model"] != 1:
        raise NotImplementedError("the reference encodes through psy model 1 alone")
    specs = station_specs(config, workload)
    res = {}
    for b in range(0, len(keys), BLOCK):
        block = keys[b:b + BLOCK]
        cfg = make_config([specs[i] for _, i in block])
        enc = Mp2Encoder(cfg, dtype=dtype, device=device)
        packer = Mp2Packer(cfg)
        pcm = np.stack([prog.station(i, k - 2, 3) for k, i in block])     # [B, 2, 3 * 1152]
        state = enc.init_state()
        outs = []
        for f in range(3):
            state, out = enc.encode_step(state, pcm[..., f * 1152:(f + 1) * 1152])
            outs.append(to_numpy(out))
        res.update((key, frame_bytes(packer, outs[1], outs[2], r)) for r, key in enumerate(block))
    return res


class Driver:
    """The reference put in the program's place (the control): the whole
    batch on the device in `dtype`, the drain packing only the rows asked
    for (frame k - 1, patched with frame k's ScF-CRC)."""

    def __init__(self, config, workload, device, dtype):
        cfg = make_config(station_specs(config, workload))
        self.enc = Mp2Encoder(cfg, dtype=dtype, device=device)
        self.packer = Mp2Packer(cfg)
        self.state = self.enc.init_state()
        self.xpad = torch.zeros((cfg.n_streams,), dtype=torch.int64, device=device)
        self.prev = None

    def dispatch(self, pcm):
        self.state, out = self.enc._encode_step(self.state, pcm[0], self.xpad)
        return out

    def drain(self, out, rows):
        prev, self.prev = self.prev, out
        if prev is None:
            return [b""] * len(rows)
        return [frame_bytes(self.packer, prev, out, i) for i in rows]
