"""What a DAB+ station emits, from its audio alone.

The DAB+ step carries the bit reservoir, the MDCT and block-switching
history and the pre-echo state from superframe to superframe, so the
reference encodes each sampled station from the start of its stream
through the last compared step, all sampled stations in one batch, through
the exact float64 encoder, the Python AU writer, the superframe packer and
RS(120, 110).
"""
import numpy as np
import torch

from benchmark.reference.dabplus.model import DabPlusConfig, DabPlusEncoder
from benchmark.reference.host.dabplus_parse import validate_superframe

UNIT = "superframes"


def valid(superframe):
    """The superframe's own integrity: RS(120, 110), the firecode, the AU
    order and every AU's CRC."""
    if len(superframe) == 0 or len(superframe) % 120:
        return False
    try:
        return validate_superframe(superframe)[0]
    except (IndexError, ValueError):
        return False


def dabplus_config(config):
    return DabPlusConfig(config["sample_rate"], config["subch"], config["channels"],
                         aot=config["aot"])


def pack_rows(enc, out, rows):
    """The superframes (RS included) of `rows` of a step's numpy outputs."""
    return [enc.packer.assemble([enc.write_au(out, s, a) for a in range(enc.cfg.num_aus)],
                                add_rs=True) for s in rows]


def expected(config, workload, prog, keys, device, dtype=torch.float64):
    """{(k, i): bytes} of the drains `keys`."""
    stations = sorted({i for _, i in keys})
    want = {}
    for k, i in keys:
        want.setdefault(k, []).append(i)
    enc = DabPlusEncoder(dabplus_config(config), n_streams=len(stations), dtype=dtype,
                         device=device)
    row = {i: r for r, i in enumerate(stations)}
    state = enc.init_state()
    res = {}
    for k in range(max(want) + 1):
        pcm = np.stack([prog.station(i, k, 1) for i in stations])
        state, out = enc._superframe_step(state, torch.as_tensor(pcm, device=device))
        if k in want:
            out = {key: v.cpu().numpy() for key, v in out.items()}
            frames = pack_rows(enc, out, [row[i] for i in want[k]])
            res.update(((k, i), f) for i, f in zip(want[k], frames))
    return res


class Driver:
    """The reference put in the program's place (the control): the whole
    batch on the device in `dtype`, the drain packing only the rows asked
    for."""

    def __init__(self, config, workload, device, dtype):
        self.enc = DabPlusEncoder(dabplus_config(config), n_streams=workload["stations"],
                                  dtype=dtype, device=device)
        self.state = self.enc.init_state()

    def dispatch(self, pcm):
        self.state, out = self.enc._superframe_step(self.state, pcm[0])
        return out

    def drain(self, out, rows):
        return pack_rows(self.enc, out, rows)
