"""Entry point of the port: the flagship encode step, ready to call.

The twin of the JAX package's `__graft_entry__.entry()`: batched 48 kHz
stereo MP2 at 128 kbps joint stereo, psy model 1, f32 fast path, S=8.
"""
import torch

from .device import default_device
from .mp2.model import Mp2Encoder, make_config


def entry(device=None, n_streams=8):
    """Returns (fn, example_args): fn(state, pcm, xpad) runs one encode step
    of the flagship configuration on `device` (default: the card; raises
    where there is none, so the CPU takes device="cpu")."""
    device = torch.device(device) if device is not None else default_device()
    cfg = make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}] * n_streams)
    enc = Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=device)
    state = enc.init_state()
    pcm = torch.zeros((n_streams, 2, 1152), dtype=torch.int16, device=device)
    xpad = torch.zeros((n_streams,), dtype=torch.int32, device=device)

    def fn(state, pcm, xpad):
        return enc._encode_step(state, pcm, xpad)

    return fn, (state, pcm, xpad)
