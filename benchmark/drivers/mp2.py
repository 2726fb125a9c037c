"""The MP2 path of the port, as the fleet runtime drives an MP2 group.

dispatch: Mp2Encoder._encode_step(state, pcm, xpad_len) carrying the state,
psy model 1 in float32 with the frame packed on the device (`wire`);
drain: Mp2Packer.emit, which patches each frame's ScF-CRC into the previous
frame and so emits, at step k, every station's frame k - 1.
"""
import torch

from benchmark.stations import station_specs


class Driver:
    def __init__(self, config, workload, device):
        from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
        from odr_audioenc_tpu_torch.mp2.model import Mp2Encoder, make_config
        S = workload["stations"]
        cfg = make_config(station_specs(config, workload))
        e = config["encoder"]
        self.enc = Mp2Encoder(cfg, psy_model=e["psy_model"], dtype=getattr(torch, e["dtype"]),
                              device=device, pack_on_device=e["pack_on_device"])
        self.packer = Mp2Packer(cfg)
        self.state = self.enc.init_state()
        self.xpad = torch.zeros((S,), dtype=torch.int64, device=device)

    def dispatch(self, pcm):
        """pcm: [1, S, 2, 1152] int16 on the device -> the step's outputs."""
        self.state, out = self.enc._encode_step(self.state, pcm[0], self.xpad)
        return out

    def drain(self, out, rows):
        """out: the step's outputs as numpy -> the bytes emitted for `rows`."""
        emitted = self.packer.emit(out)
        return [emitted[i] for i in rows]

    @staticmethod
    def counters():
        from odr_audioenc_tpu_torch.mp2 import psycho1_kernels
        return {"tonal_walk_launches": psycho1_kernels.launches,
                "tonal_noise_launches": psycho1_kernels.noise_launches}
