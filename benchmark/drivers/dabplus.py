"""The DAB+ path of the port, as the fleet runtime drives a DAB+ group.

dispatch: DabPlusEncoder.encode_superframes(state, pcm, pack=False) with the
device pack (AU syntax, superframe, firecode and RS on the card; one `wire`
output); drain: pack_superframes(out, add_rs=True), which slices each
station's superframe.
"""
import torch


class Driver:
    def __init__(self, config, workload, device):
        from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig, DabPlusEncoder
        e = config["encoder"]
        cfg = DabPlusConfig(config["sample_rate"], config["subch"], config["channels"],
                            aot=config["aot"])
        self.enc = DabPlusEncoder(cfg, n_streams=workload["stations"],
                                  dtype=getattr(torch, e["dtype"]), device=device,
                                  pack_on_device=e["pack_on_device"])
        self.state = self.enc.init_state()

    def dispatch(self, pcm):
        """pcm: [1, S, ch, 5760] int16 on the device -> the step's outputs."""
        self.state, out = self.enc.encode_superframes(self.state, pcm[0], pack=False)
        return out

    def drain(self, out, rows):
        frames = self.enc.pack_superframes(out, add_rs=True)
        return [frames[i] for i in rows]

    def counters(self):
        return {"recover_checks": self.enc.recover_checks,
                "recoveries": int(self.enc.recoveries)}
