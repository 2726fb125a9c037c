"""Entry points of the port: the flagship encode step, ready to call, and
the multi-device dry run.

`entry` is the twin of the JAX package's `__graft_entry__.entry()`: batched
48 kHz stereo MP2 at 128 kbps joint stereo, psy model 1, f32 fast path, S=8.
`dryrun_multichip` is the twin of its `dryrun_multichip`: the stream axis
split over n devices, one MP2 step and one DAB+ superframe step (LC, HE-AAC,
HE-AAC v2) with the device pack on every shard.
"""
import numpy as np
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


# the DAB+ profiles of the dry run: (label, (rate, subch, channels), aot)
DRYRUN_DABPLUS = (("DAB+ LC", (48000, 12, 2), "lc"),
                  ("HE-AAC", (48000, 6, 1), "sbr"),
                  ("HE-AAC v2 (PS)", (48000, 4, 2), "ps"))


def dryrun_multichip(n_devices, device=None):
    """Split S = 2 * n_devices streams into n_devices shards and run one
    full encode step on each: MP2 (48 kHz stereo 128k joint, psy 1, f32) and
    one superframe of DAB+ LC, HE-AAC and HE-AAC v2 with pack_on_device=True.
    The encoder is stream-parallel (no math crosses streams), so every
    shard has its own encoder with its own copy of the tables and there are
    no collectives.

    By default (device None or "cuda") shard i runs on cuda:i; raises if the
    host has fewer cards than n_devices.  With device="cpu" the shards run
    one after another on the CPU.  Any other device raises.  Either way the
    unsplit batch runs too (on cuda:0 or the CPU), and each line printed
    says how many of the shards' rows (MP2 bit_alloc, DAB+ wire) equal its
    rows.  On the CPU, and with one card (the shard is the batch), all must:
    the CPU comparison runs on one thread, since with more a float reduction
    is split over the threads by the batch's size, its last bit moves with
    the split, and a rate-loop decision at a boundary can move with it.
    Across cards the count is only reported: a GEMM may pick another kernel
    for another batch size."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu") or dev.index is not None:
        raise ValueError(f"device must be None, 'cuda' or 'cpu', not {device!r}")
    if dev.type == "cuda":
        return _dryrun(n_devices, False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _dryrun(n_devices, True)
    finally:
        torch.set_num_threads(threads)


def _dryrun(n_devices, on_cpu):
    from .dabplus.model import DabPlusConfig, DabPlusEncoder

    if on_cpu:
        devs = [torch.device("cpu")] * n_devices
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
        devs = [torch.device("cuda", i) for i in range(n_devices)]

    S, per = 2 * n_devices, 2
    rng = np.random.default_rng(0)

    def run_shards(step, pcm, key):
        """step(device, n_streams, pcm rows) -> outputs.  Returns the shards'
        `key` rows, concatenated on the host, and how many of them equal the
        unsplit batch's."""
        rows = [step(d, per, pcm[i * per:(i + 1) * per])[key] for i, d in enumerate(devs)]
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        got = torch.cat([r.cpu() for r in rows], 0)
        want = step(devs[0], S, pcm)[key].cpu()
        same = int((got == want).flatten(1).all(1).sum())
        if same < S and (on_cpu or n_devices == 1):
            raise AssertionError(f"{key}: {S - same} of {S} rows differ from the unsplit batch")
        return got, same

    def mp2_step(dev, n, pcm):
        cfg = make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}] * n)
        enc = Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev)
        xpad = torch.zeros((n,), dtype=torch.int32, device=dev)
        return enc._encode_step(enc.init_state(), torch.as_tensor(pcm, device=dev), xpad)[1]

    pcm = rng.integers(-3000, 3000, (S, 2, 1152)).astype(np.int16)
    ba, same = run_shards(mp2_step, pcm, "bit_alloc")
    assert ba.shape == (S, 2, 32)
    print(f"dryrun_multichip (MP2): {n_devices} devices, {S} streams OK, "
          f"{same} rows as the unsplit batch")

    for label, (rate, subch, nch), aot in DRYRUN_DABPLUS:
        dcfg = DabPlusConfig(rate, subch, nch, aot=aot)

        def dab_step(dev, n, pcm):
            enc = DabPlusEncoder(dcfg, n, dtype=torch.float32, device=dev, pack_on_device=True)
            return enc._superframe_step(enc.init_state(), torch.as_tensor(pcm, device=dev))[1]

        dpcm = rng.integers(-3000, 3000, (S, nch, dcfg.num_aus * dcfg.au_samples)).astype(np.int16)
        wire, same = run_shards(dab_step, dpcm, "wire")
        assert wire.shape[0] == S
        assert wire.shape[1] >= 120 * subch          # RS'd superframe bytes
        print(f"dryrun_multichip ({label}, device pack): {n_devices} devices, {S} streams OK, "
              f"{same} rows as the unsplit batch")


if __name__ == "__main__":      # python -m odr_audioenc_tpu_torch.entry N [cpu]
    import sys
    dryrun_multichip(int(sys.argv[1]), *sys.argv[2:3])
