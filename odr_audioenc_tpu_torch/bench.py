"""Full-path throughput of the port on the card: concurrent streams x
realtime on the five BASELINE cells, each through its device step, the copy
of its outputs to pinned host memory and the host's emit, pipelined one
step deep as the fleet runtime runs (the counterpart of the repository's
root bench.py, which drives the JAX package).

Cells (BASELINE.md):
  mp2_128   MP2 48 kHz stereo 128 kbps joint, psy 1 f32 with the tonal-walk
            kernel, the frame packed on the device; Mp2Packer.emit on the
            host;
  lc_96     DAB+ AAC-LC 48 kHz stereo 96 kbps (12 subchannels), AU syntax,
            superframe and RS packed on the device; the host slices the
            wire rows (pack_superframes);
  sbr_48    HE-AAC 48 kbps mono (6 subchannels), likewise;
  ps_32     HE-AAC v2 32 kbps stereo (4 subchannels), likewise;
  fleet_64  64 mixed stations through fleet.run_fleet, with file sinks and
            stats sockets, 30 s of music each.
The four device cells run S streams of int16 noise from one
np.random.default_rng(0), drawn in the order above and uploaded once.
The headline is the harmonic mean of the five rates, against the north
star of 1024 streams x 10x realtime.

Usage, on a machine with a CUDA card:

    python -m odr_audioenc_tpu_torch.bench

BENCH_STREAMS (default 2048) and BENCH_ITERS (default 10) set S and the
timed steps of the device cells.  Prints one line per cell, then one JSON
line {"metric", "value", "unit", "vs_baseline"}.  Without a card it raises.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from . import fleet
from .device import default_device

BASELINE = 1024 * 10            # north star: 1024 streams x 10x realtime
FRAME_S = 1152 / 48000.0        # one MP2 frame
SUPERFRAME_S = 5760 / 48000.0   # one DAB+ superframe
# the DAB+ cells: (8 kbps subchannels, channels, aot)
DABPLUS_CELLS = {"lc_96": (12, 2, "lc"), "sbr_48": (6, 1, "sbr"), "ps_32": (4, 2, "ps")}
CELLS = ("mp2_128",) + tuple(DABPLUS_CELLS) + ("fleet_64",)

# figures of each cell's last run (read by chip_smoke.py and the tests), as
# fleet.last_run: {cell: {"rate", "steps", "last", "ms", "S", "launches",
# "device", ...}}; "steps" counts the dispatches (fleet_64: the passes),
# "last" holds each stream's bytes of the last drain, "launches" the
# (tonal_walk, tonal_noise) kernel launches of the cell
last_cells = {}


def _full_path_throughput(dispatch, drain, audio_s, streams, iters):
    """One-step-deep pipeline: step k+1 is dispatched and the copy of its
    outputs into pinned host buffers enqueued (fleet._Transfers, two slots)
    before drain(k) runs on the host.  dispatch() returns the step's
    outputs (a dict of tensors); drain takes their numpy copies.  Returns
    streams x realtime over the `iters` timed steps."""
    io = []

    def prefetch(out):
        if not io:
            io.append(fleet._Transfers(next(iter(out.values())).device))
        return io[0].download(out)

    pend = prefetch(dispatch())       # warm: tables, FFT plans, allocator, kernel loads
    drain(io[0].wait(pend))
    pend = prefetch(dispatch())
    t0 = time.perf_counter()
    for _ in range(iters):
        nxt = prefetch(dispatch())    # the device step and its D2H enqueued
        drain(io[0].wait(pend))       # host emit / slicing of the previous step
        pend = nxt
    dt = (time.perf_counter() - t0) / iters
    drain(io[0].wait(pend))
    return streams * audio_s / dt


def _launches():
    from .mp2 import psycho1_kernels
    return psycho1_kernels.launches, psycho1_kernels.noise_launches


def _run_cell(name, dispatch, drain, audio_s, S, iters):
    """_full_path_throughput of one device cell, recorded in last_cells."""
    rec = last_cells[name] = {"steps": 0}

    def counted(out):
        rec["steps"] += 1
        rec["leaves"] = sorted(out)
        rec["d2h_bytes"] = sum(v.numel() * v.element_size() for v in out.values())
        rec["device"] = str(next(iter(out.values())).device)
        return out

    def kept(out_np):
        rec["last"] = drain(out_np)

    before = _launches()
    rate = _full_path_throughput(lambda: counted(dispatch()), kept, audio_s, S, iters)
    after = _launches()
    rec.update(rate=rate, S=S, ms=1000.0 * S * audio_s / rate,
               launches=(after[0] - before[0], after[1] - before[1]))
    return rate


def cell_inputs(S, device):
    """Each device cell's PCM [S, ch, n] int16 on `device`, drawn from one
    np.random.default_rng(0) in the cells' order."""
    rng = np.random.default_rng(0)
    shapes = {"mp2_128": (S, 2, 1152)}
    shapes.update((name, (S, ch, 5760)) for name, (_, ch, _) in DABPLUS_CELLS.items())
    return {name: torch.as_tensor(rng.integers(-16000, 16000, shape).astype(np.int16),
                                  device=device) for name, shape in shapes.items()}


def mp2_128_rate(pcm, iters):
    """mp2_128 on pcm [S, 2, 1152] (on the encoder's device): the psy-1 f32
    step with the frame pack, carrying its state; the drain emits the
    frames through Mp2Packer."""
    from .host.mp2pack import Mp2Packer
    from .mp2.model import Mp2Encoder, make_config
    S = pcm.shape[0]
    cfg = make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}] * S)
    enc = Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=pcm.device,
                     pack_on_device="frame")
    packer = Mp2Packer(cfg)
    xpad = torch.zeros((S,), dtype=torch.int64, device=pcm.device)
    state = [enc.init_state()]

    def dispatch():
        state[0], out = enc._encode_step(state[0], pcm, xpad)
        return out

    return _run_cell("mp2_128", dispatch, packer.emit, FRAME_S, S, iters)


def dabplus_rate(name, pcm, iters):
    """One of the DAB+ cells on pcm [S, ch, 5760]: the superframe step with
    the device pack (its one output is the `wire` rows); the drain slices
    each stream's superframe, RS included."""
    from .dabplus.model import DabPlusConfig, DabPlusEncoder
    subch, ch, aot = DABPLUS_CELLS[name]
    S = pcm.shape[0]
    enc = DabPlusEncoder(DabPlusConfig(48000, subch, ch, aot=aot), n_streams=S,
                         dtype=torch.float32, device=pcm.device, pack_on_device=True)
    state = [enc.init_state()]

    def dispatch():
        state[0], out = enc.encode_superframes(state[0], pcm, pack=False)
        return out

    return _run_cell(name, dispatch, lambda out: enc.pack_superframes(out, add_rs=True),
                     SUPERFRAME_S, S, iters)


def _signals():
    """tests/signals.py, the repository's deterministic test signals."""
    tests = str(Path(__file__).resolve().parent.parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import signals
    return signals


def fleet64_streams(tmp, wav, wav1):
    """BASELINE config 5: 32 MP2 stations at 128/192/96/160 kbps, joint
    stereo and stereo alternating; 16 DAB+ LC 96k stereo; 8 HE-AAC 48k mono;
    8 HE-AAC v2 32k stereo; all 48 kHz, each with a file sink and a stats
    socket in `tmp`."""
    streams = []
    for i in range(64):
        if i < 32:
            spec = {"codec": "mp2", "bitrate": [128, 192, 96, 160][i % 4], "mode": "js"[i % 2]}
        elif i < 48:
            spec = {"codec": "dabplus", "bitrate": 96, "channels": 2}
        elif i < 56:
            spec = {"codec": "dabplus", "bitrate": 48, "channels": 1}
        else:
            spec = {"codec": "dabplus", "bitrate": 32, "channels": 2}
        spec.update(rate=48000, input=wav1 if spec.get("channels") == 1 else wav,
                    output=os.path.join(tmp, f"out{i}.bin"),
                    stats=os.path.join(tmp, f"stats{i}.sock"))
        streams.append(spec)
    return streams


def fleet64_rate(seconds=30.0, device=None):
    """fleet_64: the 64 stations of fleet64_streams through the fleet
    runtime, each reading `seconds` of music (signals.music_like tiled).
    Returns run_fleet's streams x realtime over the passes after its two
    warm ones.  last_cells["fleet_64"]["last"]: each station's bytes of its
    group's last drain (k frames or superframes)."""
    sig = _signals().music_like(30)
    n = int(round(48000 * seconds))
    sig = np.tile(sig, (1, -(-n // sig.shape[1])))[:, :n]
    before = _launches()
    with tempfile.TemporaryDirectory(prefix="bench_fleet_") as tmp:
        wav, wav1 = os.path.join(tmp, "in.wav"), os.path.join(tmp, "in_mono.wav")
        for path, ch in ((wav, 2), (wav1, 1)):
            with wave.open(path, "wb") as w:
                w.setnchannels(ch)
                w.setsampwidth(2)
                w.setframerate(48000)
                w.writeframes(sig[:ch].T.astype("<i2").tobytes())
        streams = fleet64_streams(tmp, wav, wav1)
        try:
            rate = fleet.run_fleet({"streams": streams}, device=device)
        finally:
            # StatsPublisher binds the reference's /tmp/odr-audioenc.<pid>
            Path(f"/tmp/odr-audioenc.{os.getpid()}").unlink(missing_ok=True)
        run = fleet.last_run
        # run_fleet groups MP2 by rate, DAB+ by (rate, bitrate, channels,
        # pad_len, aot): here one group per codec and (bitrate, channels)
        k = {}
        for g in run["groups"]:
            k[g["key"][0] if g["key"][0] == "mp2" else g["key"][2:4]] = g["k"]
        last, sizes = [], []
        for s in streams:
            data = Path(s["output"]).read_bytes()
            if s["codec"] == "mp2":
                n_last = k["mp2"] * 3 * s["bitrate"]
            else:
                n_last = k[(s["bitrate"], s["channels"])] * 15 * s["bitrate"]
            last.append(data[-n_last:])
            sizes.append(len(data))
    after = _launches()
    passes = max(g["chunks"] for g in run["groups"])
    last_cells["fleet_64"] = {
        "rate": rate, "steps": passes, "last": last, "sizes": sizes, "S": len(streams),
        "ms": 1000.0 * run["wall_s"] / max(1, passes - 2), "device": run["device"],
        "launches": (after[0] - before[0], after[1] - before[1]),
        "groups": [{key: g[key] for key in ("key", "streams", "k", "chunks")}
                   for g in run["groups"]]}
    return rate


def card_line(device):
    """The card's name, and its name and power limit as nvidia-smi gives
    them; "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    smi = "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())
    return f"{torch.cuda.get_device_name(device)}; {smi}"


def cell_line(name, card):
    c = last_cells[name]
    what = "pass of 0.96 s" if name == "fleet_64" else "step"
    return (f"bench: {name}: {c['rate']:.3f} streams x realtime; {c['ms']:.3f} ms per {what} "
            f"(mean of the timed ones, {c['steps']} in all), S={c['S']} [{card}]")


def run_cells(S, iters, device, card, fleet_seconds=30.0):
    """The five cells in order, the four device cells at S streams and
    `iters` timed steps; prints each cell's line (with `card`) as it ends.
    Returns {cell: streams x realtime}."""
    pcms = cell_inputs(S, device)
    rates = {"mp2_128": mp2_128_rate(pcms.pop("mp2_128"), iters)}
    print(cell_line("mp2_128", card), flush=True)
    for name in DABPLUS_CELLS:
        rates[name] = dabplus_rate(name, pcms.pop(name), iters)
        print(cell_line(name, card), flush=True)
    rates["fleet_64"] = fleet64_rate(fleet_seconds, device)
    print(cell_line("fleet_64", card), flush=True)
    return rates


def headline(rates, S, device, card):
    """The bench's JSON line: the harmonic mean of the rates against the
    north star."""
    mixed = len(rates) / sum(1.0 / r for r in rates.values())
    detail = ", ".join(f"{k}={v:.1f}" for k, v in rates.items())
    return {"metric": f"concurrent 48kHz streams x realtime per card, full path (device step + "
                      f"device pack/RS + host send), 5-config fleet ({device.type} {card}, "
                      f"S={S}; {detail})",
            "value": round(mixed, 1),
            "unit": "streams*x",
            "vs_baseline": round(mixed / BASELINE, 4)}


def main(device=None):
    """The bench on the card (device=None; raises where there is none);
    the tests pass device="cpu".  Returns the JSON line's object."""
    device = torch.device(device) if device is not None else default_device()
    S = int(os.environ.get("BENCH_STREAMS", "2048"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    card = card_line(device)
    rates = run_cells(S, iters, device, card)
    line = headline(rates, S, device, card)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
