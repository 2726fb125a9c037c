"""Where a DAB+ superframe step spends its time on one card.

    python -m odr_audioenc_tpu_torch.profile_dabplus [--out FILE]

Run from the root of a checkout, on a machine with one NVIDIA card.  For
each configuration (HE-AAC 48 kHz mono 48k, HE-AAC v2 stereo 32k, stereo
HE-AAC 64k, AAC-LC stereo 96k), at S=2048 streams in f32 on music-like PCM
(one seeded signal read by every stream from its own offset):
  - the superframe step without the profiler: 2 warm-up superframes, then
    the mean of 3 (host clock around the step and a sync), and the host
    pack (native, D2H included) of the same superframes;
  - one superframe under torch.profiler: the device events (kernels,
    memcpys, memsets), their summed time (device busy), the CUDA launch
    calls, the largest kernels by total time, and the device's idle share
    of the unprofiled step (1 - busy / step);
  - for HE-AAC, the same device figures for the stages of the step alone,
    on a copy of the state: the PS analysis and the SBR analysis (side
    analysis, coupling, payload and PS sizes, decimation); and the
    decimator (the stride-2 conv1d) by itself, timed with CUDA events
    (median of 20 calls).
Prints the card line and one JSON line (also written to FILE with --out).
"""
import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from .dabplus import model as M

S = 2048
CONFIGS = {
    "sbr48": M.DabPlusConfig(48000, 6, 1, aot="sbr"),
    "ps32": M.DabPlusConfig(48000, 4, 2, aot="ps"),
    "sbr64": M.DabPlusConfig(48000, 8, 2, aot="sbr"),
    "lc96": M.DabPlusConfig(48000, 12, 2),
}


def music_pcm(n_streams, n_sf, channels, seed=13, spf=5760, rate=48000):
    """[n_sf, S, ch, spf] int16: low-passed noise plus four tones under a
    slow envelope, read by every stream from its own offset."""
    rng = np.random.default_rng(seed)
    n = (n_sf + 8) * spf
    t = np.arange(n) / rate
    chans = []
    for c in range(channels):
        x = np.convolve(rng.normal(0, 0.08, n), np.hanning(31) / np.hanning(31).sum(), "same")
        for f0, amp in ((441.3, 0.22), (1333.7, 0.12), (3777.1, 0.05), (9212.9, 0.02)):
            x += amp * np.sin(2 * np.pi * f0 * (1 + 0.001 * c) * t + 0.7 * c)
        x *= np.interp(np.linspace(0, 15, n), np.arange(16), rng.uniform(0.05, 1.0, 16))
        chans.append(x)
    src = (np.clip(np.stack(chans), -0.999, 0.999) * 32767).astype(np.int16)
    offs = rng.integers(0, n - n_sf * spf, n_streams)
    idx = offs[:, None] + np.arange(n_sf * spf)[None, :]
    return np.ascontiguousarray(src[:, idx].reshape(channels, n_streams, n_sf, spf)
                                .transpose(2, 1, 0, 3))


def device_profile(fn, top=8):
    """Run fn() once under torch.profiler; returns its device figures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, count, launches, per = 0.0, 0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = (e.time_range.end - e.time_range.start) / 1000.0       # ms
            busy += d
            count += 1
            n, ms = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, ms + d)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            launches += 1
    largest = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_events": count, "device_busy_ms": busy, "launch_calls": launches,
            "profiled_wall_ms": 1000.0 * wall,
            "largest": [{"name": k[:120], "calls": n, "ms": ms} for k, (n, ms) in largest]}


def profile_config(name, S, dev):
    """The figures above for CONFIGS[name] at S streams on `dev`."""
    cfg = CONFIGS[name]
    enc = M.DabPlusEncoder(cfg, S, dtype=torch.float32, device=dev)
    n_warm, n_timed = 2, 3
    pcm = music_pcm(S, n_warm + n_timed + 1, cfg.channels)
    state = enc.init_state()
    step_s, pack_s = [], []
    for t in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = enc.encode_superframes(state, pcm[t], pack=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        enc.pack_superframes(out, add_rs=True)
        pack_s.append(time.perf_counter() - t1)
        step_s.append(t1 - t0)
    step_ms = 1000.0 * statistics.mean(step_s[n_warm:])
    x = torch.as_tensor(pcm[-1], device=dev)
    res = {"config": name, "S": S, "step_ms": step_ms,
           "host_pack_ms": 1000.0 * statistics.mean(pack_s[n_warm:]),
           "recover_checks_per_sf": enc.recover_checks / (n_warm + n_timed),
           "step": device_profile(lambda: enc.encode_superframes(dict(state), x, pack=False))}
    res["idle_share"] = 1.0 - res["step"]["device_busy_ms"] / step_ms
    if enc.is_sbr:
        # the stages alone, on the delayed stream the step builds
        xd = torch.cat([state["pend"], x.to(torch.float32)[..., :-cfg.au_samples]], -1)
        xs = xd
        if enc.is_ps:
            res["ps_analysis"] = device_profile(lambda: enc._ps_analysis(xd, dict(state)))
            xs, _, ps_out = enc._ps_analysis(xd, dict(state))
        else:
            ps_out = {}
        res["sbr_analysis"] = device_profile(
            lambda: enc._sbr_analysis(xs, dict(state), ps_out))
        xx = torch.cat([state["ds_hist"], xs], -1).reshape(-1, 1, xs.shape[-1] + M.DS_TAPS - 1)
        res["decimator_ms"] = event_ms(lambda: F.conv1d(xx, enc.ds_filter.view(1, 1, -1),
                                                        stride=2))
    return res


def event_ms(fn, reps=20):
    """Median of per-call CUDA-event times of fn() (a single launch, which
    a one-kernel profiler window can miss)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_dabplus needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    res = {"card": card, "torch": torch.__version__,
           "runs": [profile_config(c, S, dev) for c in CONFIGS]}
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
