#!/usr/bin/env python3
"""Drive the PyTorch port's MP2 main path on one CUDA card and check it.

Usage (from the root of a checkout, on a machine with one NVIDIA card):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. card: name and power limit (nvidia-smi); build the tonal-walk kernel
     from odr_audioenc_tpu_torch/csrc/ and time the build.
  2. kernel vs its plain version on the card: the random B=64 recipe and
     real psy-1 spectra at B=4096 (S=2048 streams); masks equal, power'
     within 1e-3 dB; median times of both with CUDA events.
  3. exact path on the card: the golden config music_48s_128_j_psy1 (40
     frames) in f64 through the shared host packer, byte-exact.
  4. main path at full width: S=2048 streams, 48 kHz stereo 128k joint,
     f32 fast path, pack_on_device="frame", music-like PCM with per-stream
     offsets; 3 warm-up + 20 timed steps through Mp2Packer.emit.  Every
     frame parses with a valid CRC, the frame count is right, the kernel
     ran once per step, and the first 8 streams re-encoded on the CPU (the
     plain version) agree: >= 90% of frames with the same allocation, and
     SMR within 0.5 dB in >= 99% of subbands whose scalefactor agrees (max
     3 dB, the JAX fast path's own bound against the exact path).  cuBLAS
     and the CPU's BLAS sum the f32 spectrum in different orders, which
     flips a few local-maximum candidates and moves those subbands' SMR.

Prints, before the last line, the card line and one JSON line with the
kernel's figures; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
S_FULL = 2048
WARMUP, TIMED = 3, 20
FRAME_S = 1152 / 48000.0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _parse_ok(frames):
    from odr_audioenc_tpu.host import mp2parse
    return [bool(mp2parse.parse_frame(f)["crc_ok"]) for f in frames]


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def cuda_median_ms(fn, reps, torch):
    """Median of per-call CUDA-event times (warm, back to back)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def music_pcm(n_streams, n_frames, seed):
    """[n_frames, S, 2, 1152] int16: one music-like signal, read by every
    stream from its own offset (so streams differ, as stations do)."""
    import numpy as np
    from signals import music_like
    need = n_frames * 1152
    src = music_like(n_frames + 48, seed=seed)                  # [2, N]
    offs = np.random.default_rng(seed).integers(0, src.shape[1] - need, n_streams)
    idx = offs[:, None] + np.arange(need)[None, :]
    pcm = src[:, idx]                                           # [2, S, need]
    return np.ascontiguousarray(pcm.reshape(2, n_streams, n_frames, 1152)
                                .transpose(2, 1, 0, 3))


def main():
    check((ROOT / "odr_audioenc_tpu_torch").is_dir() and (ROOT / "tests" / "golden").is_dir(),
          f"{ROOT} is not a checkout of the repository")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "tools")]
    import numpy as np
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(torch.cuda.device_count() >= 1, "no CUDA device")

    from odr_audioenc_tpu.host import mp2parse
    from odr_audioenc_tpu.host.mp2pack import Mp2Packer
    from odr_audioenc_tpu_torch import convert
    from odr_audioenc_tpu_torch.kernels import build
    from odr_audioenc_tpu_torch.mp2 import model, psycho1, psycho1_fast, psycho1_kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load("tonal_walk")
    print(f"phase 1: built tonal_walk in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- phase 2: kernel vs plain version ---------------------------------------
    def compare(power):
        """Kernel vs tonal_fast on one spectrum: masks equal, power' < 1e-3."""
        cand = psycho1.tonal_candidates(power)
        pk, mk, yk = psycho1_kernels.tonal_walk(power, cand)
        pp, mp, yp = psycho1_fast.tonal_fast(power, cand)
        torch.cuda.synchronize()
        B = power.shape[0]
        check(torch.equal(mk, mp) and torch.equal(yk, yp), f"B={B}: kernel masks differ")
        e = float((pk - pp).abs().max())
        check(e < 1e-3, f"B={B}: power' differs by {e} dB")
        return cand, e

    rng = np.random.default_rng(7)
    _, err = compare(torch.as_tensor(rng.uniform(-90, 40, (64, 512)).astype(np.float32),
                                     device=dev))
    pcm1 = music_pcm(S_FULL, 2, seed=5)[1]                      # [S, 2, 1152]
    win = torch.as_tensor(pcm1[..., 128:].reshape(2 * S_FULL, 1024), device=dev)
    power, _, _ = psycho1.power_spectrum(win.to(torch.float32) / 32768.0)
    cand, e = compare(power)
    err = max(err, e)
    k_ms = cuda_median_ms(lambda: psycho1_kernels.tonal_walk(power, cand), 50, torch)
    p_ms = cuda_median_ms(lambda: psycho1_fast.tonal_fast(power, cand), 20, torch)
    print(f"phase 2: tonal_walk == tonal_fast (masks equal, max |dpower'| {err:.3g} dB); "
          f"B={2 * S_FULL}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]", flush=True)

    # ---- phase 3: exact path, golden bytes, on the card ----------------------------
    import gen_golden
    name = "music_48s_128_j_psy1"
    frames, _ = gen_golden.make_input(name)
    cfg1 = model.make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}])
    enc = model.Mp2Encoder(cfg1, psy_model=1, dtype=torch.float64, device=dev)
    packer = Mp2Packer(cfg1)
    state, chunks = enc.init_state(), []
    t0 = time.perf_counter()
    for f in frames:
        state, out = enc.encode_step(state, f[None])
        chunks += packer.emit(convert.to_numpy(out))
    chunks += packer.finish()
    want = (ROOT / "tests" / "golden" / f"{name}.mp2").read_bytes()
    got = b"".join(chunks)
    bad = [i for i, (a, b) in enumerate(zip(mp2parse.split_frames(got),
                                            mp2parse.split_frames(want))) if a != b]
    check(got == want, f"phase 3: golden {name} differs on the card (frames {bad[:5]})")
    print(f"phase 3: golden {name} byte-exact on the card, f64, {len(frames)} frames "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- phase 4: main path at full width -------------------------------------------
    steps = WARMUP + TIMED
    pcm = music_pcm(S_FULL, steps, seed=11)                     # [steps, S, 2, 1152]
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * S_FULL
    cfg = model.make_config(streams)
    enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev,
                           pack_on_device="frame")
    packer = Mp2Packer(cfg)
    state = enc.init_state()
    torch.cuda.synchronize()
    per_stream = [[] for _ in range(S_FULL)]
    psycho1_kernels.launches = 0
    step_s = []
    for t in range(steps):
        t0 = time.perf_counter()
        state, out = enc.encode_step(state, pcm[t])
        emitted = packer.emit({"wire": out["wire"].cpu().numpy()})
        step_s.append(time.perf_counter() - t0)
        for i, b in enumerate(emitted):
            if b:
                per_stream[i].append(b)
    launches = psycho1_kernels.launches
    for i, b in enumerate(packer.finish()):
        per_stream[i].append(b)
    check(launches == steps, f"phase 4: tonal_walk launched {launches} times in {steps} steps")
    check(all(len(f) == steps for f in per_stream), "phase 4: wrong frame count")
    flat = [f for fs in per_stream for f in fs]
    n_proc = min(8, os.cpu_count() or 1)
    chunk = -(-len(flat) // (4 * n_proc))
    with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
        ok = [x for part in pool.map(_parse_ok, [flat[i:i + chunk] for i in
                                                 range(0, len(flat), chunk)]) for x in part]
    check(len(ok) == S_FULL * steps and all(ok), "phase 4: a frame fails its CRC")
    step_ms = 1000.0 * statistics.mean(step_s[WARMUP:])
    rt = S_FULL * FRAME_S / (step_ms / 1000.0)

    # the first 8 streams re-encoded on the CPU (the plain version)
    n8 = 8
    cfg8 = model.make_config(streams[:n8])
    cpu8 = model.Mp2Encoder(cfg8, psy_model=1, dtype=torch.float32, device="cpu",
                            pack_on_device="frame")
    pk8 = Mp2Packer(cfg8)
    st8, cpu_frames = cpu8.init_state(), [[] for _ in range(n8)]
    for t in range(steps):
        st8, out8 = cpu8.encode_step(st8, pcm[t, :n8])
        for i, b in enumerate(pk8.emit(convert.to_numpy(out8))):
            if b:
                cpu_frames[i].append(b)
    for i, b in enumerate(pk8.finish()):
        cpu_frames[i].append(b)
    same_ba, sf_flip, total = 0, 0, 0
    for i in range(n8):
        for a, b in zip(per_stream[i], cpu_frames[i]):
            pa, pb = mp2parse.parse_frame(a), mp2parse.parse_frame(b)
            same_ba += np.array_equal(pa["bit_alloc"], pb["bit_alloc"])
            both = (pa["bit_alloc"] > 0) & (pb["bit_alloc"] > 0)
            sf_flip += int((pa["sf"][:, 0][both] != pb["sf"][:, 0][both]).sum())
            total += 1
    # SMR: the card's and the CPU's fast path on the same 8 streams
    gpu8 = model.Mp2Encoder(cfg8, psy_model=1, dtype=torch.float32, device=dev)
    cpu8s = model.Mp2Encoder(cfg8, psy_model=1, dtype=torch.float32, device="cpu")
    sg, sc = gpu8.init_state(), cpu8s.init_state()
    diffs, flips, cand_flips = [], 0, 0
    for t in range(steps):
        sg, og = gpu8.encode_step(sg, pcm[t, :n8])
        sc, oc = cpu8s.encode_step(sc, pcm[t, :n8])
        og, oc = convert.to_numpy(og), convert.to_numpy(oc)
        alike = og["sf_index"].min(axis=2) == oc["sf_index"].min(axis=2)
        flips += int((~alike).sum())
        diffs.append(np.abs(og["smr"] - oc["smr"])[alike])
        if t:   # the psy-1 window of step t, as _encode_step builds it
            w = np.concatenate([pcm[t - 1, :n8, :, 960:], pcm[t, :n8, :, :832]], -1)
            w = torch.as_tensor(w.reshape(2 * n8, 1024).astype(np.float32) / 32768.0)
            cg = psycho1.tonal_candidates(psycho1.power_spectrum(w.to(dev))[0]).cpu()
            cand_flips += int((cg != psycho1.tonal_candidates(psycho1.power_spectrum(w)[0]))
                              .sum())
    d = np.concatenate(diffs)
    smr_diff, over = float(d.max()), float((d > 0.5).mean())
    check(same_ba >= 0.9 * total, f"phase 4: only {same_ba}/{total} frames allocate as on CPU")
    check(over <= 0.01 and smr_diff < 3.0,
          f"phase 4: SMR vs CPU: {over:.2%} of subbands beyond 0.5 dB, max {smr_diff} dB")
    check(flips <= 0.01 * steps * n8 * 64, f"phase 4: {flips} scalefactor flips vs CPU")
    print(f"phase 4: S={S_FULL} f32 fast path, frame pack: {steps} steps, {len(flat)} frames "
          f"CRC-valid, {launches} kernel launches; step {step_ms:.3f} ms "
          f"(mean of {TIMED}), {rt:.1f} streams x realtime [{card}]; first {n8} streams vs "
          f"CPU: {same_ba}/{total} frames same bit_alloc, {sf_flip} transmitted-scf "
          f"differences; SMR |diff| max {smr_diff:.4f} dB, p99 {np.quantile(d, 0.99):.4f} dB, "
          f"{over:.3%} of {d.size} beyond 0.5 dB ({flips} scf-min flips, {cand_flips} "
          f"tonal-candidate flips in {(steps - 1) * 2 * n8 * 512} bins)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "tonal_walk", "route": "cuda",
        "source": "odr_audioenc_tpu_torch/csrc/tonal_walk.cu",
        "replaces": "odr_audioenc_tpu/mp2/psycho1_pallas.py:140",
        "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
