#!/usr/bin/env python3
"""Drive the PyTorch port's MP2 and DAB+ AAC-LC main paths on one CUDA card
and check them.

Usage (from the root of a checkout, on a machine with one NVIDIA card):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. card: name and power limit (nvidia-smi); build both kernels from
     odr_audioenc_tpu_torch/csrc/ (one nvcc each, started together), time
     each build and print ptxas's registers / shared memory.
  2. tonal_walk vs its plain version on the card: the random B=64 recipe,
     real psy-1 spectra at B=4096 (S=2048 streams) and the ragged B=1 and
     B=4095 of them; masks equal, power' within 1e-3 dB; median times per
     call of the wrapper and of the plain version with CUDA events, and the
     device time (events over 200 back-to-back launches of the bare
     launcher, cycling over six copies of the inputs, / 200) beside the
     bound (bytes in and out at 3.35 TB/s).
  2b. tonal_noise (the fused tonal+noise kernel) vs its plain version
     tonal_noise_fast: B=64 random-window spectra and the B=4096, B=1 and
     B=4095 spectra of phase 2; tone members equal, at most one
     noise-member flip per row on average, power' within 1e-2 dB where both
     have a noise member and 1e-3 dB where neither has one; times as in 2.
  3. exact path on the card: the golden config music_48s_128_j_psy1 (40
     frames) in f64 through the port's host packer, byte-exact.
  3b. the same for psy models 0, 2 and 3: music_48s_128_j_psy0,
     music_48s_128_j_psy2 and tones_48s_192_s_psy3, byte-exact.
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
  4b. the main path of phase 4 with psy_kernel="fused-noise" on the same
     PCM: every frame CRC-valid, the fused kernel launched once per step
     and tonal_walk never, >= 90% of frames with phase 4's allocation.
  5. psy models 0, 2 and 3 on the f32 path at S=2048 (frame pack, a few
     steps each): every frame CRC-valid, step time printed.
  6. DAB+ AAC-LC main path at full width: 48 kHz stereo 96 kbps (subch 12,
     the lc_96 shape), S=2048 streams, f32, music-like PCM at per-stream
     offsets; 2 warm-up + 5 timed superframes through
     encode_superframes(pack=False) and pack_superframes(add_rs=True) with
     the native host packer (which must have built).  Every superframe is
     120*subch bytes and passes RS, the firecode and validate_superframe;
     on the first 8 streams every AU's counted bits equal its written length
     + 10, and their f32 re-encode on the CPU makes the same decisions
     (gains, books, window sequence) in >= 90% of AUs.  Prints the device
     step and the host pack separately, streams x realtime and the
     crash-recovery syncs per superframe.  No hand-written kernel is on this
     path: both launch counts must stay 0.
  6b. the same configuration in f64 on the card at S=8 for 3 superframes
     against the f64 port on the CPU: >= 99% of AUs with identical integer
     decisions and every superframe valid.

Every main-path run (4, 4b, 5, 6) sets the launch counts to 0 just before it
and reads them just after.  Every process the script starts (nvcc,
nvidia-smi, the CRC workers) is waited for, and before the result lines it
checks that no child process is left.  Prints, before the last line, the card line
and one JSON line with both kernels' figures; the last line is
{"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package: the port's own host
packers, RS and validators check every frame.
"""
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
    from odr_audioenc_tpu_torch.host import mp2parse
    return [bool(mp2parse.parse_frame(f)["crc_ok"]) for f in frames]


def _superframe_ok(frames):
    """DAB+ superframes: 120*subch bytes, RS, firecode and AU CRCs valid."""
    import numpy as np
    from odr_audioenc_tpu_torch.fec.rs import superframe_check_rs
    from odr_audioenc_tpu_torch.host.aacpack import firecode_crc
    from odr_audioenc_tpu_torch.host.dabplus_parse import validate_superframe
    return [len(f) % 120 == 0 and bool(superframe_check_rs(np.frombuffer(f, np.uint8)))
            and firecode_crc(f[2:11]) == (f[0] << 8 | f[1]) and validate_superframe(f)[0]
            for f in frames]


def all_crc_ok(flat, checker="_parse_ok"):
    """CRC check of every frame (`checker`: a function of this script
    taking a list of frames), run by child interpreters (one per core, at
    most 8), each of which is waited for.  No multiprocessing pool: its
    resource-tracker process would outlive the script."""
    n_proc = min(8, os.cpu_count() or 1)
    chunk = max(1, -(-len(flat) // n_proc))
    code = (f"import pickle, sys; sys.path[:0] = [{str(ROOT)!r}]; "
            f"from chip_smoke import {checker}; "
            f"sys.stdout.buffer.write(pickle.dumps({checker}(pickle.load(sys.stdin.buffer))))")

    def parse(part):
        res = subprocess.run([sys.executable, "-c", code], input=pickle.dumps(part),
                             capture_output=True, timeout=600)
        check(res.returncode == 0, f"CRC worker failed: {res.stderr.decode()[-2000:]}")
        return pickle.loads(res.stdout)

    with ThreadPoolExecutor(n_proc) as ex:
        ok = [x for part in ex.map(parse, [flat[i:i + chunk] for i in
                                           range(0, len(flat), chunk)]) for x in part]
    return len(ok) == len(flat) and all(ok)


def live_children():
    """PIDs of this process's children that have not been reaped (Linux)."""
    return [pid for task in Path("/proc/self/task").glob("*/children")
            for pid in task.read_text().split()]


def run_main_path(enc, pcm, warmup, torch, kernels):
    """Drive `enc` (frame pack) over pcm [steps, S, 2, 1152] through
    Mp2Packer.emit, with both launch counts set to 0 just before and read
    just after.  Returns (frames per stream, step seconds, (tonal_walk
    launches, tonal_noise launches), mean step ms after `warmup`)."""
    from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
    steps, S = pcm.shape[:2]
    packer = Mp2Packer(enc.cfg)
    state = enc.init_state()
    torch.cuda.synchronize()
    per_stream = [[] for _ in range(S)]
    step_s = []
    kernels.launches = kernels.noise_launches = 0
    for t in range(steps):
        t0 = time.perf_counter()
        state, out = enc.encode_step(state, pcm[t])
        emitted = packer.emit({"wire": out["wire"].cpu().numpy()})
        step_s.append(time.perf_counter() - t0)
        for i, b in enumerate(emitted):
            if b:
                per_stream[i].append(b)
    launches = (kernels.launches, kernels.noise_launches)
    for i, b in enumerate(packer.finish()):
        per_stream[i].append(b)
    check(all(len(f) == steps for f in per_stream), "wrong frame count")
    return per_stream, step_s, launches, 1000.0 * statistics.mean(step_s[warmup:])


def encode_golden(name, dev, torch):
    """The golden config `name` in f64 on `dev` through the port's host
    packer: (bytes, wanted bytes, frames, seconds)."""
    import gen_golden
    from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
    from odr_audioenc_tpu_torch import convert
    from odr_audioenc_tpu_torch.mp2 import model
    _, _, rate, bitrate, mode, psy, _ = gen_golden.CONFIGS[name]
    frames, _ = gen_golden.make_input(name)
    cfg = model.make_config([{"rate": rate, "bitrate": bitrate, "mode": mode}])
    enc = model.Mp2Encoder(cfg, psy_model=psy, dtype=torch.float64, device=dev)
    packer = Mp2Packer(cfg)
    state, chunks = enc.init_state(), []
    t0 = time.perf_counter()
    for f in frames:
        state, out = enc.encode_step(state, f[None])
        chunks += packer.emit(convert.to_numpy(out))
    chunks += packer.finish()
    want = (ROOT / "tests" / "golden" / f"{name}.mp2").read_bytes()
    return b"".join(chunks), want, len(frames), time.perf_counter() - t0


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


def superframe_pcm(n_streams, n_sf, seed):
    """[n_sf, S, 2, 5760] int16: music_pcm's per-stream offsets, in DAB+
    superframes of 48 kHz AAC-LC (6 AUs of 960 samples)."""
    import numpy as np
    pcm = music_pcm(n_streams, 5 * n_sf, seed)                 # [5 n_sf, S, 2, 1152]
    return np.ascontiguousarray(pcm.reshape(n_sf, 5, n_streams, 2, 1152)
                                .transpose(0, 2, 3, 1, 4).reshape(n_sf, n_streams, 2, 5760))


def run_dabplus(enc, pcm, torch, first8=8):
    """Drive enc over pcm [n_sf, S, ch, n] through encode_superframes
    (pack=False) and pack_superframes (RS).  Returns (frames per stream,
    device step seconds, host pack seconds, numpy outputs of the first
    `first8` streams per superframe)."""
    S = pcm.shape[1]
    frames, step_s, pack_s, outs = [[] for _ in range(S)], [], [], []
    state = enc.init_state()
    for t in range(pcm.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = enc.encode_superframes(state, pcm[t], pack=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, f in enumerate(enc.pack_superframes(out, add_rs=True)):
            frames[i].append(f)
        pack_s.append(time.perf_counter() - t1)
        step_s.append(t1 - t0)
        outs.append({k: v[:first8].cpu().numpy() for k, v in out.items()})
    return frames, step_s, pack_s, outs


def encode_cpu(cfg, pcm, dtype, torch):
    """The port on the CPU over pcm [n_sf, S, ch, n]: numpy outputs per superframe."""
    from odr_audioenc_tpu_torch import convert
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    enc = dmodel.DabPlusEncoder(cfg, pcm.shape[1], dtype=dtype, device="cpu")
    state, outs = enc.init_state(), []
    for t in range(pcm.shape[0]):
        state, out = enc.encode_superframes(state, pcm[t], pack=False)
        outs.append(convert.to_numpy(out))
    return outs


def same_decisions(outs_a, outs_b, keys):
    """(AUs whose `keys` outputs are equal, AUs) over [S, nau, ...] outputs."""
    import numpy as np
    same = total = 0
    for a, b in zip(outs_a, outs_b):
        S, nau = a["bits"].shape
        for s in range(S):
            for u in range(nau):
                same += all(np.array_equal(a[k][s, u], b[k][s, u]) for k in keys)
                total += 1
    return same, total


def main():
    check((ROOT / "odr_audioenc_tpu_torch").is_dir() and (ROOT / "tests" / "golden").is_dir(),
          f"{ROOT} is not a checkout of the repository")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "tools")]
    import numpy as np
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(torch.cuda.device_count() >= 1, "no CUDA device")

    from odr_audioenc_tpu_torch.host import mp2parse
    from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
    from odr_audioenc_tpu_torch import convert, tables
    from odr_audioenc_tpu_torch.bench_psy1_kernels import bound_ms, device_ms
    from odr_audioenc_tpu_torch.kernels import build
    from odr_audioenc_tpu_torch.mp2 import model, psycho1, psycho1_fast, psycho1_kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- phase 1: build (one nvcc per source, started together) ---------------
    def timed_build(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    names = ("tonal_walk", "tonal_noise")
    with ThreadPoolExecutor(len(names)) as ex:
        secs = dict(zip(names, ex.map(timed_build, names)))
    for n in names:
        log = build.library_path(n).with_suffix(".log").read_text()
        usage = " | ".join(line.split("ptxas info    : ")[-1].strip()
                           for line in log.splitlines() if "Used" in line or "spill" in line)
        print(f"phase 1: built {n} in {secs[n]:.2f} s; ptxas: {usage}", flush=True)

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
    power, energy, _ = psycho1.power_spectrum(win.to(torch.float32) / 32768.0)
    B = 2 * S_FULL
    for rows in (1, B - 1):                                     # the ragged edges
        err = max(err, compare(power[:rows])[1])
    cand, e = compare(power)
    err = max(err, e)
    k_ms = cuda_median_ms(lambda: psycho1_kernels.tonal_walk(power, cand), 50, torch)
    p_ms = cuda_median_ms(lambda: psycho1_fast.tonal_fast(power, cand), 20, torch)
    # device time of the bare launcher over six copies of the inputs: the
    # tonal walk's reads of them, 63 MB, are more than the 50 MB L2
    sets = [(torch.roll(power, 7 * i, 0), torch.roll(energy, 7 * i, 0), torch.roll(cand, 7 * i, 0))
            for i in range(6)]
    outs = (torch.empty_like(power), torch.empty_like(cand), torch.empty_like(cand))
    walk_tab = torch.as_tensor(psycho1_kernels.walk_table(), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bare_walk(i):
        p, _, c = sets[i]
        check(psycho1_kernels._launcher("tonal_walk")(
            p.data_ptr(), c.data_ptr(), walk_tab.data_ptr(), *(o.data_ptr() for o in outs), B,
            stream) == 0, "tonal_walk: launch failed")

    kd_ms = device_ms(bare_walk, len(sets))
    kb_ms = bound_ms("tonal_walk", B)
    print(f"phase 2: tonal_walk == tonal_fast at B=64, 1, {B - 1}, {B} (masks equal, max "
          f"|dpower'| {err:.3g} dB); B={B}: kernel {k_ms:.4f} ms per call, device "
          f"{kd_ms:.4f} ms (bound {kb_ms:.4f} ms, {kb_ms / kd_ms:.1%}), plain {p_ms:.4f} ms "
          f"[{card}]", flush=True)

    # ---- phase 2b: fused tonal+noise kernel vs plain version ----------------------
    tabs48 = psycho1_fast.make_fast_tables(psycho1.make_psy1_tables(np.array([1])))
    uniform = convert.tables_from_numpy(
        {"static_noise_uniform": tabs48["static_noise_uniform"]}, dev,
        torch.float32)["static_noise_uniform"]

    def compare_noise(power, energy):
        """tonal_noise vs tonal_noise_fast on one spectrum (see phase 2b above)."""
        cand = psycho1.tonal_candidates(power)
        pk, tk, nk = psycho1_kernels.tonal_noise(power, cand, energy, *uniform)
        pp, tp, npl = psycho1_fast.tonal_noise_fast(power, cand, energy, *uniform)
        torch.cuda.synchronize()
        B = power.shape[0]
        check(torch.equal(tk, tp), f"B={B}: tonal_noise tone members differ")
        flips = int((nk != npl).sum())
        check(flips <= B, f"B={B}: {flips} noise-member flips")
        d = (pk - pp).abs()
        e_both = float(d[nk & npl].max()) if bool((nk & npl).any()) else 0.0
        e_neither = float(d[~nk & ~npl].max())
        check(e_both < 1e-2, f"B={B}: power' on shared noise members differs by {e_both} dB")
        check(e_neither < 1e-3, f"B={B}: power' off the noise members differs by {e_neither} dB")
        return cand, flips, max(e_both, e_neither)

    rwin = torch.as_tensor(rng.standard_normal((64, 1024)) * 0.1, dtype=torch.float32,
                           device=dev)
    rp, rn, _ = psycho1.power_spectrum(rwin)
    _, flips64, err_n = compare_noise(rp, rn)
    for rows in (1, B - 1):
        err_n = max(err_n, compare_noise(power[:rows], energy[:rows])[2])
    cand, flips, e = compare_noise(power, energy)
    err_n = max(err_n, e)
    kn_ms = cuda_median_ms(lambda: psycho1_kernels.tonal_noise(power, cand, energy, *uniform),
                           50, torch)
    pn_ms = cuda_median_ms(lambda: psycho1_fast.tonal_noise_fast(power, cand, energy, *uniform),
                           20, torch)
    noise_tab, base32, span32, _ = psycho1_kernels._geometry(*uniform)

    def bare_noise(i):
        p, en, c = sets[i]
        check(psycho1_kernels._launcher("tonal_noise")(
            p.data_ptr(), c.data_ptr(), en.data_ptr(), noise_tab.data_ptr(), base32.data_ptr(),
            span32.data_ptr(), *(o.data_ptr() for o in outs), float(tables.CF), B, stream) == 0,
            "tonal_noise: launch failed")

    knd_ms = device_ms(bare_noise, len(sets))
    knb_ms = bound_ms("tonal_noise", B)
    print(f"phase 2b: tonal_noise vs tonal_noise_fast at B=64, 1, {B - 1}, {B}: tone members "
          f"equal, noise-member flips {flips64} (B=64) and {flips} (B={B}), max |dpower'| off "
          f"the flips {err_n:.3g} dB; B={B}: kernel {kn_ms:.4f} ms per call, device "
          f"{knd_ms:.4f} ms (bound {knb_ms:.4f} ms, {knb_ms / knd_ms:.1%}), plain {pn_ms:.4f} ms "
          f"[{card}]", flush=True)

    # ---- phase 3 / 3b: exact path, golden bytes, on the card -------------------------
    for phase, name in (("3", "music_48s_128_j_psy1"), ("3b", "music_48s_128_j_psy0"),
                        ("3b", "music_48s_128_j_psy2"), ("3b", "tones_48s_192_s_psy3")):
        got, want, nf, secs_g = encode_golden(name, dev, torch)
        bad = [i for i, (a, b) in enumerate(zip(mp2parse.split_frames(got),
                                                mp2parse.split_frames(want))) if a != b]
        check(got == want, f"phase {phase}: golden {name} differs on the card (frames {bad[:5]})")
        print(f"phase {phase}: golden {name} byte-exact on the card, f64, {nf} frames "
              f"in {secs_g:.2f} s", flush=True)

    # ---- phase 4: main path at full width -------------------------------------------
    steps = WARMUP + TIMED
    pcm = music_pcm(S_FULL, steps, seed=11)                     # [steps, S, 2, 1152]
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * S_FULL
    cfg = model.make_config(streams)
    enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev,
                           pack_on_device="frame")
    per_stream, _, (launches, n_l), step_ms = run_main_path(
        enc, pcm, WARMUP, torch, psycho1_kernels)
    check(launches == steps and n_l == 0,
          f"phase 4: tonal_walk launched {launches} times, tonal_noise {n_l}, in {steps} steps")
    flat = [f for fs in per_stream for f in fs]
    check(all_crc_ok(flat), "phase 4: a frame fails its CRC")
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

    # ---- phase 4b: the main path with the fused tonal+noise kernel ------------------
    fenc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev,
                            pack_on_device="frame", psy_kernel="fused-noise")
    fused_stream, _, (w_l, noise_launches), fstep_ms = run_main_path(
        fenc, pcm, WARMUP, torch, psycho1_kernels)
    check(noise_launches == steps and w_l == 0,
          f"phase 4b: tonal_noise launched {noise_launches} times, tonal_walk {w_l}, "
          f"in {steps} steps")
    fflat = [f for fs in fused_stream for f in fs]
    check(all_crc_ok(fflat), "phase 4b: a frame fails its CRC")
    same_bytes = sum(a == b for a, b in zip(flat, fflat))
    same_f = same_bytes + sum(
        np.array_equal(mp2parse.parse_frame(a)["bit_alloc"], mp2parse.parse_frame(b)["bit_alloc"])
        for a, b in zip(flat, fflat) if a != b)
    check(same_f >= 0.9 * len(flat),
          f"phase 4b: only {same_f}/{len(flat)} frames allocate as in phase 4")
    frt = S_FULL * FRAME_S / (fstep_ms / 1000.0)
    print(f"phase 4b: S={S_FULL} f32 fast path, psy_kernel=fused-noise: {len(fflat)} frames "
          f"CRC-valid, {noise_launches} tonal_noise launches, 0 tonal_walk; step "
          f"{fstep_ms:.3f} ms (mean of {TIMED}), {frt:.1f} streams x realtime "
          f"(phase 4, tonal: {step_ms:.3f} ms) [{card}]; vs phase 4: {same_bytes} frames "
          f"byte-equal, {same_f}/{len(flat)} with the same bit_alloc", flush=True)

    # ---- phase 5: psy models 0, 2 and 3 at full width ---------------------------------
    for psy, (warm, timed) in ((0, (2, 5)), (2, (2, 5)), (3, (1, 2))):
        penc = model.Mp2Encoder(cfg, psy_model=psy, dtype=torch.float32, device=dev,
                                pack_on_device="frame")
        psy_stream, _, psy_l, psy_ms = run_main_path(penc, pcm[:warm + timed], warm, torch,
                                                     psycho1_kernels)
        psy_flat = [f for fs in psy_stream for f in fs]
        check(all_crc_ok(psy_flat), f"phase 5: psy {psy}: a frame fails its CRC")
        check(psy_l == (0, 0), f"phase 5: psy {psy} launched the psy-1 kernels {psy_l}")
        print(f"phase 5: psy {psy}, S={S_FULL} f32, frame pack: {len(psy_flat)} frames "
              f"CRC-valid; step {psy_ms:.3f} ms (mean of {timed}), "
              f"{S_FULL * FRAME_S / (psy_ms / 1000.0):.1f} streams x realtime [{card}]",
              flush=True)

    # ---- phase 6: DAB+ AAC-LC at full width, host pack ---------------------------------
    from odr_audioenc_tpu_torch.host import native
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    native.get_lib()       # raises if the native host packer does not build
    dcfg = dmodel.DabPlusConfig(48000, 12, 2)
    d_warm, d_timed = 2, 5
    n_sf = d_warm + d_timed
    dpcm = superframe_pcm(S_FULL, n_sf, seed=13)                # [n_sf, S, 2, 5760]
    denc = dmodel.DabPlusEncoder(dcfg, S_FULL, dtype=torch.float32, device=dev)
    psycho1_kernels.launches = psycho1_kernels.noise_launches = 0
    dframes, dstep, dpack, douts = run_dabplus(denc, dpcm, torch)
    d_l = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
    check(d_l == (0, 0), f"phase 6: the DAB+ path launched the psy-1 kernels {d_l}")
    dflat = [f for fs in dframes for f in fs]
    check(len(dflat) == S_FULL * n_sf and all(len(f) == 120 * dcfg.subch for f in dflat),
          "phase 6: wrong superframe count or size")
    check(all_crc_ok(dflat, "_superframe_ok"),
          "phase 6: a superframe fails RS, its firecode or an AU CRC")
    n8 = 8
    for t, out in enumerate(douts):
        for s8 in range(n8):
            for a in range(dcfg.num_aus):
                bw = denc.write_au(out, s8, a)
                w = len(bw.buf) * 8 + bw.nbits + 10
                check(int(out["bits"][s8, a]) == w, f"phase 6: superframe {t} stream {s8} AU {a}: "
                      f"counted {int(out['bits'][s8, a])} bits, written + 10 = {w}")
    cpu_outs = encode_cpu(dcfg, dpcm[:, :n8], torch.float32, torch)
    d_same, d_total = same_decisions(douts, cpu_outs, ("gains", "books", "wseq"))
    check(d_same >= 0.9 * d_total, f"phase 6: only {d_same}/{d_total} AUs decide as on the CPU")
    d_ms = 1000.0 * statistics.mean(dstep[d_warm:])
    pack_ms = 1000.0 * statistics.mean(dpack[d_warm:])
    syncs = denc.recover_checks / n_sf
    print(f"phase 6: DAB+ LC 48 kHz stereo 96k, S={S_FULL} f32, host pack (native): {len(dflat)} "
          f"superframes valid (RS, firecode, AU CRCs); device step {d_ms:.3f} ms, host pack "
          f"{pack_ms:.3f} ms (means of {d_timed}), {S_FULL * 0.12 / (d_ms / 1000.0):.1f} streams x "
          f"realtime on the device step, {S_FULL * 0.12 / ((d_ms + pack_ms) / 1000.0):.1f} with the "
          f"pack [{card}]; {syncs:.1f} crash-recovery syncs per superframe, {denc.recoveries} "
          f"recoveries; psy-1 kernel launches {d_l}; first {n8} streams: counted == written + 10 "
          f"on {n_sf * n8 * dcfg.num_aus} AUs, {d_same}/{d_total} AUs decide as the CPU f32 port",
          flush=True)

    # ---- phase 6b: DAB+ f64 on the card vs the f64 port on the CPU ---------------------
    s64 = 8
    enc64 = dmodel.DabPlusEncoder(dcfg, s64, dtype=torch.float64, device=dev)
    f64_frames, f64_step, _, f64_outs = run_dabplus(enc64, dpcm[:3, :s64], torch)
    cpu64 = encode_cpu(dcfg, dpcm[:3, :s64], torch.float64, torch)
    keys = ("q", "gains", "books", "bits", "ms_used", "tns_en", "tns_order", "tns_idx",
            "tns_en_lo", "tns_order_lo", "tns_idx_lo", "tns_len", "wseq")
    e_same, e_total = same_decisions(f64_outs, cpu64, keys)
    flat64 = [f for fs in f64_frames for f in fs]
    check(all(_superframe_ok(flat64)), "phase 6b: a superframe is invalid")
    check(e_same >= 0.99 * e_total,
          f"phase 6b: only {e_same}/{e_total} AUs decide in f64 as on the CPU")
    print(f"phase 6b: DAB+ LC f64 on the card, S={s64}, 3 superframes: {e_same}/{e_total} AUs "
          f"with every integer output equal to the CPU f64 port's, {len(flat64)} superframes "
          f"valid; step {1000.0 * statistics.mean(f64_step):.1f} ms", flush=True)

    left = live_children()
    check(not left, f"child processes still running: {left}")
    print(f"child processes left running: {len(left)}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "tonal_walk", "route": "cuda",
         "source": "odr_audioenc_tpu_torch/csrc/tonal_walk.cu",
         "replaces": "odr_audioenc_tpu/mp2/psycho1_pallas.py:140",
         "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": kb_ms, "bound_by": "bytes", "library_ms": None, "device_ms": kd_ms,
         "share": kb_ms / kd_ms},
        {"name": "tonal_noise", "route": "cuda",
         "source": "odr_audioenc_tpu_torch/csrc/tonal_noise.cu",
         "replaces": "odr_audioenc_tpu/mp2/psycho1_pallas.py:151",
         "launches": noise_launches, "max_abs_err": err_n, "ms": kn_ms, "plain_ms": pn_ms,
         "bound_ms": knb_ms, "bound_by": "bytes", "library_ms": None, "device_ms": knd_ms,
         "share": knb_ms / knd_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
