#!/usr/bin/env python3
"""Drive the PyTorch port's MP2 and DAB+ (AAC-LC, HE-AAC, HE-AAC v2) main
paths, its fleet runtime, its CLIs and its bench on one CUDA card and check
them.

Usage (from the root of a checkout, on a machine with one NVIDIA card):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. card: name and power limit (nvidia-smi); build the five kernels from
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
     B=4095 spectra of phase 2; tone members equal, at most B // 256
     noise-member flips (none at B=64, 16 at B=4096: the kernel computes
     10^(x/10) as the plain version does, and a faster exp2f flips 14 and
     802), power' within 1e-2 dB where both have a noise member and 1e-3 dB
     where neither has one; times as in 2.
  3. exact path on the card: the golden config music_48s_128_j_psy1 (40
     frames) in f64 through the port's host packer, byte-exact.
  3b. the same for psy models 0, 2 and 3: music_48s_128_j_psy0,
     music_48s_128_j_psy2 and tones_48s_192_s_psy3, byte-exact.
  4. main path at full width: S=2048 streams, 48 kHz stereo 128k joint,
     f32 fast path, pack_on_device="frame", music-like PCM with per-stream
     offsets; 3 warm-up + 10 timed steps through Mp2Packer.emit.  Every
     frame parses with a valid CRC, the frame count is right, the kernel
     ran once per step, and the first 8 streams re-encoded on the CPU (the
     plain version) agree: >= 90% of frames with the same allocation, and
     SMR within 0.5 dB in >= 99% of subbands whose scalefactor agrees (max
     3 dB, the JAX fast path's own bound against the exact path).  cuBLAS
     and the CPU's BLAS sum the f32 spectrum in different orders, which
     flips a few local-maximum candidates and moves those subbands' SMR.
  4b. the main path of phase 4 with psy_kernel="fused-noise" on the same
     PCM: every frame CRC-valid, the fused kernel launched once per step
     and tonal_walk never, >= 99.9% of frames byte-equal to phase 4's (the
     fused kernel labels the noise members as noise_fast does; with the 802
     flips of an exp2f noise stage 99.69% were).
  4c. the MP2 allocation kernel (csrc/mp2_alloc.cu) against its plain
     version (allocate.js_mode_select + a_bit_allocation) on the card at the
     MP2 cells' shapes: S=8192 stations of mp2_48k.music128 and of
     mp2_48k.mux_mix (the cells' station patterns), 20 frames of the cells'
     music (benchmark/traffic, station i at offset base + 997 i), psy 1 f32,
     the kernel launched once per frame; each frame's allocation inputs kept
     and run again through the kernel and the plain version: mode, mode_ext,
     jsbound, bit_alloc and adb_left identical on every station-frame.
     Prints the kernel's device time per launch (CUDA events over 20
     launches) beside its bound (alloc_kernel.bound_bytes at 3.35 TB/s),
     the greedy's picks per station and the plain version's time.
  5. psy models 0, 2 and 3 on the f32 path at S=2048 (frame pack, a few
     steps each): every frame CRC-valid, step time printed.
  6. DAB+ AAC-LC main path at full width: 48 kHz stereo 96 kbps (subch 12,
     the lc_96 shape), S=2048 streams, f32, music-like PCM at per-stream
     offsets; 2 warm-up + 3 timed superframes through
     encode_superframes(pack=False) and pack_superframes(add_rs=True) with
     the native host packer (which must have built).  Every superframe is
     120*subch bytes and passes RS, the firecode and validate_superframe;
     on the first 8 streams every AU's counted bits equal its written length
     + 10, and their f32 re-encode on the CPU makes the same decisions
     (gains, books, window sequence) in >= 90% of AUs.  Prints the device
     step and the host pack separately, streams x realtime and the
     crash-recovery syncs per superframe.  Neither psy-1 kernel is on this
     path: both launch counts must stay 0 (the rate loop runs in its kernel,
     once per AU).
  6b. the same configuration in f64 on the card at S=8 for 3 superframes
     against the f64 port on the CPU: >= 99% of AUs with identical integer
     decisions and every superframe valid.
  6c. the rate-loop kernel (csrc/rate_loop.cu) against its plain version on
     the card at the LC cell's shape: S=8192 stations of DAB+ LC 48 kHz
     stereo 96k (f32, device pack), 4 superframes of the cell's music
     (benchmark/traffic/music.py, seed 1234, station i at offset
     base + 997 i), the kernel launched once per AU; each AU's rate inputs
     kept and run again through the kernel and through rate_loop_plain:
     no station over its budget where the plain version fits, and >= 98%
     of station-AUs with q, gains and books identical.  Prints the
     identical share, the kernel's device time per AU (CUDA events over 20
     launches) beside its bound (rate_kernel.bound_bytes at 3.35 TB/s) and
     the plain version's time per AU.
  7. HE-AAC (SBR) at full width: 48 kHz mono 48 kbps (subch 6, the sbr_48
     shape), S=2048, f32, the left channel of phase 6's music, 2 warm-up + 3
     timed superframes through encode_superframes(pack=False) and the
     native pack_superframes(add_rs=True).  Every superframe is 720 bytes
     and passes RS, the firecode and validate_superframe; on the first 8
     streams, on every AU, the counted core bits equal the written core + 10,
     the written FIL element equals sbr.payload_bits with the header bits as
     written, and the step's sbr_bits equal payload_bits as the reference
     counts them; >= 90% of AUs make the CPU f32 port's core decisions
     (gains, books, window sequence) and carry its SBR side data.  Prints
     the device step, the host pack and streams x realtime (S x 0.12 s /
     step).
  7b. the same for HE-AAC v2 (PS): 48 kHz stereo 32 kbps (subch 4, the
     ps_32 shape; 2 PS envelopes), with the PS parameters among the side data.
  7c. the same for stereo SBR at 64 kbps (subch 8, CPE core, per-AU
     coupling); prints how many AUs are coupled.
  7d. each of the three in f64 on the card at S=8 for 3 superframes
     against the f64 port on the CPU: >= 99% of AUs with every integer
     output (the core's, the side data and sbr_bits) equal, every superframe
     valid.

  8. the DAB+ device pack (dabplus/aupack.py: AU syntax, superframe, CRCs and
     RS as integer tensor ops) at full width, S=2048 f32, for lc_96, sbr_48
     and ps_32 on phase 6's music:
     8a (inside phases 6, 7 and 7b, on their last superframe): the step's
     outputs packed twice, by aupack.pack_from_outputs on the card and by the
     native host packer; the bytes must be equal on all 2,048 streams.  One
     more pack_from_outputs under torch.profiler gives the pack's device
     events and busy time per AU.
     8b: DabPlusEncoder(pack_on_device=True) over the same 2 warm-up + 3
     timed superframes: every superframe is 120*subch bytes and passes RS,
     the firecode, every AU CRC and validate_superframe; the wire's au_len
     equal the AU lengths read from the superframe header; no AU over the
     pack bound; >= 99% of the superframes equal the host-mode encoder's of
     phase 6/7/7b (same input, same state).  Prints the step with the
     device pack beside the host-mode step + host pack of that phase, and
     the device-to-host bytes per superframe of each mode.
     8c: entry.dryrun_multichip(1) on the card: shapes as asserted there, and
     the shard's rows equal to the unsplit batch's (here a second run).
     8d: X-PAD, S=8, pad_len=16, random pads: the device-mode encoder's
     bytes equal the host-mode encoder's through the native host packer.
     8e: the AU-pack kernel (csrc/au_pack.cu) against the slot-grid pack
     (au_content_groups + pack_au_content) on the card at the DAB+ cells'
     shapes: LC 96k stereo at S=8192 over 4 superframes and HE-AAC 48k mono
     at S=16,384 over 2, of the cells' music (as phase 6c), the kernel
     launched once per AU; each AU's pack inputs kept and packed again by
     both: (aubuf, au_bits, crc_part) identical on 100% of station-AUs.
     Prints the kernel's device time per AU (CUDA events over 20 launches)
     beside its bound (aupack_kernel.bound_bytes at 3.35 TB/s) and the
     slot-grid pack's time per AU.

  9. the runtime's main path, BASELINE config 5 (the JAX bench's fleet_64,
     bench.py:161-199) through odr_audioenc_tpu_torch.cli.main(["--streams",
     conf, "--compute-device", "cuda"]): 32 MP2 stations (128/192/96/160k,
     joint stereo and stereo alternating; psy 1 f32, frame pack, the
     tonal-walk kernel), 16 DAB+ LC 96k stereo, 8 HE-AAC 48k mono, 8 HE-AAC
     v2 32k stereo (f32, device pack), 48 kHz, file sinks and stats sockets,
     1.92 s of music per station (cut from the bench's 30 s: 2 chunks of
     0.96 s, k = 40 MP2 frames or 8 superframes, and the pass that meets
     EOF, a chunk of silence; 2 warm-up passes and 1 timed; 3.84 s until
     phase 11, which times fleet_64 over 2 passes, joined the run).  Every
     MP2 frame parses with a valid
     CRC and every superframe passes RS, the firecode and
     validate_superframe; tonal_walk launched once per MP2 step and
     tonal_noise never; the first chunk of every station is byte-equal to
     its group's encoder run directly on the card.  Prints the fleet's
     streams x realtime and each group's chunk time and share of the pass.
  10. the single-stream CLIs on the card (--compute-device cuda): MP2 f64
     (the exact path) over 8 frames equals music_48s_128_j_psy1.mp2 on the
     overlap; DAB+ LC 96k, --sbr 48k mono and --ps 32k over 3 superframes
     are valid; aacenc_cli writes 18 LOAS frames with valid syncwords and
     lengths.  Neither psy-1 kernel launches (the exact path has no kernel).
  11. the port's full-path bench (odr_audioenc_tpu_torch/bench.py, the
     counterpart of the root bench.py) through bench.run_cells, as its main()
     runs it: mp2_128, lc_96, sbr_48 and ps_32 at S=2048 with 3 timed steps
     (the bench's default: 10) after its warm step, one step deep through
     fleet._Transfers; fleet_64 on 2.88 s of audio per station (the bench's
     default: 30 s; 3 chunks of 0.96 s and the pass that meets EOF, 2 of them
     warm).  Every cell's last drain is valid (MP2 frames of the right count
     and size with valid CRCs; superframes that pass RS, the firecode and
     every AU CRC; fleet_64's last chunk of every station), the DAB+ steps
     download the one wire leaf, tonal_walk launched iters + 2 times in the
     mp2_128 cell, once per MP2 step in fleet_64 and never in the DAB+
     cells, tonal_noise never, every rate finite and above 0.  Prints each
     cell's line and the bench's own JSON line (the harmonic mean).

The f32 phases 6-7c report how many of the AUs that decide differently on the
card than on the CPU differ in the core's decisions only, in the SBR/PS side
data only, and in both.

Every main-path run (4, 4b, 5, 6, 7, 7b, 7c, 7d, 8b, 9, 10, 11) sets the launch
counts to 0 just before it and reads them just after; the DAB+ runs must
launch neither psy-1 kernel (the rate-loop kernel runs once per AU of every
DAB+ run on the card, the AU-pack kernel once per AU of every device-pack
run; phases 6c and 8e check their counts).  Every process the script starts (nvcc,
nvidia-smi, the CRC workers) is waited for, and before the result lines it
checks that no child process is left.  Prints, before the last line, the card line
and one JSON line with the five kernels' figures (with the launches of each
path that ran them); the last line is
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
WARMUP, TIMED = 3, 10      # 3 + 20 until phases 9 and 10 joined the run
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


def run_dabplus(enc, pcm, torch, first8=8, count_key=None, pack_check=False):
    """Drive enc over pcm [n_sf, S, ch, n] through encode_superframes
    (pack=False) and pack_superframes (RS).  Returns (frames per stream,
    device step seconds, host pack seconds, numpy outputs of the first
    `first8` streams per superframe, the sum of out[count_key] over every
    stream and superframe, read after the pack, info).  info["d2h_bytes"]:
    the bytes of one superframe's outputs.  With pack_check (phase 8a), on
    the last superframe the same outputs also go through the device pack
    (aupack.pack_from_outputs) on the card: info["pack_equal"] streams whose
    bytes equal the host pack's, and info["pack_profile"], the device figures
    of one more such pack under torch.profiler."""
    S = pcm.shape[1]
    frames, step_s, pack_s, outs, counted = [[] for _ in range(S)], [], [], [], 0
    info = {}
    state = enc.init_state()
    for t in range(pcm.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = enc.encode_superframes(state, pcm[t], pack=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        packed = enc.pack_superframes(out, add_rs=True)
        pack_s.append(time.perf_counter() - t1)
        step_s.append(t1 - t0)
        for i, f in enumerate(packed):
            frames[i].append(f)
        outs.append({k: v[:first8].cpu().numpy() for k, v in out.items()})
        if count_key in out:
            counted += int(out[count_key].sum())
        info["d2h_bytes"] = sum(v.numel() * v.element_size() for v in out.values())
        if pack_check and t == pcm.shape[0] - 1:
            from odr_audioenc_tpu_torch.dabplus import aupack
            ctx = aupack.AuPackCtx(enc)
            dev_sf = aupack.pack_from_outputs(enc, out, ctx=ctx)
            info["pack_equal"] = sum(dev_sf[i].tobytes() == f for i, f in enumerate(packed))
            info["pack_profile"] = device_profile(
                lambda: aupack.pack_from_outputs(enc, out, ctx=ctx), torch)
            info["maxcb"] = ctx.maxcb
    return frames, step_s, pack_s, outs, counted, info


def device_profile(fn, torch):
    """fn() once under torch.profiler: its device events (kernels, memcpys,
    memsets), their summed time and the host wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"device_events": len(dev), "profiled_wall_ms": 1000.0 * wall,
            "device_busy_ms": sum(e.time_range.end - e.time_range.start for e in dev) / 1000.0}


def report_pack_check(label, cfg, info, S, card):
    """Phase 8a's line for one shape; fails unless every stream's bytes are equal."""
    prof = info["pack_profile"]
    check(info["pack_equal"] == S,
          f"phase 8a: {label}: device pack equals the host pack on only "
          f"{info['pack_equal']}/{S} streams")
    print(f"phase 8a: {label}: aupack.pack_from_outputs on the card == native host pack on "
          f"{info['pack_equal']}/{S} streams (same outputs, {120 * cfg.subch} bytes each); the "
          f"pack alone under torch.profiler: {prof['device_events']} device events "
          f"({prof['device_events'] / cfg.num_aus:.1f} per AU), busy "
          f"{prof['device_busy_ms']:.3f} ms ({prof['device_busy_ms'] / cfg.num_aus:.3f} per AU), "
          f"{prof['profiled_wall_ms']:.1f} ms of host clock under the profiler; pack bound "
          f"{info['maxcb']} bytes per AU [{card}]", flush=True)


def header_au_lens(sf, nau, header_bytes, total):
    """AU byte lengths (CRC excluded) read from the au_start fields of
    superframes sf [S, >= total] uint8 (12 bits each from bit 24)."""
    import numpy as np
    bits = np.unpackbits(sf[:, 3:header_bytes], axis=1)[:, :12 * (nau - 1)]
    starts = (bits.reshape(len(sf), nau - 1, 12) << np.arange(11, -1, -1)).sum(-1)
    edges = np.concatenate([np.full((len(sf), 1), header_bytes), starts,
                            np.full((len(sf), 1), total)], axis=1)
    return np.diff(edges, axis=1) - 2


def run_device_pack(label, cfg, pcm, host_frames, host_ms, host_d2h, warm, torch, dev, card,
                    kernels):
    """Phase 8b for one shape: DabPlusEncoder(pack_on_device=True) over pcm
    [n_sf, S, ch, n] from the initial state; host_frames: the host-mode
    encoder's superframes per stream on the same input (phase 6/7/7b);
    host_ms: (its device step, its host pack) in ms."""
    import numpy as np
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    n_sf, S = pcm.shape[:2]
    enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device=dev, pack_on_device=True)
    maxcb, nau, total = enc.aupack_ctx.maxcb, cfg.num_aus, enc.packer.total
    state = enc.init_state()
    frames, step_s, take_s, over, len_bad = [[] for _ in range(S)], [], [], 0, 0
    kernels.launches = kernels.noise_launches = 0
    for t in range(n_sf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = enc.encode_superframes(state, pcm[t], pack=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        packed = enc.pack_superframes(out, add_rs=True)
        take_s.append(time.perf_counter() - t1)
        step_s.append(t1 - t0)
        check(set(out) == {"wire"} and out["wire"].dtype == torch.uint8
              and tuple(out["wire"].shape) == (S, 120 * cfg.subch + 4 * nau),
              f"phase 8b: {label}: the step's output is not the one wire leaf")
        d2h = out["wire"].numel()
        wire = out["wire"].cpu().numpy()
        tail = wire[:, -4 * nau:].astype(np.int32)
        au_len = tail[:, :nau] | (tail[:, nau:2 * nau] << 8)
        au_bits = tail[:, 2 * nau:3 * nau] | (tail[:, 3 * nau:] << 8)
        over += int((au_bits > 8 * maxcb).sum())
        len_bad += int((au_len != header_au_lens(wire, nau, enc.packer.header_bytes, total))
                       .any(axis=1).sum())
        for i, f in enumerate(packed):
            frames[i].append(f)
    k_l = (kernels.launches, kernels.noise_launches)
    check(k_l == (0, 0), f"phase 8b: {label}: the DAB+ path launched the psy-1 kernels {k_l}")
    flat = [f for fs in frames for f in fs]
    check(len(flat) == S * n_sf and all(len(f) == 120 * cfg.subch for f in flat),
          f"phase 8b: {label}: wrong superframe count or size")
    check(all_crc_ok(flat, "_superframe_ok"),
          f"phase 8b: {label}: a device-packed superframe fails RS, its firecode or an AU CRC")
    check(over == 0, f"phase 8b: {label}: {over} AUs over the pack bound of {maxcb} bytes")
    check(len_bad == 0, f"phase 8b: {label}: the wire's au_len differ from the superframe "
          f"header's on {len_bad} superframes")
    same = sum(a == b for fa, fb in zip(frames, host_frames) for a, b in zip(fa, fb))
    check(same >= 0.99 * len(flat), f"phase 8b: {label}: only {same}/{len(flat)} superframes "
          f"equal the host-mode encoder's")
    ms = 1000.0 * statistics.mean(step_s[warm:])
    take_ms = 1000.0 * statistics.mean(take_s[warm:])
    h_step, h_pack = host_ms
    print(f"phase 8b: {label}, S={S} f32, pack_on_device=True: {len(flat)} superframes of "
          f"{120 * cfg.subch} bytes valid (RS, firecode, AU CRCs), au_len == the header's AU "
          f"lengths, 0 AUs over the {maxcb}-byte pack bound; {same}/{len(flat)} superframes equal "
          f"the host-mode encoder's; step with the device pack {ms:.3f} ms + D2H and slicing "
          f"{take_ms:.3f} ms (means of {n_sf - warm}), {S * 0.12 / ((ms + take_ms) / 1000.0):.1f} "
          f"streams x realtime; host mode in this run: step {h_step:.3f} ms + host pack "
          f"{h_pack:.3f} ms, {S * 0.12 / ((h_step + h_pack) / 1000.0):.1f} streams x realtime; "
          f"D2H per superframe {d2h} bytes (device pack) against {host_d2h} (host mode); "
          f"{enc.recoveries} recoveries; psy-1 kernel launches {k_l} [{card}]", flush=True)


# the HE-AAC side outputs held against the CPU port (those the step emits)
HE_SIDE = ("sbr_env", "sbr_env2", "sbr_transient", "sbr_noise_q", "sbr_invf", "sbr_addharm",
           "sbr_tgrid", "sbr_cpl", "ps_iid", "ps_icc", "ps_iid_fine", "ps_fine")


def fil_bits(enc, out, hdr_bits):
    """sbr.payload_bits over numpy step outputs [S, nau, ...] on the CPU."""
    import torch
    from odr_audioenc_tpu_torch.dabplus import sbr
    t = {k: torch.as_tensor(v) for k, v in out.items()}
    ps_bits = None
    if enc.is_ps:
        ps_bits = sbr.ps_data_bits(t["ps_iid"], t["ps_iid_fine"], t["ps_fine"], t["ps_icc"])
    return sbr.payload_bits({k: v for k, v in t.items() if k.startswith("sbr_")},
                            enc.sbr_params, enc.cfg.num_aus, ps_bits=ps_bits,
                            hdr_bits=hdr_bits).numpy()


def check_heaac_aus(enc, outs, phase):
    """Every AU of `outs` (numpy, the first streams per superframe): counted
    core bits = written core + 10; the written FIL element = payload_bits
    with the header bits as written; the step's sbr_bits = payload_bits as
    the reference counts them (its header count is off by a few bits, so
    the FIL can differ from it by a byte, two where the FIL's length
    crosses its escape at 15 bytes).  Returns (AUs checked, AUs whose FIL
    differs from sbr_bits)."""
    import numpy as np
    from odr_audioenc_tpu_torch.dabplus import sbr
    n = off = 0
    for t, out in enumerate(outs):
        check(np.array_equal(out["sbr_bits"], fil_bits(enc, out, sbr.HDR_BITS)),
              f"phase {phase}: superframe {t}: the step's sbr_bits are not payload_bits")
        fil = fil_bits(enc, out, sbr.HDR_BITS_WRITTEN)
        for s, a in np.ndindex(*out["bits"].shape):
            core = enc.write_au(out, s, a, sbr=False)
            core = len(core.buf) * 8 + core.nbits
            full = enc.write_au(out, s, a)
            check(int(out["bits"][s, a]) == core + 10,
                  f"phase {phase}: superframe {t} stream {s} AU {a}: counted "
                  f"{int(out['bits'][s, a])} core bits, written + 10 = {core + 10}")
            check(len(full.buf) * 8 + full.nbits - core == fil[s, a],
                  f"phase {phase}: superframe {t} stream {s} AU {a}: FIL element of "
                  f"{len(full.buf) * 8 + full.nbits - core} bits, payload_bits {fil[s, a]}")
            n += 1
            off += int(fil[s, a] != out["sbr_bits"][s, a])
    return n, off


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


def same_decisions(outs_a, outs_b, keys, side_keys=()):
    """(AUs whose `keys` and `side_keys` outputs are equal, AUs, [differing
    AUs that differ in `keys` only, in `side_keys` only, in both]) over
    [S, nau, ...] outputs."""
    import numpy as np
    same = total = 0
    split = [0, 0, 0]
    for a, b in zip(outs_a, outs_b):
        S, nau = a["bits"].shape
        for s in range(S):
            for u in range(nau):
                core = all(np.array_equal(a[k][s, u], b[k][s, u]) for k in keys)
                side = all(np.array_equal(a[k][s, u], b[k][s, u]) for k in side_keys)
                same += core and side
                total += 1
                if not (core and side):
                    split[0 if side else (1 if core else 2)] += 1
    return same, total, split


def split_text(split):
    return (f"of the AUs that differ: {split[0]} in the core's decisions only, {split[1]} in the "
            f"SBR/PS side data only, {split[2]} in both")


def write_wav(path, sig):
    """sig [ch, n] int16 -> a 48 kHz WAV through the port's writer."""
    import numpy as np
    from odr_audioenc_tpu_torch.io.wav import WavWriter
    w = WavWriter(str(path), 48000, sig.shape[0])
    w.write(np.ascontiguousarray(sig.T).astype("<i2").tobytes())
    w.close()
    return str(path)


FLEET_S = 1.92      # seconds of audio per fleet_64 station: 2 chunks of 0.96 s


def fleet64_streams(tmp, sig):
    """BASELINE config 5 (the bench's fleet_64, bench.fleet64_streams) on
    sig [2, n], written as a stereo and a mono 48 kHz WAV in `tmp`."""
    from odr_audioenc_tpu_torch import bench
    wav, wav1 = write_wav(tmp / "in.wav", sig), write_wav(tmp / "in_mono.wav", sig[:1])
    return bench.fleet64_streams(str(tmp), wav, wav1)


def first_chunk_direct(streams, sig, k_of, torch, dev):
    """Each fleet_64 group's encoder run directly on the card over the
    first chunk of its stations' PCM: MP2 k + 1 frames through
    Mp2Packer.emit (the k-th frame's ScF-CRC comes with frame k + 1), DAB+
    k superframes with the device pack.  Returns {station: bytes}."""
    import numpy as np
    from odr_audioenc_tpu_torch import convert
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
    from odr_audioenc_tpu_torch.mp2 import model
    want = {}
    mp2 = [i for i, s in enumerate(streams) if s["codec"] == "mp2"]
    cfg = model.make_config([{"rate": 48000, "bitrate": streams[i]["bitrate"],
                              "mode": streams[i]["mode"]} for i in mp2])
    enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev,
                           pack_on_device="frame")
    packer, state, k = Mp2Packer(cfg), enc.init_state(), k_of["mp2"]
    for t in range(k + 1):
        pcm = np.broadcast_to(sig[:, t * 1152:(t + 1) * 1152], (len(mp2), 2, 1152))
        state, out = enc.encode_step(state, np.ascontiguousarray(pcm))
        for j, b in enumerate(packer.emit(convert.to_numpy(out))):
            want[mp2[j]] = want.get(mp2[j], b"") + b
    for aot, (subch, ch) in (("lc", (12, 2)), ("sbr", (6, 1)), ("ps", (4, 2))):
        idx = [i for i, s in enumerate(streams)
               if s["codec"] == "dabplus" and s["bitrate"] == 8 * subch]
        cfg = dmodel.DabPlusConfig(48000, subch, ch, aot=aot)
        enc = dmodel.DabPlusEncoder(cfg, len(idx), dtype=torch.float32, device=dev,
                                    pack_on_device=True)
        state, k, spf = enc.init_state(), k_of[aot], cfg.num_aus * cfg.au_samples
        for t in range(k):
            pcm = np.broadcast_to(sig[:ch, t * spf:(t + 1) * spf], (len(idx), ch, spf))
            state, frames = enc.encode_superframes(state, np.ascontiguousarray(pcm))
            for j, f in enumerate(frames):
                want[idx[j]] = want.get(idx[j], b"") + f
    return want


def alloc_picks(bit_alloc, jsbound, nch, sblimit, tablenum):
    """Picks of the C greedy per station, from its result: one per rung
    allocated (a joint pair's rung once) and one per slot (a joint pair
    once) that ended below its max_alloc, which a pick froze."""
    import numpy as np
    from odr_audioenc_tpu_torch import tables as T
    line = T.LINE[tablenum]                                                 # [S, 32]
    nbal = np.where(line < 0, 0, T.NBAL[np.maximum(line, 0)])
    maxa = (1 << nbal) - 1
    sb = np.arange(32)[None, :]
    valid = np.stack([sb < sblimit[:, None], (sb < sblimit[:, None]) & (nch[:, None] == 2)
                      & (sb < jsbound[:, None])], 1)                       # ch 1 of a pair counts once
    valid &= (maxa > 0)[:, None, :]
    ba = np.where(valid, bit_alloc, 0)
    return ba.sum((1, 2)) + (valid & (ba < maxa[:, None, :])).sum((1, 2))


def phase_alloc_kernel(card, torch, dev, S=8192, n_frames=20):
    """Phase 4c (see the module docstring).  Returns the kernel's JSON entry."""
    import numpy as np
    from benchmark import registry
    from benchmark.stations import station_specs
    from benchmark.traffic.programme import Programme
    from odr_audioenc_tpu_torch.mp2 import alloc_kernel as AK
    from odr_audioenc_tpu_torch.mp2 import allocate, model
    lines, entry = [], None
    for cell in ("mp2_48k.music128", "mp2_48k.mux_mix"):
        wl, conf = registry.cell(cell)
        wl["stations"] = S
        prog = Programme(wl, conf["channels"], conf["samples_per_step"], 2028,
                         registry.module("traffic", wl["programme"]["kind"]).make,
                         conf["sample_rate"])
        cfg = model.make_config(station_specs(conf, wl))
        enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=dev,
                               pack_on_device="frame")
        xpad = torch.zeros((S,), dtype=torch.int64, device=dev)
        kept, routed = [], allocate.bit_allocation

        def keep(*args):
            kept.append(args)
            return routed(*args)
        allocate.bit_allocation = keep
        try:
            AK.launches = 0
            state = enc.init_state()
            for k in range(n_frames):
                pcm = torch.as_tensor(np.ascontiguousarray(prog.batch(k)[0]), device=dev)
                state, _ = enc._encode_step(state, pcm, xpad)
            torch.cuda.synchronize()
        finally:
            allocate.bit_allocation = routed
        check(AK.launches == n_frames == len(kept),
              f"phase 4c: {cell}: {AK.launches} kernel launches for {n_frames} frames")
        same = total = 0
        plain_s, picks = [], []
        for smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb in kept:
            got = allocate.bit_allocation(smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stereo, ext, jsb = allocate.js_mode_select(smr, scfsi, ft, sblimit, nch, is_joint,
                                                       adb)
            ba, left = allocate.a_bit_allocation(smr, scfsi, ft, sblimit, nch, jsb, adb)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)
            ok = (got[0] == stereo) & (got[1] == ext) & (got[2] == jsb) \
                & (got[3] == ba).flatten(1).all(1) & (got[4] == left)
            same += int(ok.sum())
            total += S
            picks.append(alloc_picks(*(t.cpu().numpy() for t in (got[3], got[2], nch, sblimit,
                                                                  tablenum))))
        check(same == total, f"phase 4c: {cell}: only {same}/{total} station-frames identical")
        args = kept[-1]
        kargs = (args[0], args[1], *args[3:])
        for _ in range(3):
            AK.allocate(*kargs)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            AK.allocate(*kargs)
        b.record()
        torch.cuda.synchronize()
        k_ms = a.elapsed_time(b) / 20
        bound_ms = AK.bound_bytes(S) / 3.35e12 * 1e3
        p_ms = 1000.0 * statistics.median(plain_s)
        picks = np.concatenate(picks)
        lines.append(f"{cell}, S={S} f32, {n_frames} frames of the cell's music: {same}/{total} "
                     f"station-frames identical; kernel {1000.0 * k_ms:.1f} us per launch "
                     f"(device, events over 20 launches), bound {1000.0 * bound_ms:.2f} us "
                     f"(bytes, {AK.bound_bytes(S) / 1e6:.2f} MB at 3.35 TB/s, "
                     f"{100.0 * bound_ms / k_ms:.1f}% of it); picks per station mean "
                     f"{picks.mean():.1f}, max {picks.max()}; plain version {p_ms:.1f} ms "
                     f"(median of {len(plain_s)}, host clock with a sync)")
        if entry is None:
            entry = {"name": "mp2_alloc", "route": "cuda",
                     "source": "odr_audioenc_tpu_torch/csrc/mp2_alloc.cu", "replaces": None,
                     "launches": n_frames, "identical_share": same / total, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "dependent picks",
                     "library_ms": None, "device_ms": k_ms, "share": bound_ms / k_ms,
                     "launches_by_path": {}}
        entry["launches_by_path"][f"{cell} S={S} (phase 4c)"] = n_frames
        del enc, kept
    print(f"phase 4c: mp2_alloc kernel vs js_mode_select + a_bit_allocation: "
          f"{'; '.join(lines)} [{card}]", flush=True)
    return entry


def cell_music_pcm(n_streams, n_sf, seed):
    """[n_sf, S, 2, 5760] int16: the LC cell's programme (benchmark/traffic/
    music.py, 20 s from seed 1234), station i reading it from base + 997 i
    (mod its length), base drawn from `seed`."""
    import numpy as np
    from benchmark.traffic import music
    src = music.make(20 * 48000, 2, 1234)
    L = src.shape[1]
    base = int(np.random.default_rng(seed).integers(0, L))
    t = np.arange(n_sf * 5760)
    idx = (base + 997 * np.arange(n_streams)[:, None] + t[None, :]) % L     # [S, n]
    pcm = src[:, idx]                                                        # [2, S, n]
    return np.ascontiguousarray(pcm.reshape(2, n_streams, n_sf, 5760).transpose(2, 1, 0, 3))


def phase_rate_kernel(card, torch, dev, S=8192, n_sf=4):
    """Phase 6c (see the module docstring).  Returns the kernel's JSON entry."""
    from odr_audioenc_tpu_torch.dabplus import encode as E
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    from odr_audioenc_tpu_torch.dabplus import rate_kernel as RK
    cfg = dmodel.DabPlusConfig(48000, 12, 2, aot="lc")
    enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device=dev, pack_on_device=True)
    pcm = cell_music_pcm(S, n_sf, 2026)
    kept, routed = [], E.rate_loop

    def keep(inp, rounds=E.REFINE_ROUNDS):
        kept.append((inp, rounds))
        return routed(inp, rounds)
    E.rate_loop = keep
    try:
        RK.launches = 0
        state = enc.init_state()
        for t in range(n_sf):
            state, out = enc(state, torch.as_tensor(pcm[t], device=dev))
        torch.cuda.synchronize()
    finally:
        E.rate_loop = routed
    n_au = n_sf * cfg.num_aus
    check(RK.launches == n_au == len(kept),
          f"phase 6c: {RK.launches} kernel launches for {n_au} AUs")
    same = total = over = 0
    plain_s = []
    for inp, rounds in kept:
        q, gains, books, bits = E.rate_loop(inp, rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pq, pg, pb, pbits = E.rate_loop_plain(inp, rounds)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
        ok = (q == pq).flatten(1).all(1) & (gains == pg).flatten(1).all(1) \
            & (books == pb).flatten(1).all(1)
        same += int(ok.sum())
        total += S
        over += int(((bits > inp.budget_bits) & (pbits <= inp.budget_bits)).sum())
    check(over == 0, f"phase 6c: {over} station-AUs over budget where the plain version fits")
    check(same >= 0.98 * total, f"phase 6c: only {same}/{total} station-AUs identical")
    inp, rounds = kept[-1]
    args = (inp, rounds, E._RATE_TABLE, E._RATE_PARAMS)
    for _ in range(3):
        RK.rate_loop(*args)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        RK.rate_loop(*args)
    b.record()
    torch.cuda.synchronize()
    k_ms = a.elapsed_time(b) / 20
    bound_ms = RK.bound_bytes(S, 2) / 3.35e12 * 1e3
    p_ms = 1000.0 * statistics.median(plain_s)
    print(f"phase 6c: rate_loop kernel vs rate_loop_plain, DAB+ LC 96k stereo, S={S} f32, "
          f"{n_sf} superframes of the cell's music: {same}/{total} station-AUs identical "
          f"({100.0 * same / total:.3f}%), none over budget where the plain version fits; "
          f"kernel {k_ms:.3f} ms per AU (device, events over 20 launches), bound "
          f"{bound_ms:.4f} ms (bytes, {RK.bound_bytes(S, 2) / 1e6:.1f} MB at 3.35 TB/s, "
          f"{100.0 * bound_ms / k_ms:.2f}% of it); plain version {p_ms:.1f} ms per AU "
          f"(median of {len(plain_s)}, host clock with a sync) [{card}]", flush=True)
    return {"name": "rate_loop", "route": "cuda",
            "source": "odr_audioenc_tpu_torch/csrc/rate_loop.cu", "replaces": None,
            "launches": n_au, "identical_share": same / total, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None, "device_ms": k_ms,
            "share": bound_ms / k_ms, "launches_by_path": {"lc_96 S=8192 (phase 6c)": n_au}}


def phase_aupack_kernel(card, torch, dev):
    """Phase 8e (see the module docstring).  Returns the kernel's JSON entry."""
    import numpy as np
    from odr_audioenc_tpu_torch.dabplus import aupack
    from odr_audioenc_tpu_torch.dabplus import aupack_kernel as AK
    from odr_audioenc_tpu_torch.dabplus import model as dmodel
    shapes = (("LC 96k stereo", dmodel.DabPlusConfig(48000, 12, 2, aot="lc"), 8192, 4),
              ("HE-AAC 48k mono", dmodel.DabPlusConfig(48000, 6, 1, aot="sbr"), 16384, 2))
    lines, entry = [], None
    for label, cfg, S, n_sf in shapes:
        enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device=dev,
                                    pack_on_device=True)
        ctx = enc.aupack_ctx
        pcm = cell_music_pcm(S, n_sf, 2027)[:, :, :cfg.channels]
        kept, routed = [], aupack.pack_au

        def keep(ctx_, o, is_last, pad_buf=None, pad_len=None, sbr_group=None):
            kept.append((o, is_last, sbr_group))
            return routed(ctx_, o, is_last, pad_buf, pad_len, sbr_group)
        aupack.pack_au = keep
        try:
            AK.launches = 0
            state = enc.init_state()
            for t in range(n_sf):
                state, _ = enc(state, torch.as_tensor(np.ascontiguousarray(pcm[t]), device=dev))
            torch.cuda.synchronize()
        finally:
            aupack.pack_au = routed
        n_au = n_sf * cfg.num_aus
        check(AK.launches == n_au == len(kept),
              f"phase 8e: {label}: {AK.launches} kernel launches for {n_au} AUs")
        same = total = 0
        plain_s = []
        for o, is_last, sbr in kept:
            got = aupack.pack_au(ctx, o, is_last, sbr_group=sbr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf, bits, crc = aupack.pack_au_content(ctx, aupack.au_content_groups(
                ctx, o, is_last, sbr_group=None if sbr is None else (*sbr, 4)))
            buf = buf.to(torch.uint8)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)
            ok = (got[0] == buf).all(1) & (got[1] == bits) & (got[2] == crc)
            same += int(ok.sum())
            total += S
        check(same == total, f"phase 8e: {label}: only {same}/{total} station-AUs identical")
        o, is_last, sbr = kept[-1]
        for _ in range(3):
            AK.pack_au(ctx, o, is_last, sbr_group=sbr)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            AK.pack_au(ctx, o, is_last, sbr_group=sbr)
        b.record()
        torch.cuda.synchronize()
        k_ms = a.elapsed_time(b) / 20
        nbytes = AK.bound_bytes(S, enc.core_channels, ctx.maxcb,
                                n_sbr=0 if sbr is None else sbr[0].shape[1])
        bound_ms = nbytes / 3.35e12 * 1e3
        p_ms = 1000.0 * statistics.median(plain_s)
        lines.append(f"{label}, S={S} f32, {n_sf} superframes of the cells' music: {same}/{total} "
                     f"station-AUs identical; kernel {1000.0 * k_ms:.1f} us per AU (device, "
                     f"events over 20 launches), bound {1000.0 * bound_ms:.1f} us (bytes, "
                     f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, {100.0 * bound_ms / k_ms:.1f}% of it); "
                     f"slot-grid pack {p_ms:.1f} ms per AU (median of {len(plain_s)}, host clock "
                     f"with a sync)")
        if entry is None:
            entry = {"name": "au_pack", "route": "cuda",
                     "source": "odr_audioenc_tpu_torch/csrc/au_pack.cu", "replaces": None,
                     "launches": n_au, "identical_share": same / total, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": None, "device_ms": k_ms, "share": bound_ms / k_ms,
                     "launches_by_path": {}}
        entry["launches_by_path"][f"{label} S={S} (phase 8e)"] = n_au
        del enc, ctx, kept
    print(f"phase 8e: au_pack kernel vs the slot-grid pack: {'; '.join(lines)} [{card}]",
          flush=True)
    return entry


def phase_fleet(card, kernels, torch, dev):
    """Phase 9: fleet_64 through the odr-audioenc CLI's --streams on the
    card.  Returns (tonal_walk launches, tonal_noise launches) of the run."""
    import numpy as np
    import tempfile
    from signals import music_like
    from odr_audioenc_tpu_torch import cli, fleet
    from odr_audioenc_tpu_torch.host import mp2parse
    src = music_like(30)
    n = int(48000 * FLEET_S)
    sig = np.tile(src, (1, -(-n // src.shape[1])))[:, :n]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        tmp = Path(tmp)
        streams = fleet64_streams(tmp, sig)
        (tmp / "fleet.json").write_text(json.dumps({"streams": streams}))
        kernels.launches = kernels.noise_launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--streams", str(tmp / "fleet.json"), "--compute-device", "cuda"])
        wall = time.perf_counter() - t0
        k_l = (kernels.launches, kernels.noise_launches)
        check(rc == 0, f"phase 9: cli.main --streams returned {rc}")
        run = fleet.last_run
        groups = {g["key"][0] if g["key"][0] == "mp2" else g["key"][-1]: g
                  for g in run["groups"]}
        check(sorted(groups) == ["lc", "mp2", "ps", "sbr"] and
              [groups[a]["streams"] for a in ("mp2", "lc", "sbr", "ps")] == [32, 16, 8, 8],
              f"phase 9: unexpected grouping {[(g['key'], g['streams']) for g in run['groups']]}")
        mp2_steps = groups["mp2"]["chunks"] * groups["mp2"]["k"]
        check(k_l == (mp2_steps, 0), f"phase 9: tonal_walk launched {k_l[0]} times and "
              f"tonal_noise {k_l[1]} in {mp2_steps} MP2 steps")
        outs = [(tmp / f"out{i}.bin").read_bytes() for i in range(64)]
        mp2_frames = [f for i in range(32) for f in mp2parse.split_frames(outs[i])]
        check(all(len(outs[i]) == (mp2_steps - 1) * 3 * streams[i]["bitrate"]
                  for i in range(32)), "phase 9: wrong MP2 byte count")
        check(all_crc_ok(mp2_frames), "phase 9: an MP2 frame fails its CRC")
        sfs = [outs[i][j:j + 15 * streams[i]["bitrate"]] for i in range(32, 64)
               for j in range(0, len(outs[i]), 15 * streams[i]["bitrate"])]
        aot_of = ["mp2"] * 32 + ["lc"] * 16 + ["sbr"] * 8 + ["ps"] * 8
        check(all(len(outs[i]) == groups[aot_of[i]]["chunks"] * groups[aot_of[i]]["k"] * 15 *
                  streams[i]["bitrate"] for i in range(32, 64)), "phase 9: wrong DAB+ byte count")
        check(all_crc_ok(sfs, "_superframe_ok"),
              "phase 9: a superframe fails RS, its firecode or an AU CRC")
        k_of = {a: g["k"] for a, g in groups.items()}
        t1 = time.perf_counter()
        want = first_chunk_direct(streams, sig, k_of, torch, dev)
        direct_s = time.perf_counter() - t1
        frame_bytes = [3 * s["bitrate"] if s["codec"] == "mp2" else 15 * s["bitrate"]
                       for s in streams]
        bad = [i for i in range(64) if len(want[i]) != k_of[aot_of[i]] * frame_bytes[i]
               or not outs[i].startswith(want[i])]
        check(not bad, f"phase 9: the first chunk of stations {bad} differs from the encoders "
              f"run directly")
    # StatsPublisher binds the reference's /tmp/odr-audioenc.<pid>; take it away
    Path(f"/tmp/odr-audioenc.{os.getpid()}").unlink(missing_ok=True)
    times = {a: [s + d for s, d in zip(g["step_s"][2:], g["drain_s"][2:])]
             for a, g in groups.items()}
    per_pass = {a: statistics.mean(t) for a, t in times.items()}
    total = sum(per_pass.values())
    parts = "; ".join(f"{a} S={groups[a]['streams']} k={groups[a]['k']}: "
                      f"{1000 * per_pass[a]:.1f} ms per chunk (step "
                      f"{1000 * statistics.mean(groups[a]['step_s'][2:]):.1f} + drain "
                      f"{1000 * statistics.mean(groups[a]['drain_s'][2:]):.1f}), "
                      f"{per_pass[a] / total:.1%} of the pass"
                      for a in ("mp2", "lc", "sbr", "ps"))
    print(f"phase 9: fleet_64 through cli.main --streams on the card: {run['stations']} "
          f"stations, {len(mp2_frames)} MP2 frames CRC-valid, {len(sfs)} superframes valid (RS, "
          f"firecode, AU CRCs); tonal_walk {k_l[0]} launches in {mp2_steps} MP2 steps, "
          f"tonal_noise {k_l[1]}; first chunk of all 64 stations byte-equal to the encoders run "
          f"directly ({direct_s:.1f} s); {run['audio_seconds']:.2f} audio-s in "
          f"{run['wall_s']:.3f} s over {len(times['mp2'])} timed passes = {run['rate']:.2f} "
          f"streams x realtime, {total:.3f} s per 0.96 s pass; {parts}; whole command "
          f"{wall:.1f} s [{card}]", flush=True)
    return k_l


def loas_frames(data):
    """Split a LOAS AudioSyncStream into its frames; fails unless every one
    starts with the 0x2B7 syncword and the lengths tile the stream."""
    out, pos = [], 0
    while pos < len(data):
        check(pos + 3 <= len(data) and (data[pos] << 3 | data[pos + 1] >> 5) == 0x2B7,
              f"phase 10: no LOAS syncword at byte {pos}")
        n = ((data[pos + 1] & 0x1F) << 8 | data[pos + 2]) + 3
        out.append(data[pos:pos + n])
        pos += n
    check(pos == len(data), "phase 10: the LOAS frames overrun the stream")
    return out


def phase_cli(card, kernels, torch):
    """Phase 10: the single-stream CLIs on the card.  Returns the psy-1
    kernel launches of the run (the CLI's MP2 is the f64 exact path)."""
    import numpy as np
    import tempfile
    from signals import music_like
    from odr_audioenc_tpu_torch import aacenc_cli, cli
    cuda = ["--compute-device", "cuda"]
    kernels.launches = kernels.noise_launches = 0
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        nf = 8
        wav = write_wav(tmp / "golden.wav", music_like(40)[:, :nf * 1152])
        t0 = time.perf_counter()
        check(cli.main(["-a", "-i", wav, "-b", "128", "-c", "2", "-r", "48000", "--dabmode",
                        "j", "-o", str(tmp / "o.mp2")] + cuda) == 0, "phase 10: MP2 rc != 0")
        got = (tmp / "o.mp2").read_bytes()
        want = (ROOT / "tests" / "golden" / "music_48s_128_j_psy1.mp2").read_bytes()
        check(len(got) == (nf - 1) * 384 and got == want[:len(got)],
              "phase 10: the MP2 CLI's bytes differ from music_48s_128_j_psy1.mp2")
        lines.append(f"MP2 f64 {nf - 1} frames == the golden ({time.perf_counter() - t0:.1f} s)")
        sig = music_like(30, seed=21)[:, :3 * 5760]
        for label, args, ch in (("LC 96k", ["-b", "96"], 2), ("--sbr 48k mono", ["--sbr", "-b",
                                "48", "-c", "1"], 1), ("--ps 32k", ["--ps", "-b", "32"], 2)):
            wav = write_wav(tmp / f"in{ch}.wav", sig[:ch])
            out = tmp / "o.dabp"
            t0 = time.perf_counter()
            check(cli.main(args + ["-i", wav, "-o", str(out)] + cuda) == 0,
                  f"phase 10: {label}: rc != 0")
            data, n = out.read_bytes(), 15 * int(args[args.index("-b") + 1])
            check(len(data) == 3 * n and all(_superframe_ok([data[j:j + n] for j in
                                                             range(0, len(data), n)])),
                  f"phase 10: {label}: 3 valid superframes expected")
            lines.append(f"DAB+ {label}: 3 superframes valid ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        check(aacenc_cli.main(["-r", "96000"] + cuda + [str(tmp / "in2.wav"),
                                                         str(tmp / "o.loas")]) == 0,
              "phase 10: aacenc rc != 0")
        frames = loas_frames((tmp / "o.loas").read_bytes())
        check(len(frames) == 18, f"phase 10: {len(frames)} LOAS frames for 18 AUs")
        lines.append(f"aacenc: {len(frames)} LOAS frames ({time.perf_counter() - t0:.1f} s)")
    k_l = (kernels.launches, kernels.noise_launches)
    check(k_l == (0, 0), f"phase 10: the CLI launched the psy-1 kernels {k_l}")
    print(f"phase 10: the CLIs on the card: {'; '.join(lines)}; psy-1 kernel launches {k_l} "
          f"[{card}]", flush=True)
    return k_l


BENCH_ITERS = 3         # timed steps of the bench's device cells (its default: 10)
BENCH_FLEET_S = 2.88    # seconds of audio per fleet_64 station (its default: 30)


def phase_bench(card, kernels, torch, dev):
    """Phase 11: the port's full-path bench (odr_audioenc_tpu_torch.bench)
    on the card.  Returns (tonal_walk launches, tonal_noise launches) of the
    run."""
    import math
    from odr_audioenc_tpu_torch import bench
    from odr_audioenc_tpu_torch.host import mp2parse
    kernels.launches = kernels.noise_launches = 0
    t0 = time.perf_counter()
    rates = bench.run_cells(S_FULL, BENCH_ITERS, dev, card, fleet_seconds=BENCH_FLEET_S)
    wall = time.perf_counter() - t0
    k_l = (kernels.launches, kernels.noise_launches)
    cells = bench.last_cells
    check(list(rates) == list(bench.CELLS), f"phase 11: cells {list(rates)}")
    check(all(math.isfinite(r) and r > 0 for r in rates.values()), f"phase 11: rates {rates}")
    check(tuple(map(sum, zip(*(cells[c]["launches"] for c in bench.CELLS)))) == k_l,
          f"phase 11: the cells' launches do not add up to the run's {k_l}")
    mp2 = cells["mp2_128"]
    check(mp2["steps"] == BENCH_ITERS + 2 and mp2["launches"] == (BENCH_ITERS + 2, 0),
          f"phase 11: mp2_128 launched {mp2['launches']} (tonal_walk, tonal_noise) in "
          f"{mp2['steps']} steps")
    check(len(mp2["last"]) == S_FULL and all(len(f) == 384 for f in mp2["last"]),
          "phase 11: wrong frame count or size in mp2_128's last drain")
    sfs = []            # every superframe drained last, checked below in one go
    for name, (subch, _, _) in bench.DABPLUS_CELLS.items():
        c = cells[name]
        check(c["launches"] == (0, 0), f"phase 11: {name} launched the psy-1 kernels "
              f"{c['launches']}")
        check(c["leaves"] == ["wire"], f"phase 11: {name}'s step downloads {c['leaves']}")
        check(len(c["last"]) == S_FULL and all(len(f) == 120 * subch for f in c["last"]),
              f"phase 11: wrong superframe count or size in {name}'s last drain")
        sfs += c["last"]
    n_sf = len(sfs)
    fl = cells["fleet_64"]
    groups = {g["key"][0] if g["key"][0] == "mp2" else g["key"][-1]: g for g in fl["groups"]}
    mp2_steps = groups["mp2"]["chunks"] * groups["mp2"]["k"]
    check(fl["launches"] == (mp2_steps, 0), f"phase 11: fleet_64 launched {fl['launches']} "
          f"(tonal_walk, tonal_noise) in {mp2_steps} MP2 steps")
    chunk = 40 * 1152                 # 0.96 s: 40 MP2 frames, 8 superframes
    check(fl["steps"] == -(-round(48000 * BENCH_FLEET_S) // chunk) + 1,
          f"phase 11: fleet_64 ran {fl['steps']} passes")
    specs = bench.fleet64_streams("", "", "")
    aot_of = ["mp2"] * 32 + ["lc"] * 16 + ["sbr"] * 8 + ["ps"] * 8
    fb = [3 * s["bitrate"] if s["codec"] == "mp2" else 15 * s["bitrate"] for s in specs]
    check(all(len(fl["last"][i]) == groups[aot_of[i]]["k"] * fb[i] for i in range(64)),
          "phase 11: fleet_64's last drain has the wrong size")
    check(all(fl["sizes"][i] == (mp2_steps - 1) * fb[i] for i in range(32)),
          "phase 11: wrong MP2 byte count in fleet_64")
    fl_frames = [f for i in range(32) for f in mp2parse.split_frames(fl["last"][i])]
    fl_sfs = [fl["last"][i][j:j + fb[i]] for i in range(32, 64)
              for j in range(0, len(fl["last"][i]), fb[i])]
    # one pass of CRC workers per checker (each worker's start imports torch)
    check(all_crc_ok(mp2["last"] + fl_frames),
          "phase 11: an MP2 frame of mp2_128's or fleet_64's last drain fails its CRC")
    check(all_crc_ok(sfs + fl_sfs, "_superframe_ok"), "phase 11: a superframe of the DAB+ "
          "cells' or fleet_64's last drain fails RS, its firecode or an AU CRC")
    line = bench.headline(rates, S_FULL, dev, card)
    print(f"phase 11: the port's bench (odr_audioenc_tpu_torch.bench.run_cells) on the card, "
          f"S={S_FULL}, {BENCH_ITERS} timed steps, fleet_64 on {BENCH_FLEET_S} s of audio "
          f"({fl['steps']} passes, 2 warm): last drains valid ({len(mp2['last'])} MP2 frames, "
          f"{n_sf} superframes; fleet_64 {len(fl_frames)} MP2 frames and {len(fl_sfs)} "
          f"superframes); tonal_walk {mp2['launches'][0]} launches in the mp2_128 cell, "
          f"{fl['launches'][0]} in fleet_64's {mp2_steps} MP2 steps, 0 in the DAB+ cells; "
          f"tonal_noise {k_l[1]}; headline {line['value']} streams x realtime; {wall:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps(line), flush=True)
    return k_l


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

    names = ("tonal_walk", "tonal_noise", "rate_loop", "au_pack", "mp2_alloc")
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
        check(flips <= B // 256, f"B={B}: {flips} noise-member flips")
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
    check(same_bytes >= 0.999 * len(flat),
          f"phase 4b: only {same_bytes}/{len(flat)} frames byte-equal to phase 4's")
    frt = S_FULL * FRAME_S / (fstep_ms / 1000.0)
    print(f"phase 4b: S={S_FULL} f32 fast path, psy_kernel=fused-noise: {len(fflat)} frames "
          f"CRC-valid, {noise_launches} tonal_noise launches, 0 tonal_walk; step "
          f"{fstep_ms:.3f} ms (mean of {TIMED}), {frt:.1f} streams x realtime "
          f"(phase 4, tonal: {step_ms:.3f} ms) [{card}]; vs phase 4: {same_bytes} frames "
          f"byte-equal, {same_f}/{len(flat)} with the same bit_alloc", flush=True)

    # ---- phase 4c: the allocation kernel vs its plain version at the MP2 cells' shapes ----
    alloc_k = phase_alloc_kernel(card, torch, dev)

    # ---- phase 5: psy models 0, 2 and 3 at full width ---------------------------------
    for psy, (warm, timed) in ((0, (2, 3)), (2, (2, 3)), (3, (1, 2))):
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
    # 2 + 3 superframes (2 + 5 until phases 9 and 10 joined the run)
    d_warm, d_timed = 2, 3
    n_sf = d_warm + d_timed
    dpcm = superframe_pcm(S_FULL, n_sf, seed=13)                # [n_sf, S, 2, 5760]
    denc = dmodel.DabPlusEncoder(dcfg, S_FULL, dtype=torch.float32, device=dev)
    psycho1_kernels.launches = psycho1_kernels.noise_launches = 0
    dframes, dstep, dpack, douts, _, dinfo = run_dabplus(denc, dpcm, torch, pack_check=True)
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
    d_same, d_total, d_split = same_decisions(douts, cpu_outs, ("gains", "books", "wseq"))
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
          f"on {n_sf * n8 * dcfg.num_aus} AUs, {d_same}/{d_total} AUs decide as the CPU f32 port "
          f"({split_text(d_split)})", flush=True)
    report_pack_check("DAB+ LC 48 kHz stereo 96k (lc_96)", dcfg, dinfo, S_FULL, card)
    # what phase 8b holds the device-mode encoder against
    host_runs = {"lc_96": ("DAB+ LC 48 kHz stereo 96k (lc_96)", dcfg, dpcm, dframes,
                           (d_ms, pack_ms), dinfo["d2h_bytes"])}

    # ---- phase 6b: DAB+ f64 on the card vs the f64 port on the CPU ---------------------
    s64 = 8
    enc64 = dmodel.DabPlusEncoder(dcfg, s64, dtype=torch.float64, device=dev)
    f64_frames, f64_step, _, f64_outs, _, _ = run_dabplus(enc64, dpcm[:3, :s64], torch)
    cpu64 = encode_cpu(dcfg, dpcm[:3, :s64], torch.float64, torch)
    keys = ("q", "gains", "books", "bits", "ms_used", "tns_en", "tns_order", "tns_idx",
            "tns_en_lo", "tns_order_lo", "tns_idx_lo", "tns_len", "wseq")
    e_same, e_total, _ = same_decisions(f64_outs, cpu64, keys)
    flat64 = [f for fs in f64_frames for f in fs]
    check(all(_superframe_ok(flat64)), "phase 6b: a superframe is invalid")
    check(e_same >= 0.99 * e_total,
          f"phase 6b: only {e_same}/{e_total} AUs decide in f64 as on the CPU")
    print(f"phase 6b: DAB+ LC f64 on the card, S={s64}, 3 superframes: {e_same}/{e_total} AUs "
          f"with every integer output equal to the CPU f64 port's, {len(flat64)} superframes "
          f"valid; step {1000.0 * statistics.mean(f64_step):.1f} ms", flush=True)

    # ---- phase 6c: the rate-loop kernel vs its plain version at the LC cell's shape ------
    rate_k = phase_rate_kernel(card, torch, dev)

    # ---- phases 7 / 7b / 7c: HE-AAC and HE-AAC v2 at full width, host pack ---------------
    # the phase 6 music (a 48 kHz HE-AAC superframe is 3 AUs of 1920 samples,
    # 5760 as LC's 6 of 960); mono configurations read its left channel
    he_cfgs = (("7", "HE-AAC 48 kHz mono 48k (sbr_48)",
                dmodel.DabPlusConfig(48000, 6, 1, aot="sbr")),
               ("7b", "HE-AAC v2 48 kHz stereo 32k (ps_32)",
                dmodel.DabPlusConfig(48000, 4, 2, aot="ps")),
               ("7c", "HE-AAC 48 kHz stereo 64k", dmodel.DabPlusConfig(48000, 8, 2, aot="sbr")))
    for phase, label, hcfg in he_cfgs:
        hpcm = np.ascontiguousarray(dpcm[:, :, :hcfg.channels])
        henc = dmodel.DabPlusEncoder(hcfg, S_FULL, dtype=torch.float32, device=dev)
        psycho1_kernels.launches = psycho1_kernels.noise_launches = 0
        in_8 = phase in ("7", "7b")                 # the sbr_48 and ps_32 shapes of phase 8
        hframes, hstep, hpack, houts, n_cpl, hinfo = run_dabplus(
            henc, hpcm, torch, count_key="sbr_cpl", pack_check=in_8)
        h_l = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
        check(h_l == (0, 0), f"phase {phase}: the HE-AAC path launched the psy-1 kernels {h_l}")
        hflat = [f for fs in hframes for f in fs]
        check(len(hflat) == S_FULL * n_sf and all(len(f) == 120 * hcfg.subch for f in hflat),
              f"phase {phase}: wrong superframe count or size")
        check(all_crc_ok(hflat, "_superframe_ok"),
              f"phase {phase}: a superframe fails RS, its firecode or an AU CRC")
        n_aus, n_off = check_heaac_aus(henc, houts, phase)
        h_same, h_total, h_split = same_decisions(
            houts, encode_cpu(hcfg, hpcm[:, :n8], torch.float32, torch),
            ("gains", "books", "wseq"), tuple(k for k in HE_SIDE if k in houts[0]))
        check(h_same >= 0.9 * h_total,
              f"phase {phase}: only {h_same}/{h_total} AUs decide as on the CPU")
        h_ms = 1000.0 * statistics.mean(hstep[d_warm:])
        hp_ms = 1000.0 * statistics.mean(hpack[d_warm:])
        cpl = (f"; {n_cpl} of {S_FULL * n_sf * hcfg.num_aus} AUs coupled"
               if henc.core_channels == 2 else "")
        print(f"phase {phase}: {label}, S={S_FULL} f32, host pack (native): {len(hflat)} "
              f"superframes of {120 * hcfg.subch} bytes valid (RS, firecode, AU CRCs); device "
              f"step {h_ms:.3f} ms, host pack {hp_ms:.3f} ms (means of {d_timed}), "
              f"{S_FULL * 0.12 / (h_ms / 1000.0):.1f} streams x realtime on the device step, "
              f"{S_FULL * 0.12 / ((h_ms + hp_ms) / 1000.0):.1f} with the pack [{card}]; "
              f"{henc.recover_checks / n_sf:.1f} crash-recovery syncs per superframe, "
              f"{henc.recoveries} recoveries; psy-1 kernel launches {h_l}; first {n8} streams: "
              f"counted core == written + 10 and FIL == payload_bits on {n_aus} AUs (FIL off "
              f"the reference's count, sbr_bits, on {n_off}), "
              f"{h_same}/{h_total} AUs with the CPU f32 port's core decisions and side "
              f"data ({split_text(h_split)}){cpl}", flush=True)
        if in_8:
            report_pack_check(label, hcfg, hinfo, S_FULL, card)
            host_runs["sbr_48" if phase == "7" else "ps_32"] = (
                label, hcfg, hpcm, hframes, (h_ms, hp_ms), hinfo["d2h_bytes"])
        del henc, hflat

    # ---- phase 7d: the three HE-AAC configurations in f64 on the card vs the CPU ------------
    psycho1_kernels.launches = psycho1_kernels.noise_launches = 0
    for _, label, hcfg in he_cfgs:
        hpcm = np.ascontiguousarray(dpcm[:3, :s64, :hcfg.channels])
        h64 = dmodel.DabPlusEncoder(hcfg, s64, dtype=torch.float64, device=dev)
        h64_frames, h64_step, _, h64_outs, _, _ = run_dabplus(h64, hpcm, torch)
        hkeys = keys + ("sbr_bits",) + tuple(k for k in HE_SIDE if k in h64_outs[0])
        e_same, e_total, _ = same_decisions(h64_outs, encode_cpu(hcfg, hpcm, torch.float64,
                                                                 torch), hkeys)
        flat64 = [f for fs in h64_frames for f in fs]
        check(all(_superframe_ok(flat64)), f"phase 7d: {label}: a superframe is invalid")
        check(e_same >= 0.99 * e_total,
              f"phase 7d: {label}: only {e_same}/{e_total} AUs decide in f64 as on the CPU")
        print(f"phase 7d: {label} f64 on the card, S={s64}, 3 superframes: {e_same}/{e_total} "
              f"AUs with every integer output equal to the CPU f64 port's, {len(flat64)} "
              f"superframes valid; step {1000.0 * statistics.mean(h64_step):.1f} ms", flush=True)
    h_l = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
    check(h_l == (0, 0), f"phase 7d: the HE-AAC path launched the psy-1 kernels {h_l}")

    # ---- phase 8b: the device-mode encoder at full width, against phases 6, 7 and 7b -------
    for shape in ("lc_96", "sbr_48", "ps_32"):
        label, hcfg, hpcm, host_frames, host_ms, host_d2h = host_runs.pop(shape)
        run_device_pack(label, hcfg, hpcm, host_frames, host_ms, host_d2h, d_warm, torch,
                        dev, card, psycho1_kernels)
        del host_frames

    # ---- phase 8c: the multi-device dry run on this host's one card --------------------------
    from odr_audioenc_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(1)
    print(f"phase 8c: dryrun_multichip(1) on the card: MP2 and DAB+ LC, HE-AAC and HE-AAC v2 "
          f"with the device pack, every row equal to a second run's, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 8d: X-PAD through the device pack ----------------------------------------------
    pcfg = dmodel.DabPlusConfig(48000, 12, 2, pad_len=16)
    prng = np.random.default_rng(17)
    penc_h = dmodel.DabPlusEncoder(pcfg, s64, dtype=torch.float32, device=dev)
    penc_d = dmodel.DabPlusEncoder(pcfg, s64, dtype=torch.float32, device=dev,
                                   pack_on_device=True)
    st_h, st_d, p_same, n_pad = penc_h.init_state(), penc_d.init_state(), 0, 0
    for t in range(3):
        pads = [[bytes(prng.integers(0, 256, int(prng.integers(0, 17))).astype(np.uint8))
                 for _ in range(pcfg.num_aus)] for _ in range(s64)]
        n_pad += sum(len(p) for ps in pads for p in ps)
        st_h, fr_h = penc_h.encode_superframes(st_h, dpcm[t, :s64], pads=pads)
        st_d, fr_d = penc_d.encode_superframes(st_d, dpcm[t, :s64], pads=pads)
        check(all(_superframe_ok(fr_d)), "phase 8d: a device-packed superframe is invalid")
        p_same += sum(a == b for a, b in zip(fr_h, fr_d))
    check(p_same == 3 * s64, f"phase 8d: only {p_same}/{3 * s64} X-PAD superframes equal the "
          f"host pack's")
    print(f"phase 8d: X-PAD (pad_len=16, {n_pad} random pad bytes), DAB+ LC 96k, S={s64}, 3 "
          f"superframes: device pack == native host pack on {p_same}/{3 * s64}", flush=True)

    # ---- phase 8e: the AU-pack kernel vs the slot-grid pack at the DAB+ cells' shapes ---------
    pack_k = phase_aupack_kernel(card, torch, dev)

    # ---- phase 9: fleet_64 through the CLI's --streams; phase 10: the single-stream CLIs ----
    fleet_l = phase_fleet(card, psycho1_kernels, torch, dev)
    cli_l = phase_cli(card, psycho1_kernels, torch)

    # ---- phase 11: the port's full-path bench --------------------------------------------
    bench_l = phase_bench(card, psycho1_kernels, torch, dev)

    left = live_children()
    check(not left, f"child processes still running: {left}")
    print(f"child processes left running: {len(left)}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "tonal_walk", "route": "cuda",
         "source": "odr_audioenc_tpu_torch/csrc/tonal_walk.cu",
         "replaces": "odr_audioenc_tpu/mp2/psycho1_pallas.py:140",
         "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": kb_ms, "bound_by": "bytes", "library_ms": None, "device_ms": kd_ms,
         "share": kb_ms / kd_ms,
         "launches_by_path": {"mp2_128 (phase 4)": launches, "fused-noise (phase 4b)": w_l,
                              "fleet_64 (phase 9)": fleet_l[0], "cli (phase 10)": cli_l[0],
                              "bench (phase 11)": bench_l[0]}},
        {"name": "tonal_noise", "route": "cuda",
         "source": "odr_audioenc_tpu_torch/csrc/tonal_noise.cu",
         "replaces": "odr_audioenc_tpu/mp2/psycho1_pallas.py:151",
         "launches": noise_launches, "max_abs_err": err_n, "ms": kn_ms, "plain_ms": pn_ms,
         "bound_ms": knb_ms, "bound_by": "bytes", "library_ms": None, "device_ms": knd_ms,
         "share": knb_ms / knd_ms,
         "launches_by_path": {"mp2_128 (phase 4)": n_l, "fused-noise (phase 4b)": noise_launches,
                              "fleet_64 (phase 9)": fleet_l[1], "cli (phase 10)": cli_l[1],
                              "bench (phase 11)": bench_l[1]}},
        alloc_k, rate_k, pack_k]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
