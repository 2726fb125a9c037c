"""Time the psy-1 CUDA kernels on one card against an earlier version of
their sources, in turns.

    python -m odr_audioenc_tpu_torch.bench_psy1_kernels --old DIR [--old-tables current]
                                                        [--rows 4096] [--out FILE]

Run from the root of a checkout, on a machine with one NVIDIA card.  DIR
holds tonal_walk.cu, tonal_noise.cu and psy1_tonal.cuh of the earlier
version, with the C interface it had before the walk table (`runs` a [512]
int32 run table), e.g. from `git show <commit>:odr_audioenc_tpu_torch/csrc/<file>`.
With --old-tables current, DIR's sources have this tree's C interface (the
walk table and the noise geometry's table) and only the kernels' device time
and agreement are compared: the wrapper is the same.
Both versions are built with kernels/build.py's nvcc flags.

On psy-1 spectra of music-like PCM at B rows (the MP2 main path's B = 2 S),
for each kernel and in the order old, new, new, old:
  - device time per call: CUDA events around 200 back-to-back launches of
    the bare C launcher with preallocated outputs, cycling over six input
    sets (the tonal walk reads 63 MB of them, more than the 50 MB L2),
    divided by 200;
  - host enqueue per call: host clock over 1000 wrapper calls without a
    sync (the new version through psycho1_kernels; the old through the
    per-call steps of its own wrapper: the argument checks, the run
    table's lookup, three empty_like, the geometry's int32 conversion, the
    device context, a ctypes call);
and both versions' outputs against the plain version (tonal walk: masks
equal; fused: tone members equal, noise-member flips counted).  Prints the
card line, ptxas's report of each build and one JSON line (also written to
FILE with --out).
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import convert
from . import tables as T
from .device import const
from .kernels import build
from .mp2 import psycho1, psycho1_fast, psycho1_kernels as K

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
# each input byte read once, each output byte written once: power (+ energy)
# and candidates in; power', two bool masks out
BYTES_PER_BIN = {"tonal_walk": 4 + 1 + 4 + 1 + 1, "tonal_noise": 4 + 4 + 1 + 4 + 1 + 1}


def bound_ms(name, rows):
    """The least time of kernel `name` on [rows, 512]: its bytes at the
    card's memory rate."""
    return BYTES_PER_BIN[name] * K.NBINS * rows / HBM_BYTES_PER_S * 1e3
OLD_ARGTYPES = {
    "tonal_walk": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p],
    "tonal_noise": [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def build_old(src_dir, name):
    """csrc/<name>.cu of the earlier version, built with this tree's flags
    into kernels/build/old-<name>.so; returns (ctypes function, ptxas log)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / f"old-{name}.so"
    cmd = [build.nvcc_path(), *build.FLAGS, "-o", str(so), str(Path(src_dir) / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the old {name}:\n{res.stdout}\n{res.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), name + "_launch")
    fn.argtypes = OLD_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def ptxas_summary(log):
    return " | ".join(line.split("ptxas info    : ")[-1].strip() for line in log.splitlines()
                      if "Used" in line or "spill" in line)


def spectra(rows, seed, dev):
    """psy-1 power, energy and candidates of music-like windows, [rows, 512]."""
    from signals import music_like
    src = music_like(rows // 2 + 48, seed=seed)                       # [2, N]
    offs = np.random.default_rng(seed).integers(0, src.shape[1] - 1024, rows)
    win = np.stack([src[i % 2, o:o + 1024] for i, o in enumerate(offs)])
    w = torch.as_tensor(win.astype(np.float32) / 32768.0, device=dev)
    power, energy, _ = psycho1.power_spectrum(w)
    return power.contiguous(), energy.contiguous(), psycho1.tonal_candidates(power).contiguous()


def device_ms(launch, n_sets, reps=200):
    """CUDA events around `reps` back-to-back launches of a bare launcher
    (launch(i) launches on input set i, cycling over `n_sets`); ms per
    launch."""
    for i in range(3):
        launch(i % n_sets)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        launch(i % n_sets)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(call, calls=1000):
    """Host clock over `calls` calls without a sync; microseconds per call."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory with the earlier kernel sources")
    ap.add_argument("--old-tables", choices=("runs", "current"), default="runs",
                    help="the table argument the earlier sources take: the [512] run table, "
                         "or this tree's walk and noise tables")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_psy1_kernels: no CUDA device")
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root / "tests")]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    B = args.rows
    sets = [spectra(B, seed, dev) for seed in range(5, 11)]
    tabs48 = psycho1_fast.make_fast_tables(psycho1.make_psy1_tables(np.array([1])))
    uniform = convert.tables_from_numpy({"static_noise_uniform": tabs48["static_noise_uniform"]},
                                        dev, torch.float32)["static_noise_uniform"]
    bmt, base, span = uniform
    base32, span32 = base.to(torch.int32).contiguous(), span.to(torch.int32).contiguous()
    runs_old = torch.as_tensor(T.TONAL_RUN, dtype=torch.int32, device=dev)
    walk_tab = torch.as_tensor(K.walk_table(), device=dev)
    noise_tab = K._geometry(*uniform)[0]
    cf = float(T.CF)
    stream = torch.cuda.current_stream(dev).cuda_stream

    old = {n: build_old(args.old, n) for n in ("tonal_walk", "tonal_noise")}
    new = {n: K._launcher(n) for n in ("tonal_walk", "tonal_noise")}
    logs = {f"old {n}": ptxas_summary(old[n][1]) for n in old}
    logs.update({f"new {n}": ptxas_summary(build.library_path(n).with_suffix(".log").read_text())
                 for n in new})
    for k, v in logs.items():
        print(f"ptxas {k}: {v}", flush=True)

    p0, e0, c0 = sets[0]
    outs = (torch.empty_like(p0), torch.empty_like(c0), torch.empty_like(c0))

    def walk(fn, table):
        def launch(i):
            p, _, c = sets[i]
            rc = fn(p.data_ptr(), c.data_ptr(), table.data_ptr(), *(o.data_ptr() for o in outs),
                    B, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return launch

    def noise(fn, table):
        def launch(i):
            p, e, c = sets[i]
            rc = fn(p.data_ptr(), c.data_ptr(), e.data_ptr(), table.data_ptr(), base32.data_ptr(),
                    span32.data_ptr(), *(o.data_ptr() for o in outs), cf, B, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return launch

    same_c = args.old_tables == "current"
    launchers = {("old", "tonal_walk"): walk(old["tonal_walk"][0], walk_tab if same_c else runs_old),
                 ("new", "tonal_walk"): walk(new["tonal_walk"], walk_tab),
                 ("old", "tonal_noise"): noise(old["tonal_noise"][0],
                                               noise_tab if same_c else runs_old),
                 ("new", "tonal_noise"): noise(new["tonal_noise"], noise_tab)}

    # agreement with the plain version, both versions, on every input set
    agree = {}
    for (ver, n), launch in launchers.items():
        worst = 0.0
        flips = 0
        for i, (p, e, c) in enumerate(sets):
            launch(i)
            torch.cuda.synchronize()
            if n == "tonal_walk":
                pp, mp, yp = psycho1_fast.tonal_fast(p, c)
                if not (torch.equal(outs[1], mp) and torch.equal(outs[2], yp)):
                    raise SystemExit(f"{ver} {n}: masks differ from the plain version")
                worst = max(worst, float((outs[0] - pp).abs().max()))
            else:
                pp, tp, npl = psycho1_fast.tonal_noise_fast(p, c, e, *uniform)
                if not torch.equal(outs[1], tp):
                    raise SystemExit(f"{ver} {n}: tone members differ from the plain version")
                flips += int((outs[2] != npl).sum())
                both = outs[2] & npl
                worst = max(worst, float((outs[0] - pp).abs()[both | (~outs[2] & ~npl)].max()))
        agree[f"{ver} {n}"] = {"max_abs_err_db": worst, "noise_flips": flips}

    # device time, in turns: old, new, new, old
    times = {k: [] for k in launchers}
    for n in ("tonal_walk", "tonal_noise"):
        for ver in ("old", "new", "new", "old"):
            times[(ver, n)].append(device_ms(launchers[(ver, n)], len(sets)))

    # host enqueue per call through each version's wrapper
    p, e, c = sets[0]

    old_runs_np = np.asarray(T.TONAL_RUN)

    def old_walk_call():
        # the earlier wrapper's steps: checks, run table, outputs, context, launch
        K._check_rows("tonal_walk", p, c)
        runs = const(old_runs_np, p.device, torch.int32)
        pw, member, typ = torch.empty_like(p), torch.empty_like(c), torch.empty_like(c)
        with torch.cuda.device(p.device):
            rc = old["tonal_walk"][0](p.data_ptr(), c.data_ptr(), runs.data_ptr(), pw.data_ptr(),
                                      member.data_ptr(), typ.data_ptr(), B,
                                      torch.cuda.current_stream(p.device).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def old_noise_call():
        K._check_rows("tonal_noise", p, c, e)
        K._geometry(bmt, base, span)                       # the earlier one-hot check, cached
        runs = const(old_runs_np, p.device, torch.int32)
        b32, s32 = base.to(torch.int32).contiguous(), span.to(torch.int32).contiguous()
        pw, tm, nm = torch.empty_like(p), torch.empty_like(c), torch.empty_like(c)
        with torch.cuda.device(p.device):
            rc = old["tonal_noise"][0](p.data_ptr(), c.data_ptr(), e.data_ptr(), runs.data_ptr(),
                                       b32.data_ptr(), s32.data_ptr(), pw.data_ptr(), tm.data_ptr(),
                                       nm.data_ptr(), cf, B,
                                       torch.cuda.current_stream(p.device).cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    host = {"new tonal_walk": host_us(lambda: K.tonal_walk(p, c)),
            "new tonal_noise": host_us(lambda: K.tonal_noise(p, c, e, *uniform))}
    if not same_c:
        host.update({"old tonal_walk": host_us(old_walk_call),
                     "old tonal_noise": host_us(old_noise_call)})

    result = {"card": card, "rows": B, "ptxas": logs, "agreement": agree, "host_us_per_call": host,
              "kernels": {}}
    for n in ("tonal_walk", "tonal_noise"):
        bound = bound_ms(n, B)
        row = {"bound_ms": bound, "bound_by": "bytes"}
        for ver in ("old", "new"):
            t = times[(ver, n)]
            row[ver] = {"device_ms_runs": t, "device_ms": statistics.median(t),
                        "share_of_bound": bound / statistics.median(t)}
        result["kernels"][n] = row
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")


if __name__ == "__main__":
    main()
