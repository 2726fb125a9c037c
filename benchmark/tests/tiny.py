"""A copy of the benchmark with its cells cut to a CPU's size, for the tests:
the same files, with fewer stations and a shorter programme."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SIZES = {"dabplus_lc96.music": 4, "mp2_48k.music128": 6, "mp2_48k.mux_mix": 8}


def tiny_copy(dest, sizes=SIZES):
    """benchmark/ and BENCHMARK.json under `dest`; returns the copy's root."""
    root = Path(dest) / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", Path(dest) / "BENCHMARK.json")
    for cell, S in sizes.items():
        path = root / "workloads" / f"{cell}.json"
        wl = json.loads(path.read_text())
        wl["stations"] = S
        wl["programme"]["seconds"] = 1.0
        wl["trace_steps"] = 1
        chk = wl["check"]
        if "stations" in chk:
            chk["stations"] = S
        else:
            chk["per_step"] = S
        path.write_text(json.dumps(wl))
    return root


def run_tiny(root, cell, seed=7, seconds=1.0, **kw):
    """One run of `cell` of the copy on the CPU; returns the result line."""
    import time
    import torch
    from benchmark import harness
    from benchmark.run import result
    t = time.perf_counter()
    dev = torch.device("cpu")
    run, checks, compared, failed, peak = harness.run_cell(cell, seed, seconds, 0, dev, t,
                                                           root=root, **kw)
    return result(cell, 0, run, checks, compared, failed, peak, dev, root)
