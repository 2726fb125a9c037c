"""Readings of the check's numbers for setting its limits, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --impl program
    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --impl control
    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --impl fault:half_batch

Each seed is one run of the cell in this process (as benchmark.run makes
it, with --seconds of window), and prints one JSON line: the numbers the
check compares, with the answers compared and the window's steps.
`program` is the port as the cell runs it (the lower readings); `control`
puts the plain reference in the program's place, computed in the nearest
precision below the configuration's float32: float32 with TF32 matmuls
(the port pins TF32 off); `fault:<name>` plants one of faults.FAULTS under
the program.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import registry  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def set_tf32(on):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Control:
    """The reference's Driver in the program's place, its steps in float32
    with TF32 matmuls (the switch is read when a matmul is launched, so it
    is on for the dispatch alone and off for the check's reference)."""

    def __init__(self, reference, root):
        self.reference, self.root = reference, root

    def __call__(self, config, workload, device):
        import torch
        self.inner = registry.module("reference", self.reference, self.root).Driver(
            config, workload, device, torch.float32)
        return self

    def dispatch(self, pcm):
        set_tf32(True)
        try:
            return self.inner.dispatch(pcm)
        finally:
            set_tf32(False)

    def drain(self, out, rows):
        return self.inner.drain(out, rows)


def one(cell, seed, seconds, impl, device, t_start, root=registry.ROOT, per_step=None):
    """One run of `cell` with `impl` in the program's place; its readings."""
    import torch
    from benchmark.harness import run_cell
    _, cfg = registry.cell(cell, root)
    kw = {"root": root, "per_step": per_step}
    if impl == "control":
        kw["make_driver"] = Control(cfg["reference"], root)
    elif impl.startswith("fault:"):
        kw["wrap"] = FAULTS[impl.split(":", 1)[1]]
    elif impl != "program":
        raise SystemExit(f"unknown --impl {impl!r}")
    run, checks, compared, failed, peak = run_cell(cell, seed, seconds, 0, device, t_start, **kw)
    t0, t1 = run["window"]
    return {"cell": cell, "impl": impl, "seed": seed, "checks": checks, "compared": compared,
            "failed": failed, "steps": len(run["steps"]), "window_s": t1 - t0,
            "setup_s": run["setup_s"], "check_s": run["check_s"],
            "memory_peak_bytes": peak, "card": torch.cuda.get_device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--impl", default="program")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--per-step", type=int, help="stations checked per step (MP2), in place "
                    "of the workload's, so that a control of fewer, slower steps compares "
                    "as many answers as a run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    t_start = T_START
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(one(args.workload, seed, args.seconds, args.impl, device, t_start,
                             per_step=args.per_step)), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
