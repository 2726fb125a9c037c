"""One run of one cell of the benchmark on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer ones with --trace 1, as
BENCHMARK.json lists them; each read by metrics/<name>.py), `device`, with
--trace 1 `breakdown`, and last `checks`: each number compared beside its
limit, which also end standard error.  Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits 2; if a module of JAX
or of the JAX package is loaded once the result is built (every metric
reader loaded), it prints no result and exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import registry  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "odr_audioenc_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def read_metrics(cell, trace, run, root=registry.ROOT):
    """{name: {"value", "unit"}} of the metrics BENCHMARK.json gives the
    cell; a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in registry.metrics_of(cell, trace, root):
        value = registry.module("metrics", m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, trace, run, checks, compared, failed, peak, device, root=registry.ROOT):
    """The result line's object, `checks` last."""
    import torch
    from benchmark.trace import breakdown
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()) and not failed,
            "attempted": len(run["steps"]) * run["S"], "failed": failed,
            "metrics": read_metrics(cell, trace, run, root)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": run["chips"], "memory_peak_bytes": peak}
    if trace:
        alone = run["trace"].get("device") or run["trace"]     # the device-only slice
        dev.update(busy_s=alone["busy_s"], window_s=alone["window_s"])
    line["device"] = dev
    if trace:
        line["breakdown"] = breakdown(run["trace"])
    line["card"] = card(device) if device.type == "cuda" else "cpu"
    line["compared"] = compared
    line["checks"] = checks
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    wl, _ = registry.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    return measure(args.workload, args.seed, args.seconds, args.trace, torch.device("cuda", 0),
                   T_START)


def measure(cell, seed, seconds, trace, device, t_start, root=registry.ROOT):
    """Run the cell, build its result line with every metric reader loaded,
    then look for JAX and the JAX package: with none loaded, print the
    checks and the line and return 0; else print nothing and return 3."""
    from benchmark.harness import run_cell
    run, checks, compared, failed, peak = run_cell(cell, seed, seconds, trace, device,
                                                   t_start, root=root)
    line = result(cell, trace, run, checks, compared, failed, peak, device, root)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(f"benchmark: window {run['window'][1] - run['window'][0]:.3f} s, "
          f"{len(run['steps'])} steps; reference check {run['check_s']:.3f} s; {line['card']}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}; {compared} compared)",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
