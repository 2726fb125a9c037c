"""Everything of one configuration, cell, driver, traffic kind, reference
or metric is a file of its own, found here by its name: a later cell or
metric is a new file, and no code is edited for it."""
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_json(kind, name, root=ROOT):
    """configs/<name>.json or workloads/<name>.json."""
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def cell(name, root=ROOT):
    """(workload, config) of the cell `name`."""
    wl = load_json("workloads", name, root)
    return wl, load_json("configs", wl["config"], root)


def module(kind, name, root=ROOT):
    """The module <kind>/<name>.py (a name may hold dots), loaded from its file."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    key = f"benchmark_{kind}_{name}_{abs(hash(str(path)))}".replace(".", "_")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    """BENCHMARK.json beside the benchmark's folder."""
    return json.loads((Path(root).parent / "BENCHMARK.json").read_text())


def metrics_of(cell_name, trace, root=ROOT):
    """The metrics a run of `cell_name` reports: the end-to-end ones
    (trace 0) or the per-layer ones (trace 1) whose `workloads` take it."""
    entries = benchmark(root)["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]
