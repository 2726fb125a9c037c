"""No run loads JAX or the JAX package; the top-level module names are
compared whole, since the port's name begins with the JAX package's."""
import json
import shutil
import subprocess
import sys
import time
import types

import torch

from benchmark import registry
from benchmark.run import forbidden_modules, measure
from tiny import tiny_copy

REPO = registry.ROOT.parent


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "odr_audioenc_tpu_torch_extra", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "odr_audioenc_tpu.mp2", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert forbidden_modules() == ["jaxlib", "odr_audioenc_tpu.mp2"]


def test_a_run_loads_neither(tmp_path):
    """A tiny run of every cell in a fresh process, then its modules."""
    code = f"""
import sys, json
sys.path.insert(0, {str(REPO / 'benchmark' / 'tests')!r})
from tiny import tiny_copy, run_tiny
root = tiny_copy({str(tmp_path)!r})
for cell in ("mp2_48k.music128", "dabplus_lc96.music"):
    assert run_tiny(root, cell, seconds=0.3)["compared"] > 0
from benchmark.run import forbidden_modules
print(json.dumps([forbidden_modules(), sorted(m for m in sys.modules if m.startswith("tests"))]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]


def test_no_result_without_a_card_or_the_program(tmp_path):
    """In a directory with BENCHMARK.json and benchmark/ alone the run exits
    with an error and prints no result (here there is no card either)."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "mp2_48k.music128", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, monkeypatch, capsys):
    """Metric readers load after the window, while the result is built; a
    new reader that imports a module named `jax` (here a stand-in) makes
    the run exit 3 with nothing on standard output."""
    root = tiny_copy(tmp_path / "copy")
    (root / "metrics" / "probe.py").write_text(
        '"""Reads nothing; imports jax."""\nimport jax  # noqa: F401\n\n\n'
        "def read(run):\n    return 1.0\n")
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "probe", "unit": "s", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": ["mp2_48k.music128"]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "standin").mkdir()
    (tmp_path / "standin" / "jax.py").write_text('"""A stand-in named jax."""\n')
    monkeypatch.syspath_prepend(str(tmp_path / "standin"))
    had = sys.modules.pop("jax", None)
    try:
        code = measure("mp2_48k.music128", 7, 0.3, 0, torch.device("cpu"), time.perf_counter(),
                       root=root)
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    out = capsys.readouterr()
    assert code == 3 and out.out == ""
    assert "['jax']" in out.err
