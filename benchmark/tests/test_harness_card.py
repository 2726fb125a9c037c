"""On the card (marked `cuda`; each test skips where there is none): every
cell runs briefly and comes out correct, and the control, the plain
reference in the program's place in float32 with TF32, comes out not
correct.  Run on a machine with a card:

    python3 -m pytest benchmark/tests/test_harness_card.py -q -m cuda
"""
import json
import subprocess
import sys

import pytest

from benchmark import registry
from tiny import tiny_copy

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_briefly_and_is_correct(cell):
    need_card()
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=registry.ROOT.parent, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
    assert set(line["metrics"]) == {m["name"] for m in registry.metrics_of(cell, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, tmp_path):
    need_card()
    import torch
    from benchmark.control import one
    root = tiny_copy(tmp_path, {c: 256 for c in CELLS})
    dev = torch.device("cuda", 0)
    for impl, sound in (("program", True), ("control", False)):
        got = one(cell, 5, 2.0, impl, dev, 0.0, root)
        assert all(c["value"] <= c["limit"] for c in got["checks"].values()) == sound, got
