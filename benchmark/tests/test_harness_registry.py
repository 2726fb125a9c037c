"""Everything of a cell is found by name: BENCHMARK.json's cells, their
configurations, drivers, references, traffic kinds and metric readers are
files, and a new cell or metric is picked up with no code edited."""
import json

import pytest

from benchmark import registry
from benchmark.run import read_metrics
from tiny import run_tiny, tiny_copy

BENCH = registry.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    wl, cfg = registry.cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] == cfg["name"]
    assert wl["chips"] == entry["chips"] and wl["why"] == entry["why"]
    registry.module("drivers", cfg["driver"]).Driver
    registry.module("reference", cfg["reference"]).expected
    registry.module("traffic", wl["programme"]["kind"]).make
    unit = registry.module("reference", cfg["reference"]).UNIT
    assert set(wl["check"]["limits"]) == {f"{unit}_differ_pct", f"{unit}_invalid_pct"}
    names = [m["name"] for m in registry.metrics_of(cell, 0) + registry.metrics_of(cell, 1)]
    assert "setup_s" in names and "streams_x_rt" in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.module("metrics", metric).read)


def test_config_files_are_benchmarks(tmp_path):
    for c in BENCH["configs"]:
        cfg = json.loads((registry.ROOT.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_a_new_cell_and_metric_are_picked_up_without_code(tmp_path):
    """A workload file and a metric reader added to a copy: the copy's run
    finds both by name."""
    root = tiny_copy(tmp_path)
    wl = json.loads((root / "workloads" / "mp2_48k.mux_mix.json").read_text())
    wl.update(stations=5, pattern=[{"bitrate": 256, "mode": "s"}, {"bitrate": 64, "mode": "j"}],
              why="a new cell")
    (root / "workloads" / "mp2_48k.new_mix.json").write_text(json.dumps(wl))
    (root / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return len(run['steps'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["mp2_48k.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_tiny(root, "mp2_48k.new_mix", seconds=0.5)
    assert line["correct"], line
    assert set(line["metrics"]) == {"streams_x_rt", "setup_s", "steps_in_window"}
    assert line["metrics"]["steps_in_window"]["value"] >= 1
    assert line["attempted"] == 5 * line["metrics"]["steps_in_window"]["value"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    root = tiny_copy(tmp_path)
    run = {"codec": "dabplus", "trace": None, "steps": [{"dispatch_s": 0.1, "drain_s": 0.01}]}
    got = read_metrics("dabplus_lc96.music", 1, run, root)
    assert set(got) == {"dispatch_ms.dabplus", "slice_ms.dabplus"}
