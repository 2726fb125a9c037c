"""Each metric reader's arithmetic on a synthetic timeline and trace."""
import pytest

from benchmark import registry
from benchmark.trace import breakdown, busy_and_wall, summarize

S, AUDIO_S = 100, 0.024


def timeline(step_s=0.05, n=100, stall_at=None, stall_s=0.0):
    """n steps drained one every step_s (each handed two steps before its
    drain ends), the one at `stall_at` taking stall_s more."""
    steps, t = [], 0.0
    for k in range(n):
        t += step_s + (stall_s if k == stall_at else 0.0)
        steps.append({"k": k, "hand": t - 2 * step_s, "done": t, "dispatch_s": 0.01,
                      "drain_s": 0.002})
    return {"codec": "mp2", "S": S, "audio_s": AUDIO_S, "setup_s": 12.5, "window": (0.0, t),
            "steps": steps, "trace": None}


def read(name, run):
    return registry.module("metrics", name).read(run)


def test_rate_and_delay():
    run = timeline()
    assert read("streams_x_rt", run) == pytest.approx(100 * S * AUDIO_S / 5.0)
    assert read("frame_delay_p95_ms", run) == pytest.approx(100.0)
    assert read("setup_s", run) == 12.5
    assert read("dispatch_ms.mp2", run) == pytest.approx(10.0)
    assert read("emit_ms.mp2", run) == pytest.approx(2.0)
    assert read("dispatch_ms.dabplus", run) is None and read("slice_ms.dabplus", run) is None


def test_a_stall_in_the_window_moves_rate_and_tail():
    """Steps that wait on a stalled one are late too: ten stalls of 0.5 s
    put more than 5% of the steps' delays over the stall."""
    calm = timeline()
    run = timeline(stall_at=50, stall_s=2.0)
    assert read("streams_x_rt", run) == pytest.approx(100 * S * AUDIO_S / 7.0)
    assert read("streams_x_rt", run) < read("streams_x_rt", calm)
    stalled = timeline()
    for s in stalled["steps"][40:50]:
        s["hand"] -= 0.5
    assert read("frame_delay_p95_ms", stalled) == pytest.approx(600.0)
    assert read("frame_delay_p95_ms", stalled) > read("frame_delay_p95_ms", calm)


def test_too_few_steps_for_a_p95():
    assert read("frame_delay_p95_ms", timeline(n=19)) is None


def raw_trace():
    """Two steps: kernels 0-30 (two overlapping), a copy 50-60 and the
    tonal walk 70-80 us, in a slice of 0-100 us."""
    return {"steps": 2, "start_us": 0.0, "end_us": 100.0,
            "device": [("bench.dispatch", 0.0, 48.0), ("gemm", 0.0, 20.0), ("gemm", 10.0, 30.0),
                       ("Memcpy DtoH", 50.0, 60.0),
                       ("void tonal_walk_kernel(float const*)", 70.0, 80.0)],
            "host": [("bench.slice", 0.0, 100.0), ("bench.dispatch", 0.0, 48.0),
                     ("aten::_local_scalar_dense", 32.0, 47.0), ("aten::item", 31.0, 47.5),
                     ("bench.drain", 61.0, 100.0), ("aten::_local_scalar_dense", 62.0, 63.0)]}


def test_trace_readers():
    t = summarize(raw_trace())
    assert t["busy_s"] == pytest.approx(50e-6) and t["window_s"] == pytest.approx(100e-6)
    # the device-only slice: fills at 0-1 and 119-120 us, kernels 10-40 and 30-60
    alone = busy_and_wall([(0.0, 1.0), (10.0, 40.0), (30.0, 60.0), (119.0, 120.0)], 2)
    assert alone == {"steps": 2, "busy_s": pytest.approx(52e-6),
                     "window_s": pytest.approx(120e-6)}
    assert busy_and_wall([], 2) is None
    run = dict(timeline(), S=4, trace=dict(t, device=alone))
    # from the device-only slice alone: not the window's steps, nor the full slice
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 52 / 120))
    assert read("device_idle_pct", dict(run, window=(0.0, 1.0))) == pytest.approx(
        100 * (1 - 52 / 120))
    assert read("device_idle_pct", dict(run, trace=dict(t, device=None))) is None
    assert read("device_events_per_step", run) == 2.0
    assert read("host_syncs_per_step", run) == 1.0
    # 11 B/bin x 512 bins x 8 rows at 3.35 TB/s over 10 us
    assert read("tonal_walk_roofline", run) == pytest.approx(
        100 * 11 * 512 * 8 / 3.35e12 / 10e-6)
    b = breakdown(t)
    assert b["device_ops"][0] == ["gemm", pytest.approx(40e-6)]     # each call's own time
    gaps = dict(b["idle_gaps"])
    assert gaps == {"bench.dispatch / aten::_local_scalar_dense": pytest.approx(20e-6),
                    "bench.drain": pytest.approx(30e-6)}


def test_trace_readers_find_nothing_without_a_trace_or_a_kernel():
    run = timeline()
    for name in ("device_idle_pct", "device_events_per_step", "host_syncs_per_step",
                 "tonal_walk_roofline"):
        assert read(name, run) is None
    raw = raw_trace()
    raw["device"] = raw["device"][:3]
    assert read("tonal_walk_roofline", dict(run, trace=summarize(raw))) is None
