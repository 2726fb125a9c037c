"""The readers of the program's spans (benchmark/spans.py and the metrics
that rest on it) on a synthetic span list."""
import sys
from types import SimpleNamespace

import pytest

from benchmark import registry, spans

MS = 1_000_000          # ns


def span(name, start_ms, end_ms, parent=None, **counts):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts=counts)


def mp2_step(t, passes):
    """One MP2 step from t ms: psy 10 ms, alloc 20 ms holding a tail of 15
    ms whose `passes` syncs take 1 ms each, an emit of 3 ms outside it."""
    step = span("mp2.step", t, t + 40)
    alloc = span("mp2.alloc", t + 12, t + 32, step)
    tail = span("mp2.alloc.tail", t + 15, t + 30, alloc, passes=passes)
    syncs = [span("mp2.tail.sync", t + 16 + 2 * i, t + 17 + 2 * i, tail) for i in range(passes)]
    return [span("mp2.polyphase", t, t + 2, step), span("mp2.psy", t + 2, t + 12, step),
            *syncs, tail, alloc, span("mp2.quantize", t + 32, t + 35, step), step,
            span("mp2.emit", t + 41, t + 44), span("io.upload", t - 2, t - 1)]


def lc_step(t):
    """One DAB+ step from t ms with two AUs: rate spans 30 + 5 + 20 ms per
    AU, a recovery check of 4 ms, a recount of 6 ms on the second AU, packs
    of 8 ms per AU and an assemble of 10 ms."""
    step = span("dabplus.step", t, t + 200)
    out = []
    for a in range(2):
        t0 = t + 10 + 90 * a
        au = span("dabplus.au", t0, t0 + 90, step, a=a)
        out += [span("dabplus.psy", t0, t0 + 10, au),
                span("dabplus.rate.bisect", t0 + 10, t0 + 40, au),
                span("dabplus.rate.final", t0 + 40, t0 + 45, au),
                span("dabplus.rate.refine", t0 + 45, t0 + 65, au),
                span("dabplus.recover.sync", t0 + 65, t0 + 69, au),
                span("dabplus.aupack", t0 + 75, t0 + 83, au)]
        if a == 1:
            out.append(span("dabplus.rate.recover", t0 + 69, t0 + 75, au))
        out.append(au)
    return out + [span("dabplus.assemble", t + 190, t + 200, step), step,
                  span("dabplus.slice", t + 210, t + 215)]


@pytest.fixture
def store(monkeypatch):
    """Hands the readers `kept` in place of the program's store."""
    from odr_audioenc_tpu_torch import obs
    kept = []
    monkeypatch.setattr(obs, "spans", lambda: list(kept))
    return kept


def read(name, window_end_s=1.0):
    return registry.module("metrics", name).read({"window": (0.0, window_end_s), "trace": {}})


def test_mp2_readers(store):
    store += mp2_step(2000, 3) + mp2_step(2100, 5)
    assert read("psy_ms.mp2") == pytest.approx(10.0)
    assert read("alloc_ms.mp2") == pytest.approx(20.0 - 4.0)       # less 8 syncs of 1 ms
    assert read("alloc_tail_passes.mp2") == pytest.approx(4.0)
    assert read("sync_wait_ms") == pytest.approx(4.0)
    assert read("rate_loop_ms.dabplus") is None and read("aupack_ms.dabplus") is None


def test_lc_readers(store):
    store += lc_step(2000) + lc_step(3000)
    assert read("rate_loop_ms.dabplus") == pytest.approx(2 * 55.0 + 6.0)
    assert read("aupack_ms.dabplus") == pytest.approx(2 * 8.0 + 10.0)
    assert read("sync_wait_ms") == pytest.approx(8.0)
    assert read("psy_ms.mp2") is None and read("alloc_tail_passes.mp2") is None


def test_syncs_inside_a_read_stage_are_taken_out():
    """A sync nested (at any depth) in a stage the reader sums is waiting,
    not the stage's own host time; one outside it is not subtracted."""
    step = span("dabplus.step", 0, 100)
    rate = span("dabplus.rate.bisect", 0, 50, step)
    inner = span("x.inner", 10, 30, rate)
    kept = [step, rate, inner, span("x.sync", 12, 20, inner), span("y.sync", 60, 70, step)]
    assert spans.ms_per_step(kept, lambda n: n.startswith("dabplus.rate.")) == \
        pytest.approx(42.0)
    assert spans.ms_per_step(kept, lambda n: n.endswith(".sync")) == pytest.approx(18.0)


def test_only_this_runs_spans_and_steps_count(store):
    """Spans that began before the window's end (another run in the same
    process) are not read, nor any in a run with no traced slice; without a
    top-level step there is no figure."""
    store += mp2_step(500, 9) + mp2_step(2000, 3)
    assert read("alloc_tail_passes.mp2") == pytest.approx(3.0)
    assert registry.module("metrics", "alloc_tail_passes.mp2").read(
        {"window": (0.0, 1.0), "trace": None}) is None
    assert read("alloc_tail_passes.mp2", window_end_s=3.0) is None
    nested = mp2_step(5000, 2)
    nested[-3].parent = span("outer", 4000, 6000)                  # mp2.step, not top-level
    store[:] = nested
    assert read("psy_ms.mp2") is None and read("sync_wait_ms") is None


def test_a_program_without_spans_gives_no_figure(monkeypatch):
    """A commit whose program has no obs module: every reader leaves its
    metric out, and none raises."""
    monkeypatch.setitem(sys.modules, "odr_audioenc_tpu_torch.obs", None)
    monkeypatch.delattr("odr_audioenc_tpu_torch.obs", raising=False)
    for name in ("rate_loop_ms.dabplus", "aupack_ms.dabplus", "psy_ms.mp2", "alloc_ms.mp2",
                 "alloc_tail_passes.mp2", "sync_wait_ms"):
        assert read(name) is None
