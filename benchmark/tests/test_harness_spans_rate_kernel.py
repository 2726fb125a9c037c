"""rate_kernel_aus.dabplus on a synthetic span list: the AUs counted on the
program's dabplus.rate.kernel spans per step, and no figure from a program
that keeps no such span (the eager loop's bisect/final/refine spans)."""
from types import SimpleNamespace

import pytest

from benchmark import registry

MS = 1_000_000          # ns


def span(name, start_ms, end_ms, parent=None, **counts):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts=counts)


def lc_step(t, kernel=True, n_au=6):
    """One DAB+ step from t ms: per AU psy 10 ms, then the rate loop as one
    kernel span of 1 ms (aus=1) or as the eager loop's three spans, a
    recovery check and a pack."""
    step = span("dabplus.step", t, t + 100 * n_au)
    out = []
    for a in range(n_au):
        t0 = t + 100 * a
        au = span("dabplus.au", t0, t0 + 100, step, a=a)
        out.append(span("dabplus.psy", t0, t0 + 10, au))
        if kernel:
            out.append(span("dabplus.rate.kernel", t0 + 10, t0 + 11, au, aus=1))
        else:
            out += [span("dabplus.rate.bisect", t0 + 10, t0 + 40, au),
                    span("dabplus.rate.final", t0 + 40, t0 + 45, au),
                    span("dabplus.rate.refine", t0 + 45, t0 + 65, au)]
        out += [span("dabplus.recover.sync", t0 + 65, t0 + 69, au),
                span("dabplus.aupack", t0 + 75, t0 + 83, au), au]
    return out + [step]


@pytest.fixture
def store(monkeypatch):
    """Hands the readers `kept` in place of the program's store."""
    from odr_audioenc_tpu_torch import obs
    kept = []
    monkeypatch.setattr(obs, "spans", lambda: list(kept))
    return kept


def read(name):
    return registry.module("metrics", name).read({"window": (0.0, 1.0), "trace": {}})


def test_rate_kernel_aus_counts_kernel_aus_per_step(store):
    store += lc_step(2000) + lc_step(3000)
    assert read("rate_kernel_aus.dabplus") == pytest.approx(6.0)
    # the kernel span is the rate loop's host time: 1 ms per AU
    assert read("rate_loop_ms.dabplus") == pytest.approx(6.0)


def test_rate_kernel_aus_left_out_for_the_eager_loop(store):
    store += lc_step(2000, kernel=False) + lc_step(3000, kernel=False)
    assert read("rate_kernel_aus.dabplus") is None
    assert read("rate_loop_ms.dabplus") == pytest.approx(6 * 55.0)
