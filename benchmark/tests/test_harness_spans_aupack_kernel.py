"""aupack_kernel_aus.dabplus on a synthetic span list: the AUs counted on the
program's dabplus.aupack.kernel spans per step, and no figure from a program
that keeps no such span (the slot-grid pack's bare dabplus.aupack)."""
from types import SimpleNamespace

import pytest

from benchmark import registry

MS = 1_000_000          # ns


def span(name, start_ms, end_ms, parent=None, **counts):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts=counts)


def dab_step(t, kernel=True, n_au=6):
    """One DAB+ step from t ms: per AU psy and the rate kernel, a recovery
    check, then the AU pack, 8 ms as slot groups or 1 ms around the pack
    kernel's 0.5 ms span (aus=1); then the assembly."""
    step = span("dabplus.step", t, t + 100 * n_au + 10)
    out = []
    for a in range(n_au):
        t0 = t + 100 * a
        au = span("dabplus.au", t0, t0 + 100, step, a=a)
        out += [span("dabplus.psy", t0, t0 + 10, au),
                span("dabplus.rate.kernel", t0 + 10, t0 + 11, au, aus=1),
                span("dabplus.recover.sync", t0 + 65, t0 + 69, au)]
        if kernel:
            pack = span("dabplus.aupack", t0 + 75, t0 + 76, au)
            out += [span("dabplus.aupack.kernel", t0 + 75.25, t0 + 75.75, pack, aus=1), pack]
        else:
            out.append(span("dabplus.aupack", t0 + 75, t0 + 83, au))
        out.append(au)
    out.append(span("dabplus.assemble", t + 100 * n_au, t + 100 * n_au + 2, step))
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


@pytest.mark.parametrize("n_au", [6, 3], ids=["lc", "he"])
def test_aupack_kernel_aus_counts_kernel_aus_per_step(store, n_au):
    store += dab_step(2000, n_au=n_au) + dab_step(3000, n_au=n_au)
    assert read("aupack_kernel_aus.dabplus") == pytest.approx(float(n_au))
    # the pack's host time keeps its meaning: the dabplus.aupack spans (the
    # kernel span inside them is not counted twice) and the assembly
    assert read("aupack_ms.dabplus") == pytest.approx(n_au * 1.0 + 2.0)


def test_aupack_kernel_aus_left_out_for_the_slot_grid_pack(store):
    store += dab_step(2000, kernel=False) + dab_step(3000, kernel=False)
    assert read("aupack_kernel_aus.dabplus") is None
    assert read("aupack_ms.dabplus") == pytest.approx(6 * 8.0 + 2.0)
    assert read("rate_kernel_aus.dabplus") == pytest.approx(6.0)


def test_aupack_kernel_aus_left_out_without_a_traced_slice(store):
    store += dab_step(2000)
    assert registry.module("metrics", "aupack_kernel_aus.dabplus").read(
        {"window": (0.0, 1.0), "trace": None}) is None
