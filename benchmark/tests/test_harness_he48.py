"""The HE-AAC (SBR) mono 48k cell at a tiny size on the CPU: the reference
emits the port's bytes in float64, a sound run is correct and the faults
are not, and the two SBR readers read the program's spans (on a synthetic
list, on the port's own spans, and nothing from a program without them)."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import registry
from benchmark.faults import FAULTS
from benchmark.traffic.programme import Programme
from tiny import run_tiny, tiny_copy

CELL = "dabplus_he48.music"
MS = 1_000_000          # ns


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"), sizes={CELL: 4})


def test_he48_reference_is_the_port_in_float64():
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig, DabPlusEncoder
    S, steps = 3, 4
    wl, cfg = registry.cell(CELL)
    wl = dict(wl, stations=S, programme=dict(wl["programme"], seconds=1.0))
    prog = Programme(wl, cfg["channels"], cfg["samples_per_step"], 2**31 + 99,
                     registry.module("traffic", "music").make, cfg["sample_rate"])
    ref = registry.module("reference", cfg["reference"])
    enc = DabPlusEncoder(DabPlusConfig(48000, 6, 1, aot="sbr"), n_streams=S,
                         dtype=torch.float64, device="cpu", pack_on_device=True)
    state, got = enc.init_state(), {}
    for k in range(steps):
        state, out = enc.encode_superframes(state, prog.batch(k)[0], pack=False)
        got.update(((k, i), b) for i, b in enumerate(enc.pack_superframes(out, add_rs=True)))
    keys = [(k, i) for k in (1, 3) for i in (0, 2)]
    want = ref.expected(cfg, wl, prog, keys, torch.device("cpu"))
    assert all(len(want[key]) == 6 * 120 for key in keys)
    assert [key for key in keys if got[key] != want[key]] == []


def test_a_sound_he48_run_is_correct(root):
    line = run_tiny(root, CELL, seconds=2.0)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["compared"] >= 8
    assert set(line["metrics"]) == {"streams_x_rt", "setup_s"}


@pytest.mark.parametrize("fault", ["stale_state", "half_batch"])
def test_a_fault_in_the_he48_cell_is_not_correct(root, fault):
    line = run_tiny(root, CELL, seconds=2.0, wrap=FAULTS[fault])
    assert not line["correct"], (fault, line["checks"])


def span(name, start_ms, end_ms, parent=None):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts={})


def he_step(t, pack=True):
    """One HE-AAC step from t ms: dabplus.sbr of 12 ms holding its four
    stages, then (with the span, as this program keeps it) the slot groups
    of 3 ms, then three AUs of 20 ms with a pack of 5 ms each."""
    step = span("dabplus.step", t, t + 100)
    sbr = span("dabplus.sbr", t + 2, t + 14, step)
    out = [span("dabplus.sbr.qmf", t + 2, t + 4, sbr),
           span("dabplus.sbr.env", t + 4, t + 10, sbr),
           span("dabplus.sbr.bits", t + 10, t + 12, sbr),
           span("dabplus.sbr.decimate", t + 12, t + 14, sbr), sbr]
    if pack:
        out.append(span("dabplus.sbr.pack", t + 15, t + 18, step))
    for a in range(3):
        au = span("dabplus.au", t + 20 + 20 * a, t + 40 + 20 * a, step)
        out += [span("dabplus.aupack", t + 30 + 20 * a, t + 35 + 20 * a, au), au]
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


def test_sbr_readers_on_synthetic_spans(store):
    store += he_step(2000) + he_step(3000)
    assert read("sbr_ms.dabplus") == pytest.approx(12.0)
    assert read("sbr_pack_ms.dabplus") == pytest.approx(3.0)
    # the slot groups are not the device pack's AU spans
    assert read("aupack_ms.dabplus") == pytest.approx(15.0)


def test_sbr_readers_leave_out_what_the_program_lacks(store):
    """A program that does not span the slot groups gives no
    sbr_pack_ms.dabplus, and one without SBR (LC) no sbr_ms.dabplus."""
    store += he_step(2000, pack=False) + he_step(3000, pack=False)
    assert read("sbr_pack_ms.dabplus") is None
    assert read("sbr_ms.dabplus") == pytest.approx(12.0)
    store[:] = [s for s in store if not s.name.startswith("dabplus.sbr")]
    assert read("sbr_ms.dabplus") is None and read("sbr_pack_ms.dabplus") is None


def test_sbr_readers_on_the_ports_spans():
    """The readers find the spans the port records, one of each per step."""
    from odr_audioenc_tpu_torch import obs
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig, DabPlusEncoder
    enc = DabPlusEncoder(DabPlusConfig(48000, 6, 1, aot="sbr"), n_streams=2,
                         dtype=torch.float32, device="cpu", pack_on_device=True)
    state = enc.init_state()
    pcm = torch.zeros(2, 1, 5760, dtype=torch.int16)
    obs.clear()
    try:
        with obs.enabled():
            for _ in range(2):
                state, _ = enc.encode_superframes(state, pcm, pack=False)
        run = {"window": (0.0, 0.0), "trace": {}}
        got = {n: registry.module("metrics", n).read(run)
               for n in ("sbr_ms.dabplus", "sbr_pack_ms.dabplus")}
        names = [s.name for s in obs.spans()]
    finally:
        obs.clear()
    assert all(v is not None and v > 0 for v in got.values()), got
    assert names.count("dabplus.sbr") == names.count("dabplus.sbr.pack") == 2
