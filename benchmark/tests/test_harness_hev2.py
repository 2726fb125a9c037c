"""The HE-AAC v2 (PS) stereo 32k cell at a tiny size on the CPU: the
reference emits the port's bytes in float64, a sound run is correct and the
faults are not, and the two PS readers read the program's spans (on a
synthetic list, on the port's own spans, and nothing from a program without
them)."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import registry
from benchmark.faults import FAULTS
from benchmark.traffic.programme import Programme
from tiny import run_tiny, tiny_copy

CELL = "dabplus_hev2_32.music"
READERS = ("ps_ms.dabplus", "ps_pack_ms.dabplus")
MS = 1_000_000          # ns


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"), sizes={CELL: 4})


def test_hev2_reference_is_the_port_in_float64():
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig, DabPlusEncoder
    S, steps = 3, 4
    wl, cfg = registry.cell(CELL)
    wl = dict(wl, stations=S, programme=dict(wl["programme"], seconds=1.0))
    prog = Programme(wl, cfg["channels"], cfg["samples_per_step"], 2**31 + 99,
                     registry.module("traffic", "music").make, cfg["sample_rate"])
    ref = registry.module("reference", cfg["reference"])
    enc = DabPlusEncoder(DabPlusConfig(48000, 4, 2, aot="ps"), n_streams=S,
                         dtype=torch.float64, device="cpu", pack_on_device=True)
    state, got = enc.init_state(), {}
    for k in range(steps):
        state, out = enc.encode_superframes(state, prog.batch(k)[0], pack=False)
        got.update(((k, i), b) for i, b in enumerate(enc.pack_superframes(out, add_rs=True)))
    assert all(len(b) == 4 * 120 for b in got.values())
    keys = [(k, i) for k in (1, 3) for i in (0, 2)]
    want = ref.expected(cfg, wl, prog, keys, torch.device("cpu"))
    assert all(len(want[key]) == 4 * 120 for key in keys)
    assert [key for key in keys if got[key] != want[key]] == []


def test_a_sound_hev2_run_is_correct(root):
    line = run_tiny(root, CELL, seconds=2.0)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["compared"] >= 8
    assert set(line["metrics"]) == {"streams_x_rt", "setup_s"}


@pytest.mark.parametrize("fault", ["stale_state", "half_batch"])
def test_a_fault_in_the_hev2_cell_is_not_correct(root, fault):
    line = run_tiny(root, CELL, seconds=2.0, wrap=FAULTS[fault])
    assert not line["correct"], (fault, line["checks"])


def span(name, start_ms, end_ms, parent=None):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts={})


def ps_step(t, spanned=True):
    """One HE-AAC v2 step from t ms: dabplus.ps of 9 ms holding its two
    stages, dabplus.sbr of 12 ms, then dabplus.sbr.pack of 4 ms holding
    (with the span, as this program keeps it) the PS slot groups of 1.5 ms,
    then three AUs of 20 ms with a pack of 5 ms each.  Without `spanned`,
    as a program before the PS spans: dabplus.ps bare and no
    dabplus.sbr.pack.ps."""
    step = span("dabplus.step", t, t + 120)
    ps = span("dabplus.ps", t + 2, t + 11, step)
    out = [ps]
    if spanned:
        out = [span("dabplus.ps.iid", t + 2, t + 9, ps),
               span("dabplus.ps.downmix", t + 9, t + 11, ps), ps]
    out.append(span("dabplus.sbr", t + 12, t + 24, step))
    pack = span("dabplus.sbr.pack", t + 25, t + 29, step)
    if spanned:
        out.append(span("dabplus.sbr.pack.ps", t + 26, t + 27.5, pack))
    out.append(pack)
    for a in range(3):
        au = span("dabplus.au", t + 30 + 20 * a, t + 50 + 20 * a, step)
        out += [span("dabplus.aupack", t + 40 + 20 * a, t + 45 + 20 * a, au), au]
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


def test_ps_readers_on_synthetic_spans(store):
    store += ps_step(2000) + ps_step(3000)
    assert read("ps_ms.dabplus") == pytest.approx(9.0)
    assert read("ps_pack_ms.dabplus") == pytest.approx(1.5)
    # the PS spans move none of the readers that were there before them
    assert read("sbr_ms.dabplus") == pytest.approx(12.0)
    assert read("sbr_pack_ms.dabplus") == pytest.approx(4.0)
    assert read("aupack_ms.dabplus") == pytest.approx(15.0)
    assert read("rate_loop_ms.dabplus") is None and read("sync_wait_ms") is None


def test_ps_readers_leave_out_what_the_program_lacks(store):
    """A program that does not span the PS slot groups gives no
    ps_pack_ms.dabplus, and one without PS (HE-AAC v1, LC) no
    ps_ms.dabplus; a run with no traced slice gives neither."""
    store += ps_step(2000, spanned=False) + ps_step(3000, spanned=False)
    assert read("ps_pack_ms.dabplus") is None
    assert read("ps_ms.dabplus") == pytest.approx(9.0)
    store[:] = [s for s in store if s.name != "dabplus.ps"]
    assert all(read(n) is None for n in READERS)
    store[:] = ps_step(2000)
    assert all(registry.module("metrics", n).read({"window": (0.0, 1.0), "trace": None})
               is None for n in READERS)


def encode_spans(cfg, steps=2, S=2):
    """The spans a device-pack encoder of `cfg` records over `steps`
    superframes of silence, and the two readers' values."""
    from odr_audioenc_tpu_torch import obs
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusEncoder
    enc = DabPlusEncoder(cfg, n_streams=S, dtype=torch.float32, device="cpu",
                         pack_on_device=True)
    state = enc.init_state()
    pcm = torch.zeros(S, cfg.channels, cfg.num_aus * cfg.au_samples, dtype=torch.int16)
    obs.clear()
    try:
        with obs.enabled():
            for _ in range(steps):
                state, _ = enc.encode_superframes(state, pcm, pack=False)
        run = {"window": (0.0, 0.0), "trace": {}}
        got = {n: registry.module("metrics", n).read(run) for n in READERS}
        names = [s.name for s in obs.spans()]
    finally:
        obs.clear()
    return got, names


def test_ps_readers_on_the_ports_spans():
    """The readers find the spans the port records, one of each per step,
    and nothing in the HE-AAC v1 encoder, which has no PS stage."""
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig
    got, names = encode_spans(DabPlusConfig(48000, 4, 2, aot="ps"))
    assert all(v is not None and v > 0 for v in got.values()), got
    assert names.count("dabplus.ps") == names.count("dabplus.sbr.pack.ps") == 2
    got, names = encode_spans(DabPlusConfig(48000, 6, 1, aot="sbr"))
    assert got == {n: None for n in READERS}
    assert "dabplus.sbr" in names and "dabplus.psy" in names
    assert not any(n == "dabplus.ps" or n.startswith("dabplus.ps.") for n in names)
