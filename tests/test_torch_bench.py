"""The port's full-path bench (odr_audioenc_tpu_torch/bench.py) against the
root bench.py, which drives the JAX package, on the CPU and one torch
thread: the one-step-deep pipeline makes the JAX bench's sequence of
dispatches and drains over the same timed window; fleet_64's 64 station
specs and audio are the JAX bench's; the device cells' PCM is the JAX
bench's draws; and each device cell's last drained bytes are valid and
equal to its encoder run directly for the same steps.  Every comparison is
exact."""
import importlib.util
import tempfile
import types
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import bench, convert, fleet
from odr_audioenc_tpu_torch.dabplus import model as dmodel
from odr_audioenc_tpu_torch.fec.rs import superframe_check_rs
from odr_audioenc_tpu_torch.host import dabplus_parse, mp2parse
from odr_audioenc_tpu_torch.host.aacpack import firecode_crc
from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
from odr_audioenc_tpu_torch.mp2 import model

from torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
S = 2


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py (it imports only numpy at its top)."""
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JaxOut:
    """A device array of step k that records its copy_to_host_async."""

    def __init__(self, k, log):
        self.k, self.log = k, log

    def copy_to_host_async(self):
        self.log.append(("prefetch", self.k))


def _clock(log):
    """perf_counter of a fake clock that counts the dispatches so far."""
    return types.SimpleNamespace(perf_counter=lambda: float(sum(e[0] == "dispatch" for e in log)))


@pytest.mark.parametrize("iters", [1, 3])
def test_pipeline_makes_the_jax_bench_calls(iters, jax_bench, monkeypatch):
    """Dispatches, prefetches and drains in the JAX bench's order, each
    drain taking the outputs of the dispatch it follows in JAX; the port's
    one extra prefetch is the warm step's, whose drain JAX copies itself.
    Under a clock that ticks once per dispatch both rates are streams x
    audio_s: the timed window holds the same `iters` dispatches."""
    jlog, plog = [], []

    def jdispatch():
        k = sum(e[0] == "dispatch" for e in jlog)
        jlog.append(("dispatch", k))
        return {"wire": _JaxOut(k, jlog)}

    def pdispatch():
        k = sum(e[0] == "dispatch" for e in plog)
        plog.append(("dispatch", k))
        return {"wire": torch.full((S, 3), k, dtype=torch.uint8)}

    def pdrain(out):
        assert isinstance(out["wire"], np.ndarray)
        plog.append(("drain", int(out["wire"][0, 0])))

    download = fleet._Transfers.download

    def logged(self, out):
        plog.append(("prefetch", int(out["wire"][0, 0])))
        return download(self, out)

    monkeypatch.setattr(jax_bench, "time", _clock(jlog))
    monkeypatch.setattr(bench, "time", _clock(plog))
    monkeypatch.setattr(fleet._Transfers, "download", logged)
    j_rate = jax_bench._full_path_throughput(
        jdispatch, lambda out: jlog.append(("drain", out["wire"].k)), 0.5, 4, iters)
    p_rate = bench._full_path_throughput(pdispatch, pdrain, 0.5, 4, iters)
    assert plog.index(("prefetch", 0)) == 1
    assert plog[:1] + plog[2:] == jlog
    assert sum(e[0] == "dispatch" for e in jlog) == iters + 2
    assert j_rate == p_rate == 4 * 0.5


class _Captured(Exception):
    pass


def _capture(into):
    """A run_fleet that keeps its conf and each input's frames, then stops."""
    def run_fleet(conf, *args, **kwargs):
        audio = {}
        for spec in conf["streams"]:
            with wave.open(spec["input"], "rb") as w:
                audio[Path(spec["input"]).name] = (w.getnchannels(), w.getframerate(),
                                                   w.readframes(w.getnframes()))
        into.update(conf=conf, audio=audio)
        raise _Captured
    return run_fleet


def _by_basename(conf):
    return [{k: Path(v).name if k in ("input", "output", "stats") else v for k, v in s.items()}
            for s in conf["streams"]]


def test_fleet_specs_and_audio_are_the_jax_benchs(jax_bench, monkeypatch, tmp_path):
    """fleet64_rate hands run_fleet the JAX bench's 64 station specs (paths
    compared by basename) and the same stereo and mono 30 s WAVs."""
    import odr_audioenc_tpu.fleet as jfleet
    jax_run, port_run = {}, {}
    monkeypatch.setattr(jfleet, "run_fleet", _capture(jax_run))
    monkeypatch.setattr(fleet, "run_fleet", _capture(port_run))
    with monkeypatch.context() as m:            # the JAX bench leaves its mkdtemp behind
        m.setattr(tempfile, "mkdtemp", lambda prefix=None: str(tmp_path))
        with pytest.raises(_Captured):
            jax_bench._fleet64_rate()
    with pytest.raises(_Captured):
        bench.fleet64_rate()
    assert len(port_run["conf"]["streams"]) == 64
    assert _by_basename(port_run["conf"]) == _by_basename(jax_run["conf"])
    assert port_run["audio"] == jax_run["audio"]
    assert {k: v[:2] for k, v in port_run["audio"].items()} == {"in.wav": (2, 48000),
                                                               "in_mono.wav": (1, 48000)}
    assert all(len(v[2]) == 30 * 48000 * 2 * v[0] for v in port_run["audio"].values())


def test_cell_inputs_are_the_jax_benchs_draws():
    """The device cells' PCM: one default_rng(0), drawn in the JAX bench's
    order (MP2, then LC, SBR, PS) and cast to int16 as jnp.asarray does."""
    import jax.numpy as jnp
    got = bench.cell_inputs(3, "cpu")
    rng = np.random.default_rng(0)
    want = [rng.integers(-16000, 16000, shape) for shape in
            ((3, 2, 1152), (3, 2, 5760), (3, 1, 5760), (3, 2, 5760))]
    assert list(got) == ["mp2_128", "lc_96", "sbr_48", "ps_32"]
    for t, w in zip(got.values(), want):
        assert t.dtype == torch.int16 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(jnp.asarray(w, jnp.int16)))


def test_mp2_cell_equals_the_encoder_run_directly():
    """mp2_128 at S=2, iters=1: three steps; the last drain's frames are
    CRC-valid and those of Mp2Encoder + Mp2Packer run directly."""
    pcm = bench.cell_inputs(S, "cpu")["mp2_128"]
    rate = bench.mp2_128_rate(pcm, 1)
    cell = bench.last_cells["mp2_128"]
    assert np.isfinite(rate) and rate > 0 and cell["rate"] == rate
    assert (cell["steps"], cell["S"], cell["device"]) == (3, S, "cpu")
    assert cell["leaves"] == ["wire"] and cell["launches"] == (0, 0)
    cfg = model.make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}] * S)
    enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device="cpu",
                           pack_on_device="frame")
    packer, state = Mp2Packer(cfg), enc.init_state()
    for _ in range(3):
        state, out = enc.encode_step(state, pcm.numpy())
        last = packer.emit(convert.to_numpy(out))
    assert cell["last"] == last
    assert all(len(f) == 384 and mp2parse.parse_frame(f)["crc_ok"] for f in last)


@pytest.mark.parametrize("name", list(bench.DABPLUS_CELLS))
def test_dabplus_cell_equals_the_encoder_run_directly(name):
    """Each DAB+ cell at S=2, iters=1: the step's one output is the wire
    leaf; the last drain's superframes pass RS, the firecode and every AU
    CRC and are those of the device-pack encoder run directly."""
    subch, ch, aot = bench.DABPLUS_CELLS[name]
    pcm = bench.cell_inputs(S, "cpu")[name]
    rate = bench.dabplus_rate(name, pcm, 1)
    cell = bench.last_cells[name]
    cfg = dmodel.DabPlusConfig(48000, subch, ch, aot=aot)
    assert np.isfinite(rate) and rate > 0 and cell["rate"] == rate
    assert (cell["steps"], cell["S"], cell["launches"]) == (3, S, (0, 0))
    assert cell["leaves"] == ["wire"]
    assert cell["d2h_bytes"] == S * (120 * subch + 4 * cfg.num_aus)
    enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device="cpu", pack_on_device=True)
    state = enc.init_state()
    for _ in range(3):
        state, frames = enc.encode_superframes(state, pcm.numpy())
    assert cell["last"] == frames
    for f in frames:
        assert len(f) == 120 * subch
        assert superframe_check_rs(np.frombuffer(f, np.uint8))
        assert firecode_crc(f[2:11]) == (f[0] << 8 | f[1])
        assert dabplus_parse.validate_superframe(f)[0]


def test_headline_is_the_harmonic_mean():
    """The JSON line: the JAX bench's keys, the harmonic mean of the five
    rates, vs_baseline over 1024 x 10, the platform and card named."""
    rates = {"mp2_128": 900.0, "lc_96": 150.0, "sbr_48": 400.0, "ps_32": 380.0, "fleet_64": 2.5}
    card = "NVIDIA H100 80GB HBM3; NVIDIA H100 80GB HBM3, 700.00 W"
    line = bench.headline(rates, 2048, torch.device("cuda"), card)
    mixed = 5 / sum(1 / r for r in rates.values())
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["value"] == round(mixed, 1) and line["unit"] == "streams*x"
    assert line["vs_baseline"] == round(mixed / 10240, 4)
    assert f"cuda {card}" in line["metric"] and "S=2048" in line["metric"]
    assert "fleet_64=2.5" in line["metric"]
