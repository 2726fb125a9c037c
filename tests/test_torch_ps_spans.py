"""The port's spans inside the HE-AAC v2 (PS) stage on the CPU, stereo 32
kbit/s at 48 kHz: each step's dabplus.ps holds the IID/ICC analysis
(dabplus.ps.iid) and the mono downmix (dabplus.ps.downmix) and counts its
AUs and PS envelopes; the PS extension's slot groups for the device pack are
dabplus.sbr.pack.ps inside dabplus.sbr.pack, once per step; the superframes'
bytes are the same with spans on and off; and no benchmark reader takes a PS
span but the two that read them."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import obs
from odr_audioenc_tpu_torch.dabplus import model as dmodel

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

S, SUPERFRAMES = 2, 3
PS_STAGES = ("dabplus.ps.iid", "dabplus.ps.downmix")
PS_NAMES = ("dabplus.ps",) + PS_STAGES + ("dabplus.sbr.pack.ps",)
# the readers of the PS spans, and the one span each reads
PS_READERS = {"ps_ms.dabplus": "dabplus.ps", "ps_pack_ms.dabplus": "dabplus.sbr.pack.ps"}


def encode(pack_on_device=True):
    """HE-AAC v2 stereo 32k (4 subchannel units, 3 AUs of 1920 samples) in
    float32: every superframe's bytes, each station from its own offset."""
    cfg = dmodel.DabPlusConfig(48000, 4, 2, aot="ps")
    enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device="cpu",
                                pack_on_device=pack_on_device)
    n = cfg.num_aus * cfg.au_samples
    sig = np.tile(music_like(10, seed=5), (1, 4))
    x = np.stack([sig[:, 997 * i:997 * i + SUPERFRAMES * n] for i in range(S)])
    state, out = enc.init_state(), []
    for t in range(SUPERFRAMES):
        state, o = enc.encode_superframes(state, x[..., t * n:(t + 1) * n], pack=False)
        out.append(enc.pack_superframes(o, add_rs=True))
    return out


_RUNS = {}


def run(mode):
    """("plain", bytes) with nothing recording; ("device" | "host", (bytes,
    spans)) under obs.enabled() with the device or the host pack; each made
    once per worker."""
    if mode not in _RUNS:
        if mode == "plain":
            _RUNS[mode] = encode()
        else:
            obs.clear()
            try:
                with obs.enabled():
                    got = encode(pack_on_device=mode == "device")
                _RUNS[mode] = (got, obs.spans())
            finally:
                obs.clear()
    return _RUNS[mode]


def ancestors(sp):
    p, out = sp.parent, []
    while p is not None:
        out.append(p.name)
        p = p.parent
    return out


def test_ps_stages_nest_in_dabplus_ps_with_its_counts():
    _, spans = run("device")
    steps = [sp for sp in spans if sp.name == "dabplus.step"]
    ps = [sp for sp in spans if sp.name == "dabplus.ps"]
    assert len(steps) == len(ps) == SUPERFRAMES
    assert all(sp.parent in steps for sp in ps)
    for outer in ps:
        assert outer.counts == {"aus": 3, "envelopes": 2}
        inner = sorted((sp for sp in spans if sp.parent is outer), key=lambda sp: sp.start_ns)
        assert [sp.name for sp in inner] == list(PS_STAGES)
        for sp in inner:
            assert outer.start_ns <= sp.start_ns <= sp.end_ns <= outer.end_ns
    assert sum(sp.name in PS_STAGES for sp in spans) == len(PS_STAGES) * SUPERFRAMES


def test_ps_pack_once_per_step_inside_sbr_pack():
    _, spans = run("device")
    packs = [sp for sp in spans if sp.name == "dabplus.sbr.pack"]
    ps_packs = [sp for sp in spans if sp.name == "dabplus.sbr.pack.ps"]
    assert len(packs) == len(ps_packs) == SUPERFRAMES
    assert sorted(id(sp.parent) for sp in ps_packs) == sorted(id(sp) for sp in packs)
    for sp in ps_packs:
        assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns <= sp.parent.end_ns
        assert "dabplus.aupack" not in ancestors(sp) and "dabplus.ps" not in ancestors(sp)


def test_no_ps_pack_span_with_the_host_pack():
    """The host-pack encoder builds no slot groups, so keeps no such span,
    and still records the PS stage."""
    _, spans = run("host")
    names = [sp.name for sp in spans]
    assert "dabplus.sbr.pack.ps" not in names and "dabplus.sbr.pack" not in names
    assert names.count("dabplus.ps") == names.count("dabplus.ps.iid") == SUPERFRAMES


def test_bytes_equal_with_spans_on_and_off():
    got, spans = run("device")
    assert spans and got == run("plain")
    assert all(len(b) == 4 * 120 for sf in got for b in sf)
    host, _ = run("host")
    assert host == got


def reader_matchers(monkeypatch):
    """{reader: match(name)} of every span reader under benchmark/metrics/,
    taken from the calls it makes into benchmark.spans."""
    from benchmark import registry, spans
    seen = {}
    monkeypatch.setattr(spans, "recorded", lambda run: [])
    monkeypatch.setattr(spans, "ms_per_step",
                        lambda sp, match: seen.setdefault("match", match))
    monkeypatch.setattr(spans, "count_per_step",
                        lambda sp, name, key: seen.setdefault("match", lambda n: n == name))
    out = {}
    for path in sorted((registry.ROOT / "metrics").glob("*.py")):
        mod = registry.module("metrics", path.stem)
        if getattr(mod, "spans", None) is not spans:
            continue                          # reads the trace or the clocks, not spans
        seen.clear()
        mod.read({"window": (0.0, 0.0), "trace": {}})
        out[path.stem] = seen["match"]
    return out


def test_only_the_ps_readers_take_the_ps_spans(monkeypatch):
    """Every span name the PS run records goes to the readers that read it
    before these spans existed, and the PS spans to their two readers
    alone: no name starts with dabplus.rate., ends in .sync, or is one of
    the SBR stage's or the device pack's."""
    matchers = reader_matchers(monkeypatch)
    assert set(PS_READERS) <= set(matchers) and len(matchers) > len(PS_READERS)
    names = {sp.name for sp in run("device")[1]} | {sp.name for sp in run("host")[1]}
    assert set(PS_NAMES) <= names
    for reader, match in matchers.items():
        took = {n for n in names if match(n)}
        if reader in PS_READERS:
            assert took == {PS_READERS[reader]}, reader
        else:
            assert not took & set(PS_NAMES), (reader, took)
