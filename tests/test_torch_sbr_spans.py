"""The port's spans inside the HE-AAC (SBR) stage on the CPU, mono 48 kbit/s
at 48 kHz: each step's dabplus.sbr holds its four stages (QMF analysis,
envelope side data, FIL bit count, decimator), the SBR FIL element's slot
groups for the device pack are dabplus.sbr.pack once per step outside
dabplus.aupack, and the superframes' bytes are the same with spans on and
off."""
import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import obs
from odr_audioenc_tpu_torch.dabplus import model as dmodel

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

S, SUPERFRAMES = 2, 3
STAGES = ("dabplus.sbr.qmf", "dabplus.sbr.env", "dabplus.sbr.bits", "dabplus.sbr.decimate")


@pytest.fixture(autouse=True)
def empty_store():
    obs.clear()
    yield
    obs.clear()


def encode(pack_on_device=True):
    """HE-AAC mono 48k (6 subchannel units, 3 AUs of 1920 samples) in
    float32: every superframe's bytes, each station from its own offset."""
    cfg = dmodel.DabPlusConfig(48000, 6, 1, aot="sbr")
    enc = dmodel.DabPlusEncoder(cfg, S, dtype=torch.float32, device="cpu",
                                pack_on_device=pack_on_device)
    n = cfg.num_aus * cfg.au_samples
    sig = np.tile(music_like(10, seed=5)[:1], (1, 4))
    x = np.stack([sig[:, 997 * i:997 * i + SUPERFRAMES * n] for i in range(S)])
    state, out = enc.init_state(), []
    for t in range(SUPERFRAMES):
        state, o = enc.encode_superframes(state, x[..., t * n:(t + 1) * n], pack=False)
        out.append(enc.pack_superframes(o, add_rs=True))
    return out


_PLAIN = []


def plain():
    """The bytes with nothing recording, once per worker."""
    if not _PLAIN:
        _PLAIN.append(encode())
    return _PLAIN[0]


def recorded(pack_on_device=True):
    with obs.enabled():
        got = encode(pack_on_device)
    return got, obs.spans()


def ancestors(sp):
    p, out = sp.parent, []
    while p is not None:
        out.append(p.name)
        p = p.parent
    return out


def test_sbr_stages_nest_in_dabplus_sbr():
    _, spans = recorded()
    steps = [sp for sp in spans if sp.name == "dabplus.step"]
    sbr = [sp for sp in spans if sp.name == "dabplus.sbr"]
    assert len(steps) == len(sbr) == SUPERFRAMES
    assert all(sp.parent in steps for sp in sbr)
    for outer in sbr:
        inner = sorted((sp for sp in spans if sp.parent is outer), key=lambda sp: sp.start_ns)
        assert [sp.name for sp in inner] == list(STAGES)
        for sp in inner:
            assert outer.start_ns <= sp.start_ns <= sp.end_ns <= outer.end_ns
    assert sum(sp.name in STAGES for sp in spans) == len(STAGES) * SUPERFRAMES


def test_sbr_pack_once_per_step_outside_aupack():
    _, spans = recorded()
    packs = [sp for sp in spans if sp.name == "dabplus.sbr.pack"]
    steps = [sp for sp in spans if sp.name == "dabplus.step"]
    assert len(packs) == len(steps) == SUPERFRAMES
    assert sorted(id(sp.parent) for sp in packs) == sorted(id(sp) for sp in steps)
    assert all("dabplus.aupack" not in ancestors(sp) for sp in packs)
    assert all("dabplus.sbr" not in ancestors(sp) for sp in packs)


def test_no_sbr_pack_span_with_the_host_pack():
    """The host-pack encoder builds no slot groups, so keeps no such span,
    and still records the SBR stage."""
    _, spans = recorded(pack_on_device=False)
    names = [sp.name for sp in spans]
    assert "dabplus.sbr.pack" not in names
    assert names.count("dabplus.sbr") == SUPERFRAMES


def test_bytes_equal_with_spans_on_and_off():
    got, spans = recorded()
    assert spans and got == plain()
    assert all(len(b) == 6 * 120 for sf in got for b in sf)
