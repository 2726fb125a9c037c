"""The port's own copies of the JAX package's numpy/C++ layer against the
originals: every public table of `tables.py` and `dabplus/tables.py`, the
MP2 packer (native and Python paths, from a golden's steps), the DAB+
superframe packer (native and Python), the RS code and the validators, and
the native build, which raises when it fails."""
import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch

from odr_audioenc_tpu import tables as JT
from odr_audioenc_tpu.dabplus import tables as JAT
from odr_audioenc_tpu.fec import rs as jrs
from odr_audioenc_tpu.host import aacpack as jaacpack, dabplus_parse as jdparse
from odr_audioenc_tpu.host import mp2parse as jmp2parse
from odr_audioenc_tpu.host.mp2pack import Mp2Packer as JMp2Packer
from odr_audioenc_tpu.host import native as jnative
from odr_audioenc_tpu_torch import convert, tables as TT
from odr_audioenc_tpu_torch.dabplus import model as tdm, tables as TAT
from odr_audioenc_tpu_torch.fec import rs as trs
from odr_audioenc_tpu_torch.host import dabplus_parse as tdparse, mp2parse as tmp2parse
from odr_audioenc_tpu_torch.host import native as tnative
from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer as TMp2Packer
from odr_audioenc_tpu_torch.mp2 import model as tmodel

import gen_golden
from signals import music_like

_RATES = (16000, 22050, 24000, 32000, 44100, 48000)
# example arguments for every public function of the two tables modules
_CALLS = {
    "dct_matrix": [()],
    "make_map": [(r,) for r in range(7)],
    "psy0_ath_min": [(r,) for r in _RATES],
    "ath_db": [(np.linspace(10.0, 24000.0, 97),)],
    "bark": [(np.linspace(0.0, 24000.0, 97),)],
    "fdk_bark": [(np.linspace(0.0, 24000.0, 97),)],
    "band_matrix": [(r,) for r in _RATES],
    "band_of_line": [(r,) for r in _RATES],
    "band_psy_tables": [(r,) for r in _RATES],
    "long_cos_basis": [(), (np.float32,)],
    "mdct_matrix": [(), (256,)],
    "min_snr_ladder": [(b, r, s) for r in (24000, 32000, 48000) for b in (12000, 48000)
                       for s in (False, True)],
    "sfb_offsets": [(r,) for r in _RATES],
    "sfb_short_offsets": [(r,) for r in _RATES],
    "short_band_count": [(r,) for r in _RATES],
    "short_band_matrix": [(r,) for r in _RATES],
    "short_band_of_line": [(r,) for r in _RATES],
    "short_band_psy_tables": [(r,) for r in _RATES],
    "short_cos_basis": [(), (np.float32,)],
    "spread_energy_tables": [(r, b, s) for r in (24000, 48000) for b in (16000, 48000)
                             for s in (False, True)],
    "window_vectors": [(), (np.float32,)],
}


def _public(mod):
    return sorted(k for k, v in vars(mod).items() if not k.startswith("_")
                  and not isinstance(v, (types.ModuleType, type)))


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif a is None or isinstance(a, (bool, int, float, str, bytes)):
        assert type(a) is type(b) and a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("mods,name",
                         [((JT, TT), n) for n in _public(JT)] +
                         [((JAT, TAT), n) for n in _public(JAT)],
                         ids=lambda x: x if isinstance(x, str) else x[1].__name__.split(".", 1)[1])
def test_copied_table_equals_original(mods, name):
    """Each public name of the port's tables modules equals the JAX
    package's: arrays and scalars as they are, functions over the example
    arguments of _CALLS (every public function must have some)."""
    orig, copy = (getattr(m, name) for m in mods)
    assert _public(mods[0]) == _public(mods[1])
    if callable(orig):
        assert name in _CALLS, f"no example arguments for {name}"
        for args in _CALLS[name]:
            _assert_same(orig(*args), copy(*args), f"{name}{args}")
    else:
        _assert_same(orig, copy, name)


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library as the oracle, built privately: its
    own `get_lib()` rebuilds `native/libodrhost.so` in place whenever the
    file is missing or older than its sources, and parallel test workers
    that do so at once can load a half-written file and get None.  This
    compiles the same sources with the flags of its `native/build.sh` into
    a directory of this module's own, loads it as `get_lib()` does, and
    hands it to `jnative` for the module's tests."""
    src = jnative._DIR
    so = tmp_path_factory.mktemp("jax_native") / "libodrhost.so"
    res = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-fopenmp", "-o", str(so),
                          "mp2pack.cpp", "dabpack.cpp"], cwd=src, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.mp2_pack_batch.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnative, "_LIB", lib)
        m.setattr(jnative, "_TRIED", True)
        yield lib


# ---- MP2: the packers from a golden's steps ------------------------------------

# two 48 kHz goldens of 30 frames in one batch: X-PAD 16 joint stereo, and 192k stereo
_GOLDENS = ("music_48s_128_j_psy1_xpad16", "music_48s_192_s_psy1")
_MP2 = {}


def _mp2_steps(pack_on_device):
    """The port's f64 outputs (numpy) of every step of both goldens in one
    batch, with each step's X-PAD; cached per pack mode."""
    if pack_on_device not in _MP2:
        inputs = [gen_golden.make_input(n) for n in _GOLDENS]
        streams = []
        for n in _GOLDENS:
            _, _, rate, bitrate, mode, _, xpad_len = gen_golden.CONFIGS[n]
            streams.append({"rate": rate, "bitrate": bitrate, "mode": mode,
                            "pad_len": xpad_len})
        cfg = tmodel.make_config(streams)
        enc = tmodel.Mp2Encoder(cfg, psy_model=1, dtype=torch.float64, device="cpu",
                                pack_on_device=pack_on_device)
        pad_len = np.array([s["pad_len"] for s in streams], np.int32)
        state, steps = enc.init_state(), []
        for fi in range(len(inputs[0][0])):
            pcm = np.stack([frames[fi] for frames, _ in inputs])
            xp = [x[fi] if x else None for _, x in inputs]
            xbuf = None
            if pack_on_device == "frame":    # the frame pack takes X-PAD on the device
                xbuf = np.zeros((len(xp), int(pad_len.max())), np.uint8)
                for i, x in enumerate(xp):
                    xbuf[i, :len(x or b"")] = np.frombuffer(x or b"", np.uint8)
            state, out = enc.encode_step(state, pcm, pad_len, xbuf)
            steps.append((convert.to_numpy(out), xp))
        _MP2[pack_on_device] = (cfg, steps)
    return _MP2[pack_on_device]


def _pack_mp2(packer_cls, cfg, steps, use_native):
    packer = packer_cls(cfg)
    per_stream = [[] for _ in _GOLDENS]
    for out, xp in steps:
        for i, b in enumerate(packer.emit(out, xp, use_native=use_native)):
            per_stream[i].append(b)
    for i, b in enumerate(packer.finish()):
        per_stream[i].append(b)
    return [b"".join(chunks) for chunks in per_stream]


@pytest.mark.parametrize("pack_on_device,use_native", [(False, True), (False, False),
                                                       ("frame", True)])
def test_mp2_packer_equals_jax_and_golden(pack_on_device, use_native, jax_native_lib):
    """The port's Mp2Packer gives the JAX package's bytes, which are the
    goldens' bytes, on the native path, on the Python path, and from the
    device-packed frames ("wire")."""
    assert jnative.get_lib() is jax_native_lib
    cfg, steps = _mp2_steps(pack_on_device)
    got = _pack_mp2(TMp2Packer, cfg, steps, use_native)
    ref = _pack_mp2(JMp2Packer, cfg, steps, use_native)
    assert got == ref
    for name, b in zip(_GOLDENS, got):
        assert b == (gen_golden.GOLDEN / f"{name}.mp2").read_bytes(), name


def _verdict(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:          # a flipped byte may make a frame unparsable
        return type(e).__name__


def test_mp2parse_verdicts_equal_jax():
    """parse_frame and split_frames of the port and of the JAX package agree
    on valid frames and on frames with one flipped byte (CRC failures and
    unparsable headers alike)."""
    cfg, steps = _mp2_steps("frame")
    stream = _pack_mp2(TMp2Packer, cfg, steps, True)[0]
    frames = tmp2parse.split_frames(stream)
    _assert_same(frames, jmp2parse.split_frames(stream))
    rng = np.random.default_rng(0)
    crc_bad = 0
    for f in frames[:12]:
        bad = bytearray(f)
        bad[int(rng.integers(0, 40))] ^= 1 << int(rng.integers(0, 8))
        for buf in (f, bytes(bad)):
            a, b = _verdict(tmp2parse.parse_frame, buf), _verdict(jmp2parse.parse_frame, buf)
            _assert_same(a, b)
            crc_bad += buf is not f and isinstance(a, dict) and not a["crc_ok"]
        assert tmp2parse.parse_frame(f)["crc_ok"]
    assert crc_bad > 0


# ---- DAB+: the superframe packers, RS and the validator -------------------------

_DAB = {}


def _dab_outputs():
    """Two superframes of the port's f64 AAC-LC encoder (48 kHz stereo 64k,
    X-PAD up to 16 bytes per AU) for two streams, with the pads."""
    if not _DAB:
        cfg = tdm.DabPlusConfig(48000, 8, 2, pad_len=16)
        enc = tdm.DabPlusEncoder(cfg, 2, dtype=torch.float64, device="cpu")
        sig = music_like(20)                                # [2, 20 * 1152]
        rng = np.random.default_rng(1)
        state, outs = enc.init_state(), []
        for t in range(2):
            pcm = np.stack([sig[:, t * 5760:(t + 1) * 5760], sig[:, 9000 + t * 5760:
                                                                  9000 + (t + 1) * 5760]])
            state, out = enc.encode_superframes(state, pcm, pack=False)
            pads = [[rng.integers(0, 256, int(rng.integers(0, 17)), dtype=np.uint8).tobytes()
                     for _ in range(cfg.num_aus)] for _ in range(2)]
            outs.append((out, pads))
        _DAB["enc"], _DAB["outs"] = enc, outs
    return _DAB["enc"], _DAB["outs"]


def _jax_python_pack(enc, out, pads, add_rs, monkeypatch):
    """The JAX package's Python AU writer and SuperframePacker, driven by the
    port encoder's pack loop."""
    with monkeypatch.context() as m:
        m.setattr(tdm, "write_au", jaacpack.write_au)
        m.setattr(tdm, "write_dse", jaacpack.write_dse)
        m.setattr(enc, "packer", jaacpack.SuperframePacker(enc.cfg.subch, enc.cfg.sample_rate,
                                                           enc.core_channels))
        return enc.pack_superframes(out, add_rs=add_rs, pads=pads, use_native=False)


@pytest.mark.parametrize("use_native,add_rs,with_pads", [(True, True, True), (True, False, False),
                                                         (False, True, True),
                                                         (False, False, False)])
def test_superframe_packer_equals_jax(use_native, add_rs, with_pads, monkeypatch,
                                      jax_native_lib):
    """The port's dabplus_pack_batch (native) and its SuperframePacker with
    the Python AU writer give the JAX package's superframes; with RS every
    one validates.  The native oracle is the module's private build of the
    JAX package's library, and it must be there: None fails, loudly."""
    assert jnative.get_lib() is jax_native_lib
    enc, outs = _dab_outputs()
    for out, pads in outs:
        pads = pads if with_pads else None
        got = enc.pack_superframes(out, add_rs=add_rs, pads=pads, use_native=use_native)
        if use_native:
            ref = jnative.dabplus_pack_batch(enc, convert.to_numpy(out), pads, add_rs)
            assert ref is not None, "the JAX native oracle is unavailable"
        else:
            ref = _jax_python_pack(enc, out, pads, add_rs, monkeypatch)
        assert got == ref
        assert all(len(f) == enc.cfg.subch * (120 if add_rs else 110) for f in got)
        if add_rs:
            assert all(tdparse.validate_superframe(f)[0] for f in got)


def test_rs_and_validator_agree_with_jax():
    """superframe_add_rs of the port equals the JAX package's; the RS check,
    parse_superframe and validate_superframe give the same verdicts on valid
    superframes and on superframes with one flipped byte."""
    enc, outs = _dab_outputs()
    core = [f for out, _ in outs for f in enc.pack_superframes(out, add_rs=False)]
    arr = np.stack([np.frombuffer(f, np.uint8) for f in core])
    coded = trs.superframe_add_rs(arr)
    np.testing.assert_array_equal(coded, jrs.superframe_add_rs(arr))
    rng = np.random.default_rng(2)
    bad_seen = 0
    for row in coded:
        bad = row.copy()
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        for x in (row, bad):
            ok = trs.superframe_check_rs(x)
            _assert_same(ok, jrs.superframe_check_rs(x))
            _assert_same(_verdict(tdparse.validate_superframe, x.tobytes()),
                         _verdict(jdparse.validate_superframe, x.tobytes()))
            n = len(x) // 120 * 110
            _assert_same(_verdict(tdparse.parse_superframe, x[:n].tobytes()),
                         _verdict(jdparse.parse_superframe, x[:n].tobytes()))
            bad_seen += x is bad and not bool(ok)
        assert tdparse.validate_superframe(row.tobytes())[0]
    assert bad_seen == len(coded)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A native build that fails raises with the compiler's report; nothing
    hands the caller the Python packer instead."""
    monkeypatch.setattr(tnative, "CXX", "false")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="native host library"):
        tnative.get_lib()
    cfg, steps = _mp2_steps(False)
    with pytest.raises(RuntimeError, match="native host library"):
        TMp2Packer(cfg).emit(*steps[0])
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-odr")
    with pytest.raises(RuntimeError, match="cannot run"):
        tnative.get_lib()


def test_native_library_keyed_by_sources(tmp_path, monkeypatch):
    """The library's name is the hash of native/'s sources and the flags:
    stable for the same sources, another for an edited header or flags,
    and it lies in the git-ignored kernels/build/."""
    first = tnative.library_path()
    assert first.parent == tnative.BUILD_DIR and first.name.startswith("libodrhost-")
    assert tnative.library_path() == first
    monkeypatch.setattr(tnative, "FLAGS", tnative.FLAGS + ["-g"])
    assert tnative.library_path() != first
    monkeypatch.undo()
    for f in tnative.SOURCES + tnative.HEADERS:
        (tmp_path / f).write_bytes((tnative.SRC_DIR / f).read_bytes())
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    assert tnative.library_path() == first
    with open(tmp_path / "aac_tables.h", "a") as fh:
        fh.write("// edited\n")
    assert tnative.library_path() != first
