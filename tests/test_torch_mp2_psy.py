"""The port's MP2 encoder with psy models 0, 2, 3, 4 and -1 end to end: the
goldens of models 0, 2 and 3 byte-exact in f64, models 4 and -1 through the
encoder and the packer as the JAX encoder runs them, and the psy-2 state
carried across JAX and the port.  JAX runs on the CPU with x64
(conftest.py); inputs are numpy."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.host import mp2parse
from odr_audioenc_tpu.host.mp2pack import Mp2Packer
from odr_audioenc_tpu.mp2 import model as jmodel
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.mp2 import model as tmodel

import gen_golden
from torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
OTHER_GOLDENS = [n for n, c in gen_golden.CONFIGS.items() if c[5] != 1]
STREAM = [{"rate": 48000, "bitrate": 128, "mode": "j"}]


def test_the_goldens_of_other_models_are_five():
    assert sorted(OTHER_GOLDENS) == ["music_48s_128_j_psy0", "music_48s_128_j_psy2",
                                     "music_48s_128_j_psy3", "tones_48s_192_s_psy2",
                                     "tones_48s_192_s_psy3"]


@pytest.mark.parametrize("name", OTHER_GOLDENS)
def test_golden_byte_exact(name):
    """The f64 path + the shared host packer reproduce toolame's stream
    byte for byte for psy models 0, 2 and 3 (no tolerance)."""
    _, _, rate, bitrate, mode, psy, xpad_len = gen_golden.CONFIGS[name]
    frames, _ = gen_golden.make_input(name)
    cfg = tmodel.make_config([{"rate": rate, "bitrate": bitrate, "mode": mode}])
    enc = tmodel.Mp2Encoder(cfg, psy_model=psy, dtype=torch.float64, device="cpu")
    packer = Mp2Packer(cfg)
    state, chunks = enc.init_state(), []
    for f in frames:
        state, out = enc.encode_step(state, f[None])
        chunks += packer.emit(convert.to_numpy(out))
    got = b"".join(chunks + packer.finish())
    want = (GOLDEN / f"{name}.mp2").read_bytes()
    bad = [i for i, (a, b) in enumerate(zip(mp2parse.split_frames(got),
                                            mp2parse.split_frames(want))) if a != b]
    assert got == want, f"{name}: frames {bad[:5]} differ"


def _random_pcm(n, seed=0):
    return np.random.default_rng(seed).integers(-9000, 9000, (n, 1, 2, 1152)).astype(np.int16)


@pytest.mark.parametrize("model", [-1, 4])
def test_null_and_psy4_encode_like_jax(model):
    """The twin of test_psy4.py's end-to-end case: three frames of random
    PCM through the encoder and the packer give three 384-byte frames with
    the sync word, and in f64 the same bytes as the JAX encoder."""
    pcm = _random_pcm(3)
    cfg = tmodel.make_config(STREAM)
    jenc = jmodel.Mp2Encoder(jmodel.make_config(STREAM), psy_model=model, dtype=jnp.float64)
    tenc = tmodel.Mp2Encoder(cfg, psy_model=model, dtype=torch.float64, device="cpu")
    streams = []
    for enc, to_np in ((jenc, lambda o: {k: np.asarray(v) for k, v in o.items()}),
                       (tenc, convert.to_numpy)):
        pk, state, chunks = Mp2Packer(cfg), enc.init_state(), []
        for f in pcm:
            state, out = enc.encode_step(state, f)
            chunks += pk.emit(to_np(out))
        streams.append(b"".join(c for c in chunks + pk.finish() if c))
    want, got = streams
    assert len(got) == 3 * 384, (model, len(got))
    assert got[0] == 0xFF and (got[1] & 0xF0) == 0xF0
    assert all(p["crc_ok"] for p in map(mp2parse.parse_frame, mp2parse.split_frames(got)))
    assert got == want


def jax_rows(rows):
    return {"hist": jnp.asarray(rows["hist"]),
            "psy2": {k: jnp.asarray(v) for k, v in rows["psy2"].items()}}


def test_psy2_state_crosses_jax_and_port():
    """Psy model 2, f64: JAX encodes frames 1-4; its state (history and the
    psy-2 leaves) crosses through convert into the port, which encodes
    frames 5-7 and hands its state back to JAX (put_state into a fresh
    state), which encodes frames 8-10.  One packer throughout: the bytes
    equal JAX's own ten frames."""
    frames, _ = gen_golden.make_input("music_48s_128_j_psy2")
    frames = frames[:10, None]
    cfg = jmodel.make_config(STREAM)
    jenc = jmodel.Mp2Encoder(cfg, psy_model=2)
    tenc = tmodel.Mp2Encoder(tmodel.make_config(STREAM), psy_model=2,
                             dtype=torch.float64, device="cpu")

    def jax_frames(js, fs, packer, chunks):
        for f in fs:
            js, out = jenc.encode_step(js, f)
            chunks += packer.emit({k: np.asarray(v) for k, v in out.items()})
        return js

    pure, want = Mp2Packer(cfg), []
    jax_frames(jenc.init_state(), frames, pure, want)
    want = b"".join(want + pure.finish())

    packer, chunks = Mp2Packer(cfg), []
    js = jax_frames(jenc.init_state(), frames[:4], packer, chunks)
    rows = jenc.take_state(js, [0])
    ts = convert.state_from_numpy({"hist": np.asarray(rows["hist"]),
                                   "psy2": {k: np.asarray(v) for k, v in rows["psy2"].items()}},
                                  "cpu")
    for f in frames[4:7]:
        ts, out = tenc.encode_step(ts, f)
        chunks += packer.emit(convert.to_numpy(out))
    back = convert.state_to_numpy(ts)
    assert back["psy2"]["savebuf"].shape == (2, 1056)
    assert back["psy2"]["r_m1"].shape == (2, 513)
    js = jenc.put_state(jenc.init_state(), [0], jax_rows(back))
    jax_frames(js, frames[7:], packer, chunks)
    assert b"".join(chunks + packer.finish()) == want


def test_take_put_state_psy2_matches_jax():
    """Stream churn with psy model 2: rows taken from one batch and put
    into another at new indices, in the port and in JAX, from the same
    states; the psy-2 leaves are channel-major [2S, ...]: equal (a copy)."""
    streams = STREAM * 4
    jenc = jmodel.Mp2Encoder(jmodel.make_config(streams), psy_model=2)
    tenc = tmodel.Mp2Encoder(tmodel.make_config(streams), psy_model=2,
                             dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)

    def state():
        return {"hist": rng.normal(size=(4, 2, 480)),
                "psy2": {"savebuf": rng.normal(size=(8, 1056)),
                         **{k: rng.normal(size=(8, 513))
                            for k in ("r_m1", "r_m2", "p_m1", "p_m2")}}}
    src, dst = state(), state()
    jrows = jenc.take_state(jax_rows(src), [3, 0])
    trows = tenc.take_state(convert.state_from_numpy(src, "cpu"), [3, 0])
    jput = jenc.put_state(jax_rows(dst), [1, 2], jrows)
    tput = tenc.put_state(convert.state_from_numpy(dst, "cpu"), [1, 2], trows)
    for got, want in ((convert.state_to_numpy(trows), jrows),
                      (convert.state_to_numpy(tput), jput)):
        np.testing.assert_array_equal(got["hist"], np.asarray(want["hist"]))
        for k, v in want["psy2"].items():
            np.testing.assert_array_equal(got["psy2"][k], np.asarray(v), err_msg=k)


def test_mixed_rates_need_one_rate_for_psy_2_3_4():
    """Psy models 2, 3 and 4 build one table set per batch and refuse a
    batch of mixed sample rates, as the JAX encoder does; 0, 1 and -1
    take it."""
    cfg = tmodel.make_config(STREAM + [{"rate": 24000, "bitrate": 64, "mode": "m"}])
    for psy in (2, 3, 4):
        with pytest.raises(ValueError, match="homogeneous"):
            tmodel.Mp2Encoder(cfg, psy_model=psy, device="cpu")
        with pytest.raises(ValueError, match="homogeneous"):
            jmodel.Mp2Encoder(jmodel.make_config(STREAM + [{"rate": 24000, "bitrate": 64,
                                                            "mode": "m"}]), psy_model=psy)
    for psy in (0, 1, -1):
        enc = tmodel.Mp2Encoder(cfg, psy_model=psy, device="cpu")
        _, out = enc.encode_step(enc.init_state(), _random_pcm(1)[0].repeat(2, 0))
        assert out["bit_alloc"].shape == (2, 2, 32)
