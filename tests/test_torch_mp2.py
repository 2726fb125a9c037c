"""The port's MP2 slice end to end: the goldens through the port, the fast
path against the JAX fast path, and state carried from the JAX encoder into
the port.  JAX runs on the CPU with x64 (conftest.py); inputs are numpy."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.host import mp2parse
from odr_audioenc_tpu.host.mp2pack import Mp2Packer
from odr_audioenc_tpu.mp2 import model as jmodel
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.mp2 import model as tmodel, psycho1_kernels

import gen_golden
from signals import frames_of, music_like
from torch_cpu import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
PSY1_GOLDENS = [n for n, c in gen_golden.CONFIGS.items() if c[5] == 1]
# the fast tier keeps the flagship, X-PAD16, 44.1k padding and LSF mono;
# the other ten run in the full suite
FAST_GOLDENS = {"music_48s_128_j_psy1", "music_48s_128_j_psy1_xpad16",
                "music_44s_128_j_psy1", "music_24m_64_m_psy1"}


def _encode_golden(name):
    _, _, rate, bitrate, mode, _, xpad_len = gen_golden.CONFIGS[name]
    frames, xpads = gen_golden.make_input(name)
    cfg = tmodel.make_config([{"rate": rate, "bitrate": bitrate, "mode": mode,
                               "pad_len": xpad_len}])
    enc = tmodel.Mp2Encoder(cfg, psy_model=1, dtype=torch.float64, device="cpu")
    packer = Mp2Packer(cfg)
    state = enc.init_state()
    chunks = []
    for fi, f in enumerate(frames):
        state, out = enc.encode_step(state, f[None], np.array([xpad_len], np.int32))
        chunks += packer.emit(convert.to_numpy(out), [xpads[fi]] if xpads else None)
    chunks += packer.finish()
    return b"".join(chunks)


@pytest.mark.parametrize("name", [
    n if n in FAST_GOLDENS else pytest.param(n, marks=pytest.mark.slow)
    for n in PSY1_GOLDENS])
def test_golden_byte_exact(name):
    """The exact f64 path + the shared host packer reproduce the reference
    stream byte for byte (no tolerance: the goldens are toolame's bytes)."""
    want = (GOLDEN / f"{name}.mp2").read_bytes()
    got = _encode_golden(name)
    assert len(got) == len(want)
    bad = [i for i, (a, b) in enumerate(zip(mp2parse.split_frames(got),
                                            mp2parse.split_frames(want))) if a != b]
    assert got == want, f"{name}: frames {bad[:5]} differ"


def _two_streams(nf):
    a = frames_of(music_like(nf))
    b = frames_of(music_like(nf, seed=77))
    return np.stack([a, b], axis=1)                     # [nf, 2, 2, 1152]


@pytest.mark.parametrize("pack,mixed", [(False, False), (True, False), ("frame", False),
                                        ("frame", True)])
def test_fast_path_f64_integers_equal_jax(pack, mixed):
    """fast_psy=True in f64: every integer decision and every byte equals the
    JAX fast path, for the flagship pair and for a 48k + 24k (LSF) pair
    whose per-row band matrices and generic minimum mask differ.  SMR agrees
    to 1e-6 dB, not bitwise: the two f64 rFFTs (pocketfft/MKL vs XLA's)
    round differently, which moves low-energy bins' dB values by ~1e-10 and
    the linear-domain threshold sums after them."""
    nf = 12
    pcm = _two_streams(nf)
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * 2
    if mixed:
        streams[1] = {"rate": 24000, "bitrate": 64, "mode": "j"}
    jcfg, tcfg = jmodel.make_config(streams), tmodel.make_config(streams)
    jenc = jmodel.Mp2Encoder(jcfg, psy_model=1, dtype=jnp.float64, fast_psy=True,
                             pack_on_device=pack)
    tenc = tmodel.Mp2Encoder(tcfg, psy_model=1, dtype=torch.float64, device="cpu",
                             fast_psy=True, pack_on_device=pack)
    js, ts = jenc.init_state(), tenc.init_state()
    for fi in range(nf):
        js, jo = jenc.encode_step(js, pcm[fi])
        ts, to = tenc.encode_step(ts, pcm[fi])
        to = convert.to_numpy(to)
        for k, v in jo.items():
            v = np.asarray(v)
            if k == "smr":
                np.testing.assert_allclose(to[k], v, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(to[k].astype(np.int64), v.astype(np.int64),
                                              err_msg=f"frame {fi} {k}")


def test_fast_path_f32_close_to_jax_and_valid():
    """f32 fast path against JAX's f32 fast path, S=2, 12 frames: SMR within
    0.5 dB (f32 op order in the spectrum and the linear-domain sums) in every
    subband whose scalefactor both paths chose alike, >= 90% of frames with
    the same bit allocation, and every emitted frame CRC-valid.  Where f32
    filterbank rounding moves a peak across a scalefactor boundary, SMR
    moves by the table's 2.007 dB step by construction; such subbands are
    counted and held to at most 1%."""
    nf = 12
    pcm = _two_streams(nf)
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * 2
    jcfg, tcfg = jmodel.make_config(streams), tmodel.make_config(streams)
    jenc = jmodel.Mp2Encoder(jcfg, psy_model=1, dtype=jnp.float32, fast_psy=True)
    tenc = tmodel.Mp2Encoder(tcfg, psy_model=1, dtype=torch.float32, device="cpu")
    packer = Mp2Packer(tcfg)
    js, ts = jenc.init_state(), tenc.init_state()
    smr_diff, flips, same, streams_out = 0.0, 0, 0, [b"", b""]
    for fi in range(nf):
        js, jo = jenc.encode_step(js, pcm[fi])
        ts, to = tenc.encode_step(ts, pcm[fi])
        to = convert.to_numpy(to)
        alike = to["sf_index"].min(axis=2) == np.asarray(jo["sf_index"]).min(axis=2)
        flips += int((~alike).sum())
        d = np.abs(to["smr"] - np.asarray(jo["smr"]))[alike]
        smr_diff = max(smr_diff, float(d.max()))
        same += np.array_equal(to["bit_alloc"], np.asarray(jo["bit_alloc"]))
        for i, c in enumerate(packer.emit(to)):
            streams_out[i] += c
    for i, c in enumerate(packer.finish()):
        streams_out[i] += c
    assert smr_diff < 0.5, smr_diff
    assert flips <= 0.01 * nf * 2 * 2 * 32, flips
    assert same >= 0.9 * nf, f"{same}/{nf} frames allocate like JAX"
    for s in streams_out:
        parsed = [mp2parse.parse_frame(f) for f in mp2parse.split_frames(s)]
        assert len(parsed) == nf
        assert all(p["crc_ok"] for p in parsed)


def test_state_carried_from_jax_continues_exactly():
    """JAX encodes frames 1-5; its state crosses through convert into the
    port, which encodes frames 6-10.  The bytes equal JAX's own 10 frames
    (f64 exact path on both sides: equality, no tolerance)."""
    name = "music_48s_128_j_psy1"
    frames, _ = gen_golden.make_input(name)
    frames = frames[:10]
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}]
    cfg = jmodel.make_config(streams)
    jenc = jmodel.Mp2Encoder(cfg, psy_model=1)
    tenc = tmodel.Mp2Encoder(tmodel.make_config(streams), psy_model=1,
                             dtype=torch.float64, device="cpu")

    def run(split):
        packer = Mp2Packer(cfg)
        js = jenc.init_state()
        chunks = []
        for f in frames[:split]:
            js, out = jenc.encode_step(js, f[None])
            chunks += packer.emit({k: np.asarray(v) for k, v in out.items()})
        ts = convert.state_from_numpy(
            {k: np.asarray(v) for k, v in jenc.take_state(js, [0]).items()}, "cpu")
        for f in frames[split:]:
            ts, out = tenc.encode_step(ts, f[None])
            chunks += packer.emit(convert.to_numpy(out))
        back = convert.state_to_numpy(ts)
        chunks += packer.finish()
        return b"".join(chunks), back, js

    mixed, back, _ = run(5)
    pure, _, js = run(10)
    assert mixed == pure
    assert back["hist"].dtype == np.float64 and back["hist"].shape == (1, 2, 480)


def test_take_put_state_matches_jax():
    """Stream churn: rows taken from one batch and put into another at new
    indices, in the port and in JAX, from the same states: equal rows
    (a copy, exact)."""
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * 4
    jenc = jmodel.Mp2Encoder(jmodel.make_config(streams), psy_model=1)
    tenc = tmodel.Mp2Encoder(tmodel.make_config(streams), psy_model=1,
                             dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    src, dst = rng.normal(size=(4, 2, 480)), rng.normal(size=(4, 2, 480))
    jrows = jenc.take_state({"hist": jnp.asarray(src)}, [3, 0])
    trows = tenc.take_state(convert.state_from_numpy({"hist": src}, "cpu"), [3, 0])
    np.testing.assert_array_equal(trows["hist"].numpy(), np.asarray(jrows["hist"]))
    jput = jenc.put_state({"hist": jnp.asarray(dst)}, [1, 2], jrows)
    tput = tenc.put_state(convert.state_from_numpy({"hist": dst}, "cpu"), [1, 2], trows)
    np.testing.assert_array_equal(convert.state_to_numpy(tput)["hist"],
                                  np.asarray(jput["hist"]))


def test_fused_noise_encoder_matches_jax_and_tonal():
    """psy_kernel="fused-noise" end to end, S=2, 12 frames.  f64 fast path:
    every integer output equals the JAX fast path's (whose noise labelling
    is the unfused noise_fast; in f64 the band sums' order moves no
    centre here).  f32 frame pack: every frame CRC-valid, and >= 90% of
    frames allocate as the port's tonal path does."""
    nf = 12
    pcm = _two_streams(nf)
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j"}] * 2
    jcfg, tcfg = jmodel.make_config(streams), tmodel.make_config(streams)
    jenc = jmodel.Mp2Encoder(jcfg, psy_model=1, dtype=jnp.float64, fast_psy=True)
    fused64 = tmodel.Mp2Encoder(tcfg, psy_model=1, dtype=torch.float64, device="cpu",
                                fast_psy=True, psy_kernel="fused-noise")
    js, ts = jenc.init_state(), fused64.init_state()
    for fi in range(nf):
        js, jo = jenc.encode_step(js, pcm[fi])
        ts, to = fused64.encode_step(ts, pcm[fi])
        to = convert.to_numpy(to)
        for k, v in jo.items():
            if k != "smr":
                np.testing.assert_array_equal(to[k].astype(np.int64),
                                              np.asarray(v).astype(np.int64),
                                              err_msg=f"frame {fi} {k}")
    encs = [tmodel.Mp2Encoder(tcfg, psy_model=1, dtype=torch.float32, device="cpu",
                              pack_on_device="frame", psy_kernel=k)
            for k in ("tonal", "fused-noise")]
    states = [e.init_state() for e in encs]
    packers = [Mp2Packer(tcfg) for _ in encs]
    out = [[b"", b""], [b"", b""]]
    for fi in range(nf):
        for j, enc in enumerate(encs):
            states[j], o = enc.encode_step(states[j], pcm[fi])
            for i, c in enumerate(packers[j].emit({"wire": o["wire"].numpy()})):
                out[j][i] += c
    for j in range(2):
        for i, c in enumerate(packers[j].finish()):
            out[j][i] += c
    same, total = 0, 0
    for tonal, fused in zip(*out):
        pt = [mp2parse.parse_frame(f) for f in mp2parse.split_frames(tonal)]
        pf = [mp2parse.parse_frame(f) for f in mp2parse.split_frames(fused)]
        assert len(pf) == nf and all(p["crc_ok"] for p in pf)
        same += sum(np.array_equal(a["bit_alloc"], b["bit_alloc"]) for a, b in zip(pt, pf))
        total += nf
    assert same >= 0.9 * total, f"{same}/{total} frames allocate as the tonal path"


def test_launch_count_and_device_policy():
    """On the CPU both psy-1 kernels take their plain versions and count no
    launch; every psy model of the JAX encoder constructs, and an unknown
    model or psy-1 kernel is refused."""
    cfg = tmodel.make_config([{"rate": 48000, "bitrate": 128, "mode": "j"}])
    for kernel in ("tonal", "fused-noise"):
        enc = tmodel.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device="cpu",
                                pack_on_device="frame", psy_kernel=kernel)
        before = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
        state, out = enc.encode_step(enc.init_state(), frames_of(music_like(1))[:1])
        assert (psycho1_kernels.launches, psycho1_kernels.noise_launches) == before
        assert out["wire"].shape == (1, enc.frame_bytes + 6)
        assert out["wire"].dtype == torch.uint8
    for psy in (0, 2, 3, 4, -1):
        assert tmodel.Mp2Encoder(cfg, psy_model=psy, device="cpu").psy_model == psy
    with pytest.raises(NotImplementedError):
        tmodel.Mp2Encoder(cfg, psy_model=5, device="cpu")
    with pytest.raises(ValueError):
        tmodel.Mp2Encoder(cfg, psy_model=1, device="cpu", psy_kernel="pallas")
