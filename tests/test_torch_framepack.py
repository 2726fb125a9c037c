"""The port's device-side packing (bitpack, binpack, framepack) against the
JAX package's and against the shared host packer.  Everything here is
integer: bytes must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu import bitpack as jbp
from odr_audioenc_tpu.host import mp2parse
from odr_audioenc_tpu.host.mp2pack import Mp2Packer
from odr_audioenc_tpu.mp2 import allocate as ja, binpack as jbin, framepack as jfp
from odr_audioenc_tpu_torch import bitpack as tbp, convert
from odr_audioenc_tpu_torch.mp2 import allocate as ta, binpack as tbin, framepack as tfp
from odr_audioenc_tpu_torch.mp2 import model as tmodel

from signals import frames_of, music_like

CASES = {
    "48k_j128_xpad16": ([{"rate": 48000, "bitrate": 128, "mode": "j", "pad_len": 16}] * 2, 16),
    "44k_s160_pad": ([{"rate": 44100, "bitrate": 160, "mode": "s"},
                      {"rate": 44100, "bitrate": 128, "mode": "j"}], 0),
    "mixed_lsf_mono": ([{"rate": 24000, "bitrate": 64, "mode": "m"},
                        {"rate": 48000, "bitrate": 64, "mode": "j"},
                        {"rate": 48000, "bitrate": 96, "mode": "d"}], 0),
}
NF = 4


def _run(streams, xpad_len, pack):
    """Port f32 fast path, NF frames, through the host packer; returns the
    per-stream byte streams and the last step's outputs."""
    cfg = tmodel.make_config(streams)
    S = cfg.n_streams
    enc = tmodel.Mp2Encoder(cfg, dtype=torch.float32, device="cpu", pack_on_device=pack)
    packer = Mp2Packer(cfg)
    pcm = np.stack([frames_of(music_like(NF, seed=20 + i)) for i in range(S)], axis=1)
    rng = np.random.default_rng(3)
    state, streams_out = enc.init_state(), [b""] * S
    for fi in range(NF):
        xl = np.full(S, xpad_len if fi % 2 == 0 else 0, np.int32)
        xbuf = rng.integers(0, 256, (S, max(enc.pad_max, 1)), dtype=np.uint8)
        xpads = [(xbuf[i].tobytes(), int(xl[i])) for i in range(S)] if enc.pad_max else None
        state, out = enc.encode_step(state, pcm[fi], xl,
                                     xbuf[:, :enc.pad_max] if enc.pad_max else None)
        for i, c in enumerate(packer.emit(convert.to_numpy(out), xpads)):
            streams_out[i] += c
    for i, c in enumerate(packer.finish()):
        streams_out[i] += c
    return streams_out


@pytest.mark.parametrize("case", list(CASES))
def test_device_packs_equal_host_pack(case):
    """The three emission modes (host pack of the decisions, device-packed
    sample section, complete device frames on the "wire") give the same
    bytes, and every frame parses with a valid CRC."""
    streams, xpad_len = CASES[case]
    host = _run(streams, xpad_len, False)
    assert _run(streams, xpad_len, True) == host
    assert _run(streams, xpad_len, "frame") == host
    for s in host:
        parsed = [mp2parse.parse_frame(f) for f in mp2parse.split_frames(s)]
        assert len(parsed) == NF and all(p["crc_ok"] for p in parsed)


def _decisions(seed=4, S=3):
    """A spread of integer decisions in the ranges the encoder produces."""
    rng = np.random.default_rng(seed)
    streams = [{"rate": 48000, "bitrate": 128, "mode": "j", "pad_len": 8},
               {"rate": 44100, "bitrate": 192, "mode": "s", "pad_len": 8},
               {"rate": 24000, "bitrate": 64, "mode": "m", "pad_len": 8}][:S]
    cfg = tmodel.make_config(streams)
    sb = np.arange(32)[None, :] < cfg.sblimit[:, None]
    nbal = tfp.nbal_rows(cfg)
    ba = rng.integers(0, 16, (S, 2, 32)) % (1 << nbal)[:, None, :]
    ba = np.where(sb[:, None], ba, 0)
    ba[:, 1] = np.where(cfg.nch[:, None] == 2, ba[:, 1], 0)
    out = {"sf_index": np.where(sb[:, None, None], rng.integers(0, 63, (S, 2, 3, 32)), 0),
           "scfsi": rng.integers(0, 4, (S, 2, 32)), "bit_alloc": ba,
           "mode": np.where(cfg.mode == 1, 1, cfg.mode), "mode_ext": rng.integers(0, 4, S),
           "jsbound": np.where(cfg.mode == 1, 16, cfg.sblimit),
           "extra": np.array([0, 1, 0])[:S]}
    sbband = rng.integers(0, 1 << 15, (S, 2, 3, 12, 32))
    xlen = np.array([8, 0, 5])[:S]
    xbuf = rng.integers(0, 256, (S, 8))
    return cfg, out, sbband, xlen, xbuf


def test_pack_full_frame_equals_jax():
    """framepack.pack_full_frame and binpack.pack_payload on the same
    decisions: frames, ScF-CRC values, payload and its bit count equal."""
    cfg, out, sbband, xlen, xbuf = _decisions()
    cols = ["version", "bitrate_idx", "sfreq_idx", "dab_ext", "dab_length",
            "lg_frame", "sblimit", "nch"]
    jc = {k: jnp.asarray(getattr(cfg, k)) for k in cols}
    jc["nbal"] = jnp.asarray(jfp.nbal_rows(cfg))
    tc = {k: torch.as_tensor(np.asarray(getattr(cfg, k)).astype(np.int64)) for k in cols}
    tc["nbal"] = torch.as_tensor(tfp.nbal_rows(cfg).astype(np.int64))
    jft = ja._frame_tables(jnp.asarray(cfg.tablenum))
    tft = ta._frame_tables(torch.as_tensor(cfg.tablenum))
    n_bytes = int(cfg.lg_frame.max()) + 1
    fj, vj = jax.jit(jfp.pack_full_frame, static_argnums=6)(
        jc, {k: jnp.asarray(v, jnp.int32) for k, v in out.items()}, jnp.asarray(sbband),
        jft, jnp.asarray(xlen), jnp.asarray(xbuf, jnp.int32), n_bytes)
    ft, vt = tfp.pack_full_frame(tc, {k: torch.as_tensor(v) for k, v in out.items()},
                                 torch.as_tensor(sbband), tft, torch.as_tensor(xlen),
                                 torch.as_tensor(xbuf), n_bytes)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))

    sbl, nch, jsb = cfg.sblimit, cfg.nch, out["jsbound"]
    pj, bj = jbin.pack_payload(jnp.asarray(sbband), jnp.asarray(out["bit_alloc"]), jft,
                               jnp.asarray(sbl), jnp.asarray(nch), jnp.asarray(jsb), 300)
    pt, bt = tbin.pack_payload(torch.as_tensor(sbband), torch.as_tensor(out["bit_alloc"]),
                               tft, torch.as_tensor(sbl).long(), torch.as_tensor(nch).long(),
                               torch.as_tensor(jsb), 300)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("poly,width,init,nb", [(0x8005, 16, 0xFFFF, 52), (0x1D, 8, 0, 32)])
def test_crc_device_matches_bit_serial(poly, width, init, nb):
    """GF(2) CRC of messages of every length class against the bit-serial
    reference and the JAX version (integers: equal)."""
    rng = np.random.default_rng(width)
    tab = tbp.CrcTable(poly, width, init, nb * 8)
    jtab = jbp.CrcTable(poly, width, init, nb * 8)
    lens = rng.integers(0, nb * 8 + 1, 40)
    lens[:3] = [0, 1, nb * 8]
    bufs = np.zeros((40, nb), np.int64)
    want = []
    for i, L in enumerate(lens.tolist()):
        val = int("0" + "".join(map(str, rng.integers(0, 2, L))), 2)
        msb = val << (nb * 8 - L)
        bufs[i] = np.frombuffer(msb.to_bytes(nb, "big"), np.uint8)
        want.append(tbp._crc_ref(val, int(L), init, poly, width))
    got = tbp.crc_device(torch.as_tensor(bufs), torch.as_tensor(lens),
                         tab.device_tables("cpu"), width)
    assert got.tolist() == want
    gj = jbp.crc_device(jnp.asarray(bufs, jnp.int32), jnp.asarray(lens, jnp.int32),
                        jtab.device_tables(), width)
    assert np.asarray(gj).tolist() == want
