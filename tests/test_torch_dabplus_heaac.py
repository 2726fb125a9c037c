"""The port's HE-AAC (SBR) encoder end to end against the JAX encoder,
through the host packer: in f64 the superframes are byte-equal to JAX's
(48 kHz mono 48 kbps; 48 kHz stereo 64 kbps with coupled and uncoupled
AUs; 32 kHz mono 48 kbps, slow); in f32 at least 90% of AUs make JAX's
core decisions and carry its SBR side data.  On every AU the counted core
bits equal the written core length + 10, the written FIL element is as long
as payload_bits counts it with the header bits as written, and the
step's sbr_bits are the reference's count; native and Python host packs
are byte-equal; every superframe passes RS, the firecode and
validate_superframe.  The helpers serve test_torch_dabplus_heaac_ps.py
too.  JAX runs on the CPU with x64 (conftest.py); inputs are numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.dabplus import model as JM
from odr_audioenc_tpu.fec.rs import superframe_check_rs
from odr_audioenc_tpu.host.aacpack import firecode_crc
from odr_audioenc_tpu.host.dabplus_parse import validate_superframe
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.dabplus import model as TM
from odr_audioenc_tpu_torch.dabplus import sbr as TS

from signals import music_like

N_SF = 3
_JAX = {}
# the keys of the step outputs that are the core's decisions, and the side data
CORE = ("gains", "books", "wseq")
SIDE = ("sbr_env", "sbr_env2", "sbr_transient", "sbr_noise_q", "sbr_invf", "sbr_addharm",
        "sbr_tgrid", "sbr_cpl", "ps_iid", "ps_icc", "ps_iid_fine", "ps_fine")


def jax_encoder(cfg, dtype):
    """One JAX encoder per (config, dtype): its jitted step compiles once
    (~12-15 s on the CPU) and serves every test of the module."""
    key = (tuple(sorted(cfg.items())), dtype)
    if key not in _JAX:
        _JAX[key] = JM.DabPlusEncoder(JM.DabPlusConfig(**cfg), 1, dtype=dtype)
    return _JAX[key]


def port_encoder(cfg, dtype):
    return TM.DabPlusEncoder(TM.DabPlusConfig(**cfg), 1, dtype=dtype, device="cpu")


def _burst_channel(n, seed=5):
    """Quiet noise with a 12 kHz tone burst every 7000 samples: transients
    in the SBR range where the other channel has none."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.02, n) * 32767
    for s in range(2000, n, 7000):
        x[s:s + 960] += np.sin(2 * np.pi * 12000 * np.arange(len(x[s:s + 960])) / 48000) * 20000
    return np.clip(x, -32768, 32767).astype(np.int16)


def signal(name, cfg, n_sf=N_SF):
    """[ch, n_sf * superframe] int16.  `music`: music_like; `split`: music
    on the left, `_burst_channel` on the right (the channels' framing
    differs on some AUs, so stereo SBR codes them uncoupled)."""
    c = TM.DabPlusConfig(**cfg)
    n = n_sf * c.num_aus * c.au_samples
    x = music_like(n // 1152 + 2, stereo=c.channels == 2, rate=c.sample_rate)[:c.channels, :n]
    if name == "split":
        x = np.stack([x[0], _burst_channel(n)])
    return x


def encode(enc, sig, first=0, n_sf=N_SF, state=None):
    """Superframes first..first+n_sf-1 of sig through enc (either package)
    and the native host packer.  Returns (frames, per-superframe numpy
    outputs, state)."""
    spf = enc.cfg.num_aus * enc.cfg.au_samples
    state = enc.init_state() if state is None else state
    frames, outs = [], []
    for i in range(first, first + n_sf):
        state, out = enc.encode_superframes(state, sig[None, :, i * spf:(i + 1) * spf],
                                            pack=False)
        frames += enc.pack_superframes(out, add_rs=True)
        if isinstance(enc, TM.DabPlusEncoder):
            out = convert.to_numpy(out)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return frames, outs, state


def _nbits(bw):
    return len(bw.buf) * 8 + bw.nbits


def recount(enc, out, hdr_bits):
    """payload_bits over the step outputs `out` (numpy, [S, nau, ...])."""
    t = {k: torch.as_tensor(v) for k, v in out.items()}
    ps_bits = None
    if enc.is_ps:
        ps_bits = TS.ps_data_bits(t["ps_iid"], t["ps_iid_fine"], t["ps_fine"], t["ps_icc"])
    side = {k: v for k, v in t.items() if k.startswith("sbr_")}
    return TS.payload_bits(side, enc.sbr_params, enc.cfg.num_aus, ps_bits=ps_bits,
                           hdr_bits=hdr_bits).numpy()


def check_stream(enc, frames, outs):
    """Every superframe valid; per AU: counted core bits = written core +
    10, the FIL element = payload_bits with the written header bits, the
    step's sbr_bits = payload_bits as the reference counts; the Python
    host pack equals the native one."""
    subch = enc.cfg.subch
    for fr in frames:
        assert len(fr) == 120 * subch
        assert superframe_check_rs(np.frombuffer(fr, np.uint8))
        assert firecode_crc(fr[2:11]) == (fr[0] << 8 | fr[1])
        assert validate_superframe(fr)[0]
    for i, out in enumerate(outs):
        fil = recount(enc, out, TS.HDR_BITS_WRITTEN)
        np.testing.assert_array_equal(out["sbr_bits"], recount(enc, out, TS.HDR_BITS))
        for a in range(enc.cfg.num_aus):
            core = _nbits(enc.write_au(out, 0, a, sbr=False))
            assert int(out["bits"][0, a]) == core + 10, (i, a)
            assert _nbits(enc.write_au(out, 0, a)) - core == fil[0, a], (i, a)
        assert enc.pack_superframes(out, add_rs=True, use_native=False) == [frames[i]]


def run_f64_case(cfg, name="music"):
    """The f64 port against the f64 JAX encoder over N_SF superframes.
    Returns the port's per-superframe outputs."""
    sig = signal(name, cfg)
    want, _, _ = encode(jax_encoder(cfg, jnp.float64), sig)
    tenc = port_encoder(cfg, torch.float64)
    got, outs, _ = encode(tenc, sig)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not bad and len(got) == len(want) == N_SF, f"superframes {bad} differ"
    check_stream(tenc, got, outs)
    return outs


def run_f32_case(cfg, name="music"):
    """The f32 port against the f32 JAX encoder: >= 90% of AUs with the same
    core decisions and the same SBR/PS side data; the port's stream valid."""
    sig = signal(name, cfg)
    _, jouts, _ = encode(jax_encoder(cfg, jnp.float32), sig)
    tenc = port_encoder(cfg, torch.float32)
    frames, touts, _ = encode(tenc, sig)
    check_stream(tenc, frames, touts)
    keys = CORE + tuple(k for k in SIDE if k in touts[0])
    assert all(k in j for j in jouts for k in keys)
    same = sum(all(np.array_equal(j[k][0, a], t[k][0, a]) for k in keys)
               for j, t in zip(jouts, touts) for a in range(tenc.cfg.num_aus))
    total = N_SF * tenc.cfg.num_aus
    assert same >= 0.9 * total, f"only {same}/{total} AUs decide as JAX's"


SBR48 = {"sample_rate": 48000, "subch": 6, "channels": 1, "aot": "sbr"}
SBR64 = {"sample_rate": 48000, "subch": 8, "channels": 2, "aot": "sbr"}
SBR32K = {"sample_rate": 32000, "subch": 6, "channels": 1, "aot": "sbr"}


def test_sbr48_f64_byte_equal_to_jax():
    """48 kHz mono 48 kbps (the sbr_48 shape): a 2-envelope AU among them."""
    outs = run_f64_case(SBR48)
    assert any(o["sbr_transient"].any() for o in outs)


def test_stereo_sbr64_f64_byte_equal_to_jax():
    """48 kHz stereo 64 kbps: a CPE core with sbr_channel_pair_element,
    coupled AUs and uncoupled ones (where the channels' framing differs)."""
    outs = run_f64_case(SBR64, "split")
    cpl = np.concatenate([o["sbr_cpl"].ravel() for o in outs])
    assert cpl.any() and not cpl.all(), cpl


@pytest.mark.slow
def test_sbr_32k_f64_byte_equal_to_jax():
    """32 kHz mono 48 kbps: 2 AUs of 1920 samples, the 32 kHz header row."""
    run_f64_case(SBR32K)


def test_sbr48_f32_agrees_with_jax():
    run_f32_case(SBR48)


@pytest.mark.slow
def test_stereo_sbr64_f32_agrees_with_jax():
    run_f32_case(SBR64, "split")
