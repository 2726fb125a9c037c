"""The port's DAB+ AAC-LC encoder end to end against the JAX encoder,
through the shared host packer: in f64 the superframes are byte-equal to
JAX's; in f32 the AUs make the same decisions (gains, books, window
sequence) in at least 90% of cases; every AU's counted bits equal its
written length plus 10 (ID_END and the byte-align allowance); every
superframe passes RS, the firecode and validate_superframe.  The state
crosses JAX -> port -> JAX with the bitstream unchanged.  JAX runs on the
CPU with x64 (conftest.py); inputs are numpy."""
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

from signals import loud_tones, music_like
from torch_cpu import one_torch_thread  # noqa: F401

N_SF = 3
_JAX = {}


def jax_encoder(cfg, dtype):
    """One JAX encoder per (config, dtype): its jitted step compiles once
    (~10-13 s on the CPU) and serves every test of the module."""
    key = (tuple(sorted(cfg.items())), dtype)
    if key not in _JAX:
        _JAX[key] = JM.DabPlusEncoder(JM.DabPlusConfig(**cfg), 1, dtype=dtype)
    return _JAX[key]


def port_encoder(cfg, dtype):
    return TM.DabPlusEncoder(TM.DabPlusConfig(**cfg), 1, dtype=dtype, device="cpu")


def signal(name, cfg, n_sf=N_SF):
    """[ch, n_sf * superframe] int16 of `music` or `tones`."""
    c = TM.DabPlusConfig(**cfg)
    n = n_sf * c.num_aus * 960
    make = {"music": music_like, "tones": loud_tones}[name]
    return make(n // 1152 + 2, stereo=c.channels == 2, rate=c.sample_rate)[:c.channels, :n]


def xpads(cfg, i):
    """X-PAD bytes for superframe i (none without pad_len)."""
    c = TM.DabPlusConfig(**cfg)
    if not c.pad_len:
        return None
    return [[bytes((7 * i + a + k) % 256 for k in range(c.pad_len - a % 3))
             for a in range(c.num_aus)]]


def encode(enc, cfg, sig, first=0, n_sf=N_SF, state=None):
    """Superframes first..first+n_sf-1 of sig through enc (either package)
    and the host packer.  Returns (frames, per-superframe numpy outputs,
    state)."""
    spf = enc.cfg.num_aus * 960
    state = enc.init_state() if state is None else state
    frames, outs = [], []
    for i in range(first, first + n_sf):
        state, out = enc.encode_superframes(state, sig[None, :, i * spf:(i + 1) * spf],
                                            pack=False)
        frames += enc.pack_superframes(out, add_rs=True, pads=xpads(cfg, i))
        if isinstance(enc, TM.DabPlusEncoder):
            out = convert.to_numpy(out)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return frames, outs, state


def written_bits(enc, out, a):
    """The bit length of AU a (stream 0) as the host AU writer writes it."""
    bw = enc.write_au(out, 0, a)
    return len(bw.buf) * 8 + bw.nbits


def check_stream(enc, frames, outs):
    """Every superframe valid; counted = written + 10 on every AU."""
    subch = enc.cfg.subch
    for fr in frames:
        assert len(fr) == 120 * subch
        assert superframe_check_rs(np.frombuffer(fr, np.uint8))
        assert firecode_crc(fr[2:11]) == (fr[0] << 8 | fr[1])
        assert validate_superframe(fr)[0]
    for out in outs:
        for a in range(enc.cfg.num_aus):
            assert int(out["bits"][0, a]) == written_bits(enc, out, a) + 10, a


def run_f64_case(cfg, name):
    """The f64 port against the f64 JAX encoder over N_SF superframes.
    Returns the port's per-superframe outputs."""
    sig = signal(name, cfg)
    want, _, _ = encode(jax_encoder(cfg, jnp.float64), cfg, sig)
    tenc = port_encoder(cfg, torch.float64)
    got, outs, _ = encode(tenc, cfg, sig)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not bad and len(got) == len(want) == N_SF, f"superframes {bad} differ"
    check_stream(tenc, got, outs)
    return outs


def run_f32_case(cfg, name="music"):
    """The f32 port against the f32 JAX encoder: >= 90% of AUs with the same
    gains, books and window sequence; the port's stream valid."""
    sig = signal(name, cfg)
    _, jouts, _ = encode(jax_encoder(cfg, jnp.float32), cfg, sig)
    tenc = port_encoder(cfg, torch.float32)
    frames, touts, _ = encode(tenc, cfg, sig)
    check_stream(tenc, frames, touts)
    same = sum(all(np.array_equal(j[k][0, a], t[k][0, a]) for k in ("gains", "books", "wseq"))
               for j, t in zip(jouts, touts) for a in range(tenc.cfg.num_aus))
    total = N_SF * tenc.cfg.num_aus
    assert same >= 0.9 * total, f"only {same}/{total} AUs decide as JAX's"


LC96 = {"sample_rate": 48000, "subch": 12, "channels": 2}
PNS64 = {"sample_rate": 48000, "subch": 8, "channels": 2}


@pytest.mark.parametrize("name", ["music", "tones"])
def test_lc96_f64_byte_equal_to_jax(name):
    """48 kHz stereo 96 kbps (the lc_96 shape); the first superframe from
    silence codes an all-zero AU and a START/EIGHT_SHORT/STOP sequence.
    The Python AU writer packs the same bytes as the native packer."""
    outs = run_f64_case(LC96, name)
    seqs = np.concatenate([o["wseq"][0] for o in outs])
    assert {0, 1, 2, 3} <= set(seqs.tolist()), seqs
    enc = port_encoder(LC96, torch.float64)
    sig = signal(name, LC96, 1)
    _, out = enc.encode_superframes(enc.init_state(), sig[None], pack=False)
    assert enc.pack_superframes(out, add_rs=True, use_native=False) == \
        enc.pack_superframes(out, add_rs=True)


@pytest.mark.parametrize("name", ["music", "tones"])
def test_pns_f64_byte_equal_to_jax(name):
    """48 kHz stereo 64 kbps: PNS on the 0.05 ladder (32 kbps/channel)."""
    outs = run_f64_case(PNS64, name)
    if name == "music":
        assert sum(int((o["books"] == 13).sum()) for o in outs) > 0, "no PNS band coded"


def test_lc96_f32_agrees_with_jax():
    run_f32_case(LC96)


@pytest.mark.slow
def test_pns_f32_agrees_with_jax():
    run_f32_case(PNS64)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_state_carries_between_jax_and_port(first):
    """Two superframes in one package, take_state, two more in the other:
    the four superframes equal an all-JAX run byte for byte (f64)."""
    sig = signal("music", LC96, 4)
    jenc = jax_encoder(LC96, jnp.float64)
    want, _, _ = encode(jenc, LC96, sig, n_sf=4)
    tenc = port_encoder(LC96, torch.float64)
    if first == "jax":
        a, _, st = encode(jenc, LC96, sig, n_sf=2)
        rows = {k: np.asarray(v) for k, v in jenc.take_state(st, [0]).items()}
        st = tenc.put_state(tenc.init_state(), [0],
                            convert.dabplus_state_from_numpy(rows, "cpu", torch.float64))
        b, _, _ = encode(tenc, LC96, sig, first=2, n_sf=2, state=st)
    else:
        a, _, st = encode(tenc, LC96, sig, n_sf=2)
        rows = convert.to_numpy(tenc.take_state(st, [0]))
        st = jenc.put_state(jenc.init_state(), [0], rows)
        b, _, _ = encode(jenc, LC96, sig, first=2, n_sf=2, state=st)
    assert a + b == want
