"""The port's DAB+ device pack end to end (odr_audioenc_tpu_torch/dabplus/
aupack.py and the pack_on_device=True encoder), the twins of
tests/test_aupack.py: on the same step outputs the port's device pack, the
port's host writer and the JAX package's aupack.pack_from_outputs give the
same bytes (8 configurations x 4 signals, and the X-PAD case); the
device-mode encoder gives the host-mode encoder's bytes, valid under RS, the
firecode, the AU CRCs and validate_superframe; the multi-device dry run on
the CPU.  Integers everywhere, so no tolerance.  The JAX pack runs eagerly
on the port's outputs as numpy: no JAX step is compiled."""
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.dabplus import aupack as JA
from odr_audioenc_tpu.dabplus import model as JM
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.dabplus import aupack as TA
from odr_audioenc_tpu_torch.dabplus import model as TM
from odr_audioenc_tpu_torch.entry import dryrun_multichip
from odr_audioenc_tpu_torch.fec.rs import superframe_check_rs
from odr_audioenc_tpu_torch.host.aacpack import crc16_ccitt, firecode_crc
from odr_audioenc_tpu_torch.host.dabplus_parse import validate_superframe

S = 3
CASES = [
    dict(rate=48000, subch=12, ch=2),
    dict(rate=48000, subch=8, ch=1),
    dict(rate=32000, subch=6, ch=2),
    dict(rate=48000, subch=24, ch=2),
    dict(rate=48000, subch=6, ch=1, aot="sbr"),
    dict(rate=48000, subch=8, ch=2, aot="sbr"),
    dict(rate=48000, subch=4, ch=2, aot="ps"),
    dict(rate=32000, subch=4, ch=2, aot="ps"),
]
KINDS = ["noise", "attack", "quiet", "tone"]


def case_id(case):
    return f"{case.get('aot', 'lc')}-{case['rate'] // 1000}k-{case['subch']}-{case['ch']}ch"


def make_signal(rng, n_streams, ch, n, kind):
    """The four signals of tests/test_aupack.py."""
    if kind == "noise":
        return rng.integers(-16000, 16000, (n_streams, ch, n)).astype(np.int16)
    if kind == "quiet":
        return rng.integers(-60, 60, (n_streams, ch, n)).astype(np.int16)
    if kind == "attack":
        x = rng.integers(-200, 200, (n_streams, ch, n)).astype(np.int16)
        t = np.arange(300)
        x[:, :, n // 2:n // 2 + 300] += (14000 * np.sin(2 * np.pi * 3000 / 48000 * t)
                                         ).astype(np.int16)
        return x
    t = np.arange(n) / 48000.0
    x = (11000 * np.sin(2 * np.pi * 997 * t)).astype(np.int16)
    return np.tile(x, (n_streams, ch, 1)).astype(np.int16)


def make_pads(rng, n_streams, nau):
    return [[bytes(rng.integers(0, 256, int(rng.integers(0, 17))).astype(np.uint8))
             for _ in range(nau)] for _ in range(n_streams)]


def configs(case, pad_len=0):
    kw = dict(aot=case.get("aot", "lc"), pad_len=pad_len)
    return (TM.DabPlusConfig(case["rate"], case["subch"], case["ch"], **kw),
            JM.DabPlusConfig(case["rate"], case["subch"], case["ch"], **kw))


def check_valid(frame, cfg, packer):
    """RS, firecode, every AU CRC (from the header's AU starts), the parser."""
    sf = np.frombuffer(frame, np.uint8)
    assert len(sf) == 120 * cfg.subch
    assert superframe_check_rs(sf)
    core = bytes(sf[:110 * cfg.subch])
    assert firecode_crc(core[2:11]) == (core[0] << 8) | core[1]
    bits = "".join(f"{b:08b}" for b in core[:packer.header_bytes])
    starts = [packer.header_bytes] + [int(bits[24 + 12 * i:36 + 12 * i], 2)
                                      for i in range(cfg.num_aus - 1)]
    for lo, hi in zip(starts, starts[1:] + [len(core)]):
        assert crc16_ccitt(core[lo:hi - 2]) ^ 0xFFFF == (core[hi - 2] << 8) | core[hi - 1]
    assert validate_superframe(frame)[0]


def run_pack_case(case, with_pad):
    """Device pack == host writer == JAX device pack, on the port's f32
    outputs of four signals in a row (the state carries).  The JAX pack,
    whose eager ops cost the same at any batch, takes the four superframes'
    outputs as one batch of 4 S streams."""
    tcfg, jcfg = configs(case, 16 if with_pad else 0)
    enc = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    st = enc.init_state()
    n = tcfg.num_aus * tcfg.au_samples
    outs, all_pads, devs = [], [], []
    for kind in KINDS:
        pcm = make_signal(rng, S, tcfg.channels, n, kind)
        pads = make_pads(rng, S, tcfg.num_aus) if with_pad else None
        st, out = enc.encode_superframes(st, pcm, pack=False, pads=pads)
        host = enc.pack_superframes(out, add_rs=True, pads=pads, use_native=False)
        dev = TA.pack_from_outputs(enc, out, pads=pads, add_rs=True)
        for s in range(S):
            d = dev[s].tobytes()
            assert host[s] == d, (
                f"{kind} stream {s}: device != host writer, first at "
                f"{next(j for j in range(len(d)) if host[s][j] != d[j])} of {len(d)}")
            check_valid(d, tcfg, enc.packer)
        core = TA.pack_from_outputs(enc, out, pads=pads, add_rs=False)
        assert core.shape == (S, 110 * tcfg.subch)
        assert np.array_equal(core, dev[:, :110 * tcfg.subch])
        outs.append(convert.to_numpy(out))
        all_pads += pads or []
        devs.append(dev)
    jenc = JM.DabPlusEncoder(jcfg, n_streams=len(KINDS) * S)    # its jitted step is never called
    jdev = JA.pack_from_outputs(jenc, {k: np.concatenate([o[k] for o in outs]) for k in outs[0]},
                                pads=all_pads if with_pad else None, add_rs=True)
    assert np.array_equal(np.concatenate(devs), jdev), "device pack != JAX device pack"


@pytest.mark.parametrize("case", CASES[:4], ids=case_id)
def test_device_pack_matches_host_and_jax(case):
    """The four AAC-LC configurations (the HE-AAC ones: test_torch_aupack.py)."""
    run_pack_case(case, False)


def test_device_pack_matches_host_and_jax_with_pads():
    run_pack_case(CASES[0], True)


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[5], CASES[6]], ids=case_id)
def test_device_mode_encoder_equals_host_mode(case):
    """pack_on_device=True: one `wire` leaf per step; the same bytes as the
    host-mode encoder on the same input, valid, with the wire's au_len and
    au_bits consistent with the superframe header."""
    tcfg, _ = configs(case)
    host = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device="cpu")
    dev = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device="cpu", pack_on_device=True)
    assert host.aupack_ctx is None and dev.aupack_ctx is not None
    rng = np.random.default_rng(7)
    sh, sd = host.init_state(), dev.init_state()
    n, nau = tcfg.num_aus * tcfg.au_samples, tcfg.num_aus
    for kind in ("noise", "attack", "tone"):
        pcm = make_signal(rng, S, tcfg.channels, n, kind)
        sh, want = host.encode_superframes(sh, pcm)
        sd, out = dev.encode_superframes(sd, pcm, pack=False)
        assert set(out) == {"wire"} and out["wire"].dtype == torch.uint8
        assert tuple(out["wire"].shape) == (S, 120 * tcfg.subch + 4 * nau)
        got = dev.pack_superframes(out)
        assert got == want
        for f in got:
            check_valid(f, tcfg, dev.packer)
        assert [f[:110 * tcfg.subch] for f in got] == dev.pack_superframes(out, add_rs=False)
        tail = out["wire"][:, -4 * nau:].numpy().astype(np.int32)
        au_len = tail[:, :nau] | (tail[:, nau:2 * nau] << 8)
        au_bits = tail[:, 2 * nau:3 * nau] | (tail[:, 3 * nau:] << 8)
        assert (au_len.sum(1) + 2 * nau + dev.packer.header_bytes == dev.packer.total).all()
        assert ((au_bits[:, :-1] + 7) // 8 == au_len[:, :-1]).all()
        assert (au_bits <= 8 * dev.aupack_ctx.maxcb).all()
    for k in sh:
        assert torch.equal(sh[k], sd[k]), k


def test_device_mode_encoder_with_pads():
    """X-PAD through the step's pad_buf/pad_len arguments == the host pack."""
    tcfg, _ = configs(CASES[0], 16)
    host = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device="cpu")
    dev = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device="cpu", pack_on_device=True)
    rng = np.random.default_rng(11)
    sh, sd = host.init_state(), dev.init_state()
    for kind in ("noise", "tone"):
        pcm = make_signal(rng, S, 2, tcfg.num_aus * tcfg.au_samples, kind)
        pads = make_pads(rng, S, tcfg.num_aus)
        sh, want = host.encode_superframes(sh, pcm, pads=pads)
        sd, got = dev.encode_superframes(sd, pcm, pads=pads)
        assert got == want
    # no pads given: the DSE slots stay empty
    pcm = make_signal(rng, S, 2, tcfg.num_aus * tcfg.au_samples, "noise")
    assert dev.encode_superframes(sd, pcm)[1] == host.encode_superframes(sh, pcm)[1]


def test_dryrun_multichip_cpu(capsys):
    """Two shards of two streams, one after another on the CPU: their rows
    equal the unsplit batch's (dryrun_multichip raises otherwise)."""
    threads = torch.get_num_threads()
    dryrun_multichip(2, device="cpu")
    assert torch.get_num_threads() == threads
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(
        line.endswith("2 devices, 4 streams OK, 4 rows as the unsplit batch") for line in lines)


def test_dryrun_multichip_needs_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun_multichip(have + 1)


@pytest.mark.parametrize("device", ["meta", "cuda:1", "cpu:0"])
def test_dryrun_multichip_refuses_other_devices(device):
    """Only None, "cuda" (shard i on cuda:i) and "cpu" name a placement."""
    with pytest.raises(ValueError, match="device must be"):
        dryrun_multichip(1, device=device)
