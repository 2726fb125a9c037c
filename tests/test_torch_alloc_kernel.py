"""The MP2 bit-allocation kernel (mp2/alloc_kernel.py, csrc/mp2_alloc.cu) and
its router allocate.bit_allocation.

On the CPU: a scalar model of the kernel's per-station loop (the
joint-stereo walk-down, then the C greedy literally: first minimum wins,
the joint mirror above jsbound) equals the plain vectorised version
(js_mode_select + a_bit_allocation with its sorted-rung prefix and tail) on
mixed batches in float32 and float64; the router takes the plain version
for CPU tensors and counts no launch; the kernel's checks refuse a bad
dtype, shape or device; the kernel's tables are tables.py's; on the CPU the
step keeps the tail's span and has no kernel span.  On the card
(`-m cuda`): the kernel against the plain version run on the card on real
psy-1 outputs, and the psy-1 goldens through the kernel in float64.
Integers throughout: equal, no tolerance."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import convert, obs
from odr_audioenc_tpu_torch import tables as T
from odr_audioenc_tpu_torch.host import mp2parse
from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
from odr_audioenc_tpu_torch.mp2 import alloc_kernel as AK
from odr_audioenc_tpu_torch.mp2 import allocate as A
from odr_audioenc_tpu_torch.mp2 import model as M

import gen_golden
from signals import frames_of, loud_tones, music_like
from torch_cpu import one_torch_thread  # noqa: F401

SRC = Path(AK.__file__).resolve().parent.parent / "csrc" / "mp2_alloc.cu"
GOLDEN = Path(__file__).parent / "golden"
PSY1_GOLDENS = [n for n, c in gen_golden.CONFIGS.items() if c[5] == 1]

# the mux_mix bitrates in joint and stereo, mono, dual channel, 24 kHz
# (MPEG-2 LSF), 32 kHz, 44.1 kHz (padding slots) and X-PAD lengths
STREAMS = ([{"rate": 48000, "bitrate": b, "mode": m} for b in (128, 192, 96, 160) for m in "js"]
           + [{"rate": 48000, "bitrate": 96, "mode": "m"},
              {"rate": 48000, "bitrate": 64, "mode": "j"},
              {"rate": 48000, "bitrate": 128, "mode": "d"},
              {"rate": 48000, "bitrate": 256, "mode": "s"},
              {"rate": 24000, "bitrate": 64, "mode": "m"},
              {"rate": 24000, "bitrate": 160, "mode": "j"},
              {"rate": 32000, "bitrate": 64, "mode": "j"},
              {"rate": 44100, "bitrate": 128, "mode": "j"},
              {"rate": 44100, "bitrate": 160, "mode": "s"},
              {"rate": 48000, "bitrate": 128, "mode": "j", "pad_len": 16},
              {"rate": 48000, "bitrate": 96, "mode": "j", "pad_len": 58}])


def station_model(smr, scfsi, tablenum, sblimit, nch, is_joint, adb, dtype):
    """The kernel's loop for one station, one slot at a time: the walk-down
    of main_bit_allocation_new (bits_for_nonoise_new at jsbound = sblimit,
    16, 12, 8; the first that fits), then a_bit_allocation_new: pick the
    open slot of least MNR (the first in (ch, sb) order on ties; MNR at or
    above 999999 is never picked), allocate its next rung if the budget
    holds it or freeze it, mirror the pick above jsbound.  MNR in `dtype`.
    Returns (stereo, mode_ext, jsbound, bit_alloc [2, 32], adb_left)."""
    f = np.float32 if dtype == torch.float32 else np.float64
    snr = np.asarray(T.SNR, np.float64).astype(f)
    gbq = A._GBQ
    line = T.LINE[tablenum]
    nb = [0 if line[sb] < 0 else int(T.NBAL[line[sb]]) for sb in range(32)]
    maxa = [(1 << n) - 1 for n in nb]
    row = [T.STEP_INDEX[max(int(line[sb]), 0)] for sb in range(32)]
    sfs = [[int(T.SFS_PER_SCFSI[scfsi[ch][sb]]) for sb in range(32)] for ch in range(2)]
    smr = np.asarray(smr).astype(f)
    two = nch == 2

    def mnr(ch, sb, b):
        return snr[row[sb][b]] - smr[ch][sb]

    def first_rung(ch, sb):
        for k in range(maxa[sb] - 1):
            if mnr(ch, sb, k) >= 0:
                return k
        return max(maxa[sb] - 1, 0)

    stereo, ext, jsb = True, 0, sblimit
    if is_joint:
        idx = 4
        for i, v in enumerate((sblimit, 16, 12, 8)):
            bits = A.BANC + A.BERR
            for sb in range(sblimit):
                bits += nb[sb] * (nch if sb < v else 1)
                b = [first_rung(0, sb), first_rung(1, sb)]
                if sb >= v and two:
                    if max(b) > 0:
                        bits += int(gbq[row[sb][max(b)]]) + 4 + 6 * (sfs[0][sb] + sfs[1][sb])
                else:
                    for ch in range(nch):
                        if b[ch] > 0:
                            bits += int(gbq[row[sb][b[ch]]]) + 2 + 6 * sfs[ch][sb]
            if bits <= adb:
                idx = i
                break
        stereo = idx == 0
        ext = 0 if stereo else 4 - idx
        jsb = sblimit if stereo else int(T.JSB_TABLE[ext])

    ad = adb - (A.BANC + A.BERR + sum(nb[sb] * (nch if sb < jsb else 1)
                                      for sb in range(sblimit)))
    ba = np.zeros((2, 32), np.int64)
    used = [[0 if sb < sblimit and ch < nch and maxa[sb] > 0 else 2 for sb in range(32)]
            for ch in range(2)]
    m = [[mnr(ch, sb, 0) for sb in range(32)] for ch in range(2)]
    spent = 0
    while True:
        small, mch, msb = f(999999.0), -1, -1
        for ch in range(2):
            for sb in range(32):
                if used[ch][sb] != 2 and small > m[ch][sb]:
                    small, mch, msb = m[ch][sb], ch, sb
        if msb < 0:
            break
        js = msb >= jsb and two
        b, u = int(ba[mch][msb]), used[mch][msb]
        inc = int(gbq[row[msb][b + 1]]) - (int(gbq[row[msb][b]]) if u == 1 else 0)
        seli = 0 if u else (4 if js else 2)
        scale = 0 if u else 6 * sfs[mch][msb] + (6 * sfs[1 - mch][msb] if js else 0)
        if ad >= spent + seli + scale + inc:
            b += 1
            spent += inc + seli + scale
            u = 2 if b >= maxa[msb] else 1
        else:
            u = 2
        for ch in ((0, 1) if js else (mch,)):
            ba[ch][msb], used[ch][msb], m[ch][msb] = b, u, mnr(ch, msb, b)
    return stereo, ext, jsb, ba, ad - spent


def columns(cfg, xpad_len=None, extra=None, scale=1.0):
    """The router's per-station inputs from a Mp2Config as the encoder step
    builds them: tablenum, sblimit, nch, is_joint and adb (the frame's bits
    less the ScF-CRC and X-PAD bytes, plus a padding slot), the budget
    scaled to reach the walk-down's narrower jsbounds."""
    S = cfg.n_streams
    xpad_len = cfg.dab_length if xpad_len is None else xpad_len
    extra = np.zeros(S, np.int64) if extra is None else extra
    adb = (cfg.adb_full.astype(np.int64) - cfg.dab_ext * 8
           - np.where(xpad_len > 0, xpad_len, 2) * 8 + extra * 8)
    t = {k: torch.as_tensor(getattr(cfg, k).astype(np.int64)) for k in ("tablenum", "sblimit",
                                                                         "nch")}
    t["is_joint"] = torch.as_tensor(cfg.mode == M.MODE_JOINT)
    t["adb"] = torch.as_tensor((adb * scale).astype(np.int64))
    return t


def spreads(S, seed, dtype):
    """SMR spread over -25..45 dB with exact ties inside a channel and
    across the two channels (joint slots), and random scfsi codes."""
    rng = np.random.default_rng(seed)
    smr = rng.uniform(-25, 45, (S, 2, 32))
    smr[:, :, rng.integers(0, 32, 4)] = smr[:, :, :4]
    tie = rng.integers(0, 32, 6)
    smr[:, 1, tie] = smr[:, 0, tie]
    scfsi = rng.integers(0, 4, (S, 2, 32)).astype(np.int32)
    return torch.as_tensor(smr, dtype=dtype), torch.as_tensor(scfsi)


def plain(smr, scfsi, cols):
    ft = A._frame_tables(cols["tablenum"])
    stereo, ext, jsb = A.js_mode_select(smr, scfsi, ft, cols["sblimit"], cols["nch"],
                                        cols["is_joint"], cols["adb"])
    ba, left = A.a_bit_allocation(smr, scfsi, ft, cols["sblimit"], cols["nch"], jsb,
                                  cols["adb"])
    return stereo, ext, jsb, ba, left


def assert_model_equals(smr, scfsi, cols, got):
    """station_model on every station equals `got` (the five outputs)."""
    stereo, ext, jsb, ba, left = (t.cpu().numpy() for t in got)
    for s in range(smr.shape[0]):
        m = station_model(smr[s].cpu().numpy(), scfsi[s].cpu().numpy(),
                          int(cols["tablenum"][s]), int(cols["sblimit"][s]),
                          int(cols["nch"][s]), bool(cols["is_joint"][s]), int(cols["adb"][s]),
                          smr.dtype)
        assert (m[0], m[1], m[2]) == (stereo[s], ext[s], jsb[s]), f"station {s}: mode"
        assert np.array_equal(m[3], ba[s]), f"station {s}: {ba[s]} != {m[3]}"
        assert m[4] == left[s], f"station {s}: adb_left {left[s]} != {m[4]}"


# ---- the CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", [1.0, 0.8, 0.5])
def test_model_equals_plain_on_spreads(dtype, scale):
    """Mixed batch (STREAMS twice: X-PAD lengths and padding slots vary),
    SMR spreads with ties, budgets at 100%, 80% and 50% of the frame's; the
    joint stations' walk-down ends in more than one place at each."""
    cfg = M.make_config(STREAMS * 2)
    S = cfg.n_streams
    rng = np.random.default_rng(int(scale * 100))
    xpad = np.where(rng.random(S) < 0.3, rng.integers(0, 59, S), cfg.dab_length)
    extra = np.where(cfg.slots_frac != 0, rng.integers(0, 2, S), 0)
    cols = columns(cfg, xpad, extra, scale)
    smr, scfsi = spreads(S, 3 + int(scale * 10), dtype)
    got = plain(smr, scfsi, cols)
    joint = cols["is_joint"]
    assert len(set(zip(got[0][joint].tolist(), got[1][joint].tolist()))) >= 2
    assert_model_equals(smr, scfsi, cols, got)


def capture(enc, pcm):
    """The router's inputs of each step of `enc` over pcm [n, S, 2, 1152]
    (the encoder's own psy-1 SMR, scfsi and budgets), the plain version's
    outputs with them."""
    kept, routed = [], A.bit_allocation

    def keep(smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb):
        out = routed(smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb)
        kept.append(((smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb), out))
        return out
    A.bit_allocation = keep
    try:
        state = enc.init_state()
        for f in pcm:
            state, _ = enc.encode_step(state, f)
    finally:
        A.bit_allocation = routed
    return kept


def mixed_pcm(S, n, seed):
    """[n, S, 2, 1152] int16: music and loud tones, each station at its own
    offset."""
    sig = np.concatenate([frames_of(music_like(n + 8, seed=seed)),
                          frames_of(loud_tones(n + 8, seed=seed))])
    return np.stack([sig[(7 * s) % (len(sig) - n) + np.arange(n)] for s in range(S)], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_model_equals_plain_on_psy1_outputs(dtype):
    """The encoder's own psy-1 SMR over 3 frames of the mixed batch."""
    cfg = M.make_config(STREAMS)
    enc = M.Mp2Encoder(cfg, psy_model=1, dtype=dtype, device="cpu")
    for (smr, scfsi, _, tablenum, sblimit, nch, is_joint, adb), out in \
            capture(enc, mixed_pcm(cfg.n_streams, 3, 5)):
        cols = dict(tablenum=tablenum, sblimit=sblimit, nch=nch, is_joint=is_joint, adb=adb)
        assert_model_equals(smr, scfsi, cols, out)


def test_router_takes_the_plain_version_on_cpu(monkeypatch):
    """A CPU tensor takes js_mode_select + a_bit_allocation and never the
    kernel; the launch count stays; a tensor elsewhere (meta) raises."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(AK, "allocate", no_kernel)
    cfg = M.make_config(STREAMS)
    cols = columns(cfg)
    smr, scfsi = spreads(cfg.n_streams, 1, torch.float32)
    ft = A._frame_tables(cols["tablenum"])
    before = AK.launches
    got = A.bit_allocation(smr, scfsi, ft, cols["tablenum"], cols["sblimit"], cols["nch"],
                           cols["is_joint"], cols["adb"])
    want = plain(smr, scfsi, cols)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert AK.launches == before
    meta = {k: v.to("meta") for k, v in cols.items()}
    with pytest.raises(ValueError):
        A.bit_allocation(smr.to("meta"), scfsi.to("meta"), ft, meta["tablenum"],
                         meta["sblimit"], meta["nch"], meta["is_joint"], meta["adb"])


def test_kernel_checks_refuse_what_it_does_not_take():
    """check_inputs (run before every launch) raises TypeError on smr other
    than float32/float64, scfsi other than int32 or a column in another
    dtype, and ValueError on a wrong shape, a non-contiguous tensor, or
    tensors off a CUDA card (the CPU here, and meta)."""
    cfg = M.make_config(STREAMS)
    S = cfg.n_streams

    def args(**over):
        smr, scfsi = spreads(S, 2, torch.float32)
        a = dict(smr=smr, scfsi=scfsi, **columns(cfg))
        a.update({k: v(a[k]) for k, v in over.items()})
        return a
    for bad in (dict(smr=lambda t: t.half()), dict(smr=lambda t: t.long()),
                dict(scfsi=lambda t: t.long()), dict(tablenum=lambda t: t.int()),
                dict(nch=lambda t: t.int()), dict(is_joint=lambda t: t.long()),
                dict(adb=lambda t: t.int()), dict(sblimit=lambda t: t.double())):
        with pytest.raises(TypeError):
            AK.check_inputs(**args(**bad))
    for bad in (dict(smr=lambda t: t[..., :31].contiguous()),
                dict(smr=lambda t: t.reshape(S, 64)),
                dict(scfsi=lambda t: t[:-1].contiguous()),
                dict(adb=lambda t: t[:-1].contiguous()),
                dict(is_joint=lambda t: t[:, None].contiguous()),
                dict(smr=lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(sblimit=lambda t: t.repeat(2)[::2])):
        with pytest.raises(ValueError):
            AK.check_inputs(**args(**bad))
    with pytest.raises(ValueError, match="CUDA"):
        AK.check_inputs(**args())
    with pytest.raises(ValueError, match="CUDA"):
        AK.check_inputs(**{k: v.to("meta") for k, v in args().items()})
    with pytest.raises(ValueError):
        AK.allocate(*args().values())


def test_kernel_tables_are_tables_py():
    """Every __constant__ table of csrc/mp2_alloc.cu, parsed from the
    source, equals its counterpart in tables.py and allocate.py, as do the
    header and CRC bits."""
    src = SRC.read_text()
    tabs = {m[1]: np.array([float(x) for x in re.findall(r"-?\d+(?:\.\d+)?", m[2])])
            for m in re.finditer(r"__constant__ \w+ (\w+)\[[^=]*= \{(.*?)\};", src, re.S)}
    want = {"LINE_T": T.LINE, "NBAL_T": T.NBAL, "STEP_INDEX_T": T.STEP_INDEX, "SNR_T": T.SNR,
            "GBQ_T": A._GBQ, "SFS_T": T.SFS_PER_SCFSI, "JSB_T": T.JSB_TABLE}
    assert set(tabs) == set(want)
    for k, v in want.items():
        assert np.array_equal(tabs[k], np.asarray(v, np.float64).ravel()), k
    defs = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert (defs["SB"], defs["NTAB"], defs["NLINE"], defs["NSTEP"]) == (
        A.SBLIMIT, *T.LINE.shape[:1], *T.NBAL.shape, *T.SNR.shape)
    assert (defs["BANC"], defs["BERR"]) == (A.BANC, A.BERR)


def test_cpu_step_keeps_the_tail_span():
    """On the CPU the step's allocation is the plain version: mp2.alloc
    holds mp2.alloc.tail (with its passes) and no mp2.alloc.kernel."""
    cfg = M.make_config(STREAMS[:4])
    enc = M.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device="cpu")
    obs.clear()
    with obs.enabled():
        state = enc.init_state()
        for f in mixed_pcm(cfg.n_streams, 2, 9):
            state, _ = enc.encode_step(state, f)
    names = [sp.name for sp in obs.spans()]
    assert "mp2.alloc.kernel" not in names
    tails = [sp for sp in obs.spans() if sp.name == "mp2.alloc.tail"]
    assert len(tails) == 2 and all(sp.parent.name == "mp2.alloc" for sp in tails)
    assert all(sp.counts["passes"] >= 1 for sp in tails)
    obs.clear()


# ---- the card -----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    """S=512 mixed batch (STREAMS cycled) over 4 frames of music and tones,
    psy 1 on the card: at each step the router launched the kernel once,
    inside a mp2.alloc.kernel span, and its five outputs equal the plain
    version's run on the card on the same inputs, station for station."""
    dev = _card()
    cfg = M.make_config([STREAMS[i % len(STREAMS)] for i in range(512)])
    enc = M.Mp2Encoder(cfg, psy_model=1, dtype=dtype, device=dev)
    before = AK.launches
    obs.clear()
    with obs.enabled():
        kept = capture(enc, mixed_pcm(cfg.n_streams, 4, 21))
    torch.cuda.synchronize()
    assert AK.launches == before + 4
    assert [sp.counts for sp in obs.spans() if sp.name == "mp2.alloc.kernel"] == \
        [{"launches": 1}] * 4
    assert not any(sp.name == "mp2.alloc.tail" for sp in obs.spans())
    obs.clear()
    for (smr, scfsi, ft, tablenum, sblimit, nch, is_joint, adb), got in kept:
        cols = dict(tablenum=tablenum, sblimit=sblimit, nch=nch, is_joint=is_joint, adb=adb)
        want = plain(smr, scfsi, cols)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PSY1_GOLDENS)
def test_golden_byte_exact_through_the_kernel_on_card(name):
    """The exact float64 path on the card, its allocation in the kernel (one
    launch per frame), reproduces the psy-1 golden stream byte for byte."""
    dev = _card()
    _, _, rate, bitrate, mode, _, xpad_len = gen_golden.CONFIGS[name]
    frames, xpads = gen_golden.make_input(name)
    cfg = M.make_config([{"rate": rate, "bitrate": bitrate, "mode": mode,
                          "pad_len": xpad_len}])
    enc = M.Mp2Encoder(cfg, psy_model=1, dtype=torch.float64, device=dev)
    packer = Mp2Packer(cfg)
    state, chunks = enc.init_state(), []
    before = AK.launches
    for fi, f in enumerate(frames):
        state, out = enc.encode_step(state, f[None], np.array([xpad_len], np.int32))
        chunks += packer.emit(convert.to_numpy(out), [xpads[fi]] if xpads else None)
    chunks += packer.finish()
    assert AK.launches == before + len(frames)
    got, want = b"".join(chunks), (GOLDEN / f"{name}.mp2").read_bytes()
    bad = [i for i, (a, b) in enumerate(zip(mp2parse.split_frames(got),
                                            mp2parse.split_frames(want))) if a != b]
    assert got == want, f"{name}: frames {bad[:5]} differ"
