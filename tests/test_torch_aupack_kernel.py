"""The DAB+ AU-pack kernel (dabplus/aupack_kernel.py, csrc/au_pack.cu) and
its router aupack.pack_au.

On the CPU: the router takes the slot-grid pack for CPU tensors and counts
no launch; the kernel's checks refuse a bad dtype, shape or device; the
numpy model of the kernel's CRC (a byte table over each thread's slice,
shifted and XORed) equals bitpack.crc_fixed; the kernel's table follows
the source and the context.  On the card (`-m cuda`): on
real encoder outputs the kernel's (aubuf, au_bits, crc_part) equal the
slot-grid pack run on the card, station for station.  Integers throughout:
equal, no tolerance."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import bitpack as BP
from odr_audioenc_tpu_torch.dabplus import aupack as TA
from odr_audioenc_tpu_torch.dabplus import aupack_kernel as AK
from odr_audioenc_tpu_torch.dabplus import model as TM

from torch_cpu import one_torch_thread  # noqa: F401

LC96 = dict(sample_rate=48000, subch=12, channels=2)
SBR48 = dict(sample_rate=48000, subch=6, channels=1, aot="sbr")
PS32 = dict(sample_rate=48000, subch=4, channels=2, aot="ps")
SRC = Path(AK.__file__).resolve().parent.parent / "csrc" / "au_pack.cu"


def signals(rng, S, ch, n):
    """Per station one of four signals: loud noise (book-11 escapes), a
    quiet bed with a 300-sample burst (short windows), a tone (TNS), quiet."""
    x = np.zeros((S, ch, n), np.int16)
    t = np.arange(n) / 48000.0
    for s in range(S):
        kind = s % 4
        if kind == 0:
            x[s] = rng.integers(-16000, 16000, (ch, n))
        elif kind == 1:
            x[s] = rng.integers(-200, 200, (ch, n))
            at = int(rng.integers(0, n - 300))
            x[s, :, at:at + 300] += (14000 * np.sin(2 * np.pi * 3000 * t[:300])).astype(np.int16)
        elif kind == 2:
            x[s] = (11000 * np.sin(2 * np.pi * rng.uniform(200, 4000) * t)).astype(np.int16)
        else:
            x[s] = rng.integers(-60, 60, (ch, n))
    return x


def au_inputs(cfg, S, n_sf, device, seed=0):
    """A host-mode encoder's outputs on `device` over n_sf superframes of
    `signals`: (its pack tables, [(per-AU decisions as pack_au takes them,
    the AU's FIL slots or None, is_last)])."""
    tcfg = TM.DabPlusConfig(**cfg)
    enc = TM.DabPlusEncoder(tcfg, S, dtype=torch.float32, device=device)
    ctx = TA.AuPackCtx(enc)
    rng = np.random.default_rng(seed)
    st, aus = enc.init_state(), []
    for _ in range(n_sf):
        pcm = signals(rng, S, tcfg.channels, tcfg.num_aus * tcfg.au_samples)
        st, out = enc.encode_superframes(st, pcm, pack=False)
        sw = sv = None
        if enc.is_sbr:
            sw, sv = TA.sbr_slot_groups(ctx, {k: v for k, v in out.items()
                                              if k.startswith(("sbr_", "ps_"))})
        for a in range(tcfg.num_aus):
            fr = {k: out[k][:, a].to(torch.bool if k in AK.BOOL_KEYS else torch.int32)
                  .contiguous() for k in TA.CORE_KEYS}
            aus.append((fr, (sw[:, a], sv[:, a]) if sw is not None else None,
                        a == tcfg.num_aus - 1))
    return ctx, aus


def plain(ctx, fr, is_last, pad_buf=None, pad_len=None, sbr_group=None):
    groups = TA.au_content_groups(ctx, fr, is_last, pad_buf=pad_buf, pad_len=pad_len,
                                  sbr_group=None if sbr_group is None else (*sbr_group, 4))
    buf, bits, crc = TA.pack_au_content(ctx, groups)
    return buf.to(torch.uint8), bits, crc


# ---- the CPU ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lc_cpu():
    return au_inputs(LC96, 4, 1, "cpu", seed=3)


def test_router_takes_the_plain_pack_on_cpu(lc_cpu):
    """aupack.pack_au on CPU tensors: the slot-grid pack's bytes (as uint8),
    bit counts and CRC reductions, and no kernel launch."""
    ctx, aus = lc_cpu
    before = AK.launches
    for fr, _, last in aus:
        got = TA.pack_au(ctx, fr, last)
        want = plain(ctx, fr, last)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].dtype == torch.uint8 and got[1].dtype == got[2].dtype == torch.int32
    assert AK.launches == before


def test_checks_refuse_what_the_kernel_does_not_take(lc_cpu):
    ctx, aus = lc_cpu
    fr, _, last = aus[0]

    def refused(exc, what, **change):
        o = dict(fr, **{k: v for k, v in change.items() if k in fr})
        kw = {k: v for k, v in change.items() if k not in fr}
        with pytest.raises(exc, match=what):
            TA.pack_au(ctx, o, kw.pop("is_last", last), **kw)

    refused(TypeError, "q is torch.int64", q=fr["q"].long())
    refused(TypeError, "ms_used is torch.int32", ms_used=fr["ms_used"].int())
    refused(TypeError, "is_last is torch.int64", is_last=torch.zeros(4, dtype=torch.long))
    refused(ValueError, r"books is \(4, 2, 50\)", books=torch.zeros((4, 2, 50), dtype=torch.int32))
    refused(ValueError, r"wseq is \(5,\)", wseq=torch.zeros(5, dtype=torch.int32))
    refused(ValueError, r"is_last is \(3,\)", is_last=torch.ones(3, dtype=torch.bool))
    refused(ValueError, r"tns_idx is \(4, 2\)", tns_idx=torch.zeros((4, 2), dtype=torch.int32))
    refused(ValueError, "FIL group's widths and values differ",
            sbr_group=(torch.zeros((4, 5), dtype=torch.int32),
                       torch.zeros((4, 6), dtype=torch.int32)))
    refused(ValueError, "q is not contiguous", q=fr["q"].transpose(0, 1).contiguous()
            .transpose(0, 1))
    refused(ValueError, "pad_buf and pad_len", pad_buf=torch.zeros((4, 8), dtype=torch.int32))
    refused(ValueError, "rows are not contiguous",
            pad_buf=torch.zeros((8, 4), dtype=torch.int32).t(),
            pad_len=torch.zeros(4, dtype=torch.int32))
    refused(ValueError, "tensors on", q=fr["q"].to("meta"))
    with pytest.raises(ValueError, match="the CPU or a CUDA card"):
        TA.pack_au(ctx, {k: v.to("meta") for k, v in fr.items()}, last)
    # the kernel itself takes CUDA tensors only
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        AK.pack_au(ctx, fr, last)


@pytest.mark.parametrize("maxcb", [32, 256, 832, 1344])
def test_crc_model_equals_crc_fixed(maxcb):
    """The kernel's CRC, modelled in numpy: per thread a byte-table CRC of
    its slice of the buffer, shifted by x^(8 * bytes after it), XORed over
    the block, equals crc_fixed's bit product; also where the slices are
    ragged (maxcb not a multiple of the threads) and where threads have no
    bytes."""
    rng = np.random.default_rng(maxcb)
    buf = rng.integers(0, 256, (6, maxcb))
    buf[0] = 0
    buf[1, : maxcb // 2] = 0
    tab = np.concatenate([np.zeros(AK.TABLE_FIXED - 256, np.int64), TA._crc16_bytes(),
                          TA._xpow8(maxcb)])
    want = BP.crc_fixed(torch.as_tensor(buf), torch.as_tensor(TA._crc16_R_np(8 * maxcb),
                                                                 dtype=torch.float32), 16, 0)
    got = AK.crc_model(buf, tab)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(AK.crc_model(buf[2:], tab, threads=7), want.numpy()[2:])


def test_table_follows_the_source_and_the_context():
    """Each T_* offset in csrc/au_pack.cu is TABLE_LAYOUT's, THREADS is the
    source's, and the context's table holds its own lookups in that
    order, the CRC byte table and x^(8j) mod g for j up to maxcb."""
    src = SRC.read_text()
    defs = {m[0]: int(m[1]) for m in re.findall(r"#define (T_\w+|THREADS) (\d+)", src)}
    names = ("T_Q12 T_Q34 T_P56 T_PAIR T_SCF T_BOP_L T_BOP_S T_PERM_S T_TX_L T_TX_S T_GS_L "
             "T_GS_S T_CRC").split()
    off = 0
    for name, (_, n) in zip(names, AK.TABLE_LAYOUT):
        assert defs[name] == off, name
        off += n
    assert defs["T_XP8"] == AK.TABLE_FIXED == off and defs["THREADS"] == AK.THREADS
    enc = TM.DabPlusEncoder(TM.DabPlusConfig(**LC96), 1, device="cpu", pack_on_device=True)
    ctx = enc.aupack_ctx
    tab = ctx.kernel_table.numpy()
    assert tab.dtype == np.int32 and tab.shape == (AK.TABLE_FIXED + ctx.maxcb + 1,)
    parts = dict(q12=ctx.q12, q34=ctx.q34, p56=ctx.p56, pair=ctx.pair_tab, scf=ctx.scf_tab,
                 bop_long=ctx.bop_long, bop_short=ctx.bop_short, perm_short=ctx.perm_short,
                 tx_long=ctx.tx_long, tx_short=ctx.tx_short, gstart_long=ctx.gstart_long,
                 gstart_short=ctx.gstart_short)
    off = 0
    for name, n in AK.TABLE_LAYOUT:
        if name in parts:
            np.testing.assert_array_equal(tab[off:off + n], parts[name].reshape(-1).numpy(),
                                          name)
        off += n
    crc_t = tab[off - 256:off]
    assert [int(crc_t[i]) for i in (0, 1, 0x80, 0xFF)] == [0, 0x1021, 0x9188, 0x1EF0]
    np.testing.assert_array_equal(tab[off:], TA._xpow8(ctx.maxcb))


# ---- the card -----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def compare(ctx, fr, is_last, **kw):
    """Kernel (through the router) against the slot-grid pack on the card on
    the same inputs: one launch, the same dtypes, every station equal."""
    before = AK.launches
    got = TA.pack_au(ctx, fr, is_last, **kw)
    torch.cuda.synchronize()
    assert AK.launches == before + 1
    want = plain(ctx, fr, is_last, **kw)
    for g, w, what in zip(got, want, ("aubuf", "au_bits", "crc_part")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), (what, (g != w).reshape(g.shape[0], -1).any(1)
                                   .nonzero().flatten()[:8].tolist())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [LC96, SBR48, PS32], ids=["lc96", "sbr48", "ps32"])
def test_kernel_matches_the_slot_grid_pack_on_card(cfg):
    """S=64 over 2 superframes of four signals: LC stereo (CPE, M/S, long
    and short windows, TNS, book-11 escapes, one AU forced to carry
    escapes), HE-AAC mono with its SBR FIL group, HE-AAC v2 with PS in it;
    is_last as a bool, and as an [S] and a one-element tensor."""
    ctx, aus = au_inputs(cfg, 64, 2, _card(), seed=7)
    q = torch.stack([fr["q"] for fr, _, _ in aus])
    wseq = torch.stack([fr["wseq"] for fr, _, _ in aus])
    assert bool((wseq == 2).any()) and bool((wseq != 2).any()), "long and short windows"
    if cfg is LC96:
        assert bool(torch.stack([fr["tns_en"] for fr, _, _ in aus]).any()), "TNS on"
        fr = aus[0][0]                      # station 5, AU 0: book 11 with escapes, band 3
        lo, hi = (int(x) for x in TA.AT.sfb_offsets(48000)[3:5])
        fr["wseq"][5] = 0
        fr["books"][5, :, 3] = 11
        fr["q"][5, :, lo:hi] = torch.as_tensor([300, -5000, 17, 16, -8191, 40, -16, 0][:hi - lo],
                                               dtype=torch.int32, device=q.device)
        q = torch.stack([fr["q"] for fr, _, _ in aus])
    assert bool((q.abs() >= 16).any()) or cfg is not LC96
    S = q.shape[1]
    for i, (fr, sbr, last) in enumerate(aus):
        compare(ctx, fr, last, sbr_group=sbr)
        if i % 3 == 0:
            alt = torch.arange(S, device=q.device) % 2 == i % 2
            compare(ctx, fr, alt, sbr_group=sbr)
            compare(ctx, fr, torch.tensor([not last], device=q.device), sbr_group=sbr)


@pytest.mark.cuda
def test_kernel_with_xpad_on_card():
    """LC 96k with a 58-byte X-PAD DSE: pad_len 0 to 58 (both ends on some
    station), the pad rows as the model slices them ([S, nau, 58][:, a])."""
    dev = _card()
    cfg = dict(LC96, pad_len=58)
    ctx, aus = au_inputs(cfg, 32, 1, dev, seed=8)
    nau = TM.DabPlusConfig(**cfg).num_aus
    rng = np.random.default_rng(9)
    pb = torch.as_tensor(rng.integers(0, 256, (32, nau, 58)).astype(np.int32), device=dev)
    pl = torch.as_tensor(rng.integers(0, 59, (32, nau)).astype(np.int32), device=dev)
    pl[0], pl[1] = 58, 0
    for a, (fr, _, last) in enumerate(aus):
        compare(ctx, fr, last, pad_buf=pb[:, a], pad_len=pl[:, a])


@pytest.mark.cuda
def test_kernel_over_the_bound_on_card():
    """An AU past the pack bound (station 1: every band book 11 at 8191):
    au_bits equal the slot-grid pack's (over 8 maxcb, so pack_superframes
    warns), the bytes past maxcb are dropped in both, and every other
    station's row is what it was without the forced station."""
    ctx, aus = au_inputs(LC96, 8, 1, _card(), seed=10)
    fr, _, last = aus[2]
    good = compare(ctx, fr, last)
    big = {k: v.clone() for k, v in fr.items()}
    big["wseq"][1] = 0
    big["books"][1, :, :ctx.max_sfb] = 11
    big["gains"][1] = 10
    big["q"][1, :, :int(ctx.sfb_off[ctx.max_sfb])] = 8191
    got = compare(ctx, big, last)
    assert int(got[1][1]) > 8 * ctx.maxcb and bool((got[1][[0, 2, 3, 4, 5, 6, 7]] <= 8 * ctx.maxcb)
                                                   .all())
    rest = torch.arange(8) != 1
    for g, w in zip(got, good):
        assert torch.equal(g[rest], w[rest])
    assert not torch.equal(got[0][1], good[0][1])
