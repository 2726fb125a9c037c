"""The DAB+ rate loop's split (encode.au_psy -> RateInputs -> encode.rate_loop)
and its CUDA kernel (dabplus/rate_kernel.py, csrc/rate_loop.cu).

On the CPU: the plain loop is per-station independent (the premise of one
block per station), the router takes the plain version for CPU tensors and
the kernel's checks refuse what it does not take, au_psy's input
layout, the kernel's ladder and Huffman tables.  On the card (`-m cuda`):
the kernel against the plain version run on the card on the same inputs."""
import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch.dabplus import encode as E
from odr_audioenc_tpu_torch.dabplus import model as TM
from odr_audioenc_tpu_torch.dabplus import rate_kernel as RK
from odr_audioenc_tpu_torch.dabplus import tables as AT

from torch_cpu import one_torch_thread  # noqa: F401


def _psy_args(S, ch=2, seed=0, short_every=3, device="cpu", dtype=torch.float32,
              budget=None, with_short=True):
    """encode_au's arguments for S stations of a 48 kHz LC encoder with PNS
    (64 kbit/s stereo, 48 kbit/s mono), tilted noise spectra of levels
    spread over 50 dB; every `short_every`-th station short-block, the
    weighting and pre-echo state armed."""
    cfg = TM.DabPlusConfig(48000, 8 if ch == 2 else 6, ch)
    enc = TM.DabPlusEncoder(cfg, S, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(2.0, 4.5, (S, 1, 1))
    tilt = np.exp(-np.arange(AT.N) / rng.uniform(150.0, 600.0, (S, 1, 1)))
    spec = torch.as_tensor(rng.normal(0.0, 1.0, (S, ch, AT.N)) * amp * tilt, dtype=dtype,
                           device=device)
    seq = torch.zeros(S, dtype=torch.int64, device=device)
    if short_every:
        seq[::short_every] = 2
    pt, short_ctx = enc.tables()
    st = enc.init_state()
    if budget is None:
        budget = torch.full((S,), enc.budget_au, dtype=torch.int32, device=device)
    return enc, dict(spec=spec, pt=pt, band_m=enc.band_m, bol=enc.bol,
                     max_sfb=torch.full((S,), enc.max_sfb, dtype=torch.int32, device=device),
                     budget_bits=budget,
                     n_ch=torch.full((S,), ch, dtype=torch.int32, device=device),
                     tns_cfg=enc.tns_cfg, short_ctx=short_ctx if with_short else None,
                     is_short=seq == 2, modify_minsnr=enc.modify_minsnr,
                     pre_state=(st["thr_nm1"], st["pre_flag"] | True), seq=seq,
                     weight_state=st["wgt_last"] | True)


def _inputs(S, **kw):
    return E.au_psy(**_psy_args(S, **kw)[1])[0]


def decision_bits(inp, q, gains, books):
    """The AU bits of the decisions (q, gains, books) by the plain bit
    counter: each coded non-PNS band's cost in its book, the side info of
    the books and transmitted gains, TNS, the element's fixed bits, ID_END
    and the byte-align allowance."""
    cost = E.spectral_bits_and_books(q, inp.bctx, inp.bsel, return_cost=True)
    coded = inp.bsel & ~inp.pns_mask
    bb = torch.where(coded, cost.gather(-1, books.clamp(max=11).long()[..., None])[..., 0], 0)
    side = E.side_info_bits(books, gains, inp.bsel, sect_hdr=inp.sect_hdr_c,
                            force_break=inp.force_break, is_short=inp.is_short_c)
    return (bb.sum(-1) + side + inp.tns_bits).sum(-1) + inp.elem_fixed + 3 + 7


# ---- the CPU ------------------------------------------------------------------------

def test_plain_loop_is_per_station():
    """encode_au on 12 stations (stereo, long and short blocks mixed, PNS,
    one station over an unfittable budget so that crash recovery runs)
    equals encode_au on the two halves, station for station: every integer
    output, and the float ones within 1e-12 (float64 on one CPU thread: the
    psy's matmuls may round by batch size)."""
    S = 12
    enc, args = _psy_args(S, seed=5, dtype=torch.float64)
    args["budget_bits"][4] = 150
    whole = E.encode_au(**args)
    assert whole["recovered"]
    halves = []
    for sl in (slice(0, 6), slice(6, 12)):
        a = dict(args, spec=args["spec"][sl], max_sfb=args["max_sfb"][sl],
                 budget_bits=args["budget_bits"][sl], n_ch=args["n_ch"][sl],
                 is_short=args["is_short"][sl], seq=args["seq"][sl],
                 pre_state=tuple(t[sl] for t in args["pre_state"]),
                 weight_state=args["weight_state"][sl])
        halves.append(E.encode_au(**a))
    for k, v in whole.items():
        if isinstance(v, torch.Tensor):
            cat = torch.cat([h[k] for h in halves])
            if v.dtype.is_floating_point:
                torch.testing.assert_close(v, cat, rtol=1e-12, atol=0, msg=k)
            else:
                assert torch.equal(v, cat), k


def test_decision_bits_recount_the_plain_loop():
    """The recount the card tests hold the kernel to gives the plain loop's
    own bits on its own decisions (long and short blocks, PNS, f32)."""
    inp = _inputs(24, seed=2)
    q, gains, books, bits = E.rate_loop_plain(inp)
    assert torch.equal(decision_bits(inp, q, gains, books), bits)


def test_rate_loop_routes_cpu_to_plain(monkeypatch):
    """A CPU tensor takes the plain version and never the kernel; the
    launch count stays; a tensor elsewhere (meta) raises."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(RK, "rate_loop", no_kernel)
    inp = _inputs(6, seed=1)
    before = RK.launches
    got = E.rate_loop(inp, 2)
    want = E.rate_loop_plain(inp, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert RK.launches == before
    for k, v in inp.tensors().items():
        setattr(inp, k, v.to("meta"))
    with pytest.raises(ValueError):
        E.rate_loop(inp)


def test_kernel_checks_refuse_what_it_does_not_take():
    """check_inputs (run before every launch) raises TypeError on a float
    dtype other than float32/float64 or a mixed one, and ValueError on a
    non-contiguous tensor, a band count other than NB, 3 channels, or a
    wrong station count; it takes float32 and float64 inputs as built."""
    for dtype in (torch.float32, torch.float64):
        RK.check_inputs(_inputs(4, seed=3, dtype=dtype))

    def broken(**fields):
        inp = _inputs(4, seed=3)
        for k, v in fields.items():
            setattr(inp, k, v(getattr(inp, k)))
        return inp
    with pytest.raises(TypeError):
        RK.check_inputs(broken(**{k: (lambda t: t.half()) for k in
                                  ("mag075", "absx", "thr4", "cap_thr", "floor29", "hole_rank",
                                   "hole_thr", "wgt", "log_ffak", "scf_corr", "thr")}))
    with pytest.raises(TypeError):
        RK.check_inputs(broken(thr4=lambda t: t.double()))
    with pytest.raises(TypeError):
        RK.check_inputs(broken(pns_nrg=lambda t: t.long()))
    with pytest.raises(ValueError):
        RK.check_inputs(broken(thr=lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError):
        RK.check_inputs(broken(cap_thr=lambda t: t[..., :E.NB - 1].contiguous()))
    with pytest.raises(ValueError):
        RK.check_inputs(broken(**{k: (lambda t: torch.cat([t, t[:, :1]], 1)) for k in
                                  E.RateInputs.LINE + E.RateInputs.BAND}))
    with pytest.raises(ValueError):
        RK.check_inputs(broken(budget_bits=lambda t: t[:3]))


@pytest.mark.parametrize("ch,short", [(2, False), (2, True), (1, False), (1, True)])
def test_rate_inputs_layout(ch, short):
    """au_psy's RateInputs for long-only (no short-block tables), mixed,
    mono and stereo batches: every tensor contiguous, in its documented
    dtype and shape; the optional fields None exactly where documented."""
    S = 5
    inp = _inputs(S, ch=ch, with_short=short, short_every=2 if short else 0)
    f = torch.float32
    want = {k: ((S, ch, AT.N), torch.bool if k in ("neg", "pns_line") else f)
            for k in E.RateInputs.LINE}
    want.update({k: ((S, ch, E.NB), f) for k in E.RateInputs.BAND})
    want.update(no_ah=((S, ch, E.NB), torch.bool), pns_mask=((S, ch, E.NB), torch.bool),
                pns_nrg=((S, ch, E.NB), torch.int32), bsel=((S, 1, E.NB), torch.bool))
    if short:
        want.update(force_break=((S, 1, E.NB), torch.bool), is_short=((S,), torch.bool))
    ts = inp.tensors()
    for k, (shape, dtype) in want.items():
        assert tuple(ts[k].shape) == shape and ts[k].dtype == dtype, k
    for k in ("sect_hdr", "elem_fixed", "budget_bits"):
        if k in ts:
            assert tuple(ts[k].shape) == (S,) and not ts[k].dtype.is_floating_point, k
    assert tuple(ts["tns_bits"].shape) == (S, ch) and not ts["tns_bits"].dtype.is_floating_point
    assert all(t.is_contiguous() for t in ts.values())
    if short:
        assert inp.ladders[1] is not None and "sect_hdr" in ts
    else:
        assert inp.force_break is None and inp.is_short is None and inp.sect_hdr == E.SECT_BITS
        assert inp.ladders[1] is None
    assert inp.ladders[0].shape == (AT.N,)
    RK.check_inputs(inp)


def test_ladder_table_lists_each_bands_quads():
    """ladder_table of every rate's long and short ladders: each line's
    band, the quads of band b at quads[qoff[b]:qoff[b + 1]] in line order
    and in no other band; a ladder whose quad straddles two bands raises."""
    for rate in (48000, 32000, 24000, 16000):
        tab = RK.ladder_table(AT.band_of_line(rate), AT.short_band_of_line(rate))
        for r, bol in enumerate((AT.band_of_line(rate), AT.short_band_of_line(rate))):
            assert (tab[r, :AT.N] == bol).all()
            quads, qoff = tab[r, AT.N:AT.N + 240], tab[r, AT.N + 240:AT.N + 240 + E.NB + 1]
            assert sorted(quads.tolist()) == list(range(240)) and qoff[-1] == 240
            for b in range(E.NB):
                mine = quads[qoff[b]:qoff[b + 1]].astype(int)
                assert (np.diff(mine) > 0).all() and (bol[4 * mine] == b).all()
                assert len(mine) == (bol == b).sum() // 4
    long_only = RK.ladder_table(AT.band_of_line(48000))
    assert (long_only[0] == long_only[1]).all()
    bad = AT.band_of_line(48000).copy()
    bad[5] = bad[4] + 1
    with pytest.raises(ValueError):
        RK.ladder_table(bad)


def test_rate_table_layout():
    """encode._RATE_TABLE holds the Huffman lengths and book limits in
    rate_kernel.TABLE_LAYOUT's order and sizes."""
    tab = E._RATE_TABLE
    assert tab.dtype == np.int32 and tab.shape == (RK.TABLE_LEN,)
    parts = dict(quad=E._LEN_QUAD_T.ravel(), pair56=E._LEN_PAIR56_T.ravel(),
                 pair17=E._LEN_PAIR17.ravel(), scf=E._LEN_SCF,
                 book_lim=np.array([0, 1, 1, 2, 2, 4, 4, 7, 7, 12, 12, 8191]))
    off = 0
    for name, n in RK.TABLE_LAYOUT:
        assert (tab[off:off + n] == parts[name]).all(), name
        off += n


# ---- the card -----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _compare(inp, rounds):
    """Kernel (through encode.rate_loop) vs the plain version on the card on
    the same inputs.  Returns the share of stations with q, gains and books
    all equal, after the checks every comparison makes."""
    before = RK.launches
    got = E.rate_loop(inp, rounds)
    torch.cuda.synchronize()
    assert RK.launches == before + 1
    want = E.rate_loop_plain(inp, rounds)
    q, gains, books, bits = got
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    budget = inp.budget_bits
    assert bool(((bits <= budget) | (want[3] > budget)).all()), "over budget where plain fits"
    assert torch.equal(decision_bits(inp, q, gains, books), bits), "bits != their recount"
    same = (q == want[0]).flatten(1).all(1) & (gains == want[1]).flatten(1).all(1) \
        & (books == want[2]).flatten(1).all(1)
    return float(same.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [E.REFINE_ROUNDS, 0])
def test_kernel_matches_plain_stereo_on_card(rounds):
    """S=512 stereo LC, a third of the stations short-block, PNS, weighting
    armed; the afterburner's 4 rounds and none (-A): bits within budget
    where the plain version's are, equal to the recount of the kernel's own
    decisions, and (q, gains, books) identical on >= 98% of stations."""
    inp = _inputs(512, seed=11, device=_card())
    assert _compare(inp, rounds) >= 0.98


@pytest.mark.cuda
def test_kernel_matches_plain_mono_on_card():
    """S=256 mono (SCE), long and short blocks: as the stereo test."""
    inp = _inputs(256, ch=1, seed=12, device=_card())
    assert _compare(inp, E.REFINE_ROUNDS) >= 0.98


@pytest.mark.cuda
def test_kernel_f64_matches_plain_on_card():
    """The float64 path (chip_smoke's exact-path phases send it): S=64
    stereo, as the stereo test."""
    inp = _inputs(64, seed=13, device=_card(), dtype=torch.float64)
    assert _compare(inp, E.REFINE_ROUNDS) >= 0.98


@pytest.mark.cuda
def test_kernel_bisect_ends_and_recovery_on_card():
    """Budgets from 60 bits to 40x the AU's: some stations fit at O_LO
    (the bisect's lowest offset), some not even at O_HI; the kernel matches
    the plain version there, and encode_au on the card runs crash recovery:
    a station still over its budget is the all-zero AU (under ~120 bits no
    AU fits)."""
    dev = _card()
    S = 256
    budget = torch.as_tensor(np.geomspace(60, 40 * 1500, S).astype(np.int32), device=dev)
    enc, args = _psy_args(S, seed=14, device=dev, budget=budget)
    inp = E.au_psy(**{k: v for k, v in args.items() if k != "refine_rounds"})[0]
    fits_lo = E.try_offset(inp, torch.full((S,), E.O_LO, device=dev), use_dp=False)[0] <= budget
    fits_hi = E.try_offset(inp, torch.full((S,), E.O_HI, device=dev), use_dp=False)[0] <= budget
    assert bool(fits_lo.any()) and bool((~fits_hi).any())
    assert _compare(inp, E.REFINE_ROUNDS) >= 0.98
    out = E.encode_au(**args)
    over = out["bits"] > budget
    assert out["recovered"] and bool(over.any()) and bool((budget[over] < 150).all())
    assert not bool(out["q"][over].any()) and not bool(out["books"][over].any())
