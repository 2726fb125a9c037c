"""The port's DAB+ AAC-LC stages against the JAX package's, from shared
inputs: block switching, the switched MDCT, the band-domain dispatch, TNS,
M/S and PNS, the Huffman bit counter (also against test_bitcount's brute
force), the sectioning DP and the side-info count, the refinement's top-k
ties, and test_recovery's two crash-recovery cases.  JAX runs on the CPU
with x64 (conftest.py).  In f64 every integer output is equal; floats agree
within 1e-9 relative to their scale unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.dabplus import blockswitch as JBS
from odr_audioenc_tpu.dabplus import encode as JE
from odr_audioenc_tpu.dabplus import model as JM
from odr_audioenc_tpu_torch.dabplus import blockswitch as TBS
from odr_audioenc_tpu_torch.dabplus import encode as TE
from odr_audioenc_tpu_torch.dabplus import model as TM

from signals import music_like
from test_bitcount import _ref_costs

F64 = torch.float64
RTOL = 1e-9


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, what, rtol=RTOL):
    a, b = _np(a), _np(b)
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= rtol * scale, f"{what}: max |diff| {err} vs scale {scale}"


def _equal(a, b, what):
    np.testing.assert_array_equal(_np(a).astype(np.int64), _np(b).astype(np.int64), err_msg=what)


_ENCODERS = {}


def encoders(rate=48000, subch=12, ch=2):
    """(JAX encoder, port encoder) in f64; the JAX one is only a table
    source here (its step is never traced)."""
    key = (rate, subch, ch)
    if key not in _ENCODERS:
        _ENCODERS[key] = (JM.DabPlusEncoder(JM.DabPlusConfig(*key), 4, dtype=jnp.float64),
                          TM.DabPlusEncoder(TM.DabPlusConfig(*key), 4, dtype=F64, device="cpu"))
    return _ENCODERS[key]


def _burst_pcm(n_sf, seed=3):
    """Quiet music with loud bursts: attacks that switch to short blocks."""
    sig = (music_like(6 * n_sf + 2, seed=seed)[:, :n_sf * 5760] * 0.15).astype(np.int16)
    for start in range(2500, n_sf * 5760 - 400, 3100):
        sig[:, start:start + 300] = (12000 * np.sin(np.arange(300) * 0.3)).astype(np.int16)
    return sig


def test_block_switching_matches_jax():
    """window energies, the attack walk and the sequence machine over two
    superframes with carried state: sequences and integer/bool state equal,
    float state within tolerance; the bursts give START/SHORT/STOP."""
    sig = _burst_pcm(2)
    S = 3
    pcm = np.stack([np.roll(sig, 700 * s, axis=1) for s in range(S)]).astype(np.float64)
    js = JBS.init_state(S, 2, jnp.float64)
    ts = TBS.init_state(S, 2, F64, "cpu")
    seqs = []
    for i in range(2):
        x = pcm[..., i * 5760:(i + 1) * 5760]
        jseq, js = JBS.block_switch(jnp.asarray(x), js, 120, jnp.float64)
        tseq, ts = TBS.block_switch(torch.as_tensor(x), ts, 120)
        _equal(jseq, tseq, f"seq, superframe {i}")
        for k in js:
            if np.asarray(js[k]).dtype.kind == "f":
                _close(js[k], ts[k], f"state {k}")
            else:
                _equal(js[k], ts[k], f"state {k}")
        seqs.append(_np(tseq))
    seqs = np.concatenate(seqs)
    assert {TBS.START, TBS.SHORT, TBS.STOP} <= set(seqs.ravel().tolist()), seqs


def test_window_energies_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 8000, (2, 2, 960))
    tail = rng.normal(0, 8000, (2, 2, TBS._HP_TAPS + 1))
    j = JBS.window_energies(jnp.asarray(x), jnp.asarray(tail), 120, jnp.float64)
    t = TBS.window_energies(torch.as_tensor(x), torch.as_tensor(tail), 120)
    for a, b, what in zip(j, t, ("enF", "en", "tail")):
        _close(a, b, what)


def test_mdct_long_and_short_match_jax():
    """All four window sequences, one per stream."""
    _, te = encoders()
    rng = np.random.default_rng(2)
    prev, cur = rng.normal(0, 5000, (2, 4, 2, 960))
    seq = np.array([0, 1, 2, 3], np.int32)
    j = JE.mdct_frame_switched(jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(te.cos_basis),
                               jnp.asarray(te.wvecs), jnp.asarray(te.short_basis),
                               jnp.asarray(seq), jnp.float64)
    t = TE.mdct_frame_switched(torch.as_tensor(prev), torch.as_tensor(cur), te.cos_basis,
                               te.wvecs, te.short_basis, torch.as_tensor(seq))
    _close(j, t, "spec")


def _band_ctx_pair(is_short):
    je, te = encoders()
    pt, sc = te.tables()
    jb = JE.BandCtx(je.band_m, je.bol, je.short_ctx, jnp.asarray(is_short))
    tb = TE.BandCtx(te.band_m, te.bol, sc, torch.as_tensor(is_short))
    return jb, tb


def test_band_ctx_dispatch_matches_jax():
    """Per-stream long/short band sums, integer band sums and band-to-line
    broadcasts of the port's index form equal the JAX one-hot matmuls."""
    is_short = np.array([False, True, True, False])
    jb, tb = _band_ctx_pair(is_short)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 100, (4, 2, 960))
    _close(jb.reduce_f(jnp.asarray(x)), tb.reduce_f(torch.as_tensor(x)), "reduce_f")
    _close(jb.energy(jnp.asarray(x[:, 0])), tb.energy(torch.as_tensor(x[:, 0])), "energy 2-D")
    ints = rng.integers(0, 40, (4, 2, 480)).astype(np.int32)
    _equal(jb.bsum(jnp.asarray(ints), 2), tb.bsum(torch.as_tensor(ints)[..., None], 2)[..., 0],
           "bsum stride 2")
    vals = rng.normal(0, 1, (4, 2, TE.NB))
    _close(jb.to_lines(jnp.asarray(vals)), tb.to_lines(torch.as_tensor(vals)), "to_lines")
    flags = rng.random((4, TE.NB)) < 0.5
    _equal(jb.to_lines(jnp.asarray(flags)), tb.to_lines(torch.as_tensor(flags)), "to_lines bool")


def _tns_spec(S=3):
    """MDCT spectra of long windows holding an attack (TNS territory)."""
    _, te = encoders()
    rng = np.random.default_rng(5)
    prev = rng.normal(0, 30, (S, 2, 960))
    cur = rng.normal(0, 30, (S, 2, 960))
    for s in range(S):
        cur[s, :, 300 + 150 * s:600 + 150 * s] += rng.normal(0, 8000, (2, 300))
    cur[1, 1] = cur[1, 0] * 0.9                      # a near-identical pair: TNS sync
    seq = torch.zeros(S, dtype=torch.int32)
    return TE.mdct_frame_switched(torch.as_tensor(prev), torch.as_tensor(cur), te.cos_basis,
                                  te.wvecs, te.short_basis, seq).numpy()


def test_tns_analysis_sync_and_filter_match_jax():
    _, te = encoders()
    cfg = te.tns_cfg
    a, m, b = cfg["start_line"], cfg["mid_line"], cfg["stop_line"]
    spec = _tns_spec()
    jt = JE.tns_analysis_fdk(jnp.asarray(spec), a, m, b, jnp.float64)
    tt = TE.tns_analysis_fdk(torch.as_tensor(spec), a, m, b)
    assert bool(tt["en"].any()), "no TNS filter engaged: the test input is too tame"

    def compare(j, t, where):
        assert j.keys() == t.keys()
        for k in j:
            if np.asarray(j[k]).dtype.kind == "f":
                _close(j[k], t[k], f"{where} {k}")
            else:
                _equal(j[k], t[k], f"{where} {k}")
    compare(jt, tt, "analysis")
    jt, tt = JE.tns_sync(jt), TE.tns_sync(tt)
    compare(jt, tt, "sync")
    _close(JE.tns_filter_fdk(jnp.asarray(spec), jt, a, m, b),
           TE.tns_filter_fdk(torch.as_tensor(spec), tt, a, m, b), "filtered spectrum")


def test_ms_stereo_and_pns_detect_match_jax():
    """M/S decision and substitution, then PNS detection (the 0.05 ladder of
    48 kHz stereo at 64 kbps) on correlated noise-like spectra."""
    je, te = encoders(48000, 8, 2)
    pt, _ = te.tables()
    jb = JE.BandCtx(je.band_m, je.bol)
    tb = TE.BandCtx(te.band_m, te.bol)
    rng = np.random.default_rng(6)
    base = rng.normal(0, 300, (3, 960)) * np.linspace(2.0, 0.2, 960)
    spec = np.stack([base + rng.normal(0, 60, (3, 960)),
                     base * 0.8 + rng.normal(0, 60, (3, 960))], 1)
    spec[2, 1] = rng.normal(0, 300, 960)              # one uncorrelated pair
    en = tb.energy(torch.as_tensor(spec)).numpy()
    thr = en * 10.0 ** (-1.5 + rng.uniform(-1, 1, en.shape))
    bandsel = np.arange(TE.NB)[None] < te.max_sfb
    bandsel = np.repeat(bandsel, 3, 0)
    j = JE.ms_stereo(jnp.asarray(spec), jnp.asarray(en), jnp.asarray(thr), jb,
                     jnp.asarray(bandsel), jnp.float64)
    t = TE.ms_stereo(torch.as_tensor(spec), torch.as_tensor(en), torch.as_tensor(thr), tb,
                     torch.as_tensor(bandsel))
    _equal(j[3], t[3], "ms_used")
    assert 0 < int(t[3].sum()) < t[3].numel()
    for a, b, what in zip(j[:3], t[:3], ("spec", "en", "thr")):
        _close(a, b, what)

    eligible = bandsel[:, None] & (np.arange(TE.NB) >= pt["pns_start"])
    jm, jn = JE.pns_detect(jnp.asarray(spec), jnp.asarray(en), jnp.asarray(thr), jb,
                           jnp.asarray(eligible), None, jnp.float64, pns_tabs=je.pt["pns_tabs"])
    tm, tn = TE.pns_detect(torch.as_tensor(spec), torch.as_tensor(en), torch.as_tensor(thr),
                           tb, torch.as_tensor(eligible), pt["pns_tabs"])
    _equal(jm, tm, "pns mask")
    _equal(jn, tn, "noise energies")
    assert bool(tm.any()), "no PNS band detected: the test input is too tonal"


def _random_q(S=3, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.integers(-40, 40, (S, 2, 960)).astype(np.int32)
    q[0, 0, :64] = 0
    q[1, 1] = rng.integers(-2, 2, 960)
    q[2, 0, 500:] = rng.integers(-3000, 3000, 460)    # escapes up to 2^11
    return q


def test_bit_counter_matches_brute_force_and_jax():
    """The full cost table equals the brute-force table lookups wherever a
    book is valid (test_bitcount._ref_costs) and JAX's where it is not; the
    full and fast book choices equal JAX's."""
    je, te = encoders()
    q = _random_q()
    bandsel = np.ones((3, 1, TE.NB), bool)
    tb = TE.BandCtx(te.band_m, te.bol)
    jb = JE.BandCtx(je.band_m, je.bol)
    cost = TE.spectral_bits_and_books(torch.as_tensor(q), tb, torch.as_tensor(bandsel),
                                      return_cost=True).numpy()
    ref = _ref_costs(q, te.sfb_off)
    valid = cost < (1 << 20)
    assert valid[..., 11].all()
    np.testing.assert_array_equal(cost[..., 1:][valid[..., 1:]], ref[..., 1:][valid[..., 1:]])
    jcost, _ = JE.spectral_bits_and_books(jnp.asarray(q), jb, jnp.asarray(bandsel),
                                          jnp.float64, return_cost=True)
    _equal(jcost, cost, "cost table")
    for fast in (False, True):
        jr = jax.jit(lambda qq, f=fast: JE.spectral_bits_and_books(
            qq, jb, jnp.asarray(bandsel), jnp.float64, fast=f))(jnp.asarray(q))
        tr = TE.spectral_bits_and_books(torch.as_tensor(q), tb, torch.as_tensor(bandsel),
                                        fast=fast)
        _equal(jr[0], tr[0], f"books fast={fast}")
        _equal(jr[1], tr[1], f"bits fast={fast}")


def test_optimal_books_and_side_info_match_jax():
    """The sectioning DP (per-stream section header, short-group breaks)
    and the side-info count (sections, escapes, both dpcm chains, PNS)."""
    je, te = encoders()
    _, sc = te.tables()
    q = _random_q(4, seed=8)
    is_short = np.array([False, True, False, True])
    jb, tb = _band_ctx_pair(is_short)
    bandsel = np.where(is_short[:, None], sc["bandsel"].numpy(),
                       np.arange(TE.NB) < te.max_sfb)[:, None]
    fb = (is_short[:, None] & sc["force_break"].numpy())[:, None]
    hdr = np.where(is_short, TE.SECT_BITS_SHORT, TE.SECT_BITS).astype(np.int32)[:, None]
    rng = np.random.default_rng(9)
    pns = rng.random((4, 2, TE.NB)) < 0.1
    sel = bandsel & ~pns
    cost = TE.spectral_bits_and_books(torch.as_tensor(q), tb, torch.as_tensor(bandsel),
                                      return_cost=True)
    jbooks = JE.optimal_books(jnp.asarray(cost.numpy()), jnp.asarray(sel),
                              sect_bits=jnp.asarray(hdr[..., None]), force_break=jnp.asarray(fb))
    tbooks = TE.optimal_books(cost, torch.as_tensor(sel), sect_bits=torch.as_tensor(hdr[..., None]),
                              force_break=torch.as_tensor(fb))
    _equal(jbooks, tbooks, "books")
    books = np.where(pns, TE.PNS_HCB, tbooks.numpy())
    gains = rng.integers(-100, 156, (4, 2, TE.NB)).astype(np.int32)
    args_j = (jnp.asarray(books), jnp.asarray(gains), jnp.asarray(bandsel), jnp.float64)
    js = JE.side_info_bits(*args_j, sect_hdr=jnp.asarray(hdr), force_break=jnp.asarray(fb),
                           is_short=jnp.asarray(is_short[:, None]))
    ts = TE.side_info_bits(torch.as_tensor(books), torch.as_tensor(gains),
                           torch.as_tensor(bandsel), sect_hdr=torch.as_tensor(hdr),
                           force_break=torch.as_tensor(fb),
                           is_short=torch.as_tensor(is_short[:, None]))
    _equal(js, ts, "side info bits")
    _equal(JE.side_info_bits(*args_j), TE.side_info_bits(
        torch.as_tensor(books), torch.as_tensor(gains), torch.as_tensor(bandsel)), "long only")


def test_refine_top_k_ties_match_jax():
    """encode_au on an all-zero AU (every refinable band at NMR 0) and on a
    mono AU with 4 coded bands (the top 8 take 4 bands at -inf): lax.top_k
    puts the lower index first among ties, and so must the port."""
    je, te = encoders(48000, 8, 1)
    pt, _ = te.tables()
    rng = np.random.default_rng(10)
    spec = np.zeros((2, 1, 960))
    spec[1, 0] = rng.normal(0, 3000, 960)
    max_sfb = np.array([te.max_sfb, 4], np.int32)
    budget = np.array([te.budget_au, 400], np.int32)
    nch = np.ones(2, np.int32)
    j = jax.jit(lambda s, m, b: JE.encode_au(
        s, je.pt, je.band_m, je.bol, m, b, jnp.asarray(nch), jnp.float64,
        tns_cfg=je.tns_cfg))(jnp.asarray(spec), jnp.asarray(max_sfb), jnp.asarray(budget))
    t = TE.encode_au(torch.as_tensor(spec), pt, te.band_m, te.bol, torch.as_tensor(max_sfb),
                     torch.as_tensor(budget), torch.as_tensor(nch), tns_cfg=te.tns_cfg)
    for k in ("q", "gains", "books", "bits", "tns_en", "tns_order"):
        _equal(j[k], t[k], k)
    assert (t["q"][0] == 0).all() and int(t["bits"][1]) <= 400


def _recovery_encode(enc, spec, budgets):
    pt, _ = enc.tables()
    S = spec.shape[0]
    return TE.encode_au(torch.as_tensor(spec), pt, enc.band_m, enc.bol,
                        torch.full((S,), enc.max_sfb, dtype=torch.int32),
                        torch.as_tensor(budgets),
                        torch.full((S,), enc.core_channels, dtype=torch.int32),
                        tns_cfg=enc.tns_cfg)


def test_adversarial_stream_recovers_others_unchanged():
    """test_recovery's first case on the port: one stream with an
    unfittable budget is degraded alone; the others are bit-identical."""
    S = 8
    enc = TM.DabPlusEncoder(TM.DabPlusConfig(48000, 12, 2), S, dtype=torch.float32, device="cpu")
    spec = np.random.default_rng(3).normal(0.0, 3e4, (S, 2, 960)).astype(np.float32)
    full = np.full((S,), enc.budget_au, np.int32)
    tiny = full.copy()
    tiny[7] = 128
    out_a = _recovery_encode(enc, spec, tiny)
    out_b = _recovery_encode(enc, spec, full)
    assert out_a["recovered"]
    assert int(out_a["bits"][7]) <= 128
    assert (out_a["books"][7] <= 15).all()
    for k in ("q", "gains", "books", "bits", "ms_used"):
        assert torch.equal(out_a[k][:7], out_b[k][:7]), k


def test_overfull_budget_never_overruns():
    """test_recovery's second case on the port: every stream over budget
    degrades to the all-zero AU and none exceeds its budget."""
    S = 4
    enc = TM.DabPlusEncoder(TM.DabPlusConfig(48000, 8, 1), S, dtype=torch.float32, device="cpu")
    spec = np.random.default_rng(9).normal(0.0, 5e4, (S, 1, 960)).astype(np.float32)
    out = _recovery_encode(enc, spec, np.full((S,), 56, np.int32))
    assert (out["bits"] <= 56).all(), out["bits"]
    assert (out["books"] == 0).all()
    assert (out["q"][..., :int(enc.sfb_off[enc.max_sfb])] == 0).all()


@pytest.mark.parametrize("rate,subch,ch", [(48000, 12, 2), (48000, 8, 2), (32000, 12, 2),
                                           (48000, 8, 1)])
def test_encoder_tables_match_jax(rate, subch, ch):
    """The port's encoder builds its tables and static config exactly as
    the JAX encoder does."""
    je, te = encoders(rate, subch, ch)
    pt, sc = te.tables()
    for k in TM._PT_KEYS:
        np.testing.assert_array_equal(np.asarray(je.pt[k]), pt[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(je.short_ctx["pt"][k]), sc["pt"][k].numpy(),
                                      err_msg=f"short {k}")
    for k in TM._SHORT_KEYS:
        np.testing.assert_array_equal(np.asarray(je.short_ctx[k]), sc[k].numpy(), err_msg=k)
    assert je.short_ctx["nbands_tx"] == sc["nbands_tx"]
    assert je.pt.get("pns_start") == pt.get("pns_start")
    if "pns_tabs" in je.pt:
        for k in TM._PNS_KEYS:
            np.testing.assert_array_equal(np.asarray(je.pt["pns_tabs"][k]),
                                          pt["pns_tabs"][k].numpy(), err_msg=k)
    for k in ("max_sfb", "max_sfb_short", "nsfb_short", "budget_au", "bitres_max",
              "tns_cfg", "modify_minsnr", "nbands"):
        assert getattr(je, k) == getattr(te, k), k
    for k in ("cos_basis", "wvecs", "short_basis", "band_m", "bol"):
        np.testing.assert_array_equal(np.asarray(getattr(je, k)), getattr(te, k).numpy(),
                                      err_msg=k)
