"""The port's psy model 1 against the JAX package's: the exact path stage by
stage (bitwise from a shared spectrum), the whole SMR, the fast path's
stages, the tonal walk's plain version against JAX's `tonal_fast` and
against the Pallas kernel run in interpret mode (the recipe of
test_fast_path.py:51-71), and the fused tonal+noise kernel's plain version
against `tonal_noise_pallas` in interpret mode and against JAX's
`tonal_fast` + `noise_fast` (the bounds of test_fast_path.py:74-114)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.mp2 import psycho1 as jp, psycho1_fast as jf, psycho1_pallas
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.mp2 import psycho1 as tp, psycho1_fast as tf, psycho1_kernels

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

RATE_IDX = [1, 1, 0, 5]          # 48k, 48k, 44.1k, 24k rows
# the JAX side jitted (eager op-by-op dispatch compiles every op on the CPU)
_J_TONAL = jax.jit(jf.tonal_fast, static_argnums=2)
_J_NOISE = jax.jit(jf.noise_fast, static_argnums=6)
_J_COMPACT = jax.jit(jf.compact_maskers, static_argnums=(3, 4))
_J_THRESH = jax.jit(jf.threshold_fast, static_argnums=6)


def _windows(seed=3):
    x = music_like(3, seed=seed).astype(np.float64) / 32768.0
    return np.stack([x[0, :1024], x[1, 700:1724], x[0, 1500:2524], x[1, 2200:3224]])


def _tables(fast=False, dtype=torch.float64, rate_idx=RATE_IDX):
    tabs = jp.make_psy1_tables(np.array(rate_idx))
    if fast:
        tabs.update(jf.make_fast_tables(tabs))
    jt = {k: (v if k.startswith("static_") or v is None else jnp.asarray(v))
          for k, v in tabs.items()}
    return jt, convert.tables_from_numpy(tabs, "cpu", dtype)


def _np(x):
    return np.array(x)


def test_power_spectrum_close():
    """f64 spectrum: the rFFTs differ in reduction order, so power agrees to
    1e-6 dB (low-energy bins carry the FFT's absolute error), spike and
    energy to 1e-9 relative."""
    win = _windows()
    pj, ej, sj = jp.power_spectrum(jnp.asarray(win), jnp.float64)
    pt, et, st = tp.power_spectrum(torch.as_tensor(win))
    np.testing.assert_allclose(pt.numpy(), _np(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(et.numpy(), _np(ej), rtol=1e-9, atol=1e-30)
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=1e-9)


def test_exact_stages_bitwise_from_shared_spectrum():
    """From the same inputs, each exact-path stage (tonal walk, noise scan,
    subsampling, bark merge, minimum mask) equals JAX's to the last bit: the
    same f64 operations in the same order.  The threshold and the SMR, which
    go through compiled multiply-adds and log10, are held to 1e-14
    relative."""
    win = _windows()
    jt, tt = _tables()
    dbj = jnp.asarray(jp.T.ADD_DB_TABLE)
    dbt = torch.as_tensor(jp.T.ADD_DB_TABLE)
    pj, ej, sj = jp.power_spectrum(jnp.asarray(win), jnp.float64)
    pt, et, st = (torch.as_tensor(np.array(a)) for a in (pj, ej, sj))
    cand = tp.tonal_candidates(pt)

    a = jp.tonal_label(pj, jnp.asarray(cand.numpy()), dbj, jnp.float64)
    b = tp.tonal_label(pt, cand, dbt)
    for u, v in zip(b, a):
        np.testing.assert_array_equal(u.numpy(), _np(v))
    na = jp.noise_label_scan(a[0], a[1], ej, jt["cbound"], jt["n_cband"], dbj, jnp.float64)
    nb = tp.noise_label_scan(b[0], b[1], et, tt["cbound"], tt["n_cband"], dbt)
    for u, v in zip(nb, na):
        np.testing.assert_array_equal(u.numpy(), _np(v))

    pj2, tmj = jp.subsample(na[0], a[2], jt["hear_of_bin"])
    pj2, nmj = jp.subsample(pj2, na[2], jt["hear_of_bin"])
    pt2, tmt = tp.subsample(nb[0], b[2], tt["hear_of_bin"])
    pt2, nmt = tp.subsample(pt2, nb[2], tt["hear_of_bin"])
    mj = jp.bark_merge(pj2, tmj, jt["bark_of_bin"], jnp.float64)
    mt = tp.bark_merge(pt2, tmt, tt["bark_of_bin"])
    for u, v in zip(mt, mj):
        np.testing.assert_array_equal(u.numpy(), _np(v))

    low = np.array([False, True, False, True])
    lj = jp.threshold(mj[0], mj[1], nmj, jt["map"], jt["bark_line"], jt["hear_line"],
                      jt["sub_size"], jnp.asarray(low), dbj, jnp.float64)
    lt = tp.threshold(mt[0], mt[1], nmt, tt["map"], tt["bark_line"], tt["hear_line"],
                      tt["sub_size"], torch.as_tensor(low), dbt)
    # the masking function: XLA compiles the expression, torch evaluates it
    # op by op; they differ by at most a few ulp
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-14, atol=0)
    mmj = jp.minimum_mask(lj, jt["line_sb"], jt["hear_line"], jt["sub_size"])
    mmt = tp.minimum_mask(torch.as_tensor(_np(lj)), tt["line_sb"], tt["hear_line"],
                          tt["sub_size"])
    np.testing.assert_array_equal(mmt.numpy(), _np(mmj))
    scale = np.random.default_rng(0).uniform(1e-5, 0.5, (4, 32))
    # 20 log10(scale): two libraries' log10, within an ulp or two
    np.testing.assert_allclose(
        tp.smr_from(mmt, st, torch.as_tensor(scale)).numpy(),
        _np(jp.smr_from(mmj, sj, jnp.asarray(scale), jnp.float64)), rtol=1e-14, atol=1e-13)


def test_psycho_1_smr_close():
    """The whole exact model from samples: SMR within 1e-6 dB of JAX's (the
    only difference is the rFFT's rounding, see test_power_spectrum_close;
    the stages after it are bitwise, see above)."""
    win = _windows(seed=11)
    jt, tt = _tables()
    scale = np.random.default_rng(1).uniform(1e-5, 0.5, (4, 32))
    low = np.array([False, True, False, False])
    sj = jp.psycho_1(jnp.asarray(win), jnp.asarray(scale), jt, jnp.asarray(low))
    st = tp.psycho_1(torch.as_tensor(win), torch.as_tensor(scale), tt, torch.as_tensor(low))
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=0, atol=1e-6)


def _tonal_inputs(B=64, seed=7):
    rng = np.random.default_rng(seed)
    power = rng.uniform(-90, 40, (B, 512)).astype(np.float32)
    return power, tp.tonal_candidates(torch.as_tensor(power)).numpy()


def test_tonal_fast_matches_jax():
    """The plain version of the kernel against JAX's tonal_fast: masks
    equal, power' within 1e-3 dB (f32 pow/log10 of two libraries)."""
    power, cand = _tonal_inputs()
    pj, mj, yj = _J_TONAL(jnp.asarray(power), jnp.asarray(cand), jnp.float32)
    pt, mt, yt = tf.tonal_fast(torch.as_tensor(power), torch.as_tensor(cand))
    np.testing.assert_array_equal(mt.numpy(), _np(mj))
    np.testing.assert_array_equal(yt.numpy(), _np(yj))
    assert float(np.abs(pt.numpy() - _np(pj)).max()) < 1e-3


def test_tonal_walk_cpu_matches_pallas_interpret():
    """The wrapper on a CPU tensor (the plain version) against the TPU kernel
    itself, run by Pallas in interpret mode: masks equal, power' < 1e-3."""
    power, cand = _tonal_inputs(seed=8)
    pj, mj, yj = psycho1_pallas.tonal_pallas(jnp.asarray(power), jnp.asarray(cand),
                                            jnp.float32, interpret=True)
    before = psycho1_kernels.launches
    pt, mt, yt = psycho1_kernels.tonal_walk(torch.as_tensor(power), torch.as_tensor(cand))
    assert psycho1_kernels.launches == before        # the plain version launches nothing
    np.testing.assert_array_equal(mt.numpy(), _np(mj))
    np.testing.assert_array_equal(yt.numpy(), _np(yj))
    assert float(np.abs(pt.numpy() - _np(pj)).max()) < 1e-3


def test_noise_and_masker_stages_match_jax():
    """Fast-path stages after the tonal walk in f64 from the same input:
    noise maskers (members equal, power 1e-9), compaction and merge (equal),
    threshold and minimum mask (1e-9 dB: linear sums in another order)."""
    win = _windows(seed=5)
    jt, tt = _tables(fast=True, rate_idx=[1, 1, 1, 1])
    pj, ej, _ = jp.power_spectrum(jnp.asarray(win), jnp.float64)
    pt, et = torch.as_tensor(_np(pj)), torch.as_tensor(_np(ej))
    cand = tp.tonal_candidates(pt)
    a = _J_TONAL(pj, jnp.asarray(cand.numpy()), jnp.float64)
    b = tf.tonal_fast(pt, cand)
    na = _J_NOISE(a[0], a[2], ej, jt["band_matrix"], jt["centre_base"],
                       jt["centre_span"], jnp.float64)
    nb = tf.noise_fast(b[0], b[2], et, tt["band_matrix"], tt["centre_base"],
                       tt["centre_span"])
    np.testing.assert_array_equal(nb[1].numpy(), _np(na[1]))
    np.testing.assert_allclose(nb[0].numpy(), _np(na[0]), rtol=0, atol=1e-9)
    pw = torch.as_tensor(_np(na[0]))
    ca = _J_COMPACT(a[1], na[0], jt["bark_of_bin"], jf.MAX_TONE, jnp.float64)
    cb = tf.compact_maskers(b[1], pw, tt["bark_of_bin"], tf.MAX_TONE)
    for u, v in zip(cb, ca):
        np.testing.assert_array_equal(u.numpy(), _np(v))
    np.testing.assert_array_equal(tf.merge_compact(*cb).numpy(), _np(jf.merge_compact(*ca)))
    na2 = _J_COMPACT(na[1], na[0], jt["bark_of_bin"], 32, jnp.float64)
    nb2 = tf.compact_maskers(nb[1], pw, tt["bark_of_bin"], 32)
    low = np.array([False, True, False, True])
    lj = _J_THRESH(ca, na2, jt["bark_line"], jt["hear_line"], jt["sub_size"],
                           jnp.asarray(low), jnp.float64)
    lt = tf.threshold_fast(cb, nb2, tt["bark_line"], tt["hear_line"], tt["sub_size"],
                           torch.as_tensor(low))
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=1e-9)
    mj = jf.minimum_mask_fast(lj, jt["hear_line"], jt["static_mm"])
    mt = tf.minimum_mask_fast(lt, tt["hear_line"], tt["static_mm"])
    np.testing.assert_allclose(mt.numpy(), _np(mj), rtol=0, atol=1e-9)


def _noise_inputs(S=16, seed=3):
    """The recipe of test_fast_path.py:74-114: 2S rows of random windows at
    48 kHz through the f32 spectrum; the uniform band geometry of that rate."""
    tabs = jp.make_psy1_tables(np.array([1] * (2 * S)))
    tabs.update(jf.make_fast_tables(tabs))
    rng = np.random.default_rng(seed)
    win = (rng.standard_normal((2 * S, 1024)) * 0.1).astype(np.float32)
    pj, ej, _ = jp.power_spectrum(jnp.asarray(win), jnp.float32)
    power, energy = _np(pj), _np(ej)
    cand = tp.tonal_candidates(torch.as_tensor(power)).numpy()
    return tabs, power, energy, cand


def _assert_noise_close(pw, tone_m, noise_m, ref_pw, ref_tone, ref_noise, S):
    """Tone members equal; at most 2S noise-member flips (a centre is
    base + trunc(index * span), with no rounding margin, so f32 sums in
    another order can move it by one bin); power' within 1e-2 dB where both
    have a noise member, and 1e-3 dB where neither has one."""
    np.testing.assert_array_equal(tone_m, ref_tone)
    flips = int((noise_m != ref_noise).sum())
    assert flips <= 2 * S, f"noise member mismatch at {flips} bins"
    d = np.abs(pw - ref_pw)
    both, neither = noise_m & ref_noise, ~noise_m & ~ref_noise
    assert float(d[both].max(initial=0.0)) < 1e-2
    assert float(d[neither].max(initial=0.0)) < 1e-3


def test_tonal_noise_cpu_matches_pallas_interpret():
    """The fused wrapper on CPU tensors (its plain version, no launch)
    against the TPU kernel itself, run by Pallas in interpret mode."""
    S = 16
    tabs, power, energy, cand = _noise_inputs(S)
    bmt, base32, span32 = tabs["static_noise_uniform"]
    pj, tj, nj = psycho1_pallas.tonal_noise_pallas(
        jnp.asarray(power), jnp.asarray(cand), jnp.asarray(energy), jnp.asarray(bmt),
        jnp.asarray(base32), jnp.asarray(span32), interpret=True)
    uniform = convert.tables_from_numpy(tabs, "cpu", torch.float32)["static_noise_uniform"]
    before = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
    pt, tt, nt = psycho1_kernels.tonal_noise(torch.as_tensor(power), torch.as_tensor(cand),
                                             torch.as_tensor(energy), *uniform)
    assert (psycho1_kernels.launches, psycho1_kernels.noise_launches) == before
    _assert_noise_close(pt.numpy(), tt.numpy(), nt.numpy(), _np(pj), _np(tj), _np(nj), S)


def test_tonal_noise_fast_matches_jax_plain():
    """tonal_noise_fast against JAX's tonal_fast followed by noise_fast
    (the pipeline the fused TPU kernel replaces), from the same inputs."""
    S = 16
    tabs, power, energy, cand = _noise_inputs(S, seed=4)
    a = _J_TONAL(jnp.asarray(power), jnp.asarray(cand), jnp.float32)
    na = _J_NOISE(a[0], a[2], jnp.asarray(energy), tabs["band_matrix"], tabs["centre_base"],
                  tabs["centre_span"], jnp.float32)
    uniform = convert.tables_from_numpy(tabs, "cpu", torch.float32)["static_noise_uniform"]
    pt, tt, nt = tf.tonal_noise_fast(torch.as_tensor(power), torch.as_tensor(cand),
                                     torch.as_tensor(energy), *uniform)
    _assert_noise_close(pt.numpy(), tt.numpy(), nt.numpy(), _np(na[0]), _np(a[1]),
                        _np(na[1]), S)


def test_fused_noise_is_not_ported():
    """use_kernel="fused-noise" runs: with the uniform geometry through the
    fused wrapper (on the CPU its plain version, so the SMR equals the
    tonal path's up to the band sums' matmul shape), and for a mixed-rate
    batch, which has no uniform geometry, as the tonal walk + noise_fast,
    exactly as use_kernel="tonal".  Another name raises."""
    win = torch.as_tensor(_windows(seed=9)).float()
    scale = torch.as_tensor(np.random.default_rng(5).uniform(1e-5, 0.5, (4, 32))).float()
    low = torch.zeros(4, dtype=torch.bool)
    for rate_idx, atol in (([1, 1, 1, 1], 1e-3), (RATE_IDX, 0.0)):
        _, tt = _tables(fast=True, dtype=torch.float32, rate_idx=rate_idx)
        assert (tt.get("static_noise_uniform") is None) == (rate_idx == RATE_IDX)
        fused = tf.psycho_1_fast(win, scale, tt, low, use_kernel="fused-noise")
        tonal = tf.psycho_1_fast(win, scale, tt, low, use_kernel="tonal")
        np.testing.assert_allclose(fused.numpy(), tonal.numpy(), rtol=0, atol=atol)
    with pytest.raises(ValueError):
        tf.psycho_1_fast(win, scale, tt, low, use_kernel="pallas")


# the string condition is evaluated when the test runs, not at import
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_tonal_walk_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (B=64 and a
    ragged B=3): masks equal, power' < 1e-3, one launch per call."""
    for B in (64, 3):
        power, cand = _tonal_inputs(B=B, seed=B)
        p = torch.as_tensor(power, device="cuda")
        c = torch.as_tensor(cand, device="cuda")
        before = psycho1_kernels.launches
        pk, mk, yk = psycho1_kernels.tonal_walk(p, c)
        torch.cuda.synchronize()
        assert psycho1_kernels.launches == before + 1
        pp, mp, yp = tf.tonal_fast(p, c)
        assert torch.equal(mk, mp) and torch.equal(yk, yp)
        assert float((pk - pp).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_tonal_noise_kernel_matches_plain_on_card():
    """The fused CUDA kernel against its plain version on the card (B=32
    random-window rows and a ragged B=3): the bounds of the CPU tests, one
    launch per call, no tonal_walk launch."""
    for S, rows in ((16, None), (16, 3)):
        tabs, power, energy, cand = _noise_inputs(S, seed=S)
        if rows:
            power, energy, cand = power[:rows], energy[:rows], cand[:rows]
        dev = [torch.as_tensor(a, device="cuda") for a in (power, cand, energy)]
        uniform = convert.tables_from_numpy(tabs, "cuda", torch.float32)["static_noise_uniform"]
        before = (psycho1_kernels.launches, psycho1_kernels.noise_launches)
        got = psycho1_kernels.tonal_noise(*dev, *uniform)
        torch.cuda.synchronize()
        assert (psycho1_kernels.launches, psycho1_kernels.noise_launches) == \
            (before[0], before[1] + 1)
        ref = tf.tonal_noise_fast(*dev, *uniform)
        _assert_noise_close(*(t.cpu().numpy() for t in got + ref), S)


@pytest.mark.parametrize("density", [0.02, 0.1, 0.3, 0.7])
def test_reach_masks_reproduce_min_zeroer(density):
    """The kernels' zeroing from the wrapper's reach table and the accept
    words (psycho1_kernels.zeroing_from_words, the kernel's bit arithmetic)
    against the plain min_zeroer of tonal_fast, for random accept patterns:
    mz equal, and "b-1 / b+1 zeroed by an accepted bin left of b" equal to
    mz[b-1] < b and mz[b+1] < b."""
    acc = torch.as_tensor(np.random.default_rng(int(density * 100)).random((64, 512)) < density)
    mz, left, right = psycho1_kernels.zeroing_from_words(acc.numpy())
    ref = tf.min_zeroer(acc)
    bins = torch.arange(512)
    no = torch.zeros((64, 1), dtype=torch.bool)
    assert torch.equal(mz, ref)
    assert torch.equal(left, torch.cat([no, ref[:, :-1] < bins[1:]], 1))
    assert torch.equal(right, torch.cat([ref[:, 1:] < bins[:-1], no], 1))
    tab = psycho1_kernels.walk_table()
    assert tab.dtype == np.int32 and tab.shape == (2, 512)
    np.testing.assert_array_equal(tab[0], jp.T.TONAL_RUN)
    assert int(tab[1].max()) < 1 << 25 and not (tab[1] >> 12 & 1).any()   # never itself


@pytest.mark.parametrize("rate_idx", [0, 1, 2, 4, 5, 6])
def test_noise_tables_band_sums(rate_idx):
    """The fused kernel's band sums (psycho1_kernels.band_sums_lanes,
    from the wrapper's noise_tables) equal the band matrix product of the
    plain version for each sample rate's geometry (f64, sums of 1-130
    positive terms in another order: 1e-12 relative)."""
    tabs = jf.make_fast_tables(jp.make_psy1_tables(np.array([rate_idx])))
    bmt, base, span = tabs["static_noise_uniform"]
    x = np.random.default_rng(rate_idx).random((16, 512))
    got = psycho1_kernels.band_sums_lanes(x, psycho1_kernels.noise_tables(base, span))
    np.testing.assert_allclose(got, x @ bmt.astype(np.float64), rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_both_kernels_ragged_batches_on_card():
    """Both kernels at B = 1, 7 and 4097 (the ragged edge of several rows
    per block and of the persistent grid) against their plain versions on
    the card, by the bounds of the tests above; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B in (1, 7, 4097):
        power, cand = _tonal_inputs(B=B, seed=B)
        p, c = (torch.as_tensor(a, device="cuda") for a in (power, cand))
        before = psycho1_kernels.launches
        pk, mk, yk = psycho1_kernels.tonal_walk(p, c)
        torch.cuda.synchronize()
        assert psycho1_kernels.launches == before + 1
        pp, mp, yp = tf.tonal_fast(p, c)
        assert torch.equal(mk, mp) and torch.equal(yk, yp), B
        assert float((pk - pp).abs().max()) < 1e-3
        S = (B + 1) // 2
        tabs, power, energy, cand = _noise_inputs(S, seed=B)
        dev = [torch.as_tensor(a[:B], device="cuda") for a in (power, cand, energy)]
        uniform = convert.tables_from_numpy(tabs, "cuda", torch.float32)["static_noise_uniform"]
        before = psycho1_kernels.noise_launches
        got = psycho1_kernels.tonal_noise(*dev, *uniform)
        torch.cuda.synchronize()
        assert psycho1_kernels.noise_launches == before + 1
        ref = tf.tonal_noise_fast(*dev, *uniform)
        _assert_noise_close(*(t.cpu().numpy() for t in got + ref), S)
