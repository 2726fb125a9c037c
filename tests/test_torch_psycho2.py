"""The port's psy models 2 and 4 (one runtime, two table sets), 0 and -1
against the JAX package's, from the same numpy inputs, frame after frame
with the carried state.  JAX runs on the CPU with x64 (conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu import tables as T
from odr_audioenc_tpu.mp2 import psycho0 as jp0, psycho2 as jp2, psycho4 as jp4
from odr_audioenc_tpu.mp2 import psycho_n1 as jpn1
from odr_audioenc_tpu_torch import convert
from odr_audioenc_tpu_torch.mp2 import psycho0 as tp0, psycho2 as tp2, psycho4 as tp4
from odr_audioenc_tpu_torch.mp2 import psycho_n1 as tpn1

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

NF = 6


def _frames(B=4, seed=4):
    """[NF, B, 1152] raw sample values: music-like rows and one of noise."""
    x = music_like(2 * NF, seed=seed).astype(np.float64)
    n = NF * 1152
    noise = np.random.default_rng(seed).integers(-12000, 12000, n).astype(np.float64)
    rows = [x[0, :n], x[1, :n], x[0, 3000:3000 + n], noise][:B]
    return np.stack(rows).reshape(B, NF, 1152).transpose(1, 0, 2)


def _phase_diff(a, b):
    """|a - b| on the circle: atan2 near the negative real axis can land on
    +pi in one library and -pi in the other."""
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("exact", [True, False], ids=["f64-exact-order", "f32-dense"])
def test_psycho_2_smr_and_state_match_jax(model, exact):
    """SMR and carried state over 6 frames.  f64 in the C loop order: SMR
    within 1e-9 dB (measured ~2e-11: the two f64 rFFTs and transcendentals
    round differently by ulps), r within 1e-9 relative, phi within 1e-8 rad
    on the circle, the ring buffer equal.  f32 with the dense matmuls: SMR
    within 0.1 dB (measured 0.009 dB: f32 FFTs of two libraries, and the
    unpredictability of low-energy lines, whose phase is noise), the ring
    buffer equal."""
    make = {2: jp2.make_psy2_tables, 4: jp4.make_psy4_tables}[model]
    copy = {2: tp2.make_psy2_tables, 4: tp4.make_psy4_tables}[model]
    runtime = {2: tp2.psycho_2, 4: tp4.psycho_4}[model]
    jdt, tdt = (jnp.float64, torch.float64) if exact else (jnp.float32, torch.float32)
    tabs = make(48000.0)
    step = jax.jit(lambda fr, st: jp2.psycho_2(fr, st, tabs, jdt, exact))
    frames = _frames()
    B = frames.shape[1]
    js = jp2.init_psy2_state(B, jdt)
    ts = tp2.init_psy2_state(B, tdt)
    tt = convert.tables_from_numpy(copy(48000.0), "cpu", tdt)
    for i in range(NF):
        sj, js = step(jnp.asarray(frames[i], jdt), js)
        st, ts = runtime(torch.as_tensor(frames[i]).to(tdt), ts, tt)
        d = float(np.abs(np.asarray(sj) - st.numpy()).max())
        assert d < (1e-9 if exact else 0.1), f"frame {i}: SMR differs by {d} dB"
        np.testing.assert_array_equal(ts["savebuf"].numpy(), np.asarray(js["savebuf"]))
        if exact:
            for k in ("r_m1", "r_m2"):
                np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-9,
                                           atol=1e-9)
            for k in ("p_m1", "p_m2"):
                assert float(_phase_diff(ts[k].numpy(), np.asarray(js[k])).max()) < 1e-8


def test_psycho_0_and_n1_match_jax():
    """psy 0 from the same scalefactors and ATH (equal: integer min, then
    one multiply-add in f64), psy -1 the canned table."""
    rng = np.random.default_rng(3)
    sf = rng.integers(0, 63, (5, 2, 3, 32))
    ath = np.stack([T.psy0_ath_min(r) for r in (48000.0, 44100.0, 32000.0, 24000.0,
                                                16000.0)])
    want = np.asarray(jp0.psycho_0(jnp.asarray(sf), jnp.asarray(ath)[:, None, :]))
    got = tp0.psycho_0(torch.as_tensor(sf), torch.as_tensor(ath)[:, None, :])
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpn1.psycho_n1(5).numpy(), np.asarray(jpn1.psycho_n1(5)))
    assert tpn1.psycho_n1(5, torch.float32).dtype == torch.float32
