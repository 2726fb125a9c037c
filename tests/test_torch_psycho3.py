"""The port's psy model 3 against the JAX package's: the tonal walk and the
noise grouping bitwise from a shared f64 spectrum, and the whole SMR in f64
and f32 from the same windows.  The whole JAX model runs eagerly: jitted,
its unrolled noise grouping takes ~80 s to compile on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu import tables as T
from odr_audioenc_tpu.mp2 import psycho3 as jp3
from odr_audioenc_tpu_torch.mp2 import psycho3 as tp3

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

P3 = jp3.make_psy3_tables(48000.0)


def _windows(seed=3):
    x = music_like(4, seed=seed).astype(np.float64) / 32768.0
    return np.stack([x[0, :1024], x[1, 700:1724], x[0, 1500:2524], x[1, 2200:3224]])


def _tables(dtype):
    return {"bark": torch.as_tensor(P3["bark"]).to(dtype),
            "ath": torch.as_tensor(P3["ath"]).to(dtype), "cbandindex": P3["cbandindex"]}


def test_tonal_and_noise_label3_bitwise():
    """From one f64 spectrum (numpy), the tonal walk and the per-band noise
    grouping equal JAX's to the last bit: the same f64 operations in the
    same order (the walk is a lax.scan there, a loop over candidates here)."""
    win = _windows()
    spec = np.fft.rfft(win * T.PSY1_WINDOW)
    energy = spec.real ** 2 + spec.imag ** 2
    power = np.where(energy < 1e-20, T.DBMIN + T.POWERNORM,
                     10 * np.log10(np.maximum(energy, 1e-300)) + T.POWERNORM)
    power[:, 0] = 0.0
    dbj = jnp.asarray(T.ADD_DB_TABLE)
    dbt = torch.as_tensor(T.ADD_DB_TABLE)
    a = jax.jit(lambda p: jp3.tonal_label3(p, dbj, jnp.float64))(jnp.asarray(power))
    b = tp3.tonal_label3(torch.as_tensor(power), dbt)
    assert int(b[2].sum()) > 0
    for u, v in zip(b, a):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    na = jp3.noise_label3(a[0], jnp.asarray(energy), P3["cbandindex"], jnp.float64)
    nb = tp3.noise_label3(b[0], torch.as_tensor(energy), P3["cbandindex"], dbt)
    for u, v in zip(nb, na):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_psycho_3_smr_close(f64):
    """The whole model from samples.  f64: SMR within 1e-9 dB (measured
    4e-14: the rFFTs round differently by ulps, which the 0.1 dB add_db
    table almost never sees).  f32: within 0.05 dB (measured 3e-5), a few
    add_db table steps, where f32 FFT rounding moves an index."""
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    win = _windows()
    rng = np.random.default_rng(1)
    scale = rng.uniform(1e-5, 0.5, (4, 32))
    low = np.array([False, True, False, True])
    want = np.asarray(jp3.psycho_3(jnp.asarray(win, jdt), jnp.asarray(scale, jdt), P3,
                                   jnp.asarray(low), jdt))
    got = tp3.psycho_3(torch.as_tensor(win).to(tdt), torch.as_tensor(scale).to(tdt),
                       _tables(tdt), torch.as_tensor(low))
    assert got.dtype == tdt
    d = float(np.abs(got.numpy() - want).max())
    assert d < (1e-9 if f64 else 0.05), d
