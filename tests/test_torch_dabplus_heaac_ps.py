"""The port's HE-AAC v2 (PS) encoder end to end against the JAX encoder
(the checks of test_torch_dabplus_heaac.py): f64 superframes byte-equal to
JAX's at 48 kHz stereo 32 kbps (2 PS envelopes) and 24 kbps (1 envelope);
f32 agreement (slow); the SBR and PS state (ds_hist, qmf_hist, sbr_hist,
ps_hist with the core's) crosses JAX -> port -> JAX with the bitstream
unchanged."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import convert

from test_torch_dabplus_heaac import encode, jax_encoder, port_encoder, run_f32_case, \
    run_f64_case, signal

PS32 = {"sample_rate": 48000, "subch": 4, "channels": 2, "aot": "ps"}
PS24 = {"sample_rate": 48000, "subch": 3, "channels": 2, "aot": "ps"}


@pytest.mark.parametrize("cfg,n_env", [(PS32, 2), (PS24, 1)], ids=["ps32", "ps24"])
def test_ps_f64_byte_equal_to_jax(cfg, n_env):
    """The ps_32 shape (2 envelopes) and 24 kbps (1 envelope)."""
    outs = run_f64_case(cfg)
    assert all(o["ps_iid"].shape[2] == n_env for o in outs)
    assert port_encoder(cfg, torch.float64).ps_nenv == n_env


@pytest.mark.slow
def test_ps32_f32_agrees_with_jax():
    run_f32_case(PS32)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_ps_state_carries_between_jax_and_port(first):
    """Two superframes in one package, take_state, two more in the other:
    the four superframes equal an all-JAX run byte for byte (f64).  The
    state holds every HE-AAC leaf (decimator, QMF, SBR and PS delays)."""
    sig = signal("music", PS32, 4)
    jenc = jax_encoder(PS32, jnp.float64)
    want, _, _ = encode(jenc, sig, n_sf=4)
    tenc = port_encoder(PS32, torch.float64)
    assert {"ds_hist", "qmf_hist", "sbr_hist", "ps_hist"} <= set(tenc.init_state())
    if first == "jax":
        a, _, st = encode(jenc, sig, n_sf=2)
        rows = {k: np.asarray(v) for k, v in jenc.take_state(st, [0]).items()}
        assert rows.keys() == tenc.init_state().keys()
        st = tenc.put_state(tenc.init_state(), [0],
                            convert.dabplus_state_from_numpy(rows, "cpu", torch.float64))
        b, _, _ = encode(tenc, sig, first=2, n_sf=2, state=st)
    else:
        a, _, st = encode(tenc, sig, n_sf=2)
        rows = convert.to_numpy(tenc.take_state(st, [0]))
        st = jenc.put_state(jenc.init_state(), [0], rows)
        b, _, _ = encode(jenc, sig, first=2, n_sf=2, state=st)
    assert a + b == want
