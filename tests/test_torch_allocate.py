"""The port's allocate.py against the JAX package's, stage by stage on the
same inputs: scalefactors, scfsi, the joint-stereo walk-down, the greedy
allocator and the quantiser.  Every output is an integer (or an exact
f64 product of table values) and must be equal."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.mp2 import allocate as ja, model as jmodel, polyphase as jpoly
from odr_audioenc_tpu_torch.mp2 import allocate as ta

from signals import frames_of, music_like, loud_tones
from torch_cpu import one_torch_thread  # noqa: F401

CONFIGS = {
    "48k_j128": [{"rate": 48000, "bitrate": 128, "mode": "j"}] * 4,
    "mixed": [{"rate": 48000, "bitrate": 192, "mode": "s"},
              {"rate": 44100, "bitrate": 64, "mode": "j"},
              {"rate": 24000, "bitrate": 64, "mode": "m"},
              {"rate": 48000, "bitrate": 128, "mode": "d"}],
}


# the JAX side jitted once per shape (eager op-by-op dispatch of the
# allocator's loops costs ~20 s of compiles on the CPU)
_J_SELECT = jax.jit(partial(ja.js_mode_select, dtype=jnp.float64))
_J_ALLOC = jax.jit(partial(ja.a_bit_allocation, dtype=jnp.float64))
_J_QUANT = jax.jit(partial(ja.quantize, dtype=jnp.float64))


def _t(x):
    return torch.as_tensor(np.array(x))


def _inputs(streams, seed):
    """sb_sample [S,2,3,12,32] f64 from the JAX filterbank on music/tones,
    and a spread of SMRs (random, so the allocator's tail, freezes and ties
    all run)."""
    S = len(streams)
    sig = music_like(3, seed=seed) if seed % 2 else loud_tones(3, seed=seed)
    fr = frames_of(sig)
    pcm = np.stack([fr[(i + 1) % 3] for i in range(S)]).astype(np.float64) / 32768.0
    hist = np.asarray(pcm[:, :, -480:]) * 0.5
    sb, _ = jpoly.polyphase_frame(jnp.asarray(hist), jnp.asarray(pcm), jnp.float64)
    rng = np.random.default_rng(seed)
    smr = rng.uniform(-25, 45, (S, 2, 32))
    smr[:, :, rng.integers(0, 32, 4)] = smr[:, :, :4]      # exact ties
    return np.asarray(sb).reshape(S, 2, 3, 12, 32), smr


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [1, 2])
def test_allocate_chain_equals_jax(name, seed):
    streams = CONFIGS[name]
    cfg = jmodel.make_config(streams)
    sb_np, smr_np = _inputs(streams, seed)
    sblimit, nch, mode = cfg.sblimit, cfg.nch, cfg.mode
    sbmask = np.arange(32)[None, :] < sblimit[:, None]

    # scalefactors, sf max, JS combine
    sf_j = np.asarray(ja.scalefactor_calc(jnp.asarray(sb_np), jnp.float64))
    sf_j = np.where(sbmask[:, None, None], sf_j, 0)
    sf_t = torch.where(_t(sbmask)[:, None, None], ta.scalefactor_calc(_t(sb_np)), 0)
    np.testing.assert_array_equal(sf_t.numpy(), sf_j)
    np.testing.assert_array_equal(
        ta.find_sf_max(sf_t, _t(sblimit), torch.float64).numpy(),
        np.asarray(ja.find_sf_max(jnp.asarray(sf_j), jnp.asarray(sblimit), jnp.float64)))
    jsmp_t = ta.combine_lr(_t(sb_np))
    np.testing.assert_array_equal(jsmp_t.numpy(), np.asarray(ja.combine_lr(jnp.asarray(sb_np))))
    jsc_j = np.asarray(ja.scalefactor_calc(jnp.asarray(jsmp_t.numpy()), jnp.float64))
    jsc_t = ta.scalefactor_calc(jsmp_t)
    np.testing.assert_array_equal(jsc_t.numpy(), jsc_j)

    # scfsi patterns and the frame tables (nbal OOB quirk included)
    adj_j, scfsi_j = ja.sf_transmission_pattern(jnp.asarray(sf_j))
    adj_t, scfsi_t = ta.sf_transmission_pattern(sf_t)
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_j))
    np.testing.assert_array_equal(scfsi_t.numpy(), np.asarray(scfsi_j))
    ft_j = ja._frame_tables(jnp.asarray(cfg.tablenum))
    ft_t = ta._frame_tables(_t(cfg.tablenum))
    for k in ft_j:
        np.testing.assert_array_equal(ft_t[k].numpy(), np.asarray(ft_j[k]), err_msg=k)

    # joint-stereo walk-down over a range of budgets
    adb = cfg.adb_full - cfg.dab_ext * 8 - 16
    is_joint = mode == jmodel.MODE_JOINT
    for scale in (1.0, 0.6, 0.35):
        b = (adb * scale).astype(np.int64)
        sel_j = _J_SELECT(jnp.asarray(smr_np), scfsi_j, ft_j, jnp.asarray(sblimit),
                          jnp.asarray(nch), jnp.asarray(is_joint), jnp.asarray(b))
        sel_t = ta.js_mode_select(_t(smr_np), scfsi_t, ft_t, _t(sblimit).long(),
                                  _t(nch).long(), _t(is_joint), _t(b))
        for u, v in zip(sel_t, sel_j):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))
        jsb = np.asarray(sel_j[2])
        ba_j, left_j = _J_ALLOC(jnp.asarray(smr_np), scfsi_j, ft_j, jnp.asarray(sblimit),
                                jnp.asarray(nch), jnp.asarray(jsb), jnp.asarray(b))
        ba_t, left_t = ta.a_bit_allocation(_t(smr_np), scfsi_t, ft_t, _t(sblimit).long(),
                                           _t(nch).long(), _t(jsb), _t(b))
        np.testing.assert_array_equal(ba_t.numpy(), np.asarray(ba_j))
        np.testing.assert_array_equal(left_t.numpy(), np.asarray(left_j))
        assert (left_t >= 0).all()

        q_j = _J_QUANT(adj_j, jnp.asarray(sb_np), jnp.asarray(jsc_j),
                       jnp.asarray(jsmp_t.numpy()), ba_j, ft_j, jnp.asarray(sblimit),
                       jnp.asarray(nch), jnp.asarray(jsb))
        q_t = ta.quantize(adj_t, _t(sb_np), jsc_t, jsmp_t, ba_t, ft_t, _t(sblimit).long(),
                          _t(nch).long(), _t(jsb))
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ordered_key_bits_preserves_order(dtype):
    """The signed-int image of a float key sorts exactly as the float does
    (including -0.0 < +0.0 and +inf), the property the bisection needs."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 50, 500), [0.0, -0.0, np.inf, -1e-300, 1e-300,
                                                  999998.9, -999999.0]])
    t = torch.as_tensor(x, dtype=dtype)
    m, nbits = ta._ordered_key_bits(t)
    assert nbits == (64 if dtype == torch.float64 else 32)
    order_f = np.lexsort((np.signbit(t.numpy()) == 0, t.numpy()))
    mv = m.numpy()
    assert np.all(np.diff(mv[order_f]) >= 0)
    # equal floats map to equal ints, different floats to different ints
    tv = t.numpy()
    same_f = tv[:, None] == tv[None, :]
    same_sign = np.signbit(tv)[:, None] == np.signbit(tv)[None, :]
    assert np.array_equal(mv[:, None] == mv[None, :], same_f & same_sign)
