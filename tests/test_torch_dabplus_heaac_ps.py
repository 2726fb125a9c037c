"""The port's HE-AAC v2 (PS) encoder end to end against the JAX encoder
(the checks of test_torch_dabplus_heaac.py): f64 superframes byte-equal to
JAX's at 48 kHz stereo 32 kbps (2 PS envelopes) and 24 kbps (1 envelope);
f32 agreement (slow); the SBR and PS state (ds_hist, qmf_hist, sbr_hist,
ps_hist with the core's) crosses JAX -> port -> JAX with the bitstream
unchanged; and the one input found where the f64 port leaves JAX's bytes
(music left, noise with 12 kHz bursts right), held to its bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import convert

from test_torch_dabplus_heaac import SIDE, check_stream, encode, jax_encoder, port_encoder, \
    run_f32_case, run_f64_case, signal
from torch_cpu import one_torch_thread  # noqa: F401

PS32 = {"sample_rate": 48000, "subch": 4, "channels": 2, "aot": "ps"}
PS24 = {"sample_rate": 48000, "subch": 3, "channels": 2, "aot": "ps"}


@pytest.mark.parametrize("cfg,n_env", [(PS32, 2), (PS24, 1)], ids=["ps32", "ps24"])
def test_ps_f64_byte_equal_to_jax(cfg, n_env):
    """The ps_32 shape (2 envelopes) and 24 kbps (1 envelope)."""
    outs = run_f64_case(cfg)
    assert all(o["ps_iid"].shape[2] == n_env for o in outs)
    assert port_encoder(cfg, torch.float64).ps_nenv == n_env


def test_ps32_burst_input_f64_within_its_bound():
    """PS 32k in f64 on music (left) and quiet noise with 12 kHz bursts
    (right), 5 superframes: the port's bytes are not all JAX's.  The two
    sides' decimated core signal and band energies differ in the last bits
    from the first AU on (1e-15 relative: the decimator's and the MDCT's
    summation order, no single transcendental), and on this input a few
    rate-loop decisions sit on their boundary: a scalefactor gain moves by
    one step, and the bit reservoir carries the difference into the AUs
    after it.  Which AUs follow depends on the CPU's BLAS threads.  Seen,
    at 1, 2 and 8 threads: superframes 0-2 byte-equal, 3 and 4 not; 5 to 7
    of 15 AUs with different core decisions; on every band both sides code,
    gains at most one step apart.  Held: at most 9 of 15 AUs differ in the
    core (q, gains, books, bits), at most 3 superframes differ in bytes,
    the first superframe is equal, shared bands' gains are within one step,
    the SBR and PS side data are equal on every AU, and the port's stream is
    valid with its counts exact."""
    n_sf = 5
    sig = signal("split", PS32, n_sf)
    want, jouts, _ = encode(jax_encoder(PS32, jnp.float64), sig, n_sf=n_sf)
    tenc = port_encoder(PS32, torch.float64)
    got, touts, _ = encode(tenc, sig, n_sf=n_sf)
    check_stream(tenc, got, touts)
    side = tuple(k for k in SIDE if k in touts[0])
    assert {"ps_iid", "ps_icc", "ps_fine", "sbr_env"} <= set(side)
    for j, t in zip(jouts, touts):
        for k in side + ("wseq", "ms_used"):
            np.testing.assert_array_equal(j[k], t[k], k)
    core = [all(np.array_equal(j[k][0, a], t[k][0, a]) for k in ("q", "gains", "books", "bits"))
            for j, t in zip(jouts, touts) for a in range(tenc.cfg.num_aus)]
    frames = [a == b for a, b in zip(got, want)]
    assert core.count(False) <= 9, f"{core.count(False)} of {len(core)} AUs differ in the core"
    assert frames.count(False) <= 3, f"superframes equal to JAX's: {frames}"
    assert all(core[:tenc.cfg.num_aus]) and frames[0], "the first superframe differs"
    for j, t in zip(jouts, touts):
        coded = [(o["books"] > 0) & (o["books"] != 13) for o in (j, t)]
        step = np.abs(j["gains"].astype(int) - t["gains"].astype(int))[coded[0] & coded[1]]
        assert step.size and step.max() <= 1, f"gains {step.max()} steps apart"


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
