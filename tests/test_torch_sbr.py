"""The port's SBR and PS stages (odr_audioenc_tpu_torch/dabplus/sbr.py)
against the JAX package's, from shared numpy inputs: the header and band
tables, the QMF analysis and the tonality quotas (f64, within 1e-9
relative), the side analysis and the PS parameters (every integer output
equal in f64), stereo coupling, the payload and PS sizes (integers equal on
random side data that hits the LAV clamps and the FIL escape) and the
writer (byte-equal to JAX's, and as long as payload_bits counts).  JAX runs
on the CPU with x64 (conftest.py), eagerly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.dabplus import sbr as JS
from odr_audioenc_tpu.host.bitwriter import BitWriter as JBitWriter
from odr_audioenc_tpu_torch.dabplus import sbr as TS
from odr_audioenc_tpu_torch.host.bitwriter import BitWriter

from signals import loud_tones, music_like


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_rel(a, b, rel=1e-9):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-300)
    err = float(np.abs(a - b).max()) / scale
    assert err <= rel, err


_TABLES = ["ENV_CODE_F", "ENV_LEN_F", "ENV_CODE_T", "ENV_LEN_T", "ENV3_CODE_F", "ENV3_LEN_F",
           "NOISE_CODE_T", "NOISE_LEN_T", "NOISE_CODE_F", "NOISE_LEN_F", "QMF_PROTO",
           "EXT_SBR_DATA", "ENV_BIAS", "TRANSIENT_RATIO", "GRID_MENU", "ENVBAL_CODE_F",
           "ENVBAL_LEN_F", "ENVBAL3_CODE_F", "ENVBAL3_LEN_F", "NOISEBAL_CODE_F",
           "NOISEBAL_LEN_F", "_PAN15", "_PAN30", "IID_CODE_F", "IID_LEN_F", "IID_CODE_FF",
           "IID_LEN_FF", "IID_GRID_DB", "IID_GRID_FINE_DB", "PS_NBANDS", "PS_BORDER_QMF",
           "ICC_CODE_F", "ICC_LEN_F", "ICC_GRID", "_HEADER_MAP", "START_BAND"]


@pytest.mark.parametrize("name", _TABLES)
def test_sbr_tables_equal_jax(name):
    """Every table and constant the port copied, equal to the original."""
    a, b = getattr(JS, name), getattr(TS, name)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k], object), np.asarray(b[k], object)), k
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _params_rates(key):
    thresholds = [thr for thr, _ in JS._HEADER_MAP[key]]
    return sorted({max(r, 8000) for t in thresholds for r in (t - 8000, t, t + 8000)})


@pytest.mark.parametrize("key", list(JS._HEADER_MAP), ids=lambda k: f"{k[0]}-{k[1]}ch")
def test_sbr_params_equal_jax(key):
    """SbrParams attribute-equal for every header row, at bitrates below, at
    and above each threshold."""
    fs, ch = key
    for br in _params_rates(key):
        a, b = vars(JS.SbrParams(fs, br, ch)), vars(TS.SbrParams(fs, br, ch))
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (br, k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (br, k)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("aot,subch,ch", [("sbr", 6, 1), ("sbr", 8, 2), ("ps", 4, 2)])
def test_encoder_sbr_buffers_equal_jax(aot, subch, ch, dtype):
    """The HE-AAC constants the encoder registers, in the working dtype,
    bitwise equal to the JAX encoder's: the QMF matrix, the band-mean and
    band-sum matrices (built in float32 and then cast, as JAX does), the
    SBR-range mask, the patch map and the decimator's taps (float64 taps
    cast)."""
    from odr_audioenc_tpu.dabplus import model as JM
    from odr_audioenc_tpu_torch.dabplus import model as TM
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jenc = JM.DabPlusEncoder(JM.DabPlusConfig(48000, subch, ch, aot=aot), 1, dtype=jdt)
    tenc = TM.DabPlusEncoder(TM.DabPlusConfig(48000, subch, ch, aot=aot), 1, dtype=tdt,
                             device="cpu")
    p = jenc.sbr_params
    want = {"ds_filter": jenc.ds_filter, "sbr_qmf": jnp.asarray(JS._qmf_matrix(), jdt),
            "sbr_bh": JS._band_mean_mat(p.f_hi, jdt),
            "sbr_bn": JS._band_mean_mat(p.noise_table, jdt),
            "sbr_bmax": JS._band_sum_max(p.f_hi, jdt),
            "sbr_sbr_mask": jnp.asarray((np.arange(64) >= p.k0) & (np.arange(64) < p.k2), jdt),
            "sbr_patch_src": p.patch_src}
    for k, v in want.items():
        got = getattr(tenc, k).numpy()
        assert got.dtype == np.dtype(dtype) or k == "sbr_patch_src", k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_qmf_and_tonality_f64_close_to_jax():
    """qmf_analysis (outputs and carried history) and tonality_quotas in
    f64 within 1e-9 relative of JAX, from shared inputs."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3000, (2, 2, 3 * 1920))
    x[1, 1] = music_like(6, stereo=False)[0, :3 * 1920]
    hist = rng.normal(0, 3000, (2, 2, 576))
    jr, ji, jh = JS.qmf_analysis(jnp.asarray(x), jnp.asarray(hist), jnp.float64)
    tr, ti, th = TS.qmf_analysis(_t(x), _t(hist))
    for a, b in ((jr, tr), (ji, ti), (jh, th)):
        _assert_rel(a, b)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    wr = np.asarray(jr).reshape(2, 2, 3, 30, 64)
    wi = np.asarray(ji).reshape(2, 2, 3, 30, 64)
    qj = JS.tonality_quotas(jnp.asarray(wr), jnp.asarray(wi), jnp.float64)
    qt = TS.tonality_quotas(_t(wr), _t(wi))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-9, atol=1e-9)


def test_decimator_f64_close_to_jax():
    """The encoder's 2:1 half-band decimation (a stride-2 conv1d) against
    the JAX step's form (the gathered [n/2, 127] product summed) on shared
    f64 input: the other summation order differs in the last bits only,
    within 1e-13 of the signal's peak; the carried history is equal."""
    import jax
    from odr_audioenc_tpu_torch.dabplus import model as TM
    enc = TM.DabPlusEncoder(TM.DabPlusConfig(48000, 6, 1, aot="sbr"), 2,
                            dtype=torch.float64, device="cpu")
    state = enc.init_state()
    rng = np.random.default_rng(4)
    state["ds_hist"] = _t(rng.normal(0, 3000, (2, 1, TM.DS_TAPS - 1)))
    x = np.stack([music_like(6, stereo=False, seed=s)[:, :5760] for s in (1, 2)]).astype(float)
    y, st, _, _ = enc._sbr_analysis(_t(x), state, {})
    xx = np.concatenate([state["ds_hist"].numpy(), x], -1)
    idx = 2 * np.arange(2880)[:, None] + np.arange(TM.DS_TAPS)[None, :]
    want = np.asarray(jax.jit(lambda a, h: (a[..., idx] * h).sum(-1))(
        jnp.asarray(xx), jnp.asarray(enc.ds_filter.numpy())))
    assert np.abs(y.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    np.testing.assert_array_equal(st["ds_hist"].numpy(), xx[..., -(TM.DS_TAPS - 1):])


def _bursts(n_streams, n):
    """[S, n] int16 quiet noise with one 12 kHz tone burst per stream, its
    onset moving by 80 samples from stream to stream (both edges of the
    transient grid at many slots)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 600.0, (n_streams, n))
    t = np.arange(400)
    for s in range(n_streams):
        o = 1920 + 80 * s
        x[s, o:o + 400] += np.sin(2 * np.pi * 12000 * t / 48000) * 20000
    return np.clip(x, -32768, 32767).astype(np.int16)


def _side_input(kind):
    """[S, ch, 3*1920] float PCM and [S, ch, 576] history for the side analysis."""
    n = 3 * 1920
    if kind == "music":
        x = np.stack([music_like(8, seed=s)[:, :n] for s in (1, 2)])
    elif kind == "tones":
        x = np.stack([loud_tones(8, seed=s)[:, :n] for s in (1, 2)])
    else:
        x = _bursts(24, n)[:, None]
    hist = np.zeros(x.shape[:2] + (576,))
    return x.astype(np.float64), hist


# ties of |t0b/2 - border| between two menu borders: t0b/2 at an integer
# midway between two borders two apart, or at a half-integer between two
# adjacent ones
_TIES = {6, 10, 13, 15, 17, 20, 24}


@pytest.mark.parametrize("kind", ["music", "tones", "bursts"])
def test_side_analysis_f64_equal_to_jax(kind):
    """sbr_side_analysis: every integer output equal to JAX's in f64, and
    the carried QMF history equal.  On the bursts the 2-envelope grid fires
    with both frame classes (FIXVAR and VARFIX), and AUs whose border lies
    midway between two menu entries take the first of them, as JAX's argmin
    does."""
    x, hist = _side_input(kind)
    ch = x.shape[1]
    params = TS.SbrParams(48000, 48000 if ch == 1 else 64000, ch)
    jside, jh = JS.sbr_side_analysis(jnp.asarray(x), jnp.asarray(hist),
                                     JS.SbrParams(48000, 48000 if ch == 1 else 64000, ch), 3,
                                     jnp.float64)
    tside, th = TS.sbr_side_analysis(_t(x), _t(hist), params, 3)
    jside, tside = _np(jside), {k: v.numpy() for k, v in tside.items()}
    assert jside.keys() == tside.keys()
    for k in jside:
        assert jside[k].dtype == tside[k].dtype or jside[k].dtype.kind == tside[k].dtype.kind, k
        np.testing.assert_array_equal(jside[k], tside[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    if kind != "bursts":
        return
    tr = tside["sbr_transient"]
    classes = {JS.GRID_MENU[g][1] for g in tside["sbr_tgrid"][tr]}
    assert classes == {1, 2}, classes
    # recompute the border slot t0b from the port's own QMF output
    wr, wi, _ = TS.qmf_analysis(_t(x), _t(hist))
    e = (wr ** 2 + wi ** 2).numpy().reshape(x.shape[0], ch, 3, 30, 64)
    les = np.log(e[..., params.k0:params.k2].sum(-1) + 1.0) / np.log(2.0)
    dlt = np.diff(les, axis=-1)
    t0 = np.abs(dlt).argmax(-1) + 1
    rising = np.take_along_axis(dlt, (t0 - 1)[..., None], -1)[..., 0] > 0
    t0b = np.where(rising, t0 + 2, t0 - 2).transpose(0, 2, 1)      # [S, nau, ch]
    ties = tr & np.isin(t0b, list(_TIES))
    assert ties.sum() >= 1, "no AU put its border midway between two menu entries"
    menu2 = np.asarray([2 * m[0] for m in JS.GRID_MENU])
    d = np.abs(t0b[..., None] - menu2)
    np.testing.assert_array_equal(tside["sbr_tgrid"][ties], d.argmin(-1)[ties])


def _ps_input(kind, ne):
    """[nau=3, S=2, ne, sub] L and R windows."""
    n, sub = 3 * 1920, 1920 // ne
    if kind == "panned":
        lr = np.stack([music_like(8, seed=s)[:, :n] for s in (1, 2)]).astype(np.float64)
        lr[:, 1] = np.floor(lr[:, 1] / 40)                 # ~-32 dB on the right
    elif kind == "tones":
        lr = np.stack([loud_tones(8, seed=s)[:, :n] for s in (1, 2)]).astype(np.float64)
    else:
        lr = np.stack([music_like(8, seed=s)[:, :n] for s in (1, 2)]).astype(np.float64)
    aus = lr.reshape(2, 2, 3, ne, sub).transpose(2, 0, 3, 1, 4)
    return aus[..., 0, :], aus[..., 1, :]


@pytest.mark.parametrize("kind", ["music", "tones", "panned"])
@pytest.mark.parametrize("ne", [1, 2])
def test_iid_parameters_f64_equal_to_jax(kind, ne):
    """iid_parameters: IID (coarse and fine), ICC and the fine choice equal
    to JAX's in f64; the hard-panned image needs the fine ladder."""
    l, r = _ps_input(kind, ne)
    want = JS.iid_parameters(jnp.asarray(l), jnp.asarray(r), 48000, jnp.float64)
    got = TS.iid_parameters(_t(l), _t(r), 48000)
    for a, b, name in zip(want, got, ("iid", "icc", "iid_fine", "use_fine")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    if kind == "panned":
        assert got[3].any()


def _walk(rng, shape, hi, step):
    """Random walks over the last axis in [0, hi], steps within +-step."""
    v = rng.integers(0, hi + 1, shape[:-1] + (1,)) + np.cumsum(
        rng.integers(-step, step + 1, shape), -1)
    return np.clip(v, 0, hi).astype(np.int32)


def _random_side(rng, S, nau, ch, params, clamps=True):
    """Random integer side data over the ranges the analysis emits; with
    `clamps` neighbouring bands jump past the Huffman books' LAV (where
    payload_bits counts raw deltas and the writer clamped ones, so only
    the sizes are compared), else the deltas stay within it.  Either way
    the payloads take the FIL escape."""
    n_hi, n_q = params.n_hi, params.n_q
    if clamps:
        env = rng.integers(0, 128, (S, nau, ch, n_hi))
        env2 = rng.integers(0, 64, (S, nau, ch, 2, n_hi))
    else:
        env, env2 = (_walk(rng, (S, nau, ch, n_hi), 127, 40),
                     _walk(rng, (S, nau, ch, 2, n_hi), 63, 20))
    return {"sbr_env": env.astype(np.int32), "sbr_env2": env2.astype(np.int32),
            "sbr_transient": rng.random((S, nau, ch)) < 0.4,
            "sbr_noise_q": rng.integers(0, 31, (S, nau, ch, n_q)).astype(np.int32),
            "sbr_invf": rng.integers(0, 4, (S, nau, ch, n_q)).astype(np.int32),
            "sbr_addharm": rng.random((S, nau, ch, n_hi)) < 0.05,
            "sbr_tgrid": rng.integers(0, 8, (S, nau, ch)).astype(np.int32)}


def _smooth(rng, side):
    """Some streams with near-equal channels (so coupling wins)."""
    out = dict(side)
    for k in ("sbr_env", "sbr_env2", "sbr_noise_q"):
        v = out[k].copy()
        v[::2, :, 1] = np.clip(v[::2, :, 0] + rng.integers(-2, 3, v[::2, :, 0].shape), 0,
                               127 if k == "sbr_env" else (63 if k == "sbr_env2" else 30))
        out[k] = v.astype(np.int32)
    tr, tg = out["sbr_transient"].copy(), out["sbr_tgrid"].copy()
    tr[::2, :, 1], tg[::2, :, 1] = tr[::2, :, 0], tg[::2, :, 0]
    out["sbr_transient"], out["sbr_tgrid"] = tr, tg
    return out


def _random_ps(rng, S, nau, ne, clamps=True):
    """Random PS indices, past the quantisers' ranges (LAV clamps) with
    `clamps`, else within them."""
    c, f = (12, 24) if clamps else (7, 15)
    return {"ps_iid": rng.integers(-c, c + 1, (S, nau, ne, 20)).astype(np.int32),
            "ps_iid_fine": rng.integers(-f, f + 1, (S, nau, ne, 20)).astype(np.int32),
            "ps_icc": rng.integers(0, 8, (S, nau, ne, 20)).astype(np.int32),
            "ps_fine": rng.random((S, nau)) < 0.5}


@pytest.mark.parametrize("case", ["mono", "stereo", "ps1", "ps2"])
def test_coupling_and_sizes_equal_jax(case):
    """apply_coupling, payload_bits and ps_data_bits integer-equal to JAX's
    on random side data (coupled and uncoupled AUs, LAV clamps, FIL and PS
    extension sizes past the 4-bit escape)."""
    rng = np.random.default_rng({"mono": 1, "stereo": 2, "ps1": 3, "ps2": 4}[case])
    ch = 2 if case == "stereo" else 1
    jp = JS.SbrParams(48000, 64000 if ch == 2 else 32000, ch)
    tp = TS.SbrParams(48000, 64000 if ch == 2 else 32000, ch)
    side = _random_side(rng, 64, 3, ch, tp)
    if ch == 2:
        side = _smooth(rng, side)
        jside = _np(JS.apply_coupling({k: jnp.asarray(v) for k, v in side.items()}, jp))
        tside = {k: v.numpy() for k, v in
                 TS.apply_coupling({k: _t(v) for k, v in side.items()}, tp).items()}
        assert jside.keys() == tside.keys()
        for k in jside:
            np.testing.assert_array_equal(jside[k], tside[k], err_msg=k)
        assert 0 < tside["sbr_cpl"].sum() < tside["sbr_cpl"].size
        side = tside
    jps = tps = None
    if case.startswith("ps"):
        ps = _random_ps(rng, 64, 3, int(case[-1]))
        jps = JS.ps_data_bits(*(jnp.asarray(ps[k]) for k in
                                ("ps_iid", "ps_iid_fine", "ps_fine", "ps_icc")))
        tps = TS.ps_data_bits(*(_t(ps[k]) for k in ("ps_iid", "ps_iid_fine", "ps_fine",
                                                     "ps_icc")))
        np.testing.assert_array_equal(np.asarray(jps), tps.numpy())
        assert ((2 + tps.numpy() + 7) // 8 >= 15).any()
    want = JS.payload_bits({k: jnp.asarray(v) for k, v in side.items()}, jp, 3, ps_bits=jps)
    got = TS.payload_bits({k: _t(v) for k, v in side.items()}, tp, 3, ps_bits=tps)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32
    assert ((got.numpy() - 7) // 8 >= 15).any(), "no FIL element took the escape"


def _write(mod, bw, side, params, s, a, ps=None, header=True):
    """One AU's SBR payload of `side` (numpy [S, nau, ch, ...]) through
    mod.write_sbr_payload, laid out as the encoders lay it out."""
    env, env2, tr = side["sbr_env"][s, a], side["sbr_env2"][s, a], side["sbr_transient"][s, a]
    nq, invf, ah, tg = (side[k][s, a] for k in ("sbr_noise_q", "sbr_invf", "sbr_addharm",
                                                  "sbr_tgrid"))

    def envs(c):
        return [env2[c, 0], env2[c, 1]] if tr[c] else [env[c]]
    kw = {}
    if ps is not None:
        fine = bool(ps["ps_fine"][s, a])
        kw = {"ps_iid": ps["ps_iid_fine" if fine else "ps_iid"][s, a],
              "ps_icc": ps["ps_icc"][s, a], "ps_fine": fine}
    if env.shape[0] == 2:
        kw = {"envs_r": envs(1), "invf_r": invf[1], "noise_vals_r": nq[1],
              "add_harm_r": ah[1], "grid_idx_r": int(tg[1]) if tr[1] else None,
              "coupled": bool(side["sbr_cpl"][s, a])}
    return mod.write_sbr_payload(bw, envs(0), noise_vals=nq[0], params=params,
                                 write_header=header, invf=invf[0], add_harm=ah[0],
                                 grid_idx=int(tg[0]) if tr[0] else None, **kw)


@pytest.mark.parametrize("case", ["mono", "cpe", "cpe_coupled", "ps_coarse", "ps_fine"])
@pytest.mark.parametrize("envs", [1, 2])
@pytest.mark.parametrize("header", [True, False])
def test_writer_byte_equal_to_jax_and_payload_bits(case, envs, header):
    """write_sbr_payload byte-equal to JAX's for mono, CPE uncoupled and
    coupled, PS coarse and fine, 1 and 2 envelopes, with and without the
    header; the FIL element it writes is as long as payload_bits counts with
    the header bits as written (HDR_BITS_WRITTEN; the reference's rate loop
    counts HDR_BITS)."""
    rng = np.random.default_rng([len(case), envs, header])
    ch = 2 if case.startswith("cpe") else 1
    p = TS.SbrParams(48000, 64000 if ch == 2 else 32000, ch)
    S, nau = 16, 3
    side = _random_side(rng, S, nau, ch, p, clamps=False)
    side["sbr_transient"][:] = envs == 2
    ps = None
    if case == "cpe":
        side["sbr_cpl"] = np.zeros((S, nau), bool)
    elif case == "cpe_coupled":
        side = {k: v.numpy() for k, v in
                TS.apply_coupling({k: _t(v) for k, v in _smooth(rng, side).items()},
                                  p).items()}
        assert side["sbr_cpl"].sum() >= 4
    if case.startswith("ps"):
        ps = _random_ps(rng, S, nau, 2, clamps=False)
        ps["ps_fine"][:] = case == "ps_fine"
    ps_bits = None if ps is None else TS.ps_data_bits(
        *(_t(ps[k]) for k in ("ps_iid", "ps_iid_fine", "ps_fine", "ps_icc")))
    counted = TS.payload_bits({k: _t(v) for k, v in side.items()}, p, nau, ps_bits=ps_bits,
                              hdr_bits=TS.HDR_BITS_WRITTEN).numpy()
    a = 0 if header else 1
    for s in range(S):
        if case == "cpe_coupled" and not side["sbr_cpl"][s, a]:
            continue
        jb, tb = JBitWriter(), BitWriter()
        _write(JS, jb, side, JS.SbrParams(48000, 64000 if ch == 2 else 32000, ch), s, a, ps,
               header)
        _write(TS, tb, side, p, s, a, ps, header)
        assert (bytes(jb.buf), jb.acc, jb.nbits) == (bytes(tb.buf), tb.acc, tb.nbits), s
        assert len(tb.buf) * 8 + tb.nbits == counted[s, a], s
