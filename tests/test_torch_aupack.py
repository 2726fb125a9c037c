"""The port's DAB+ device pack (odr_audioenc_tpu_torch/dabplus/aupack.py and
the additions to bitpack.py), function by function against the JAX package
on the same seeded numpy inputs, and on synthetic legal decisions against
the port's host writers.  Everything is an integer: equal, no tolerance.

 - crc_fixed, rs_bit_matrix and pack_groups' raw= / bit_base= arguments;
 - the host tables, equal to the JAX package's;
 - each slot function (_section_slots, _scf_slots, _tns_groups,
   _spectral_groups, sbr_slot_groups, assemble_superframes) against its JAX
   counterpart;
 - synthetic decisions from a seed that reach what signals may not: book-11
   escapes up to 8191, section runs past the escape (31 long, 7 short), PNS
   chains, TNS at full order with the low filter, the FIL escape (15 bytes
   and more) and the PS extension's escape: device pack == the Python AU
   writer == the native packer;
 - an AU forced past the pack bound: no exception, the warning, the other
   streams' bytes intact;
 - (slow) the pack bound against the worst recovered AU in all 384
   configurations.
The JAX functions run eagerly on the CPU (no step is compiled)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu import bitpack as JB
from odr_audioenc_tpu.dabplus import aupack as JA
from odr_audioenc_tpu.dabplus import model as JM
from odr_audioenc_tpu_torch import bitpack as TB
from odr_audioenc_tpu_torch.dabplus import aupack as TA
from odr_audioenc_tpu_torch.dabplus import model as TM
from odr_audioenc_tpu_torch.fec.rs import rs_dab, superframe_check_rs
from odr_audioenc_tpu_torch.host.aacpack import firecode_crc
from odr_audioenc_tpu_torch.host.dabplus_parse import validate_superframe

import test_torch_aupack_e2e as E2E

S = 3
NB = TA.NB
LC96 = dict(sample_rate=48000, subch=12, channels=2)
LC64M = dict(sample_rate=48000, subch=8, channels=1)
SBR48 = dict(sample_rate=48000, subch=6, channels=1, aot="sbr")
SBR64 = dict(sample_rate=48000, subch=8, channels=2, aot="sbr")
PS32 = dict(sample_rate=48000, subch=4, channels=2, aot="ps")
PS64 = dict(sample_rate=48000, subch=8, channels=2, aot="ps")      # 4 PS envelopes
_ENC = {}


def encoders(cfg):
    """(port encoder on the CPU, its pack tables, JAX encoder, its pack
    tables) for a configuration; host mode, made once per module."""
    key = tuple(sorted(cfg.items()))
    if key not in _ENC:
        tenc = TM.DabPlusEncoder(TM.DabPlusConfig(**cfg), S, dtype=torch.float32, device="cpu")
        jenc = JM.DabPlusEncoder(JM.DabPlusConfig(**cfg), n_streams=S)
        _ENC[key] = (tenc, TA.AuPackCtx(tenc), jenc, JA.AuPackCtx(jenc))
    return _ENC[key]


def tt(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t.to(dtype) if dtype is not None else t


def same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64), what)


# ---------------------------------------------------------------------------
# bitpack: crc_fixed, rs_bit_matrix, pack_groups(raw=, bit_base=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poly,nb", [(0x1021, 64), (0x782D, 9)], ids=["crc16", "firecode"])
def test_crc_fixed_equals_jax_and_the_bit_serial_crc(poly, nb):
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, (5, 4, nb))
    R = TB.CrcTable(poly, 16, 0, 8 * nb).R
    np.testing.assert_array_equal(R, JB.CrcTable(poly, 16, 0, 8 * nb).R)
    got = TB.crc_fixed(tt(buf), tt(R, torch.float32), 16, 0)
    assert got.dtype == torch.int32 and got.shape == (5, 4)
    same(got, JB.crc_fixed(jnp.asarray(buf), jnp.asarray(R, jnp.bfloat16), 16, 0))
    for i, j in ((0, 0), (4, 3)):
        msg = int.from_bytes(bytes(buf[i, j].tolist()), "big")
        assert int(got[i, j]) == TB._crc_ref(msg, 8 * nb, 0, poly, 16)
    # the byte dtype does not matter, and init_contrib is XORed in
    same(TB.crc_fixed(tt(buf, torch.uint8), tt(R, torch.float32), 16, 0x1D0F), got ^ 0x1D0F)


def test_crc_fixed_firecode_is_the_host_firecode():
    rng = np.random.default_rng(4)
    buf = rng.integers(0, 256, (6, 9))
    got = TB.crc_fixed(tt(buf), tt(TA._fire_R_np(72), torch.float32), 16, 0)
    assert [int(x) for x in got] == [firecode_crc(bytes(r.tolist())) for r in buf]


def test_rs_bit_matrix_equals_jax_and_the_encoder():
    from odr_audioenc_tpu.fec.rs import rs_dab as jax_rs_dab
    rs = rs_dab()
    M = TB.rs_bit_matrix(rs)
    assert M.shape == (880, 80) and set(np.unique(M)) <= {0, 1}
    np.testing.assert_array_equal(M, JB.rs_bit_matrix(jax_rs_dab()))
    data = np.random.default_rng(5).integers(0, 256, (7, 110)).astype(np.uint8)
    par_bits = (np.unpackbits(data, axis=1).astype(np.int64) @ M.astype(np.int64)) & 1
    np.testing.assert_array_equal(np.packbits(par_bits.astype(np.uint8), axis=1),
                                  rs.encode(data))


def test_pack_groups_raw_and_bit_base_equal_jax():
    """The two uses of assemble_superframes: header fields with raw byte
    placements (indices outside the buffer dropped), and a slot group
    starting at a per-row bit offset."""
    rng = np.random.default_rng(6)
    n_bytes = 40
    w = rng.integers(0, 17, (4, 9))
    v = rng.integers(0, 1 << 16, (4, 9))
    idx = np.stack([rng.permutation(60)[:12] for _ in range(4)])    # some past the end
    idx[:, 0] = n_bytes + 31
    val = rng.integers(0, 256, (4, 12))
    # raw bytes may only land where the slots left zeros: slots end by byte 19
    idx = np.where(idx < 20, idx + 20, idx)
    got, bits = TB.pack_groups([(tt(w), tt(v), 3)], n_bytes, raw=[(tt(idx), tt(val))])
    want, wbits = JB.pack_groups([(jnp.asarray(w, jnp.int32), jnp.asarray(v, jnp.int32), 3)],
                                 n_bytes, raw=[(jnp.asarray(idx, jnp.int32),
                                                jnp.asarray(val, jnp.int32))])
    same(got, want)
    same(bits, wbits)
    base = rng.integers(0, 100, 4)
    got, bits = TB.pack_groups([(tt(w), tt(v), 3)], n_bytes, bit_base=tt(base))
    want, wbits = JB.pack_groups([(jnp.asarray(w, jnp.int32), jnp.asarray(v, jnp.int32), 3)],
                                 n_bytes, bit_base=jnp.asarray(base, jnp.int32))
    same(got, want)
    same(bits, wbits)
    # a slot starting before the buffer or past it is dropped, not an error:
    # row 0 straddles bit 0, row 1 starts at the end, row 2 straddles the end
    base = np.array([-40, 8 * n_bytes, 8 * n_bytes - 40, 5])
    got, _ = TB.pack_groups([(tt(w), tt(v), 3)], n_bytes, bit_base=tt(base))
    want, _ = JB.pack_groups([(jnp.asarray(w, jnp.int32), jnp.asarray(v, jnp.int32), 3)],
                             n_bytes, bit_base=jnp.asarray(base, jnp.int32))
    same(got, want)
    # and against a bit-serial writer that keeps only the slots starting inside
    ref = np.zeros((4, 8 * n_bytes + 64), np.uint8)
    starts = base[:, None] + np.cumsum(w, 1) - w
    for r in range(4):
        for wi, vi, s in zip(w[r], v[r], starts[r]):
            if 0 <= s < 8 * n_bytes:
                ref[r, s:s + wi] = [((vi & ((1 << wi) - 1)) >> (wi - 1 - b)) & 1 for b in range(wi)]
    np.testing.assert_array_equal(np.asarray(got), np.packbits(ref[:, :8 * n_bytes], axis=1))
    assert np.asarray(got)[0].any() and not np.asarray(got)[1].any()


def merge_chunks(tab):
    """The JAX package's (len, 8-bit code chunk, ...) column groups as the
    port's (len, code) pairs.  tab: [n, k*g] with g = 3 (two chunks) or 4
    (three chunks) columns per codebook."""
    tab = np.asarray(tab).astype(np.int64)
    g = 4 if tab.shape[1] == 4 else 3
    cols = []
    for j in range(0, tab.shape[1], g):
        code = np.zeros(tab.shape[0], np.int64)
        for c in range(1, g):
            code = (code << 8) | tab[:, j + c]
        cols += [tab[:, j], code]
    return np.stack(cols, -1)


def test_host_tables_equal_jax():
    for name in ("q12", "q34", "p56", "p78", "p910", "p11", "scf"):
        np.testing.assert_array_equal(TA._code_tables()[name],
                                      merge_chunks(JA._code_tables()[name]), name)
    np.testing.assert_array_equal(TA._pair_tables_np(), merge_chunks(JA._pair_tables_np()))
    for k, v in JA._sbr_tabs().items():
        np.testing.assert_array_equal(TA._sbr_tabs()[k], v if k == "grid" else merge_chunks(v), k)
    for a, b in zip(TA._tail_tables(880), JA._tail_tables(880)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TA._crc_shift_tables(96, 330), JA._crc_shift_tables(96, 330)):
        np.testing.assert_array_equal(a, b)
    assert TA._fill_slots_host(3000) == JA._fill_slots_host(3000)
    assert [TA._mulmod_int(a, b) for a, b in ((0xFFFF, 0x8001), (0x1234, 0xBEEF))] == \
        [JA._mulmod_int(a, b) for a, b in ((0xFFFF, 0x8001), (0x1234, 0xBEEF))]


@pytest.mark.parametrize("cfg", [LC96, SBR48, PS32], ids=["lc96", "sbr48", "ps32"])
def test_context_equals_jax(cfg):
    _, tctx, _, jctx = encoders(cfg)
    for k in ("total", "nau", "header_bytes", "flags_byte", "hdr_pad4", "n_ch", "max_sfb",
              "msfb_s", "nsfb_s", "maxcb"):
        assert getattr(tctx, k) == getattr(jctx, k), k
    for k in ("bop_long", "bop_short", "tx_long", "tx_short", "gstart_long", "gstart_short",
              "perm_short", "crc_shift", "crc_init"):
        same(getattr(tctx, k), getattr(jctx, k), k)
    assert tctx.n_tx >= max(int(np.flatnonzero(jctx.tx_long).max()),
                            int(np.flatnonzero(jctx.tx_short).max())) + 1


def test_lookups_clamp_and_zero_outside():
    tab = torch.arange(10, 15, dtype=torch.int32)
    idx = torch.tensor([-3, 0, 4, 5, 99])
    assert TA._lut16(idx, tab).tolist() == [0, 10, 14, 0, 0]
    tab2 = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    cols = TA._lut_cols(torch.tensor([-1, 2, 3]), tab2)
    assert [c.tolist() for c in cols] == [[0, 8, 0], [0, 9, 0], [0, 10, 0], [0, 11, 0]]
    tab3 = torch.arange(8, dtype=torch.int32).reshape(2, 2, 2)
    cols = TA._lut_cols2(torch.tensor([0, 1, 2]), torch.tensor([1, -1, 0]), tab3)
    assert [c.tolist() for c in cols] == [[2, 0, 0], [3, 0, 0]]
    a = torch.tensor([0x1234, 0xFFFF, 1], dtype=torch.int32)
    b = torch.tensor([0xBEEF, 0x8001, 0x8000], dtype=torch.int32)
    assert TA._mulmod_dev(a, b).tolist() == [TA._mulmod_int(int(x), int(y))
                                             for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# synthetic legal decisions
# ---------------------------------------------------------------------------

BOOK_LIMIT = {1: 1, 2: 1, 3: 2, 4: 2, 5: 4, 6: 4, 7: 7, 8: 7, 9: 12, 10: 12, 11: 8191}
ESCAPES = (16, 17, 31, 32, 63, 100, 1023, 1024, 4095, 4096, 8191)


def synth_core(rng, enc, n_streams, density=0.25):
    """Legal core decisions [S, nau, ...] (the step's output keys) that no
    signal need reach: every book with signed values to its limit, book-11
    escapes to 8191, one section run over the whole transmitted range (past
    the 31 / 7 escape), PNS bands with a first energy far from global_gain
    and steps past +-60 (both writers clamp), regular deltas of exactly
    +-60, TNS at order 12 with the low filter, all four window sequences."""
    cfg, ch = enc.cfg, enc.core_channels
    nau = cfg.num_aus
    out = {"q": np.zeros((n_streams, nau, ch, 960), np.int16),
           "gains": rng.integers(-100, 156, (n_streams, nau, ch, NB)).astype(np.int16),
           "books": np.zeros((n_streams, nau, ch, NB), np.uint8),
           "ms_used": rng.random((n_streams, nau, NB)) < 0.5,
           "tns_en": np.zeros((n_streams, nau, ch), bool),
           "tns_order": np.zeros((n_streams, nau, ch), np.int8),
           "tns_idx": rng.integers(-8, 8, (n_streams, nau, ch, 12)).astype(np.int8),
           "tns_en_lo": np.zeros((n_streams, nau, ch), bool),
           "tns_order_lo": np.zeros((n_streams, nau, ch), np.int8),
           "tns_idx_lo": rng.integers(-8, 8, (n_streams, nau, ch, 12)).astype(np.int8),
           "tns_len": rng.integers(1, 40, (n_streams, nau, ch)).astype(np.int8),
           "wseq": np.zeros((n_streams, nau), np.int8),
           "bits": np.zeros((n_streams, nau), np.int32)}
    wpg = 8 // TA.AT.N_GROUPS
    for s in range(n_streams):
        for a in range(nau):
            wseq = (s + a) % 4 if (s, a) != (0, 0) else 2
            out["wseq"][s, a] = wseq
            short = wseq == 2
            if short:
                tx = [(g * enc.nsfb_short + b, g, b) for g in range(TA.AT.N_GROUPS)
                      for b in range(enc.max_sfb_short)]
            else:
                tx = [(b, 0, b) for b in range(enc.max_sfb)]
            for c in range(ch):
                mode = (s + a + c) % 3
                gain = int(rng.integers(-20, 60))
                noise = None
                for gb, g, b in tx:
                    if mode == 0:          # one run over every transmitted band
                        book = 1
                    elif mode == 1:        # every book, PNS among them
                        book = int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 13]))
                    else:                  # sparse: long zero runs, escapes
                        book = int(rng.choice([0, 0, 0, 0, 11, 13, 9]))
                    out["books"][s, a, c, gb] = book
                    if book == 13:
                        step = int(rng.choice([-90, -60, -7, 0, 3, 60, 75]))
                        noise = int(rng.integers(-150, 150)) if noise is None else noise + step
                        out["gains"][s, a, c, gb] = noise
                        continue
                    if book == 0:
                        continue
                    gain += int(rng.choice([-60, -5, -1, 0, 0, 1, 2, 60]))
                    gain = min(max(gain, -100), 155)
                    out["gains"][s, a, c, gb] = gain
                    if short:
                        off = enc.sfb_off_short
                        lines = np.concatenate([w * TA.AT.NS + np.arange(off[b], off[b + 1])
                                                for w in range(g * wpg, (g + 1) * wpg)])
                    else:
                        lines = np.arange(enc.sfb_off[b], enc.sfb_off[b + 1])
                    lim = min(BOOK_LIMIT[book], 15)
                    dens = density * (0.2 if mode == 0 else 1.0)
                    vals = rng.integers(-lim, lim + 1, len(lines)) * (rng.random(len(lines)) < dens)
                    if book == 11 and rng.random() < 0.5:
                        k = rng.integers(0, len(lines), 2)
                        vals[k] = rng.choice(ESCAPES, 2) * rng.choice([-1, 1], 2)
                    out["q"][s, a, c, lines] = vals
                # (the TNS syntax of these encoders is long-window only)
                if enc.tns_cfg is not None and not short and (s + a + c) % 2 == 0:
                    full = (s + a) % 4 == 0        # both filters at the full order
                    out["tns_en"][s, a, c] = True
                    out["tns_order"][s, a, c] = 12 if full else int(rng.integers(1, 12))
                    lo = full or rng.random() < 0.5
                    out["tns_en_lo"][s, a, c] = lo
                    out["tns_order_lo"][s, a, c] = (12 if full else int(rng.integers(1, 12))) \
                        if lo else 0
    return out


def synth_side(rng, enc, n_streams):
    """Legal SBR (and PS) side data [S, nau, ...]: envelope and noise values
    inside their start widths, steps within and past each book's LAV (both
    writers clamp), transient and additional-harmonics flags, coupled and
    uncoupled AUs, coarse and fine IID with every envelope."""
    p, nau, ch = enc.sbr_params, enc.cfg.num_aus, enc.core_channels
    n_hi = p.n_hi
    lead = (n_streams, nau, ch)

    def walk(shape, lo, hi, step):
        x = np.cumsum(rng.integers(-step, step + 1, shape), axis=-1) + rng.integers(lo, hi, shape[:-1]
                                                                                  )[..., None]
        return np.clip(x, lo, hi - 1).astype(np.int32)

    side = {"sbr_env": walk(lead + (n_hi,), 0, 30, 14),
            "sbr_env2": walk(lead + (2, n_hi), 0, 30, 14),
            "sbr_transient": rng.random(lead) < 0.4,
            "sbr_noise_q": walk(lead + (p.n_q,), 0, 30, 14),
            "sbr_invf": rng.integers(0, 4, lead + (p.n_q,)).astype(np.int32),
            "sbr_addharm": (rng.random(lead + (n_hi,)) < 0.3) & (rng.random(lead)[..., None] < 0.5),
            "sbr_tgrid": rng.integers(0, 8, lead).astype(np.int32)}
    if ch == 2:
        side["sbr_cpl"] = rng.random((n_streams, nau)) < 0.5
    if enc.is_ps:
        ne = enc.ps_nenv
        side.update(ps_iid=walk((n_streams, nau, ne, 20), -7, 8, 9),
                    ps_iid_fine=walk((n_streams, nau, ne, 20), -15, 16, 20),
                    ps_icc=walk((n_streams, nau, ne, 20), 0, 8, 5),
                    ps_fine=rng.random((n_streams, nau)) < 0.5)
    return side


def synth_outputs(cfg, seed, density=0.25):
    tenc = encoders(cfg)[0]
    rng = np.random.default_rng(seed)
    out = synth_core(rng, tenc, S, density)
    if tenc.is_sbr:
        out.update(synth_side(rng, tenc, S))
    # keep every AU inside its share of the superframe (and so inside the
    # pack bound): zero half of its nonzero lines until it fits
    room = min(tenc.packer.payload_bits() // tenc.cfg.num_aus - 16, 8 * encoders(cfg)[1].maxcb)
    for s, a in np.ndindex(S, tenc.cfg.num_aus):
        while True:
            bw = tenc.write_au(out, s, a)
            if len(bw.buf) * 8 + bw.nbits <= room:
                break
            c, lines = np.nonzero(out["q"][s, a])
            if len(c) == 0:             # the side info alone is too much: an empty core
                assert out["books"][s, a].any(), "the side data alone overflows the AU"
                out["books"][s, a] = 0
            drop = rng.random(len(c)) < 0.5
            out["q"][s, a, c[drop], lines[drop]] = 0
    return out


def au_frame(out, a):
    """One AU's slice of the outputs, as the slot functions take it."""
    return {k: np.asarray(out[k])[:, a] for k in TA.CORE_KEYS}


# ---------------------------------------------------------------------------
# slot functions against JAX
# ---------------------------------------------------------------------------

def groups_equal(got, want, what):
    assert len(got) == len(want), what
    for i, ((gw, gv, gs), (ww, wv, ws)) in enumerate(zip(got, want)):
        assert gs == ws, (what, i)
        same(gw, ww, f"{what} group {i} widths")
        # a value only matters inside its width
        gm = TB._mask_to_width(gv.long(), gw.long())
        wm = np.asarray(JB._mask_to_width(jnp.asarray(wv, jnp.int32), jnp.asarray(ww, jnp.int32)))
        same(gm, wm, f"{what} group {i} values")


@pytest.mark.parametrize("cfg", [LC96, LC64M], ids=["lc96", "lc64-mono"])
def test_core_slot_functions_equal_jax(cfg):
    """_ics_info_slot, _section_slots, _scf_slots, _tns_groups and
    _spectral_groups on synthetic decisions, AU by AU and channel by
    channel; then au_content_groups and pack_au_content as a whole."""
    tenc, tctx, _, jctx = encoders(cfg)
    out = synth_outputs(cfg, 21)
    runs = []
    for a in range(tenc.cfg.num_aus):
        fr = au_frame(out, a)
        wseq = fr["wseq"].astype(np.int32)
        short_t, short_j = tt(wseq == 2), jnp.asarray(wseq == 2)
        iw, iv = TA._ics_info_slot(tctx, tt(wseq), short_t)
        jw, jv = JA._ics_info_slot(jctx, jnp.asarray(wseq), short_j)
        same(iw, jw)
        same(iv, jv)
        for c in range(tctx.n_ch):
            books = fr["books"][:, c].astype(np.int32)
            gains = fr["gains"][:, c].astype(np.int32)
            q = fr["q"][:, c].astype(np.int32)
            sw, sv = TA._section_slots(tctx, tt(books), short_t)
            jsw, jsv = JA._section_slots(jctx, jnp.asarray(books), short_j)
            same(sw, jsw, "section widths")
            same(sv, jsv, "section values")
            runs.append(int(np.asarray(jsw).max()))
            fw, fv, gg = TA._scf_slots(tctx, tt(books), tt(gains), short_t)
            jfw, jfv, jgg = JA._scf_slots(jctx, jnp.asarray(books), jnp.asarray(gains), short_j)
            same(fw, jfw, "scf widths")
            same(fv, jfv, "scf values")
            same(gg, jgg, "global gain")
            t_args = [fr[k][:, c] for k in ("tns_en", "tns_order", "tns_idx", "tns_en_lo",
                                            "tns_order_lo", "tns_idx_lo")]
            groups_equal(TA._tns_groups(tctx, *[tt(x) for x in t_args],
                                        tns_len=tt(fr["tns_len"][:, c])),
                         JA._tns_groups(jctx, *[jnp.asarray(x) for x in t_args],
                                        tns_len=jnp.asarray(fr["tns_len"][:, c])), "tns")
            groups_equal(TA._spectral_groups(tctx, tt(q), tt(books), short_t),
                         JA._spectral_groups(jctx, jnp.asarray(q), jnp.asarray(books), short_j),
                         "spectral")
        last = a == tenc.cfg.num_aus - 1
        tg = TA.au_content_groups(tctx, {k: tt(v) for k, v in fr.items()}, last)
        jg = JA.au_content_groups(jctx, {k: jnp.asarray(v.astype(np.int32)) for k, v in fr.items()},
                                  jnp.asarray(last))
        groups_equal(tg, jg, f"AU {a}")
        buf, bits, crc = TA.pack_au_content(tctx, tg)
        jbuf, jbits, jcrc = JA.pack_au_content(jctx, jg)
        same(buf, jbuf)
        same(bits, jbits)
        same(crc, jcrc)
    # section widths past one escape: 4 + 3 * 5 (long, run >= 31), 4 + 2 * 3 (short, run >= 7)
    assert max(runs) >= 14


@pytest.mark.parametrize("cfg,seed", [(SBR48, 31), (SBR64, 32), (PS32, 33), (PS64, 34)],
                         ids=["mono", "stereo", "ps-2env", "ps-4env"])
def test_sbr_slot_groups_equal_jax(cfg, seed):
    """Mono, stereo (coupled and uncoupled AUs), PS coarse and fine."""
    tenc, tctx, jenc, _ = encoders(cfg)
    out = synth_outputs(cfg, seed)
    side = {k: v for k, v in out.items() if k.startswith(("sbr_", "ps_"))}
    if "sbr_cpl" in side:
        assert side["sbr_cpl"].any() and not side["sbr_cpl"].all()
    if tenc.is_ps:
        assert side["ps_fine"].any() and not side["ps_fine"].all()
        groups, ps_bits = TA._ps_slot_groups(tctx, {k: tt(v) for k, v in side.items()})
        jgroups, jps_bits = JA._ps_slot_groups({k: jnp.asarray(v) for k, v in side.items()})
        groups_equal(groups, jgroups, "ps")
        same(ps_bits, jps_bits)
    w, v = TA.sbr_slot_groups(tctx, {k: tt(x) for k, x in side.items()})
    jw, jv = JA.sbr_slot_groups(jenc, {k: jnp.asarray(x) for k, x in side.items()})
    assert w.dtype == torch.int32 and v.dtype == torch.int32
    same(w, jw)
    same(TB._mask_to_width(v.long(), w.long()),
         np.asarray(JB._mask_to_width(jnp.asarray(jv), jnp.asarray(jw))))
    # ID_FIL and the 4-bit count, then whole bytes; from 15 bytes on the count's escape
    bits = w.sum(-1).numpy()
    assert (bits % 8 == 7).all() and (bits >= 7 + 8 + 15 * 8).any()


@pytest.mark.parametrize("cfg", [LC96, SBR48], ids=["lc96", "sbr48"])
@pytest.mark.parametrize("add_rs", [True, False])
def test_assemble_superframes_equals_jax(cfg, add_rs):
    """Random AU buffers whose lengths fill the superframe to different
    degrees, with arbitrary CRC reductions."""
    tenc, tctx, _, jctx = encoders(cfg)
    rng = np.random.default_rng(41)
    nau, maxcb = tctx.nau, tctx.maxcb
    room = tctx.total - tctx.header_bytes - 2 * nau
    fill = np.array([0.2, 0.7, 1.0])[:, None]
    au_bytes = np.minimum((room // nau * fill * rng.uniform(0.5, 1.0, (S, nau))).astype(np.int64),
                          maxcb)
    au_bytes[2, :-1] = room // nau          # the last AU gets what is left: a short tail
    au_bits = np.maximum(au_bytes * 8 - rng.integers(0, 8, (S, nau)), 16)
    au_bits[2, -1] = (room - au_bytes[2, :-1].sum()) * 8 - 3
    aubuf = rng.integers(0, 256, (S, nau, maxcb))
    aubuf = np.where(np.arange(maxcb) < ((au_bits + 7) // 8)[..., None], aubuf, 0)
    crc = rng.integers(0, 1 << 16, (S, nau))
    sf, lens = TA.assemble_superframes(tctx, tt(aubuf, torch.uint8), tt(au_bits), tt(crc),
                                       add_rs=add_rs)
    jsf, jlens = JA.assemble_superframes(jctx, jnp.asarray(aubuf, jnp.int32),
                                         jnp.asarray(au_bits, jnp.int32),
                                         jnp.asarray(crc, jnp.int32), add_rs=add_rs)
    assert sf.dtype == torch.uint8
    assert sf.shape == (S, tctx.total // 110 * (120 if add_rs else 110))
    same(sf, jsf)
    same(lens, jlens)
    if add_rs:
        assert all(superframe_check_rs(r) for r in sf.numpy())


# ---------------------------------------------------------------------------
# synthetic decisions through the whole pack, against the host writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,seed", [(LC96, 51), (LC64M, 52), (SBR64, 53), (PS32, 54), (PS64, 55)],
                         ids=["lc96", "lc64-mono", "sbr64", "ps32", "ps64"])
def test_synthetic_decisions_device_pack_equals_host_writers(cfg, seed):
    tenc, tctx, _, _ = encoders(cfg)
    out = synth_outputs(cfg, seed, density=0.12 if cfg.get("aot") else 0.25)
    host = tenc.pack_superframes(out, add_rs=True, use_native=False)
    dev = TA.pack_from_outputs(tenc, out, add_rs=True, ctx=tctx)
    for s in range(S):
        d = dev[s].tobytes()
        assert d == host[s], f"stream {s}: first difference at byte " \
            f"{next(j for j in range(len(d)) if d[j] != host[s][j])}"
        assert superframe_check_rs(dev[s]) and validate_superframe(d)[0]
    assert tenc.pack_superframes(out, add_rs=True, use_native=True) == host
    # what the synthetic decisions reached
    q = np.abs(out["q"].astype(np.int64))
    if not cfg.get("aot"):
        assert q.max() == 8191 and ((out["books"] == 13).sum(-1) >= 2).any()
        assert (out["tns_order"] == 12).any() and (out["tns_order_lo"] == 12).any()
    if tenc.is_ps:
        side = {k: tt(v) for k, v in out.items() if k.startswith("ps_")}
        ps_bits = TA._ps_slot_groups(tctx, side)[1].numpy()
        assert ((ps_bits + 2 + 7) // 8 >= 15).any(), "no PS extension reached its escape"


@pytest.mark.parametrize("case", E2E.CASES[4:], ids=E2E.case_id)
def test_device_pack_matches_host_and_jax_heaac(case):
    """The HE-AAC and HE-AAC v2 configurations of test_torch_aupack_e2e.py's
    comparison on four signals (here, to share the two files' time)."""
    E2E.run_pack_case(case, False)


# ---------------------------------------------------------------------------
# an AU past the pack bound
# ---------------------------------------------------------------------------

def test_overflowing_au_corrupts_its_stream_only(capsys):
    """A stream whose AU exceeds the pack bound (unreachable while crash
    recovery holds its bound) yields a corrupt superframe and a warning;
    nothing raises and the other streams' bytes are the host writer's."""
    cfg = LC96
    tenc, tctx, _, _ = encoders(cfg)
    out = synth_outputs(cfg, 61)
    good = TA.pack_from_outputs(tenc, out, ctx=tctx)
    big = {k: np.array(v) for k, v in out.items()}
    # stream 1, AU 2: every band book 11 with large escapes, ~20 kbit per channel
    big["wseq"][1, 2] = 0
    big["books"][1, 2, :, :tenc.max_sfb] = 11
    big["gains"][1, 2, :, :] = 10
    big["q"][1, 2, :, :int(tenc.sfb_off[tenc.max_sfb])] = 8191
    fr = {k: tt(big[k][:, 2]) for k in TA.CORE_KEYS}
    _, bits, _ = TA.pack_au_content(tctx, TA.au_content_groups(tctx, fr, False))
    assert int(bits[1]) > 8 * tctx.maxcb and (bits[[0, 2]] <= 8 * tctx.maxcb).all()
    got = TA.pack_from_outputs(tenc, big, ctx=tctx)
    assert got.shape == good.shape
    np.testing.assert_array_equal(got[[0, 2]], good[[0, 2]])
    try:
        valid = validate_superframe(got[1].tobytes())[0]
    except ValueError:          # its AU starts are out of order
        valid = False
    assert not valid
    # the same through the device-mode encoder's output leaf: the warning names the stream
    denc = TM.DabPlusEncoder(TM.DabPlusConfig(**cfg), S, dtype=torch.float32, device="cpu",
                             pack_on_device=True)
    nau = denc.cfg.num_aus
    ab = np.zeros((S, nau), np.int64)
    ab[1, 2] = int(bits[1])
    tail = np.concatenate([np.zeros((S, 2 * nau), np.int64), ab & 0xFF, ab >> 8], axis=1)
    wire = np.concatenate([got, tail.astype(np.uint8)], axis=1)
    frames = denc.pack_superframes({"wire": torch.as_tensor(wire)}, add_rs=True)
    assert [bytes(f) for f in frames] == [g.tobytes() for g in got]
    err = capsys.readouterr().err
    assert "exceeds the device pack bound" in err and "[1]" in err


def test_pack_on_device_constructs_for_lc_sbr_ps():
    for cfg in (LC96, SBR48, PS32):
        enc = TM.DabPlusEncoder(TM.DabPlusConfig(**cfg), 1, device="cpu", pack_on_device=True)
        ctx = enc.aupack_ctx
        assert ctx.maxcb % 32 == 0 and ctx.crc16_R.shape == (8 * ctx.maxcb, 16)
        assert ctx.crc16_R.dtype == torch.float32 and set(ctx.rs_M.unique().tolist()) == {0.0, 1.0}
        worst = 2 * enc.budget_au + enc.bitres_max + 8
        assert worst <= 8 * ctx.maxcb


def test_pack_bound_assert_fires():
    """AuPackCtx refuses a configuration whose worst recovered AU exceeds the bound."""
    enc = TM.DabPlusEncoder(TM.DabPlusConfig(**LC96), 1, device="cpu")
    enc.budget_au *= 4
    with pytest.raises(AssertionError, match="device-pack AU bound"):
        TA.AuPackCtx(enc)


@pytest.mark.slow
def test_pack_bound_covers_recovery_bound_all_configs():
    """Every CLI-reachable DAB+ configuration constructs with the device
    pack: AuPackCtx asserts that the rate loop's crash-recovery bit bound
    (budget_au + bitres_max + X-PAD DSE + align) fits the content buffer."""
    n = 0
    for rate in (48000, 32000):
        for subch in range(1, 25):
            for ch in (1, 2):
                for aot in ("lc", "sbr", "ps"):
                    if aot == "ps" and ch != 2:
                        continue
                    for pad_len in (0, 58):
                        cfg = TM.DabPlusConfig(rate, subch, ch, aot=aot, pad_len=pad_len)
                        TM.DabPlusEncoder(cfg, 1, device="cpu", pack_on_device=True)
                        n += 1
    assert n == 480
