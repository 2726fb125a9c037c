"""Batched Layer-II scalefactor / scfsi / bit-allocation / quantization
(port of odr_audioenc_tpu/mp2/allocate.py; libtoolame-dab/encode_new.c).

Table lookups are integer indexing and `gather`; the greedy allocator's
per-pick updates index the picked slot directly.  Every decision comparison
replicates the C expression, so the f64 path is bit-exact.
"""
import numpy as np
import torch

from odr_audioenc_tpu import tables as T

from ..device import const

SBLIMIT = 32
BANC = 32  # header bits
BERR = 16  # CRC bits (error_protection always on in the DAB tool)

_SFS = T.SFS_PER_SCFSI
_GBQ = (12 * np.asarray(T.GROUP) * np.asarray(T.BITS)).astype(np.int64)  # [18]


def _arange(n, like):
    return torch.arange(n, device=like.device)


def scalefactor_calc(sb_sample):
    """sb_sample: [..., 3, 12, 32] -> sf indices [..., 3, 32] int32
    (scalefactor_calc_new, encode_new.c:179-230)."""
    cur_max = sb_sample.abs().amax(dim=-2)                      # [..., 3, 32]
    tab = const(T.SCALEFACTOR, sb_sample.device, sb_sample.dtype)
    count = (tab >= cur_max[..., None]).sum(dim=-1)
    return (count - 1).clamp(0, 63).to(torch.int32)


def find_sf_max(sf_index, sblimit, dtype):
    """multiple[min over gr] per (ch, sb); 1e-20 above sblimit
    (find_sf_max, encode_new.c:260-277).  sf_index: [B, 2, 3, 32]."""
    low = sf_index.amin(dim=-2).long()                          # [B, 2, 32]
    mult = const(T.SCALEFACTOR, sf_index.device, dtype)[low]
    mask = _arange(SBLIMIT, sf_index) < sblimit[:, None, None]
    return torch.where(mask, mult, torch.full_like(mult, 1e-20))


def combine_lr(sb_sample):
    """joint = .5*(L+R) (combine_LR_new, encode_new.c:237-246)."""
    return 0.5 * (sb_sample[:, 0] + sb_sample[:, 1])


# scfsi pattern -> (code, rewritten sf0/sf1/sf2); patterns enumerated
# 0x123,0x122,0x133,0x113,0x111,0x222,0x333,0x444
# (sf_transmission_pattern, encode_new.c:288-354)
_PATTERNS = [0x123, 0x122, 0x133, 0x113, 0x111, 0x222, 0x333, 0x444]
_PAT_CODE = np.array([0, 3, 3, 1, 2, 2, 2, 2], np.int32)
_PAT_LUT = np.zeros((5, 5), np.int32)
for _i in range(5):
    for _j in range(5):
        _PAT_LUT[_i, _j] = _PATTERNS.index(int(T.SCFSI_PATTERN[_i, _j]))


def _classify(d):
    return torch.where(d <= -3, 0, torch.where(d < 0, 1, torch.where(
        d == 0, 2, torch.where(d < 3, 3, 4))))


def _select(conds, vals, default):
    """jnp.select: the first true condition picks its value."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def sf_transmission_pattern(sf_index):
    """sf_index: [B, 2, 3, 32] -> (adjusted sf_index, scfsi [B, 2, 32])."""
    sf0, sf1, sf2 = sf_index[..., 0, :], sf_index[..., 1, :], sf_index[..., 2, :]
    dev = sf_index.device
    c0 = _classify(sf0.long() - sf1.long())
    c1 = _classify(sf1.long() - sf2.long())
    pat = const(_PAT_LUT, dev, torch.int64)[c0, c1]  # [B, 2, 32]
    code = const(_PAT_CODE, dev)[pat]
    min02 = torch.minimum(sf0, sf2)
    p = [pat == k for k in range(8)]
    n0 = _select([p[5], p[6], p[7]], [sf1, sf2, min02], sf0)
    n1 = _select([p[3], p[4], p[2], p[5], p[6], p[7]],
                 [sf0, sf0, sf2, sf1, sf2, min02], sf1)
    n2 = _select([p[1], p[4], p[5], p[6], p[7]],
                 [sf1, sf0, sf1, sf2, min02], sf2)
    return torch.stack([n0, n1, n2], dim=-2), code


def _frame_tables(tablenum):
    """Per-stream alloc tables.  tablenum: [B] -> dict of [B,32] / [B,32,16]
    tensors.  line==-1 (above sblimit) maps to nbal 0, matching the
    reference's benign OOB read of nbal[-1] (== step_index[8][15] == 0)."""
    dev = tablenum.device
    line = const(T.LINE, dev, torch.int64)[tablenum.long()]          # [B, 32]
    line_c = line.clamp_min(0)
    nbal = torch.where(line < 0, 0, const(T.NBAL, dev, torch.int64)[line_c])
    step_idx = const(T.STEP_INDEX, dev, torch.int64)[line_c]  # [B, 32, 16]
    return {"line": line, "nbal": nbal, "step_idx": step_idx,
            "max_alloc": (1 << nbal) - 1,                       # 0 above sblimit
            "snr_steps": const(T.SNR, dev)[step_idx],           # float64
            "gb_steps": const(_GBQ, dev)[step_idx]}


def _ba_for_mnr(smr, ft, nch, jsbound):
    """First allocation index reaching min_mnr=0 per (ch, sb), with the
    joint-stereo continuation = max over channels above jsbound
    (bits_for_nonoise_new, encode_new.c:668-703)."""
    snr = ft["snr_steps"].to(smr.dtype)                         # [B, 32, 16]
    max_alloc = ft["max_alloc"]
    k16 = _arange(16, smr)
    ok = (snr[:, None] - smr[..., None]) >= 0.0                 # [B, 2, 32, 16]
    ok = ok & (k16 < (max_alloc[:, None, :, None] - 1))
    first = torch.where(ok, k16, 16).amin(dim=-1)
    ba = torch.where(ok.any(dim=-1), first,
                     (max_alloc[:, None, :] - 1).clamp_min(0))
    is_js = (_arange(SBLIMIT, smr)[None, :] >= jsbound[:, None]) & (nch[:, None] == 2)
    ba0 = torch.where(is_js, torch.maximum(ba[:, 0], ba[:, 1]), ba[:, 0])
    return torch.stack([ba0, ba[:, 1]], dim=1)                  # [B, 2, 32]


def bits_for_nonoise(smr, scfsi, ft, sblimit, nch, jsbound):
    """Total bits required for transparent coding at a given jsbound
    (bits_for_nonoise_new)."""
    sb = _arange(SBLIMIT, smr)[None, :]
    below = sb < sblimit[:, None]
    chmul = torch.where(sb < jsbound[:, None], nch[:, None], 1)
    bbal = (ft["nbal"] * chmul * below).sum(dim=1)
    req = BANC + bbal + BERR

    ba = _ba_for_mnr(smr, ft, nch, jsbound)
    B = smr.shape[0]
    smp = torch.gather(ft["gb_steps"][:, None].expand(B, 2, SBLIMIT, 16), -1,
                       ba[..., None])[..., 0]                   # 12*group*bits at ba
    sfs = const(_SFS, smr.device, torch.int64)[scfsi.long()]  # [B, 2, 32]
    is_js = (sb >= jsbound[:, None])[:, None, :] & (nch[:, None, None] == 2)
    sel = 2 + torch.where(is_js, 2, 0)
    sc = 6 * sfs + torch.where(is_js, 6 * sfs.flip(1), 0)
    # channel loop: ch < nch below jsbound, ch < 1 above
    ch_on = torch.stack([torch.ones_like(is_js[:, 0]),
                         (~is_js[:, 0]) & (nch[:, None] == 2)], dim=1)
    active = ch_on & below[:, None, :] & (ba > 0)
    return req + torch.where(active, smp + sel + sc, 0).sum(dim=(1, 2))


def js_mode_select(smr, scfsi, ft, sblimit, nch, is_joint, adb):
    """Joint-stereo mode_ext walk-down (main_bit_allocation_new,
    encode_new.c:803-819).  Returns (mode_is_stereo [B] bool, mode_ext [B],
    jsbound [B])."""
    variants = [sblimit] + [torch.full_like(sblimit, v) for v in (16, 12, 8, 4)]
    fits = [bits_for_nonoise(smr, scfsi, ft, sblimit, nch, v) <= adb
            for v in variants]
    # first fitting variant in order [stereo, ext3, ext2, ext1]; else ext0
    four = torch.full_like(sblimit, 4)
    idx = _select(fits[:4], [torch.full_like(sblimit, k) for k in range(4)], four)
    idx = torch.where(is_joint, idx, 0)
    mode_is_stereo = idx == 0
    mode_ext = torch.where(mode_is_stereo, 0, 4 - idx)
    jsb = const(T.JSB_TABLE, smr.device, torch.int64)[mode_ext.clamp(0, 3).long()]
    jsbound = torch.where(is_joint & ~mode_is_stereo, jsb, sblimit.long())
    return mode_is_stereo, mode_ext, jsbound


def _ladder_tables(smr, scfsi, ft, sblimit, nch, jsbound):
    """Rung tables for the sorted-greedy allocator.

    A 'ladder' is one (ch, sb) allocation slot; above jsbound in stereo the
    two channels share one ladder (in channel-0's slot) whose MNR uses
    max(SMR_L, SMR_R) - what the C greedy converges to, since the mirrored
    update keeps both channels equal and the argmin sees the worse first.
    Returns [B, 1024] rung data (2 ch x 32 sb x 16 rungs) and the [B, 32]
    joint-ladder mask."""
    B = smr.shape[0]
    dtype = smr.dtype
    sb = _arange(SBLIMIT, smr)[None, :]
    below = sb < sblimit[:, None]
    is_js = (sb >= jsbound[:, None]) & (nch[:, None] == 2)     # [B, 32]

    smr_eff0 = torch.where(is_js, torch.maximum(smr[:, 0], smr[:, 1]), smr[:, 0])
    smr_eff = torch.stack([smr_eff0, smr[:, 1]], dim=1)         # [B, 2, 32]
    active = torch.stack([below, below & (nch[:, None] == 2) & ~is_js], dim=1)

    # tie-break index = the flat (ch*32+sb) the C argmin would report
    tie0 = torch.where(is_js & (smr[:, 1] > smr[:, 0]), 32 + sb, sb)
    tie = torch.stack([tie0, (32 + sb).expand_as(tie0)], dim=1)  # [B, 2, 32]

    gb = ft["gb_steps"]                                         # [B, 32, 16]
    inc = torch.cat([gb[:, :, :1], gb[:, :, 1:] - gb[:, :, :-1]], dim=2)
    snr = ft["snr_steps"].to(dtype)
    # sort key for rung k = MNR at ba=k-1 (what maxmnr_new sees when picking)
    mnr_prev = torch.cat([torch.full((B, SBLIMIT, 1), float(T.SNR[0]), dtype=dtype,
                                     device=smr.device), snr[:, :, :-1]], dim=2)
    keys = mnr_prev[:, None] - smr_eff[..., None]               # [B, 2, 32, 16]
    # maxmnr_new's small=999999.0 start makes such entries unselectable
    keys = torch.where(keys < 999999.0, keys, torch.inf)

    sfs = const(_SFS, smr.device, torch.int64)[scfsi.long()]  # [B, 2, 32]
    first_extra0 = torch.where(is_js, 4 + 6 * (sfs[:, 0] + sfs[:, 1]),
                               2 + 6 * sfs[:, 0])
    first_extra = torch.stack([first_extra0, 2 + 6 * sfs[:, 1]], dim=1)

    kk = _arange(16, smr)
    # rungs run up to ba == max_alloc == (1<<nbal)-1 (a_bit_allocation_new
    # marks used=2 when ba reaches it, encode_new.c:1161)
    rung_valid = (kk >= 1) & (kk <= ft["max_alloc"][:, :, None])
    cost = inc[:, None].repeat(1, 2, 1, 1)                      # [B, 2, 32, 16]
    cost[..., 1] += first_extra
    valid = rung_valid[:, None] & active[..., None]
    R = 2 * SBLIMIT * 16
    return {
        "keys": torch.where(valid, keys, torch.inf).reshape(B, R),
        "cost": torch.where(valid, cost, 0).reshape(B, R),
        "tie": tie[..., None].expand(B, 2, SBLIMIT, 16).reshape(B, R),
        "valid": valid.reshape(B, R),
        "is_js": is_js,
    }


def _ordered_key_bits(keys):
    """Order-preserving map IEEE float -> SIGNED int of the same width, so
    `a < b` on floats equals `m(a) < m(b)` on ints: negative floats get
    their magnitude bits flipped.  (The JAX version maps into unsigned
    ints; CUDA and torch have little unsigned support.  The two images
    differ by the top bit, m_u = m_s ^ top, which is an order isomorphism.)
    Returns (mapped ints, bit width)."""
    if keys.dtype == torch.float64:
        s = keys.view(torch.int64)
        return torch.where(s < 0, s ^ 0x7FFFFFFFFFFFFFFF, s), 64
    s = keys.to(torch.float32).view(torch.int32)
    return torch.where(s < 0, s ^ 0x7FFFFFFF, s), 32


def a_bit_allocation(smr, scfsi, ft, sblimit, nch, jsbound, adb):
    """Greedy min-MNR allocation (a_bit_allocation_new, encode_new.c:1078-1187)
    as sorted-rung prefix + exact sequential tail.

    The C loop's pick sequence equals the rung list sorted by
    (MNR-before-rung, scan index), and no slot can freeze before the first
    rung that exceeds the budget, so the longest affordable prefix is
    allocated wholesale: a bitwise bisection on the ordered integer image of
    the key finds the threshold key, a second 16-bit bisection on
    (tie*1024 + pos) orders rungs inside that group.  The short tail runs
    the faithful loop (_alloc_tail).  Returns (bit_alloc [B,2,32] int64,
    adb_left [B])."""
    B = smr.shape[0]
    sb = _arange(SBLIMIT, smr)[None, :]
    below = sb < sblimit[:, None]
    chmul = torch.where(sb < jsbound[:, None], nch[:, None], 1)
    bbal = (ft["nbal"] * chmul * below).sum(dim=1)
    ad = adb - (bbal + BERR + BANC)

    lt = _ladder_tables(smr, scfsi, ft, sblimit, nch, jsbound)
    R = lt["keys"].shape[-1]
    pos = _arange(R, smr)[None, :]
    ikey, nbits = _ordered_key_bits(lt["keys"])                 # [B, R]
    cost = lt["cost"]
    total = cost.sum(dim=-1)
    all_true = total <= ad

    # bisection over the unsigned image, bit by bit from the top; in the
    # signed image the unsigned zero is the most negative int, and setting
    # the unsigned top bit clears the signed one
    lowest = torch.iinfo(ikey.dtype).min
    tk = torch.full((B,), lowest, dtype=ikey.dtype, device=smr.device)
    for i in range(nbits):
        cand = tk ^ lowest if i == 0 else tk | (1 << (nbits - 1 - i))
        s = torch.where(ikey < cand[:, None], cost, 0).sum(dim=-1)
        tk = torch.where(s <= ad, cand, tk)                     # threshold key
    below_grp = ikey < tk[:, None]
    in_grp = ikey == tk[:, None]
    ad2 = ad - torch.where(below_grp, cost, 0).sum(dim=-1)
    comp = lt["tie"] * R + pos                                  # strict in-group order

    # comp = tie*1024 + pos with tie <= 63, pos <= 1023: 16 bits exactly
    ck = torch.zeros((B,), dtype=comp.dtype, device=smr.device)
    for i in range(16):
        cand = ck | (1 << (15 - i))
        s = torch.where(in_grp & (comp < cand[:, None]), cost, 0).sum(dim=-1)
        ck = torch.where(s <= ad2, cand, ck)
    before_thr = below_grp | (in_grp & (comp < ck[:, None]))
    taken = torch.where(all_true[:, None], lt["valid"], before_thr & lt["valid"])
    spent0 = torch.where(all_true, total,
                         torch.where(before_thr, cost, 0).sum(dim=-1))

    ba0 = taken.reshape(B, 2, SBLIMIT, 16).sum(dim=-1)         # rungs are consecutive
    # mirror joint ladders into channel 1
    ba0 = torch.stack([ba0[:, 0], torch.where(lt["is_js"], ba0[:, 0], ba0[:, 1])],
                      dim=1)
    return _alloc_tail(ba0, spent0, ad, smr, scfsi, ft, sblimit, nch, jsbound)


def _alloc_tail(ba0, spent0, ad, smr, scfsi, ft, sblimit, nch, jsbound):
    """Faithful continuation of the C greedy from a mid-allocation state.
    One iteration per pick for every stream at once; the loop ends when no
    stream has an open slot (on CUDA the test is one host sync per
    iteration)."""
    B = smr.shape[0]
    dev, dtype = smr.device, smr.dtype
    sb = _arange(SBLIMIT, smr)
    below = sb[None, :] < sblimit[:, None]
    ar = torch.arange(B, device=dev)

    snr_tab = const(T.SNR, dev, dtype)
    sfs_tab = const(_SFS, dev, torch.int64)
    gbq = const(_GBQ, dev)
    step_idx = ft["step_idx"]                                   # [B, 32, 16]
    si2 = step_idx[:, None].expand(B, 2, SBLIMIT, 16)
    max_alloc = ft["max_alloc"]

    ba = ba0.long()
    mnr = snr_tab[torch.gather(si2, -1, ba[..., None])[..., 0]] - smr
    valid = (_arange(2, smr)[None, :, None] < nch[:, None, None]) & below[:, None, :]
    used = torch.where(~valid, 2, torch.where(ba >= max_alloc[:, None, :], 2,
                                              torch.where(ba > 0, 1, 0)))
    spent = spent0.long()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    is_js_e = (sb[None, :] >= jsbound[:, None])[:, None, :] & (nch[:, None, None] == 2)
    scfsi_f = scfsi.reshape(B, 2 * SBLIMIT).long()
    sfs_all = sfs_tab[scfsi.long()]                             # [B, 2, 32]
    first_extra_e = torch.where(is_js_e, 4 + 6 * (sfs_all + sfs_all.flip(1)),
                                2 + 6 * sfs_all)
    smr_f = smr.reshape(B, 2 * SBLIMIT)
    slot = _arange(2 * SBLIMIT, smr)

    def at16(rows, idx):
        """rows [..., 16] at idx [...] (clipped to the row)."""
        return torch.gather(rows, -1, idx.clamp(0, 15)[..., None])[..., 0]

    while not bool(done.all()):
        # every open slot whose next rung no longer fits will freeze when
        # visited (the budget never grows), so freeze them all now without
        # changing the pick order of the rest
        costs = gbq[at16(si2, ba + 1)] - torch.where(used == 1, gbq[at16(si2, ba)], 0)
        costs = costs + torch.where(used == 0, first_extra_e, 0)
        open0 = (used != 2) & (mnr < 999999.0)
        freeze_now = open0 & (spent[:, None, None] + costs > ad[:, None, None])
        # mirror freezes across joint-stereo pairs (used stays in sync)
        freeze_js = freeze_now | (freeze_now.flip(1) & is_js_e)
        used = torch.where(freeze_js, 2, used)

        # maxmnr_new starts from small=999999.0: entries at/above it are
        # never selectable (encode_new.c:1061-1077)
        open_ = ((used != 2) & (mnr < 999999.0)).reshape(B, 2 * SBLIMIT)
        mnr_m = torch.where(open_, mnr.reshape(B, 2 * SBLIMIT), torch.inf)
        lo = mnr_m.amin(dim=1, keepdim=True)
        # first minimum wins ties = the C scan order
        flat = torch.where(mnr_m == lo, slot, 2 * SBLIMIT).amin(dim=1) % (2 * SBLIMIT)
        any_open = open_.any(dim=1)
        act = any_open & ~done
        min_ch, min_sb = flat // SBLIMIT, flat % SBLIMIT
        oth = (1 - min_ch) * SBLIMIT + min_sb

        ba_f = ba.reshape(B, 2 * SBLIMIT).clone()
        used_f = used.reshape(B, 2 * SBLIMIT).clone()
        mnr_f = mnr.reshape(B, 2 * SBLIMIT).clone()
        ba_cur, used_cur = ba_f[ar, flat], used_f[ar, flat]
        si_row = step_idx[ar, min_sb]                           # [B, 16]
        increment = gbq[at16(si_row, ba_cur + 1)] - \
            torch.where(used_cur == 1, gbq[at16(si_row, ba_cur)], 0)
        fresh = used_cur == 0
        is_js = (min_sb >= jsbound) & (nch == 2)
        seli = torch.where(fresh, torch.where(is_js, 4, 2), 0)
        scale = torch.where(fresh, 6 * sfs_tab[scfsi_f[ar, flat]] + torch.where(
            is_js, 6 * sfs_tab[scfsi_f[ar, oth]], 0), 0)

        fits = ad >= spent + seli + scale + increment
        alloc = act & fits
        freeze = act & ~fits
        ba_new = ba_cur + 1
        max_a = max_alloc[ar, min_sb]
        new_used = torch.where(alloc & (ba_new >= max_a), 2, torch.where(
            alloc, 1, torch.where(freeze, 2, used_cur)))
        mnr_new = snr_tab[at16(si_row, ba_new)] - smr_f[ar, flat]
        ba_f[ar, flat] = torch.where(alloc, ba_new, ba_cur)
        used_f[ar, flat] = torch.where(alloc | freeze, new_used, used_cur)
        mnr_f[ar, flat] = torch.where(alloc, mnr_new, mnr_f[ar, flat])

        # joint mirror: above jsbound the allocation applies to both channels
        mirror = is_js & (alloc | freeze) & act
        ba_mirror = torch.where(alloc, ba_new, ba_cur)
        mnr_mir = snr_tab[at16(si_row, ba_mirror)] - smr_f[ar, oth]
        ba_f[ar, oth] = torch.where(mirror, ba_mirror, ba_f[ar, oth])
        used_f[ar, oth] = torch.where(mirror, torch.where(alloc, new_used, 2),
                                      used_f[ar, oth])
        mnr_f[ar, oth] = torch.where(mirror, mnr_mir, mnr_f[ar, oth])

        ba = ba_f.reshape(B, 2, SBLIMIT)
        used = used_f.reshape(B, 2, SBLIMIT)
        mnr = mnr_f.reshape(B, 2, SBLIMIT)
        spent = spent + torch.where(alloc, increment + scale + seli, 0)
        done = done | ~any_open
    return ba, ad - spent


def quantize(sf_index, sb_sample, j_scale, j_sample, bit_alloc, ft,
             sblimit, nch, jsbound):
    """Subband quantization (subband_quantization_new, encode_new.c:479-547).

    sf_index: [B,2,3,32] (post-scfsi); sb_sample: [B,2,3,12,32];
    j_scale: [B,3,32]; j_sample: [B,3,12,32]; bit_alloc: [B,2,32].
    Returns sbband [B,2,3,12,32] int32."""
    dev, dtype = sb_sample.device, sb_sample.dtype
    B = sb_sample.shape[0]
    sftab = const(T.SCALEFACTOR, dev, dtype)
    sb = _arange(SBLIMIT, sb_sample)
    is_js = (sb[None, :] >= jsbound[:, None]) & (nch[:, None] == 2)  # [B, 32]

    d_own = sb_sample / sftab[sf_index.long()][:, :, :, None, :]
    d_js = j_sample / sftab[j_scale.long()][:, :, None, :]     # [B, 3, 12, 32]
    d = torch.where(is_js[:, None, None, None, :], d_js[:, None], d_own)

    si = torch.gather(ft["step_idx"][:, None].expand(B, 2, SBLIMIT, 16), -1,
                      bit_alloc.long()[..., None])[..., 0]
    si = si[:, :, None, None, :]                                # [B,2,1,1,32]
    a = const(T.QUANT_A, dev, dtype)[si]
    b = const(T.QUANT_B, dev, dtype)[si]
    s2n = const(T.STEPS2N, dev, torch.int32)[si]

    q = d * a + b
    neg = q < 0
    q = torch.where(neg, q + 1.0, q)
    v = (q * s2n.to(dtype)).to(torch.int32)
    v = torch.where(~neg, v | s2n, v)

    active = (bit_alloc > 0)[:, :, None, None, :] & \
        (sb[None, None, None, None, :] < sblimit[:, None, None, None, None])
    return torch.where(active, v, 0)
