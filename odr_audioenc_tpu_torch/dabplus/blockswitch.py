"""AAC block switching: attack detection + window-sequence state machine (port
of odr_audioenc_tpu/dabplus/blockswitch.py).

The reference's first-order high-pass IIR (block_switch.cpp:130-131,
392-395) runs as a truncated causal FIR (one `F.conv1d` over the whole
superframe); the 0.7/0.3 accumulator attack walk (block_switch.cpp:298-312)
is a Python loop over granules with the 8-window inner loop unrolled; the
window sequence follows the look-ahead table chgWndSqLkAhd
(block_switch.cpp:215-227).  Stereo channels share one sequence (attack
flags OR-ed).

Window sequences: 0=LONG, 1=START, 2=EIGHT_SHORT, 3=STOP.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..device import const

LONG, START, SHORT, STOP = 0, 1, 2, 3

_HP_POLE = 0.5095
_HP_C1 = 0.7548
_HP_TAPS = 48
_ACC_OLD, _ACC_NEW = 0.7, 0.3
_INV_ATTACK_RATIO = 0.1
_MIN_ATTACK_NRG_120 = 1.0e6

# chgWndSqLkAhd[lastattack][attack][lastseq], flat [16]
_SEQ_LUT = np.array([
    [[LONG, SHORT, STOP, LONG],
     [START, SHORT, SHORT, START]],
    [[LONG, SHORT, SHORT, LONG],
     [START, SHORT, SHORT, START]],
], np.int64).reshape(-1)


def hp_fir_kernel(dtype=np.float32):
    """FIR expansion of f[n] = c1*(u[n]-u[n-1]) + p*f[n-1] (p = +0.5095):
    taps h[k] applied to u (length _HP_TAPS+2, causal)."""
    g = _HP_C1 * _HP_POLE ** np.arange(_HP_TAPS + 1)
    h = np.zeros(_HP_TAPS + 2)
    h[:_HP_TAPS + 1] += g
    h[1:_HP_TAPS + 2] -= g
    return h.astype(dtype)


# the JAX encoder builds its taps in float32 and casts them to the working
# dtype; so does the port (the f64 path carries the f32-rounded taps)
_HP_KERNEL = hp_fir_kernel()


def init_state(S, n_ch, dtype, device):
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "bs_tail": z((S, n_ch, _HP_TAPS + 1)),        # raw samples
        "bs_acc": z((S, n_ch)),                       # accWindowNrg
        "bs_enF_last": z((S, n_ch)),                  # enM1 seed
        "bs_enF_prev7": z((S, n_ch)),                 # spread check
        "bs_lastatt": z((S, n_ch), torch.bool),
        "bs_lastidx": z((S, n_ch), torch.int32),
        "bs_seq": z((S,), torch.int32),               # per stream
        "bs_att_pend": z((S,), torch.bool),           # pending AU's
    }


def window_energies(x, tail, wl):
    """x: [S, ch, T] int16-units float; tail: [S, ch, taps+1] previous raw
    samples.  Returns (enF [S, ch, T//wl], en [S, ch, T//wl], new_tail)."""
    S, C, T = x.shape
    h = const(_HP_KERNEL, x.device, x.dtype)
    K = h.shape[0]
    xx = torch.cat([tail, x], dim=-1).reshape(S * C, 1, T + K - 1)
    f = F.conv1d(xx, h.flip(0).reshape(1, 1, K)).reshape(S, C, T)
    enF = (f * f).reshape(S, C, T // wl, wl).sum(-1)
    en = (x * x).reshape(S, C, T // wl, wl).sum(-1)
    return enF, en, xx.reshape(S, C, -1)[..., -(K - 1):]


def attack_scan(enF, state, wl):
    """enF: [S, ch, nau, 8] filtered window energies of the new granules.
    Returns (att [nau, S, ch] bool, att_idx [nau, S, ch] int32, state')."""
    S, C, nau, _ = enF.shape
    min_nrg = _MIN_ATTACK_NRG_120 * (wl / 120.0)
    acc, enM1, p7 = state["bs_acc"], state["bs_enF_last"], state["bs_enF_prev7"]
    lastatt, lastidx = state["bs_lastatt"], state["bs_lastidx"]
    atts, idxs = [], []
    for g in range(nau):
        e = enF[:, :, g]                                   # [S, ch, 8]
        att = torch.zeros((S, C), dtype=torch.bool, device=enF.device)
        idx = torch.zeros((S, C), dtype=torch.int32, device=enF.device)
        for i in range(8):
            acc = _ACC_OLD * acc + _ACC_NEW * enM1
            hit = e[..., i] * _INV_ATTACK_RATIO > acc
            att = att | hit
            idx = torch.where(hit, i, idx)
            enM1 = e[..., i]
        att = att & (e.amax(-1) >= min_nrg)
        # attack spreading over the frame border (block_switch.cpp:315-326)
        spread = ~att & lastatt & (lastidx == 7) & (p7 > 10.0 * e[..., 1])
        att = att | spread
        idx = torch.where(spread, 0, idx)
        p7, lastatt, lastidx = e[..., 7], att, idx
        atts.append(att)
        idxs.append(idx)
    state = dict(state, bs_acc=acc, bs_enF_last=enM1, bs_enF_prev7=p7,
                 bs_lastatt=lastatt, bs_lastidx=lastidx)
    return torch.stack(atts), torch.stack(idxs), state


def sequence_scan(att_coded, att_look, seq0):
    """att_coded/att_look: [nau, S] bool; seq0: [S] carried sequence.
    Returns (seq [nau, S] int32, seq_last [S])."""
    lut = const(_SEQ_LUT, seq0.device)
    seq, out = seq0, []
    for la, a in zip(att_coded, att_look):
        flat = (la.long() * 2 + a.long()) * 4 + seq
        seq = lut.take(flat).to(torch.int32)
        out.append(seq)
    return torch.stack(out), seq


def block_switch(x, state, wl):
    """Block-switching decision for one superframe.  x: [S, ch, nau*8*wl]
    UNDELAYED input (int16-units float); the coded granules are the
    one-AU-delayed stream, so granule i's look-ahead flag is the attack flag
    of undelayed granule i.  Returns (seq [nau, S] for the coded granules,
    state')."""
    S, C, T = x.shape
    nau = T // (8 * wl)
    enF, _, tail = window_energies(x, state["bs_tail"], wl)
    att, _, state = attack_scan(enF.reshape(S, C, nau, 8), state, wl)
    att_s = att.any(-1)                                   # [nau, S] ch-sync
    att_coded = torch.cat([state["bs_att_pend"][None], att_s[:-1]], 0)
    seq, seq_last = sequence_scan(att_coded, att_s, state["bs_seq"])
    state = dict(state, bs_tail=tail, bs_seq=seq_last, bs_att_pend=att_s[-1])
    return seq, state
