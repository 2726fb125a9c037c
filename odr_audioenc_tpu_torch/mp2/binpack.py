"""Device-side MP2 sample-section slot construction (port of
odr_audioenc_tpu/mp2/binpack.py).

Serializes the sample section in the exact write_samples_new order
(libtoolame-dab encode_new.c:560-598 - granule, 3-sample step, subband,
channel) as a static [S, 3, 4, 32, 2, 3] grid of (width, value) slots:
grouped allocations combine their triplet into one codeword in slot x=0;
individual allocations emit three codewords.
"""
import torch

from .. import bitpack as BP
from .. import tables as T
from ..device import const

SBLIMIT = 32
SAMPLE_SPANS = 3  # sample codewords are <= 16 bits -> at most 3 bytes


def sample_slots(sbband, bit_alloc, ft, sblimit, nch, jsbound):
    """(widths, values) [S, K=2304] int64 in serialization order.

    sbband: [S,2,3,12,32] int codewords (quantize() output);
    bit_alloc: [S,2,32]; ft: allocate._frame_tables dict;
    sblimit/nch/jsbound: [S]."""
    S = sbband.shape[0]
    dev = sbband.device
    si = torch.gather(ft["step_idx"][:, None].expand(S, 2, SBLIMIT, 16), -1,
                      bit_alloc.long()[..., None])[..., 0]      # [S,2,32]
    nbits = const(T.BITS, dev, torch.int64)[si]
    group = const(T.GROUP, dev, torch.int64)[si]
    steps = const(T.STEPS, dev, torch.int64)[si]

    sb = torch.arange(SBLIMIT, device=dev)
    # channel loop is `ch < (sb < jsbound ? nch : 1)`: above jsbound (or in
    # mono) only channel 0 is serialized (it carries the joint codewords)
    act0 = (bit_alloc[:, 0] > 0) & (sb[None, :] < sblimit[:, None])
    act1 = (bit_alloc[:, 1] > 0) & (sb[None, :] < sblimit[:, None]) & \
        (sb[None, :] < jsbound[:, None]) & (nch[:, None] == 2)
    active = torch.stack([act0, act1], dim=1)                   # [S,2,32]

    # values in slot order [S, gr, jstep, sb, ch, x]
    v = sbband.long().permute(0, 2, 3, 1, 4)                    # [S,3,12,2,32]
    v = v.reshape(S, 3, 4, 3, 2, SBLIMIT).permute(0, 1, 2, 5, 4, 3)

    # per-(ch,sb) tables onto the slot grid [S,1,1,32,2]
    def grid(a):
        return a.transpose(1, 2)[:, None, None]
    y = grid(steps)
    grouped = grid((group == 1) & active)
    indiv = grid((group == 3) & active)
    nb_g = grid(nbits)
    v_comb = v[..., 0] + v[..., 1] * y + v[..., 2] * (y * y)
    first = torch.arange(3, device=dev) == 0
    w = torch.where(indiv[..., None] | (grouped[..., None] & first),
                    nb_g[..., None], 0).expand(S, 3, 4, SBLIMIT, 2, 3)
    val = torch.where(grouped[..., None] & first, v_comb[..., None],
                      torch.where(indiv[..., None], v, 0))
    K = 3 * 4 * SBLIMIT * 2 * 3
    return w.reshape(S, K), val.reshape(S, K)


def pack_payload(sbband, bit_alloc, ft, sblimit, nch, jsbound, n_bytes):
    """Serialize the sample section on device -> (payload [S, n_bytes]
    uint8, nbits [S] int32).  The host packer splices these bits after the
    header/alloc/scfsi/scf section (host/mp2pack.py)."""
    w, val = sample_slots(sbband, bit_alloc, ft, sblimit, nch, jsbound)
    payload, total_bits = BP.pack_groups([(w, val, SAMPLE_SPANS)], n_bytes)
    return payload.to(torch.uint8), total_bits.to(torch.int32)
