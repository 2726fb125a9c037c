// The psy-1 tonal walk of one spectrum row (psycho_1.c:267-340), shared by
// tonal_walk.cu and tonal_noise.cu.  Computes what the TPU kernels' common
// body `_tonal_body` (odr_audioenc_tpu/mp2/psycho1_pallas.py:40) computes,
// for a row of a [B, 512] f32 dB spectrum and its 0/1 local-max candidates:
//   1. decision: a candidate b is accepted unless some o in 2..run(b) has
//      power[b] - 7 < power[b -+ o] (the one relaxation round of the JAX
//      kernel starts from "nothing accepted", so it reads raw power);
//   2. min_zeroer mz[b]: the smallest accepted a with |a - b| <= run(a),
//      a != b (513 if none); zeroed bins read DBMIN;
//   3. boost of an accepted bin: 10 log10(lin(b) + lin(b-1) + lin(b+1)),
//      where a neighbour already zeroed before b's turn (mz < b) adds 0;
//   4. list surgery: accepted p leaves the tone list when it has an
//      accepted predecessor and the next accepted q has q - p <= run(q).
// Gives power' (DBMIN where zeroed, the boost where accepted), member and
// typ (= accepted and not zeroed).
//
// Layout: one 512-thread block per row, one thread per bin; the row's
// power, its 10^(0.1 x), accept flags, mz and run lengths live in shared
// memory (~8.7 KB), so every +-d neighbour read is a shared-memory read.
// The prefix "last accepted before b" and suffix "next accepted after b" of
// step 4 are one warp ballot per warp (16 words of accept bits) and one pass
// over at most 15 of those words - the cross-warp step of a scan.
//
// Built without fast-math and with --fmad=false (kernels/build.py): the
// masks depend only on exact f32 compares; power' matches the plain version
// to a few ulp of powf/log10f.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NBINS 512
#define PAD 12
#define BIG (NBINS + 1)
#define NWARPS (NBINS / 32)
#define DBMIN (-200.0f)

struct TonalSmem {
    float p[NBINS];
    float lin[NBINS];
    int run[NBINS];
    int mz[NBINS];
    uint8_t acc[NBINS];
    unsigned mask[NWARPS];
};

struct TonalBin {
    float pw;      // power' of this thread's bin
    bool member;   // in the tone list after the surgery
    bool typ;      // type == TONE after the walk
};

// Called by all NBINS threads of the block, thread b = bin b; p, cand and
// run are this bin's power, candidate flag and TONAL_RUN.  Ends after a
// __syncthreads(), so the caller may reuse nothing of `sm` before its own.
__device__ __forceinline__ TonalBin tonal_walk_bin(TonalSmem& sm, const int b,
                                                   const float p, const bool cand,
                                                   const int run)
{
    const int lane = b & 31;
    const int warp = b >> 5;
    sm.p[b] = p;
    sm.run[b] = run;
    sm.lin[b] = powf(10.0f, 0.1f * p);
    __syncthreads();

    // 1. decision against the raw row
    bool acc = cand;
    if (acc) {
        const float maxv = p - 7.0f;
        for (int o = 2; o <= run; ++o) {
            if ((b - o >= 0 && maxv < sm.p[b - o]) ||
                (b + o < NBINS && maxv < sm.p[b + o])) {
                acc = false;
                break;
            }
        }
    }
    sm.acc[b] = acc ? 1 : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, acc);
    if (lane == 0) sm.mask[warp] = ballot;
    __syncthreads();

    // 2. smallest accepted bin whose run reaches b
    int mz = BIG;
    for (int d = 1; d <= PAD; ++d) {
        const int l = b - d;
        if (l >= 0 && sm.acc[l] && sm.run[l] >= d) mz = min(mz, l);
        const int r = b + d;
        if (r < NBINS && sm.acc[r] && sm.run[r] >= d) mz = min(mz, r);
    }
    sm.mz[b] = mz;
    __syncthreads();

    // 3. power'
    const bool zeroed = mz < BIG;
    TonalBin out;
    out.pw = p;
    if (zeroed) {
        out.pw = DBMIN;
    } else if (acc) {
        const float left = (b >= 1 && !(sm.mz[b - 1] < b)) ? sm.lin[b - 1] : 0.0f;
        const float right = (b + 1 < NBINS && !(sm.mz[b + 1] < b)) ? sm.lin[b + 1] : 0.0f;
        const float tot = (sm.lin[b] + left) + right;
        out.pw = 10.0f * log10f(fmaxf(tot, 1e-37f));
    }

    // 4. list surgery from the accept bit words
    int prev = -1;
    const unsigned below = sm.mask[warp] & ((1u << lane) - 1u);
    if (below) {
        prev = warp * 32 + 31 - __clz(below);
    } else {
        for (int w = warp - 1; w >= 0; --w) {
            const unsigned m = sm.mask[w];
            if (m) { prev = w * 32 + 31 - __clz(m); break; }
        }
    }
    int nxt = -1;
    const unsigned above = lane == 31 ? 0u : (sm.mask[warp] & ~((2u << lane) - 1u));
    if (above) {
        nxt = warp * 32 + __ffs(above) - 1;
    } else {
        for (int w = warp + 1; w < NWARPS; ++w) {
            const unsigned m = sm.mask[w];
            if (m) { nxt = w * 32 + __ffs(m) - 1; break; }
        }
    }
    const bool drop = prev >= 0 && nxt >= 0 && (nxt - b) <= sm.run[nxt];
    out.member = acc && !drop;
    out.typ = acc && !zeroed;
    __syncthreads();
    return out;
}
