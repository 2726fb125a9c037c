// psy-1 tonal walk (psycho_1.c:267-340) for Hopper (sm_90a).
//
// Replaces the TPU kernel odr_audioenc_tpu/mp2/psycho1_pallas.py:140
// `_tonal_kernel` (body `_tonal_body`, :40), and computes what it computes:
// the plain version is odr_audioenc_tpu_torch/mp2/psycho1_fast.py
// `tonal_fast`.  Per row of a [B, 512] f32 dB spectrum and its 0/1
// local-max candidates:
//   1. decision: a candidate b is accepted unless some o in 2..run(b) has
//      power[b] - 7 < power[b -+ o] (the one relaxation round of the JAX
//      kernel starts from "nothing accepted", so it reads raw power);
//   2. min_zeroer mz[b]: the smallest accepted a with |a - b| <= run(a),
//      a != b (513 if none); zeroed bins read DBMIN;
//   3. boost of an accepted bin: 10 log10(lin(b) + lin(b-1) + lin(b+1)),
//      where a neighbour already zeroed before b's turn (mz < b) adds 0;
//   4. list surgery: accepted p leaves the tone list when it has an
//      accepted predecessor and the next accepted q has q - p <= run(q).
// Outputs power' (DBMIN where zeroed, the boost where accepted), member and
// typ (= accepted and not zeroed).
//
// Bound: memory.  A bin is read once (4 B power + 1 B candidate) and
// written once (4 B power' + 1 B member + 1 B typ), against ~100 integer
// compares and three transcendentals per bin, so a row costs ~5.6 KB of
// device traffic and a few thousand instructions per 512 threads.  Design:
// one 512-thread block per row, one thread per bin; the row's power, its
// 10^(0.1 x), accept flags, mz and run lengths live in shared memory
// (~8.7 KB), so every +-d neighbour read of steps 1-3 is a shared-memory
// read, and device memory sees exactly one coalesced read and one coalesced
// write of each array.  The TPU tiling (256 rows per grid step, B % 256 ==
// 0) is not carried over: any B >= 1 works.  The prefix "last accepted
// before b" and suffix "next accepted after b" of step 4 are one warp
// ballot per warp (16 words of accept bits in shared memory) and one pass
// over at most 15 of those words - the cross-warp step of a scan.
//
// Built without fast-math and with --fmad=false (kernels/build.py): the
// masks depend only on exact f32 compares; power' matches the plain version
// to a few ulp of powf/log10f.

#include <cuda_runtime.h>
#include <stdint.h>

#define NBINS 512
#define PAD 12
#define BIG (NBINS + 1)
#define NWARPS (NBINS / 32)
#define DBMIN (-200.0f)

__global__ void __launch_bounds__(NBINS)
tonal_walk_kernel(const float* __restrict__ power, const uint8_t* __restrict__ cand,
                  const int32_t* __restrict__ runs, float* __restrict__ pw_out,
                  uint8_t* __restrict__ member_out, uint8_t* __restrict__ typ_out)
{
    __shared__ float s_p[NBINS];
    __shared__ float s_lin[NBINS];
    __shared__ int s_run[NBINS];
    __shared__ int s_mz[NBINS];
    __shared__ uint8_t s_acc[NBINS];
    __shared__ unsigned s_mask[NWARPS];

    const int b = threadIdx.x;
    const int lane = b & 31;
    const int warp = b >> 5;
    const size_t off = (size_t)blockIdx.x * NBINS + b;

    const float p = power[off];
    const int run = runs[b];
    s_p[b] = p;
    s_run[b] = run;
    s_lin[b] = powf(10.0f, 0.1f * p);
    __syncthreads();

    // 1. decision against the raw row
    bool acc = cand[off] != 0;
    if (acc) {
        const float maxv = p - 7.0f;
        for (int o = 2; o <= run; ++o) {
            if ((b - o >= 0 && maxv < s_p[b - o]) ||
                (b + o < NBINS && maxv < s_p[b + o])) {
                acc = false;
                break;
            }
        }
    }
    s_acc[b] = acc ? 1 : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, acc);
    if (lane == 0) s_mask[warp] = ballot;
    __syncthreads();

    // 2. smallest accepted bin whose run reaches b
    int mz = BIG;
    for (int d = 1; d <= PAD; ++d) {
        const int l = b - d;
        if (l >= 0 && s_acc[l] && s_run[l] >= d) mz = min(mz, l);
        const int r = b + d;
        if (r < NBINS && s_acc[r] && s_run[r] >= d) mz = min(mz, r);
    }
    s_mz[b] = mz;
    __syncthreads();

    // 3. power'
    const bool zeroed = mz < BIG;
    float out = p;
    if (zeroed) {
        out = DBMIN;
    } else if (acc) {
        const float left = (b >= 1 && !(s_mz[b - 1] < b)) ? s_lin[b - 1] : 0.0f;
        const float right = (b + 1 < NBINS && !(s_mz[b + 1] < b)) ? s_lin[b + 1] : 0.0f;
        const float tot = (s_lin[b] + left) + right;
        out = 10.0f * log10f(fmaxf(tot, 1e-37f));
    }

    // 4. list surgery from the accept bit words
    int prev = -1;
    const unsigned below = s_mask[warp] & ((1u << lane) - 1u);
    if (below) {
        prev = warp * 32 + 31 - __clz(below);
    } else {
        for (int w = warp - 1; w >= 0; --w) {
            const unsigned m = s_mask[w];
            if (m) { prev = w * 32 + 31 - __clz(m); break; }
        }
    }
    int nxt = -1;
    const unsigned above = lane == 31 ? 0u : (s_mask[warp] & ~((2u << lane) - 1u));
    if (above) {
        nxt = warp * 32 + __ffs(above) - 1;
    } else {
        for (int w = warp + 1; w < NWARPS; ++w) {
            const unsigned m = s_mask[w];
            if (m) { nxt = w * 32 + __ffs(m) - 1; break; }
        }
    }
    const bool drop = prev >= 0 && nxt >= 0 && (nxt - b) <= s_run[nxt];

    pw_out[off] = out;
    member_out[off] = (acc && !drop) ? 1 : 0;
    typ_out[off] = (acc && !zeroed) ? 1 : 0;
}

// power/pw: [B, 512] f32; cand/member/typ: [B, 512] bytes 0/1 (torch.bool);
// runs: [512] int32 on the device.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() of the launch.
extern "C" int tonal_walk_launch(const void* power, const void* cand, const void* runs,
                                 void* pw, void* member, void* typ, int B, void* stream)
{
    if (B <= 0) return 0;
    tonal_walk_kernel<<<B, NBINS, 0, (cudaStream_t)stream>>>(
        (const float*)power, (const uint8_t*)cand, (const int32_t*)runs,
        (float*)pw, (uint8_t*)member, (uint8_t*)typ);
    return (int)cudaGetLastError();
}
