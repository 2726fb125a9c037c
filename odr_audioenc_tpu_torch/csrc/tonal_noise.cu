// psy-1 tonal walk fused with the noise labelling (psycho_1.c:267-400) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel odr_audioenc_tpu/mp2/psycho1_pallas.py:151
// `_tonal_noise_kernel` (called through tonal_noise_pallas, :272) and
// computes what it computes; the plain version is
// odr_audioenc_tpu_torch/mp2/psycho1_fast.py `tonal_noise_fast` (tonal_fast,
// then noise_fast).  Per row of a [B, 512] f32 dB spectrum, its energy and
// its local-max candidates, with one band geometry for every row (one sample
// rate per batch: band k covers bins [base_k, base_k + span_k), span 0 = no
// band, 32 slots for the 26 critical bands at most):
//   1. the tonal walk (tonal_walk_bin, psy1_tonal.cuh): power', tone
//      member, typ;
//   2. per bin: usable = !typ && power' != DBMIN, lin = 10^(0.1 power'),
//      and CF*energy weights, zero where not usable;
//   3. per band: the sums of lin, CF*energy and CF*energy*bin; the centre
//      base + trunc(index * span) with index = (wpos - base*wsum) / span /
//      sum (base + span/2 when the band has no usable line), the Iwadare
//      adjustment (a tonal centre moves to c+1 if c+1 is tonal too, else to
//      c-1) and the clip to 0..511; the band's level 10 log10(sum);
//   4. per bin: consumed (usable, in some band) lines -> DBMIN, then the
//      band centres written in band order, so the last band writing a bin
//      wins (noise_label mutates in place, psycho_1.c:390-397).
//
// Bound: memory.  A bin is read once (4 B power + 4 B energy + 1 B
// candidate) and written once (4 B power' + 1 B tone + 1 B noise member),
// ~15 B per bin, 31.5 MB at B = 4096.  Design: one 512-thread block per row,
// the row kept in shared memory (~15.9 KB) from the tonal stage through the
// noise stage, so nothing but the inputs and outputs touches device memory.
// The TPU kernel takes the band sums as a [T,512]x[512,32] matmul of a 0/1
// band matrix; here the bands are contiguous (the wrapper checks that the
// matrix is exactly the one-hot of the geometry), so each band is summed by
// one warp (strided loads from shared memory, then a __shfl_xor_sync
// tree), 16 warps covering the 32 slots in two rounds, and the warp's lane
// 0 finishes the band.  The sums run in another order than the plain
// version's matmul, so a centre - a trunc() with no rounding margin - can
// move by one bin in rare rows; that is expected, and bounded by the tests.
//
// Built without fast-math and with --fmad=false (kernels/build.py), as the
// tonal walk is.

#include "psy1_tonal.cuh"

#define NGEOM 32

__global__ void __launch_bounds__(NBINS)
tonal_noise_kernel(const float* __restrict__ power, const uint8_t* __restrict__ cand,
                   const float* __restrict__ energy, const int32_t* __restrict__ runs,
                   const int32_t* __restrict__ base, const int32_t* __restrict__ span,
                   float* __restrict__ pw_out, uint8_t* __restrict__ tmem_out,
                   uint8_t* __restrict__ nmem_out, const float cf)
{
    __shared__ TonalSmem sm;
    __shared__ float s_lin[NBINS];
    __shared__ float s_w[NBINS];
    __shared__ float s_wp[NBINS];
    __shared__ uint8_t s_typ[NBINS];
    __shared__ int s_base[NGEOM];
    __shared__ int s_span[NGEOM];
    __shared__ int s_centre[NGEOM];
    __shared__ float s_sumdb[NGEOM];

    const int b = threadIdx.x;
    const int lane = b & 31;
    const int warp = b >> 5;
    const size_t off = (size_t)blockIdx.x * NBINS + b;
    if (b < NGEOM) {
        s_base[b] = base[b];
        s_span[b] = span[b];
    }
    const float e = energy[off];
    // ends in __syncthreads(): s_base / s_span are visible after it
    const TonalBin t = tonal_walk_bin(sm, b, power[off], cand[off] != 0, runs[b]);

    // 2. per-bin terms of the band sums
    const bool usable = !t.typ && t.pw != DBMIN;
    const float u = usable ? 1.0f : 0.0f;
    const float cfe = (cf * e) * u;
    s_typ[b] = t.typ ? 1 : 0;
    s_lin[b] = powf(10.0f, 0.1f * t.pw) * u;
    s_w[b] = cfe;
    s_wp[b] = cfe * (float)b;
    __syncthreads();

    // 3. one warp per band
    for (int k = warp; k < NGEOM; k += NWARPS) {
        const int lo = s_base[k];
        const int n = s_span[k];
        float sum = 0.0f, wsum = 0.0f, wpos = 0.0f;
        for (int i = lane; i < n; i += 32) {
            sum += s_lin[lo + i];
            wsum += s_w[lo + i];
            wpos += s_wp[lo + i];
        }
        for (int m = 16; m > 0; m >>= 1) {
            sum += __shfl_xor_sync(0xffffffffu, sum, m);
            wsum += __shfl_xor_sync(0xffffffffu, wsum, m);
            wpos += __shfl_xor_sync(0xffffffffu, wpos, m);
        }
        if (lane == 0) {
            const float spanf = (float)max(n, 1);
            const float weight = (wpos - (float)lo * wsum) / spanf;
            const bool no_comp = sum <= 0.0f;
            const float index = weight / fmaxf(sum, 1e-37f);
            int c = no_comp ? lo + n / 2 : lo + __float2int_rz(index * spanf);
            c = min(max(c, 0), NBINS - 1);
            if (s_typ[c]) {
                const bool next_tone = c + 1 < NBINS && s_typ[c + 1];
                c = min(max(next_tone ? c + 1 : c - 1, 0), NBINS - 1);
            }
            s_centre[k] = n > 0 ? c : -1;
            s_sumdb[k] = no_comp ? DBMIN : 10.0f * log10f(fmaxf(sum, 1e-37f));
        }
    }
    __syncthreads();

    // 4. consumed lines, then the centre writes in band order
    bool inband = false;
    for (int k = 0; k < NGEOM; ++k)
        inband |= b >= s_base[k] && b < s_base[k] + s_span[k];
    float out = (usable && inband) ? DBMIN : t.pw;
    bool noise = false;
    for (int k = 0; k < NGEOM; ++k) {
        if (s_centre[k] == b) {
            out = s_sumdb[k];
            noise = true;
        }
    }
    pw_out[off] = out;
    tmem_out[off] = t.member ? 1 : 0;
    nmem_out[off] = noise ? 1 : 0;
}

// power/energy/pw: [B, 512] f32; cand/tmem/nmem: [B, 512] bytes 0/1
// (torch.bool); runs: [512] int32; base/span: [32] int32, all on the device;
// cf: the CF*energy weight's constant in f32.  Launches on `stream`, does
// not synchronise, returns cudaGetLastError() of the launch.
extern "C" int tonal_noise_launch(const void* power, const void* cand, const void* energy,
                                  const void* runs, const void* base, const void* span,
                                  void* pw, void* tmem, void* nmem, float cf, int B,
                                  void* stream)
{
    if (B <= 0) return 0;
    tonal_noise_kernel<<<B, NBINS, 0, (cudaStream_t)stream>>>(
        (const float*)power, (const uint8_t*)cand, (const float*)energy,
        (const int32_t*)runs, (const int32_t*)base, (const int32_t*)span,
        (float*)pw, (uint8_t*)tmem, (uint8_t*)nmem, cf);
    return (int)cudaGetLastError();
}
