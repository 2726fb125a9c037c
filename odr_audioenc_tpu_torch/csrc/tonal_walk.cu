// psy-1 tonal walk (psycho_1.c:267-340) for Hopper (sm_90a).
//
// Replaces the TPU kernel odr_audioenc_tpu/mp2/psycho1_pallas.py:140
// `_tonal_kernel` (body `_tonal_body`, :40), and computes what it computes:
// the plain version is odr_audioenc_tpu_torch/mp2/psycho1_fast.py
// `tonal_fast`.  The walk itself is `tonal_walk_bin` in psy1_tonal.cuh,
// shared with the fused tonal+noise kernel (tonal_noise.cu).
//
// Bound: memory.  A bin is read once (4 B power + 1 B candidate) and
// written once (4 B power' + 1 B member + 1 B typ), against ~100 integer
// compares and three transcendentals per bin, so a row costs ~5.6 KB of
// device traffic and a few thousand instructions per 512 threads.  Design:
// one 512-thread block per row, one thread per bin, the row in shared
// memory (see the header), so device memory sees exactly one coalesced
// read and one coalesced write of each array.  The TPU tiling (256 rows per
// grid step, B % 256 == 0) is not carried over: any B >= 1 works.

#include "psy1_tonal.cuh"

__global__ void __launch_bounds__(NBINS)
tonal_walk_kernel(const float* __restrict__ power, const uint8_t* __restrict__ cand,
                  const int32_t* __restrict__ runs, float* __restrict__ pw_out,
                  uint8_t* __restrict__ member_out, uint8_t* __restrict__ typ_out)
{
    __shared__ TonalSmem sm;
    const int b = threadIdx.x;
    const size_t off = (size_t)blockIdx.x * NBINS + b;
    const TonalBin t = tonal_walk_bin(sm, b, power[off], cand[off] != 0, runs[b]);
    pw_out[off] = t.pw;
    member_out[off] = t.member ? 1 : 0;
    typ_out[off] = t.typ ? 1 : 0;
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
