// psy-1 tonal walk (psycho_1.c:267-340) for Hopper (sm_90a).
//
// Replaces the TPU kernel odr_audioenc_tpu/mp2/psycho1_pallas.py:140
// `_tonal_kernel` (body `_tonal_body`, :40), and computes what it computes:
// the plain version is odr_audioenc_tpu_torch/mp2/psycho1_fast.py
// `tonal_fast`.  The walk itself is in psy1_tonal.cuh, shared with the fused
// tonal+noise kernel (tonal_noise.cu).
//
// Bound: memory.  A bin is read once (4 B power + 1 B candidate) and
// written once (4 B power' + 1 B member + 1 B typ): 11 B per bin, 23.1 MB
// at B = 4096, 6.9 us at 3.35 TB/s.  The work per bin is a few dozen
// compares and bit operations, but the decision's 22 neighbour reads per
// bin would, as shared-memory loads, take longer than the bound; the walk
// of psy1_tonal.cuh reads them from registers.  One warp per row, 8 rows
// per block, ceil(B / 8) blocks (4 blocks of <= 64 registers and 43 KB of
// shared memory fit an SM: all 4,096 rows of the main path are resident at
// once; a warp walking two rows, the second one's copy in flight, measured
// slower on the H100: a warp's walk is bound by its own latency, and at this
// size the card has one warp slot per row).  power' leaves in 128-byte
// lines (through the stage, once walked), the bool outputs as one 16-byte
// store per lane.  The TPU tiling (256 rows per grid step, B % 256 == 0) is
// not carried over: any B >= 1 works.

#include "psy1_tonal.cuh"

#define WARPS 8

__global__ void __launch_bounds__(32 * WARPS, 4)
tonal_walk_kernel(const float* __restrict__ power, const uint8_t* __restrict__ cand,
                  const int32_t* __restrict__ tab, float* __restrict__ pw_out,
                  uint8_t* __restrict__ member_out, uint8_t* __restrict__ typ_out, const int B)
{
    __shared__ __align__(16) WalkTables t;
    __shared__ __align__(16) Stage stages[WARPS];
    __shared__ __align__(16) WalkScratch scratch[WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * WARPS + warp;
    Stage& st = stages[warp];
    if (row < B) {
        stage_row(st, power + (size_t)row * NBINS, cand + (size_t)row * NBINS, lane);
        set_pads(st, lane);
    }
    load_walk_tables<32 * WARPS>(t, tab);
    __syncthreads();
    if (row >= B) return;
    cp_async_wait_all();
    __syncwarp();

    WalkScratch& w = scratch[warp];
    const unsigned m = walk16(st, w, t, lane);
    float pw[16];
    const unsigned typ = power16(st, w, lane, m, pw);
    store_bits16(member_out + (size_t)row * NBINS, half_word(w.member, lane), lane);
    store_bits16(typ_out + (size_t)row * NBINS, typ, lane);
    store_power(st, pw, pw_out + (size_t)row * NBINS, lane);
}

// power/pw: [B, 512] f32; cand/member/typ: [B, 512] bytes 0/1 (torch.bool),
// all rows 16-byte aligned; runs: [2, 512] int32 on the device, the run
// lengths (TONAL_RUN: 0, 2, 3, 6 or 12) then the reach masks
// (psycho1_kernels.walk_table).  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() of the launch.
extern "C" int tonal_walk_launch(const void* power, const void* cand, const void* runs,
                                 void* pw, void* member, void* typ, int B, void* stream)
{
    if (B <= 0) return 0;
    tonal_walk_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const float*)power, (const uint8_t*)cand, (const int32_t*)runs, (float*)pw,
        (uint8_t*)member, (uint8_t*)typ, B);
    return (int)cudaGetLastError();
}
