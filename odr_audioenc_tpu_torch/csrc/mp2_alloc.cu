// The MP2 bit allocation of one frame (mp2/allocate.py js_mode_select, then
// a_bit_allocation with its tail) for Hopper (sm_90a): the joint-stereo
// mode_ext walk-down of main_bit_allocation_new (bits_for_nonoise_new at
// jsbound = sblimit, 16, 12, 8; encode_new.c:634-819), then the greedy
// a_bit_allocation_new / maxmnr_new (encode_new.c:1061-1187) literally, for
// every station in one launch.
//
// Replaces no TPU kernel: the JAX package's allocator is jnp code with a
// lax.while_loop tail.  It was added because the vectorised allocator on the
// card is ~1,000 small launches per frame (five bits_for_nonoise variants,
// the rung tables, two bitwise bisections of 32 + 16 rounds over [S, 1024]
// keys, ~60 launches per tail pass) and one host sync per tail pass, the tail
// running to the batch's hardest station.
//
// Design: one warp per station, the 2 x 32 (channel, subband) slots two per
// lane, lane l holding (0, l) and (1, l), so that the joint mirror above
// jsbound stays inside a lane.  Each pick is a warp argmin over the open
// slots' MNR (value, then slot index: the first minimum wins, as the C scan
// over ch, sb does), then the owner lane's fit test against the remaining
// budget (allocate the next rung, or freeze the slot), the mirror, and one
// shuffle of the bits spent.  A warp stops at its own station's last pick.
// The step-index rows, SNR and 12 * group * bits steps sit in shared memory
// (each lane's lookups diverge by subband), indexed by the station's table.
//
// Bound: the chain of dependent picks, not bytes.  A station reads smr
// (64 floats), scfsi (64 int32) and five columns and writes 64 int64 and
// four scalars: ~1.1 KB in float32 (alloc_kernel.bound_bytes), 8.9 MB and
// ~2.7 us at S=8192 at 3.35 TB/s.  Each pick is ~11 dependent shuffles, and
// a station makes one pick per rung allocated or slot frozen: 126-128 on
// average on the MP2 cells' music at S=8192, 172 at most (chip_smoke phase
// 4c), so the kernel runs at ~1% of the byte bound (~0.25 ms per launch on
// an H100), 1% of a ~50 ms step.
//
// Arithmetic follows the plain version: MNR = SNR(step) - smr in the input's
// precision (SNR rounded to float32 first on the float32 path), the "open"
// test mnr < 999999.0, the budget in integers.  The outputs are the plain
// version's, integer for integer.

#include <cstdint>
#include <cuda_runtime.h>

#define SB 32
#define NTAB 5                 // allocation tables (tablenum)
#define NLINE 9                // table lines
#define NSTEP 18               // quantiser steps
#define WARPS 4                // stations per block, one warp each
#define FULL 0xffffffffu
#define BANC 32                // header bits
#define BERR 16                // CRC bits
#define NONE 64                // no open slot

// tables.LINE: the line of each subband per table, -1 above its sblimit
__constant__ int LINE_T[NTAB][SB] = {
    {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, -1, -1, -1, -1, -1},
    {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, -1, -1},
    {4, 4, 5, 5, 5, 5, 5, 5, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
    {4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
    {6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8}};
// tables.NBAL: allocation bits per line
__constant__ int NBAL_T[NLINE] = {4, 4, 3, 2, 4, 3, 4, 3, 2};
// tables.STEP_INDEX: quantiser step of each allocation index per line
__constant__ int STEP_INDEX_T[NLINE][16] = {
    {0, 1, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 17},
    {0, 1, 2, 3, 4, 5, 6, 17, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16},
    {0, 1, 2, 4, 5, 6, 7, 8, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 1, 2, 4, 5, 6, 7, 8, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
// tables.SNR per step (dB)
__constant__ double SNR_T[NSTEP] = {0.00, 7.00, 11.00, 16.00, 20.84, 25.28, 31.59, 37.75, 43.84,
                                    49.89, 55.93, 61.96, 67.98, 74.01, 80.03, 86.05, 92.01, 98.01};
// allocate._GBQ: 12 * GROUP * BITS per step, a subband's sample bits
__constant__ int GBQ_T[NSTEP] = {0, 60, 84, 108, 120, 144, 180, 216, 252,
                                 288, 324, 360, 396, 432, 468, 504, 540, 576};
// tables.SFS_PER_SCFSI: scalefactors sent per scfsi code
__constant__ int SFS_T[4] = {3, 2, 1, 2};
// tables.JSB_TABLE: jsbound per mode_ext
__constant__ int JSB_T[4] = {4, 8, 12, 16};

struct AllocArgs {
    const void* smr;                                  // [S, 2, 32] float or double
    const int32_t* scfsi;                             // [S, 2, 32]
    const int64_t *tablenum, *sblimit, *nch, *adb;    // [S]
    const bool* is_joint;                             // [S]
    bool* stereo;                                     // [S] out
    int64_t *mode_ext, *jsbound, *bit_alloc, *adb_left;   // [S], [S], [S, 2, 32], [S] out
    int S, f64;
};

template <typename F>
__device__ __forceinline__ F open_below();
template <> __device__ __forceinline__ float open_below<float>() { return 999999.0f; }
template <> __device__ __forceinline__ double open_below<double>() { return 999999.0; }

// The first allocation index whose MNR reaches 0 (bits_for_nonoise_new's
// per-channel search), below max_alloc - 1; else max(max_alloc - 1, 0).
template <typename F>
__device__ __forceinline__ int first_rung(const unsigned char* row, const F* snr, int maxa, F smr)
{
    for (int k = 0; k < maxa - 1; ++k)
        if (snr[row[k]] - smr >= F(0)) return k;
    return maxa > 0 ? maxa - 1 : 0;
}

template <typename F>
__global__ void __launch_bounds__(32 * WARPS) mp2_alloc_kernel(const AllocArgs a)
{
    __shared__ F snr[NSTEP];
    __shared__ int gbq[NSTEP];
    __shared__ unsigned char steps[NLINE * 16];
    for (int i = threadIdx.x; i < NLINE * 16; i += blockDim.x)
        steps[i] = (unsigned char)STEP_INDEX_T[i / 16][i % 16];
    if (threadIdx.x < NSTEP) {
        snr[threadIdx.x] = (F)SNR_T[threadIdx.x];
        gbq[threadIdx.x] = GBQ_T[threadIdx.x];
    }
    __syncthreads();
    const int s = blockIdx.x * WARPS + threadIdx.x / 32;
    if (s >= a.S) return;
    const int l = threadIdx.x & 31;

    const int tab = min(max((int)a.tablenum[s], 0), NTAB - 1);
    const int sbl = min(max((int)a.sblimit[s], 0), SB);
    const int nch = (int)a.nch[s];
    const bool two = nch == 2;
    const long long adb = a.adb[s];
    const int ln = LINE_T[tab][l];
    const int nb = ln < 0 ? 0 : NBAL_T[ln];
    const int maxa = (1 << nb) - 1;
    const unsigned char* row = steps + 16 * (ln < 0 ? 0 : ln);
    const bool below = l < sbl;
    const F* sm = (const F*)a.smr + (size_t)s * 2 * SB;
    const F smr0 = sm[l], smr1 = sm[SB + l];
    const int32_t* sc = a.scfsi + (size_t)s * 2 * SB;
    const int sfs0 = SFS_T[sc[l] & 3], sfs1 = SFS_T[sc[SB + l] & 3];

    // ---- the joint-stereo walk-down (main_bit_allocation_new) ----
    bool stereo = true;
    int ext = 0, jsb = sbl;
    if (a.is_joint[s]) {
        const int b0 = first_rung(row, snr, maxa, smr0), b1 = first_rung(row, snr, maxa, smr1);
        const int bj = max(b0, b1);
        int idx = 4;
        for (int i = 0; i < 4; ++i) {
            const int v = i == 0 ? sbl : 16 - 4 * (i - 1);
            int c = 0;
            if (below) {
                c = nb * (l < v ? nch : 1);
                if (l >= v && two) {
                    if (bj > 0) c += gbq[row[bj]] + 4 + 6 * (sfs0 + sfs1);
                } else {
                    if (b0 > 0) c += gbq[row[b0]] + 2 + 6 * sfs0;
                    if (two && b1 > 0) c += gbq[row[b1]] + 2 + 6 * sfs1;
                }
            }
            if (BANC + BERR + __reduce_add_sync(FULL, c) <= adb) {
                idx = i;
                break;
            }
        }
        stereo = idx == 0;
        ext = stereo ? 0 : 4 - idx;
        jsb = stereo ? sbl : JSB_T[ext];
    }

    // ---- the greedy (a_bit_allocation_new) ----
    const long long ad = adb - (BANC + BERR + __reduce_add_sync(FULL, below ? nb * (l < jsb ? nch : 1) : 0));
    const bool js = l >= jsb && two;
    int ba0 = 0, ba1 = 0;
    F mnr0 = snr[row[0]] - smr0, mnr1 = snr[row[0]] - smr1;
    // 0 open and empty, 1 open, 2 closed (invalid, frozen or at max_alloc)
    int used0 = below && maxa > 0 ? 0 : 2;
    int used1 = below && two && maxa > 0 ? 0 : 2;
    long long spent = 0;
    const F lim = open_below<F>();
    for (;;) {
        F v = lim;
        int i = NONE;
        if (used0 != 2 && mnr0 < lim) { v = mnr0; i = l; }
        if (used1 != 2 && mnr1 < lim && (i == NONE || mnr1 < v)) { v = mnr1; i = SB + l; }
        for (int off = 16; off; off >>= 1) {
            const F ov = __shfl_xor_sync(FULL, v, off);
            const int oi = __shfl_xor_sync(FULL, i, off);
            if (oi != NONE && (i == NONE || ov < v || (ov == v && oi < i))) { v = ov; i = oi; }
        }
        if (i == NONE) break;
        const int msb = i & (SB - 1);
        int delta = 0;
        if (l == msb) {
            const bool c1 = i >= SB;
            int ba = c1 ? ba1 : ba0, used = c1 ? used1 : used0;
            const int inc = gbq[row[min(ba + 1, 15)]] - (used == 1 ? gbq[row[ba]] : 0);
            const int seli = used ? 0 : (js ? 4 : 2);
            const int scale = used ? 0 : 6 * (c1 ? sfs1 : sfs0) + (js ? 6 * (c1 ? sfs0 : sfs1) : 0);
            if (ad >= spent + seli + scale + inc) {
                ++ba;
                delta = inc + seli + scale;
                used = ba >= maxa ? 2 : 1;
            } else {
                used = 2;
            }
            const F mnr = snr[row[ba]];
            if (c1 || js) { ba1 = ba; used1 = used; mnr1 = mnr - smr1; }
            if (!c1 || js) { ba0 = ba; used0 = used; mnr0 = mnr - smr0; }
        }
        spent += __shfl_sync(FULL, delta, msb);
    }

    int64_t* out = a.bit_alloc + (size_t)s * 2 * SB;
    out[l] = ba0;
    out[SB + l] = ba1;
    if (l == 0) {
        a.stereo[s] = stereo;
        a.mode_ext[s] = ext;
        a.jsbound[s] = jsb;
        a.adb_left[s] = ad - spent;
    }
}

extern "C" int mp2_alloc_launch(const AllocArgs* args, void* stream)
{
    const AllocArgs a = *args;
    if (a.S < 0) return (int)cudaErrorInvalidValue;
    if (a.S == 0) return 0;
    const int blocks = (a.S + WARPS - 1) / WARPS;
    if (a.f64)
        mp2_alloc_kernel<double><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
    else
        mp2_alloc_kernel<float><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
