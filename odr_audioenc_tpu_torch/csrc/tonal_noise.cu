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
// band, 32 slots for the 26 critical bands at most, bands disjoint):
//   1. the tonal walk (psy1_tonal.cuh): power', tone member, typ;
//   2. per bin: usable = !typ && power' != DBMIN, lin = 10^(0.1 power'),
//      and CF*energy weights, zero where not usable;
//   3. per band: the sums of lin, CF*energy and CF*energy*bin; the centre
//      base + trunc(index * span) with index = (wpos - base*wsum) / span /
//      sum (base + span/2 when the band has no usable line), the Iwadare
//      adjustment (a tonal centre moves to c+1 if c+1 is tonal too, else to
//      c-1) and the clip to 0..511; the band's level 10 log10(sum);
//   4. per bin: consumed (usable, in some band) lines -> DBMIN, then the
//      band centres, the last band writing a bin winning (noise_label
//      mutates in place, psycho_1.c:390-397).
//
// Bound: memory.  A bin is read once (4 B power + 4 B energy + 1 B
// candidate) and written once (4 B power' + 1 B tone + 1 B noise member):
// 15 B per bin, 31.5 MB at B = 4096, 9.4 us at 3.35 TB/s.  Design: the tonal
// walk's (tonal_walk.cu; psy1_tonal.cuh: one warp per row, lane l owns bins
// 16 l .. 16 l + 15; 8 rows per block, and 4 blocks of <= 64 registers and
// 47 KB of shared memory fit an SM, so all 4,096 rows of the main path are
// resident at once).  Then the noise labelling, in the same layout, with no
// shared-memory traffic per bin:
//   - each lane sums its 16 bins band by band in registers (the bands are
//     contiguous, the band of each bin static);
//   - a band that reaches into lane l from the left gets the sum of the
//     lanes before it: one segmented shuffle scan of the lanes' trailing
//     sums per row, keyed by static flags;
//   - the lane where a band ends writes its three sums to shared memory;
//     lane k then runs band k's stage (26 lanes at once), and the "last
//     band wins" centre writes are one __match_any_sync;
//   - the energy comes straight from device memory into registers, four
//     16-byte loads per lane, issued once the walk is done (other warps
//     walk meanwhile; loaded first, it would hold 16 registers through the
//     walk).
// The band and scan-flag tables are built once per geometry by the wrapper
// (psycho1_kernels.noise_tables; band_sums_lanes is the same sum in numpy)
// and passed after the walk's.  The sums run in another order than the
// plain version's matmul, and 10^(x/10) is exp2f, so a centre - a trunc()
// with no rounding margin - can move by one bin in some rows; that is
// expected, and bounded by the tests.
//
// Built without fast-math and with --fmad=false (kernels/build.py), as the
// tonal walk is.

#include "psy1_tonal.cuh"

#define WARPS 8
#define NGEOM 32

// The geometry, in each block's shared memory: band k covers bins
// [base_k, base_k + span_k); the band of each bin (-1: none); each lane's
// cross-lane scan flags.
struct NoiseTables {
    int base[NGEOM];
    int span[NGEOM];
    unsigned info[32];         // lane l: scan flags, carried bit, continue bits
    unsigned ends[32];         // lane l: which of its bins end a band
    unsigned inband[32];       // lane l: which of its bins lie in a band
    int8_t band[NBINS];
};

struct NoiseScratch {
    WalkScratch walk;
    float sums[3][32];         // band k's sums of lin, CF*energy, CF*energy*bin
    unsigned noise[NSTEP];     // noise member words
};

// The walk's tables and the geometry's (tab rows 2 and 3: the band of each
// bin; the lanes' scan flags, carried and continue bits, end bits and
// in-band bits, psycho1_kernels.noise_tables) into the block's shared
// memory, every load issued before the first store.  All threads of the
// block; the caller synchronises the block after it.
__device__ __forceinline__ void load_tables(WalkTables& t, NoiseTables& nt,
                                            const int32_t* __restrict__ tab,
                                            const int32_t* __restrict__ base,
                                            const int32_t* __restrict__ span)
{
    constexpr int THREADS = 32 * WARPS, PER = NBINS / THREADS;
    const int i = threadIdx.x;
    int32_t run[PER], reach[PER], band[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        run[k] = __ldg(tab + i + k * THREADS);
        reach[k] = __ldg(tab + NBINS + i + k * THREADS);
        band[k] = __ldg(tab + 2 * NBINS + i + k * THREADS);
    }
    int32_t b = 0, sp = 0, info = 0, ends = 0, inband = 0;
    if (i < NGEOM) {
        b = __ldg(base + i);
        sp = __ldg(span + i);
        info = __ldg(tab + 3 * NBINS + i);
        ends = __ldg(tab + 3 * NBINS + 32 + i);
        inband = __ldg(tab + 3 * NBINS + 64 + i);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        t.run[i + k * THREADS] = (uint8_t)run[k];
        t.reach[i + k * THREADS] = (uint32_t)reach[k];
        nt.band[i + k * THREADS] = (int8_t)band[k];
    }
    if (i < NGEOM) {
        nt.base[i] = b;
        nt.span[i] = sp;
        nt.info[i] = (unsigned)info;
        nt.ends[i] = (unsigned)ends;
        nt.inband[i] = (unsigned)inband;
    }
}

__device__ __forceinline__ int sbyte_of(const uint4& v, int i) { return (int)(int8_t)byte_of(v, i); }

// 10^(x/10) as the plain version computes it, torch.pow(10, 0.1 x): the band
// centre below is a truncation with no rounding margin, so the noise sums keep
// the plain version's rounding of every term (the tonal stage keeps exp2f).
__device__ __forceinline__ float lin_of_db_pow(float x) { return powf(10.0f, 0.1f * x); }

// The noise labelling of one walked row (see the top of this file): writes
// power' and both member masks of the row.
__device__ __forceinline__ void noise_row(Stage& st, NoiseScratch& w, const NoiseTables& nt,
                                          const float4 (&e4)[4], unsigned m, float cf,
                                          int lane, float* out_row, uint8_t* tmem_row,
                                          uint8_t* nmem_row)
{
    float pw[16];
    const unsigned typ = power16(st, w.walk, lane, m, pw);
    // typ half-words for the band stage's tone test
    reinterpret_cast<uint16_t*>(w.walk.typ)[lane] = (uint16_t)typ;
    if (lane < NSTEP) w.noise[lane] = 0u;

    // the lane's bins band by band; each band ending here is written, and a
    // band that came in from the left gets the lanes before it added after
    // the scan
    const unsigned info = nt.info[lane];
    const unsigned cont = (info >> 8) & 0xFFFFu;
    const unsigned ends = nt.ends[lane];
    const uint4 bv = *reinterpret_cast<const uint4*>(nt.band + 16 * lane);
    const float bin0 = (float)(16 * lane);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;       // the running sums of the current band
    unsigned usable = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const float4 q = e4[i / 4];
        const float e = i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
        // a usable bin is neither zeroed nor accepted: its power' is its power
        const bool u = !((typ >> i) & 1u) && pw[i] != DBMIN;
        const float x0 = u ? lin_of_db_pow(pw[i]) : 0.0f;
        const float x1 = u ? cf * e : 0.0f;
        const float x2 = x1 * (bin0 + (float)i);
        usable |= (u ? 1u : 0u) << i;
        if ((cont >> i) & 1u) {
            s0 += x0;
            s1 += x1;
            s2 += x2;
        } else {
            s0 = x0;
            s1 = x1;
            s2 = x2;
        }
        if ((ends >> i) & 1u) {                    // the band of bin i ends here
            const int bd = sbyte_of(bv, i);
            w.sums[0][bd] = s0;
            w.sums[1][bd] = s1;
            w.sums[2][bd] = s2;
        }
    }
    const unsigned consumed = usable & nt.inband[lane];
    // the lanes' trailing sums, scanned across the lanes a band spans
    const unsigned fl = info & 31u;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const float y0 = __shfl_up_sync(FULL, s0, 1 << k);
        const float y1 = __shfl_up_sync(FULL, s1, 1 << k);
        const float y2 = __shfl_up_sync(FULL, s2, 1 << k);
        if ((fl >> k) & 1u) {
            s0 += y0;
            s1 += y1;
            s2 += y2;
        }
    }
    const float c0 = __shfl_up_sync(FULL, s0, 1);
    const float c1 = __shfl_up_sync(FULL, s1, 1);
    const float c2 = __shfl_up_sync(FULL, s2, 1);
    if (((info >> 5) & 1u) && ends != 0u) {        // a carried band ends in this lane
        const int band0 = sbyte_of(bv, 0);
        w.sums[0][band0] += c0;
        w.sums[1][band0] += c1;
        w.sums[2][band0] += c2;
    }
    __syncwarp();

    // the band stage, lane k = band k
    const unsigned* typw = w.walk.typ;
    const int lo = nt.base[lane];
    const int n = nt.span[lane];
    int key = -1 - lane;                  // matches no other lane unless valid
    float level = DBMIN;
    if (n > 0) {
        const float sum = w.sums[0][lane], wsum = w.sums[1][lane], wpos = w.sums[2][lane];
        const float spanf = (float)n;
        const float weight = (wpos - (float)lo * wsum) / spanf;
        const bool no_comp = sum <= 0.0f;
        const float index = weight / fmaxf(sum, 1e-37f);
        int c = no_comp ? lo + n / 2 : lo + __float2int_rz(index * spanf);
        c = min(max(c, 0), NBINS - 1);
        if ((typw[c >> 5] >> (c & 31)) & 1u) {
            const bool next_tone = c + 1 < NBINS && ((typw[(c + 1) >> 5] >> ((c + 1) & 31)) & 1u);
            c = min(max(next_tone ? c + 1 : c - 1, 0), NBINS - 1);
        }
        key = c;
        level = no_comp ? DBMIN : 10.0f * log10f(fmaxf(sum, 1e-37f));
    }
    // the last band writing a bin wins
    const unsigned same = __match_any_sync(FULL, key);
    const bool winner = n > 0 && 31 - __clz(same) == lane;
    if (winner) atomicOr(&w.noise[key >> 5], 1u << (key & 31));

    // consumed lines -> DBMIN, then the centres' levels over them
#pragma unroll
    for (int i = 0; i < 16; ++i)
        if ((consumed >> i) & 1u) pw[i] = DBMIN;
    store_bits16(tmem_row, half_word(w.walk.member, lane), lane);
    store_power(st, pw, out_row, lane);          // its __syncwarp()s order the noise words too
    store_bits16(nmem_row, half_word(w.noise, lane), lane);
    if (winner) out_row[key] = level;
}

__global__ void __launch_bounds__(32 * WARPS, 4)
tonal_noise_kernel(const float* __restrict__ power, const uint8_t* __restrict__ cand,
                   const float* __restrict__ energy, const int32_t* __restrict__ tab,
                   const int32_t* __restrict__ base, const int32_t* __restrict__ span,
                   float* __restrict__ pw_out, uint8_t* __restrict__ tmem_out,
                   uint8_t* __restrict__ nmem_out, const float cf, const int B)
{
    __shared__ __align__(16) WalkTables t;
    __shared__ __align__(16) NoiseTables nt;
    __shared__ __align__(16) Stage stages[WARPS];
    __shared__ __align__(16) NoiseScratch scratch[WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * WARPS + warp;
    Stage& st = stages[warp];
    if (row < B) {
        stage_row(st, power + (size_t)row * NBINS, cand + (size_t)row * NBINS, lane);
        set_pads(st, lane);
    }
    load_tables(t, nt, tab, base, span);
    __syncthreads();
    if (row >= B) return;
    cp_async_wait_all();
    __syncwarp();

    NoiseScratch& w = scratch[warp];
    const unsigned m = walk16(st, w.walk, t, lane);
    // the energy only now: held through the walk, its 16 registers per lane
    // would cost a block per SM
    float4 e4[4];
    const float4* src = reinterpret_cast<const float4*>(energy + (size_t)row * NBINS + 16 * lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) e4[k] = __ldcs(src + k);
    noise_row(st, w, nt, e4, m, cf, lane, pw_out + (size_t)row * NBINS,
              tmem_out + (size_t)row * NBINS, nmem_out + (size_t)row * NBINS);
}

// power/energy/pw: [B, 512] f32; cand/tmem/nmem: [B, 512] bytes 0/1
// (torch.bool), all rows 16-byte aligned; runs: [4, 512] int32, the walk's
// two rows (run lengths, reach masks) and the geometry's two (the band of
// each bin, the lanes' scan flags; psycho1_kernels.noise_tables);
// base/span: [32] int32, all on the device; cf: the CF*energy weight's
// constant in f32.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() of the launch.
extern "C" int tonal_noise_launch(const void* power, const void* cand, const void* energy,
                                  const void* runs, const void* base, const void* span,
                                  void* pw, void* tmem, void* nmem, float cf, int B,
                                  void* stream)
{
    if (B <= 0) return 0;
    tonal_noise_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const float*)power, (const uint8_t*)cand, (const float*)energy, (const int32_t*)runs,
        (const int32_t*)base, (const int32_t*)span, (float*)pw, (uint8_t*)tmem,
        (uint8_t*)nmem, cf, B);
    return (int)cudaGetLastError();
}
