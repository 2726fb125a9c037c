// The psy-1 tonal walk of one spectrum row (psycho_1.c:267-340), one warp
// per row, shared by tonal_walk.cu and tonal_noise.cu.  Computes what the
// TPU kernels' common body `_tonal_body` (odr_audioenc_tpu/mp2/psycho1_pallas.py:40)
// computes, for a row of a [B, 512] f32 dB spectrum and its 0/1 local-max
// candidates:
//   1. decision: a candidate b is accepted unless some o in 2..run(b) has
//      power[b] - 7 < power[b -+ o] (the one relaxation round of the JAX
//      kernel starts from "nothing accepted", so it reads raw power);
//   2. zeroing: b is zeroed when some accepted a != b has |a - b| <= run(a);
//   3. boost of an accepted, unzeroed bin: 10 log10(lin(b) + lin(b-1) +
//      lin(b+1)), where a neighbour zeroed by an accepted bin left of b
//      adds 0;
//   4. list surgery: accepted p leaves the tone list when it has an
//      accepted predecessor and the next accepted q has q - p <= run(q).
// Gives power' (DBMIN where zeroed, the boost where accepted), member and
// typ (= accepted and not zeroed).
//
// What bounds it on Hopper is the shared-memory and shuffle bandwidth of an
// SM (128 bytes a clock for loads and shuffles together), not the
// arithmetic: the decision reads 22 neighbours of every bin.  So:
//   - one warp owns a row, and lane l owns the 16 consecutive bins
//     16 l .. 16 l + 15; it reads them and the 12 bins on either side once
//     (ten 16-byte loads) and decides its bins from registers;
//   - the row is staged in the warp's own slice of shared memory by 16-byte
//     cp.async copies, skewed by 16 bytes after every 64 so that those
//     16-byte reads hit every bank once (`skew`), with -inf pads around
//     the row so the +-12 reads need no bounds tests;
//   - the accepted bins (a few dozen of 512) are then walked from a list,
//     one per lane: the zeroing test, the boost (exp2/log2), the bins each
//     zeroes (a range of at most 25 bits OR-ed into the zeroed words), the
//     surgery (previous and next accepted bins are the list's neighbours);
//     the boosts then go into the staged row, which becomes power';
//   - only __syncwarp orders the lanes: no row waits for another.
// The zeroing test of an accepted bin uses a static reach table built by
// the wrapper (psycho1_kernels.py `walk_table`): bit d of reach[b] is set
// iff a = b + d - 12 is in range, a != b and run(a) >= |a - b|.  b is
// zeroed iff the accept window around b (cut from words j-1, j, j+1 of the
// 16 accept words, bit l of word j = bin 32 j + l) meets reach[b]; the
// same window against reach[b-+1] says whether a neighbour was zeroed by an
// accepted bin left of b.
//
// Built without fast-math and with --fmad=false (kernels/build.py): the
// masks depend only on exact f32 compares (a maximum of the window compared
// once equals the plain version's compare of each neighbour, NaN included)
// and integer bit operations.  10^(x/10) and 10 log10(y) are
// exp2f(x log2(10)/10) and 10 log10(2) log2f(y), within a few 1e-5 dB of the
// plain version's pow and log10.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NBINS 512
#define NSTEP 16                      // bit words of a row, and bins per lane
#define SROW 680                      // floats of a skewed staged row (skew(527) = 675)
// Accepted bins per row, at most: bins 3..500 have run >= 2, so no two
// accepted bins there are 2 apart (each would need to exceed the other by
// 7 dB): at most 125 in each parity class; plus the 14 bins of run 0.
#define MAX_ACC 272
#define DBMIN (-200.0f)
#define FULL 0xffffffffu

constexpr float LIN_K = 0.33219280948873623f;   // log2(10) / 10
constexpr float DB_K = 3.0102999566398120f;     // 10 log10(2)

__device__ __forceinline__ float lin_of_db(float x) { return exp2f(x * LIN_K); }
__device__ __forceinline__ float db_of_lin(float y) { return DB_K * log2f(fmaxf(y, 1e-37f)); }

// Where float f (-16 <= f < 528) of a staged row lies: a 16-byte gap after
// every 16 floats, so lane l's 16 bins start at 20 l + 20 and the lanes'
// 16-byte reads of one instruction fall on 8 distinct bank groups
// (skew(16 l + c) = 20 l + skew(c)).
__device__ __forceinline__ int skew(int f) { return 20 + f + 4 * (f >> 4); }

// The static tables of the walk, in each block's shared memory.
struct WalkTables {
    uint32_t reach[NBINS];
    uint8_t run[NBINS];
};

// A staged row: power (skewed, -inf pads) and candidates.
struct Stage {
    float p[SROW];
    uint8_t cand[NBINS];
};

// A warp's scratch for the row being walked.
struct WalkScratch {
    unsigned acc[NSTEP];           // accept words (bit l of word j: bin 32 j + l)
    unsigned zero[NSTEP];          // zeroed words
    unsigned member[NSTEP];        // tone-list member words
    unsigned typ[NSTEP];           // typ words
    float boost[MAX_ACC];          // power' of the accepted bins, in list order
    int16_t list[MAX_ACC];         // the accepted bins, in bin order
};

// tab: int32 rows of 512 on the device: run lengths, then reach masks.
// All THREADS threads of the block, every load issued before the first
// store; the caller synchronises the block after it.
template <int THREADS>
__device__ __forceinline__ void load_walk_tables(WalkTables& t, const int32_t* __restrict__ tab)
{
    constexpr int PER = NBINS / THREADS;
    int32_t run[PER], reach[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        run[k] = __ldg(tab + threadIdx.x + k * THREADS);
        reach[k] = __ldg(tab + NBINS + threadIdx.x + k * THREADS);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        t.run[threadIdx.x + k * THREADS] = (uint8_t)run[k];
        t.reach[threadIdx.x + k * THREADS] = (uint32_t)reach[k];
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Starts the copy of a row's power (skewed) and candidates into a stage;
// the caller waits (cp_async_wait_all, __syncwarp) before reading it.
__device__ __forceinline__ void stage_row(Stage& st, const float* power, const uint8_t* cand,
                                          int lane)
{
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = lane + 32 * i;              // 16-byte chunk q: floats 4q .. 4q + 3
        cp_async16(st.p + skew(4 * q), power + 4 * q);
    }
    cp_async16(st.cand + 16 * lane, cand + 16 * lane);
}

// -inf into the pads around a stage's row.
__device__ __forceinline__ void set_pads(Stage& st, int lane)
{
    st.p[lane < 16 ? skew(lane - 16) : skew(NBINS + lane - 16)] = -INFINITY;
}

// 4 bits -> 4 bytes of 0/1 (bit k -> byte k).
__device__ __forceinline__ unsigned expand4(unsigned x) { return (x * 0x00204081u) & 0x01010101u; }

// A lane's 16 bits (bit i: bin 16 lane + i) as one 16-byte store of 0/1
// bytes (torch.bool).
__device__ __forceinline__ void store_bits16(uint8_t* __restrict__ out_row, unsigned h, int lane)
{
    uint4 v;
    v.x = expand4(h & 15u);
    v.y = expand4((h >> 4) & 15u);
    v.z = expand4((h >> 8) & 15u);
    v.w = expand4((h >> 12) & 15u);
    *reinterpret_cast<uint4*>(out_row + 16 * lane) = v;
}

// The lane's 16 bits of a row's bit words (bins 16 lane .. 16 lane + 15).
__device__ __forceinline__ unsigned half_word(const unsigned* words, int lane)
{
    return (words[lane >> 1] >> (16 * (lane & 1))) & 0xFFFFu;
}

// The lane's 16 staged floats (bins 16 lane ..): four conflict-free loads.
__device__ __forceinline__ void own16(const float* skewed, int lane, float (&v)[16])
{
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(skewed + 20 * lane + skew(4 * k));
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
    }
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int i)
{
    const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
    return (w >> (8 * (i & 3))) & 0xFFu;
}

// Step 1 for the lane's 16 bins from registers: bit i of the result is set
// iff bin 16 lane + i is accepted.  Run lengths are 0, 2, 3, 6 or 12 (the
// wrapper's table checks it), so the window maximum is one of four
// cumulative maxima; their outer parts are built from what neighbouring
// bins' windows share.
__device__ __forceinline__ unsigned decide16(const Stage& st, const WalkTables& t, int lane)
{
    float R[40];                                   // bins 16 lane - 12 .. 16 lane + 27
#pragma unroll
    for (int k = 0; k < 10; ++k) {
        const float4 q = *reinterpret_cast<const float4*>(st.p + 20 * lane + skew(4 * k - 12));
        R[4 * k] = q.x;
        R[4 * k + 1] = q.y;
        R[4 * k + 2] = q.z;
        R[4 * k + 3] = q.w;
    }
    const uint4 cv = *reinterpret_cast<const uint4*>(st.cand + 16 * lane);
    const uint4 rv = *reinterpret_cast<const uint4*>(t.run + 16 * lane);
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
        // bins c .. c + 3: the outer parts of their r = 12 windows,
        // [c + k - 12, c + k - 7] and [c + k + 7, c + k + 12], built from
        // what four and two of them share
        const int c = i + 12;                      // R index of bin 16 lane + i
        const float all4 = fmaxf(fmaxf(fmaxf(R[c - 9], R[c - 8]), fmaxf(R[c - 7], R[c + 10])),
                                 fmaxf(R[c + 11], R[c + 12]));
        const float pair01 = fmaxf(all4, fmaxf(fmaxf(R[c - 11], R[c - 10]), fmaxf(R[c + 8], R[c + 9])));
        const float pair23 = fmaxf(all4, fmaxf(fmaxf(R[c - 6], R[c - 5]), fmaxf(R[c + 13], R[c + 14])));
        const float outer[4] = {fmaxf(pair01, fmaxf(R[c - 12], R[c + 7])),
                                fmaxf(pair01, fmaxf(R[c - 6], R[c + 13])),
                                fmaxf(pair23, fmaxf(R[c - 10], R[c + 9])),
                                fmaxf(pair23, fmaxf(R[c - 4], R[c + 15]))};
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
            // bins cc, cc + 1: their [x - 6, x - 4] and [x + 4, x + 6] parts
            const int cc = c + h;
            const float mid2 = fmaxf(fmaxf(R[cc - 5], R[cc - 4]), fmaxf(R[cc + 5], R[cc + 6]));
            const float mid[2] = {fmaxf(mid2, fmaxf(R[cc - 6], R[cc + 4])),
                                  fmaxf(mid2, fmaxf(R[cc - 3], R[cc + 7]))};
#pragma unroll
            for (int g = 0; g < 2; ++g) {
                const int x = cc + g;
                // the maximum over [x - r, x - 2] and [x + 2, x + r]
                const float a2 = fmaxf(R[x - 2], R[x + 2]);
                const float a3 = fmaxf(a2, fmaxf(R[x - 3], R[x + 3]));
                const float a6 = fmaxf(a3, mid[g]);
                const float a12 = fmaxf(a6, outer[h + g]);
                const int r = (int)byte_of(rv, i + h + g);
                const float mx = r >= 12 ? a12 : r >= 6 ? a6 : r >= 3 ? a3 : a2;
                const bool a = (byte_of(cv, i + h + g) != 0u) & ((r < 2) | !(R[x] - 7.0f < mx));
                m |= (a ? 1u : 0u) << (i + h + g);
            }
        }
    }
    return m;
}

// Steps 1-4: decides the lane's bins (returns their accept bits), builds
// the accept words and the list, walks the list, leaves the zeroed and
// member words in the scratch and each accepted bin's power' (its boost,
// or DBMIN where zeroed) in the staged row.  Ends with __syncwarp().
__device__ __forceinline__ unsigned walk16(Stage& st, WalkScratch& w, const WalkTables& t,
                                           int lane)
{
    const unsigned m = decide16(st, t, lane);
    const unsigned word = m | (__shfl_down_sync(FULL, m, 1) << 16);
    if ((lane & 1) == 0) w.acc[lane >> 1] = word;
    if (lane < NSTEP) {
        w.zero[lane] = 0u;
        w.member[lane] = 0u;
    }
    int incl = __popc(m);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
    }
    const int n = min(__shfl_sync(FULL, incl, 31), MAX_ACC);
    int at = incl - __popc(m);
    for (unsigned mm = m; mm != 0u; mm &= mm - 1u, ++at)
        if (at < MAX_ACC) w.list[at] = (int16_t)(16 * lane + __ffs(mm) - 1);
    __syncwarp();

    const float* P = st.p;
    for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        if (i < n) {
            const int b = w.list[i];
            const int j = b >> 5;
            const int l = b & 31;
            // accept bits of bins b-13 .. b+18 (bit e = bin b - 13 + e), cut
            // from words j-1, j, j+1 at bit l + 19 of the 96
            const unsigned prev_w = j > 0 ? w.acc[j - 1] : 0u;
            const unsigned next_w = j < NSTEP - 1 ? w.acc[j + 1] : 0u;
            const int s = l + 19;
            const unsigned win = s < 32 ? __funnelshift_r(prev_w, w.acc[j], s)
                                        : __funnelshift_r(w.acc[j], next_w, s - 32);
            const bool zeroed = ((win >> 1) & t.reach[b]) != 0u;
            float pw = DBMIN;
            if (!zeroed) {
                // a neighbour zeroed by an accepted bin left of b adds nothing
                const bool left_z = b >= 1 && (win & t.reach[b - 1] & 0x1FFFu) != 0u;
                const bool right_z = b + 1 < NBINS && ((win >> 2) & t.reach[b + 1] & 0x7FFu) != 0u;
                float tot = lin_of_db(P[skew(b)]);
                if (b >= 1 && !left_z) tot += lin_of_db(P[skew(b - 1)]);
                if (b + 1 < NBINS && !right_z) tot += lin_of_db(P[skew(b + 1)]);
                pw = db_of_lin(tot);
            }
            w.boost[i] = pw;
            // the bins b zeroes: [b - run, b + run] but b, within the row
            const int r = t.run[b];
            if (r > 0) {
                const int zl = max(b - r, 0), zh = min(b + r, NBINS - 1);
                for (int k = zl >> 5; k <= zh >> 5; ++k) {
                    const int lo_bit = max(zl - 32 * k, 0), hi_bit = min(zh - 32 * k, 31);
                    unsigned mask = (0xFFFFFFFFu >> (31 - hi_bit)) & (0xFFFFFFFFu << lo_bit);
                    if (k == j) mask &= ~(1u << l);
                    atomicOr(&w.zero[k], mask);
                }
            }
            // list surgery
            const int prev = i > 0 ? w.list[i - 1] : -1;
            const int nxt = i + 1 < n ? w.list[i + 1] : -1;
            if (!(prev >= 0 && nxt >= 0 && (nxt - b) <= (int)t.run[nxt]))
                atomicOr(&w.member[j], 1u << l);
        }
    }
    __syncwarp();
    // the boosts into the staged row, now that no neighbour is read
    for (int i = lane; i < n; i += 32) st.p[skew(w.list[i])] = w.boost[i];
    __syncwarp();
    return m;
}

// power' of the lane's 16 bins, after walk16 (m: their accept bits): DBMIN
// where zeroed and not accepted, the staged value elsewhere.  Returns the
// typ bits.
__device__ __forceinline__ unsigned power16(const Stage& st, const WalkScratch& w, int lane,
                                            unsigned m, float (&pw)[16])
{
    const unsigned z = half_word(w.zero, lane);
    own16(st.p, lane, pw);
    const unsigned dead = z & ~m;
#pragma unroll
    for (int i = 0; i < 16; ++i)
        if ((dead >> i) & 1u) pw[i] = DBMIN;
    return m & ~z;
}

// The lane's 16 values of power' into the row of pw_out, through the
// stage's power (no longer read): each store instruction then writes 128
// contiguous bytes.  Starts with __syncwarp() (every lane done reading the
// stage) and ends with one.
__device__ __forceinline__ void store_power(Stage& st, const float (&pw)[16], float* out_row,
                                            int lane)
{
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k)
        *reinterpret_cast<float4*>(st.p + 20 * lane + skew(4 * k)) =
            make_float4(pw[4 * k], pw[4 * k + 1], pw[4 * k + 2], pw[4 * k + 3]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) out_row[32 * j + lane] = st.p[skew(32 * j + lane)];
    __syncwarp();
}
