// The DAB+ AAC-LC rate loop of one AU (encode.py rate_loop_plain) for Hopper
// (sm_90a): the integer and fractional bisect of the threshold-reduction
// offset over fast bit counts, the final count with the sectioning DP, and
// the afterburner rounds, for every station in one launch.
//
// Replaces no TPU kernel: the JAX package's rate loop is jnp code that XLA
// fuses.  It was added because the eager loop on the card is some 7,000
// small launches per AU (16 bit counts, each a chain of gathers, segment
// sums and a 49-step DP of ~10 launches a band), which set the pace of the
// whole DAB+ step on both the host and the card.
//
// Bound: a station's loop reads only its own spectrum and band tables and
// its budget, so one block runs it, from shared memory.  Bytes: per
// station-AU of two channels in float32 ~23 KB read (rate_kernel.bound_bytes)
// and ~8.5 KB written, 0.26 GB and ~78 us per AU at S=8192 at 3.35 TB/s.
// The real limit is the chain of dependent steps inside a block: 16 counts
// (each a quantisation, per-band Huffman sums and side info) and five 48-step
// DPs.  The design keeps them short: lines and q in shared memory, one
// thread per (channel, band) for the band sums and the count's per-band
// decisions, the DP in one warp per channel with the 12 books in lanes
// (warp min and ballot per band), the side info with ballots over the bands,
// and enough resident blocks (128 threads, ~30 KB) for the card to switch
// between them while one waits.
//
// Arithmetic follows the plain version op for op (separate roundings, no
// FMA contraction: the build passes --fmad=false; exp, log and pow are the
// libm calls PyTorch's CUDA kernels make, with the exponents passed at run
// time), so the integer decisions agree with the plain version run on the
// card.  The one difference: the afterburner's NMR band sums are a matmul
// there and a sum in line order here.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#define NB 49
#define NL 960
#define THREADS 128
#define BIG (1 << 20)
#define PNS_HCB 13
#define FULL 0xffffffffu

// encode._RATE_TABLE (rate_kernel.TABLE_LAYOUT)
#define T_QUAD 0        // [81][4] books 1-4 by quad index
#define T_PAIR56 324    // [81][2] books 5-6 by signed pair index
#define T_PAIR17 486    // [289][5] books 7-11 by the clipped magnitude pair index
#define T_SCF 1931      // [121] scalefactor dpcm lengths by delta + 60
#define T_LIM 2052      // [12] the largest magnitude each book codes
#define T_LEN 2064

// rate_kernel.ladder_table, per ladder
#define L_BOL 0         // [960] band of each line
#define L_QUADS 960     // [240] quads (line / 4) in band order
#define L_QOFF 1200     // [50] first quad of each band
#define L_LEN 1280

struct RateArgs {
    const void *mag075, *absx, *neg, *pns_line;
    const void *thr4, *cap_thr, *floor29, *hole_rank, *hole_thr, *wgt, *log_ffak, *scf_corr,
        *thr;
    const void *no_ah, *pns_mask, *pns_nrg;
    const void *bsel, *force_break, *is_short, *sect_hdr, *tns_bits, *elem_fixed, *budget;
    const void *ladders, *table;
    void *q, *gains, *books, *bits;
    int S, C, refine_rounds, sect_bits, o_lo, o_hi, bisect_steps, frac_steps, hole_o, spill_o,
        refine_bands, table_len, f64;
    double hole_rate, p4, p43;
};

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float fl(float x) { return floorf(x); }
__device__ __forceinline__ double fl(double x) { return floor(x); }
template <typename F> __device__ __forceinline__ F mn(F a, F b) { return b < a ? b : a; }
template <typename F> __device__ __forceinline__ F mx(F a, F b) { return b > a ? b : a; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

template <typename F>
struct Smem {
    F mag[2 * NL];
    F scale[2 * NB];
    F nmr[2 * NB];
    int cost[2][NB][12];
    int red[8];              // per channel: 0-1 band bits, 2-3 gain max, 4-5 nonzero max, 6-7 any
    int chbits[2];           // per channel: the count's bits less the element's fixed bits
    __align__(8) int16_t q[2 * NL];      // the count's quantised lines
    __align__(8) int16_t qbest[2 * NL];  // the accepted ones
    int16_t tab[T_LEN];
    int16_t book[2 * NB];    // the count's books (the DP's choice until the band pass)
    int16_t gtx[2 * NB];     // the count's transmitted gains
    uint8_t flag[2 * NL];    // bit 0: negative line, bit 1: PNS line
    uint8_t lad[L_LEN];
    uint8_t bflag[2 * NB];   // bit 0: coded band, bit 1: PNS band, bit 2: forced section break
    uint8_t bestj[2][NB];
};

// what one thread of a (channel, band) keeps for the whole loop
template <typename F>
struct Band {
    bool on, no_ah, pns, bsel;
    int c, b, pns_nrg;
    F thr4, cap, floor29, hole_rank, hole_thr, w, log_ffak, scf_corr, thr_f;
    bool has_w;
};

struct Station {
    int C, budget, sect_hdr, elem_fixed, tns[2];
    bool is_short;
};

// ---- one bit count (encode.count_for_gains without `keep`) --------------------------
// g: the band thread's gain.  Leaves q in sm.q, the books and transmitted
// gains in sm.book / sm.gtx, and returns the AU's bits (the same on every thread).
template <typename F, bool DP>
__device__ int count_bits(Smem<F>& sm, const Band<F>& bd, const Station& st, int g)
{
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nl = st.C * NL;
    if (bd.on) sm.scale[t] = ex(F(0.6931471805599453) * (F(-0.1875) * F(g)));
    if (t < 8 && t != 2 && t != 3) sm.red[t] = (t >= 4 && t < 6) ? INT_MIN : 0;
    __syncthreads();

    for (int i = t; i < nl; i += THREADS) {
        const int c = i >= NL;
        const F x = sm.mag[i] * sm.scale[c * NB + sm.lad[L_BOL + i - c * NL]];
        int q = (int)mn(mx(fl(x + F(0.4054)), F(0)), F(8191));
        const uint8_t f = sm.flag[i];
        if (f & 1) q = -q;
        if (f & 2) q = 0;
        sm.q[i] = (int16_t)q;
    }
    __syncthreads();

    int book = 0, bbits = 0;
    bool nz = false;
    if (bd.on) {
        const int16_t* tab = sm.tab;
        const int16_t* qc = sm.q + bd.c * NL;
        int s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0, s7 = 0, s8 = 0, s9 = 0, s10 = 0,
            s11 = 0, bmax = 0;
        for (int j = sm.lad[L_QOFF + bd.b]; j < sm.lad[L_QOFF + bd.b + 1]; ++j) {
            const short4 v = *reinterpret_cast<const short4*>(qc + 4 * sm.lad[L_QUADS + j]);
            const int q0 = v.x, q1 = v.y, q2 = v.z, q3 = v.w;
            const int a0 = abs(q0), a1 = abs(q1), a2 = abs(q2), a3 = abs(q3);
            bmax = max(bmax, max(max(a0, a1), max(a2, a3)));
            const int sg01 = (a0 != 0) + (a1 != 0), sg23 = (a2 != 0) + (a3 != 0);
            const int i1 = (clampi(q0 + 1, 0, 2) * 3 + clampi(q1 + 1, 0, 2)) * 9
                           + clampi(q2 + 1, 0, 2) * 3 + clampi(q3 + 1, 0, 2);
            const int i3 = (min(a0, 2) * 3 + min(a1, 2)) * 9 + min(a2, 2) * 3 + min(a3, 2);
            const int i5a = clampi(q0 + 4, 0, 8) * 9 + clampi(q1 + 4, 0, 8);
            const int i5b = clampi(q2 + 4, 0, 8) * 9 + clampi(q3 + 4, 0, 8);
            const int i11a = min(a0, 16) * 17 + min(a1, 16);
            const int i11b = min(a2, 16) * 17 + min(a3, 16);
            // escapes of book 11: 2 floor(log2 a) - 3 bits for each |q| >= 16
            const int esc = (a0 >= 16 ? 2 * (31 - __clz(a0)) - 3 : 0)
                            + (a1 >= 16 ? 2 * (31 - __clz(a1)) - 3 : 0)
                            + (a2 >= 16 ? 2 * (31 - __clz(a2)) - 3 : 0)
                            + (a3 >= 16 ? 2 * (31 - __clz(a3)) - 3 : 0);
            s1 += tab[T_QUAD + i1 * 4];
            s3 += tab[T_QUAD + i3 * 4 + 2] + sg01 + sg23;
            s5 += tab[T_PAIR56 + i5a * 2] + tab[T_PAIR56 + i5b * 2];
            s7 += tab[T_PAIR17 + i11a * 5] + tab[T_PAIR17 + i11b * 5] + sg01 + sg23;
            s9 += tab[T_PAIR17 + i11a * 5 + 2] + tab[T_PAIR17 + i11b * 5 + 2] + sg01 + sg23;
            s11 += tab[T_PAIR17 + i11a * 5 + 4] + tab[T_PAIR17 + i11b * 5 + 4] + sg01 + sg23
                   + esc;
            if (DP) {
                s2 += tab[T_QUAD + i1 * 4 + 1];
                s4 += tab[T_QUAD + i3 * 4 + 3] + sg01 + sg23;
                s6 += tab[T_PAIR56 + i5a * 2 + 1] + tab[T_PAIR56 + i5b * 2 + 1];
                s8 += tab[T_PAIR17 + i11a * 5 + 1] + tab[T_PAIR17 + i11b * 5 + 1] + sg01 + sg23;
                s10 += tab[T_PAIR17 + i11a * 5 + 3] + tab[T_PAIR17 + i11b * 5 + 3] + sg01
                       + sg23;
            }
        }
        nz = bmax > 0;
        const int bits[12] = {0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11};
        if (DP) {
            int* row = sm.cost[bd.c][bd.b];
#pragma unroll
            for (int k = 0; k < 12; ++k) row[k] = bmax <= tab[T_LIM + k] ? bits[k] : BIG;
        } else {
            // the odd books' first minimum (encode.spectral_bits_and_books, fast)
            int best = bmax <= tab[T_LIM] ? 0 : BIG;
#pragma unroll
            for (int k = 1; k < 12; k += 2) {
                const int cst = bmax <= tab[T_LIM + k] ? bits[k] : BIG;
                if (cst < best) { best = cst; book = k; }
            }
            bbits = best;
        }
    }

    if (DP) {
        __syncthreads();
        // the sectioning DP (encode.optimal_books) of channel `warp`: lane k holds book k
        if (warp < st.C) {
            const int c = warp;
            const int sb = st.sect_hdr;
            const int (*cost)[12] = sm.cost[c];
            int dp = lane < 12 ? cost[0][lane] + sb : INT_MAX / 2;
            unsigned long long stayed = 0;
            for (int b = 1; b < NB; ++b) {
                const int best = __reduce_min_sync(FULL, dp);
                const int bj = __ffs(__ballot_sync(FULL, dp == best)) - 1;
                const int nw = best + sb;
                const uint8_t f = sm.bflag[c * NB + b];
                const bool fb = f & 4, sel = (f & 1) && !(f & 2);
                if (dp <= nw && !fb) stayed |= 1ull << (b - 1);
                if (sel && lane < 12) dp = cost[b][lane] + (fb ? nw : min(dp, nw));
                if (lane == 0) sm.bestj[c][b - 1] = (uint8_t)bj;
            }
            const int best = __reduce_min_sync(FULL, dp);
            int k = __ffs(__ballot_sync(FULL, dp == best)) - 1;
            __syncwarp();
            for (int b = NB - 1; b > 0; --b) {
                if (lane == 0) sm.book[c * NB + b] = (int16_t)k;
                const bool st_b = (__shfl_sync(FULL, stayed, k) >> (b - 1)) & 1;
                const uint8_t f = sm.bflag[c * NB + b];
                if ((f & 1) && !(f & 2)) k = st_b ? k : sm.bestj[c][b - 1];
            }
            if (lane == 0) sm.book[c * NB] = (int16_t)k;
        }
        __syncthreads();
        if (bd.on) {
            book = sm.book[t];
            bbits = sm.cost[bd.c][bd.b][book];
        }
    }

    if (bd.on) {
        if (!bd.bsel) { book = 0; bbits = 0; }
        if (bd.pns) { book = PNS_HCB; bbits = 0; }
        sm.book[t] = (int16_t)book;
        atomicAdd(&sm.red[bd.c], bbits);
        atomicMax(&sm.red[4 + bd.c], nz ? g : -100);
        if (nz) atomicOr(&sm.red[6 + bd.c], 1);
    }
    __syncthreads();
    if (bd.on) {
        // all-zero bands' gains into the nonzero bands' window (g_safe)
        const int gnz = sm.red[6 + bd.c] ? sm.red[4 + bd.c] : 100;
        const int g_safe = min(max(g, gnz - 60), gnz);
        sm.gtx[t] = (int16_t)(bd.pns ? bd.pns_nrg : (nz ? g : g_safe));
    }
    __syncthreads();

    // side info of channel `warp` (encode.side_info_bits): lane l has bands l and l + 32
    if (warp < st.C) {
        const int c = warp;
        const int16_t* bk = sm.book + c * NB;
        const int16_t* gt = sm.gtx + c * NB;
        const uint8_t* bf = sm.bflag + c * NB;
        unsigned long long ns = 0, ms = 0, mns = 0;
        for (int h = 0; h < 2; ++h) {
            const int b = lane + 32 * h;
            bool n = false, m_s = false, m_n = false;
            if (b < NB) {
                const bool sel = bf[b] & 1;
                const int bm = sel ? bk[b] : -1;
                const int prev = b == 0 ? -2 : ((bf[b - 1] & 1) ? bk[b - 1] : -1);
                n = sel && (bm != prev || (bf[b] & 4));
                m_s = bm > 0 && bm != PNS_HCB;
                m_n = bm == PNS_HCB;
            }
            ns |= (unsigned long long)__ballot_sync(FULL, n) << (32 * h);
            ms |= (unsigned long long)__ballot_sync(FULL, m_s) << (32 * h);
            mns |= (unsigned long long)__ballot_sync(FULL, m_n) << (32 * h);
        }
        int part = 0;
        for (int h = 0; h < 2; ++h) {
            const int b = lane + 32 * h;
            if (b >= NB) continue;
            const unsigned long long upto = ns & ((2ull << b) - 1);
            if ((bf[b] & 1) && upto) {
                const int d = b - (63 - __clzll(upto));
                part += st.is_short ? (d % 7 == 6) * 3 : (d % 31 == 30) * 5;
            }
            const unsigned long long below = (1ull << b) - 1;
            const unsigned long long prev_s = ms & below, prev_n = mns & below;
            if (((ms >> b) & 1) && prev_s)
                part += sm.tab[T_SCF + clampi(gt[b] - gt[63 - __clzll(prev_s)], -60, 60) + 60];
            if (((mns >> b) & 1) && prev_n)
                part += sm.tab[T_SCF + clampi(gt[b] - gt[63 - __clzll(prev_n)], -60, 60) + 60];
        }
        part = __reduce_add_sync(FULL, part);
        if (lane == 0)
            sm.chbits[c] = sm.red[c] + __popcll(ns) * st.sect_hdr + part
                           + (ms ? sm.tab[T_SCF + 60] : 0) + (mns ? 9 : 0) + (8 + 3)
                           + st.tns[c];
    }
    __syncthreads();
    return sm.chbits[0] + (st.C == 2 ? sm.chbits[1] : 0) + st.elem_fixed + 3 + 7;
}

// ---- one threshold-reduction step (encode.try_offset) -------------------------------
template <typename F, bool DP>
__device__ int try_offset(Smem<F>& sm, const Band<F>& bd, const Station& st, F o,
                          const RateArgs& a)
{
    const int t = threadIdx.x;
    int g = -100;
    if (bd.on) {
        F tr = pw(bd.thr4 + ex(F(0.6931471805599453) * (F(0.5) * o)), F(a.p4));
        if (!bd.no_ah) tr = mn(tr, bd.cap);
        tr = mx(tr, bd.floor29);
        if (bd.hole_rank < (o - F(a.hole_o)) * F(a.hole_rate)) tr = mx(tr, bd.hole_thr);
        if (bd.has_w) tr = tr * bd.w;
        const F spill = mx(o - F(a.spill_o), F(0));
        const F scf = fl(F(8.8585) * (lg(F(6.75) * tr) * F(0.4342944819032518) - bd.log_ffak)
                         + bd.scf_corr + spill);
        if (bd.bsel) g = (int)mn(mx(scf, F(-100)), F(155));
    }
    if (t < 2) sm.red[2 + t] = INT_MIN;
    __syncthreads();
    if (bd.on) atomicMax(&sm.red[2 + bd.c], g);
    __syncthreads();
    if (bd.on) {
        const int gmax = sm.red[2 + bd.c];
        g = min(max(g, gmax - 60), gmax);
    }
    return count_bits<F, DP>(sm, bd, st, g);
}

template <typename F>
__device__ void accept(Smem<F>& sm, int nl, int& gbest, int& bkbest)
{
    for (int i = threadIdx.x; i < nl; i += THREADS) sm.qbest[i] = sm.q[i];
    if (threadIdx.x < nl / NL * NB) {
        gbest = sm.gtx[threadIdx.x];
        bkbest = sm.book[threadIdx.x];
    }
}

template <typename F>
__global__ void __launch_bounds__(THREADS) rate_loop_kernel(const RateArgs a)
{
    __shared__ Smem<F> sm;
    const int t = threadIdx.x;
    const size_t s = blockIdx.x;
    const int C = a.C, nl = C * NL;

    Station st;
    st.C = C;
    st.is_short = a.is_short && ((const uint8_t*)a.is_short)[s];
    st.budget = ((const int*)a.budget)[s];
    st.sect_hdr = a.sect_hdr ? ((const int*)a.sect_hdr)[s] : a.sect_bits;
    st.elem_fixed = ((const int*)a.elem_fixed)[s];
    st.tns[0] = ((const int*)a.tns_bits)[s * C];
    st.tns[1] = C == 2 ? ((const int*)a.tns_bits)[s * C + 1] : 0;

    const F* mag = (const F*)a.mag075 + s * nl;
    const uint8_t* neg = (const uint8_t*)a.neg + s * nl;
    const uint8_t* pnl = (const uint8_t*)a.pns_line + s * nl;
    for (int i = t; i < nl; i += THREADS) {
        sm.mag[i] = mag[i];
        sm.flag[i] = neg[i] | (pnl[i] << 1);
    }
    const uint8_t* lad = (const uint8_t*)a.ladders + (st.is_short ? L_LEN : 0);
    for (int i = t; i < L_LEN; i += THREADS) sm.lad[i] = lad[i];
    for (int i = t; i < T_LEN; i += THREADS) sm.tab[i] = (int16_t)((const int*)a.table)[i];

    Band<F> bd;
    bd.on = t < C * NB;
    bd.c = t / NB;
    bd.b = t - bd.c * NB;
    if (bd.on) {
        const size_t j = s * C * NB + t;
        bd.thr4 = ((const F*)a.thr4)[j];
        bd.cap = ((const F*)a.cap_thr)[j];
        bd.floor29 = ((const F*)a.floor29)[j];
        bd.hole_rank = ((const F*)a.hole_rank)[j];
        bd.hole_thr = ((const F*)a.hole_thr)[j];
        bd.has_w = a.wgt != nullptr;
        bd.w = bd.has_w ? ((const F*)a.wgt)[j] : F(1);
        bd.log_ffak = ((const F*)a.log_ffak)[j];
        bd.scf_corr = ((const F*)a.scf_corr)[j];
        bd.thr_f = mx(((const F*)a.thr)[j], F(1e-10));
        bd.no_ah = ((const uint8_t*)a.no_ah)[j];
        bd.pns = ((const uint8_t*)a.pns_mask)[j];
        bd.pns_nrg = ((const int*)a.pns_nrg)[j];
        bd.bsel = ((const uint8_t*)a.bsel)[s * NB + bd.b];
        const bool fb = a.force_break && ((const uint8_t*)a.force_break)[s * NB + bd.b];
        sm.bflag[t] = bd.bsel | (bd.pns << 1) | (fb << 2);
    }
    __syncthreads();

    // bisect the reduction offset with fast counts: the smallest fitting
    // integer offset, then a fractional bisect over (hi - 1, hi]
    int lo = a.o_lo, hi = a.o_hi;
    for (int i = 0; i < a.bisect_steps; ++i) {
        const int mid = (lo + hi) >= 0 ? (lo + hi) / 2 : -((-(lo + hi) + 1) / 2);
        if (try_offset<F, false>(sm, bd, st, F(mid), a) <= st.budget) hi = mid;
        else lo = mid + 1;
    }
    F fhi = F(hi), flo = mx(fhi - F(1), F(a.o_lo));
    for (int i = 0; i < a.frac_steps; ++i) {
        const F fmid = F(0.5) * (flo + fhi);
        if (try_offset<F, false>(sm, bd, st, fmid, a) <= st.budget) fhi = fmid;
        else flo = fmid;
    }
    int bits = try_offset<F, true>(sm, bd, st, fhi, a);
    int gbest = 0, bkbest = 0;
    accept(sm, nl, gbest, bkbest);

    // afterburner: one gain step down on the worst-NMR bands, kept while the AU fits
    const F p43 = F(a.p43);
    const F* absx = (const F*)a.absx + s * nl;
    for (int r = 0; r < a.refine_rounds; ++r) {
        if (t < 2) sm.red[2 + t] = INT_MIN;
        __syncthreads();
        F nmr = F(0);
        if (bd.on) {
            atomicMax(&sm.red[2 + bd.c], gbest);
            const F sc = ex(F(0.6931471805599453) * (F(0.25) * F(gbest)));
            const int16_t* qb = sm.qbest + bd.c * NL;
            const F* xa = absx + bd.c * NL;
            F acc = F(0);
            for (int j = sm.lad[L_QOFF + bd.b]; j < sm.lad[L_QOFF + bd.b + 1]; ++j) {
                const int l0 = 4 * sm.lad[L_QUADS + j];
                for (int l = l0; l < l0 + 4; ++l) {
                    const F d = xa[l] - pw(F(abs((int)qb[l])), p43) * sc;
                    acc = acc + d * d;
                }
            }
            nmr = acc / bd.thr_f;
        }
        __syncthreads();
        if (bd.on) {
            const bool can = bd.bsel && gbest > sm.red[2 + bd.c] - 60;
            sm.nmr[t] = can ? nmr : -F(INFINITY);
        }
        __syncthreads();
        int g2 = 0;
        if (bd.on) {
            // the stable descending order's first refine_bands (lower band first among ties)
            const F v = sm.nmr[t];
            int rank = 0;
            for (int b2 = 0; b2 < NB; ++b2) {
                const F u = sm.nmr[bd.c * NB + b2];
                rank += (u > v) || (u == v && b2 < bd.b);
            }
            g2 = bd.pns ? gbest : gbest - (rank < a.refine_bands);
        }
        const int total = count_bits<F, true>(sm, bd, st, g2);
        if (total <= st.budget) {
            accept(sm, nl, gbest, bkbest);
            bits = total;
        }
    }

    __syncthreads();
    int* q_out = (int*)a.q + s * nl;
    for (int i = t; i < nl; i += THREADS) q_out[i] = sm.qbest[i];
    if (bd.on) {
        ((int*)a.gains)[s * C * NB + t] = gbest;
        ((int*)a.books)[s * C * NB + t] = bkbest;
    }
    if (t == 0) ((long long*)a.bits)[s] = bits;
}

// args: encode.RateInputs' tensors (rate_kernel.rate_loop), all on the current
// device, float32 (f64 = 0) or float64 (f64 = 1).  Launches S blocks on
// `stream`, does not synchronise, and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an argument the kernel does not take).
extern "C" int rate_loop_launch(const RateArgs* args, void* stream)
{
    const RateArgs a = *args;
    if (a.table_len != T_LEN || (a.C != 1 && a.C != 2) || a.S < 0) return (int)cudaErrorInvalidValue;
    if (a.S == 0) return 0;
    if (a.f64)
        rate_loop_kernel<double><<<a.S, THREADS, 0, (cudaStream_t)stream>>>(a);
    else
        rate_loop_kernel<float><<<a.S, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
