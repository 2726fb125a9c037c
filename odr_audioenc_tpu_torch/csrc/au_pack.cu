// The DAB+ AU content pack of one AU (aupack.py au_content_groups followed by
// pack_au_content) for Hopper (sm_90a): the AU's raw_data_block (SCE or CPE
// with ics_info, the M/S mask, section data, the scalefactor chains, TNS and
// the spectral codewords with their signs and book-11 escapes), the X-PAD
// DSE, the SBR/PS FIL element and ID_END, serialised into a left-aligned
// [maxcb] byte buffer, with the AU's bit count and the fixed-alignment CRC
// reduction R(buf * x^16), for every station in one launch.
//
// Replaces no TPU kernel: the JAX package's pack is jnp code that XLA fuses.
// It was added because the eager slot-grid pack on the card is some 4,000
// small launches per AU (the slot functions, the int64 concatenation of every
// group's widths and values, a scatter-add per byte span, the CRC's bit
// product), which set the pace of the DAB+ step's launch stream.
//
// Bound: a station's AU reads only its own decisions, so one block packs it.
// Bytes: per station-AU of two channels ~8.6 KB read (q as int32 is 7.7 KB)
// and maxcb + 8 written (aupack_kernel.bound_bytes), ~77 MB and ~23 us per AU
// at S=8192 at 3.35 TB/s.  The design keeps every intermediate on chip: the
// slots' widths and values in shared memory in serialisation order (each
// group filled by a strided loop, the scalefactor DPCM chain by one thread per
// channel), one block-wide exclusive scan of the widths for the bit offsets,
// each slot ORed into a shared word buffer (at most four bytes, atomicOr),
// and the CRC from that buffer: a byte-table CRC over each thread's slice,
// shifted by x^(8 * bytes after it) and XOR-reduced across the block.
//
// Semantics follow bitpack.pack_groups exactly: a value is masked to its
// width (at most 24 bits), a slot touches at most its group's span of bytes,
// bytes past maxcb are dropped while the bit count still counts them, so an
// AU over the bound corrupts only its own station.  Every table lookup is an
// integer gather (aupack_kernel.TABLE_LAYOUT, one table per AuPackCtx).

#include <cstdint>
#include <cuda_runtime.h>

#define NB 49
#define NL 960
#define NP 480                 // line pairs per channel
#define THREADS 256
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu
#define PNS_HCB 13
#define SCF_GROUPING 0x77      // tables.SCF_GROUPING
#define G_CRC 0x11021u

// aupack_kernel.TABLE_LAYOUT (int32 entries)
#define T_Q12 0                // [81][4] books 1-2: (len, code) x 2 by quad index
#define T_Q34 324              // [81][4] books 3-4 by unsigned quad index
#define T_P56 648              // [81][4] books 5-6 by signed pair index
#define T_PAIR 972             // [289][10] books 7-11 by clipped magnitude pair index
#define T_SCF 3862             // [121][2] scalefactor dpcm (len, code) by delta + 60
#define T_BOP_L 4104           // [480] band of each line pair, long
#define T_BOP_S 4584           // [480] short
#define T_PERM_S 5064          // [480] short emission order of the pairs
#define T_TX_L 5544            // [49] transmitted bands, long
#define T_TX_S 5593            // [49] short
#define T_GS_L 5642            // [49] section restarts, long
#define T_GS_S 5691            // [49] short
#define T_CRC 5740             // [256] CRC-16 (0x1021) byte table
#define T_XP8 5996             // [maxcb + 1] x^(8j) mod g

struct PackArgs {
    const void *q, *gains, *books, *ms_used, *tns_en, *tns_order, *tns_idx, *tns_en_lo,
        *tns_order_lo, *tns_idx_lo, *tns_len, *wseq, *pad_buf, *pad_len, *sbr_w, *sbr_v,
        *is_last, *table;
    void *aubuf, *au_bits, *crc_part;
    int S, C, K, K_lo, pad_max, pad_stride, pad_len_stride, n_sbr, sbr_stride, last,
        last_stride, max_sfb, msfb_s, has_tns, length_code, length_code_lo, maxcb, table_len;
};

// slot indices in serialisation order (aupack.au_content_groups); channel c's
// slot k is ch0 + c * ch_len + k
struct Layout {
    int hdr, ics, msp, ms, ch0, ch_len, gg, ics_c, sec, scf, tnsp, v1, coef, v2, coef_lo, gc,
        spec, dse, padb, sbr, end, n;
};

__host__ __device__ inline Layout layout(const PackArgs& a)
{
    Layout L{};
    int p = 0;
    L.hdr = p++;
    L.ics = L.msp = L.ms = -1;
    if (a.C == 2) {
        L.ics = p++;
        L.msp = p++;
        L.ms = p;
        p += NB;
    }
    L.ch0 = p;
    int o = 0;
    L.gg = o++;
    L.ics_c = a.C == 1 ? o++ : -1;
    L.sec = o;
    o += NB;
    L.scf = o;
    o += NB;
    L.tnsp = o++;
    L.v1 = L.coef = L.v2 = L.coef_lo = -1;
    if (a.has_tns) {
        L.v1 = o++;
        L.coef = o;
        o += a.K;
        L.v2 = o++;
        L.coef_lo = o;
        o += a.K_lo;
    }
    L.gc = o++;
    L.spec = o;
    o += 3 * NP;
    L.ch_len = o;
    p += a.C * o;
    L.dse = L.padb = L.sbr = -1;
    if (a.pad_len) {
        L.dse = p++;
        L.padb = p;
        p += a.pad_max;
    }
    if (a.sbr_w) {
        L.sbr = p;
        p += a.n_sbr;
    }
    L.end = p++;
    L.n = p;
    return L;
}

__host__ __device__ inline size_t smem_bytes(int n_slots, int maxcb)
{
    // widths int32 [n], values uint32 [n], the byte buffer [maxcb], spans uint8 [n]
    return (size_t)n_slots * 9 + (size_t)maxcb;
}

struct Slots {
    int* w;
    uint32_t* v;
    uint8_t* sp;
    __device__ __forceinline__ void put(int k, int w_, uint32_t v_, int spans)
    {
        w[k] = w_;
        v[k] = v_;
        sp[k] = (uint8_t)spans;
    }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// torch's int32 abs (wraps at INT_MIN)
__device__ __forceinline__ int iabs(int x) { return (int)(x < 0 ? 0u - (uint32_t)x : (uint32_t)x); }

// carry-less product mod G_CRC of two <= 16-bit values (aupack._mulmod_dev)
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b)
{
    uint32_t acc = 0;
    for (int i = 0; i < 16; ++i) {
        if ((a >> i) & 1u) acc ^= b;
        b = ((b << 1) ^ (((b >> 15) & 1u) ? G_CRC : 0u)) & 0xFFFFu;
    }
    return acc;
}

// one slot into the word buffer, as bitpack.pack_groups places it: e is the
// slot's end bit (its exclusive cumulative width)
__device__ __forceinline__ void emit(uint32_t* words, int w, uint32_t v, int spans, int e,
                                     int maxcb)
{
    if (w <= 0) return;
    const uint32_t vm = v & ((1u << min(w, 24)) - 1u);
    const int start = e - w;
    if (vm == 0 || start < 0) return;
    const int b0 = start >> 3, last_b = (e - 1) >> 3;
    for (int k = 0; k < spans; ++k) {
        const int bt = b0 + k;
        if (bt > last_b || bt >= maxcb) break;
        const int sh = e - 8 * (bt + 1);
        const uint32_t c = (sh >= 0 ? vm >> min(sh, 24) : vm << min(-sh, 8)) & 0xFFu;
        if (c) atomicOr(&words[bt >> 2], c << (8 * (bt & 3)));
    }
}

// block-wide exclusive scan of v; *total gets the sum
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < WARPS ? wsum[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        if (lane < WARPS) wsum[lane] = w;
    }
    __syncthreads();
    *total = wsum[WARPS - 1];
    return x - v + (warp ? wsum[warp - 1] : 0);
}

// the spectral slots of emission pair j of one channel: codeword + signs, then
// the two lines' book-11 escapes (aupack._spectral_groups)
__device__ __forceinline__ void spectral_slots(Slots& sl, int k, const int* tab, const int* qc,
                                               const int* bk, const uint8_t* tx, bool is_short,
                                               int j)
{
    const int p = is_short ? tab[T_PERM_S + j] : j;
    const int bp = tab[(is_short ? T_BOP_S : T_BOP_L) + p];
    const int book = (tx[bp] && bk[bp] != PNS_HCB) ? bk[bp] : 0;
    const int ln[2] = {qc[2 * p], qc[2 * p + 1]};
    int w = 0;
    uint32_t v = 0;
    if (book >= 1 && book <= 4) {
        if ((p & 1) == 0) {                   // a quad's codeword rides on its even pair
            const int l4[4] = {ln[0], ln[1], qc[2 * p + 2], qc[2 * p + 3]};
            int c[4];
            for (int i = 0; i < 4; ++i)
                c[i] = book <= 2 ? clampi((int)((uint32_t)l4[i] + 1u), 0, 2)
                                 : clampi(iabs(l4[i]), 0, 2);
            const int idx = (c[0] * 3 + c[1]) * 9 + c[2] * 3 + c[3];
            const int col = (book & 1) ? 0 : 2;
            const int* e = tab + (book <= 2 ? T_Q12 : T_Q34) + 4 * idx + col;
            w = e[0];
            v = (uint32_t)e[1];
            if (book >= 3) {
                uint32_t s4 = 0;
                int n4 = 0;
                for (int i = 0; i < 4; ++i)
                    if (l4[i] != 0) {
                        s4 = (s4 << 1) | (uint32_t)(l4[i] < 0);
                        ++n4;
                    }
                w += n4;
                v = (v << n4) | s4;
            }
        }
    } else if (book == 5 || book == 6) {
        const int idx = clampi((int)((uint32_t)ln[0] + 4u), 0, 8) * 9
            + clampi((int)((uint32_t)ln[1] + 4u), 0, 8);
        const int* e = tab + T_P56 + 4 * idx + (book == 5 ? 0 : 2);
        w = e[0];
        v = (uint32_t)e[1];
    } else if (book >= 7 && book <= 11) {
        const int idx = clampi(iabs(ln[0]), 0, 16) * 17 + clampi(iabs(ln[1]), 0, 16);
        const int* e = tab + T_PAIR + 10 * idx + 2 * (book - 7);
        uint32_t s2 = 0;
        int n2 = 0;
        for (int i = 0; i < 2; ++i)
            if (ln[i] != 0) {
                s2 = (s2 << 1) | (uint32_t)(ln[i] < 0);
                ++n2;
            }
        w = e[0] + n2;
        v = ((uint32_t)e[1] << n2) | s2;
    }
    sl.put(k, w, v, 4);
    for (int i = 0; i < 2; ++i) {
        const int a = iabs(ln[i]);
        int we = 0;
        uint32_t ve = 0;
        if (book == 11 && a >= 16) {
            // n = floor(log2 a) through the float32 exponent, as the plain version takes it
            const int n = (__float_as_int(__int2float_rn(a)) >> 23) - 127;
            we = 2 * n - 3;
            ve = ((((1u << max(n - 3, 0)) - 2u) << n) | ((uint32_t)a - (1u << n)));
        }
        sl.put(k + 1 + i, we, ve, 4);
    }
}

__global__ void __launch_bounds__(THREADS) au_pack_kernel(const PackArgs a)
{
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int bk_s[2 * NB], gn_s[2 * NB];
    __shared__ uint8_t tx[NB], gs[NB];
    __shared__ int wsum[WARPS];
    __shared__ uint32_t red[WARPS];

    const int s = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int C = a.C, maxcb = a.maxcb;
    const Layout L = layout(a);
    const int n = L.n;
    Slots sl{(int*)smem, (uint32_t*)(smem + 4 * (size_t)n), nullptr};
    uint32_t* words = (uint32_t*)(smem + 8 * (size_t)n);
    sl.sp = smem + 8 * (size_t)n + maxcb;
    const int* tab = (const int*)a.table;
    const int wseq = ((const int*)a.wseq)[s];
    const bool is_short = wseq == 2;

    for (int i = t; i < maxcb / 4; i += THREADS) words[i] = 0;
    for (int i = t; i < C * NB; i += THREADS) {
        bk_s[i] = ((const int*)a.books)[(size_t)s * C * NB + i];
        gn_s[i] = ((const int*)a.gains)[(size_t)s * C * NB + i];
    }
    if (t < NB) {
        tx[t] = (uint8_t)tab[(is_short ? T_TX_S : T_TX_L) + t];
        gs[t] = (uint8_t)tab[(is_short ? T_GS_S : T_GS_L) + t];
    }
    __syncthreads();

    // ---- every slot's width, value and span, in serialisation order ----------------
    const int iw = is_short ? 15 : 11;
    const uint32_t iv = is_short ? ((2u << 12) | ((uint32_t)a.msfb_s << 7) | SCF_GROUPING)
                                 : (((uint32_t)wseq << 8) | ((uint32_t)a.max_sfb << 1));
    if (t == 0) {
        if (C == 2) {
            sl.put(L.hdr, 8, (1u << 5) | 1u, 3);     // CPE id + tag + common_window
            sl.put(L.ics, iw, iv, 3);
            sl.put(L.msp, 2, 1, 3);                  // ms_mask_present = 1
        } else {
            sl.put(L.hdr, 7, 0, 3);                  // SCE id + tag
            sl.put(L.ch0 + L.ics_c, iw, iv, 3);
        }
        if (a.pad_len) {                             // DSE: id(3) tag(4) align(1) count(8)
            const int cnt = ((const int*)a.pad_len)[(size_t)s * a.pad_len_stride];
            sl.put(L.dse, cnt > 0 ? 16 : 0, (4u << 13) | (uint32_t)cnt, 3);
        }
        const bool last = a.is_last
            ? ((const uint8_t*)a.is_last)[(size_t)s * a.last_stride] != 0 : a.last != 0;
        sl.put(L.end, last ? 0 : 3, 7, 2);           // ID_END (the last AU's is the tail's)
    }
    if (C == 2)
        for (int b = t; b < NB; b += THREADS)
            sl.put(L.ms + b, tx[b], ((const uint8_t*)a.ms_used)[(size_t)s * NB + b] != 0, 1);

    // the scalefactor chains and global_gain: one thread per channel walks its bands
    if (lane == 0 && warp < C) {
        const int c = warp, base = L.ch0 + c * L.ch_len;
        const int *bk = bk_s + c * NB, *gn = gn_s + c * NB;
        int first = NB;
        for (int b = 0; b < NB; ++b)
            if (tx[b] && bk[b] > 0 && bk[b] != PNS_HCB) {
                first = b;
                break;
            }
        const int gg = clampi(first < NB ? gn[first] + 100 : 100, 0, 255);
        int prev = gg - 100, nprev = gg - 90;
        bool nfirst = true;
        for (int b = 0; b < NB; ++b) {
            const int g = gn[b];
            const bool reg = tx[b] && bk[b] > 0 && bk[b] != PNS_HCB;
            const bool pns = tx[b] && bk[b] == PNS_HCB;
            const int dd = g - nprev;
            const int d0 = clampi(dd, -256, 255), dn = clampi(dd, -60, 60);
            const bool u0 = pns && nfirst;
            const int delta = reg ? g - prev : (u0 ? d0 : dn);
            if (reg) prev = g;
            nprev = u0 ? nprev + d0 : (pns ? nprev + dn : nprev);
            if (pns) nfirst = false;
            int w = 0;
            uint32_t v = 0;
            if (reg || pns) {
                if (u0) {
                    w = 9;
                    v = (uint32_t)(delta + 256);
                } else {
                    const int i = clampi(delta + 60, 0, 120);
                    w = tab[T_SCF + 2 * i];
                    v = (uint32_t)tab[T_SCF + 2 * i + 1];
                }
            }
            sl.put(base + L.scf + b, w, v, 4);
        }
        sl.put(base + L.gg, 8, (uint32_t)gg, 2);
    }

    // section data: each band finds the end of its run
    for (int i = t; i < C * NB; i += THREADS) {
        const int c = i / NB, b = i % NB;
        const int* bk = bk_s + c * NB;
        const bool change = tx[b] && (gs[b] || bk[b] != bk[b > 0 ? b - 1 : 0]);
        int nc = NB;
        for (int x = b + 1; x < NB; ++x)
            if (!tx[x] || gs[x] || bk[x] != bk[x - 1]) {
                nc = x;
                break;
            }
        const int run = clampi(nc - b, 1, NB);
        const int esc = is_short ? 7 : 31, bits = is_short ? 3 : 5;
        const int nesc = run / esc;
        uint32_t v = (uint32_t)bk[b];
        for (int k = 0; k < 2; ++k)
            if (nesc > k) v = (v << bits) | (uint32_t)esc;
        v = (v << bits) | (uint32_t)(run - nesc * esc);
        sl.put(L.ch0 + c * L.ch_len + L.sec + b, change ? 4 + bits * (nesc + 1) : 0,
               change ? v : 0u, 3);
    }

    // TNS headers and gain_control per channel, then the filters' coefficients
    const uint8_t* ten = (const uint8_t*)a.tns_en;
    const uint8_t* ten_lo = (const uint8_t*)a.tns_en_lo;
    for (int c = t; c < C; c += THREADS) {
        const int base = L.ch0 + c * L.ch_len, sc = s * C + c;
        const bool en = ten[sc] != 0;
        sl.put(base + L.tnsp, 2, en, 2);             // pulse_data_present + tns_data_present
        if (a.has_tns) {
            const bool en_lo = ten_lo[sc] != 0 && en;
            const uint32_t n_filt = en_lo ? 2 : 1;
            const uint32_t order = (uint32_t)((const int*)a.tns_order)[sc];
            const uint32_t length = a.tns_len ? (uint32_t)((const int*)a.tns_len)[sc]
                                              : (uint32_t)a.length_code;
            // n_filt(2) coef_res(1) length(6) order(5) dir(1) compress(1)
            const uint32_t v1 = ((((((n_filt << 1) | 1u) << 6) | length) << 5) | order) << 2;
            sl.put(base + L.v1, en ? 16 : 0, v1, 3);
            const uint32_t order_lo = (uint32_t)((const int*)a.tns_order_lo)[sc];
            sl.put(base + L.v2, en_lo ? 13 : 0,
                   (((uint32_t)a.length_code_lo << 5) | order_lo) << 2, 3);
        }
        sl.put(base + L.gc, 1, 0, 3);
    }
    if (a.has_tns) {
        for (int i = t; i < C * (a.K + a.K_lo); i += THREADS) {
            const int c = i / (a.K + a.K_lo), k = i % (a.K + a.K_lo), sc = s * C + c;
            const bool en = ten[sc] != 0;
            const int base = L.ch0 + c * L.ch_len;
            if (k < a.K) {
                const int order = ((const int*)a.tns_order)[sc];
                const int idx = ((const int*)a.tns_idx)[(size_t)sc * a.K + k];
                sl.put(base + L.coef + k, en && k < order ? 4 : 0, (uint32_t)idx & 0xFu, 2);
            } else {
                const int k2 = k - a.K;
                const bool en_lo = ten_lo[sc] != 0 && en;
                const int order = ((const int*)a.tns_order_lo)[sc];
                const int idx = ((const int*)a.tns_idx_lo)[(size_t)sc * a.K_lo + k2];
                sl.put(base + L.coef_lo + k2, en_lo && k2 < order ? 4 : 0,
                       (uint32_t)idx & 0xFu, 2);
            }
        }
    }

    // the spectral slots, in emission order (short windows: their permuted order)
    for (int i = t; i < C * NP; i += THREADS) {
        const int c = i / NP, j = i % NP;
        spectral_slots(sl, L.ch0 + c * L.ch_len + L.spec + 3 * j, tab,
                       (const int*)a.q + ((size_t)s * C + c) * NL, bk_s + c * NB, tx, is_short,
                       j);
    }

    if (a.pad_len) {
        const int cnt = ((const int*)a.pad_len)[(size_t)s * a.pad_len_stride];
        const int* pb = (const int*)a.pad_buf + (size_t)s * a.pad_stride;
        for (int k = t; k < a.pad_max; k += THREADS)
            sl.put(L.padb + k, cnt > 0 && k < cnt ? 8 : 0, (uint32_t)pb[k], 2);
    }
    if (a.sbr_w) {
        const int* sw = (const int*)a.sbr_w + (size_t)s * a.sbr_stride;
        const int* sv = (const int*)a.sbr_v + (size_t)s * a.sbr_stride;
        for (int k = t; k < a.n_sbr; k += THREADS) sl.put(L.sbr + k, sw[k], (uint32_t)sv[k], 4);
    }
    __syncthreads();

    // ---- bit offsets: one exclusive scan over each thread's run of slots ---------------
    const int per = (n + THREADS - 1) / THREADS;
    const int k0 = min(t * per, n), k1 = min(k0 + per, n);
    int sum = 0;
    for (int k = k0; k < k1; ++k) sum += sl.w[k];
    int total;
    int e = block_scan(sum, wsum, &total);
    for (int k = k0; k < k1; ++k) {
        const int w = sl.w[k];
        e += w;
        emit(words, w, sl.v[k], sl.sp[k], e, maxcb);
    }
    __syncthreads();

    // ---- the bytes out, and the CRC reduction from the same buffer -------------------------
    uint32_t* out = (uint32_t*)((uint8_t*)a.aubuf + (size_t)s * maxcb);
    for (int i = t; i < maxcb / 4; i += THREADS) out[i] = words[i];
    const uint8_t* bytes = (const uint8_t*)words;
    const int cb = (maxcb + THREADS - 1) / THREADS;
    const int b0 = min(t * cb, maxcb), b1 = min(b0 + cb, maxcb);
    uint32_t r = 0;
    for (int i = b0; i < b1; ++i)
        r = ((r << 8) & 0xFFFFu) ^ (uint32_t)tab[T_CRC + (((r >> 8) ^ bytes[i]) & 0xFFu)];
    r = mulmod(r, (uint32_t)tab[T_XP8 + (maxcb - b1)]);
    for (int o = 16; o; o >>= 1) r ^= __shfl_xor_sync(FULL, r, o);
    if (lane == 0) red[warp] = r;
    __syncthreads();
    if (t == 0) {
        uint32_t c = 0;
        for (int w = 0; w < WARPS; ++w) c ^= red[w];
        ((int*)a.crc_part)[s] = (int)c;
        ((int*)a.au_bits)[s] = total;
    }
}

// args: one AU's decisions (aupack_kernel.pack_au), all on the current device.
// Launches S blocks on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for an argument the
// kernel does not take).
extern "C" int au_pack_launch(const PackArgs* args, void* stream)
{
    const PackArgs a = *args;
    if ((a.C != 1 && a.C != 2) || a.S < 0 || a.maxcb <= 0 || a.maxcb % 4
        || a.table_len != T_XP8 + a.maxcb + 1)
        return (int)cudaErrorInvalidValue;
    if (a.S == 0) return 0;
    const size_t smem = smem_bytes(layout(a).n, a.maxcb);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            au_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    au_pack_kernel<<<a.S, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
