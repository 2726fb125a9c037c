/* Native batch DAB+ superframe packer: AU syntax (AAC-LC with MS/TNS +
 * optional DSE X-PAD + SBR/PS FIL payload), superframe assembly (firecode,
 * au_start back-patch, AU CRCs, FIL padding) and RS(120,110) column
 * interleave - matching host/aacpack.py + dabplus/sbr.py byte-for-byte
 * (equivalence-tested against the Python implementations).
 *
 * The reference's equivalent code is C++ (libAACenc bitenc.cpp,
 * tpenc_dab.cpp, contrib/fec); at fleet batch sizes the Python writer is
 * the wall-clock bottleneck, so this is the production path.
 */
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "aac_tables.h"

namespace {

struct BitWr {
  uint8_t *buf;
  size_t bitpos = 0;
  explicit BitWr(uint8_t *b) : buf(b) {}
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      size_t byte = bitpos >> 3;
      int off = 7 - int(bitpos & 7);
      uint8_t bit = (v >> i) & 1;
      buf[byte] = uint8_t((buf[byte] & ~(1u << off)) | (bit << off));
      ++bitpos;
    }
  }
};

uint16_t crc16_ccitt(const uint8_t *d, int n, uint16_t crc = 0xFFFF,
                     uint16_t poly = 0x1021) {
  for (int i = 0; i < n; ++i) {
    crc = uint16_t(crc ^ (d[i] << 8));
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? uint16_t((crc << 1) ^ poly) : uint16_t(crc << 1);
  }
  return crc;
}

uint16_t firecode(const uint8_t *d, int n) {
  uint16_t crc = 0;
  for (int i = 0; i < n; ++i) {
    crc = uint16_t(crc ^ (d[i] << 8));
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? uint16_t((crc << 1) ^ 0x782D) : uint16_t(crc << 1);
  }
  return crc;
}

/* GF(256) / RS(120,110), poly 0x11D, fcr 0, prim 1 (contrib/fec) */
struct RsDab {
  uint8_t exp[512], log[256], taps[10];
  RsDab() {
    int x = 1;
    for (int i = 0; i < 255; ++i) {
      exp[i] = uint8_t(x);
      log[x] = uint8_t(i);
      x <<= 1;
      if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 512; ++i) exp[i] = exp[i - 255];
    log[0] = 0;
    /* genpoly = prod (x - a^i), i = 0..9; ascending degree g[0..10] */
    uint8_t g[11] = {1};
    int deg = 0;
    for (int i = 0; i < 10; ++i) {
      uint8_t root = exp[i];
      uint8_t ng[11] = {0};
      for (int j = 0; j <= deg; ++j) {
        ng[j + 1] ^= g[j];                       /* x * g */
        ng[j] ^= mul(g[j], root);                /* root * g */
      }
      ++deg;
      memcpy(g, ng, sizeof(g));
    }
    /* tap for parity slot j is g[nroots-1-j] */
    for (int j = 0; j < 10; ++j) taps[j] = g[9 - j];
  }
  uint8_t mul(uint8_t a, uint8_t b) const {
    if (!a || !b) return 0;
    return exp[log[a] + log[b]];
  }
  void encode(const uint8_t *data, int kk, uint8_t *par) const {
    memset(par, 0, 10);
    for (int i = 0; i < kk; ++i) {
      uint8_t fb = uint8_t(data[i] ^ par[0]);
      memmove(par, par + 1, 9);
      par[9] = 0;
      if (fb)
        for (int j = 0; j < 10; ++j) par[j] ^= mul(taps[j], fb);
    }
  }
};

const RsDab &rs_dab() {
  static RsDab rs;
  return rs;
}

void write_spectrum(BitWr &bw, const int32_t *q, int book, int lo, int hi) {
  int step = (book <= 4) ? 4 : 2;
  for (int i = lo; i < hi; i += step) {
    int v0 = q[i], v1 = q[i + 1];
    int v2 = step == 4 ? q[i + 2] : 0, v3 = step == 4 ? q[i + 3] : 0;
    switch (book) {
      case 1: case 2: {
        int idx = (((v0 + 1) * 3 + (v1 + 1)) * 3 + (v2 + 1)) * 3 + (v3 + 1);
        const uint32_t *c = book == 1 ? HC1 : HC2;
        const uint8_t *l = book == 1 ? HL1 : HL2;
        bw.put(c[idx], l[idx]);
        break;
      }
      case 3: case 4: {
        int a0 = v0 < 0 ? -v0 : v0, a1 = v1 < 0 ? -v1 : v1;
        int a2 = v2 < 0 ? -v2 : v2, a3 = v3 < 0 ? -v3 : v3;
        int idx = ((a0 * 3 + a1) * 3 + a2) * 3 + a3;
        const uint32_t *c = book == 3 ? HC3 : HC4;
        const uint8_t *l = book == 3 ? HL3 : HL4;
        bw.put(c[idx], l[idx]);
        if (v0) bw.put(v0 < 0, 1);
        if (v1) bw.put(v1 < 0, 1);
        if (v2) bw.put(v2 < 0, 1);
        if (v3) bw.put(v3 < 0, 1);
        break;
      }
      case 5: case 6: {
        int idx = (v0 + 4) * 9 + (v1 + 4);
        const uint32_t *c = book == 5 ? HC5 : HC6;
        const uint8_t *l = book == 5 ? HL5 : HL6;
        bw.put(c[idx], l[idx]);
        break;
      }
      case 7: case 8: case 9: case 10: {
        int a0 = v0 < 0 ? -v0 : v0, a1 = v1 < 0 ? -v1 : v1;
        int dim = book <= 8 ? 8 : 13;
        int idx = a0 * dim + a1;
        const uint32_t *c = book == 7 ? HC7 : book == 8 ? HC8
                          : book == 9 ? HC9 : HC10;
        const uint8_t *l = book == 7 ? HL7 : book == 8 ? HL8
                         : book == 9 ? HL9 : HL10;
        bw.put(c[idx], l[idx]);
        if (v0) bw.put(v0 < 0, 1);
        if (v1) bw.put(v1 < 0, 1);
        break;
      }
      default: { /* 11 with escapes */
        int a0 = v0 < 0 ? -v0 : v0, a1 = v1 < 0 ? -v1 : v1;
        int i0 = a0 < 16 ? a0 : 16, i1 = a1 < 16 ? a1 : 16;
        int idx = i0 * 17 + i1;
        bw.put(HC11[idx], HL11[idx]);
        if (v0) bw.put(v0 < 0, 1);
        if (v1) bw.put(v1 < 0, 1);
        for (int a : {a0, a1})
          if (a >= 16) {
            int n = 31 - __builtin_clz(unsigned(a));
            bw.put(uint32_t((((1u << (n - 3)) - 2u) << n) | (a - (1u << n))),
                   2 * n - 3);
          }
      }
    }
  }
}

void write_tns_data(BitWr &bw, int order, const int32_t *coefs,
                    int length_code, int order_lo = 0,
                    const int32_t *coefs_lo = nullptr,
                    int length_code_lo = 0) {
  /* one or two filters: filter 0 covers the TOP length_code bands, the
   * optional LO filter the next length_code_lo below (fdk HIFILT/LOFILT
   * split, aacenc_tns.cpp:440-452) */
  bw.put(order_lo > 0 ? 2 : 1, 2);
  bw.put(1, 1);
  bw.put(length_code, 6);
  bw.put(order, 5);
  bw.put(0, 1);
  bw.put(0, 1);
  for (int i = 0; i < order; ++i) bw.put(uint32_t(coefs[i]) & 0xF, 4);
  if (order_lo > 0) {
    bw.put(length_code_lo, 6);
    bw.put(order_lo, 5);
    bw.put(0, 1);
    bw.put(0, 1);
    for (int i = 0; i < order_lo; ++i) bw.put(uint32_t(coefs_lo[i]) & 0xF, 4);
  }
}

/* wseq: 0 LONG / 1 START / 2 EIGHT_SHORT / 3 STOP.  Short blocks use the
 * fixed {4,4} window grouping (scale_factor_grouping 0x77) over the
 * window-major device layout - see host/aacpack.py for the band map. */
void write_ics_info(BitWr &bw, int max_sfb, int wseq, int max_sfb_s) {
  bw.put(0, 1);
  if (wseq == 2) {
    bw.put(2, 2);
    bw.put(0, 1);
    bw.put(uint32_t(max_sfb_s), 4);
    bw.put(0x77, 7); /* {4,4} grouping */
  } else {
    bw.put(uint32_t(wseq), 2);
    bw.put(0, 1);
    bw.put(uint32_t(max_sfb), 6);
    bw.put(0, 1);
  }
}

void write_ics(BitWr &bw, const int32_t *q, const int32_t *gains,
               const int32_t *books, int max_sfb, const int32_t *sfb_off,
               bool include_info, bool tns_on, int tns_order,
               const int32_t *tns_coefs, int tns_length_code,
               int wseq, const int32_t *sfb_off_s, int nsfb_s, int max_sfb_s,
               int tns_order_lo = 0, const int32_t *tns_coefs_lo = nullptr,
               int tns_length_code_lo = 0) {
  const bool is_short = (wseq == 2);
  int first_nz = -1;
  if (is_short) {
    for (int g = 0; g < 2 && first_nz < 0; ++g)
      for (int b = 0; b < max_sfb_s; ++b)
        if (books[g * nsfb_s + b] > 0 && books[g * nsfb_s + b] != 13) {
          first_nz = g * nsfb_s + b; break;
        }
  } else {
    for (int b = 0; b < max_sfb; ++b)
      if (books[b] > 0 && books[b] != 13) { first_nz = b; break; }
  }
  int gg = first_nz >= 0 ? gains[first_nz] + 100 : 100;
  gg = gg < 0 ? 0 : (gg > 255 ? 255 : gg);
  bw.put(gg, 8);
  if (include_info) write_ics_info(bw, max_sfb, wseq, max_sfb_s);
  if (is_short) {
    /* section_data restarts per window group; 3-bit sect_len, escape 7 */
    for (int g = 0; g < 2; ++g) {
      const int32_t *gb = books + g * nsfb_s;
      for (int b = 0; b < max_sfb_s;) {
        int e = b;
        while (e < max_sfb_s && gb[e] == gb[b]) ++e;
        bw.put(uint32_t(gb[b]), 4);
        int ln = e - b;
        while (ln >= 7) { bw.put(7, 3); ln -= 7; }
        bw.put(ln, 3);
        b = e;
      }
    }
  } else {
    for (int b = 0; b < max_sfb;) {
      int e = b;
      while (e < max_sfb && books[e] == books[b]) ++e;
      bw.put(uint32_t(books[b]), 4);
      int ln = e - b;
      while (ln >= 31) { bw.put(31, 5); ln -= 31; }
      bw.put(ln, 5);
      b = e;
    }
  }
  /* scale_factor_data: regular dpcm over spectral bands; PNS (book 13)
   * bands carry a separate noise-energy chain - 9-bit PCM first, then
   * scf-huffman deltas (aacdec_pns.cpp CPns_Read) */
  {
    int prev = gg - 100;
    int noise_prev = 0;
    bool noise_active = false;
    const int n_tx = is_short ? 2 * max_sfb_s : max_sfb;
    for (int i = 0; i < n_tx; ++i) {
      int gb = is_short ? (i / max_sfb_s) * nsfb_s + (i % max_sfb_s) : i;
      int bk = books[gb];
      if (bk == 13) {
        int v = gains[gb];
        if (!noise_active) {
          int d0 = v - (gg - 90);
          d0 = d0 < -256 ? -256 : (d0 > 255 ? 255 : d0);
          bw.put(uint32_t(d0 + 256), 9);
          noise_prev = (gg - 90) + d0;
          noise_active = true;
        } else {
          int d = v - noise_prev;
          d = d < -60 ? -60 : (d > 60 ? 60 : d);
          bw.put(HC_SCF[d + 60], HL_SCF[d + 60]);
          noise_prev += d;
        }
      } else if (bk > 0) {
        int delta = gains[gb] - prev;
        bw.put(HC_SCF[delta + 60], HL_SCF[delta + 60]);
        prev = gains[gb];
      }
    }
  }
  bw.put(0, 1);
  if (tns_on && !is_short) {
    bw.put(1, 1);
    write_tns_data(bw, tns_order, tns_coefs, tns_length_code,
                   tns_order_lo, tns_coefs_lo, tns_length_code_lo);
  } else {
    bw.put(0, 1);
  }
  bw.put(0, 1);
  if (is_short) {
    /* grouped band (g,b): the sfb's lines from each window of the group,
     * window-major chunks (widths %4 keep codewords chunk-aligned) */
    for (int g = 0; g < 2; ++g)
      for (int b = 0; b < max_sfb_s; ++b) {
        int bk = books[g * nsfb_s + b];
        if (bk <= 0 || bk == 13) continue;
        for (int w = g * 4; w < g * 4 + 4; ++w)
          write_spectrum(bw, q, bk, w * 120 + sfb_off_s[b],
                         w * 120 + sfb_off_s[b + 1]);
      }
  } else {
    for (int b = 0; b < max_sfb; ++b)
      if (books[b] > 0 && books[b] != 13)
        write_spectrum(bw, q, books[b], sfb_off[b], sfb_off[b + 1]);
  }
}

void write_dse(BitWr &bw, const uint8_t *payload, int n) {
  while (n > 0) {
    int cnt = n < 510 ? n : 510;
    bw.put(4, 3);
    bw.put(0, 4);
    bw.put(0, 1);
    if (cnt >= 255) {
      bw.put(255, 8);
      bw.put(uint32_t(cnt - 255), 8);
    } else {
      bw.put(uint32_t(cnt), 8);
    }
    for (int i = 0; i < cnt; ++i) bw.put(payload[i], 8);
    payload += cnt;
    n -= cnt;
  }
}

#define PS_NBANDS 20

int write_ps_data(BitWr &bw, const int32_t *iid, const int32_t *icc,
                  int fine, int n_env) {
  /* 20-band IID (mode 1 coarse / 4 fine) + 20-band ICC over PS_NENV
   * envelopes; env 0 FREQ-delta, later envelopes TIME-delta (mirrors
   * sbr.py _write_ps_data / ps_bitenc.cpp:555-623).
   * iid/icc: [PS_NENV][PS_NBANDS] row-major. */
  size_t n0 = bw.bitpos;
  bw.put(1, 1);
  bw.put(1, 1);
  bw.put(fine ? 4 : 1, 3);   /* iid_mode: 20 bands, fine/coarse */
  bw.put(icc ? 1 : 0, 1);
  if (icc) bw.put(1, 3);     /* icc_mode 1 = 20 bands */
  bw.put(0, 1);
  bw.put(0, 1);              /* frame_class FIX */
  bw.put(n_env == 1 ? 1 : (n_env == 2 ? 2 : 3), 2);
  int lav = fine ? 30 : 14;
  for (int e = 0; e < n_env; ++e) {
    bw.put(e == 0 ? 0 : 1, 1);          /* bs_iid_dt */
    for (int b = 0; b < PS_NBANDS; ++b) {
      int ref = e == 0 ? (b ? iid[b - 1] : 0) : iid[(e - 1) * PS_NBANDS + b];
      int d = iid[e * PS_NBANDS + b] - ref;
      d = d < -lav ? -lav : (d > lav ? lav : d);
      if (fine)
        bw.put(IID_CODE_FF[d + 30], IID_LEN_FF[d + 30]);
      else
        bw.put(IID_CODE_F[d + 14], IID_LEN_F[d + 14]);
    }
  }
  if (icc) {
    for (int e = 0; e < n_env; ++e) {
      bw.put(e == 0 ? 0 : 1, 1);        /* bs_icc_dt */
      for (int b = 0; b < PS_NBANDS; ++b) {
        int ref = e == 0 ? (b ? icc[b - 1] : 0)
                         : icc[(e - 1) * PS_NBANDS + b];
        int d = icc[e * PS_NBANDS + b] - ref;
        d = d < -7 ? -7 : (d > 7 ? 7 : d);
        bw.put(ICC_CODE_F[d + 7], ICC_LEN_F[d + 7]);
      }
    }
  }
  return int(bw.bitpos - n0);
}

void write_env(BitWr &sbr, const int32_t *env_vals, int nb, bool amp15,
               bool balance = false) {
  /* 1-envelope frames: 1.5 dB units (7-bit start, LAV60 books); split
   * frames: 3.0 dB (6-bit start, LAV31 books) - code_env.cpp:123-185.
   * balance: coupled ch1 wire values (halved domain), balance start
   * widths (6/5) + EnvBalance books. */
  int prev = env_vals[0];
  sbr.put(uint32_t(prev), balance ? (amp15 ? 6 : 5) : (amp15 ? 7 : 6));
  int lav = balance ? (amp15 ? 24 : 12) : (amp15 ? 60 : 31);
  for (int i = 1; i < nb; ++i) {
    int d = env_vals[i] - prev;
    d = d < -lav ? -lav : (d > lav ? lav : d);
    if (balance) {
      if (amp15)
        sbr.put(ENVBAL_CODE_F[d + 24], ENVBAL_LEN_F[d + 24]);
      else
        sbr.put(ENVBAL3_CODE_F[d + 12], ENVBAL3_LEN_F[d + 12]);
    } else if (amp15) {
      sbr.put(ENV_CODE_F[d + 60], ENV_LEN_F[d + 60]);
    } else {
      sbr.put(ENV3_CODE_F[d + 31], ENV3_LEN_F[d + 31]);
    }
    prev = prev + d;
  }
}

void write_sbr_payload(BitWr &bw, const int32_t *const *envs_l, int nl,
                       const int32_t *const *envs_r, int nr,
                       const int32_t *noise_l,
                       const int32_t *P /* sbr params */, bool write_header,
                       const int32_t *ps_iid, const int32_t *ps_icc,
                       const int32_t *invf_l, const int32_t *invf_r,
                       const int32_t *noise_r,
                       const uint8_t *add_harm_l = nullptr,
                       const uint8_t *add_harm_r = nullptr, int n_hi = 0,
                       int ps_fine = 0, int gidx_l = -1, int gidx_r = -1,
                       bool coupled = false) {
  /* P: 0 start_freq, 1 stop_freq, 2 xover, 3 freq_scale, 4 alter_scale,
   * 5 noise_bands, 6 n_q, 7 n_lo, 10 n_hi */
  if (!noise_r) noise_r = noise_l;
  uint8_t sbuf[512] = {0};
  BitWr sbr(sbuf);
  sbr.put(write_header ? 1 : 0, 1);
  if (write_header) {
    sbr.put(1, 1); /* bs_amp_res = 3.0 dB */
    sbr.put(uint32_t(P[0]), 4);
    sbr.put(uint32_t(P[1]), 4);
    sbr.put(uint32_t(P[2]), 3);
    sbr.put(0, 2);
    sbr.put(1, 1);
    sbr.put(0, 1);
    sbr.put(uint32_t(P[3]), 2);
    sbr.put(uint32_t(P[4]), 1);
    sbr.put(uint32_t(P[5]), 2);
  }
  sbr.put(0, 1); /* bs_data_extra */
  /* variable-grid menu (sbr.py GRID_MENU): {frame_class, R} per entry */
  static const int GRID_CLASS[8] = {2, 2, 2, 1, 2, 1, 1, 1};
  static const int GRID_REL[8] = {0, 1, 2, 3, 3, 2, 1, 0};
  auto grid = [&](int ne, int gidx) {
    if (ne == 1 || gidx < 0) {
      sbr.put(0, 2);                     /* FIXFIX */
      sbr.put(ne == 1 ? 0 : 1, 2);       /* ceil(log2(num_env)) */
      sbr.put(1, 1);                     /* bs_freq_res = high */
      return;
    }
    sbr.put(uint32_t(GRID_CLASS[gidx]), 2);  /* FIXVAR / VARFIX */
    sbr.put(0, 2);                       /* A / aL = 0 */
    sbr.put(1, 2);                       /* one relative border */
    sbr.put(uint32_t(GRID_REL[gidx]), 2);
    sbr.put(0, 2);                       /* pointer p = 0 */
    sbr.put(1, 1);                       /* freq res env 0 */
    sbr.put(1, 1);                       /* freq res env 1 */
  };
  auto dtdf = [&](int ne) {
    for (int e = 0; e < ne; ++e) sbr.put(0, 1);
    for (int e = 0; e < (ne == 1 ? 1 : 2); ++e) sbr.put(0, 1);
  };
  auto envw = [&](const int32_t *const *envs, int ne, bool bal = false) {
    for (int e = 0; e < ne; ++e) write_env(sbr, envs[e], n_hi, ne == 1, bal);
  };
  auto noisew = [&](int ne, const int32_t *nv, bool bal = false) {
    /* first band 5 bits, then FREQ deltas (bit_sbr.cpp:751-830);
     * balance noise uses the EnvBalance11 book (LAV 12) */
    int lav = bal ? 12 : 31;
    for (int e = 0; e < (ne == 1 ? 1 : 2); ++e) {
      int prev = nv[0];
      sbr.put(uint32_t(prev), 5);
      for (int i = 1; i < P[6]; ++i) {
        int d = nv[i] - prev;
        d = d < -lav ? -lav : (d > lav ? lav : d);
        if (bal)
          sbr.put(ENVBAL3_CODE_F[d + 12], ENVBAL3_LEN_F[d + 12]);
        else
          sbr.put(NOISE_CODE_F[d + 31], NOISE_LEN_F[d + 31]);
        prev = prev + d;
      }
    }
  };
  auto invfw = [&](const int32_t *modes) {
    for (int i = 0; i < P[6]; ++i)
      sbr.put(uint32_t(modes ? modes[i] : 1), 2);
  };
  auto addharmw = [&](const uint8_t *flags) {
    bool any = false;
    if (flags)
      for (int b = 0; b < n_hi; ++b) any = any || flags[b];
    if (!any) {
      sbr.put(0, 1);
    } else {
      sbr.put(1, 1);
      for (int b = 0; b < n_hi; ++b) sbr.put(flags[b] ? 1 : 0, 1);
    }
  };
  if (envs_r && coupled) {
    /* sbr_channel_pair_element, coupling on (env_extr.cpp:637-810):
     * one grid + one invf; env/noise interleaved; ch1 = balance */
    sbr.put(1, 1);                                   /* bs_coupling */
    grid(nl, gidx_l);
    dtdf(nl); dtdf(nr);
    invfw(invf_l);
    envw(envs_l, nl);
    noisew(nl, noise_l);
    envw(envs_r, nr, true);
    noisew(nr, noise_r, true);
    addharmw(add_harm_l);
    addharmw(add_harm_r);
  } else if (envs_r) {
    /* sbr_channel_pair_element, coupling off (env_extr.cpp:617-820) */
    sbr.put(0, 1);                                   /* bs_coupling */
    grid(nl, gidx_l); grid(nr, gidx_r);
    dtdf(nl); dtdf(nr);
    invfw(invf_l);
    invfw(invf_r);
    envw(envs_l, nl);
    envw(envs_r, nr);
    noisew(nl, noise_l);
    noisew(nr, noise_r);
    addharmw(add_harm_l);
    addharmw(add_harm_r);
  } else {
    grid(nl, gidx_l);
    dtdf(nl);
    invfw(invf_l);
    envw(envs_l, nl);
    noisew(nl, noise_l);
    addharmw(add_harm_l);
  }
  if (!ps_iid) {
    sbr.put(0, 1);
  } else {
    uint8_t pbuf[64] = {0};
    BitWr ps(pbuf);
    int ps_bits = 2 + write_ps_data(ps, ps_iid, ps_icc, ps_fine, P[11]);
    int ext_size = (ps_bits + 7) / 8;
    sbr.put(1, 1);
    if (ext_size < 15) {
      sbr.put(uint32_t(ext_size), 4);
    } else {
      sbr.put(15, 4);
      sbr.put(uint32_t(ext_size - 15), 8);
    }
    sbr.put(2, 2);
    size_t nb = ps.bitpos;
    for (size_t i = 0; i < nb / 8; ++i) sbr.put(pbuf[i], 8);
    if (nb % 8) sbr.put(pbuf[nb / 8] >> (8 - nb % 8), int(nb % 8));
    int pad = ext_size * 8 - ps_bits;
    if (pad) sbr.put(0, pad);
  }
  int payload_bits = int(sbr.bitpos);
  int total_ext_bits = 4 + payload_bits;
  int cnt = (total_ext_bits + 7) / 8;
  bw.put(6, 3);
  if (cnt >= 15) {
    bw.put(15, 4);
    bw.put(uint32_t(cnt - 14), 8);
  } else {
    bw.put(uint32_t(cnt), 4);
  }
  bw.put(13, 4); /* EXT_SBR_DATA */
  size_t nb = sbr.bitpos;
  for (size_t i = 0; i < nb / 8; ++i) bw.put(sbuf[i], 8);
  if (nb % 8) bw.put(sbuf[nb / 8] >> (8 - nb % 8), int(nb % 8));
  int pad = cnt * 8 - total_ext_bits;
  if (pad) bw.put(0, pad);
}

void fill_raw_data_block(BitWr &bw, int payload_bits) {
  while (payload_bits >= 7) {
    payload_bits -= 7;
    int esc_count = -1;
    if (payload_bits >= 15 * 8) {
      payload_bits -= 8;
      esc_count = 0;
    }
    int cnt = payload_bits >> 3;
    if (cnt > 269) cnt = 269;
    if (cnt >= 15) esc_count = cnt - 15 + 1;
    bw.put(6, 3);
    if (esc_count >= 0) {
      bw.put(15, 4);
      bw.put(uint32_t(esc_count), 8);
    } else {
      bw.put(uint32_t(cnt), 4);
    }
    int cnt_bits = cnt * 8 < payload_bits ? cnt * 8 : payload_bits;
    if (cnt_bits >= 4) {
      bw.put(0, 4);
      int wb = cnt_bits - 8;
      bw.put(0, 4);
      while (wb >= 8) {
        bw.put(0, 8);
        wb -= 8;
      }
    }
    payload_bits -= cnt_bits;
  }
}

}  // namespace

extern "C" {

int dabplus_pack_batch(
    int S, int nau, int ch, int max_sfb, int nb,
    const int32_t *sfb_off,      /* [>= max_sfb+1] */
    const int32_t *wseq,         /* [S,nau] window sequences or NULL (LONG) */
    const int32_t *sfb_off_s,    /* [nsfb_s+1] short sfb offsets or NULL */
    const int32_t *shortp,       /* [2]: nsfb_s, max_sfb_s (or NULL) */
    const int32_t *q,            /* [S,nau,ch,960] */
    const int32_t *gains,        /* [S,nau,ch,nb] */
    const int32_t *books,        /* [S,nau,ch,nb] */
    const uint8_t *ms_used,      /* [S,nau,nb] or NULL */
    const uint8_t *tns_en,       /* [S,nau,ch] or NULL */
    const int32_t *tns_order,    /* [S,nau,ch] */
    const int32_t *tns_idx,      /* [S,nau,ch,12] */
    int tns_length_code,
    const int32_t *tns_len,      /* [S,nau,ch] per-AU filter-1 length in
                                    bands (merged TNS spans the whole
                                    range) or NULL -> tns_length_code */
    const uint8_t *tns_en_lo,    /* [S,nau,ch] or NULL */
    const int32_t *tns_order_lo, /* [S,nau,ch] or NULL */
    const int32_t *tns_idx_lo,   /* [S,nau,ch,12] or NULL */
    int tns_length_code_lo,
    const int32_t *sbr_env,      /* [S,nau,env_ch,n_lo] or NULL */
    const int32_t *sbr_env2,     /* [S,nau,env_ch,2,n_lo] or NULL */
    const uint8_t *sbr_trans,    /* [S,nau,env_ch] or NULL */
    const int32_t *sbr_nq,       /* [S,nau,env_ch] noise floors or NULL */
    const int32_t *sbr_invf,     /* [S,nau,env_ch,n_q] invf modes or NULL */
    const uint8_t *sbr_addh,     /* [S,nau,env_ch,n_hi] or NULL */
    const int32_t *sbr_tgrid,    /* [S,nau,env_ch] grid menu idx or NULL */
    const uint8_t *sbr_cpl,      /* [S,nau] stereo-SBR coupling flags or
                                    NULL (apply_coupling) */
    const int32_t *ps_iid,       /* [S,nau,PS_NENV,20] or NULL */
    const int32_t *ps_iid_fine,  /* [S,nau,PS_NENV,20] or NULL */
    const uint8_t *ps_fine,      /* [S,nau] or NULL */
    const int32_t *ps_icc,       /* [S,nau,PS_NENV,20] or NULL */
    const uint8_t *pads,         /* [S,nau,pad_stride] or NULL */
    const int32_t *pad_len,     /* [S,nau] */
    int pad_stride,
    const int32_t *sbrp,         /* [9]: see write_sbr_payload + noise_val */
    const int32_t *sfp,          /* [6]: subch, dac_rate, sbr, ps, ch_mode, add_rs */
    uint8_t *out, int out_stride, int32_t *out_len)
{
  const int subch = sfp[0], dac_rate = sfp[1], has_sbr = sfp[2];
  const int ps = sfp[3], ch_mode = sfp[4], add_rs = sfp[5];
  const int nsfb_s = shortp ? shortp[0] : 0;
  const int max_sfb_s = shortp ? shortp[1] : 0;
  const int total = subch * 110;
  int hdr_bits = 16 + 8 + (nau - 1) * 12;
  if (dac_rate == 0 || has_sbr == 0) hdr_bits += 4;
  const int header_bytes = hdr_bits / 8;
  int bad = 0;

#pragma omp parallel for schedule(static)
  for (int s = 0; s < S; ++s) {
    uint8_t sf_buf[24 * 110];
    memset(sf_buf, 0, sizeof(sf_buf));
    BitWr hdr(sf_buf);
    hdr.put(0, 16);
    hdr.put(0, 1);
    hdr.put(uint32_t(dac_rate), 1);
    hdr.put(uint32_t(has_sbr), 1);
    hdr.put(uint32_t(ch_mode), 1);
    hdr.put(uint32_t(ps), 1);
    hdr.put(0, 3);
    for (int i = 0; i < nau - 1; ++i) hdr.put(0, 12);
    if (dac_rate == 0 || has_sbr == 0) hdr.put(0, 4);

    int pos = header_bytes;
    int au_start[8];
    for (int a = 0; a < nau; ++a) {
      uint8_t au_buf[8192];
      memset(au_buf, 0, sizeof(au_buf));
      BitWr bw(au_buf);
      const int32_t *Q = q + ((size_t(s) * nau + a) * ch) * 960;
      const int32_t *G = gains + ((size_t(s) * nau + a) * ch) * nb;
      const int32_t *B = books + ((size_t(s) * nau + a) * ch) * nb;
      const uint8_t *te = tns_en ? tns_en + (size_t(s) * nau + a) * ch : nullptr;
      const int32_t *to = tns_order + (size_t(s) * nau + a) * ch;
      const int32_t *ti = tns_idx + ((size_t(s) * nau + a) * ch) * 12;
      const uint8_t *tel = tns_en_lo
          ? tns_en_lo + (size_t(s) * nau + a) * ch : nullptr;
      const int32_t *tol = tns_order_lo
          ? tns_order_lo + (size_t(s) * nau + a) * ch : nullptr;
      const int32_t *til = tns_idx_lo
          ? tns_idx_lo + ((size_t(s) * nau + a) * ch) * 12 : nullptr;
      const int wq = wseq ? wseq[size_t(s) * nau + a] : 0;
      const int32_t *tl = tns_len ? tns_len + (size_t(s) * nau + a) * ch
                                  : nullptr;
      if (ch == 1) {
        bw.put(0, 3);
        bw.put(0, 4);
        write_ics(bw, Q, G, B, max_sfb, sfb_off, true,
                  te && te[0], to ? to[0] : 0, ti,
                  tl ? tl[0] : tns_length_code,
                  wq, sfb_off_s, nsfb_s, max_sfb_s,
                  (tel && tel[0] && tol) ? tol[0] : 0, til,
                  tns_length_code_lo);
      } else {
        const uint8_t *MS = ms_used ? ms_used + (size_t(s) * nau + a) * nb
                                    : nullptr;
        bw.put(1, 3);
        bw.put(0, 4);
        bw.put(1, 1);
        write_ics_info(bw, max_sfb, wq, max_sfb_s);
        bw.put(1, 2);
        if (wq == 2) {
          for (int g = 0; g < 2; ++g)
            for (int b = 0; b < max_sfb_s; ++b)
              bw.put(MS && MS[g * nsfb_s + b] ? 1 : 0, 1);
        } else {
          for (int b = 0; b < max_sfb; ++b) bw.put(MS && MS[b] ? 1 : 0, 1);
        }
        for (int c = 0; c < 2; ++c)
          write_ics(bw, Q + c * 960, G + c * nb, B + c * nb, max_sfb, sfb_off,
                    false, te && te[c], to ? to[c] : 0, ti + c * 12,
                    tl ? tl[c] : tns_length_code,
                    wq, sfb_off_s, nsfb_s, max_sfb_s,
                    (tel && tel[c] && tol) ? tol[c] : 0,
                    til ? til + c * 12 : nullptr, tns_length_code_lo);
      }
      if (pads && pad_len) {
        int pl = pad_len[size_t(s) * nau + a];
        if (pl > 0)
          write_dse(bw, pads + (size_t(s) * nau + a) * pad_stride, pl);
      }
      if (sbr_env) {
        const int env_ch = sbrp[9];
        const int n_hi = sbrp[10];
        const int n_q = sbrp[6];
        const int32_t *ev = sbr_env + ((size_t(s) * nau + a) * env_ch) * n_hi;
        const int32_t *ev2 = sbr_env2
            ? sbr_env2 + (((size_t(s) * nau + a) * env_ch) * 2) * n_hi : nullptr;
        const uint8_t *tr = sbr_trans
            ? sbr_trans + (size_t(s) * nau + a) * env_ch : nullptr;
        const int32_t *el[2], *er[2];
        int nl = 1, nr = 1;
        if (tr && tr[0] && ev2) {
          el[0] = ev2; el[1] = ev2 + n_hi; nl = 2;
        } else {
          el[0] = ev;
        }
        if (env_ch == 2) {
          if (tr && tr[1] && ev2) {
            er[0] = ev2 + 2 * n_hi; er[1] = ev2 + 3 * n_hi; nr = 2;
          } else {
            er[0] = ev + n_hi;
          }
        }
        const int32_t *nq = sbr_nq
            ? sbr_nq + ((size_t(s) * nau + a) * env_ch) * n_q : nullptr;
        const int32_t *ivf = sbr_invf
            ? sbr_invf + ((size_t(s) * nau + a) * env_ch) * n_q : nullptr;
        const uint8_t *ah = sbr_addh
            ? sbr_addh + ((size_t(s) * nau + a) * env_ch) * n_hi : nullptr;
        const int fine = (ps_fine && ps_fine[size_t(s) * nau + a]) ? 1 : 0;
        const int32_t *iid_sel = ps_iid
            ? (fine && ps_iid_fine
                   ? ps_iid_fine + (size_t(s) * nau + a) * size_t(sbrp[11]) * PS_NBANDS
                   : ps_iid + (size_t(s) * nau + a) * size_t(sbrp[11]) * PS_NBANDS)
            : nullptr;
        const int32_t *tg = sbr_tgrid
            ? sbr_tgrid + (size_t(s) * nau + a) * env_ch : nullptr;
        const int gl = (nl == 2 && tg) ? tg[0] : -1;
        const int gr = (nr == 2 && tg && env_ch == 2) ? tg[1] : -1;
        /* header on AU 0 only (the reference sends it once per
         * superframe); matches sbr.payload_bits on the device */
        const bool cpl = sbr_cpl && env_ch == 2
            && sbr_cpl[size_t(s) * nau + a];
        write_sbr_payload(bw, el, nl, env_ch == 2 ? er : nullptr, nr,
                          nq, sbrp, a == 0,
                          iid_sel,
                          ps_icc ? ps_icc + (size_t(s) * nau + a) * size_t(sbrp[11]) * PS_NBANDS
                                 : nullptr,
                          ivf,
                          (ivf && env_ch == 2) ? ivf + n_q : nullptr,
                          (nq && env_ch == 2) ? nq + n_q : nullptr,
                          ah,
                          (ah && env_ch == 2) ? ah + n_hi : nullptr, n_hi,
                          fine, gl, gr, cpl);
      }

      au_start[a] = pos;
      if (a == nau - 1) {
        int offset_end = total * 8 - 2 * 8 - 3;
        int fill = offset_end - (pos * 8 + int(bw.bitpos));
        if (fill < 0) { bad = 1; fill = 0; }
        fill_raw_data_block(bw, fill);
      }
      bw.put(7, 3); /* ID_END */
      if (bw.bitpos % 8) bw.put(0, int(8 - bw.bitpos % 8));
      int au_bytes = int(bw.bitpos / 8);
      if (pos + au_bytes + 2 > total) { bad = 1; break; }
      memcpy(sf_buf + pos, au_buf, size_t(au_bytes));
      uint16_t crc = uint16_t(crc16_ccitt(au_buf, au_bytes) ^ 0xFFFF);
      sf_buf[pos + au_bytes] = uint8_t(crc >> 8);
      sf_buf[pos + au_bytes + 1] = uint8_t(crc & 0xFF);
      pos += au_bytes + 2;
    }
    if (pos != total) bad = 1;

    /* au_start back-patch at bit 24, 12-bit fields */
    int bitpos = 24;
    for (int i = 1; i < nau; ++i) {
      int v = au_start[i];
      int byte = bitpos >> 3, off = bitpos & 7;
      uint32_t cur = (uint32_t(sf_buf[byte]) << 16) |
                     (uint32_t(sf_buf[byte + 1]) << 8) | sf_buf[byte + 2];
      int shift = 24 - off - 12;
      uint32_t mask = 0xFFFu << shift;
      cur = (cur & ~mask) | (uint32_t(v) << shift);
      sf_buf[byte] = uint8_t(cur >> 16);
      sf_buf[byte + 1] = uint8_t(cur >> 8);
      sf_buf[byte + 2] = uint8_t(cur);
      bitpos += 12;
    }
    uint16_t fc = firecode(sf_buf + 2, 9);
    sf_buf[0] = uint8_t(fc >> 8);
    sf_buf[1] = uint8_t(fc & 0xFF);

    uint8_t *dst = out + size_t(s) * out_stride;
    if (add_rs) {
      /* column interleave: byte p at (col p/subch, row p%subch); each row
       * (subch rows of 110 bytes) is one codeword with 10 parity bytes */
      const RsDab &rs = rs_dab();
      for (int row = 0; row < subch; ++row) {
        uint8_t data[110], par[10];
        for (int col = 0; col < 110; ++col)
          data[col] = sf_buf[col * subch + row];
        rs.encode(data, 110, par);
        for (int col = 0; col < 110; ++col)
          dst[col * subch + row] = data[col];
        for (int p = 0; p < 10; ++p)
          dst[(110 + p) * subch + row] = par[p];
      }
      out_len[s] = subch * 120;
    } else {
      memcpy(dst, sf_buf, size_t(total));
      out_len[s] = total;
    }
  }
  return bad;
}

}  /* extern "C" */
