/* Native batch MP2 frame packer: the host half of the stream-batched DAB
 * encoder.  Packs S streams' device outputs (allocations, scalefactors,
 * quantized codewords) into MP2 frames with header CRC16 and DAB ScF-CRC8
 * placeholders, matching host/mp2pack.py byte-for-byte (equivalence-tested).
 *
 * The reference keeps this path in C (libtoolame-dab/bitstream.c,
 * encode_new.c:356-598, crc.c); at fleet batch sizes the Python packer is
 * the wall-clock bottleneck, so this is the production path and Python is
 * the validation implementation.
 *
 * Build: see host/native.py (g++ -O2 -fPIC -shared -fopenmp, at first use).
 * Pure C ABI via ctypes.
 */
#include <cstdint>
#include <cstring>

#include "mp2_tables.h"

namespace {

constexpr int SBLIMIT = 32;
constexpr uint16_t CRC16_POLY = 0x8005;
constexpr uint8_t CRC8_POLY = 0x1D;
static const int SCF_RANGES[5] = {0, 4, 8, 16, 30};

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

uint16_t upd16(uint32_t data, int length, uint16_t crc) {
  for (int i = length - 1; i >= 0; --i) {
    bool carry = crc & 0x8000;
    crc = uint16_t(crc << 1);
    if (!carry != !((data >> i) & 1)) crc ^= CRC16_POLY;
  }
  return crc;
}

uint8_t upd8(uint32_t data, int length, uint8_t crc) {
  for (int i = length - 1; i >= 0; --i) {
    bool carry = crc & 0x80;
    crc = uint8_t(crc << 1);
    if (!carry != !((data >> i) & 1)) crc ^= CRC8_POLY;
  }
  return crc;
}

}  // namespace

extern "C" {

/* Per-stream config columns (cfg[s*9 + k]):
 * 0 version, 1 bitrate_idx, 2 sfreq_idx, 3 nch, 4 sblimit, 5 tablenum,
 * 6 dab_ext, 7 dab_length, 8 lg_frame */
int mp2_pack_batch(
    int S,
    const uint8_t *bit_alloc,   /* [S,2,32] */
    const uint8_t *scfsi,       /* [S,2,32] */
    const uint8_t *sf,          /* [S,2,3,32] */
    const uint32_t *sbband,     /* [S,2,3,12,32] */
    const int32_t *mode,        /* [S] */
    const int32_t *mode_ext,    /* [S] */
    const int32_t *jsbound,     /* [S] */
    const int32_t *adb_left,    /* [S] */
    const int32_t *extra,       /* [S] padding slots (or NULL) */
    const int32_t *cfg,         /* [S,9] */
    const uint8_t *xpad,        /* [S, xpad_stride] or NULL */
    const int32_t *xpad_len,    /* [S] used length (or NULL) */
    int xpad_stride,
    uint8_t *out,               /* [S, out_stride] zero-initialised */
    int out_stride,
    int32_t *out_len,           /* [S] */
    int32_t *scf_off,           /* [S] */
    uint8_t *scf_vals,          /* [S, 4] */
    const uint8_t *payload,     /* [S, payload_stride] device-packed sample
                                   section (mp2/binpack.py) or NULL */
    const int32_t *payload_bits,/* [S] used bit counts (with payload) */
    int payload_stride)
{
  int bad = 0;
#pragma omp parallel for schedule(static)
  for (int s = 0; s < S; ++s) {
    const int32_t *C = cfg + s * 9;
    const int version = C[0], br_idx = C[1], sfreq = C[2], nch = C[3];
    const int sblimit = C[4], tablenum = C[5], dab_ext = C[6];
    const int dab_length = C[7], lg_frame = C[8];
    const int pad = extra ? extra[s] : 0;
    const int jsb = jsbound[s];
    const uint8_t *BA = bit_alloc + s * 64;       /* [2][32] */
    const uint8_t *SC = scfsi + s * 64;
    const uint8_t *SF = sf + s * 192;             /* [2][3][32] */
    const uint32_t *SB = sbband + s * 2 * 3 * 12 * 32;
    const int *line_row = T_LINE[tablenum];

    BitWr bw(out + size_t(s) * out_stride);
    bw.put(0xFFF, 12);
    bw.put(version, 1);
    bw.put(4 - 2, 2);
    bw.put(0, 1); /* error protection on */
    bw.put(br_idx, 4);
    bw.put(sfreq, 2);
    bw.put(pad, 1);
    bw.put(0, 1);
    bw.put(mode[s], 2);
    bw.put(mode_ext[s], 2);
    bw.put(0, 1);
    bw.put(0, 1);
    bw.put(0, 2);

    /* header CRC (crc.c:12-41) */
    uint16_t crc = 0xFFFF;
    crc = upd16(br_idx, 4, crc);
    crc = upd16(sfreq, 2, crc);
    crc = upd16(pad, 1, crc);
    crc = upd16(0, 1, crc);
    crc = upd16(mode[s], 2, crc);
    crc = upd16(mode_ext[s], 2, crc);
    crc = upd16(0, 1, crc);
    crc = upd16(0, 1, crc);
    crc = upd16(0, 2, crc);
    for (int sb = 0; sb < sblimit; ++sb) {
      int nbal = line_row[sb] < 0 ? 0 : T_NBAL[line_row[sb]];
      for (int ch = 0; ch < (sb < jsb ? nch : 1); ++ch)
        crc = upd16(BA[ch * 32 + sb], nbal, crc);
    }
    for (int sb = 0; sb < sblimit; ++sb)
      for (int ch = 0; ch < nch; ++ch)
        if (BA[ch * 32 + sb]) crc = upd16(SC[ch * 32 + sb], 2, crc);
    bw.put(crc, 16);

    /* bit allocation */
    for (int sb = 0; sb < sblimit; ++sb) {
      int nbal = line_row[sb] < 0 ? 0 : T_NBAL[line_row[sb]];
      for (int ch = 0; ch < (sb < jsb ? nch : 1); ++ch)
        bw.put(BA[ch * 32 + sb], nbal);
    }
    /* scfsi + scalefactors */
    for (int sb = 0; sb < sblimit; ++sb)
      for (int ch = 0; ch < nch; ++ch)
        if (BA[ch * 32 + sb]) bw.put(SC[ch * 32 + sb], 2);
    for (int sb = 0; sb < sblimit; ++sb)
      for (int ch = 0; ch < nch; ++ch) {
        if (!BA[ch * 32 + sb]) continue;
        int code = SC[ch * 32 + sb];
        const uint8_t *sfc = SF + ch * 96;
        if (code == 0) {
          for (int gr = 0; gr < 3; ++gr) bw.put(sfc[gr * 32 + sb], 6);
        } else if (code == 1 || code == 3) {
          bw.put(sfc[0 * 32 + sb], 6);
          bw.put(sfc[2 * 32 + sb], 6);
        } else {
          bw.put(sfc[0 * 32 + sb], 6);
        }
      }

    /* samples (write_samples_new, encode_new.c:560-598).  With a device-
     * packed payload, splice its bits at the current position: the output
     * buffer is zero-initialised and only bits < bitpos are set, so a
     * shifted OR is exact. */
    if (payload) {
      const uint8_t *p = payload + size_t(s) * payload_stride;
      const int nbits = payload_bits[s];
      uint8_t *dst = out + size_t(s) * out_stride;
      const int sh = int(bw.bitpos & 7);
      const size_t byte = bw.bitpos >> 3;
      const int full = nbits >> 3;
      if (sh == 0) {
        for (int k = 0; k < full; ++k) dst[byte + k] |= p[k];
      } else {
        for (int k = 0; k < full; ++k) {
          dst[byte + k] |= uint8_t(p[k] >> sh);
          dst[byte + k + 1] |= uint8_t(p[k] << (8 - sh));
        }
      }
      const int rem = nbits & 7;
      if (rem) {
        uint8_t last = uint8_t(p[full] & uint8_t(0xFFu << (8 - rem)));
        dst[byte + full] |= uint8_t(last >> sh);
        if (sh + rem > 8) dst[byte + full + 1] |= uint8_t(last << (8 - sh));
      }
      bw.bitpos += size_t(nbits);
    } else
    for (int gr = 0; gr < 3; ++gr)
      for (int j = 0; j < 12; j += 3)
        for (int sb = 0; sb < sblimit; ++sb)
          for (int ch = 0; ch < (sb < jsb ? nch : 1); ++ch) {
            int ba = BA[ch * 32 + sb];
            if (!ba) continue;
            int sidx = T_STEP_INDEX[line_row[sb]][ba];
            int nbits = T_BITS[sidx];
            const uint32_t *g = SB + ((ch * 3 + gr) * 12) * 32;
            if (T_GROUP[sidx] == 3) {
              for (int x = 0; x < 3; ++x) bw.put(g[(j + x) * 32 + sb], nbits);
            } else {
              uint32_t y = uint32_t(T_STEPS[sidx]);
              uint32_t v = g[j * 32 + sb] + g[(j + 1) * 32 + sb] * y +
                           g[(j + 2) * 32 + sb] * y * y;
              bw.put(v, nbits);
            }
          }

    /* zero-stuff leftover audio bits */
    int left = adb_left[s];
    if (left < 0) { bad = 1; continue; }
    for (int k = 0; k < left / 8; ++k) bw.put(0, 8);
    if (left % 8) bw.put(0, left % 8);

    /* X-PAD */
    int xl = xpad_len ? xpad_len[s] : 0;
    const uint8_t *xp = xpad ? xpad + size_t(s) * xpad_stride : nullptr;
    if (xl)
      for (int k = dab_length - xl; k < dab_length - 2; ++k) bw.put(xp[k], 8);

    /* ScF-CRC placeholders (own values; patched into the PREVIOUS frame) */
    for (int k = dab_ext - 1, vi = 0; k >= 0; --k, ++vi) {
      int first = SCF_RANGES[k];
      int last = SCF_RANGES[k + 1] < sblimit ? SCF_RANGES[k + 1] : sblimit;
      uint8_t c8 = 0;
      for (int sb = first; sb < last; ++sb)
        for (int ch = 0; ch < nch; ++ch) {
          if (!BA[ch * 32 + sb]) continue;
          int code = SC[ch * 32 + sb];
          const uint8_t *sfc = SF + ch * 96;
          if (code == 0) {
            for (int gr = 0; gr < 3; ++gr)
              c8 = upd8(sfc[gr * 32 + sb] >> 3, 3, c8);
          } else if (code == 1 || code == 3) {
            c8 = upd8(sfc[0 * 32 + sb] >> 3, 3, c8);
            c8 = upd8(sfc[2 * 32 + sb] >> 3, 3, c8);
          } else {
            c8 = upd8(sfc[0 * 32 + sb] >> 3, 3, c8);
          }
        }
      scf_vals[s * 4 + vi] = c8;
      bw.put(c8, 8);
    }

    /* F-PAD */
    if (xl) {
      bw.put(xp[dab_length - 2], 8);
      bw.put(xp[dab_length - 1], 8);
    } else {
      bw.put(0, 16);
    }

    int nbytes = int((bw.bitpos + 7) / 8);
    if (nbytes != lg_frame + pad) { bad = 1; continue; }
    out_len[s] = nbytes;
    scf_off[s] = nbytes - 2 - dab_ext;
  }
  return bad;
}

}  /* extern "C" */
