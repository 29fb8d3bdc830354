// JPEG decode/encode and PNG unfiltering for the serving wire, on the host.
//
// The port's counterpart of what Pillow (built on libjpeg-turbo) does for the
// JAX package's wire (core/imaging.py there): the decoder follows
// libjpeg-turbo's default decompression path, so its pixels equal Pillow's bit
// for bit:
//   - Huffman entropy decoding of baseline (SOF0) and 8-bit extended
//     sequential (SOF1) scans, interleaved or not, with restart intervals;
//   - progressive (SOF2) Huffman scans into the whole image's coefficients:
//     jdphuff.c's DC first and refinement scans, AC first scans with their
//     EOB runs and AC refinement scans with their correction bits (ITU T.81
//     G.1.2), per-scan Huffman tables, restarts that also end an EOB run. The
//     pixels are made after the last scan, as for a sequential file. Where
//     libjpeg-turbo would block-smooth the image (jdcoefct.c smoothing_ok: a
//     script that leaves one of the first ten zigzag coefficients short of
//     Al = 0), the decode raises instead;
//   - jpeg_idct_islow (jidctint.c) with its post-IDCT range-limit table;
//   - fancy upsampling (jdsample.c: h2v1, h1v2, h2v2; box replication where
//     libjpeg-turbo takes it, a component no wider than 2 samples), the
//     context rows clamped to the component's real rows; int_upsample's box
//     replication for every other whole-number ratio (3x1, 4x1, 4x2, ...);
//   - the colour space libjpeg-turbo reads from the markers
//     (jdapimin.c default_decompress_parms): YCbCr through the fixed-point
//     ycc_rgb_convert (jdcolor.c), RGB-coded (Adobe transform 0, or ids
//     'R' 'G' 'B' without JFIF) passed through; 4 components as CMYK, or as
//     YCCK (Adobe transform other than 0) through ycck_cmyk_convert, then
//     as Pillow reads them: inverted (its "CMYK;I", Adobe's polarity) and
//     turned to RGB by convert("RGB")'s cmyk2rgb (Convert.c).
// The encoder follows Pillow's save(format="JPEG", quality=q) defaults: a JFIF
// APP0, the Annex K tables scaled by jpeg_quality_scaling (force_baseline),
// rgb_ycc_convert (jccolor.c), the downsamplers of jcsample.c with their edge
// expansion, jpeg_fdct_islow (jfdctint.c), jcdctmgr.c's reciprocal
// quantization, dummy edge blocks as jccoefct.c makes them, and the standard
// Huffman tables, no restart markers.
//
// A plain C interface, loaded with ctypes by core/codec.py. Every entry point
// returns a negative value and writes a message into `err` on failure.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Pillow's DecompressionBombError limit (2 * Image.MAX_IMAGE_PIXELS), checked
// before anything of the image is allocated (core/codec.py holds PNG to it).
constexpr int64_t kMaxPixels = 178956970;

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // corrupt data may run k past 63: libjpeg's extra entries
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Fixed-point constants (CONST_BITS = 13) of the islow DCTs
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range-limit table of jdmaster.c, indexed by (x & 1023) where x
// is the descaled output before the +128 level shift.
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = uint8_t(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
};
const IdctLimit kIdctLimit;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jpeg_idct_islow: dequantized 8x8 block -> samples at out (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    auto dq = [&](int r) { return int64_t(in[8 * r]) * qp[8 * r]; };
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = int(descale(tmp10 + tmp3, n));
    ws[8 * 7 + c] = int(descale(tmp10 - tmp3, n));
    ws[8 * 1 + c] = int(descale(tmp11 + tmp2, n));
    ws[8 * 6 + c] = int(descale(tmp11 - tmp2, n));
    ws[8 * 2 + c] = int(descale(tmp12 + tmp1, n));
    ws[8 * 5 + c] = int(descale(tmp12 - tmp1, n));
    ws[8 * 3 + c] = int(descale(tmp13 + tmp0, n));
    ws[8 * 4 + c] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    auto lim = [&](int64_t v) { return kIdctLimit.t[int(descale(v, n)) & 1023]; };
    o[0] = lim(tmp10 + tmp3);
    o[7] = lim(tmp10 - tmp3);
    o[1] = lim(tmp11 + tmp2);
    o[6] = lim(tmp11 - tmp2);
    o[2] = lim(tmp12 + tmp1);
    o[5] = lim(tmp12 - tmp1);
    o[3] = lim(tmp13 + tmp0);
    o[4] = lim(tmp13 - tmp0);
  }
}

// jpeg_fdct_islow on level-shifted samples (in place, results scaled by 8).
void fdct_islow(int* d) {
  for (int r = 0; r < 8; r++) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = int(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, n));
    p[5] = int(descale(tmp5 + z2 + z4, n));
    p[3] = int(descale(tmp6 + z2 + z3, n));
    p[1] = int(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; c++) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits + kPass1Bits;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[48] = int(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, n));
    p[40] = int(descale(tmp5 + z2 + z4, n));
    p[24] = int(descale(tmp6 + z2 + z3, n));
    p[8] = int(descale(tmp7 + z1 + z4, n));
  }
}

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  // decoding (jdhuff.c's maxcode/valoffset) and a 9-bit lookahead
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // (length << 8) | value, 0 when the code is longer
  // encoding: code and length per symbol
  uint16_t ehufco[256];
  uint8_t ehufsi[256];

  void build() {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) {
        if (p >= 256) throw CodecError("corrupt JPEG: bad Huffman table");
        huffsize[p++] = l;
      }
    huffsize[p] = 0;
    int n = p, code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) throw CodecError("corrupt JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    memset(look, 0, sizeof(look));
    for (int i = 0; i < n; i++) {
      int l = huffsize[i];
      if (l > 9) continue;
      int lo = huffcode[i] << (9 - l), cnt = 1 << (9 - l);
      for (int k = 0; k < cnt; k++) look[lo + k] = uint16_t((l << 8) | vals[i]);
    }
    memset(ehufsi, 0, sizeof(ehufsi));
    for (int i = 0; i < n; i++) {
      ehufco[vals[i]] = uint16_t(huffcode[i]);
      ehufsi[vals[i]] = uint8_t(huffsize[i]);
    }
    defined = true;
  }
};

// The standard tables of jstdhuff.c (Annex K.3), with bits[0] unused.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffTable std_table(const uint8_t* bits, const uint8_t* vals, int n) {
  HuffTable t;
  memcpy(t.bits, bits, 17);
  memcpy(t.vals, vals, n);
  t.build();
  return t;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int bw = 0, bh = 0;       // blocks of the component (non-interleaved scan)
  int bw_pad = 0, bh_pad = 0;  // blocks covering whole MCUs
  int dw = 0, dh = 0;       // real samples (downsampled_width / height)
  std::vector<int16_t> coef;  // bh_pad * bw_pad blocks of 64
  uint16_t q[64];
  bool q_latched = false;
  int dc_pred = 0;
  // progressive: the successive-approximation bit each coefficient (zigzag
  // order) was last sent to, -1 before its first scan (libjpeg's coef_bits)
  int coef_bits[64];
};

// The entropy-coded bits of a scan. At a marker the data stops and zero bits
// are fed, as jdhuff.c's jpeg_fill_bit_buffer feeds them; a read that takes
// one of them sets `insufficient`, after which the scan leaves its blocks zero
// (uniform gray) until a restart marker resumes the data. The data ending
// without a marker sets hit_end: Pillow reports such a file as truncated.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int zbits = 0;  // the zero bits fed past a marker: the last zbits of acc
  bool at_marker = false;  // p is at a marker's first FF (or at the end)
  bool insufficient = false;
  bool hit_end = false;

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;
            hit_end = q >= end;
          }
        } else {
          b = *p++;
        }
      } else if (!at_marker) {
        at_marker = hit_end = true;
      }
      if (at_marker) zbits += 8;
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return int(acc >> (64 - n));
  }
  void skip(int n) {
    if (n > nbits - zbits) {
      insufficient = true;
      zbits = nbits - n;
    }
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    int look = peek(16) >> 7;
    int e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = peek(16);
    for (int l = 10; l <= 16; l++) {
      int c = code >> (16 - l);
      if (c <= t.maxcode[l]) {
        skip(l);
        return t.vals[(c + t.valoffset[l]) & 0xFF];
      }
    }
    // jdhuff.c: no code of up to 16 bits matches (garbage input): libjpeg
    // warns, drops the 17 bits it read and takes the symbol as 0
    peek(17);
    skip(17);
    return 0;
  }
  // From p to the next marker (stuffed FF 00 pairs and other bytes skipped):
  // its code, p at its last FF; -1 when the data ends first.
  int next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) p++;
      const uint8_t* q = p;
      while (q < end && *q == 0xFF) q++;
      if (q >= end) return -1;
      if (*q != 0x00) {
        p = q - 1;
        return *q;
      }
      p = q + 1;
    }
  }
  // The restart marker due before the next interval: jdhuff.c
  // process_restart with jdmarker.c read_restart_marker and
  // jpeg_resync_to_restart. The bits left are dropped; the expected marker
  // (or one too far off to tell) is stepped over and the data resumes; a
  // marker of the next two intervals or a non-restart marker is left where it
  // is, so the interval reads as empty (zero blocks).
  void restart(int expected) {
    acc = 0;
    nbits = zbits = 0;
    int m = next_marker();
    for (;;) {
      if (m < 0) {
        hit_end = true;
        at_marker = true;
        return;
      }
      int action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((expected + 1) & 7) || m == 0xD0 + ((expected + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((expected + 7) & 7) || m == 0xD0 + ((expected + 6) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        p += 2;
        at_marker = insufficient = false;
        return;
      }
      if (action == 3) {
        at_marker = true;
        return;
      }
      p += 2;
      m = next_marker();
    }
  }
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool sof_seen = false, jfif = false, adobe = false, progressive = false;
  int eobrun = 0;  // progressive AC scans: blocks left in the current EOB run
  int adobe_transform = -1;
  bool rgb = false;   // 3 components coded as RGB, not YCbCr
  bool ycck = false;  // 4 components coded as YCCK, not CMYK
  long exif_off = -1, exif_len = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) throw CodecError("truncated JPEG: a header ends early");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    while (pos < n && data[pos] != 0xFF) pos++;  // garbage before a marker
    while (pos < n && data[pos] == 0xFF) pos++;
    if (pos >= n) return -1;
    return data[pos++];
  }

  void unsupported_sof(int m) {
    switch (m) {
      case 0xC3: throw CodecError("unsupported JPEG: lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7:
        throw CodecError("unsupported JPEG: hierarchical (differential) JPEG");
      default: throw CodecError("unsupported JPEG: arithmetic-coded JPEG");
    }
  }

  void parse_sof(int len) {
    if (sof_seen) throw CodecError("corrupt JPEG: two frame headers");
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8) throw CodecError("unsupported JPEG: " + std::to_string(prec) + "-bit JPEG");
    if (height == 0) throw CodecError("unsupported JPEG: height defined by DNL");
    if (width == 0) throw CodecError("corrupt JPEG: zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw CodecError("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (len != 8 + 3 * ncomp) throw CodecError("corrupt JPEG: bad frame header length");
    for (int i = 0; i < ncomp; i++) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 || comp[i].tq > 3)
        throw CodecError("corrupt JPEG: bad component parameters");
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // a lone component is never subsampled
    for (int i = 0; i < ncomp; i++) {
      max_h = std::max(max_h, comp[i].h);
      max_v = std::max(max_v, comp[i].v);
    }
    for (int i = 0; i < ncomp; i++) {
      if (max_h % comp[i].h || max_v % comp[i].v)
        throw CodecError("unsupported JPEG: a fractional sampling ratio (component " +
                         std::to_string(i) + " sampled " + std::to_string(comp[i].h) + "x" +
                         std::to_string(comp[i].v) + " of " + std::to_string(max_h) + "x" +
                         std::to_string(max_v) + ")");
    }
    if (int64_t(width) * height > kMaxPixels)
      throw CodecError("unsupported JPEG: " + std::to_string(width) + "x" +
                       std::to_string(height) + " pixels exceed the decompression-bomb limit");
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = int((int64_t(width) * c.h + max_h - 1) / max_h);
      c.dh = int((int64_t(height) * c.v + max_v - 1) / max_v);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_pad = mcus_x * c.h;
      c.bh_pad = mcus_y * c.v;
      c.coef.assign(size_t(c.bw_pad) * c.bh_pad * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    sof_seen = true;
  }

  void parse_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) throw CodecError("corrupt JPEG: bad quantization table");
      for (int k = 0; k < 64; k++) qt[t][kNatural[k]] = uint16_t(prec ? u16() : u8());
      qt_defined[t] = true;
    }
  }

  void parse_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) throw CodecError("corrupt JPEG: bad Huffman table");
      HuffTable t;
      int total = 0;
      for (int l = 1; l <= 16; l++) total += (t.bits[l] = uint8_t(u8()));
      if (total > 256) throw CodecError("corrupt JPEG: bad Huffman table");
      for (int i = 0; i < total; i++) {
        t.vals[i] = uint8_t(u8());
        // jdhuff.c jpeg_make_d_derived_tbl: a DC symbol is a bit count, 0..15
        if (cls == 0 && t.vals[i] > 15) throw CodecError("corrupt JPEG: bad Huffman table");
      }
      t.build();
      (cls ? ac : dc)[id] = t;
    }
  }

  void parse_app(int m, int len) {
    size_t start = pos, end = pos + len - 2;
    if (m == 0xE0 && len >= 7 && memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xE1 && exif_off < 0 && len >= 8 && memcmp(data + pos, "Exif\0\0", 6) == 0) {
      exif_off = long(start + 6);
      exif_len = long(len - 8);
    }
    if (m == 0xEE && len >= 14 && memcmp(data + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  // jdapimin.c default_decompress_parms: the colour space of the file
  void check_colorspace() {
    if (ncomp == 3) {
      rgb = false;
      if (!jfif) {
        if (adobe) rgb = adobe_transform == 0;
        else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
      }
    } else if (ncomp == 4) {
      ycck = adobe && adobe_transform != 0;
    }
  }

  int16_t* block(Component& c, int bx, int by) {
    return c.coef.data() + (size_t(by) * c.bw_pad + bx) * 64;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t* blk = block(c, bx, by);
    const HuffTable& dct = dc[c.td];
    const HuffTable& act = ac[c.ta];
    int s = br.decode(dct);
    int diff = s ? extend(br.get(s), s) : 0;
    // jdhuff.c: the DC sum must not overflow an int
    if ((c.dc_pred >= 0 && diff > INT_MAX - c.dc_pred) ||
        (c.dc_pred < 0 && diff < INT_MIN - c.dc_pred))
      throw CodecError("corrupt JPEG: DC coefficient out of range");
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first: the DC difference, shifted left by Al
  void dc_first(BitReader& br, Component& c, int bx, int by, int al) {
    int s = br.decode(dc[c.td]);
    int diff = s ? extend(br.get(s), s) : 0;
    if ((c.dc_pred >= 0 && diff > INT_MAX - c.dc_pred) ||
        (c.dc_pred < 0 && diff < INT_MIN - c.dc_pred))
      throw CodecError("corrupt JPEG: DC coefficient out of range");
    c.dc_pred += diff;
    block(c, bx, by)[0] = int16_t(int(unsigned(c.dc_pred) << al));
  }

  // decode_mcu_DC_refine: one more bit of the DC, no Huffman code
  void dc_refine(BitReader& br, Component& c, int bx, int by, int al) {
    if (br.get(1)) block(c, bx, by)[0] |= int16_t(1 << al);
  }

  // decode_mcu_AC_first: band ss..se of one block, or one block of an EOB run
  void ac_first(BitReader& br, Component& c, int bx, int by, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    int16_t* blk = block(c, bx, by);
    const HuffTable& act = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(int(unsigned(extend(br.get(s), s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: a correction bit for each coefficient already
  // nonzero in the band, and the newly nonzero ones (+-1 << al) placed by
  // their zero runs
  void ac_refine(BitReader& br, Component& c, int bx, int by, int ss, int se, int al) {
    int16_t* blk = block(c, bx, by);
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0) *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      const HuffTable& act = ac[c.ta];
      for (; k <= se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a size other than 1 is libjpeg's warning only
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;  // the rest of the band is refined as part of the EOB run
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1+, ten saved coefficients):
  // whether libjpeg-turbo would block-smooth this progressive image
  bool smoothing_ok() const {
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.q_latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void decode_scan(int len) {
    if (!sof_seen) throw CodecError("corrupt JPEG: scan before frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) throw CodecError("corrupt JPEG: bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) throw CodecError("corrupt JPEG: scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) throw CodecError("corrupt JPEG: bad scan header");
      if (!c->q_latched) {
        if (!qt_defined[c->tq]) throw CodecError("corrupt JPEG: undefined quantization table");
        memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->q_latched = true;
      }
      c->dc_pred = 0;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    // which tables the scan reads (jdhuff.c / jdphuff.c start_pass)
    bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss > 0;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder's JERR_BAD_PROGRESSION
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad)
        throw CodecError("corrupt JPEG: bad progression parameters Ss=" + std::to_string(ss) +
                         " Se=" + std::to_string(se) + " Ah=" + std::to_string(ah) +
                         " Al=" + std::to_string(al));
      for (int i = 0; i < ns; i++)
        for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
    } else if (ss != 0 || se != 63 || a != 0) {
      throw CodecError("unsupported JPEG: spectral selection or successive approximation "
                       "in a sequential scan");
    }
    for (int i = 0; i < ns; i++)
      if ((need_dc && !dc[sc[i]->td].defined) || (need_ac && !ac[sc[i]->ta].defined))
        throw CodecError("corrupt JPEG: scan uses an undefined Huffman table");
    eobrun = 0;
    BitReader br{data + pos, data + n};
    int units_x, units_y;
    if (ns == 1) {
      units_x = sc[0]->bw;
      units_y = sc[0]->bh;
    } else {
      units_x = mcus_x;
      units_y = mcus_y;
    }
    long done = 0;
    int rst = 0;
    for (int uy = 0; uy < units_y; uy++) {
      for (int ux = 0; ux < units_x; ux++) {
        if (restart_interval && done > 0 && done % restart_interval == 0) {
          br.restart(rst);
          rst = (rst + 1) & 7;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
          eobrun = 0;
        }
        auto unit = [&](Component& c, int bx, int by) {
          if (!progressive) decode_block(br, c, bx, by);
          else if (ss == 0 && ah == 0) dc_first(br, c, bx, by, al);
          else if (ss == 0) dc_refine(br, c, bx, by, al);
          else if (ah == 0) ac_first(br, c, bx, by, ss, se, al);
          else ac_refine(br, c, bx, by, ss, se, al);
        };
        if (br.insufficient) {
          // jdhuff.c / jdphuff.c decode_mcu: out of data, the MCU is left as
          // it is (zero in a sequential file)
        } else if (ns == 1) {
          unit(*sc[0], ux, uy);
        } else {
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) unit(c, ux * c.h + h, uy * c.v + v);
          }
        }
        done++;
      }
      // the data ran out: no zero-fed rows after that (Pillow stops too)
      if (br.hit_end) break;
    }
    if (br.hit_end) throw CodecError("truncated JPEG: the entropy-coded data ends early");
    // resume marker parsing where the entropy-coded data ends
    const uint8_t* p = br.p;
    while (p + 1 < data + n && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                                 !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      p++;
    pos = size_t(p - data);
  }

  // Markers up to the end of the image, decoding each scan; headers_only
  // stops at the first scan's header (the frame header and APPn precede it).
  void parse(bool headers_only = false) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw CodecError("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m < 0) {
        // no EOI after the scans: libjpeg accepts it in a sequential file,
        // whose pixels are made as its one scan is read; Pillow reports a
        // progressive file without it as truncated
        if (scanned && !progressive) break;
        throw CodecError(scanned ? "truncated JPEG: the progressive scans end without EOI"
                                 : "truncated JPEG: no scan");
      }
      if (m == 0xD9) break;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw CodecError("truncated JPEG: a marker segment ends early");
      switch (m) {
        case 0xC0: case 0xC1: parse_sof(len); break;
        case 0xC2:
          progressive = true;
          parse_sof(len);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF: unsupported_sof(m); break;
        case 0xCC: throw CodecError("unsupported JPEG: arithmetic-coded JPEG");
        case 0xC4: parse_dht(len); break;
        case 0xDB: parse_dqt(len); break;
        case 0xDD:
          if (len != 4) throw CodecError("corrupt JPEG: bad DRI");
          restart_interval = u16();
          break;
        case 0xDC: throw CodecError("unsupported JPEG: DNL marker");
        case 0xDA:
          if (!scanned) check_colorspace();
          if (headers_only) {
            if (!sof_seen) throw CodecError("corrupt JPEG: scan before frame header");
            return;
          }
          decode_scan(len);
          scanned = true;
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) parse_app(m, len);
          else pos += len - 2;
      }
    }
    if (!scanned) throw CodecError("truncated JPEG: no scan");
    if (progressive && smoothing_ok())
      throw CodecError("unsupported JPEG: progressive scans that leave low-frequency "
                       "coefficients short of their last bit (libjpeg block-smooths them)");
  }

  // IDCT of component c into a plane of bw_pad*8 x bh_pad*8 samples.
  std::vector<uint8_t> plane(const Component& c) const {
    int stride = c.bw_pad * 8;
    std::vector<uint8_t> out(size_t(stride) * c.bh_pad * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + (size_t(by) * c.bw_pad + bx) * 64, c.q,
                   out.data() + size_t(by) * 8 * stride + bx * 8, stride);
    return out;
  }

  // The component upsampled to (at least) width x height, as jdsample.c does
  // with do_fancy_upsampling; row stride `width`.
  std::vector<uint8_t> upsampled(const Component& c) const {
    std::vector<uint8_t> src = plane(c);
    int sstride = c.bw_pad * 8;
    int rh = max_h / c.h, rv = max_v / c.v;
    std::vector<uint8_t> out(size_t(width) * height);
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return src.data() + size_t(r) * sstride;
    };
    std::vector<uint8_t> line(size_t(c.dw) * 2 + 2);
    std::vector<int> cs(c.dw);
    const int dw = c.dw;
    for (int y = 0; y < height; y++) {
      uint8_t* o = out.data() + size_t(y) * width;
      if (rh > 2 || rv > 2) {  // int_upsample: each sample replicated rh x rv
        const uint8_t* in = src.data() + size_t(y / rv) * sstride;
        for (int x = 0; x < width; x++) o[x] = in[x / rh];
      } else if (rh == 1 && rv == 1) {
        memcpy(o, row(y), width);
      } else if (rh == 2 && rv == 1) {
        const uint8_t* in = row(y);
        if (dw > 2) {
          line[0] = in[0];
          line[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
          for (int k = 1; k < dw - 1; k++) {
            int v3 = in[k] * 3;
            line[2 * k] = uint8_t((v3 + in[k - 1] + 1) >> 2);
            line[2 * k + 1] = uint8_t((v3 + in[k + 1] + 2) >> 2);
          }
          line[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          line[2 * dw - 1] = in[dw - 1];
        } else {
          for (int k = 0; k < dw; k++) line[2 * k] = line[2 * k + 1] = in[k];
        }
        memcpy(o, line.data(), width);
      } else if (rh == 1 && rv == 2) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {  // 2x2
        int r = y >> 1;
        if (dw > 2) {
          const uint8_t* in0 = row(r);
          const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
          for (int k = 0; k < dw; k++) cs[k] = in0[k] * 3 + in1[k];
          line[0] = uint8_t((cs[0] * 4 + 8) >> 4);
          line[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
          for (int k = 1; k < dw - 1; k++) {
            line[2 * k] = uint8_t((cs[k] * 3 + cs[k - 1] + 8) >> 4);
            line[2 * k + 1] = uint8_t((cs[k] * 3 + cs[k + 1] + 7) >> 4);
          }
          line[2 * dw - 2] = uint8_t((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
          line[2 * dw - 1] = uint8_t((cs[dw - 1] * 4 + 7) >> 4);
        } else {
          const uint8_t* in = src.data() + size_t(r) * sstride;  // box: no clamping needed
          for (int k = 0; k < dw; k++) line[2 * k] = line[2 * k + 1] = in[k];
        }
        memcpy(o, line.data(), width);
      }
    }
    return out;
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      std::vector<uint8_t> y = upsampled(comp[0]);
      memcpy(out, y.data(), size_t(width) * height);
      return;
    }
    std::vector<uint8_t> Y = upsampled(comp[0]), Cb = upsampled(comp[1]),
                         Cr = upsampled(comp[2]);
    size_t np = size_t(width) * height;
    if (rgb) {
      for (size_t i = 0; i < np; i++) {
        out[3 * i] = Y[i];
        out[3 * i + 1] = Cb[i];
        out[3 * i + 2] = Cr[i];
      }
      return;
    }
    // ycc_rgb_convert's tables (jdcolor.c: SCALEBITS 16)
    struct Tables {
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      Tables() {
        const int64_t half = int64_t(1) << 15;
        for (int i = 0; i < 256; i++) {
          int64_t x = i - 128;
          cr_r[i] = int((91881 * x + half) >> 16);
          cb_b[i] = int((116130 * x + half) >> 16);
          cr_g[i] = -46802 * x;
          cb_g[i] = -22554 * x + half;
        }
      }
    };
    static const Tables t;
    if (ncomp == 4) {
      std::vector<uint8_t> K = upsampled(comp[3]);
      // Pillow's MULDIV255 (ImagingUtils.h)
      auto muldiv255 = [](int a, int b) {
        int tmp = a * b + 128;
        return ((tmp >> 8) + tmp) >> 8;
      };
      for (size_t i = 0; i < np; i++) {
        int c = Y[i], m = Cb[i], yy = Cr[i];
        if (ycck) {  // ycck_cmyk_convert: CMY = 255 - the YCbCr triple's RGB
          int y = Y[i], cb = Cb[i], cr = Cr[i];
          c = clamp255(255 - (y + t.cr_r[cr]));
          m = clamp255(255 - (y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          yy = clamp255(255 - (y + t.cb_b[cb]));
        }
        // "CMYK;I" inverts every sample; cmyk2rgb then takes
        // nk - c * nk / 255 with nk = 255 - k
        int nk = K[i];
        out[3 * i] = clamp255(nk - muldiv255(255 - c, nk));
        out[3 * i + 1] = clamp255(nk - muldiv255(255 - m, nk));
        out[3 * i + 2] = clamp255(nk - muldiv255(255 - yy, nk));
      }
      return;
    }
    for (size_t i = 0; i < np; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp255(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

const uint8_t kStdLum[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                             58, 60, 55, 14, 13, 16, 24,  40,  57,  69,  56, 14, 17,
                             22, 29, 51, 87, 80, 62, 18,  22,  37,  56,  68, 109, 103,
                             77, 24, 35, 55, 64, 81, 104, 113, 92,  49,  64, 78, 87,
                             103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrom[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                               24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                               99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                               99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = uint16_t(t);
  }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: (reciprocal,
// correction, shift) so that the quantized value is
// ((|x| + corr) * recip) >> (16 + shift), with the sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = uint32_t((uint64_t(1) << r) / divisor);
  uint32_t fr = uint32_t((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

// Bits into a preallocated buffer, 0xFF bytes stuffed with 0x00.
struct BitWriter {
  uint8_t* out;
  size_t n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(uint8_t* o) : out(o) {}
  // size <= 27 (a Huffman code and its magnitude bits together)
  inline void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    if (nbits >= 32) drain();
  }
  void drain() {
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out[n++] = b;
      if (b == 0xFF) out[n++] = 0;
      nbits -= 8;
    }
  }
  void finish() {
    drain();
    if (nbits) put(0x7F, 8 - nbits);  // pad the last byte with ones
    drain();
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void emit_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals,
              int n) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(uint8_t(cls_id));
  for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
  for (int i = 0; i < n; i++) o.push_back(vals[i]);
}

inline int bit_length(int v) { return v ? 32 - __builtin_clz(unsigned(v)) : 0; }

// jchuff.c encode_one_block: the DC difference, then run/size symbols of the
// nonzero AC coefficients in zigzag order (ZRL for runs past 15, EOB after
// the last nonzero one unless it is the 63rd).
void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffTable& dct,
                  const HuffTable& act) {
  int temp = blk[0] - last_dc;
  last_dc = blk[0];
  int nbits = bit_length(temp < 0 ? -temp : temp);
  uint32_t bits = uint32_t(temp < 0 ? temp - 1 : temp) & ((1u << nbits) - 1);
  bw.put((uint32_t(dct.ehufco[nbits]) << nbits) | bits, dct.ehufsi[nbits] + nbits);
  uint64_t mask = 0;
  int16_t zz[64];
  for (int k = 1; k < 64; k++) {
    zz[k] = blk[kNatural[k]];
    mask |= uint64_t(zz[k] != 0) << k;
  }
  int last = 0;
  while (mask) {
    int k = __builtin_ctzll(mask);
    mask &= mask - 1;
    int r = k - last - 1;
    while (r > 15) {
      bw.put(act.ehufco[0xF0], act.ehufsi[0xF0]);
      r -= 16;
    }
    temp = zz[k];
    nbits = bit_length(temp < 0 ? -temp : temp);
    bits = uint32_t(temp < 0 ? temp - 1 : temp) & ((1u << nbits) - 1);
    int sym = (r << 4) + nbits;
    bw.put((uint32_t(act.ehufco[sym]) << nbits) | bits, act.ehufsi[sym] + nbits);
    last = k;
  }
  if (last != 63) bw.put(act.ehufco[0], act.ehufsi[0]);
}

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int nc, int quality, int hs,
                            int vs) {
  if (nc == 1) hs = vs = 1;
  const int max_h = hs, max_v = vs;
  uint16_t qtab[2][64];
  scaled_table(kStdLum, quality, qtab[0]);
  scaled_table(kStdChrom, quality, qtab[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint16_t(qtab[t][i] << 3));

  // rgb_ycc_convert (jccolor.c), or the gray samples themselves
  size_t np = size_t(W) * H;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < nc; c++) full[c].resize(np);
  if (nc == 1) {
    memcpy(full[0].data(), px, np);
  } else {
    const int64_t half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
    for (size_t i = 0; i < np; i++) {
      int64_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = uint8_t((19595 * r + 38470 * g + 7471 * b + half) >> 16);
      full[1][i] = uint8_t((-11059 * r - 21709 * g + 32768 * b + cbcr_off + half - 1) >> 16);
      full[2][i] = uint8_t((32768 * r - 27439 * g - 5329 * b + cbcr_off + half - 1) >> 16);
    }
  }

  const int mcus_x = (W + 8 * max_h - 1) / (8 * max_h);
  const int mcus_y = (H + 8 * max_v - 1) / (8 * max_v);
  const int Hp = (H + max_v - 1) / max_v * max_v;  // rows padded to a row group
  struct Comp {
    int h, v, bw, bh, stride, rows;
    std::vector<uint8_t> d;  // downsampled, edge-expanded samples
    std::vector<int16_t> q;  // quantized blocks, mcus * h x mcus * v
  } comp[3];
  for (int c = 0; c < nc; c++) {
    Comp& k = comp[c];
    k.h = c == 0 ? hs : 1;
    k.v = c == 0 ? vs : 1;
    int rh = max_h / k.h, rv = max_v / k.v;
    int dw = int((int64_t(W) * k.h + max_h - 1) / max_h);
    int dh = int((int64_t(H) * k.v + max_v - 1) / max_v);
    k.bw = (dw + 7) / 8;
    k.bh = (dh + 7) / 8;
    k.stride = k.bw * 8;
    k.rows = k.bh * 8;
    k.d.resize(size_t(k.stride) * k.rows);
    int produced = Hp * k.v / max_v;  // rows the downsampler writes
    const std::vector<uint8_t>& s = full[c];
    // the image padded by replication: column and row indices clamped
    std::vector<int> cx(size_t(k.stride) * rh);
    for (size_t x = 0; x < cx.size(); x++) cx[x] = int(std::min<size_t>(x, size_t(W) - 1));
    auto srow = [&](int y) { return s.data() + size_t(std::min(y, H - 1)) * W; };
    for (int y = 0; y < k.rows; y++) {
      uint8_t* o = k.d.data() + size_t(y) * k.stride;
      int yy = y < produced ? y : produced - 1;  // bottom of the last iMCU row
      if (rh == 1 && rv == 1) {
        const uint8_t* a = srow(yy);
        for (int x = 0; x < k.stride; x++) o[x] = a[cx[x]];
      } else if (rh == 2 && rv == 1) {
        const uint8_t* a = srow(yy);
        for (int x = 0; x < k.stride; x++)
          o[x] = uint8_t((a[cx[2 * x]] + a[cx[2 * x + 1]] + (x & 1)) >> 1);
      } else if (rh == 1 && rv == 2) {
        const uint8_t *a = srow(2 * yy), *b = srow(2 * yy + 1);
        for (int x = 0; x < k.stride; x++) o[x] = uint8_t((a[cx[x]] + b[cx[x]] + 1) / 2);
      } else {
        const uint8_t *a = srow(2 * yy), *b = srow(2 * yy + 1);
        for (int x = 0; x < k.stride; x++) {
          int i0 = cx[2 * x], i1 = cx[2 * x + 1];
          o[x] = uint8_t((a[i0] + a[i1] + b[i0] + b[i1] + ((x & 1) ? 2 : 1)) >> 2);
        }
      }
    }
    int bw_all = nc == 1 ? k.bw : mcus_x * k.h;
    int bh_all = nc == 1 ? k.bh : mcus_y * k.v;
    k.q.assign(size_t(bw_all) * bh_all * 64, 0);
    int t = c == 0 ? 0 : 1;
    int ws[64];
    for (int by = 0; by < k.bh; by++)
      for (int bx = 0; bx < k.bw; bx++) {
        for (int r = 0; r < 8; r++)
          for (int x = 0; x < 8; x++)
            ws[8 * r + x] = int(k.d[size_t(by * 8 + r) * k.stride + bx * 8 + x]) - 128;
        fdct_islow(ws);
        int16_t* qb = k.q.data() + (size_t(by) * bw_all + bx) * 64;
        for (int i = 0; i < 64; i++) {
          int temp = int16_t(ws[i]);
          const Divisor& dv = div[t][i];
          bool neg = temp < 0;
          uint32_t a = uint32_t(neg ? -temp : temp) & 0xFFFF;
          uint32_t prod = ((a + dv.corr) & 0xFFFF) * dv.recip;
          int val = int(uint16_t(prod >> (16 + dv.shift)));
          qb[i] = int16_t(neg ? -val : val);
        }
      }
    k.stride = bw_all;  // from here on: blocks per row of k.q
    k.rows = bh_all;
  }

  std::vector<uint8_t> o;
  o.reserve(size_t(W) * H / 4 + 1024);
  const uint8_t app0[18] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 1, 1, 0,
                            0x00, 0x01, 0x00, 0x01, 0, 0};
  o.push_back(0xFF);
  o.push_back(0xD8);
  o.insert(o.end(), app0, app0 + 18);
  for (int t = 0; t < (nc == 1 ? 1 : 2); t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; k++) o.push_back(uint8_t(qtab[t][kNatural[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(uint8_t((comp[c].h << 4) | comp[c].v));
    o.push_back(uint8_t(c == 0 ? 0 : 1));
  }
  emit_dht(o, 0x00, kDcLumBits, kDcVals, 12);
  emit_dht(o, 0x10, kAcLumBits, kAcLumVals, 162);
  if (nc == 3) {
    emit_dht(o, 0x01, kDcChromBits, kDcVals, 12);
    emit_dht(o, 0x11, kAcChromBits, kAcChromVals, 162);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(uint8_t(c == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  HuffTable dct[2] = {std_table(kDcLumBits, kDcVals, 12), std_table(kDcChromBits, kDcVals, 12)};
  HuffTable act[2] = {std_table(kAcLumBits, kAcLumVals, 162),
                      std_table(kAcChromBits, kAcChromVals, 162)};
  size_t head = o.size(), blocks = 0;
  for (int c = 0; c < nc; c++) blocks += size_t(comp[c].stride) * comp[c].rows;
  o.resize(head + blocks * 512 + 64);  // a block codes to under 256 bytes, stuffed x2
  BitWriter bwr(o.data() + head);
  int last_dc[3] = {0, 0, 0};
  if (nc == 1) {
    Comp& k = comp[0];
    for (int by = 0; by < k.bh; by++)
      for (int bx = 0; bx < k.bw; bx++)
        encode_block(bwr, k.q.data() + (size_t(by) * k.stride + bx) * 64, last_dc[0], dct[0],
                     act[0]);
  } else {
    int16_t mcu[4 * 4][64];
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++)
        for (int c = 0; c < nc; c++) {
          Comp& k = comp[c];
          int n = 0;
          // jccoefct.c: blocks past the component's edge are dummies whose DC
          // repeats the block to their left (or the last one of the row above)
          for (int v = 0; v < k.v; v++) {
            int by = my * k.v + v;
            for (int h = 0; h < k.h; h++, n++) {
              int bx = mx * k.h + h;
              if (by < k.bh && bx < k.bw) {
                memcpy(mcu[n], k.q.data() + (size_t(by) * k.stride + bx) * 64,
                       64 * sizeof(int16_t));
              } else {
                memset(mcu[n], 0, 64 * sizeof(int16_t));
                mcu[n][0] = by < k.bh ? mcu[n - 1][0] : mcu[v * k.h - 1][0];
              }
            }
          }
          int t = c == 0 ? 0 : 1;
          for (int i = 0; i < n; i++) encode_block(bwr, mcu[i], last_dc[c], dct[t], act[t]);
        }
  }
  bwr.finish();
  o.resize(head + bwr.n);
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    snprintf(err, size_t(errlen), "%s", msg);
  }
}

}  // namespace

extern "C" {

// Header of a JPEG: width, height, output channels (1 for gray, else 3: RGB
// for a 3- or 4-component file) and the offset and
// length of its first APP1 Exif payload (TIFF header onwards; -1 when none).
// Returns 0, or -1 with a message in err (unsupported variants included).
int qie_jpeg_info(const uint8_t* data, long n, int* width, int* height, int* comps,
                  long* exif_off, long* exif_len, char* err, int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.parse(true);
    *width = d.width;
    *height = d.height;
    *comps = d.ncomp == 1 ? 1 : 3;
    *exif_off = d.exif_off;
    *exif_len = d.exif_len;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Decode a JPEG into out: height x width x comps uint8 (comps from
// qie_jpeg_info). Returns 0, or -1 with a message in err.
int qie_jpeg_decode(const uint8_t* data, long n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.parse();
    d.output(out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Encode height x width x comps (1 or 3) uint8 pixels as a baseline JFIF
// JPEG at `quality`; the first component sampled hs x vs (chroma 1x1).
// Returns the byte count written to out, the count needed when it exceeds
// cap (nothing written), or -1 with a message in err.
long qie_jpeg_encode(const uint8_t* px, int width, int height, int comps, int quality, int hs,
                     int vs, uint8_t* out, long cap, char* err, int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65535 || height > 65535)
      throw CodecError("JPEG sizes are 1 to 65535 pixels a side");
    if (comps != 1 && comps != 3) throw CodecError("JPEG encode takes 1 or 3 channels");
    if (hs < 1 || hs > 2 || vs < 1 || vs > 2) throw CodecError("sampling factors are 1 or 2");
    std::vector<uint8_t> o = encode(px, width, height, comps, quality, hs, vs);
    if (long(o.size()) <= cap) memcpy(out, o.data(), o.size());
    return long(o.size());
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Reverse the PNG row filters of `height` rows of `rowbytes` bytes, each led
// by its filter type byte (in), into out (height x rowbytes); bpp is the
// bytes a pixel. Returns 0, or -1 with a message in err.
int qie_png_unfilter(const uint8_t* in, int height, long rowbytes, int bpp, uint8_t* out,
                     char* err, int errlen) {
  std::vector<uint8_t> zero(size_t(rowbytes), 0);
  for (int y = 0; y < height; y++) {
    const uint8_t* src = in + size_t(y) * (rowbytes + 1);
    int ft = src[0];
    src++;
    uint8_t* cur = out + size_t(y) * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : zero.data();
    switch (ft) {
      case 0: memcpy(cur, src, size_t(rowbytes)); break;
      case 1:
        for (long i = 0; i < rowbytes; i++)
          cur[i] = uint8_t(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; i++) cur[i] = uint8_t(src[i] + up[i]);
        break;
      case 3:
        for (long i = 0; i < rowbytes; i++)
          cur[i] = uint8_t(src[i] + ((int(i >= bpp ? cur[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(src[i] + pred);
        }
        break;
      default: {
        std::string msg = "unsupported PNG: filter type " + std::to_string(ft);
        set_err(err, errlen, msg.c_str());
        return -1;
      }
    }
  }
  return 0;
}

}  // extern "C"
