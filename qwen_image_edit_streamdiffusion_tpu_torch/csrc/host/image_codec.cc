// JPEG decode/encode and PNG unfiltering for the serving wire, on the host.
//
// The port's counterpart of what Pillow (built on libjpeg-turbo) does for the
// JAX package's wire (core/imaging.py there): the decoder follows
// libjpeg-turbo's default decompression path, so its pixels equal Pillow's bit
// for bit:
//   - Huffman entropy decoding of baseline (SOF0) and 8-bit extended
//     sequential (SOF1) scans, interleaved or not, with restart intervals;
//     the bit buffer refilled where jdhuff.c refills it, so data that ends
//     without a marker runs out where libjpeg would wait for more; Annex K's
//     tables where a sequential file defines none (std_huff_tables);
//   - progressive (SOF2) Huffman scans into the whole image's coefficients:
//     jdphuff.c's DC first and refinement scans, AC first scans with their
//     EOB runs and AC refinement scans with their correction bits (ITU T.81
//     G.1.2), per-scan Huffman tables, restarts that also end an EOB run. The
//     pixels are made after the last scan, as for a sequential file;
//   - arithmetic-coded sequential (SOF9) and progressive (SOF10) scans:
//     jdarith.c's QM decoder (ITU T.81 D.2, Table D.2), DC and AC
//     statistics bins, DAC conditioning, restarts that reset the statistics,
//     the same four progressive scan kinds. libjpeg cannot suspend in an
//     arithmetic scan and Pillow feeds it 64 KiB blocks of the file: a scan
//     whose data crosses the block its header ended in is refused;
//   - 8-bit lossless (SOF3) scans, libjpeg-turbo 3's jdlhuff.c, jddiffct.c
//     and jdlossls.c: predictors 1-7 from the reconstructed samples, the
//     first row and each restart's predicted from the left, the point
//     transform, box upsampling; no colour conversion (as libjpeg-turbo:
//     YCbCr and YCCK refused);
//   - block smoothing of a progressive image whose scans leave low
//     frequencies short (jdcoefct.c smoothing_ok and decompress_smooth_data,
//     libjpeg-turbo 2.1+: nine AC coefficients estimated from a 5x5 window of
//     DC values, the DC too where no AC data arrived, the last scan's bits
//     only up to the last iMCU row it decoded with data left);
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
// Markers are read as jdmarker.c reads them (FF 00 skipped between markers,
// unknown markers refused before their length, DHT and DQT lengths exact), and
// what follows a single-scan file's scan only as jpeg_finish_decompress
// reads it. JPEG-in-TIFF strips (qie_tiff_jpeg) are decoded as libtiff's
// tif_jpeg.c decodes them.
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

// a marker segment that runs past the data: where libjpeg would suspend
struct DataEnd : CodecError {
  using CodecError::CodecError;
};

// Pillow's DecompressionBombError limit (2 * Image.MAX_IMAGE_PIXELS), checked
// before anything of the image is allocated (core/codec.py holds PNG to it).
constexpr int64_t kMaxPixels = 178956970;
// Pillow's ImageFile.MAXBLOCK: the bytes it hands a decoder a call
constexpr size_t kPillowBlock = 65536;

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
  int max_val = 0;  // the largest symbol
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  // decoding (jdhuff.c's maxcode/valoffset) and a 9-bit lookahead
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];  // 8-bit lookahead: (length << 8) | value, 0 when the code is longer
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
      if (l > 8) continue;
      int lo = huffcode[i] << (8 - l), cnt = 1 << (8 - l);
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
  int sof_h = 1, sof_v = 1;  // the frame header's factors, before a lone one is 1x1
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int bw = 0, bh = 0;       // blocks of the component (non-interleaved scan)
  int bw_pad = 0, bh_pad = 0;  // blocks covering whole MCUs
  int dw = 0, dh = 0;       // real samples (downsampled_width / height)
  std::vector<int16_t> coef;  // bh_pad * bw_pad blocks of 64
  uint16_t q[64];
  bool q_latched = false;
  int dc_pred = 0;
  // progressive: the successive-approximation bit each coefficient (zigzag
  // order) was last sent to, -1 before its first scan (libjpeg's coef_bits),
  // and the same before the scan that last touched it (its prev_coef_bits)
  int coef_bits[64];
  int prev_bits[64];
  int dc_context = 0;  // arithmetic DC conditioning (jdarith.c dc_context)
  // lossless: the undifferenced samples (bw_pad x bh_pad, one a block)
  std::vector<uint16_t> samples;
  int point_transform = 0;
};

// From p to the next marker (stuffed FF 00 pairs and other bytes skipped):
// its code, p at its last FF; -1 when the data ends first.
int next_marker_at(const uint8_t*& p, const uint8_t* end) {
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

// The restart marker due before the next interval: jdmarker.c
// read_restart_marker with jpeg_resync_to_restart. The expected marker (or
// one too far off to tell) is stepped over and 0 returned: the data resumes;
// a marker of the next two intervals or a non-restart marker is left where it
// is (p at its last FF) and 1 returned, so the interval reads as empty (zero
// data); -1 when the data ends first.
int find_restart(const uint8_t*& p, const uint8_t* end, int expected) {
  int m = next_marker_at(p, end);
  for (;;) {
    if (m < 0) return -1;
    int action;
    if (m < 0xC0) action = 2;
    else if (m < 0xD0 || m > 0xD7) action = 3;
    else if (m == 0xD0 + ((expected + 1) & 7) || m == 0xD0 + ((expected + 2) & 7)) action = 3;
    else if (m == 0xD0 + ((expected + 7) & 7) || m == 0xD0 + ((expected + 6) & 7)) action = 2;
    else action = 1;
    if (action == 1) {
      p += 2;
      return 0;
    }
    if (action == 3) return 1;
    p += 2;
    m = next_marker_at(p, end);
  }
}

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
  // jdhuff.h HUFF_DECODE: the bit buffer refilled (to 57 bits or a
  // marker) only when fewer than 8 bits are left, an 8-bit lookahead, then
  // jpeg_huff_decode a bit at a time, each refill again only when empty: the
  // data runs out (hit_end) exactly where libjpeg's would suspend.
  int decode(const HuffTable& t) {
    if (nbits < 8) fill();
    int e = t.look[int(acc >> 56)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = get(9);
    int l = 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) {
        // no code of up to 16 bits matches (garbage input): libjpeg warns,
        // drops the 17 bits it read and takes the symbol as 0
        return 0;
      }
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // The restart marker due before the next interval (find_restart).
  void restart(int expected) {
    acc = 0;
    nbits = zbits = 0;
    int r = find_restart(p, end, expected);
    hit_end = r < 0;
    at_marker = r != 0;
    if (r == 0) insufficient = false;
  }
};

std::string hex2(int v) {
  const char* d = "0123456789ABCDEF";
  return std::string{d[(v >> 4) & 15], d[v & 15]};
}

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// Table D.2 of ITU T.81 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed 0.5 estimate.
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x80b0412, 0x3d80514, 0x1da0617, 0xe50719,
    0x6f081c, 0x36091e, 0x1a0a21, 0xd0b23, 0x60c09, 0x30d0a, 0x10d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0xcef152b,
    0x9a1162d, 0x72f172e, 0x55c1830, 0x4061931, 0x3031a33, 0x2401b34, 0x1b11c36,
    0x1441d38, 0xf51e39, 0xb71f3b, 0x8a203c, 0x68213e, 0x4e223f, 0x3b2320,
    0x2c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0xe742e4a, 0xbfb2f4b, 0x9f8304d, 0x861314e,
    0x706324f, 0x5cd3330, 0x4de3432, 0x40f3532, 0x3633633, 0x2d43734, 0x25c3835,
    0x1f83936, 0x1a43a37, 0x1603b38, 0x1253c39, 0xf63d3a, 0xcb3e3b, 0xab3f3d,
    0x8f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0xf6b4d4a,
    0xd514e4b, 0xbb64f4d, 0xa40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
};

// The QM decoder of jdarith.c (ITU T.81 D.2) over a scan's bytes. A marker
// stops the data and zero bytes are fed from then on, as the standard has it;
// the data ending without a marker sets hit_end. `end_read` is one past the
// last byte the decoder took, for Pillow's buffer rule (Decoder::decode_scan).
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two initial bytes to fetch; -1: a fault, decode nothing more
  bool at_marker = false;  // p at the marker's last FF
  bool hit_end = false;
  const uint8_t* end_read = nullptr;
  uint8_t dc_stats[16][64];
  uint8_t ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  void reset() {
    c = a = 0;
    ct = -16;
  }
  int byte() {
    if (at_marker) return 0;
    if (p >= end) {
      hit_end = at_marker = true;
      return 0;
    }
    int data = *p++;
    if (data == 0xFF) {
      const uint8_t* q = p;
      while (q < end && *q == 0xFF) q++;
      if (q >= end) {
        p = q;
        hit_end = at_marker = true;
        return 0;
      }
      if (*q == 0) {
        p = q + 1;
      } else {
        p = q - 1;
        at_marker = true;
        data = 0;
        end_read = q + 1;
        return data;
      }
    }
    end_read = p;
    return data;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // two initial bytes: A = 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool sof_seen = false, jfif = false, adobe = false, progressive = false;
  bool arith = false, lossless = false;
  bool smooth = false;  // block smoothing at output (jdcoefct.c decompress_smooth_data)
  // the colour space a caller imposes: 0 the markers', 1 none (components as
  // they are), 2 YCbCr (libtiff's JPEGCOLORMODE_RGB)
  int force_cs = 0;
  int scans = 0;  // scans begun (libjpeg's input_scan_number)
  // the last iMCU row whose decoding began with data left (libjpeg-turbo's
  // last_good_iMCU_row): block smoothing trusts the last scan's bits up to it
  int last_good_imcu = 0;
  // DAC conditioning: L and U of each DC table, K of each AC table
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  int eobrun = 0;  // progressive AC scans: blocks left in the current EOB run
  int adobe_transform = -1;
  bool rgb = false;   // 3 components coded as RGB, not YCbCr
  bool ycck = false;  // 4 components coded as YCCK, not CMYK
  bool plain_cmyk = false;  // 4 components read as CMYK whatever the Adobe transform
  long exif_off = -1, exif_len = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
  }

  int u8() {
    if (pos >= n) throw DataEnd("truncated JPEG: a header ends early");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c next_marker: bytes before a marker skipped, FF 00 too
  int next_marker() {
    for (;;) {
      while (pos < n && data[pos] != 0xFF) pos++;  // garbage before a marker
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) return -1;
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void unsupported_sof(int m) {
    if (m == 0xCB) throw CodecError("unsupported JPEG: arithmetic-coded lossless JPEG (SOF11)");
    throw CodecError("unsupported JPEG: hierarchical (differential) JPEG (SOF" +
                     std::to_string(m - 0xC0) + ")");
  }

  // jdmarker.c get_dac: the arithmetic conditioning of each table
  void parse_dac(int len) {
    size_t end = pos + len - 2;
    if ((len - 2) % 2) throw CodecError("corrupt JPEG: bad DAC length");
    while (pos < end) {
      int index = u8(), val = u8();
      if (index >= 32) throw CodecError("corrupt JPEG: bad DAC table index");
      if (index >= 16) {
        dac_k[index - 16] = uint8_t(val);
      } else {
        dac_l[index] = uint8_t(val & 15);
        dac_u[index] = uint8_t(val >> 4);
        if (dac_l[index] > dac_u[index]) throw CodecError("corrupt JPEG: bad DAC value");
      }
    }
  }

  void parse_sof(int len) {
    if (sof_seen) throw CodecError("corrupt JPEG: two frame headers");
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8)
      throw CodecError("unsupported JPEG: " + std::to_string(prec) + "-bit " +
                       (lossless ? "lossless " : "") + "JPEG");
    if (height == 0) throw CodecError("unsupported JPEG: height defined by DNL");
    if (width == 0) throw CodecError("corrupt JPEG: zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw CodecError("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (len != 8 + 3 * ncomp) throw CodecError("corrupt JPEG: bad frame header length");
    for (int i = 0; i < ncomp; i++) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = comp[i].sof_h = hv >> 4;
      comp[i].v = comp[i].sof_v = hv & 15;
      comp[i].tq = u8();
      // a lossless file has no quantization tables: its Tq is not read
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
          (comp[i].tq > 3 && !lossless))
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
    const int bs = lossless ? 1 : 8;  // block size: a sample in lossless JPEG
    mcus_x = (width + bs * max_h - 1) / (bs * max_h);
    mcus_y = (height + bs * max_v - 1) / (bs * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = int((int64_t(width) * c.h + max_h - 1) / max_h);
      c.dh = int((int64_t(height) * c.v + max_v - 1) / max_v);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_pad = mcus_x * c.h;
      c.bh_pad = mcus_y * c.v;
      if (lossless) {  // one sample a block: samples, not coefficients
        c.bw = c.dw;
        c.bh = c.dh;
        c.samples.assign(size_t(c.bw_pad) * c.bh_pad, 0);
      } else {
        c.coef.assign(size_t(c.bw_pad) * c.bh_pad * 64, 0);
      }
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, -1);
    }
    sof_seen = true;
  }

  // jdmarker.c get_dqt: whole tables, the segment's length exactly theirs
  void parse_dqt(int len) {
    long length = len - 2;
    while (length > 0) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) throw CodecError("corrupt JPEG: bad quantization table");
      for (int k = 0; k < 64; k++) qt[t][kNatural[k]] = uint16_t(prec ? u16() : u8());
      qt_defined[t] = true;
      length -= 65 + (prec ? 64 : 0);
    }
    if (length != 0) throw CodecError("corrupt JPEG: bad DQT length");
  }

  // jdmarker.c get_dht: each table's symbols within the segment, which they
  // fill exactly
  void parse_dht(int len) {
    long length = len - 2;
    while (length > 16) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) throw CodecError("corrupt JPEG: bad Huffman table");
      HuffTable t;
      int total = 0;
      for (int l = 1; l <= 16; l++) total += (t.bits[l] = uint8_t(u8()));
      length -= 17;
      if (total > 256 || total > length) throw CodecError("corrupt JPEG: bad Huffman table");
      length -= total;
      for (int i = 0; i < total; i++) {
        t.vals[i] = uint8_t(u8());
        t.max_val = std::max<int>(t.max_val, t.vals[i]);
      }
      t.build();
      (cls ? ac : dc)[id] = t;
    }
    if (length != 0) throw CodecError("corrupt JPEG: bad DHT length");
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
    if (force_cs) {
      if (ncomp == 4) throw CodecError("unsupported JPEG: 4 components in a JPEG-in-TIFF strip");
      rgb = force_cs == 1;
      return;
    }
    if (ncomp == 3) {
      rgb = false;
      if (!jfif) {
        if (adobe) rgb = adobe_transform == 0;
        // libjpeg-turbo 3 takes a lossless file without markers as RGB
        else rgb = lossless || (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
      }
    } else if (ncomp == 4) {
      ycck = adobe && adobe_transform != 0 && !plain_cmyk;
    }
    // jdcolor.c: libjpeg-turbo converts no colour space in lossless mode
    if (lossless && (ycck || (ncomp == 3 && !rgb)))
      throw CodecError(std::string("unsupported JPEG: a lossless JPEG coded as ") +
                       (ycck ? "YCCK" : "YCbCr") + " (libjpeg-turbo converts no colour "
                       "space in lossless mode)");
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
      for (int k = 0; k < i; k++)
        if (sc[k] == c) throw CodecError("corrupt JPEG: a scan names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      if (!c->q_latched && !lossless) {
        if (!qt_defined[c->tq]) throw CodecError("corrupt JPEG: undefined quantization table");
        memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->q_latched = true;
      }
      c->dc_pred = 0;
      c->dc_context = 0;
      sc[i] = c;
    }
    if (ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) throw CodecError("corrupt JPEG: " + std::to_string(blocks) +
                                        " blocks in an MCU (libjpeg takes 10)");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    scans++;
    if (lossless) {
      // jdlossls.c: Ss is the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        throw CodecError("corrupt JPEG: bad lossless scan parameters Ss=" + std::to_string(ss) +
                         " Se=" + std::to_string(se) + " Ah=" + std::to_string(ah) +
                         " Al=" + std::to_string(al));
      for (int i = 0; i < ns; i++)
        if (sc[i]->td > 3 || !dc[sc[i]->td].defined || dc[sc[i]->td].max_val > 16)
          throw CodecError(sc[i]->td <= 3 && dc[sc[i]->td].defined ? "corrupt JPEG: bad Huffman table"
                                                 : "corrupt JPEG: scan uses an undefined Huffman table");
      decode_lossless_scan(sc, ns, ss, al);
      return;
    }
    // which tables the scan reads (jdhuff.c / jdphuff.c start_pass)
    bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss > 0;
    if (progressive) {
      // jdphuff.c / jdarith.c start_pass's JERR_BAD_PROGRESSION
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad)
        throw CodecError("corrupt JPEG: bad progression parameters Ss=" + std::to_string(ss) +
                         " Se=" + std::to_string(se) + " Ah=" + std::to_string(ah) +
                         " Al=" + std::to_string(al));
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      }
    }
    // a sequential scan's Ss, Se, Ah and Al are libjpeg's JWRN_NOT_SEQUENTIAL
    // warning only: the whole block is decoded all the same
    if (!arith)
      for (int i = 0; i < ns; i++) {
        // four Huffman tables (sixteen arithmetic ones): a scan names only
        // those it reads, as jdhuff.c / jdphuff.c build them
        if ((need_dc && sc[i]->td > 3) || (need_ac && sc[i]->ta > 3))
          throw CodecError("corrupt JPEG: bad scan header");
        if ((need_dc && !dc[sc[i]->td].defined) || (need_ac && !ac[sc[i]->ta].defined))
          throw CodecError("corrupt JPEG: scan uses an undefined Huffman table");
        // jdhuff.c jpeg_make_d_derived_tbl: a DC symbol is a bit count, 0..15
        if (need_dc && dc[sc[i]->td].max_val > 15)
          throw CodecError("corrupt JPEG: bad Huffman table");
      }
    eobrun = 0;
    BitReader br{data + pos, data + n};
    ArithReader ar{data + pos, data + n};
    if (arith) {
      for (int i = 0; i < ns; i++) {
        if (need_dc) memset(ar.dc_stats[sc[i]->td], 0, 64);
        if (need_ac) memset(ar.ac_stats[sc[i]->ta], 0, 256);
      }
    }
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
          if (arith) {
            // jdarith.c process_restart: the statistics and predictions reset
            int r = find_restart(ar.p, ar.end, rst);
            ar.hit_end = r < 0;
            ar.at_marker = r != 0;
            if (r < 0) break;
            for (int i = 0; i < ns; i++) {
              if (need_dc) memset(ar.dc_stats[sc[i]->td], 0, 64);
              if (need_ac) memset(ar.ac_stats[sc[i]->ta], 0, 256);
            }
            ar.reset();
          } else {
            br.restart(rst);
          }
          rst = (rst + 1) & 7;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = sc[i]->dc_context = 0;
          eobrun = 0;
        }
        auto unit = [&](Component& c, int bx, int by) {
          if (arith) {
            if (ar.ct == -1) return;  // jdarith.c: after a fault nothing more is decoded
            if (!progressive) arith_block(ar, c, bx, by);
            else if (ss == 0 && ah == 0) arith_dc_first(ar, c, bx, by, al);
            else if (ss == 0) {
              if (ar.decode(ar.fixed_bin)) block(c, bx, by)[0] |= int16_t(1 << al);
            } else if (ah == 0) arith_ac_first(ar, c, bx, by, ss, se, al);
            else arith_ac_refine(ar, c, bx, by, ss, se, al);
          } else if (!progressive) decode_block(br, c, bx, by);
          else if (ss == 0 && ah == 0) dc_first(br, c, bx, by, al);
          else if (ss == 0) dc_refine(br, c, bx, by, al);
          else if (ah == 0) ac_first(br, c, bx, by, ss, se, al);
          else ac_refine(br, c, bx, by, ss, se, al);
        };
        if (!br.insufficient) last_good_imcu = ns == 1 ? uy / sc[0]->v : uy;
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
        if (ar.hit_end) break;
      }
      // the data ran out: no zero-fed rows after that (Pillow stops too)
      if (br.hit_end || ar.hit_end) break;
    }
    if (br.hit_end || ar.hit_end)
      throw CodecError("truncated JPEG: the entropy-coded data ends early");
    if (arith && !force_cs) {
      // jdarith.c cannot suspend: Pillow hands libjpeg the file 64 KiB at a
      // time (ImageFile.MAXBLOCK), so an arithmetic scan whose data runs past
      // the block its header ended in breaks the decode there (libtiff hands
      // it a whole strip)
      size_t block_end = ((pos - 1) / kPillowBlock + 1) * kPillowBlock;
      if (ar.end_read && size_t(ar.end_read - data) > block_end)
        throw CodecError("unsupported JPEG: an arithmetic-coded scan that crosses a 64 KiB "
                         "boundary of the file (Pillow's read block: libjpeg's arithmetic "
                         "decoder cannot wait for more data)");
    }
    resume_after(arith ? ar.p : br.p);
  }

  // Marker parsing resumes where a scan's entropy-coded data ends: at the
  // next marker that is not a restart.
  void resume_after(const uint8_t* p) {
    while (p + 1 < data + n && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                                 !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      p++;
    pos = size_t(p - data);
  }

  // jdarith.c: the DC difference of one block (F.1.4.4.1), added to the
  // component's prediction (kept to 16 bits, as libjpeg keeps it)
  void arith_dc_diff(ArithReader& ar, Component& c) {
    uint8_t* stats = ar.dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = stats + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow: libjpeg's warning, nothing more decoded
          return;
        }
        st++;
      }
    }
    if (m < int((1L << dac_l[c.td]) >> 1)) c.dc_context = 0;
    else if (m > int((1L << dac_u[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.dc_pred = (c.dc_pred + v) & 0xFFFF;
  }

  // jdarith.c's AC band ss..se of one block (F.1.4.4.2): coefficient k's
  // value, shifted left by al; false after a fault (ct = -1)
  bool arith_ac_band(ArithReader& ar, Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ar.ac_stats[c.ta];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return false;
        }
      }
      int sign = ar.decode(ar.fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k[c.ta] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return false;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(int(unsigned(v) << al));
    }
    return true;
  }

  // jdarith.c decode_mcu: one block of a sequential scan
  void arith_block(ArithReader& ar, Component& c, int bx, int by) {
    int16_t* blk = block(c, bx, by);
    arith_dc_diff(ar, c);
    if (ar.ct == -1) return;
    blk[0] = int16_t(c.dc_pred);
    arith_ac_band(ar, c, blk, 1, 63, 0);
  }

  // decode_mcu_DC_first
  void arith_dc_first(ArithReader& ar, Component& c, int bx, int by, int al) {
    arith_dc_diff(ar, c);
    if (ar.ct == -1) return;
    block(c, bx, by)[0] = int16_t(int(unsigned(c.dc_pred) << al));
  }

  // decode_mcu_AC_first
  void arith_ac_first(ArithReader& ar, Component& c, int bx, int by, int ss, int se, int al) {
    arith_ac_band(ar, c, block(c, bx, by), ss, se, al);
  }

  // decode_mcu_AC_refine: past the band's last nonzero coefficient an EOB
  // flag first; a correction bit for each nonzero one, else whether it
  // becomes +-1 << al
  void arith_ac_refine(ArithReader& ar, Component& c, int bx, int by, int ss, int se, int al) {
    int16_t* blk = block(c, bx, by);
    uint8_t* stats = ar.ac_stats[c.ta];
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = int16_t(ar.decode(ar.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // A lossless scan (jdlhuff.c decode_mcus, jddiffct.c, jdlossls.c): each
  // sample's Huffman-coded difference from its predictor, undifferenced row
  // by row of each component; the first row of the scan and of each restart
  // interval predicted from the left (its first sample from 1 << (7 - al)),
  // every first column from above. Restart intervals are whole MCU rows.
  void decode_lossless_scan(Component** sc, int ns, int psv, int al) {
    int units_x = ns == 1 ? sc[0]->bw : mcus_x, units_y = ns == 1 ? sc[0]->bh : mcus_y;
    if (restart_interval % units_x)
      throw CodecError("corrupt JPEG: restart interval " + std::to_string(restart_interval) +
                       " is not a whole number of MCU rows (" + std::to_string(units_x) + ")");
    int rows_per_restart = restart_interval / units_x;
    BitReader br{data + pos, data + n};
    std::vector<int> diff[4];
    for (int i = 0; i < ns; i++) {
      int h = ns == 1 ? 1 : sc[i]->h, v = ns == 1 ? 1 : sc[i]->v;
      diff[i].assign(size_t(units_x) * h * v, 0);
    }
    bool first_row[4] = {true, true, true, true};
    int rst = 0;
    for (int uy = 0; uy < units_y; uy++) {
      if (rows_per_restart && uy > 0 && uy % rows_per_restart == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        std::fill(first_row, first_row + 4, true);
        if (br.hit_end) break;
      }
      bool zero = br.insufficient;  // out of data: zero differences, predictor reset
      if (zero) std::fill(first_row, first_row + 4, true);
      for (int ux = 0; ux < units_x; ux++) {
        for (int i = 0; i < ns; i++) {
          int h = ns == 1 ? 1 : sc[i]->h, v = ns == 1 ? 1 : sc[i]->v;
          for (int y = 0; y < v; y++)
            for (int x = 0; x < h; x++) {
              int d = 0;
              if (!zero) {
                int s = br.decode(dc[sc[i]->td]);
                if (s == 16) d = 32768;
                else if (s) d = extend(br.get(s), s);
              }
              diff[i][size_t(y) * units_x * h + ux * h + x] = d;
            }
        }
      }
      if (br.hit_end) break;
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int v = ns == 1 ? 1 : c.v, stride = units_x * (ns == 1 ? 1 : c.h);
        int w = c.dw;
        for (int y = 0; y < v; y++) {
          int row = uy * v + y;
          if (row >= c.dh) break;
          const int* d = diff[i].data() + size_t(y) * stride;
          uint16_t* out = c.samples.data() + size_t(row) * c.bw_pad;
          if (first_row[i]) {
            int ra = (d[0] + (1 << (7 - al))) & 0xFFFF;
            out[0] = uint16_t(ra);
            for (int x = 1; x < w; x++) out[x] = uint16_t(ra = (d[x] + ra) & 0xFFFF);
            first_row[i] = false;
            continue;
          }
          const uint16_t* up = out - c.bw_pad;
          int ra = (d[0] + up[0]) & 0xFFFF;
          out[0] = uint16_t(ra);
          for (int x = 1; x < w; x++) {
            int rb = up[x], rc = up[x - 1], pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
            out[x] = uint16_t(ra = (d[x] + pred) & 0xFFFF);
          }
        }
      }
    }
    if (br.hit_end) throw CodecError("truncated JPEG: the entropy-coded data ends early");
    for (int i = 0; i < ns; i++) sc[i]->point_transform = al;
    resume_after(br.p);
  }

  // A marker after a single-scan file's scan, as jpeg_finish_decompress
  // reads it: false where libjpeg would wait for more data.
  bool after_scan(int m) {
    int len = u16();
    if (len < 2) throw CodecError("corrupt JPEG: bad marker segment length");
    switch (m) {
      case 0xC4: parse_dht(len); return true;
      case 0xDB: parse_dqt(len); return true;
      case 0xCC: parse_dac(len); return true;
      case 0xDD:
        if (len != 4) throw CodecError("corrupt JPEG: bad DRI");
        restart_interval = u16();
        return true;
      case 0xDA: {  // jdmarker.c get_sos, then consume_markers' JERR_EOI_EXPECTED
        int ns = u8();
        if (len != 6 + 2 * ns || ns < 1 || ns > 4) throw CodecError("corrupt JPEG: bad scan header");
        for (int i = 0; i < ns; i++) {
          int id = u8();
          u8();
          bool found = false;
          for (int k = 0; k < ncomp; k++) found |= comp[k].id == id;
          if (!found) throw CodecError("corrupt JPEG: scan names an unknown component");
        }
        u8();
        u8();
        u8();
        throw CodecError("corrupt JPEG: a second scan in a single-scan file");
      }
      default:  // APPn, COM, DNL: skipped
        if (pos + len - 2 > n) return false;
        if (m >= 0xE0 && m <= 0xEF) parse_app(m, len);
        else pos += len - 2;
        return true;
    }
  }

  // An abbreviated table-only stream (a TIFF's JPEGTables), read before the
  // image stream as libjpeg reads it with jpeg_read_header(FALSE): its
  // tables are kept for the image; a frame or a scan in it is refused.
  void load_tables(const uint8_t* t, size_t tn) {
    const uint8_t* img = data;
    size_t img_n = n;
    data = t;
    n = tn;
    pos = 2;
    if (tn < 2 || t[0] != 0xFF || t[1] != 0xD8) throw CodecError("corrupt TIFF: JPEGTables without SOI");
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) break;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = u16();
      if (len < 2) throw CodecError("corrupt TIFF: a bad JPEGTables segment");
      if (m == 0xC4) parse_dht(len);
      else if (m == 0xDB) parse_dqt(len);
      else if (m == 0xCC) parse_dac(len);
      else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDD) pos = std::min(n, pos + len - 2);
      else throw CodecError("corrupt TIFF: JPEGTables holds marker 0x" + hex2(m) +
                            " (libtiff's \"Bogus JPEGTables field\")");
    }
    data = img;
    n = img_n;
    pos = 0;
  }

  // Markers up to the end of the image, decoding each scan; headers_only
  // stops at the first scan's header (the frame header and APPn precede it).
  void parse(bool headers_only = false) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw CodecError("not a JPEG file");
    pos = 2;
    // jdmarker.c get_soi: the restart interval and the arithmetic
    // conditioning go back to their defaults (tables stay)
    restart_interval = 0;
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
    bool scanned = false;
    // a single-scan file's pixels are made as its scan is read: libjpeg reads
    // what follows the scan only in jpeg_finish_decompress, where Pillow lets
    // data that runs out pass (an error still raises). A file of several
    // scans (progressive, or one component a scan) is read to its EOI first.
    bool tail = false, break_out = false;
    for (;;) {
      if (break_out) break;
      int m = next_marker();
      if (m < 0) {
        if (tail) break;
        throw CodecError(scanned ? "truncated JPEG: the scans end without EOI"
                                 : "truncated JPEG: no scan");
      }
      if (m == 0xD9) break;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      // jdmarker.c read_markers: what it refuses before reading a length
      bool known = (m >= 0xC0 && m <= 0xCF) || (m >= 0xDA && m <= 0xDD) ||
                   (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xD8;
      if (!known) throw CodecError("corrupt JPEG: unknown marker 0x" + hex2(m));
      if (m == 0xD8) throw CodecError("corrupt JPEG: a second SOI marker");
      if (m == 0xC8) throw CodecError("unsupported JPEG: the JPG extension marker (SOF8)");
      if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCB || (m >= 0xCD && m <= 0xCF))
        unsupported_sof(m);
      bool sof = m >= 0xC0 && m <= 0xCA && m != 0xC4 && m != 0xC8;
      if (sof && sof_seen) throw CodecError("corrupt JPEG: two frame headers");
      if (tail) {
        // libjpeg reads these segments a byte at a time: an error in the
        // bytes there are raises, a segment that runs past them suspends
        try {
          if (!after_scan(m)) break;
        } catch (const DataEnd&) {
          break;
        }
        continue;
      }
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw CodecError("truncated JPEG: a marker segment ends early");
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          // baseline, extended, progressive and lossless Huffman; sequential
          // and progressive arithmetic
          progressive = m == 0xC2 || m == 0xCA;
          lossless = m == 0xC3;
          arith = m >= 0xC9;
          parse_sof(len);
          break;
        case 0xCC: parse_dac(len); break;
        case 0xC4: parse_dht(len); break;
        case 0xDB: parse_dqt(len); break;
        case 0xDD:
          if (len != 4) throw CodecError("corrupt JPEG: bad DRI");
          restart_interval = u16();
          break;
        case 0xDC: pos += len - 2; break;  // DNL: skipped once the frame has a height
        case 0xDA:
          if (!scanned) {
            check_colorspace();
          }
          if (!scanned && !progressive && !lossless && !arith) {
            // libjpeg-turbo's std_huff_tables (jinit_huff_decoder, sequential
            // Huffman only): tables 0 and 1 not yet defined take Annex K's
            // (Motion JPEG)
            if (!dc[0].defined) dc[0] = std_table(kDcLumBits, kDcVals, 12);
            if (!dc[1].defined) dc[1] = std_table(kDcChromBits, kDcVals, 12);
            if (!ac[0].defined) ac[0] = std_table(kAcLumBits, kAcLumVals, 162);
            if (!ac[1].defined) ac[1] = std_table(kAcChromBits, kAcChromVals, 162);
          }
          if (headers_only) {
            if (!sof_seen) throw CodecError("corrupt JPEG: scan before frame header");
            return;
          }
          {
            size_t sos = pos;
            bool whole = !progressive && data[sos] == ncomp;  // all components in one scan
            decode_scan(len);
            tail = !scanned && whole;
            // libtiff ignores what follows a strip's single scan: its
            // jpeg_finish_decompress errors read as success
            if (tail && force_cs) break_out = true;
          }
          scanned = true;
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) parse_app(m, len);
          else pos += len - 2;  // COM
      }
    }
    if (!scanned) throw CodecError("truncated JPEG: no scan");
    smooth = progressive && smoothing_ok();
  }

  // IDCT of component c into a plane of bw_pad*8 x bh_pad*8 samples (or its
  // lossless samples, bw_pad x bh_pad, shifted left by the point transform).
  std::vector<uint8_t> plane(const Component& c) const {
    if (lossless) {
      std::vector<uint8_t> out(c.samples.size());
      for (size_t i = 0; i < out.size(); i++) out[i] = uint8_t(c.samples[i] << c.point_transform);
      return out;
    }
    int stride = c.bw_pad * 8;
    std::vector<uint8_t> out(size_t(stride) * c.bh_pad * 8);
    if (smooth) {
      smoothed_plane(c, out.data(), stride);
      return out;
    }
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + (size_t(by) * c.bw_pad + bx) * 64, c.q,
                   out.data() + size_t(by) * 8 * stride + bx * 8, stride);
    return out;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): before its IDCT
  // each block's first nine AC coefficients that are still zero and not
  // known exactly are estimated from the DC values of the 5x5 blocks around
  // it (ITU T.81 K.8 on a wider window); with no AC data at all, the DC too
  // is smoothed. The rows and columns past the image repeat its edge, in the
  // block rows the way libjpeg counts them within an iMCU row.
  void smoothed_plane(const Component& c, uint8_t* out, int stride) const {
    // rows past the last good iMCU row take the bits from before the last
    // scan (its "prev" latch: -1 after a single scan)
    int prev[10];
    for (int k = 0; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    const int v = c.v, total = mcus_y;  // iMCU rows
    const int* bits = c.coef_bits;
    bool change_dc = true;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                  Q02 = c.q[2];
    int64_t Q03 = 0, Q12 = 0, Q21 = 0, Q30 = 0;
    int latched = -1;  // which bits the Q0x above were set for
    auto dc = [&](int by, int bx) { return int(c.coef[(size_t(by) * c.bw_pad + bx) * 64]); };
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return pred;
    };
    const int last_col = c.bw - 1;
    int16_t ws[64];
    for (int by = 0; by < c.bh; by++) {
      int imcu = by / v, br = by % v;
      int which = imcu > last_good_imcu ? 1 : 0;
      if (which != latched) {
        latched = which;
        bits = which ? prev : c.coef_bits;
        change_dc = true;
        for (int k = 1; k < 10; k++)
          if (bits[k] != -1) change_dc = false;
        Q03 = change_dc ? c.q[3] : 0;
        Q12 = change_dc ? c.q[10] : 0;
        Q21 = change_dc ? c.q[17] : 0;
        Q30 = change_dc ? c.q[24] : 0;
      }
      int rows = v;
      if (imcu == total - 1) {
        rows = c.bh % v;
        if (rows == 0) rows = v;
      }
      int ibr = imcu * rows + br, ibrs = rows * total;
      int r0 = by, rp = ibr > 0 ? by - 1 : r0, rpp = ibr > 1 ? by - 2 : rp;
      int rn = ibr < ibrs - 1 ? by + 1 : r0, rnn = ibr < ibrs - 2 ? by + 2 : rn;
      const int rr[5] = {rpp, rp, r0, rn, rnn};
      int DC[26];  // DC[1..25]: the 5x5 window, row by row
      for (int r = 0; r < 5; r++)
        for (int k = 1; k <= 5; k++) DC[r * 5 + k] = dc(rr[r], 0);
      for (int bx = 0; bx <= last_col; bx++) {
        memcpy(ws, c.coef.data() + (size_t(by) * c.bw_pad + bx) * 64, sizeof(ws));
        if (bx == 0 && bx < last_col)
          for (int r = 0; r < 5; r++) DC[r * 5 + 4] = DC[r * 5 + 5] = dc(rr[r], 1);
        if (bx + 1 < last_col)
          for (int r = 0; r < 5; r++) DC[r * 5 + 5] = dc(rr[r], bx + 2);
        const int *d = DC;
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10] -
               3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
               13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25]) :
              (-7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]));
          ws[1] = int16_t(estimate(num, Q01, al));
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] + 38 * d[8] +
               13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] +
               d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]) :
              (-7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]));
          ws[8] = int16_t(estimate(num, Q10, al));
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc ?
              (d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] - 5 * d[14] +
               2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]) :
              (-d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]));
          ws[16] = int16_t(estimate(num, Q20, al));
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc ?
              (-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25]) :
              (d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24] + d[4] -
               d[6] + 10 * d[7] - 10 * d[9]));
          ws[9] = int16_t(estimate(num, Q11, al));
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc ?
              (2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] + 7 * d[14] +
               d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]) :
              (-d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]));
          ws[2] = int16_t(estimate(num, Q02, al));
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0) {
            int64_t num = Q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
            ws[3] = int16_t(estimate(num, Q03, al));
          }
          if ((al = bits[7]) != 0 && ws[10] == 0) {
            int64_t num = Q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
            ws[10] = int16_t(estimate(num, Q12, al));
          }
          if ((al = bits[8]) != 0 && ws[17] == 0) {
            int64_t num = Q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
            ws[17] = int16_t(estimate(num, Q21, al));
          }
          if ((al = bits[9]) != 0 && ws[24] == 0) {
            int64_t num = Q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
            ws[24] = int16_t(estimate(num, Q30, al));
          }
          int64_t num = Q00 *
              (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
               42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
               42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
               6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
          int pred = num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8))
                              : -int(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = int16_t(pred);
        }
        idct_islow(ws, c.q, out + size_t(by) * 8 * stride + bx * 8, stride);
        for (int r = 0; r < 5; r++)
          for (int k = 1; k < 5; k++) DC[r * 5 + k] = DC[r * 5 + k + 1];
      }
    }
  }

  // The component upsampled to (at least) width x height, as jdsample.c does
  // with do_fancy_upsampling; row stride `width`.
  std::vector<uint8_t> upsampled(const Component& c) const {
    std::vector<uint8_t> src = plane(c);
    int sstride = c.bw_pad * (lossless ? 1 : 8);
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
      // int_upsample: each sample replicated rh x rv (lossless files too:
      // jdsample.c upsamples fancily only where a block is wider than 1)
      if (rh > 2 || rv > 2 || (lossless && rh * rv > 1)) {
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
// qie_jpeg_info). A non-zero plain_cmyk sets the colour space of a
// 4-component file to CMYK (Pillow's jpegmode "CMYK"): no YCCK transform
// whatever the Adobe marker says. Returns 0, or -1 with a message in err.
int qie_jpeg_decode(const uint8_t* data, long n, int plain_cmyk, uint8_t* out, char* err,
                    int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.plain_cmyk = plain_cmyk != 0;
    d.parse();
    d.output(out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// One JPEG strip or tile of a TIFF as libtiff's tif_jpeg.c decodes it:
// `tables` (tn bytes, the JPEGTables stream; tn 0 for none) read first, then
// the strip's own stream, whose end reads as a fake EOI (libtiff's source
// manager: append FF D9 to `data`). The frame must have `spp` components,
// the first sampled hs x vs and the rest 1 x 1, at most `width` columns and
// `rows` rows, or more rows in the last strip, which libtiff cuts to `rows`.
// Both streams end in libtiff's fake EOI markers: the caller appends FF D9
// pairs to each. `ycbcr` converts YCbCr to RGB (JPEGCOLORMODE_RGB), else the components
// pass through. out: rows x width x (1 or 3), of which a smaller frame
// writes its own rows and columns only. Returns 0, or -1 with err.
int qie_tiff_jpeg(const uint8_t* tables, long tn, const uint8_t* data, long n, int ycbcr,
                  int hs, int vs, int spp, int width, int rows, int last, uint8_t* out,
                  char* err, int errlen) {
  try {
    Decoder d(data, size_t(n));
    d.force_cs = ycbcr ? 2 : 1;
    if (tn > 0) d.load_tables(tables, size_t(tn));
    d.parse(true);
    if (d.ncomp != spp)
      throw CodecError("corrupt TIFF: a JPEG strip of " + std::to_string(d.ncomp) +
                       " components for " + std::to_string(spp) + " samples");
    for (int i = 0; i < d.ncomp; i++)  // libtiff reads the frame header's factors
      if (d.comp[i].sof_h != (i ? 1 : hs) || d.comp[i].sof_v != (i ? 1 : vs))
        throw CodecError("corrupt TIFF: improper JPEG sampling factors (libtiff's check)");
    // JPEGPreDecode: a smaller frame is decoded with a warning, a taller one
    // only in the last strip (cut to it), anything larger refused
    bool const taller_last = d.width == width && d.height > rows && last;
    if (!taller_last && (d.width > width || d.height > rows))
      throw CodecError("corrupt TIFF: a " + std::to_string(d.width) + "x" +
                       std::to_string(d.height) + " JPEG in a " + std::to_string(width) + "x" +
                       std::to_string(rows) + " strip or tile");
    Decoder full(data, size_t(n));
    full.force_cs = d.force_cs;
    if (tn > 0) full.load_tables(tables, size_t(tn));
    full.parse();
    int const c = spp == 1 ? 1 : 3;
    if (full.width == width && full.height == rows) {
      full.output(out);
    } else {  // each of the frame's rows (up to the strip's) at the start of a
              // strip row; the rest of out keeps what it held
      std::vector<uint8_t> all(size_t(full.width) * full.height * c);
      full.output(all.data());
      for (int r = 0; r < std::min(full.height, rows); r++)
        memcpy(out + size_t(r) * width * c, all.data() + size_t(r) * full.width * c,
               size_t(full.width) * c);
    }
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
