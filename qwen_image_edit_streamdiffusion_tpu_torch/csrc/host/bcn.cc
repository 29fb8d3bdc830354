// The block-compressed DDS surfaces on the host (core/codec.py reads the
// header and picks the kind): BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4
// (ATI1), BC5 and BC5S (ATI2), BC6H and BC6HS, and BC7, each 4x4 block
// decoded as Pillow's bcn decoder decodes it, written from the block
// layouts:
//
// - BC1 colours: two 5:6:5 endpoints widened by bit replication, the two
//   between them by integer thirds where the first endpoint is the larger
//   (always in BC2 and BC3), else their integer mean and transparent black;
// - BC2 alpha: 4 bits a pixel, replicated to 8;
// - BC3 alpha and each BC4 / BC5 channel: two 8-bit endpoints and 3-bit
//   indices, six interpolated values by integer sevenths where the first
//   is the larger, else four by fifths and then 0 and 255; BC5S reads the
//   endpoints as signed and adds 128;
// - BC7: the mode is the first set bit of the first byte (a zero byte is
//   opaque black), then the mode's partition, rotation, index selection,
//   endpoints, p-bits and two index sets, as the format defines them;
// - BC6H: the mode from the first 2 or 5 bits (a reserved one is
//   transparent black), its endpoint bits, transformed (delta) endpoints
//   added to the first and masked to its width, unquantized signed or
//   not, one or two regions (BC7's first 32 two-subset partitions and
//   anchors), 3- or 4-bit indices; then each half float to 8 bits as
//   Pillow maps it: the finished 16-bit value (x 31/64, or x 31/32 with
//   its sign) read as a half, clipped to 0..1 and truncated x 255.
//
// Pixels past the image's right or bottom edge are dropped. The output is
// RGB, what Pillow's convert("RGB") keeps of its RGBA, L or RGB image.
// Every entry point returns 0, or a negative value with a message in `err`.

#include <cmath>
#include <cstring>
#include <utility>

#include "codec_common.h"

namespace {

using qie::CodecError;

struct Rgba {
  uint8_t r, g, b, a;
};

void rgb565(Rgba* p, uint32_t v) {
  uint8_t r = uint8_t((v & 0xf800) >> 8), g = uint8_t((v & 0x7e0) >> 3),
          b = uint8_t((v & 0x1f) << 3);
  p->r = uint8_t(r | (r >> 5));
  p->g = uint8_t(g | (g >> 6));
  p->b = uint8_t(b | (b >> 5));
  p->a = 255;
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  uint32_t c0 = qie::le16(src), c1 = qie::le16(src + 2), lut = qie::le32(src + 4);
  Rgba p[4];
  rgb565(&p[0], c0);
  rgb565(&p[1], c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3),
            255};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3),
            255};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// An interpolated 8-bit channel (BC3 alpha, BC4, each half of BC5) into
// byte `o` of each of 16 pixels `stride` bytes apart.
void bc3_channel(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0 = sign ? int(int8_t(src[0])) + 128 : src[0];
  int a1 = sign ? int(int8_t(src[1])) + 128 : src[1];
  uint8_t a[8] = {uint8_t(a0), uint8_t(a1)};
  if (a0 > a1) {
    for (int k = 1; k <= 6; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  uint32_t lut1 = qie::le24(src + 2), lut2 = qie::le24(src + 5);
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (n + 8) + o] = a[7 & (lut2 >> (3 * n))];
}

// BC7: (subsets, partition bits, rotation bits, index selection bits,
// colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
// second index bits) of modes 0-7
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// the subset of each pixel (bit n, or bits 2n and 2n + 1) of each partition
constexpr uint16_t kBc7Subsets2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
constexpr uint32_t kBc7Subsets3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
// the anchor pixels (whose index drops its top bit) of subset 1 of two, and
// of subsets 1 and 2 of three
constexpr uint8_t kBc7Anchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8,  2,  2,  8,
    8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,
    2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
constexpr uint8_t kBc7Anchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,  3,  3,  8,  15, 3,  3,
    6,  10, 5,  8,  8,  6,  8,  5,  15, 15, 8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,
    15, 15, 15, 15, 3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
constexpr uint8_t kBc7Anchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8,  15, 3,  15, 8,
    15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15,
    3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
constexpr uint8_t kWeights2[4] = {0, 21, 43, 64};
constexpr uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

// `count` (at most 8) bits from bit `bit` on, least significant first
uint8_t bits_at(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  uint32_t x = src[by];
  if (bit + count > 8) x |= uint32_t(src[by + 1]) << 8;
  return uint8_t((x >> bit) & ((1u << count) - 1));
}

// a quantized endpoint of `bits` widened to 8 by replicating its top bits
uint8_t widen(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | (v >> bits));
}

int bc7_subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kBc7Subsets2[partition] >> n);
  if (ns == 3) return 3 & (kBc7Subsets3[partition] >> (2 * n));
  return 0;
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {  // no mode bit: opaque black
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) bit++;
  const Bc7Mode& m = kBc7Modes[bit];
  bit++;
  auto load = [&](int n) {
    uint8_t v = bits_at(src, bit, n);
    bit += n;
    return v;
  };
  int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
  int cb = m.cb, ab = m.ab, numep = m.ns * 2;
  Rgba ep[6];
  for (int i = 0; i < numep; i++) ep[i].r = load(cb);
  for (int i = 0; i < numep; i++) ep[i].g = load(cb);
  for (int i = 0; i < numep; i++) ep[i].b = load(cb);
  for (int i = 0; i < numep; i++) ep[i].a = ab ? load(ab) : 255;
  auto pbit = [&](Rgba& e, uint8_t v) {
    e.r = uint8_t(e.r << 1 | v);
    e.g = uint8_t(e.g << 1 | v);
    e.b = uint8_t(e.b << 1 | v);
    if (ab) e.a = uint8_t(e.a << 1 | v);
  };
  if (m.epb) {
    for (int i = 0; i < numep; i++) pbit(ep[i], load(1));
  }
  if (m.spb) {
    for (int i = 0; i < numep; i += 2) {
      uint8_t v = load(1);
      pbit(ep[i], v);
      pbit(ep[i + 1], v);
    }
  }
  if (m.epb || m.spb) {
    cb++;
    if (ab) ab++;
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = widen(ep[i].r, cb);
    ep[i].g = widen(ep[i].g, cb);
    ep[i].b = widen(ep[i].b, cb);
    if (ab) ep[i].a = widen(ep[i].a, ab);
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int cibit = bit, aibit = bit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    int s = bc7_subset(m.ns, partition, i) << 1;
    int ib = m.ib;
    if (i == 0 || (m.ns == 2 && i == kBc7Anchor2[partition]) ||
        (m.ns == 3 && (i == kBc7Anchor3a[partition] || i == kBc7Anchor3b[partition])))
      ib--;
    int i0 = bits_at(src, cibit, ib);
    cibit += ib;
    int wc = cw[i0], wa = cw[i0];
    if (ab && m.ib2) {
      int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
      int i1 = bits_at(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wa = aw[i1];
      }
    }
    const Rgba& e0 = ep[s];
    const Rgba& e1 = ep[s + 1];
    Rgba& d = col[i];
    d.r = uint8_t(((64 - wc) * e0.r + wc * e1.r + 32) >> 6);
    d.g = uint8_t(((64 - wc) * e0.g + wc * e1.g + 32) >> 6);
    d.b = uint8_t(((64 - wc) * e0.b + wc * e1.b + 32) >> 6);
    d.a = uint8_t(((64 - wa) * e0.a + wa * e1.a + 32) >> 6);
    if (rotation == 1) std::swap(d.r, d.a);
    if (rotation == 2) std::swap(d.g, d.a);
    if (rotation == 3) std::swap(d.b, d.a);
  }
}

// BC6H: (regions, transformed endpoints, endpoint bits, delta bits of red,
// green and blue) of modes 1-14, and where each endpoint bit lies. Endpoint
// fields are numbered r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3 (region 0 from
// 0 to 1, region 1 from 2 to 3); a run {field, first, last} takes the
// stream's next bits into bits `first` to `last` of the field, stepping
// down where `first` is the larger (modes 13 and 14 store their top bits
// reversed).
struct Bc6Mode {
  int ns, transformed, epb, rb, gb, bb;
};
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, 5, 5, 5}, {2, 1, 7, 6, 6, 6},  {2, 1, 11, 5, 4, 4}, {2, 1, 11, 4, 5, 4},
    {2, 1, 11, 4, 4, 5}, {2, 1, 9, 5, 5, 5},  {2, 1, 8, 6, 5, 5},  {2, 1, 8, 5, 6, 5},
    {2, 1, 8, 5, 5, 6},  {2, 0, 6, 6, 6, 6},  {1, 0, 10, 10, 10, 10}, {1, 1, 11, 9, 9, 9},
    {1, 1, 12, 8, 8, 8}, {1, 1, 16, 4, 4, 4}};
struct Bc6Run {
  uint8_t field, first, last;
};
enum : uint8_t { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };
// each mode's runs, ended by a run of field 255
constexpr Bc6Run kBc6Layout[14][26] = {
    {{G2, 4, 4}, {B2, 4, 4}, {B3, 4, 4}, {R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 4},
     {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 4}, {B3, 1, 1},
     {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3}, {255, 0, 0}},
    {{G2, 5, 5}, {G3, 4, 5}, {R0, 0, 6}, {B3, 0, 1}, {B2, 4, 4}, {G0, 0, 6}, {B2, 5, 5},
     {B3, 2, 2}, {G2, 4, 4}, {B0, 0, 6}, {B3, 3, 3}, {B3, 5, 5}, {B3, 4, 4}, {R1, 0, 5},
     {G2, 0, 3}, {G1, 0, 5}, {G3, 0, 3}, {B1, 0, 5}, {B2, 0, 3}, {R2, 0, 5}, {R3, 0, 5},
     {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 4}, {R0, 10, 10}, {G2, 0, 3}, {G1, 0, 3},
     {G0, 10, 10}, {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 3}, {B0, 10, 10}, {B3, 1, 1}, {B2, 0, 3},
     {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 10, 10}, {G3, 4, 4}, {G2, 0, 3},
     {G1, 0, 4}, {G0, 10, 10}, {G3, 0, 3}, {B1, 0, 3}, {B0, 10, 10}, {B3, 1, 1}, {B2, 0, 3},
     {R2, 0, 3}, {B3, 0, 0}, {B3, 2, 2}, {R3, 0, 3}, {G2, 4, 4}, {B3, 3, 3}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 10, 10}, {B2, 4, 4}, {G2, 0, 3},
     {G1, 0, 3}, {G0, 10, 10}, {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 4}, {B0, 10, 10}, {B2, 0, 3},
     {R2, 0, 3}, {B3, 1, 2}, {R3, 0, 3}, {B3, 4, 4}, {B3, 3, 3}, {255, 0, 0}},
    {{R0, 0, 8}, {B2, 4, 4}, {G0, 0, 8}, {G2, 4, 4}, {B0, 0, 8}, {B3, 4, 4}, {R1, 0, 4},
     {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 4}, {B3, 1, 1},
     {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3}, {255, 0, 0}},
    {{R0, 0, 7}, {G3, 4, 4}, {B2, 4, 4}, {G0, 0, 7}, {B3, 2, 2}, {G2, 4, 4}, {B0, 0, 7},
     {B3, 3, 4}, {R1, 0, 5}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 4},
     {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 5}, {R3, 0, 5}, {255, 0, 0}},
    {{R0, 0, 7}, {B3, 0, 0}, {B2, 4, 4}, {G0, 0, 7}, {G2, 5, 5}, {G2, 4, 4}, {B0, 0, 7},
     {G3, 5, 5}, {B3, 4, 4}, {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 5}, {G3, 0, 3},
     {B1, 0, 4}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3},
     {255, 0, 0}},
    {{R0, 0, 7}, {B3, 1, 1}, {B2, 4, 4}, {G0, 0, 7}, {B2, 5, 5}, {G2, 4, 4}, {B0, 0, 7},
     {B3, 5, 5}, {B3, 4, 4}, {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0},
     {G3, 0, 3}, {B1, 0, 5}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3},
     {255, 0, 0}},
    {{R0, 0, 5}, {G3, 4, 4}, {B3, 0, 1}, {B2, 4, 4}, {G0, 0, 5}, {G2, 5, 5}, {B2, 5, 5},
     {B3, 2, 2}, {G2, 4, 4}, {B0, 0, 5}, {G3, 5, 5}, {B3, 3, 3}, {B3, 5, 5}, {B3, 4, 4},
     {R1, 0, 5}, {G2, 0, 3}, {G1, 0, 5}, {G3, 0, 3}, {B1, 0, 5}, {B2, 0, 3}, {R2, 0, 5},
     {R3, 0, 5}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 9}, {G1, 0, 9}, {B1, 0, 9}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 8}, {R0, 10, 10}, {G1, 0, 8}, {G0, 10, 10},
     {B1, 0, 8}, {B0, 10, 10}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 7}, {R0, 11, 10}, {G1, 0, 7}, {G0, 11, 10},
     {B1, 0, 7}, {B0, 11, 10}, {255, 0, 0}},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 15, 10}, {G1, 0, 3}, {G0, 15, 10},
     {B1, 0, 3}, {B0, 15, 10}, {255, 0, 0}}};

int sign_extend(int v, int bits) { return (v & (1 << (bits - 1))) ? v - (1 << bits) : v; }

// an endpoint of `bits` to 16 bits (unsigned) or 15 bits and a sign
int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  v = int16_t(uint16_t(v));  // the endpoints are 16-bit words, read as signed
  if (bits >= 16) return v;
  bool neg = v < 0;
  if (neg) v = -v;
  int u = v == 0 ? 0 : v >= (1 << (bits - 1)) - 1 ? 0x7fff : ((v << 15) + 0x4000) >> (bits - 1);
  return neg ? -u : u;
}

// a finished value is at most 0x7bff in magnitude: never infinite or NaN
float half_to_float(uint16_t h) {
  int e = (h >> 10) & 31, m = h & 1023;
  float v = std::ldexp(float(e ? m | 1024 : m), (e ? e : 1) - 25);
  return (h & 0x8000) ? -v : v;
}

// a half float to 8 bits as Pillow's bcn decoder maps it
uint8_t bc6_byte(int v, bool sign) {
  uint16_t h;
  if (sign)
    h = uint16_t(v < 0 ? 0x8000 | ((-v) * 31 / 32) : v * 31 / 32);
  else
    h = uint16_t(v * 31 / 64);
  float f = half_to_float(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else {
    mode = (mode & 3) == 2 ? 2 + (mode >> 2) : 10 + (mode >> 2);
  }
  if (mode >= 14) {  // a reserved mode
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (const Bc6Run* r = kBc6Layout[mode]; r->field != 255; r++) {
    int step = r->first <= r->last ? 1 : -1;
    for (int b = r->first;; b += step) {
      ep[r->field] |= bits_at(src, bit++, 1) << b;
      if (b == r->last) break;
    }
  }
  int numep = m.ns * 6, partition = bits_at(src, bit, m.ns == 2 ? 5 : 0);
  bit += m.ns == 2 ? 5 : 0;
  const int delta[3] = {m.rb, m.gb, m.bb}, mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.transformed)
    for (int i = 3; i < numep; i++) ep[i] = sign_extend(ep[i], delta[i % 3]);
  if (m.transformed) {
    for (int i = 3; i < numep; i++) ep[i] = (ep[i] + ep[i % 3]) & mask;
  }
  for (int i = 0; i < numep; i++) ep[i] = bc6_unquantize(ep[i], m.epb, sign);
  const int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; i++) {
    int s = bc7_subset(m.ns, partition, i) * 6, n = ib;
    if (i == 0 || (m.ns == 2 && i == kBc7Anchor2[partition])) n--;
    int wt = w[bits_at(src, bit, n)];
    bit += n;
    uint8_t c[3];
    for (int k = 0; k < 3; k++)
      c[k] = bc6_byte((ep[s + k] * (64 - wt) + ep[s + 3 + k] * wt) >> 6, sign);
    col[i] = {c[0], c[1], c[2], 255};
  }
}

// One block of kind `n` (1-5, 7) into 16 RGBA pixels.
void block(int n, bool sign, const uint8_t* src, Rgba* col) {
  memset(col, sign ? 128 : 0, 16 * sizeof(Rgba));
  uint8_t* bytes = reinterpret_cast<uint8_t*>(col);
  switch (n) {
    case 1:
      bc1_colour(col, src, false);
      break;
    case 2: {
      bc1_colour(col, src + 8, true);
      for (int i = 0; i < 16; i++) {
        uint8_t v = 0xf & (src[i / 2] >> (4 * (i & 1)));
        col[i].a = uint8_t(v << 4 | v);
      }
      break;
    }
    case 3:
      bc1_colour(col, src + 8, true);
      bc3_channel(bytes, src, 4, 3, false);
      break;
    case 4:
      bc3_channel(bytes, src, 4, 0, false);
      for (int i = 0; i < 16; i++) col[i].g = col[i].b = col[i].r;  // L
      break;
    case 5:
      bc3_channel(bytes, src, 4, 0, sign);
      bc3_channel(bytes, src + 8, 4, 1, sign);
      break;
    case 6:
      bc6_block(col, src, sign);
      break;
    case 7:
      bc7_block(col, src);
      break;
    default:
      throw CodecError("unsupported DDS: block kind " + std::to_string(n));
  }
}

// The first surface: ceil(w / 4) x ceil(h / 4) blocks of 8 bytes (BC1,
// BC4) or 16, left to right, top to bottom, into `out` (h, w, 3).
void bcn(const uint8_t* p, size_t n, int64_t w, int64_t h, int kind, bool sign, uint8_t* out) {
  const size_t size = (kind == 1 || kind == 4) ? 8 : 16;
  const int64_t across = (w + 3) / 4, down = (h + 3) / 4;
  if (n / size < size_t(across * down))
    throw CodecError("truncated DDS: the blocks end before the image is full");
  Rgba col[16];
  for (int64_t by = 0; by < down; by++) {
    for (int64_t bx = 0; bx < across; bx++, p += size) {
      block(kind, sign, p, col);
      for (int j = 0; j < 4 && by * 4 + j < h; j++) {
        uint8_t* row = out + ((by * 4 + j) * w + bx * 4) * 3;
        for (int i = 0; i < 4 && bx * 4 + i < w; i++) {
          row[3 * i] = col[4 * j + i].r;
          row[3 * i + 1] = col[4 * j + i].g;
          row[3 * i + 2] = col[4 * j + i].b;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int qie_bcn(const uint8_t* data, long n, long w, long h, int kind, int sign, uint8_t* out,
            char* err, int errlen) {
  try {
    bcn(data, size_t(n), w, h, kind, sign != 0, out);
    return 0;
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
