// WebP decoding for the serving wire, on the host, to the RGB bytes that
// Pillow's Image.open(...).convert("RGB") gives (its WebPImagePlugin over
// libwebp's WebPAnimDecoder; core/imaging.py of the JAX package).
//
// - The RIFF container as libwebp's demuxer reads it: the simple form (one
//   VP8 or VP8L chunk) and the extended one (VP8X): a still image (ALPH +
//   VP8, or VP8L) the size of the canvas, or, with the animation flag, the
//   first ANMF frame at its offset on a transparent black canvas (what
//   WebPAnimDecoder gives as the first frame). The EXIF and XMP chunks are
//   reported for ImageOps.exif_transpose. Data past the RIFF size is
//   ignored; data short of it is a truncated file.
// - VP8L (lossless, the WebP lossless bitstream specification): the four
//   transforms (predictor, cross colour, subtract green, colour indexing),
//   the colour cache, meta Huffman codes and LZ77 backward references, with
//   libwebp's checks (complete prefix codes, references inside the image,
//   no read past the data).
// - VP8 (lossy key frames, RFC 6386, as libwebp's decoder runs them): the
//   boolean decoder, segments, the token partitions, the coefficient tokens
//   and their probability updates, the intra predictors (16x16, 4x4 and
//   chroma, with libwebp's frame-edge samples), the inverse WHT and DCT, the
//   simple and normal loop filters; then libwebp's fancy upsampling
//   (dsp/upsampling.c) and fixed-point YUV->RGB (dsp/yuv.h).
// - ALPH: decoded (raw or VP8L-coded) only so that a corrupt one is refused
//   as libwebp refuses it; Pillow's convert("RGB") drops the alpha, and the
//   RGB of a WebP does not depend on it.
//
// A plain C interface, loaded with ctypes by core/codec.py beside
// image_codec.cc. Every entry point returns a negative value and writes a
// message into `err` on failure.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "codec_common.h"

namespace {

using qie::CodecError;
using qie::le16;
using qie::le24;
using qie::le32;

[[noreturn]] void truncated(const char* what) {
  throw CodecError(std::string("truncated WebP: ") + what);
}
[[noreturn]] void corrupt(const std::string& what) { throw CodecError("corrupt WebP: " + what); }

inline uint32_t tag(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

// ---------------------------------------------------------------------------
// VP8L
// ---------------------------------------------------------------------------

// Bits least significant first; a read past the data gives zeros and marks
// the stream ended (libwebp's eos_, an error wherever libwebp checks it).
struct LBits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // in bits
  bool eos = false;

  LBits(const uint8_t* data, size_t len) : d(data), n(len) {}
  uint32_t bit() {
    if (pos >= 8 * n) {
      eos = true;
      pos++;
      return 0;
    }
    uint32_t b = (d[pos >> 3] >> (pos & 7)) & 1;
    pos++;
    return b;
  }
  uint32_t read(int bits) {
    uint32_t v = 0;
    if (pos + bits <= 8 * n && bits <= 24) {
      // up to 24 bits from the (at most four) bytes that hold them
      size_t byte = pos >> 3;
      uint64_t w = 0;
      for (int i = 0; i < 4 && byte + i < n; i++) w |= uint64_t(d[byte + i]) << (8 * i);
      v = uint32_t(w >> (pos & 7)) & ((1u << bits) - 1);
      pos += bits;
      return v;
    }
    for (int i = 0; i < bits; i++) v |= bit() << i;
    return v;
  }
  void check(const char* what) const {
    if (eos) truncated(what);
  }
};

// A canonical prefix code: a 10-bit table for the short codes, the counts
// and the sorted symbols for the long ones (read bit by bit, as DEFLATE's).
struct Prefix {
  static constexpr int kTableBits = 10;
  int single = -1;  // the one symbol of a one-symbol code (read with no bits)
  std::vector<uint32_t> table;  // (length << 16) | symbol; 0: longer
  int count[16] = {0};
  std::vector<uint16_t> sorted;

  // libwebp's BuildHuffmanTable: false for an empty, over-subscribed or
  // incomplete code
  bool build(const int* lengths, int n) {
    std::fill(count, count + 16, 0);
    for (int s = 0; s < n; s++) count[lengths[s]]++;
    if (count[0] == n) return false;
    sorted.clear();
    for (int l = 1; l < 16; l++)
      for (int s = 0; s < n; s++)
        if (lengths[s] == l) sorted.push_back(uint16_t(s));
    if (sorted.size() == 1) {
      single = sorted[0];
      return true;
    }
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left = 2 * left - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    table.assign(1 << kTableBits, 0);
    int code = 0, k = 0;
    for (int l = 1; l < 16; l++) {
      for (int i = 0; i < count[l]; i++, k++, code++) {
        if (l > kTableBits) continue;
        int rev = 0;  // the code's bits in the order they are read
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int fill = rev; fill < (1 << kTableBits); fill += 1 << l)
          table[fill] = (uint32_t(l) << 16) | sorted[k];
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    if (br.pos + kTableBits <= 8 * br.n) {
      size_t byte = br.pos >> 3;
      uint32_t w = 0;
      for (int i = 0; i < 3 && byte + i < br.n; i++) w |= uint32_t(br.d[byte + i]) << (8 * i);
      uint32_t e = table[(w >> (br.pos & 7)) & ((1 << kTableBits) - 1)];
      if (e) {
        br.pos += e >> 16;
        return int(e & 0xFFFF);
      }
    }
    // bit by bit: the code's first bits are its most significant
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; l++) {
      code |= int(br.bit());
      if (code - first < count[l]) return sorted[index + code - first];
      index += count[l];
      first = (first + count[l]) << 1;
      code <<= 1;
    }
    corrupt("bad prefix code");
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};  // green (+ cache), red, blue, alpha, distance

// the (dx, dy) of the first 120 distance codes, as (dy << 4) | (8 - dx)
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct VP8L {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  VP8L(const uint8_t* d, size_t n) : br(d, n) {}

  // ReadHuffmanCode: the code lengths of one alphabet, simple or coded
  Prefix read_code(int alphabet) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {
      int symbols = int(br.read(1)) + 1;
      int first = int(br.read(br.read(1) ? 8 : 1));
      if (first < alphabet) lengths[first] = 1;
      if (symbols == 2) {
        int second = int(br.read(8));
        if (second < alphabet) lengths[second] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      int num = int(br.read(4)) + 4;
      for (int i = 0; i < num; i++) cl_lengths[kCodeLengthOrder[i]] = int(br.read(3));
      Prefix cl;
      if (!cl.build(cl_lengths, 19)) corrupt("bad code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * int(br.read(3));
        max_symbol = 2 + int(br.read(nbits));
        if (max_symbol > alphabet) corrupt("code lengths past the alphabet");
      }
      int prev = 8;
      for (int s = 0; s < alphabet;) {
        if (max_symbol-- == 0) break;
        int len = cl.read(br);
        if (len < 16) {
          lengths[s++] = len;
          if (len) prev = len;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int repeat = int(br.read(extra[len - 16])) + offset[len - 16];
          if (s + repeat > alphabet) corrupt("code lengths past the alphabet");
          int value = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = value;
        }
        if (br.eos) break;
      }
    }
    br.check("a prefix code ends early");
    Prefix p;
    if (!p.build(lengths.data(), alphabet)) corrupt("bad prefix code");
    return p;
  }

  // DecodeImageStream: transforms (level 0 only), colour cache, prefix
  // codes (meta codes at level 0 only) and the LZ77-coded pixels
  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) {
        int type = int(br.read(2));
        if (seen & (1u << type)) corrupt("a transform appears twice");
        seen |= 1u << type;
        Transform t{type, 0, xsize, {}};
        if (type == 0 || type == 1) {
          t.bits = int(br.read(3)) + 2;
          t.data = image_stream(sub_sample(xsize, t.bits), sub_sample(ysize, t.bits), false);
        } else if (type == 3) {
          int colors = int(br.read(8)) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image_stream(colors, 1, false);
          // ExpandColorMap: delta-coded, padded with transparent black
          t.data.assign(size_t(1) << (8 >> t.bits), 0);
          for (int i = 0; i < colors && i < int(t.data.size()); i++) {
            uint32_t v = pal[i];
            if (i) {
              uint32_t p = t.data[i - 1];
              v = (((v & 0xFF00FF00u) + (p & 0xFF00FF00u)) & 0xFF00FF00u) |
                  (((v & 0x00FF00FFu) + (p & 0x00FF00FFu)) & 0x00FF00FFu);
            }
            t.data[i] = v;
          }
          xsize = sub_sample(xsize, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) corrupt("colour cache size");
    }
    // meta prefix codes: a group index for each tile
    int meta_bits = 0, meta_w = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = int(br.read(3)) + 2;
      meta_w = sub_sample(xsize, meta_bits);
      meta = image_stream(meta_w, sub_sample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xFFFF;
        groups = std::max(groups, int(m) + 1);
      }
    }
    br.check("the prefix codes end early");
    std::vector<Prefix> codes;
    codes.reserve(size_t(groups) * 5);
    for (int g = 0; g < groups; g++)
      for (int j = 0; j < 5; j++)
        codes.push_back(read_code(kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0)));
    std::vector<uint32_t> px(size_t(xsize) * ysize);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    const size_t total = px.size();
    size_t i = 0;
    int x = 0, y = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (i < total) {
      const Prefix* g = &codes[0];
      if (meta_bits) g = &codes[size_t(meta[size_t(y >> meta_bits) * meta_w + (x >> meta_bits)]) * 5];
      int code = g[0].read(br);
      if (code < 256) {
        uint32_t red = uint32_t(g[1].read(br)), blue = uint32_t(g[2].read(br)),
                 alpha = uint32_t(g[3].read(br));
        px[i] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
        insert(px[i]);
        i++;
        if (++x == xsize) {
          x = 0;
          y++;
        }
      } else if (code < 256 + 24) {
        size_t length = copy_distance(code - 256);
        int dist_code = int(copy_distance(g[4].read(br)));
        size_t dist;
        if (dist_code > 120) {
          dist = size_t(dist_code - 120);
        } else {
          int c = kCodeToPlane[dist_code - 1];
          long d = long(c >> 4) * xsize + (8 - (c & 15));
          dist = d >= 1 ? size_t(d) : 1;
        }
        if (br.eos) break;
        if (dist > i || length > total - i) corrupt("a backward reference leaves the image");
        for (size_t k = 0; k < length; k++, i++) {
          px[i] = px[i - dist];
          insert(px[i]);
        }
        x += int(length % size_t(xsize));
        y += int(length / size_t(xsize));
        if (x >= xsize) {
          x -= xsize;
          y++;
        }
      } else {
        size_t key = size_t(code - 256 - 24);
        if (key >= cache.size()) corrupt("colour cache index");
        px[i] = cache[key];
        insert(px[i]);
        i++;
        if (++x == xsize) {
          x = 0;
          y++;
        }
      }
      if (br.eos) break;
    }
    br.check("the image data ends early");
    return px;
  }

  size_t copy_distance(int symbol) {
    if (symbol < 4) return size_t(symbol) + 1;
    int extra = (symbol - 2) >> 1;
    size_t offset = size_t(2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  // The inverse transforms, last read first, on the decoded h rows.
  void invert(std::vector<uint32_t>& px, int h) {
    for (int t = int(transforms.size()) - 1; t >= 0; t--) {
      Transform& tr = transforms[t];
      const int xs = tr.xsize;
      if (tr.type == 0) {
        predict(px, xs, h, tr);
      } else if (tr.type == 1) {
        const int tiles = sub_sample(xs, tr.bits);
        for (int y = 0; y < h; y++)
          for (int x = 0; x < xs; x++) {
            uint32_t m = tr.data[size_t(y >> tr.bits) * tiles + (x >> tr.bits)];
            int8_t g2r = int8_t(m & 0xFF), g2b = int8_t((m >> 8) & 0xFF),
                   r2b = int8_t((m >> 16) & 0xFF);
            uint32_t& a = px[size_t(y) * xs + x];
            int8_t green = int8_t((a >> 8) & 0xFF);
            int red = int((a >> 16) & 0xFF), blue = int(a & 0xFF);
            red = (red + ((int(g2r) * green) >> 5)) & 0xFF;
            blue += (int(g2b) * green) >> 5;
            blue += (int(r2b) * int8_t(red)) >> 5;
            blue &= 0xFF;
            a = (a & 0xFF00FF00u) | (uint32_t(red) << 16) | uint32_t(blue);
          }
      } else if (tr.type == 2) {
        for (uint32_t& a : px) {
          uint32_t g = (a >> 8) & 0xFF;
          uint32_t rb = ((a & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu;
          a = (a & 0xFF00FF00u) | rb;
        }
      } else {
        // colour indexing: packed indices in green, `bits` of them a pixel
        const int packed_w = sub_sample(xs, tr.bits);
        std::vector<uint32_t> out(size_t(xs) * h);
        const int per = 1 << tr.bits, bpp = 8 >> tr.bits, mask = (1 << bpp) - 1;
        for (int y = 0; y < h; y++)
          for (int x = 0; x < xs; x++) {
            uint32_t g = (px[size_t(y) * packed_w + (x >> tr.bits)] >> 8) & 0xFF;
            int index = int(g >> ((x & (per - 1)) * bpp)) & mask;
            out[size_t(y) * xs + x] = tr.data[size_t(index)];
          }
        px.swap(out);
      }
    }
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
           (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
  }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t per_channel(uint32_t a, uint32_t b, uint32_t c, int kind) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      int x = int((a >> s) & 0xFF), y = int((b >> s) & 0xFF), z = int((c >> s) & 0xFF);
      // kind 0: ClampAddSubtractFull(x, y, z); 1: ClampAddSubtractHalf(x, y)
      int v = kind == 0 ? clip255(x + y - z) : clip255(x + (x - y) / 2);
      out |= uint32_t(v) << s;
    }
    return out;
  }
  static uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8) {
      int a = int((t >> s) & 0xFF), b = int((l >> s) & 0xFF), c = int((tl >> s) & 0xFF);
      pa_minus_pb += std::abs(b - c) - std::abs(a - c);
    }
    return pa_minus_pb <= 0 ? t : l;
  }

  static void predict(std::vector<uint32_t>& px, int w, int h, const Transform& tr) {
    const int tiles = sub_sample(w, tr.bits);
    for (int y = 0; y < h; y++) {
      uint32_t* row = px.data() + size_t(y) * w;
      const uint32_t* top = y ? row - w : nullptr;
      for (int x = 0; x < w; x++) {
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xFF000000u : row[x - 1];
        } else if (x == 0) {
          pred = top[0];
        } else {
          int mode = int((tr.data[size_t(y >> tr.bits) * tiles + (x >> tr.bits)] >> 8) & 15);
          uint32_t L = row[x - 1], T = top[x], TL = top[x - 1];
          uint32_t TR = top[x + 1];  // at the last column: this row's first pixel
          switch (mode) {
            case 1: pred = L; break;
            case 2: pred = T; break;
            case 3: pred = TR; break;
            case 4: pred = TL; break;
            case 5: pred = avg2(avg2(L, TR), T); break;
            case 6: pred = avg2(L, TL); break;
            case 7: pred = avg2(L, T); break;
            case 8: pred = avg2(TL, T); break;
            case 9: pred = avg2(T, TR); break;
            case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
            case 11: pred = select(T, L, TL); break;
            case 12: pred = per_channel(L, T, TL, 0); break;
            case 13: pred = per_channel(avg2(L, T), TL, 0, 1); break;
            default: pred = 0xFF000000u; break;  // 0, and 14 and 15 as libwebp
          }
        }
        row[x] = add(row[x], pred);
      }
    }
  }

  // A whole VP8L bitstream (header included): ARGB pixels, width and height.
  std::vector<uint32_t> decode(int* w, int* h) {
    if (br.n < 5 || br.read(8) != 0x2f) corrupt("bad VP8L signature");
    *w = int(br.read(14)) + 1;
    *h = int(br.read(14)) + 1;
    br.read(1);  // alpha_is_used: a hint
    if (br.read(3) != 0) corrupt("VP8L version");
    qie::check_pixels("WebP", *w, *h);
    return image(*w, *h);
  }

  // The level-0 image stream of a w x h image, transforms inverted.
  std::vector<uint32_t> image(int w, int h) {
    std::vector<uint32_t> px = image_stream(w, h, true);
    invert(px, h);
    return px;
  }
};

// ---------------------------------------------------------------------------
// VP8: the boolean decoder
// ---------------------------------------------------------------------------

// libwebp's VP8BitReader, a byte at a time: `value` holds the bits read,
// `bits` how many lie below the 8-bit window; needing a byte past the data
// marks eof (a decode error wherever libwebp checks it).
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // the range minus one
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = (value << 8) | *p++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int bit = v > split;
    if (bit) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get(0x80)) << n;
    return v;
  }
  int signed_bits(int n) {
    int v = int(value_bits(n));
    return get(0x80) ? -v : v;
  }
};

// the default token probabilities [type][band][context][node] (RFC 6386 13.5)
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228,
    219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126,
    227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219,
    128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236,
    224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251,
    255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128,
    128, 128, 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171,
    128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243,
    255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1,
    1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162,
    160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149,
    167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128, 184, 141,
    234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255,
    128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202,
    128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255,
    128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201,
    253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94,
    136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128,
    128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234,
    128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255,
    236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128, 45,
    99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128,
    128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128,
    128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185,
    249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253,
    212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155,
    77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128,
    128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228,
    128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213,
    255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16, 248,
    255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255,
    255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191,
    220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219,
    151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166,
    109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255,
    255, 128, 1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250,
    221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219,
    240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108,
    170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203,
    128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235,
    205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236,
    253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128,
    128, 128, 128, 128};

// the probabilities that a frame updates each of them (RFC 6386 13.4)
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255,
    255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251,
    251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254, 249,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255,
    255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};

// key-frame 4x4 mode probabilities [top][left][node], modes in the B_* order
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69,
    143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44,
    195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96,
    182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32,
    75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43,
    26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27, 217,
    255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117,
    85, 38, 35, 179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93,
    77, 39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32,
    26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16,
    76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148,
    31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245,
    209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171, 41, 40, 5, 102,
    211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44,
    229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21,
    116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15,
    32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9,
    115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130,
    226, 64, 90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26,
    133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1,
    118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21,
    23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85,
    117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81, 171, 1, 57,
    17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110,
    90, 47, 114, 115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57,
    18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34,
    53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28,
    64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8,
    17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154,
    133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224, 45, 183,
    128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155,
    60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146,
    171, 18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35,
    99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118, 146,
    116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101,
    38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219,
    1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};

constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,
    20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,
    35,  36,  37,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,
    71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,
    89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124,
    126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,
    23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
    42,  43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,
    64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100,
    102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
    152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217,
    221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// intra modes in libwebp's order (dec/common_dec.h)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------
// VP8: prediction and transforms on a work buffer of stride kBps
// ---------------------------------------------------------------------------

constexpr int kBps = 32;

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; j++) memset(dst + j * kBps, v, size_t(size));
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; y++)
    for (int x = 0; x < size; x++)
      dst[y * kBps + x] = clip8(top[x] + dst[y * kBps - 1] - top[-1]);
}

// 16x16 luma or 8x8 chroma: DC (with libwebp's frame-edge variants), TM, V, H
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; j++) dc += dst[j * kBps - 1] + dst[j - kBps];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; j++) dc += dst[j * kBps - 1];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; j++) dc += dst[j - kBps];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOTOPLEFT: fill(dst, size, 0x80); break;
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; j++) memcpy(dst + j * kBps, dst - kBps, size_t(size));
      break;
    case B_HE:
      for (int j = 0; j < size; j++) memset(dst + j * kBps, dst[j * kBps - 1], size_t(size));
      break;
  }
}

// dsp/dec.c's 4x4 predictors
void predict4(uint8_t* dst, int mode) {
  auto D = [&](int x, int y) -> uint8_t& { return dst[x + y * kBps]; };
  const uint8_t* top = dst - kBps;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], Dd = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * kBps];
      for (int i = 0; i < 4; i++) memset(dst + i * kBps, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)),
                            uint8_t(avg3(B, C, Dd)), uint8_t(avg3(C, Dd, E))};
      for (int i = 0; i < 4; i++) memcpy(dst + i * kBps, v, 4);
      break;
    }
    case B_HE: {
      const int r[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 4; i++) memset(dst + i * kBps, r[i], 4);
      break;
    }
    case B_RD:
      D(0, 3) = uint8_t(avg3(J, K, L));
      D(1, 3) = D(0, 2) = uint8_t(avg3(I, J, K));
      D(2, 3) = D(1, 2) = D(0, 1) = uint8_t(avg3(X, I, J));
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = uint8_t(avg3(A, X, I));
      D(3, 2) = D(2, 1) = D(1, 0) = uint8_t(avg3(B, A, X));
      D(3, 1) = D(2, 0) = uint8_t(avg3(C, B, A));
      D(3, 0) = uint8_t(avg3(Dd, C, B));
      break;
    case B_LD:
      D(0, 0) = uint8_t(avg3(A, B, C));
      D(1, 0) = D(0, 1) = uint8_t(avg3(B, C, Dd));
      D(2, 0) = D(1, 1) = D(0, 2) = uint8_t(avg3(C, Dd, E));
      D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = uint8_t(avg3(Dd, E, F));
      D(3, 1) = D(2, 2) = D(1, 3) = uint8_t(avg3(E, F, G));
      D(3, 2) = D(2, 3) = uint8_t(avg3(F, G, H));
      D(3, 3) = uint8_t(avg3(G, H, H));
      break;
    case B_VR:
      D(0, 0) = D(1, 2) = uint8_t(avg2(X, A));
      D(1, 0) = D(2, 2) = uint8_t(avg2(A, B));
      D(2, 0) = D(3, 2) = uint8_t(avg2(B, C));
      D(3, 0) = uint8_t(avg2(C, Dd));
      D(0, 3) = uint8_t(avg3(K, J, I));
      D(0, 2) = uint8_t(avg3(J, I, X));
      D(0, 1) = D(1, 3) = uint8_t(avg3(I, X, A));
      D(1, 1) = D(2, 3) = uint8_t(avg3(X, A, B));
      D(2, 1) = D(3, 3) = uint8_t(avg3(A, B, C));
      D(3, 1) = uint8_t(avg3(B, C, Dd));
      break;
    case B_VL:
      D(0, 0) = uint8_t(avg2(A, B));
      D(1, 0) = D(0, 2) = uint8_t(avg2(B, C));
      D(2, 0) = D(1, 2) = uint8_t(avg2(C, Dd));
      D(3, 0) = D(2, 2) = uint8_t(avg2(Dd, E));
      D(0, 1) = uint8_t(avg3(A, B, C));
      D(1, 1) = D(0, 3) = uint8_t(avg3(B, C, Dd));
      D(2, 1) = D(1, 3) = uint8_t(avg3(C, Dd, E));
      D(3, 1) = D(2, 3) = uint8_t(avg3(Dd, E, F));
      D(3, 2) = uint8_t(avg3(E, F, G));
      D(3, 3) = uint8_t(avg3(F, G, H));
      break;
    case B_HD:
      D(0, 0) = D(2, 1) = uint8_t(avg2(I, X));
      D(0, 1) = D(2, 2) = uint8_t(avg2(J, I));
      D(0, 2) = D(2, 3) = uint8_t(avg2(K, J));
      D(0, 3) = uint8_t(avg2(L, K));
      D(3, 0) = uint8_t(avg3(A, B, C));
      D(2, 0) = uint8_t(avg3(X, A, B));
      D(1, 0) = D(3, 1) = uint8_t(avg3(I, X, A));
      D(1, 1) = D(3, 2) = uint8_t(avg3(J, I, X));
      D(1, 2) = D(3, 3) = uint8_t(avg3(K, J, I));
      D(1, 3) = uint8_t(avg3(L, K, J));
      break;
    case B_HU:
      D(0, 0) = uint8_t(avg2(I, J));
      D(2, 0) = D(0, 1) = uint8_t(avg2(J, K));
      D(2, 1) = D(0, 2) = uint8_t(avg2(K, L));
      D(1, 0) = uint8_t(avg3(I, J, K));
      D(3, 0) = D(1, 1) = uint8_t(avg3(J, K, L));
      D(3, 1) = D(1, 2) = uint8_t(avg3(K, L, L));
      D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = uint8_t(L);
      break;
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the inverse DCT of one 4x4 block added to dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* o = dst + i * kBps;
    o[0] = clip8(o[0] + ((a + d) >> 3));
    o[1] = clip8(o[1] + ((b + c) >> 3));
    o[2] = clip8(o[2] + ((b - c) >> 3));
    o[3] = clip8(o[3] + ((a - d) >> 3));
  }
}

// TransformWHT: the 16 luma DCs from the Y2 block, into out[16 * k]
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ---------------------------------------------------------------------------
// VP8: loop filters (dsp/dec.c), on a plane of stride `st`
// ---------------------------------------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `size` pixels along an edge: hstride across it, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                  int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (mb_edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

// ---------------------------------------------------------------------------
// VP8: the frame
// ---------------------------------------------------------------------------

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;  // the non-zero contexts (libwebp's VP8MB)
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0, segment = 0;
  bool is_i4x4 = false, skip = false;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  // segment and filter headers
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  struct FInfo {
    int limit = 0, ilevel = 0, hev = 0;
    bool inner = false;
  } fstrength[4][2];
  // the decoded planes, whole macroblocks
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;

  void headers(const uint8_t* d, size_t n) {
    if (n < 10) truncated("the VP8 frame header ends early");
    const uint32_t bits = le24(d);
    const bool key = !(bits & 1);
    const int profile = int((bits >> 1) & 7);
    const bool show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (!key) throw CodecError("unsupported WebP: a VP8 frame that is not a key frame");
    if (profile > 3) corrupt("VP8 profile " + std::to_string(profile));
    if (!show) throw CodecError("unsupported WebP: an invisible VP8 frame");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) corrupt("bad VP8 start code");
    width = int(le16(d + 6) & 0x3fff);
    height = int(le16(d + 8) & 0x3fff);
    qie::check_pixels("WebP", width, height);
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = d + 10;
    size_t left = n - 10;
    if (part0 > left) truncated("the first VP8 partition ends early");
    br.init(buf, part0);
    buf += part0;
    left -= part0;
    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type
    // segment header
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {
        absolute_delta = br.get(0x80);
        for (int s = 0; s < 4; s++) seg_quant[s] = br.get(0x80) ? br.signed_bits(7) : 0;
        for (int s = 0; s < 4; s++) seg_filter[s] = br.get(0x80) ? br.signed_bits(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; s++) seg_proba[s] = uint8_t(br.get(0x80) ? br.value_bits(8) : 255);
    }
    if (br.eof) truncated("cannot parse the VP8 segment header");
    // filter header
    simple = br.get(0x80);
    level = int(br.value_bits(6));
    sharpness = int(br.value_bits(3));
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int i = 0; i < 4; i++)
        if (br.get(0x80)) ref_lf_delta[i] = br.signed_bits(6);
      for (int i = 0; i < 4; i++)
        if (br.get(0x80)) mode_lf_delta[i] = br.signed_bits(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) truncated("cannot parse the VP8 filter header");
    // token partitions
    const int last = (1 << br.value_bits(2)) - 1;
    if (left < size_t(3 * last)) truncated("the VP8 partition sizes end early");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t size_left = left - 3 * last;
    parts.assign(size_t(last) + 1, BoolReader());
    for (int p = 0; p < last; p++) {
      size_t psize = le24(sz + 3 * p);
      if (psize > size_left) psize = size_left;
      parts[p].init(start, psize);
      start += psize;
      size_left -= psize;
    }
    parts[last].init(start, size_left);
    if (size_left == 0) truncated("the last VP8 partition is empty");
    // quantizers (VP8ParseQuant)
    const int base_q0 = int(br.value_bits(7));
    int dq[5];
    for (int& v : dq) v = br.get(0x80) ? br.signed_bits(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; i++) {
      int q;
      if (use_segment) {
        q = seg_quant[i] + (absolute_delta ? 0 : base_q0);
      } else if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
    br.get(0x80);  // refresh entropy probs: ignored for a lone key frame
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++) {
            const int k = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = uint8_t(br.get(kCoeffsUpdateProba[k]) ? br.value_bits(8)
                                                                      : kCoeffsProba0[k]);
          }
    use_skip = br.get(0x80);
    if (use_skip) skip_p = int(br.value_bits(8));
    // PrecomputeFilterStrengths
    if (filter_type > 0) {
      for (int s = 0; s < 4; s++) {
        int base = use_segment ? seg_filter[s] + (absolute_delta ? 0 : level) : level;
        for (int i4 = 0; i4 <= 1; i4++) {
          FInfo& f = fstrength[s][i4];
          int lv = base;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int il = lv;
            if (sharpness > 0) {
              il >>= sharpness > 4 ? 2 : 1;
              if (il > 9 - sharpness) il = 9 - sharpness;
            }
            if (il < 1) il = 1;
            f.ilevel = il;
            f.limit = 2 * lv + il;
            f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            f.limit = 0;
          }
          f.inner = i4 != 0;
        }
      }
    }
  }

  void parse_modes(MBData& mb, uint8_t* top, uint8_t* left) {
    mb.segment = 0;
    if (update_map)
      mb.segment = uint8_t(!br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                                  : br.get(seg_proba[2]) + 2);
    mb.skip = use_skip ? br.get(skip_p) : false;
    mb.is_i4x4 = !br.get(145);
    if (!mb.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
      mb.imodes[0] = uint8_t(ymode);
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      for (int y = 0; y < 4; y++) {
        int ymode = left[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !br.get(prob[0]) ? B_DC
                : !br.get(prob[1]) ? B_TM
                : !br.get(prob[2]) ? B_VE
                : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                : (!br.get(prob[6]) ? B_LD
                   : (!br.get(prob[7]) ? B_VL : (!br.get(prob[8]) ? B_HD : B_HU)));
          top[x] = uint8_t(ymode);
        }
        memcpy(mb.imodes + 4 * y, top, 4);
        left[y] = uint8_t(ymode);
      }
    }
    mb.uvmode = uint8_t(!br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE);
  }

  int large_value(BoolReader& r, const uint8_t* p) {
    int v;
    if (!r.get(p[3])) {
      v = !r.get(p[4]) ? 2 : 3 + r.get(p[5]);
    } else if (!r.get(p[6])) {
      if (!r.get(p[7])) {
        v = 5 + r.get(159);
      } else {
        v = 7 + 2 * r.get(165);
        v += r.get(145);
      }
    } else {
      const int bit1 = r.get(p[8]);
      const int bit0 = r.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + r.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the tokens of one block from position n, dequantized into
  // out (natural order); the position after the last non-zero one
  int coeffs(BoolReader& r, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!r.get(p[0])) return n;
      while (!r.get(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      const int next_band = kBands[n + 1];
      if (!r.get(p[2])) {
        v = 1;
        p = proba[type][next_band][1];
      } else {
        v = large_value(r, p);
        p = proba[type][next_band][2];
      }
      out[kZigzag[n]] = int16_t((r.get(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  // ParseResiduals; top/left are the column's and the row's MBInfo
  void residuals(BoolReader& r, MBData& mb, MBInfo& top, MBInfo& left) {
    const Quant& q = dqm[mb.segment];
    int16_t* dst = mb.coeffs;
    memset(dst, 0, sizeof(mb.coeffs));
    int first, type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top.nz_dc + left.nz_dc;
      const int nz = coeffs(r, 1, ctx, q.y2, 0, dc);
      top.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        iwht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    uint32_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; y++) {
      uint32_t l = lnz & 1, nzc = 0;
      for (int x = 0; x < 4; x++) {
        const int ctx = int(l + (tnz & 1));
        const int nz = coeffs(r, type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = uint32_t(top.nz) >> (4 + ch);
      lnz = uint32_t(left.nz) >> (4 + ch);
      for (int y = 0; y < 2; y++) {
        uint32_t l = lnz & 1;
        for (int x = 0; x < 2; x++) {
          const int ctx = int(l + (tnz & 1));
          const int nz = coeffs(r, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t |= (tnz << 4) << ch;
      out_l |= (lnz & 0xf0) << ch;
    }
    top.nz = uint8_t(out_t);
    left.nz = uint8_t(out_l);
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
  }

  // ReconstructRow for one macroblock, from the unfiltered planes
  void reconstruct(const MBData& mb, int mb_x, int mb_y) {
    uint8_t yw[kBps * 17], uw[kBps * 9], vw[kBps * 9];
    uint8_t* y_dst = yw + kBps + 8;
    uint8_t* u_dst = uw + kBps + 8;
    uint8_t* v_dst = vw + kBps + 8;
    const int x0 = mb_x * 16, y0 = mb_y * 16, cx0 = mb_x * 8, cy0 = mb_y * 8;
    // left samples: the previous macroblock's, else 129
    for (int j = 0; j < 16; j++)
      y_dst[j * kBps - 1] = mb_x ? Y[size_t(y0 + j) * ys + x0 - 1] : 129;
    for (int j = 0; j < 8; j++) {
      u_dst[j * kBps - 1] = mb_x ? U[size_t(cy0 + j) * uvs + cx0 - 1] : 129;
      v_dst[j * kBps - 1] = mb_x ? V[size_t(cy0 + j) * uvs + cx0 - 1] : 129;
    }
    // top samples (and top-left, top-right): the row above's, else 127
    if (mb_y) {
      const uint8_t* ya = &Y[size_t(y0 - 1) * ys];
      const uint8_t* ua = &U[size_t(cy0 - 1) * uvs];
      const uint8_t* va = &V[size_t(cy0 - 1) * uvs];
      memcpy(y_dst - kBps, ya + x0, 16);
      memcpy(u_dst - kBps, ua + cx0, 8);
      memcpy(v_dst - kBps, va + cx0, 8);
      y_dst[-kBps - 1] = mb_x ? ya[x0 - 1] : 129;
      u_dst[-kBps - 1] = mb_x ? ua[cx0 - 1] : 129;
      v_dst[-kBps - 1] = mb_x ? va[cx0 - 1] : 129;
      if (mb_x < mb_w - 1) memcpy(y_dst - kBps + 16, ya + x0 + 16, 4);
      else memset(y_dst - kBps + 16, ya[x0 + 15], 4);
    } else {
      memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
      memset(u_dst - kBps - 1, 127, 8 + 1);
      memset(v_dst - kBps - 1, 127, 8 + 1);
    }
    auto check_mode = [&](int mode) {
      if (mode != B_DC) return mode;
      if (mb_x == 0) return mb_y == 0 ? int(DC_NOTOPLEFT) : int(DC_NOLEFT);
      return mb_y == 0 ? int(DC_NOTOP) : int(B_DC);
    };
    if (mb.is_i4x4) {
      // the top-right samples of the macroblock, repeated for the right
      // column's blocks below the first
      for (int r = 1; r <= 3; r++) memcpy(y_dst + (4 * r - 1) * kBps + 16, y_dst - kBps + 16, 4);
      for (int n = 0; n < 16; n++) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        predict4(dst, mb.imodes[n]);
        idct_add(mb.coeffs + n * 16, dst);
      }
    } else {
      predict_block(y_dst, 16, check_mode(mb.imodes[0]));
      for (int n = 0; n < 16; n++)
        idct_add(mb.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps);
    }
    const int uvmode = check_mode(mb.uvmode);
    predict_block(u_dst, 8, uvmode);
    predict_block(v_dst, 8, uvmode);
    for (int n = 0; n < 4; n++) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
      idct_add(mb.coeffs + 256 + n * 16, u_dst + off);
      idct_add(mb.coeffs + 320 + n * 16, v_dst + off);
    }
    for (int j = 0; j < 16; j++) memcpy(&Y[size_t(y0 + j) * ys + x0], y_dst + j * kBps, 16);
    for (int j = 0; j < 8; j++) {
      memcpy(&U[size_t(cy0 + j) * uvs + cx0], u_dst + j * kBps, 8);
      memcpy(&V[size_t(cy0 + j) * uvs + cx0], v_dst + j * kBps, 8);
    }
  }

  // DoFilter for one macroblock of the reconstructed planes
  void loop_filter(const FInfo& f, int mb_x, int mb_y) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = &Y[size_t(mb_y * 16) * ys + mb_x * 16];
    if (filter_type == 1) {
      if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_edge(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u = &U[size_t(mb_y * 8) * uvs + mb_x * 8];
    uint8_t* v = &V[size_t(mb_y * 8) * uvs + mb_x * 8];
    const int il = f.ilevel, hv = f.hev;
    if (mb_x > 0) {
      complex_edge(y, 1, ys, 16, limit + 4, il, hv, true);
      complex_edge(u, 1, uvs, 8, limit + 4, il, hv, true);
      complex_edge(v, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) complex_edge(y + 4 * k, 1, ys, 16, limit, il, hv, false);
      complex_edge(u + 4, 1, uvs, 8, limit, il, hv, false);
      complex_edge(v + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      complex_edge(y, ys, 1, 16, limit + 4, il, hv, true);
      complex_edge(u, uvs, 1, 8, limit + 4, il, hv, true);
      complex_edge(v, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) complex_edge(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      complex_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      complex_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  void decode(const uint8_t* d, size_t n) {
    headers(d, n);
    ys = mb_w * 16;
    uvs = mb_w * 8;
    Y.assign(size_t(ys) * mb_h * 16, 0);
    U.assign(size_t(uvs) * mb_h * 8, 0);
    V.assign(size_t(uvs) * mb_h * 8, 0);
    std::vector<uint8_t> intra_t(size_t(mb_w) * 4, B_DC);
    std::vector<MBInfo> top(static_cast<size_t>(mb_w));
    std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
    MBData mb;
    for (int mb_y = 0; mb_y < mb_h; mb_y++) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      MBInfo left;
      BoolReader& tr = parts[size_t(mb_y) & (parts.size() - 1)];
      for (int mb_x = 0; mb_x < mb_w; mb_x++) {
        parse_modes(mb, &intra_t[size_t(mb_x) * 4], intra_l);
        bool skip = mb.skip;
        if (!skip) {
          residuals(tr, mb, top[mb_x], left);
          skip = !(mb.non_zero_y | mb.non_zero_uv);
        } else {
          memset(mb.coeffs, 0, sizeof(mb.coeffs));
          left.nz = top[mb_x].nz = 0;
          if (!mb.is_i4x4) left.nz_dc = top[mb_x].nz_dc = 0;
        }
        if (filter_type > 0) {
          FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
          f = fstrength[mb.segment][mb.is_i4x4];
          f.inner = f.inner || !skip;
        }
        reconstruct(mb, mb_x, mb_y);
      }
      if (br.eof) truncated("the first VP8 partition ends early");
      if (tr.eof) truncated("a VP8 token partition ends early");
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; mb_y++)
        for (int mb_x = 0; mb_x < mb_w; mb_x++)
          loop_filter(finfo[size_t(mb_y) * mb_w + mb_x], mb_x, mb_y);
  }

  // EmitFancyRGB over the whole picture: libwebp's fancy upsampler and
  // YUV->RGB into rgb (stride `stride` bytes, 3 a pixel)
  void to_rgb(uint8_t* rgb, size_t stride) const {
    auto mult_hi = [](int v, int c) { return (v * c) >> 8; };
    auto clip = [](int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; };
    auto put = [&](int y, int u, int v, uint8_t* o) {
      o[0] = uint8_t(clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
      o[1] = uint8_t(clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
      o[2] = uint8_t(clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
    };
    const int len = width;
    // UpsampleRgbLinePair: top row `ty` from uv rows (tu, tv) near and (cu,
    // cv) far; the bottom row `by` (if any) the other way round
    auto pair = [&](const uint8_t* ty, const uint8_t* by, const uint8_t* tu, const uint8_t* tv,
                    const uint8_t* cu, const uint8_t* cv, uint8_t* tdst, uint8_t* bdst) {
      const int last_pair = (len - 1) >> 1;
      uint32_t tl_uv = uint32_t(tu[0]) | (uint32_t(tv[0]) << 16);
      uint32_t l_uv = uint32_t(cu[0]) | (uint32_t(cv[0]) << 16);
      {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        put(ty[0], int(uv0 & 0xff), int(uv0 >> 16), tdst);
      }
      if (by) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        put(by[0], int(uv0 & 0xff), int(uv0 >> 16), bdst);
      }
      for (int x = 1; x <= last_pair; x++) {
        const uint32_t t_uv = uint32_t(tu[x]) | (uint32_t(tv[x]) << 16);
        const uint32_t uv = uint32_t(cu[x]) | (uint32_t(cv[x]) << 16);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
          const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
          const uint32_t uv1 = (diag_03 + t_uv) >> 1;
          put(ty[2 * x - 1], int(uv0 & 0xff), int(uv0 >> 16), tdst + (2 * x - 1) * 3);
          put(ty[2 * x], int(uv1 & 0xff), int(uv1 >> 16), tdst + (2 * x) * 3);
        }
        if (by) {
          const uint32_t uv0 = (diag_03 + l_uv) >> 1;
          const uint32_t uv1 = (diag_12 + uv) >> 1;
          put(by[2 * x - 1], int(uv0 & 0xff), int(uv0 >> 16), bdst + (2 * x - 1) * 3);
          put(by[2 * x], int(uv1 & 0xff), int(uv1 >> 16), bdst + (2 * x) * 3);
        }
        tl_uv = t_uv;
        l_uv = uv;
      }
      if (!(len & 1)) {
        {
          const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
          put(ty[len - 1], int(uv0 & 0xff), int(uv0 >> 16), tdst + (len - 1) * 3);
        }
        if (by) {
          const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
          put(by[len - 1], int(uv0 & 0xff), int(uv0 >> 16), bdst + (len - 1) * 3);
        }
      }
    };
    auto yrow = [&](int r) { return &Y[size_t(r) * ys]; };
    auto urow = [&](int r) { return &U[size_t(r) * uvs]; };
    auto vrow = [&](int r) { return &V[size_t(r) * uvs]; };
    pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgb, nullptr);
    int y = 0;
    for (; y + 2 < height; y += 2)
      pair(yrow(y + 1), yrow(y + 2), urow(y / 2), vrow(y / 2), urow(y / 2 + 1), vrow(y / 2 + 1),
           rgb + size_t(y + 1) * stride, rgb + size_t(y + 2) * stride);
    if (!(height & 1))
      pair(yrow(height - 1), nullptr, urow(y / 2), vrow(y / 2), urow(y / 2), vrow(y / 2),
           rgb + size_t(height - 1) * stride, nullptr);
  }
};

// ---------------------------------------------------------------------------
// ALPH: checked as libwebp's alpha decoder checks it
// ---------------------------------------------------------------------------

void check_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n < 1) truncated("the ALPH chunk is empty");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3,
            rsrv = (d[0] >> 6) & 3;
  (void)filter;  // every value is a filter
  if (method > 1 || pre > 1 || rsrv != 0) corrupt("bad ALPH header");
  if (method == 0) {
    if (n - 1 < size_t(w) * size_t(h)) truncated("the raw alpha ends early");
    return;
  }
  VP8L l(d + 1, n - 1);
  l.image(w, h);
}

// ---------------------------------------------------------------------------
// The RIFF container
// ---------------------------------------------------------------------------

// A chunk: its payload, and the payload with its pad byte where the file
// has it (what libwebp hands the VP8 and VP8L decoders of an image chunk).
struct Chunk {
  const uint8_t* data = nullptr;
  size_t size = 0, padded = 0;
};

struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  Chunk image, alpha;
  bool lossless = false;
};

constexpr int kAlphaFlag = 0x10, kAnimationFlag = 0x02, kExifFlag = 0x08, kXmpFlag = 0x04;
constexpr int kValidFlags = 0x3E;

// libwebp's demuxer (demux.c) over a whole file: its parse and validity
// rules, every frame's headers checked (WebPAnimDecoder refuses a file the
// demuxer refuses), the first frame kept.
struct WebP {
  const uint8_t* d = nullptr;
  size_t pos = 0, end = 0;  // the read position and the RIFF's end
  int flags = 0;
  int width = 0, height = 0;  // the canvas
  std::vector<Frame> frames;
  Chunk exif, xmp;

  size_t left() const { return end - pos; }
  uint32_t u32() {
    uint32_t v = le32(d + pos);
    pos += 4;
    return v;
  }

  // WebPGetFeatures on an image chunk: its size, and VP8L's alpha hint
  static void features(uint32_t fourcc, const Chunk& c, Frame* f) {
    if (fourcc == tag("VP8L")) {
      if (c.size < 5) truncated("the VP8L header ends early");
      LBits br(c.data, c.size);
      if (br.read(8) != 0x2f) corrupt("bad VP8L signature");
      f->w = int(br.read(14)) + 1;
      f->h = int(br.read(14)) + 1;
      br.read(1);
      if (br.read(3) != 0) corrupt("VP8L version");
      f->lossless = true;
      return;
    }
    if (c.size < 10) truncated("the VP8 frame header ends early");
    const uint8_t* p = c.data;
    const uint32_t bits = le24(p);
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) corrupt("bad VP8 start code");
    if (bits & 1) throw CodecError("unsupported WebP: a VP8 frame that is not a key frame");
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= c.size)
      corrupt("bad VP8 frame header");
    f->w = int(le16(p + 6) & 0x3fff);
    f->h = int(le16(p + 8) & 0x3fff);
    if (f->w == 0 || f->h == 0) corrupt("zero width or height");
  }

  // StoreFrame: an ALPH chunk, then VP8 or VP8L, from pos on; false when
  // neither is there. A frame must hold at least min_size bytes.
  bool store_frame(Frame* f, size_t min_size) {
    if (left() < 8 || left() < min_size) truncated("a frame ends early");
    bool have_alpha = false, have_image = false;
    for (;;) {
      const size_t chunk_start = pos;
      const uint32_t fourcc = u32(), size = u32();
      const size_t padded = size_t(size) + (size & 1);
      if (padded > left()) truncated("a chunk ends early");
      const Chunk c{d + pos, size, padded};
      if (fourcc == tag("ALPH") && !have_alpha) {
        have_alpha = true;
        f->alpha = c;
      } else if ((fourcc == tag("VP8 ") || fourcc == tag("VP8L")) && !have_image) {
        if (fourcc == tag("VP8L") && have_alpha) corrupt("an ALPH chunk before VP8L");
        have_image = true;
        f->image = c;
        features(fourcc, c, f);
      } else {
        pos = chunk_start;  // not this frame's: left for the caller
        break;
      }
      pos += padded;
      if (pos == end) break;
      if (left() < 8) truncated("a chunk header ends early");
    }
    if (have_alpha && !have_image) truncated("a frame without its image chunk");
    return have_image;
  }

  // ParseAnimationFrame: the ANMF header, then its frame
  void animation_frame(size_t padded) {
    if (padded < 16) corrupt("ANMF chunk size");
    Frame f;
    f.x = 2 * int(le24(d + pos));
    f.y = 2 * int(le24(d + pos + 3));
    if ((1 + uint64_t(le24(d + pos + 6))) * (1 + uint64_t(le24(d + pos + 9))) >= (uint64_t(1) << 32))
      corrupt("an ANMF frame's size");
    pos += 16;
    const size_t start = pos;
    const bool stored = store_frame(&f, padded - 16);
    if (pos - start > padded - 16) corrupt("an ANMF frame runs past its chunk");
    if (stored && (flags & kAnimationFlag)) frames.push_back(f);
  }

  void parse_vp8x() {
    pos += 4;
    const uint32_t size = u32();
    if (size < 10) corrupt("VP8X chunk size");
    const size_t padded = size_t(size) + (size & 1);
    if (padded > left()) truncated("the VP8X chunk ends early");
    flags = d[pos];
    width = 1 + int(le24(d + pos + 4));
    height = 1 + int(le24(d + pos + 7));
    qie::check_pixels("WebP", width, height);
    pos += padded;
    if (left() < 8) truncated("no chunk after VP8X");
    const bool animation = flags & kAnimationFlag;
    int anim_chunks = 0;
    for (;;) {
      const size_t chunk_start = pos;
      const uint32_t fourcc = u32(), csize = u32();
      const size_t cpadded = size_t(csize) + (csize & 1);
      if (cpadded > left()) truncated("a chunk ends early");
      if (fourcc == tag("VP8X")) {
        corrupt("a second VP8X chunk");
      } else if (fourcc == tag("ALPH") || fourcc == tag("VP8 ") || fourcc == tag("VP8L")) {
        if (anim_chunks > 0 || animation) corrupt("an image chunk outside ANMF in an animation");
        pos = chunk_start;
        single_image();
      } else if (fourcc == tag("ANIM")) {
        if (cpadded < 6) corrupt("ANIM chunk size");
        anim_chunks++;
        pos += cpadded;
      } else if (fourcc == tag("ANMF")) {
        if (anim_chunks == 0) corrupt("ANMF before ANIM");
        animation_frame(cpadded);
      } else {
        // the demuxer keeps EXIF and XMP only where VP8X's flags announce them
        if (fourcc == tag("EXIF") && (flags & kExifFlag) && !exif.data)
          exif = Chunk{d + pos, csize, cpadded};
        if (fourcc == tag("XMP ") && (flags & kXmpFlag) && !xmp.data)
          xmp = Chunk{d + pos, csize, cpadded};
        pos += cpadded;
      }
      if (pos == end) break;
      if (left() < 8) truncated("a chunk header ends early");
    }
    // IsValidExtendedFormat
    if (flags & ~kValidFlags) corrupt("reserved VP8X flags are set");
    if (frames.empty()) corrupt(animation ? "an animation without frames" : "no image in the file");
    for (const Frame& f : frames) {
      if (f.alpha.data && !f.image.data) corrupt("an ALPH chunk without an image");
      const bool exact = !animation;
      if (exact ? (f.x != 0 || f.y != 0 || f.w != width || f.h != height)
                : (f.x + f.w > width || f.y + f.h > height))
        corrupt(exact ? "the image's size differs from the canvas"
                      : "an ANMF frame leaves the canvas");
    }
  }

  // ParseSingleImage
  void single_image() {
    if (!frames.empty()) corrupt("a second image");
    if (left() < 8) truncated("no image chunk");
    Frame f;
    if (!store_frame(&f, 0)) corrupt("no image in the file");
    if (!(flags & kAlphaFlag)) f.alpha = Chunk();  // dropped where VP8X has no alpha flag
    frames.push_back(f);
  }

  void parse(const uint8_t* data, size_t n) {
    d = data;
    if (n < 12 || memcmp(d, "RIFF", 4) != 0 || memcmp(d + 8, "WEBP", 4) != 0)
      throw CodecError("not a WebP file");
    if (n < 20) truncated("the RIFF header ends early");
    const uint32_t riff = le32(d + 4);
    if (riff < 8) corrupt("RIFF size");
    if (size_t(riff) + 8 > n) truncated("the file is shorter than its RIFF size");
    end = size_t(riff) + 8;
    pos = 12;
    if (left() < 8) truncated("no chunks");
    const uint32_t first = le32(d + pos);
    if (first == tag("VP8X")) {
      parse_vp8x();
    } else if (first == tag("VP8 ") || first == tag("VP8L")) {
      single_image();
      width = frames[0].w;
      height = frames[0].h;
      qie::check_pixels("WebP", width, height);
    } else {
      corrupt("the first chunk is neither VP8, VP8L nor VP8X");
    }
  }

  // WebPAnimDecoder's first frame: decoded at its offset on a transparent
  // black canvas
  void decode(const uint8_t* data, size_t n, uint8_t* out) {
    parse(data, n);
    const Frame& f = frames[0];
    memset(out, 0, size_t(width) * height * 3);
    uint8_t* at = out + (size_t(f.y) * width + f.x) * 3;
    const size_t stride = size_t(width) * 3;
    if (f.lossless) {
      VP8L l(f.image.data, f.image.padded);
      int w, h;
      std::vector<uint32_t> argb = l.decode(&w, &h);
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          const uint32_t a = argb[size_t(y) * w + x];
          uint8_t* o = at + size_t(y) * stride + size_t(x) * 3;
          o[0] = uint8_t(a >> 16);
          o[1] = uint8_t(a >> 8);
          o[2] = uint8_t(a);
        }
      return;
    }
    VP8 v;
    v.decode(f.image.data, f.image.padded);
    if (f.alpha.data) check_alpha(f.alpha.data, f.alpha.size, f.w, f.h);
    v.to_rgb(at, stride);
  }
};

template <class F>
int guarded(char* err, int errlen, F f) {
  try {
    f();
    return 0;
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return -1;
  }
}

}  // namespace

extern "C" {

// Canvas width and height of a WebP and where its EXIF and XMP chunks'
// payloads lie (offset -1 when absent); 0, or -1 with a message in err.
int qie_webp_info(const uint8_t* data, long n, int* width, int* height, long* exif_off,
                  long* exif_len, long* xmp_off, long* xmp_len, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    WebP w;
    w.parse(data, size_t(n));
    *width = w.width;
    *height = w.height;
    *exif_off = w.exif.data ? long(w.exif.data - data) : -1;
    *exif_len = long(w.exif.size);
    *xmp_off = w.xmp.data ? long(w.xmp.data - data) : -1;
    *xmp_len = long(w.xmp.size);
  });
}

// Decode a WebP (its first frame) into out: height x width x 3 RGB.
int qie_webp_decode(const uint8_t* data, long n, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { WebP().decode(data, size_t(n), out); });
}

}  // extern "C"
