// TIFF strip and tile decompression for the serving wire, on the host.
//
// The port's counterpart of the libtiff codecs that Pillow reads a compressed
// TIFF through (core/imaging.py there opens every upload with Image.open):
//   - PackBits (tif_packbits.c PackBitsDecode);
//   - LZW as tif_lzw.c LZWDecode reads it: codes most significant bit first,
//     9 to 12 bits wide, the width growing one code early, a clear code
//     resetting the table; a strip that starts like the old-style
//     (compatibility) LZW is refused by name;
//   - CCITT modified Huffman RLE (compression 2: every row 1-D and
//     byte-aligned), Group 3 (compression 3: an EOL before every row, rows
//     1-D or, with T4Options bit 0, 1-D or 2-D by a tag bit) and Group 4
//     (compression 4: every row 2-D against the one above), from tif_fax3.c
//     and ITU T.4 / T.6. White runs are 0 bits, black runs 1 bits.
// A FillOrder of 2 reverses each input byte's bits first, as TIFFFillStrip
// does. Each strip or tile decodes to exactly the bytes it covers: its output
// is bounded by them, and data that ends short of them raises (libtiff's
// "Not enough data"), as do bad codes.
//
// Deflate and LZMA strips inflate in core/codec.py through Python's zlib and
// lzma; JPEG strips go through image_codec.cc.
//
// A plain C interface, loaded with ctypes by core/codec.py. Every entry point
// returns a negative value and writes a message into `err` on failure.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "codec_common.h"

namespace {

using qie::CodecError;

uint8_t reverse_bits(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// ---------------------------------------------------------------------------
// PackBits
// ---------------------------------------------------------------------------

void packbits(const uint8_t* in, long n, uint8_t* out, long occ) {
  long pos = 0;
  while (n - pos > 0 && occ > 0) {
    long c = in[pos++];
    if (c >= 128) c -= 256;
    if (c < 0) {  // the next byte repeated 1 - c times
      if (c == -128) continue;
      c = -c + 1;
      if (occ < c) c = occ;  // libtiff discards the rest
      if (pos >= n) break;
      memset(out, in[pos++], size_t(c));
      out += c;
      occ -= c;
    } else {  // the next c + 1 bytes as they are
      if (occ < c + 1) c = occ - 1;
      if (n - pos < c + 1) break;
      memcpy(out, in + pos, size_t(c + 1));
      out += c + 1;
      occ -= c + 1;
      pos += c + 1;
    }
  }
  if (occ > 0) throw CodecError("truncated TIFF: PackBits data ends short of its strip");
}

// ---------------------------------------------------------------------------
// LZW
// ---------------------------------------------------------------------------

void lzw(const uint8_t* in, long n, uint8_t* out, long occ) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1))
    throw CodecError("unsupported TIFF: old-style (compatibility) LZW");
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;  // libtiff's CSIZE
  // each code's string: its prefix code, last byte, first byte and length
  std::vector<int> prefix(kSize), length(kSize);
  std::vector<uint8_t> last(kSize), first(kSize);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    length[i] = 1;
    last[i] = first[i] = uint8_t(i);
  }
  int nbits = 9, free_code = kFirst, old = -1;
  long bitpos = 0, nbitsavail = n * 8;
  auto next_code = [&]() {
    if (nbitsavail - bitpos < nbits) return kEoi;  // out of data: as libtiff, an EOI
    long byte = bitpos >> 3;
    uint32_t acc = 0;
    for (int k = 0; k < 3; k++) acc = (acc << 8) | (byte + k < n ? in[byte + k] : 0);
    int code = int((acc >> (24 - (bitpos & 7) - nbits)) & ((1u << nbits) - 1));
    bitpos += nbits;
    return code;
  };
  std::vector<uint8_t> stack;
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_code = kFirst;
        nbits = 9;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) throw CodecError("corrupt TIFF: LZW code after a clear code is not a byte");
      *out++ = uint8_t(code);
      occ--;
      old = code;
      continue;
    }
    // libtiff starts a strip with no table: until a clear code every code is
    // one not yet in it
    if (old < 0) throw CodecError("corrupt TIFF: LZW data does not start with a clear code");
    if (code > free_code || free_code >= kSize)
      throw CodecError("corrupt TIFF: LZW code " + std::to_string(code) + " not yet in the table");
    // the new entry: old's string and the first byte of this code's string
    prefix[free_code] = old;
    first[free_code] = first[old];
    length[free_code] = length[old] + 1;
    last[free_code] = code < free_code ? first[code] : first[old];
    if (++free_code > (1 << nbits) - 2 && nbits < 12) nbits++;
    old = code;
    if (code < 256) {
      *out++ = uint8_t(code);
      occ--;
      continue;
    }
    // the string, written from its end; cut at the strip's end
    int len = length[code];
    stack.resize(size_t(len));
    int c = code;
    for (int i = len - 1; i >= 0; i--) {
      stack[size_t(i)] = last[c];
      c = prefix[c];
    }
    long take = len < occ ? len : occ;
    memcpy(out, stack.data(), size_t(take));
    out += take;
    occ -= take;
  }
  if (occ > 0) throw CodecError("truncated TIFF: LZW data ends short of its strip");
}

// ---------------------------------------------------------------------------
// CCITT Group 3 and 4 (ITU T.4 / T.6)
// ---------------------------------------------------------------------------

struct Code {
  const char* bits;
  int value;
};

// terminating (0..63) and make-up codes of white and of black runs
const Code kWhite[] = {
    {"00110101", 0},    {"000111", 1},      {"0111", 2},        {"1000", 3},
    {"1011", 4},        {"1100", 5},        {"1110", 6},        {"1111", 7},
    {"10011", 8},       {"10100", 9},       {"00111", 10},      {"01000", 11},
    {"001000", 12},     {"000011", 13},     {"110100", 14},     {"110101", 15},
    {"101010", 16},     {"101011", 17},     {"0100111", 18},    {"0001100", 19},
    {"0001000", 20},    {"0010111", 21},    {"0000011", 22},    {"0000100", 23},
    {"0101000", 24},    {"0101011", 25},    {"0010011", 26},    {"0100100", 27},
    {"0011000", 28},    {"00000010", 29},   {"00000011", 30},   {"00011010", 31},
    {"00011011", 32},   {"00010010", 33},   {"00010011", 34},   {"00010100", 35},
    {"00010101", 36},   {"00010110", 37},   {"00010111", 38},   {"00101000", 39},
    {"00101001", 40},   {"00101010", 41},   {"00101011", 42},   {"00101100", 43},
    {"00101101", 44},   {"00000100", 45},   {"00000101", 46},   {"00001010", 47},
    {"00001011", 48},   {"01010010", 49},   {"01010011", 50},   {"01010100", 51},
    {"01010101", 52},   {"00100100", 53},   {"00100101", 54},   {"01011000", 55},
    {"01011001", 56},   {"01011010", 57},   {"01011011", 58},   {"01001010", 59},
    {"01001011", 60},   {"00110010", 61},   {"00110011", 62},   {"00110100", 63},
    {"11011", 64},      {"10010", 128},     {"010111", 192},    {"0110111", 256},
    {"00110110", 320},  {"00110111", 384},  {"01100100", 448},  {"01100101", 512},
    {"01101000", 576},  {"01100111", 640},  {"011001100", 704}, {"011001101", 768},
    {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},   {"010011011", 1728}};
const Code kBlack[] = {
    {"0000110111", 0},     {"010", 1},            {"11", 2},             {"10", 3},
    {"011", 4},            {"0011", 5},           {"0010", 6},           {"00011", 7},
    {"000101", 8},         {"000100", 9},         {"0000100", 10},       {"0000101", 11},
    {"0000111", 12},       {"00000100", 13},      {"00000111", 14},      {"000011000", 15},
    {"0000010111", 16},    {"0000011000", 17},    {"0000001000", 18},    {"00001100111", 19},
    {"00001101000", 20},   {"00001101100", 21},   {"00000110111", 22},   {"00000101000", 23},
    {"00000010111", 24},   {"00000011000", 25},   {"000011001010", 26},  {"000011001011", 27},
    {"000011001100", 28},  {"000011001101", 29},  {"000001101000", 30},  {"000001101001", 31},
    {"000001101010", 32},  {"000001101011", 33},  {"000011010010", 34},  {"000011010011", 35},
    {"000011010100", 36},  {"000011010101", 37},  {"000011010110", 38},  {"000011010111", 39},
    {"000001101100", 40},  {"000001101101", 41},  {"000011011010", 42},  {"000011011011", 43},
    {"000001010100", 44},  {"000001010101", 45},  {"000001010110", 46},  {"000001010111", 47},
    {"000001100100", 48},  {"000001100101", 49},  {"000001010010", 50},  {"000001010011", 51},
    {"000000100100", 52},  {"000000110111", 53},  {"000000111000", 54},  {"000000100111", 55},
    {"000000101000", 56},  {"000001011000", 57},  {"000001011001", 58},  {"000000101011", 59},
    {"000000101100", 60},  {"000001011010", 61},  {"000001100110", 62},  {"000001100111", 63},
    {"0000001111", 64},    {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704},
    {"0000001001100", 768}, {"0000001001101", 832}, {"0000001110010", 896},
    {"0000001110011", 960}, {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600}, {"0000001100100", 1664},
    {"0000001100101", 1728}};
// make-up codes of either colour for runs of 1792 and more
const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// 2-D mode codes: pass, horizontal, vertical a1 - b1 = -3..3, extension
enum Mode { kPass = 100, kHoriz = 101, kExt = 102, kEol = -1000 };
const Code kModes[] = {{"0001", kPass}, {"001", kHoriz},    {"1", 0},         {"011", 1},
                       {"000011", 2},   {"0000011", 3},     {"010", -1},      {"000010", -2},
                       {"0000010", -3}, {"0000001", kExt}};

constexpr int kLookBits = 13;
constexpr int kBias = 2048;  // keeps every value of a lookup entry positive

// A code table as a lookup on the next 13 bits: (length << 16) | (value +
// kBias), 0 for no code; an EOL (000000000001) reads as its 12 bits, kEol.
struct Lookup {
  std::vector<int32_t> t;
  Lookup(std::initializer_list<std::pair<const Code*, int>> tables, bool eol) : t(1 << kLookBits, 0) {
    for (auto& [codes, count] : tables)
      for (int i = 0; i < count; i++) add(codes[i].bits, codes[i].value);
    if (eol) add("000000000001", kEol);
  }
  void add(const char* bits, int value) {
    int len = int(strlen(bits)), code = 0;
    for (int i = 0; i < len; i++) code = code * 2 + (bits[i] - '0');
    int lo = code << (kLookBits - len);
    for (int k = 0; k < (1 << (kLookBits - len)); k++)
      t[size_t(lo + k)] = (len << 16) | (value + kBias);
  }
};

const Lookup& white_table() {
  static const Lookup t({{kWhite, int(sizeof(kWhite) / sizeof(Code))},
                         {kExtended, int(sizeof(kExtended) / sizeof(Code))}}, true);
  return t;
}
const Lookup& black_table() {
  static const Lookup t({{kBlack, int(sizeof(kBlack) / sizeof(Code))},
                         {kExtended, int(sizeof(kExtended) / sizeof(Code))}}, true);
  return t;
}
const Lookup& mode_table() {
  static const Lookup t({{kModes, int(sizeof(kModes) / sizeof(Code))}}, true);
  return t;
}

struct Bits {
  const uint8_t* p;
  long n;
  long pos = 0;  // in bits
  bool rev;
  int byte(long i) const { return i < n ? (rev ? reverse_bits(p[i]) : p[i]) : 0; }
  bool done() const { return pos >= n * 8; }
  int peek(int k) const {
    long b = pos >> 3;
    uint32_t acc = uint32_t(byte(b)) << 24 | uint32_t(byte(b + 1)) << 16 |
                   uint32_t(byte(b + 2)) << 8 | uint32_t(byte(b + 3));
    return int((acc << (pos & 7)) >> (32 - k));
  }
  void skip(int k) {
    pos += k;
    if (pos > n * 8) throw CodecError("truncated TIFF: CCITT data ends short of its strip");
  }
  int bit() {
    int v = peek(1);
    skip(1);
    return v;
  }
  // a code of `table`: its value (kEol for an EOL); raises on no code
  int code(const Lookup& table, const char* what) {
    if (done()) throw CodecError("truncated TIFF: CCITT data ends short of its strip");
    int e = table.t[size_t(peek(kLookBits))];
    if (!e) throw CodecError(std::string("corrupt TIFF: bad CCITT ") + what + " code");
    skip(e >> 16);
    return (e & 0xFFFF) - kBias;
  }
  // a run of one colour, no longer than `limit`: make-up codes, then a
  // terminating code
  int run(bool black, int limit) {
    int total = 0;
    for (;;) {
      int v = code(black ? black_table() : white_table(), black ? "black run" : "white run");
      if (v == kEol) throw CodecError("corrupt TIFF: CCITT row ends early (EOL)");
      total += v;
      if (total > limit) throw CodecError("corrupt TIFF: CCITT row longer than the image");
      if (v < 64) return total;
    }
  }
  // past the next EOL: eleven or more zero bits, then a one
  void sync_eol() {
    int zeros = 0;
    for (;;) {
      if (done()) throw CodecError("truncated TIFF: CCITT data ends short of its strip (no EOL)");
      if (bit()) {
        if (zeros >= 11) return;
        zeros = 0;
      } else {
        zeros++;
      }
    }
  }
};

// One row's changing elements (the columns where the colour flips, the first
// to black) into `out`, a row of packed bits (1 = black, most significant
// bit first).
void fill_row(const std::vector<int>& changes, int width, uint8_t* out) {
  memset(out, 0, size_t((width + 7) / 8));
  for (size_t i = 0; i < changes.size(); i += 2) {
    int b = i + 1 < changes.size() ? changes[i + 1] : width;
    for (int x = changes[i]; x < b; x++) out[x >> 3] |= uint8_t(0x80 >> (x & 7));
  }
}

void row_1d(Bits& bits, int width, std::vector<int>& cur) {
  cur.clear();
  int a0 = 0;
  bool black = false;
  while (a0 < width) {
    a0 += bits.run(black, width - a0);
    if (a0 > width) throw CodecError("corrupt TIFF: CCITT row longer than the image");
    if (a0 < width) cur.push_back(a0);
    black = !black;
  }
}

// T.4 4.2 / T.6: a row coded against the changes of the row above
void row_2d(Bits& bits, int width, const std::vector<int>& ref, std::vector<int>& cur) {
  cur.clear();
  int a0 = -1;  // before the row's first pixel
  bool black = false;
  size_t ri = 0;  // the first change of the row above right of a0
  auto at = [&](size_t i) { return i < ref.size() ? ref[i] : width; };
  while (a0 < width) {
    while (ri < ref.size() && ref[ri] <= a0) ri++;
    // b1: the first change right of a0 to the colour other than a0's (the
    // changes at even indices turn black); b2 the change after it
    size_t b1i = ri + ((ri & 1) != (black ? 1u : 0u) ? 1 : 0);
    int b1 = at(b1i), b2 = at(b1i + 1);
    int mode = bits.code(mode_table(), "mode");
    int start = a0 < 0 ? 0 : a0;
    if (mode == kPass) {
      if (b2 > width) throw CodecError("corrupt TIFF: CCITT pass code outside the row");
      a0 = b2;
    } else if (mode == kHoriz) {
      int a1 = start + bits.run(black, width - start);
      int a2 = a1 + bits.run(!black, width - a1);
      if (a2 > width) throw CodecError("corrupt TIFF: CCITT row longer than the image");
      if (a1 < width) cur.push_back(a1);
      if (a2 < width) cur.push_back(a2);
      a0 = a2;
    } else if (mode == kExt) {
      throw CodecError("unsupported TIFF: CCITT uncompressed mode");
    } else if (mode == kEol) {
      throw CodecError("corrupt TIFF: CCITT row ends early (EOL)");
    } else {
      int a1 = b1 + mode;
      if (a1 < start || a1 > width || (a0 >= 0 && a1 <= a0 && a1 != width))
        throw CodecError("corrupt TIFF: CCITT vertical code outside the row");
      if (a1 < width) cur.push_back(a1);
      a0 = a1;
      black = !black;
    }
  }
}

// compression 2, 3 or 4 into `rows` packed rows of `width` pixels
void fax(int compression, const uint8_t* in, long n, uint8_t* out, long occ, int width,
         int t4options, bool rev) {
  long rowbytes = (width + 7) / 8;
  if (width <= 0 || occ % rowbytes) throw CodecError("corrupt TIFF: CCITT strip size");
  long rows = occ / rowbytes;
  if (compression == 3 && (t4options & 2)) throw CodecError("unsupported TIFF: CCITT uncompressed mode");
  if (compression == 4 && (t4options & 2)) throw CodecError("unsupported TIFF: CCITT uncompressed mode");
  Bits bits{in, n, 0, rev};
  std::vector<int> ref, cur;
  for (long r = 0; r < rows; r++) {
    if (compression == 2) {
      row_1d(bits, width, cur);
      bits.pos = (bits.pos + 7) & ~7L;  // rows start on a byte
    } else if (compression == 3) {
      bits.sync_eol();
      bool one_d = !(t4options & 1) || bits.bit();
      if (one_d) row_1d(bits, width, cur);
      else row_2d(bits, width, ref, cur);
    } else {
      row_2d(bits, width, ref, cur);
    }
    fill_row(cur, width, out + r * rowbytes);
    ref.swap(cur);
  }
}

}  // namespace

extern "C" {

// Decompress one strip or tile: `in` (n bytes) of TIFF compression 2, 3, 4, 5
// or 32773 into exactly `occ` bytes at out. width is the strip's pixels a row
// (the CCITT codes), t4options the Group 3 or 4 options, fill_order 2 for
// bits least significant first. Returns 0, or -1 with a message in err; with
// `tolerant` set, a decode error returns 1 instead, the bytes decoded before
// it kept and the rest of out as the caller made it (zero for libtiff's RGBA
// reader, which Pillow reads YCbCr through and which converts such a strip
// all the same).
int qie_tiff_decompress(int compression, const uint8_t* in, long n, uint8_t* out, long occ,
                        int width, int t4options, int fill_order, int tolerant, char* err,
                        int errlen) {
  try {
    std::vector<uint8_t> rev;
    bool reversed = fill_order == 2;
    if (reversed && compression != 2 && compression != 3 && compression != 4) {
      rev.assign(in, in + n);
      for (auto& b : rev) b = reverse_bits(b);
      in = rev.data();
    }
    switch (compression) {
      case 2: case 3: case 4: fax(compression, in, n, out, occ, width, t4options, reversed); break;
      case 5: lzw(in, n, out, occ); break;
      case 32773: packbits(in, n, out, occ); break;
      default: throw CodecError("unsupported TIFF: compression " + std::to_string(compression));
    }
    return 0;
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return tolerant ? 1 : -1;
  }
}

}  // extern "C"
