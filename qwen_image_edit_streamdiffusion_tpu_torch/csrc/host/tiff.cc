// TIFF strip and tile decompression for the serving wire, on the host.
//
// The port's counterpart of the libtiff codecs that Pillow reads a compressed
// TIFF through (core/imaging.py there opens every upload with Image.open):
//   - PackBits (tif_packbits.c PackBitsDecode);
//   - LZW as tif_lzw.c LZWDecode reads it: codes most significant bit first,
//     9 to 12 bits wide, the width growing one code early, a clear code
//     resetting the table; a strip that starts like the old-style
//     (compatibility) LZW is refused by name;
//   - ThunderScan (tif_thunder.c ThunderDecode: 4-bit runs, 2- and 3-bit
//     deltas and raw values, a row at a time);
//   - CCITT modified Huffman RLE (compression 2: every row 1-D and
//     byte-aligned; 32771, RLEW: aligned to a 16-bit word), Group 3
//     (compression 3: an EOL before every row, rows 1-D or, with T4Options
//     bit 0, 1-D or 2-D by a tag bit) and Group 4
//     (compression 4: every row 2-D against the one above), as tif_fax3.c's
//     state machine (tif_fax3.h's macros) decodes them, damaged data
//     included: a bad code ends its row, which is padded or cut to the
//     image's width, and the next row decodes on; data that runs out fails
//     the strip, but a Group 4 strip that made a row keeps its rows.
//     White runs are 0 bits, black runs 1 bits.
// A FillOrder of 2 reverses each input byte's bits first, as TIFFFillStrip
// does. Each strip or tile decodes to at most the bytes it covers, and PackBits
// or LZW data that ends short of them raises (libtiff's "Not enough data"),
// as do bad LZW codes.
//
// Deflate and LZMA strips inflate in core/codec.py through zlib and liblzma,
// called as libtiff calls them; JPEG strips go through image_codec.cc.
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
// ThunderScan
// ---------------------------------------------------------------------------

// tif_thunder.c's ThunderDecode: one row of `maxpixels` 4-bit pixels from
// the bytes at `bp` (each a 2-bit code and 6 bits of data), two a byte, the
// first in the high nibble. A run that would pass the row's end writes
// nothing; false (the rest of the row zeroed) where the row gets too few or
// too many pixels
bool thunder_row(const uint8_t*& bp, long& cc, uint8_t* op0, long maxpixels) {
  static const int kTwoBit[4] = {0, 1, 0, -1};
  static const int kThreeBit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  uint8_t* op = op0;
  unsigned lastpixel = 0;
  long npixels = 0;
  auto setpixel = [&](unsigned v) {  // SETPIXEL
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1) *op++ |= uint8_t(lastpixel);
      else op[0] = uint8_t(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++;
    cc--;
    switch (n & 0xc0) {
      case 0x00:  // a run of the last pixel, n times
        if (npixels & 1) {
          op[0] |= uint8_t(lastpixel);
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels <= maxpixels)
          for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:  // three 2-bit deltas, 2 skipping
        for (int shift : {4, 2, 0})
          if (int const d = (n >> shift) & 3; d != 2)
            setpixel(unsigned(int(lastpixel) + kTwoBit[d]));
        break;
      case 0x80:  // two 3-bit deltas, 4 skipping
        for (int shift : {3, 0})
          if (int const d = (n >> shift) & 7; d != 4)
            setpixel(unsigned(int(lastpixel) + kThreeBit[d]));
        break;
      default:  // a raw value
        setpixel(unsigned(n));
        break;
    }
  }
  if (npixels != maxpixels) {
    memset(op, 0, size_t(op0 + (maxpixels + 1) / 2 - op));
    return false;
  }
  return true;
}

// ThunderDecodeRow: the strip's rows of `width` pixels, each from where the
// row before it ended
void thunder(const uint8_t* in, long n, uint8_t* out, long occ, int width) {
  long const rowbytes = (long(width) + 1) / 2;
  if (width <= 0 || occ % rowbytes)
    throw CodecError("corrupt TIFF: ThunderScan fractional scanlines");
  for (long row = 0; occ > 0; row++, out += rowbytes, occ -= rowbytes)
    if (!thunder_row(in, n, out, width))
      throw CodecError("corrupt TIFF: ThunderScan row " + std::to_string(row) +
                       " decodes to the wrong number of pixels");
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
// libtiff's decoder state tables (mkg3states.c): indexed by the next 7, 12
// or 13 input bits least significant first; a code that is none of these is
// (S_Null, width 0)
enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
             S_MakeUpB, S_MakeUp, S_EOL };
struct FaxTab {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

struct FaxTables {
  FaxTab main[128], white[4096], black[8192];
  static void fill(FaxTab* t, int size, const char* bits, int state, uint32_t param) {
    int const width = int(strlen(bits));
    int code = 0;
    for (int i = 0; i < width; i++) code |= (bits[i] - '0') << i;  // least significant first
    for (int c = code; c < (1 << size); c += 1 << width) t[c] = {uint8_t(state), uint8_t(width), param};
  }
  static void runs(FaxTab* t, int size, const Code* codes, int count, bool term, int term_state,
                   int makeup_state) {
    for (int i = 0; i < count; i++)
      if ((codes[i].value < 64) == term)
        fill(t, size, codes[i].bits, term ? term_state : makeup_state, uint32_t(codes[i].value));
  }
  FaxTables() {
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
    int const nw = int(sizeof(kWhite) / sizeof(Code)), nb = int(sizeof(kBlack) / sizeof(Code));
    int const ne = int(sizeof(kExtended) / sizeof(Code));
    runs(white, 12, kWhite, nw, false, S_TermW, S_MakeUpW);
    for (int i = 0; i < ne; i++) fill(white, 12, kExtended[i].bits, S_MakeUp, uint32_t(kExtended[i].value));
    runs(white, 12, kWhite, nw, true, S_TermW, S_MakeUpW);
    fill(white, 12, "00000000000", S_EOL, 0);
    runs(black, 13, kBlack, nb, false, S_TermB, S_MakeUpB);
    for (int i = 0; i < ne; i++) fill(black, 13, kExtended[i].bits, S_MakeUp, uint32_t(kExtended[i].value));
    runs(black, 13, kBlack, nb, true, S_TermB, S_MakeUpB);
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// _TIFFFax3fillruns: a row of runs (white, black, ...) into packed bits (1 =
// black), each run clamped to the row, as libtiff clamps it in the array
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; k++) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      for (uint32_t i = x; i < x + run; i++) {
        uint8_t const bit = uint8_t(0x80 >> (i & 7));
        if (k) buf[i >> 3] |= bit;
        else buf[i >> 3] &= uint8_t(~bit);
      }
      x += runs[k];
    }
  }
}

struct PrematureEof {};
struct NoEol {};  // Group 3 data without the EOL SYNC_EOL looks for

// tif_fax3.c's Fax3DecodeRLE (compression 2 and 32771), Fax3Decode1D /
// Fax3Decode2D (3) and Fax4Decode (4) over the macros of tif_fax3.h: a bad
// code ends the row (CLEANUP_RUNS pads or cuts it) and decoding goes on;
// data that runs out fails the strip, but a Group 4 strip that made a row keeps the rows it
// made and leaves the rest of `out` as it was. Group 3 data whose EOL search
// runs out is read again from the strip's start, without EOLs (libtiff's
// FAXMODE_NOEOL, kept for the image's later strips), into the rows still to
// be made. RLEW rows end on a 16-bit word of the data's address, as
// FAXMODE_WORDALIGN aligns them: with no whole word left in the bit
// accumulator, an odd address is skipped (libtiff reads the strip where the
// file is mapped, at an even address: `odd_` is the strip's offset mod 2).
class Fax {
 public:
  Fax(int compression, const uint8_t* in, long n, int width, int t4options, bool reversed,
      uint32_t* runs)
      : comp_(compression), cp_(in), ep_(in + n), in_(in), lastx_(width), runs_(runs),
        two_d_(compression == 4 || (compression == 3 && (t4options & 1))),
        odd_(compression == 32771 && (t4options & 1)) {
    nruns_ = (uint32_t(width) + 1 + 31) / 32 * 32;
    if (two_d_) nruns_ *= 2;
    noeol_ = runs_ + 2 * nruns_;  // the slot past the run arrays
    for (int i = 0; i < 256; i++) bitmap_[i] = reversed ? uint8_t(i) : reverse_bits(uint8_t(i));
    // Fax3PreDecode
    cur_ = runs_;
    if (two_d_) {
      ref_ = runs_ + nruns_;
      ref_[0] = uint32_t(width);
      ref_[1] = 0;
    }
  }

  // the strip's rows into buf; false where libtiff fails it
  bool decode(uint8_t* buf, long occ) {
    long const rowbytes = (lastx_ + 7) / 8;
    if (occ % rowbytes) throw CodecError("corrupt TIFF: CCITT fractional scanlines");
    const FaxTables& t = fax_tables();
    int const start = line_;
    const uint8_t* const cp0 = cp_;
    thisrun_ = cur_;
    while (occ > 0) {
      a0_ = 0;
      rl_ = 0;
      if (two_d_) thisrun_ = cur_;
      pa_ = thisrun_;
      bool one_d = true;
      try {
        if (comp_ == 3 && !*noeol_) sync_eol();
        if (comp_ == 3 && two_d_) {
          need8(1);
          one_d = acc_ & 1;
          clr(1);
        }
        if (comp_ == 4) one_d = false;
      } catch (const PrematureEof&) {  // EOF1D / EOF2D
        cleanup();
        fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
        return false;
      } catch (const NoEol&) {  // read the strip again without EOLs
        *noeol_ = 1;
        cp_ = cp0;
        acc_ = 0;
        avail_ = eolcnt_ = 0;
        continue;
      }
      if (two_d_) {
        pb_ = ref_;
        b1_ = int(*pb_++);
      }
      try {
        if (one_d) expand1d(t);
        else expand2d(t);
      } catch (const PrematureEof&) {
        if (comp_ != 4) {
          fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
          return false;
        }
        return end_g4(buf, start);
      }
      if (comp_ == 4 && eolcnt_) return end_g4(buf, start);
      fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
      if (comp_ == 2) clr(avail_ & 7);  // rows start on a byte
      if (comp_ == 32771) {  // or on a word
        clr(avail_ & 15);
        if (avail_ == 0 && ((cp_ - in_) + odd_) & 1) cp_++;
      }
      if (two_d_) {
        if (comp_ == 4 || pa_ < thisrun_ + nruns_) setvalue(0);  // imaginary change
        std::swap(cur_, ref_);
      }
      buf += rowbytes;
      occ -= rowbytes;
      line_++;
    }
    return true;
  }

 private:
  int comp_;
  const uint8_t* cp_;
  const uint8_t* ep_;
  const uint8_t* in_;
  int lastx_;
  uint32_t* runs_;
  bool two_d_;
  bool odd_;
  uint32_t nruns_;
  uint8_t bitmap_[256];
  uint32_t* noeol_;
  uint32_t* cur_;
  uint32_t* ref_ = nullptr;
  uint32_t acc_ = 0;
  int avail_ = 0, eolcnt_ = 0, line_ = 0;
  int a0_ = 0, rl_ = 0, b1_ = 0;
  uint32_t* pa_ = nullptr;
  uint32_t* pb_ = nullptr;
  uint32_t* thisrun_ = nullptr;

  bool end_g4(uint8_t* buf, int start) {  // EOFG4, then BADG4 where no bits are left
    need16_soft(13);
    clr(13);
    fill_runs(buf, thisrun_, pa_, uint32_t(lastx_));
    return line_ != start;  // a badly-terminated strip keeps its rows
  }

  bool eod() const { return cp_ >= ep_; }
  void need8(int n) {
    if (avail_ < n) {
      if (eod()) {
        if (avail_ == 0) throw PrematureEof();
        avail_ = n;  // pad with zeros
      } else {
        acc_ |= uint32_t(bitmap_[*cp_++]) << avail_;
        avail_ += 8;
      }
    }
  }
  bool need16_soft(int n) {
    if (avail_ < n) {
      if (eod()) {
        if (avail_ == 0) return false;
        avail_ = n;
      } else {
        acc_ |= uint32_t(bitmap_[*cp_++]) << avail_;
        if ((avail_ += 8) < n) {
          if (eod()) {
            avail_ = n;
          } else {
            acc_ |= uint32_t(bitmap_[*cp_++]) << avail_;
            avail_ += 8;
          }
        }
      }
    }
    return true;
  }
  void need16(int n) {
    if (!need16_soft(n)) throw PrematureEof();
  }
  uint32_t get(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  const FaxTab& lookup8(const FaxTab* tab, int wid) {
    need8(wid);
    const FaxTab& e = tab[get(wid)];
    clr(e.width);
    return e;
  }
  const FaxTab& lookup16(const FaxTab* tab, int wid) {
    need16(wid);
    const FaxTab& e = tab[get(wid)];
    clr(e.width);
    return e;
  }

  [[noreturn]] void overflow() const {
    throw CodecError("corrupt TIFF: CCITT row has more runs than its buffer");
  }
  void setvalue(int x) {
    if (pa_ >= thisrun_ + nruns_) overflow();
    *pa_++ = uint32_t(rl_ + x);
    a0_ += x;
    rl_ = 0;
  }
  void cleanup() {  // CLEANUP_RUNS
    if (rl_) setvalue(0);
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > thisrun_) a0_ -= int(*--pa_);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if ((pa_ - thisrun_) & 1) setvalue(0);
        setvalue(lastx_ - a0_);
      } else if (a0_ > lastx_) {
        setvalue(lastx_);
        setvalue(0);
      }
    }
  }
  void sync_eol() {  // SYNC_EOL
    if (eolcnt_ == 0) {
      for (;;) {
        need16(11);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      try {
        need8(8);
      } catch (const PrematureEof&) {
        throw NoEol();
      }
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt_ = 0;
  }

  // EXPAND1D: a premature EOF cleans the row up and raises
  void expand1d(const FaxTables& t) {
    try {
      for (;;) {
        for (bool black : {false, true}) {
          for (;;) {
            const FaxTab& e = black ? lookup16(t.black, 13) : lookup16(t.white, 12);
            if (e.state == S_EOL) {
              eolcnt_ = 1;
              cleanup();
              return;
            }
            if (e.state == (black ? S_TermB : S_TermW)) {
              setvalue(int(e.param));
              break;
            }
            if (e.state == (black ? S_MakeUpB : S_MakeUpW) || e.state == S_MakeUp) {
              a0_ += int(e.param);
              rl_ += int(e.param);
              continue;
            }
            cleanup();  // unexpected: a bad code ends the row
            return;
          }
          if (a0_ >= lastx_) {
            cleanup();
            return;
          }
        }
        if (*(pa_ - 1) == 0 && *(pa_ - 2) == 0) pa_ -= 2;
      }
    } catch (const PrematureEof&) {
      cleanup();
      throw;
    }
  }

  void check_b1() {  // CHECK_b1
    if (pa_ != thisrun_)
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) overflow();
        b1_ += int(pb_[0] + pb_[1]);
        pb_ += 2;
      }
  }

  // one run of colour `black` in horizontal mode: false for a bad code
  bool horiz_run(const FaxTables& t, bool black) {
    for (;;) {
      const FaxTab& e = black ? lookup16(t.black, 13) : lookup16(t.white, 12);
      if (e.state == (black ? S_TermB : S_TermW)) {
        setvalue(int(e.param));
        return true;
      }
      if (e.state == (black ? S_MakeUpB : S_MakeUpW) || e.state == S_MakeUp) {
        a0_ += int(e.param);
        rl_ += int(e.param);
        continue;
      }
      return false;
    }
  }

  // EXPAND2D: a premature EOF cleans the row up and raises
  void expand2d(const FaxTables& t) {
    try {
      while (a0_ < lastx_) {
        if (pa_ >= thisrun_ + nruns_) overflow();
        const FaxTab& e = lookup8(t.main, 7);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb_ + 1 >= ref_ + nruns_) overflow();
            b1_ += int(*pb_++);
            rl_ += b1_ - a0_;
            a0_ = b1_;
            b1_ += int(*pb_++);
            break;
          case S_Horiz: {
            bool const first_black = (pa_ - thisrun_) & 1;
            if (!horiz_run(t, first_black) || !horiz_run(t, !first_black)) {
              cleanup();  // unexpected
              return;
            }
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            setvalue(b1_ - a0_);
            if (pb_ >= ref_ + nruns_) overflow();
            b1_ += int(*pb_++);
            break;
          case S_VR:
            check_b1();
            setvalue(b1_ - a0_ + int(e.param));
            if (pb_ >= ref_ + nruns_) overflow();
            b1_ += int(*pb_++);
            break;
          case S_VL:
            check_b1();
            if (b1_ < int(a0_ + int(e.param))) {
              cleanup();  // unexpected
              return;
            }
            setvalue(b1_ - a0_ - int(e.param));
            b1_ -= int(*--pb_);
            break;
          case S_Ext:  // uncompressed mode is not decoded: the row ends
            *pa_++ = uint32_t(lastx_ - a0_);
            cleanup();
            return;
          case S_EOL:
            *pa_++ = uint32_t(lastx_ - a0_);
            need8(4);
            clr(4);
            eolcnt_ = 1;
            cleanup();
            return;
          default:
            cleanup();  // unexpected
            return;
        }
      }
      if (rl_) {
        if (rl_ + a0_ < lastx_) {  // expect a final V0
          need8(1);
          if (!get(1)) {
            cleanup();
            return;
          }
          clr(1);
        }
        setvalue(0);
      }
      cleanup();
    } catch (const PrematureEof&) {
      cleanup();
      throw;
    }
  }
};

// compression 2, 3, 4 or 32771 into `occ` bytes of rows of `width` pixels, through
// the run arrays `runs` (2 * nruns entries, kept across a TIFF's strips as
// libtiff keeps them, then the FAXMODE_NOEOL flag); false where libtiff
// fails the strip
bool fax(int compression, const uint8_t* in, long n, uint8_t* out, long occ, int width,
         int t4options, bool reversed, uint32_t* runs) {
  if (width <= 0) throw CodecError("corrupt TIFF: CCITT strip size");
  Fax f(compression, in, n, width, t4options, reversed, runs);
  return f.decode(out, occ);
}

}  // namespace

extern "C" {

// Decompress one strip or tile: `in` (n bytes) of TIFF compression 2, 3, 4, 5,
// 32771, 32773 or 32809 into `occ` bytes at out. width is the strip's pixels a
// row (the CCITT and ThunderScan codes), t4options the Group 3 or 4 options
// (for 32771, the strip's offset in the file mod 2), fill_order 2 for bits
// least significant first, `runs` libtiff's CCITT run arrays (kept by the
// caller across a TIFF's strips). Returns 0, or -1 with a message in err;
// with `tolerant` set, a decode error returns 1 instead, the bytes decoded
// before it kept and the rest of out as the caller made it (zero for
// libtiff's RGBA reader, which Pillow reads YCbCr through and which converts
// such a strip all the same). A Group 4 strip that ends after a row returns
// 0, the rest of out as it was.
int qie_tiff_decompress(int compression, const uint8_t* in, long n, uint8_t* out, long occ,
                        int width, int t4options, int fill_order, int tolerant, uint32_t* runs,
                        char* err, int errlen) {
  try {
    std::vector<uint8_t> rev;
    bool reversed = fill_order == 2;
    bool const fax_codes = compression == 2 || compression == 3 || compression == 4 ||
                           compression == 32771;
    if (reversed && !fax_codes) {
      rev.assign(in, in + n);
      for (auto& b : rev) b = reverse_bits(b);
      in = rev.data();
    }
    switch (compression) {
      case 2: case 3: case 4: case 32771:
        if (!fax(compression, in, n, out, occ, width, t4options, reversed, runs))
          throw CodecError("truncated TIFF: CCITT data ends short of its strip");
        break;
      case 5: lzw(in, n, out, occ); break;
      case 32773: packbits(in, n, out, occ); break;
      case 32809: thunder(in, n, out, occ, width); break;
      default: throw CodecError("unsupported TIFF: compression " + std::to_string(compression));
    }
    return 0;
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return tolerant ? 1 : -1;
  }
}

}  // extern "C"
