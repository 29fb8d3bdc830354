// BMP and GIF decoding for the serving wire, on the host, to the RGB bytes
// that Pillow's Image.open(...).convert("RGB") gives (its BmpImagePlugin and
// GifImagePlugin with GifDecode.c; core/imaging.py of the JAX package).
//
// BMP: the CORE (12-byte), INFO (40), V2 (52), V3 (56), OS/2 2 (64), V4 (108)
// and V5 (124) headers; 1, 4 and 8 bits with a palette (a gray identity
// palette read as Pillow's "1" or "L", as it reads it), 16 bits as 5-5-5,
// 24 and 32 bits as BGR(X), BI_BITFIELDS at the layouts Pillow takes, RLE8 and
// RLE4 as its BmpRleDecoder runs them; rows bottom-up, or top-down for a
// negative height; alpha dropped. Palette indices past the palette read black.
// The same reader takes a DIB's info header where it lies (DibImageFile,
// and an icon's or a cursor's image, whose pixels follow the palette).
//
// GIF: the first frame, as GifImagePlugin seeks to it and GifDecode.c
// decodes it: LZW with Pillow's code-size, clear and table-full rules,
// interlaced or not, the frame's local palette or the global one (a gray
// identity table counts as none: indices read as grays where no other
// palette applies), the frame placed within the logical
// screen (which grows to hold it) on a canvas of index 0, or of the
// transparency index where the graphic control extension sets one.
//
// A plain C interface, loaded with ctypes by core/codec.py beside
// image_codec.cc. Every entry point returns a negative value and writes a
// message into `err` on failure.

#include <cstring>
#include <vector>

#include "codec_common.h"

namespace {

using qie::CodecError;
using qie::le16;
using qie::le32;

// ---------------------------------------------------------------------------
// BMP
// ---------------------------------------------------------------------------

// How the pixel bytes are laid out (Pillow's raw modes).
enum class Raw { P1, P4, P8, L8, Bit1, BGR15, BGR16, BGR24, Bytes32 };

struct Bmp {
  const uint8_t* d;
  size_t n;
  int64_t width = 0, height = 0;
  int bits = 0;
  uint32_t compression = 0;
  bool top_down = false;
  size_t data_off = 0;       // where the pixels (or the RLE stream) start
  Raw raw = Raw::P8;
  int rgb_byte[3] = {2, 1, 0};  // 32 bits: the byte of R, G and B in a pixel
  std::vector<uint8_t> palette;  // RGB, 256 entries, black past the file's

  std::string fmt;               // the format named in errors

  Bmp(const uint8_t* data, size_t len, const char* name = "BMP")
      : d(data), n(len), fmt(name) {}

  void need(size_t end) const {
    if (end > n) throw CodecError("truncated " + fmt + ": the headers end early");
  }

  void parse() {
    need(18);
    if (d[0] != 'B' || d[1] != 'M') throw CodecError("not a BMP file");
    parse_info(14, le32(d + 10));
  }

  // The info header at `at` (BmpImagePlugin's _bitmap): past a file header,
  // or a DIB's own (a DIB file, an icon's or a cursor's image), whose pixels
  // follow its palette (`offset` 0).
  void parse_info(size_t at, uint32_t offset) {
    need(at + 4);
    uint32_t hs = le32(d + at);
    if (hs != 12 && hs != 40 && hs != 52 && hs != 56 && hs != 64 && hs != 108 && hs != 124)
      throw CodecError("unsupported " + fmt + ": header size " + std::to_string(hs));
    need(at + size_t(hs));
    const uint8_t* h = d + at + 4;  // the header after its size field
    size_t pos = at + hs;           // the file position Pillow reads on from
    int pad;
    uint64_t colors = 0;
    uint32_t masks[4] = {0, 0, 0, 0};
    if (hs == 12) {
      width = le16(h);
      height = le16(h + 2);
      bits = int(le16(h + 6));
      pad = 3;
    } else {
      bool flip = h[7] == 0xFF;
      width = le32(h);
      height = flip ? int64_t(1) << 32 : 0;
      height = flip ? height - le32(h + 4) : le32(h + 4);
      top_down = flip;
      bits = int(le16(h + 10));
      compression = le32(h + 12);
      colors = le32(h + 28);
      pad = 4;
      if (compression == 3) {
        if (hs >= 52) {
          for (int i = 0; i < 3; i++) masks[i] = le32(h + 36 + 4 * i);
          if (hs >= 56) masks[3] = le32(h + 48);
        } else {  // a 40-byte header: the three masks follow it
          need(pos + 12);
          for (int i = 0; i < 3; i++) masks[i] = le32(d + pos + 4 * i);
          pos += 12;
        }
      }
    }
    qie::check_pixels(fmt.c_str(), width, height);
    if (!colors) colors = bits < 64 ? uint64_t(1) << bits : 0;
    if (offset == 14 + hs && bits <= 8) offset += uint32_t(4 * colors);

    bool paletted = bits == 1 || bits == 4 || bits == 8;
    if (!paletted && bits != 16 && bits != 24 && bits != 32)
      throw CodecError("unsupported " + fmt + ": " + std::to_string(bits) + " bits a pixel");
    raw = bits == 1 ? Raw::P1 : bits == 4 ? Raw::P4 : bits == 8 ? Raw::P8
        : bits == 16 ? Raw::BGR15 : bits == 24 ? Raw::BGR24 : Raw::Bytes32;
    if (compression == 3) {
      uint32_t r = masks[0], g = masks[1], b = masks[2], a = masks[3];
      auto is = [&](uint32_t r2, uint32_t g2, uint32_t b2, uint32_t a2) {
        return r == r2 && g == g2 && b == b2 && a == a2;
      };
      auto rgb_is = [&](uint32_t r2, uint32_t g2, uint32_t b2) {
        return r == r2 && g == g2 && b == b2;
      };
      auto bytes = [&](int rb, int gb, int bb) {
        rgb_byte[0] = rb;
        rgb_byte[1] = gb;
        rgb_byte[2] = bb;
      };
      if (bits == 32) {  // BmpImagePlugin's MASK_MODES
        if (is(0xFF0000, 0xFF00, 0xFF, 0) || is(0xFF0000, 0xFF00, 0xFF, 0xFF000000) ||
            is(0, 0, 0, 0))
          bytes(2, 1, 0);  // BGRX, BGRA
        else if (is(0xFF000000, 0xFF0000, 0xFF00, 0) || is(0xFF000000, 0xFF0000, 0xFF00, 0xFF))
          bytes(3, 2, 1);  // XBGR, ABGR
        else if (is(0xFF000000, 0xFF00, 0xFF, 0) || is(0xFF000000, 0xFF00, 0xFF, 0xFF0000))
          bytes(3, 1, 0);  // BGXR, BGAR
        else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
          bytes(0, 1, 2);  // RGBA
        else
          throw CodecError("unsupported " + fmt + ": bitfields layout");
      } else if (bits == 24 && rgb_is(0xFF0000, 0xFF00, 0xFF)) {
      } else if (bits == 16 && rgb_is(0xF800, 0x7E0, 0x1F)) {
        raw = Raw::BGR16;
      } else if (bits == 16 && rgb_is(0x7C00, 0x3E0, 0x1F)) {
      } else {
        throw CodecError("unsupported " + fmt + ": bitfields layout");
      }
    } else if (compression == 1 || compression == 2) {
      if (!paletted)
        throw CodecError("unsupported " + fmt + ": RLE at " + std::to_string(bits) + " bits a pixel");
    } else if (compression != 0) {
      const char* names[] = {"", "", "", "", " (JPEG)", " (PNG)"};
      throw CodecError("unsupported " + fmt + ": compression " + std::to_string(compression) +
                       (compression <= 5 ? names[compression] : ""));
    }
    palette.assign(256 * 3, 0);
    if (paletted) {
      if (colors == 0 || colors > 65536)
        throw CodecError("unsupported " + fmt + ": palette size " + std::to_string(colors));
      size_t want = size_t(pad) * colors;
      size_t have = pos < n ? std::min(want, n - pos) : 0;
      const uint8_t* p = d + pos;
      pos += have;
      // a palette of grays 0..colors-1 (or black and white) makes Pillow's
      // image "L" (or "1"), read with that raw mode
      bool gray = true;
      for (uint64_t i = 0; i < colors && gray; i++) {
        uint8_t v = uint8_t(colors == 2 ? (i ? 255 : 0) : i);
        gray = size_t(i) * pad + 3 <= have && p[i * pad] == v && p[i * pad + 1] == v &&
               p[i * pad + 2] == v;
      }
      if (gray) raw = colors == 2 ? Raw::Bit1 : Raw::L8;
      // Pillow's putpalette takes at most 256 entries
      if (!gray && have / size_t(pad) > 256)
        throw CodecError("unsupported " + fmt + ": a palette of " + std::to_string(have / pad) +
                         " colours");
      size_t entries = std::min<size_t>(have / size_t(pad), 256);
      for (size_t i = 0; i < entries; i++) {
        palette[3 * i] = p[i * pad + 2];
        palette[3 * i + 1] = p[i * pad + 1];
        palette[3 * i + 2] = p[i * pad];
      }
      if (gray && raw == Raw::L8)
        for (int i = 0; i < 256; i++) palette[3 * i] = palette[3 * i + 1] = palette[3 * i + 2] =
            uint8_t(i);
    }
    data_off = offset ? offset : pos;
  }

  void rgb_of_index(const uint8_t* idx, uint8_t* out, size_t count) const {
    for (size_t i = 0; i < count; i++) memcpy(out + 3 * i, &palette[3 * idx[i]], 3);
  }

  void decode(uint8_t* out) {
    parse();
    decode_pixels(out);
  }

  // The pixels of a parsed header; `height` may be cut to the rows wanted
  // (an icon's or a cursor's image without its mask).
  void decode_pixels(uint8_t* out) {
    if (compression == 1 || compression == 2) return decode_rle(out);
    // Pillow's raw decoder: `stride` bytes a file row, of which the raw
    // mode reads `bytes`
    int rb = raw == Raw::P1 || raw == Raw::Bit1 ? 1 : raw == Raw::P4 ? 4
           : raw == Raw::BGR15 || raw == Raw::BGR16 ? 16 : raw == Raw::BGR24 ? 24
           : raw == Raw::Bytes32 ? 32 : 8;
    uint64_t stride = ((uint64_t(width) * bits + 31) >> 3) & ~uint64_t(3);
    uint64_t bytes = (uint64_t(width) * rb + 7) / 8;
    if (stride < bytes)
      throw CodecError("unsupported " + fmt + ": a " + std::to_string(bits) +
                       "-bit gray palette (rows shorter than Pillow reads them)");
    // the last row needs its pixels, not its padding (Pillow's RawDecode)
    if (data_off > n || stride * uint64_t(height - 1) + bytes > n - data_off)
      throw CodecError("truncated " + fmt + ": the pixel rows end early");
    std::vector<uint8_t> idx(static_cast<size_t>(width));
    for (int64_t r = 0; r < height; r++) {
      const uint8_t* row = d + data_off + size_t(r) * stride;
      uint8_t* o = out + size_t(top_down ? r : height - 1 - r) * size_t(width) * 3;
      const size_t w = size_t(width);
      switch (raw) {
        case Raw::P1: case Raw::Bit1:
          for (size_t x = 0; x < w; x++) idx[x] = (row[x >> 3] >> (7 - (x & 7))) & 1;
          if (raw == Raw::Bit1)
            for (size_t x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
                uint8_t(idx[x] ? 255 : 0);
          else
            rgb_of_index(idx.data(), o, w);
          break;
        case Raw::P4:
          for (size_t x = 0; x < w; x++) idx[x] = (row[x >> 1] >> ((x & 1) ? 0 : 4)) & 15;
          rgb_of_index(idx.data(), o, w);
          break;
        case Raw::P8: case Raw::L8:
          rgb_of_index(row, o, w);
          break;
        case Raw::BGR15: case Raw::BGR16:
          for (size_t x = 0; x < w; x++) {
            uint32_t p = le16(row + 2 * x);
            if (raw == Raw::BGR15) {  // Unpack.c ImagingUnpackBGR15
              o[3 * x] = uint8_t(((p >> 10) & 31) * 255 / 31);
              o[3 * x + 1] = uint8_t(((p >> 5) & 31) * 255 / 31);
            } else {  // ImagingUnpackBGR16
              o[3 * x] = uint8_t(((p >> 11) & 31) * 255 / 31);
              o[3 * x + 1] = uint8_t(((p >> 5) & 63) * 255 / 63);
            }
            o[3 * x + 2] = uint8_t((p & 31) * 255 / 31);
          }
          break;
        case Raw::BGR24:
          for (size_t x = 0; x < w; x++) {
            o[3 * x] = row[3 * x + 2];
            o[3 * x + 1] = row[3 * x + 1];
            o[3 * x + 2] = row[3 * x];
          }
          break;
        case Raw::Bytes32:
          for (size_t x = 0; x < w; x++)
            for (int c = 0; c < 3; c++) o[3 * x + c] = row[4 * x + rgb_byte[c]];
          break;
      }
    }
  }

  // BmpRleDecoder.decode: the index stream row by row from the file's first
  // row, escapes 0 (end of line: the row padded with 0), 1 (end of bitmap),
  // 2 (delta: Pillow skips two bytes and reads right, up from the next two)
  // and absolute runs aligned to an even file position.
  void decode_rle(uint8_t* out) {
    if (raw == Raw::Bit1)
      throw CodecError("unsupported " + fmt + ": RLE with a black-and-white palette");
    const bool rle4 = compression == 2;
    const size_t w = size_t(width), total = w * size_t(height);
    std::vector<uint8_t> data;
    data.reserve(total);
    size_t p = data_off, x = 0;
    auto left = [&]() { return p < n ? n - p : 0; };
    while (data.size() < total) {
      if (left() < 2) break;
      int count = d[p], byte = d[p + 1];
      p += 2;
      if (count) {
        size_t k = count;
        if (x + k > w) k = x < w ? w - x : 0;
        for (size_t i = 0; i < k; i++)
          data.push_back(uint8_t(rle4 ? ((i & 1) ? byte & 15 : byte >> 4) : byte));
        x += size_t(count);
      } else if (byte == 0) {
        while (data.size() % w) data.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (left() < 2) break;
        p += 2;
        if (left() < 2) throw CodecError("truncated " + fmt + ": an RLE delta ends early");
        size_t right = d[p], up = d[p + 1];
        p += 2;
        data.insert(data.end(), right + up * w, 0);
        x = data.size() % w;
      } else {
        size_t want = rle4 ? size_t(byte) / 2 : size_t(byte);
        size_t got = std::min(want, left());
        for (size_t i = 0; i < got; i++) {
          if (rle4) {
            data.push_back(d[p + i] >> 4);
            data.push_back(d[p + i] & 15);
          } else {
            data.push_back(d[p + i]);
          }
        }
        p += got;
        if (got < want) break;
        x += size_t(byte);
        if (p % 2) p++;
      }
    }
    if (data.size() < total)
      throw CodecError("truncated " + fmt + ": the RLE data ends before the image is full");
    for (int64_t r = 0; r < height; r++)
      rgb_of_index(data.data() + size_t(r) * w,
                   out + size_t(top_down ? r : height - 1 - r) * w * 3, w);
  }
};

// ---------------------------------------------------------------------------
// GIF
// ---------------------------------------------------------------------------

struct Gif {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int64_t width = 0, height = 0;   // the logical screen, grown to hold the frame
  int fx = 0, fy = 0, fw = 0, fh = 0;  // the first frame's extent
  bool interlace = false;
  int transparency = -1;
  int lzw_bits = 0;
  size_t data_pos = 0;
  bool paletted = false;           // Pillow's "P" (else "L": index = gray)
  std::vector<uint8_t> palette;    // RGB, 256 entries, black past the file's

  Gif(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) throw CodecError("truncated GIF: the headers end early");
    return d[pos++];
  }
  // GifImageFile.data: one sub-block, or none at a zero length (or the end)
  bool sub_block(const uint8_t** body, size_t* len) {
    if (pos >= n || d[pos] == 0) {
      if (pos < n) pos++;
      return false;
    }
    size_t l = d[pos++];
    *body = d + pos;
    *len = std::min(l, n - pos);
    pos += *len;
    return true;
  }
  // The color table of `entries` entries at pos: whether it is needed
  // (GifImageFile._is_palette_needed: not the gray identity) and read.
  bool table(int entries, std::vector<uint8_t>& out) {
    size_t len = std::min(size_t(3 * entries), pos < n ? n - pos : 0);
    const uint8_t* p = d + pos;
    pos += len;
    bool needed = false;
    for (size_t i = 0; i + 2 < len; i += 3)
      if (!(p[i] == i / 3 && p[i + 1] == p[i] && p[i + 2] == p[i])) needed = true;
    if (len % 3) throw CodecError("truncated GIF: a colour table ends early");
    out.assign(256 * 3, 0);
    memcpy(out.data(), p, std::min<size_t>(len, out.size()));
    return needed;
  }

  void parse() {
    if (n < 13) throw CodecError("truncated GIF: the headers end early");
    if (memcmp(d, "GIF87a", 6) != 0 && memcmp(d, "GIF89a", 6) != 0)
      throw CodecError("not a GIF file");
    width = le16(d + 6);
    height = le16(d + 8);
    int flags = d[10];
    pos = 13;
    std::vector<uint8_t> global, local;
    bool have_global = false;
    if (flags & 128) have_global = table(1 << ((flags & 7) + 1), global);
    // GifImageFile._seek(0): extensions and stray bytes up to the first image
    int have_local = -1;  // -1 no local table, 0 a gray identity one, 1 a real one
    bool found = false;
    while (pos < n && !found) {
      int s = d[pos++];
      if (s == ';') break;
      if (s == '!') {
        int label = u8();
        const uint8_t* body;
        size_t len;
        bool block = sub_block(&body, &len);
        if (label == 0xF9 && block) {
          if (len < 4) throw CodecError("corrupt GIF: a short graphic control extension");
          if (body[0] & 1) transparency = body[3];
        } else if (label == 0xFE) {
          while (block) block = sub_block(&body, &len);
          continue;
        }
        if (block)
          while (sub_block(&body, &len)) {
          }
      } else if (s == ',') {
        if (pos + 9 > n) throw CodecError("truncated GIF: an image descriptor ends early");
        const uint8_t* s9 = d + pos;
        pos += 9;
        fx = int(le16(s9));
        fy = int(le16(s9 + 2));
        fw = int(le16(s9 + 4));
        fh = int(le16(s9 + 6));
        width = std::max<int64_t>(width, fx + fw);
        height = std::max<int64_t>(height, fy + fh);
        interlace = (s9[8] & 64) != 0;
        if (s9[8] & 128) have_local = table(1 << ((s9[8] & 7) + 1), local) ? 1 : 0;
        lzw_bits = u8();
        data_pos = pos;
        found = true;
      }
    }
    if (!found) throw CodecError("corrupt GIF: no image in the file");
    qie::check_pixels("GIF", width, height);
    // the frame's palette: the local one, else the global one; a gray
    // identity table stands for none. (A gray local table makes Pillow's
    // image "L", but the global palette it keeps is still applied to it.)
    if (have_local == 1) {
      paletted = true;
      palette = local;
    } else {
      paletted = have_global;
      palette = global;
    }
    if (lzw_bits > 8)
      throw CodecError("unsupported GIF: LZW minimum code size " + std::to_string(lzw_bits));
  }

  // GifDecode.c over the frame's sub-blocks into the canvas of indices.
  void lzw(std::vector<uint8_t>& canvas) {
    if (fw == 0 || fh == 0) return;
    constexpr int kTable = 4096;
    std::vector<uint8_t> data(kTable), stack(kTable);
    std::vector<uint16_t> link(kTable);
    const int clear = 1 << lzw_bits, end = clear + 1;
    int next = 0, codesize = 0, codemask = 0, state = 1;
    int lastcode = 0, lastdata = 0;
    uint32_t bitbuffer = 0;
    int bitcount = 0, blocksize = 0;
    size_t p = data_pos;
    // interlace passes: (first row, step) after each pass's end
    int pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
    int x = 0, y = 0;
    bool done = false;
    auto put = [&](uint8_t v) {
      canvas[size_t(fy + y) * size_t(width) + fx + x] = v;
      if (++x < fw) return;
      x = 0;
      y += step;
      while (y >= fh) {
        if (pass == 1) {
          y = 4;
          pass = 2;
        } else if (pass == 2) {
          step = 4;
          y = 2;
          pass = 3;
        } else if (pass == 3) {
          step = 2;
          y = 1;
          pass = 0;
        } else {
          done = true;
          return;
        }
      }
    };
    while (!done) {
      if (state == 1) {
        next = clear + 2;
        codesize = lzw_bits + 1;
        codemask = (1 << codesize) - 1;
        state = 2;
      }
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= uint32_t(d[p++]) << bitcount;
          bitcount += 8;
          blocksize--;
        } else {
          // a whole sub-block, or the data is cut short (Pillow: truncated)
          if (p >= n || n - p < size_t(d[p]) + 1)
            throw CodecError("truncated GIF: the image data ends early");
          blocksize = d[p++];
        }
      }
      int c = int(bitbuffer & uint32_t(codemask));
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) throw CodecError("truncated GIF: the image data ends before the frame is full");
      int sp = 0;  // the string after its first sample, last sample first
      if (state == 2) {
        if (c > clear) throw CodecError("corrupt GIF: bad first LZW code");
        lastdata = lastcode = c;
        state = 3;
      } else {
        int thiscode = c;
        if (c > next) throw CodecError("corrupt GIF: LZW code past the table");
        if (c == next) {
          stack[sp++] = uint8_t(lastdata);
          c = lastcode;
        }
        while (c >= clear) {
          if (sp >= kTable || c >= kTable) throw CodecError("corrupt GIF: bad LZW string");
          stack[sp++] = data[c];
          c = link[c];
        }
        lastdata = c;
        if (next < kTable) {
          data[next] = uint8_t(c);
          link[next] = uint16_t(lastcode);
          if (next == codemask && codesize < 12) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        lastcode = thiscode;
      }
      put(uint8_t(lastdata));
      while (sp > 0 && !done) put(stack[--sp]);
    }
  }

  void decode(uint8_t* out) {
    parse();
    std::vector<uint8_t> canvas(size_t(width) * size_t(height),
                                uint8_t(transparency >= 0 ? transparency : 0));
    lzw(canvas);
    size_t np = canvas.size();
    for (size_t i = 0; i < np; i++) {
      uint8_t v = canvas[i];
      if (paletted) {
        memcpy(out + 3 * i, &palette[3 * v], 3);
      } else {
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v;
      }
    }
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

// Width and height of a BMP; 0, or -1 with a message in err.
int qie_bmp_info(const uint8_t* data, long n, int* width, int* height, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Bmp b(data, size_t(n));
    b.parse();
    *width = int(b.width);
    *height = int(b.height);
  });
}

// Decode a BMP into out: height x width x 3 RGB.
int qie_bmp_decode(const uint8_t* data, long n, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { Bmp(data, size_t(n)).decode(out); });
}

// Width and height of the DIB whose info header starts at `at` (a DIB file,
// an icon's or a cursor's image; `name` the format named in errors), and
// the file offset of its pixels; 0, or -1 with a message in err.
int qie_dib_info(const uint8_t* data, long n, long at, const char* name, int* width,
                 int* height, long* pixels, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Bmp b(data, size_t(n), name);
    b.parse_info(size_t(at), 0);
    *width = int(b.width);
    *height = int(b.height);
    *pixels = long(b.data_off);
  });
}

// Decode the first `rows` rows of that DIB's image (in the order Pillow
// reads them: from the bottom unless its height is negative) into out:
// rows x width x 3 RGB.
int qie_dib_decode(const uint8_t* data, long n, long at, const char* name, int rows,
                   uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Bmp b(data, size_t(n), name);
    b.parse_info(size_t(at), 0);
    b.height = rows;
    b.decode_pixels(out);
  });
}

// Width and height of a GIF's first frame as Pillow opens it (the logical
// screen grown to hold the frame); 0, or -1 with a message in err.
int qie_gif_info(const uint8_t* data, long n, int* width, int* height, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Gif g(data, size_t(n));
    g.parse();
    *width = int(g.width);
    *height = int(g.height);
  });
}

// Decode a GIF's first frame into out: height x width x 3 RGB.
int qie_gif_decode(const uint8_t* data, long n, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { Gif(data, size_t(n)).decode(out); });
}

}  // extern "C"
