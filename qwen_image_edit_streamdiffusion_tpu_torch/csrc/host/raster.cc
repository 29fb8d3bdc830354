// The run-length and byte-stream decoders of the plain raster formats, on
// the host, as Pillow's C and Python decoders run them (core/codec.py reads
// the headers, palettes and modes and unpacks the rows this file writes):
//
// - TGA RLE (TgaRleDecode.c): literal packets run on into the next row, a
//   run past the row's end is an overrun;
// - PackBits as PsdImagePlugin's tiles decode it (PackbitsDecode.c): a
//   packet past the row's end is cut there, 0x80 is no operation;
// - PCX RLE (PcxDecode.c): a run past the line's end is an overrun, planes
//   padded past their length moved together before the line is read;
// - SGI RLE (SgiRleDecode.c): each row of each channel from its offset and
//   length tables, expandrow's bounds and its early ends;
// - QOI (QoiImagePlugin.QoiDecoder);
// - SUN RLE (SunRleDecode.c): 0x80 escapes a run or a literal 0x80, a run
//   past the row's end runs on into the next rows;
// - MSP version 2 (MspImagePlugin.MspDecoder): each row of the row map
//   decoded on from the last, an empty row white;
// - XBM (XbmDecode.c): the two characters after each 'x' as hex digits;
// - ICNS RLE24 (IcnsImagePlugin.read_32): three channels one after another.
//
// Every entry point returns 0, or a negative value with a message in `err`.

#include <algorithm>
#include <cstring>
#include <vector>

#include "codec_common.h"

namespace {

using qie::CodecError;

// TgaRleDecode.c: `rows` rows of `row_bytes` in file order, `depth` bytes a
// pixel (0 for a 1-bit image, which never fills a row).
void tga_rle(const uint8_t* p, size_t n, size_t depth, size_t row_bytes, size_t rows,
             uint8_t* out) {
  size_t x = 0, y = 0, extra = 0;
  std::vector<uint8_t> row(row_bytes);
  while (true) {
    if (n < 1) throw CodecError("truncated TGA: the RLE data ends before the image is full");
    size_t count = depth * ((p[0] & 0x7f) + 1);
    if (p[0] & 0x80) {
      if (n < 1 + depth)
        throw CodecError("truncated TGA: the RLE data ends before the image is full");
      if (x + count > row_bytes) throw CodecError("corrupt TGA: an RLE run crosses a row");
      for (size_t i = 0; i < count; i += depth) memcpy(&row[x + i], p + 1, depth);
      p += 1 + depth;
      n -= 1 + depth;
    } else {
      if (n < 1 + count)
        throw CodecError("truncated TGA: the RLE data ends before the image is full");
      if (x + count > row_bytes) {  // the rest runs on into the next rows
        extra = count - (row_bytes - x);
        count = row_bytes - x;
      }
      memcpy(&row[x], p + 1, count);
      p += 1 + count;
      n -= 1 + count;
    }
    while (true) {
      x += count;
      if (x >= row_bytes) {
        memcpy(out + y * row_bytes, row.data(), row_bytes);
        x = 0;
        if (++y >= rows) return;
      }
      if (extra == 0 || x > 0) break;
      count = extra >= row_bytes ? row_bytes : extra;
      memcpy(&row[x], p, count);
      p += count;
      n -= count;
      extra -= count;
    }
  }
}

// PackbitsDecode.c: rows of `row_bytes` from one stream.
void packbits(const uint8_t* p, size_t n, size_t row_bytes, size_t rows, uint8_t* out) {
  size_t x = 0, y = 0;
  uint8_t* row = out;
  while (true) {
    if (n < 1) throw CodecError("truncated PSD: the PackBits data ends before the image is full");
    if (p[0] & 0x80) {
      if (p[0] == 0x80) {  // no operation
        p++;
        n--;
        continue;
      }
      if (n < 2)
        throw CodecError("truncated PSD: the PackBits data ends before the image is full");
      for (int k = 257 - p[0]; k > 0 && x < row_bytes; k--) row[x++] = p[1];
      p += 2;
      n -= 2;
    } else {
      size_t k = size_t(p[0]) + 2;
      if (n < k)
        throw CodecError("truncated PSD: the PackBits data ends before the image is full");
      for (size_t i = 1; i < k && x < row_bytes; i++) row[x++] = p[i];
      p += k;
      n -= k;
    }
    if (x >= row_bytes) {
      x = 0;
      row += row_bytes;
      if (++y >= rows) return;
    }
  }
}

// PcxDecode.c: lines of `line_bytes` (every plane of a row) of an image
// `width` wide at `bits` a pixel of the raw mode (2 and 4 for 2 and 4 bit
// planes), each line's planes moved together to their unpadded length.
void pcx_rle(const uint8_t* p, size_t n, size_t line_bytes, size_t width, int bits,
             size_t rows, uint8_t* out) {
  size_t plane, bands, stride = 0;
  if (bits == 2 || bits == 4) {
    plane = (width + 7) / 8;
    bands = size_t(bits);
    stride = line_bytes / bands;
  } else {
    plane = width;
    bands = line_bytes / width;
    if (bands) stride = line_bytes / bands;
  }
  size_t x = 0, y = 0;
  bool overrun = false;
  uint8_t* line = out;
  while (true) {
    if (n < 1) throw CodecError("truncated PCX: the RLE data ends before the image is full");
    if ((p[0] & 0xC0) == 0xC0) {
      if (n < 2) throw CodecError("truncated PCX: the RLE data ends before the image is full");
      for (int k = p[0] & 0x3F; k > 0; k--) {
        if (x >= line_bytes) {
          overrun = true;  // PcxDecode.c's error code, reported when the image is full
          break;
        }
        line[x++] = p[1];
      }
      p += 2;
      n -= 2;
    } else {
      line[x++] = p[0];
      p++;
      n--;
    }
    if (x >= line_bytes) {
      if (stride > plane)
        for (size_t i = 1; i < bands; i++) memmove(line + i * plane, line + i * stride, plane);
      x = 0;
      line += line_bytes;
      if (++y >= rows) {
        if (overrun) throw CodecError("corrupt PCX: an RLE run crosses a line");
        return;
      }
    }
  }
}

// SgiRleDecode.c's expandrow / expandrow2: one row of one channel into
// `dest` (every `z`-th sample of `bpc` bytes) from `d[at...]`, `n` packets
// at most; its bounds are those tests against the file's last byte
// (`last`), which a literal may not reach. Returns -1 for an overrun, 1
// where the row's last packet is not its end (the decode stops there),
// else 0.
int sgi_row(uint8_t* dest, const uint8_t* d, uint64_t at, int64_t n, int z, int xsize, int bpc,
            uint64_t last) {
  int x = 0;
  for (; n > 0; n--) {
    if (at + (bpc - 1) > last) return -1;
    uint8_t pixel = d[at + (bpc - 1)];
    at += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (at + uint64_t(bpc) * count > last) return -1;
      while (count--) {
        memcpy(dest, d + at, bpc);
        at += bpc;
        dest += z * bpc;
      }
    } else {
      if (at + (bpc - 1) > last) return -1;
      while (count--) {
        memcpy(dest, d + at, bpc);
        dest += z * bpc;
      }
      at += bpc;
    }
  }
  return 0;
}

// SgiRleDecode.c: `d` is the file past its 512-byte header; rows of `bands`
// interleaved samples of `bpc` bytes, in file order (bottom row first).
// A row's length bounds its packets, not its bytes; rows after an early
// end stay zero; a row whose data ends early keeps the rest of the row
// before it (the row buffer is never cleared).
void sgi_rle(const uint8_t* d, size_t n, int xsize, int ysize, int bands, int bpc,
             uint8_t* out) {
  const size_t tablen = size_t(bands) * size_t(ysize);
  if (n < 8 * tablen) throw CodecError("corrupt SGI: the RLE tables run past the file");
  auto be32 = [&](size_t at) {
    return uint32_t(d[at]) << 24 | uint32_t(d[at + 1]) << 16 | uint32_t(d[at + 2]) << 8 |
           uint32_t(d[at + 3]);
  };
  const size_t row_bytes = size_t(xsize) * size_t(bands) * size_t(bpc);
  std::vector<uint8_t> row(row_bytes, 0);
  for (size_t r = 0; r < size_t(ysize); r++) {
    for (int c = 0; c < bands; c++) {
      size_t t = r + size_t(c) * size_t(ysize);
      uint32_t start = be32(4 * t), length = be32(4 * (tablen + t));
      if (start < 512) throw CodecError("corrupt SGI: an RLE row starts in the header");
      int status = sgi_row(&row[size_t(c) * size_t(bpc)], d, uint64_t(start) - 512,
                           int32_t(length), bands, xsize, bpc, n - 1);
      if (status == -1) throw CodecError("corrupt SGI: an RLE row overruns");
      if (status == 1) return;
    }
    memcpy(out + r * row_bytes, row.data(), row_bytes);
  }
}

// QoiImagePlugin.QoiDecoder: `pixels` RGBA pixels (the alpha as decoded).
void qoi(const uint8_t* p, size_t n, size_t pixels, uint8_t* out) {
  uint8_t seen[64][4] = {};  // an index never set reads (0, 0, 0, 0)
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t pos = 0, done = 0;
  auto need = [&](size_t k) {
    if (pos + k > n) throw CodecError("truncated QOI: the data ends before the image is full");
  };
  while (done < pixels) {
    need(1);
    uint8_t b = p[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      need(3);
      memcpy(v, p + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      need(4);
      memcpy(v, p + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      need(1);
      uint8_t b2 = p[pos++];
      int dg = (b & 63) - 32;
      v[0] = uint8_t(prev[0] + dg + ((b2 >> 4) & 15) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (b2 & 15) - 8);
      v[3] = prev[3];
    } else {  // a run of the previous pixel, the table left as it is
      size_t run = std::min(size_t(b & 63) + 1, pixels - done);
      for (size_t i = 0; i < run; i++) memcpy(out + 4 * (done + i), prev, 4);
      done += run;
      continue;
    }
    memcpy(prev, v, 4);
    int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    memcpy(seen[h], v, 4);
    memcpy(out + 4 * done++, v, 4);
  }
}

// SunRleDecode.c: `rows` rows of `row_bytes` (not padded, as the decoder
// counts them).
void sun_rle(const uint8_t* p, size_t n, size_t row_bytes, size_t rows, uint8_t* out) {
  std::vector<uint8_t> row(row_bytes);
  size_t x = 0, y = 0;
  auto truncated = [] {
    return CodecError("truncated SUN: the RLE data ends before the image is full");
  };
  while (true) {
    if (n < 1) throw truncated();
    size_t count = 1, extra = 0;
    uint8_t value = p[0];
    if (p[0] == 0x80) {
      if (n < 2) throw truncated();
      if (p[1] == 0) {  // a literal 0x80
        p += 2;
        n -= 2;
      } else {  // a run of p[1] + 1
        if (n < 3) throw truncated();
        count = size_t(p[1]) + 1;
        value = p[2];
        if (x + count > row_bytes) {
          extra = count - (row_bytes - x);
          count = row_bytes - x;
        }
        p += 3;
        n -= 3;
      }
    } else {
      p++;
      n--;
    }
    memset(&row[x], value, count);
    while (true) {
      x += count;
      if (x >= row_bytes) {
        memcpy(out + y * row_bytes, row.data(), row_bytes);
        x = 0;
        if (++y >= rows) return;
      }
      if (extra == 0 || x > 0) break;
      count = std::min(extra, row_bytes);
      memset(&row[x], value, count);
      extra -= count;
    }
  }
}

// MspDecoder: `rows` row lengths (little-endian 16-bit) from the start of
// `p`, then each row's packets; the rows' output joined end to end into
// `out` (`size` bytes, the image's rows of `row_bytes`), what is past it
// dropped. Every row is decoded, whatever it adds, as Pillow decodes them.
void msp_rle(const uint8_t* p, size_t n, size_t row_bytes, size_t rows, uint8_t* out) {
  const size_t size = row_bytes * rows;
  if (n < 2 * rows) throw CodecError("truncated MSP: the row map ends early");
  size_t at = 2 * rows, done = 0;
  auto put = [&](const uint8_t* src, uint8_t value, size_t k) {
    size_t take = std::min(k, size - done);
    if (src)
      memcpy(out + done, src, take);
    else
      memset(out + done, value, take);
    done += take;
  };
  for (size_t r = 0; r < rows; r++) {
    size_t len = qie::le16(p + 2 * r);
    if (len == 0) {  // a blank line
      put(nullptr, 0xFF, row_bytes);
      continue;
    }
    if (n - at < len) throw CodecError("truncated MSP: a row ends early");
    const uint8_t* row = p + at;
    at += len;
    for (size_t i = 0; i < len;) {
      uint8_t type = row[i++];
      if (type == 0) {
        if (i + 2 > len) throw CodecError("corrupt MSP: a run is cut by its row's end");
        put(nullptr, row[i + 1], row[i]);
        i += 2;
      } else {
        put(row + i, 0, std::min(size_t(type), len - i));
        i += type;
      }
    }
  }
  if (done < size) throw CodecError("corrupt MSP: not enough image data");
}

int hex_digit(uint8_t v) {
  if (v >= '0' && v <= '9') return v - '0';
  if (v >= 'a' && v <= 'f') return v - 'a' + 10;
  if (v >= 'A' && v <= 'F') return v - 'A' + 10;
  return 0;
}

// XbmDecode.c: `size` bytes, each the two characters after the next 'x'
// (anything not a hex digit reads 0), the scan going on three past it.
void xbm(const uint8_t* p, size_t n, size_t size, uint8_t* out) {
  size_t at = 0;
  for (size_t k = 0; k < size; k++) {
    const void* x = at < n ? memchr(p + at, 'x', n - at) : nullptr;
    if (!x) throw CodecError("truncated XBM: the bits end before the image is full");
    at = size_t(static_cast<const uint8_t*>(x) - p);
    if (n - at < 3) throw CodecError("truncated XBM: the bits end before the image is full");
    out[k] = uint8_t(hex_digit(p[at + 1]) << 4 | hex_digit(p[at + 2]));
    at += 3;
  }
}

// IcnsImagePlugin.read_32's RLE: three channels of `pixels` bytes, one
// after another from `p`, into RGB `out`; a literal of c + 1 bytes
// (c < 0x80), a run of c - 125. A channel must end exactly at its size and
// every read be whole.
void icns_rle(const uint8_t* p, size_t n, size_t pixels, uint8_t* out) {
  size_t at = 0;
  for (int band = 0; band < 3; band++) {
    size_t x = 0;
    while (x < pixels) {
      if (at >= n) throw CodecError("truncated ICNS: an RLE channel ends early");
      uint8_t c = p[at++];
      size_t k = c & 0x80 ? size_t(c) - 125 : size_t(c) + 1;
      if (x + k > pixels) throw CodecError("corrupt ICNS: an RLE channel runs past its size");
      if (n - at < (c & 0x80 ? 1 : k))
        throw CodecError("truncated ICNS: an RLE channel ends early");
      for (size_t i = 0; i < k; i++) out[3 * (x + i) + band] = p[c & 0x80 ? at : at + i];
      at += c & 0x80 ? 1 : k;
      x += k;
    }
  }
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
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

int qie_tga_rle(const uint8_t* data, long n, int depth, long row_bytes, long rows,
                uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    tga_rle(data, size_t(n), size_t(depth), size_t(row_bytes), size_t(rows), out);
  });
}

int qie_packbits(const uint8_t* data, long n, long row_bytes, long rows, uint8_t* out,
                 char* err, int errlen) {
  return guarded(err, errlen,
                 [&] { packbits(data, size_t(n), size_t(row_bytes), size_t(rows), out); });
}

int qie_pcx_rle(const uint8_t* data, long n, long line_bytes, long width, int bits, long rows,
                uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    pcx_rle(data, size_t(n), size_t(line_bytes), size_t(width), bits, size_t(rows), out);
  });
}

int qie_sgi_rle(const uint8_t* data, long n, int xsize, int ysize, int bands, int bpc,
                uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { sgi_rle(data, size_t(n), xsize, ysize, bands, bpc, out); });
}

int qie_qoi(const uint8_t* data, long n, long pixels, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { qoi(data, size_t(n), size_t(pixels), out); });
}

int qie_sun_rle(const uint8_t* data, long n, long row_bytes, long rows, uint8_t* out,
                char* err, int errlen) {
  return guarded(err, errlen,
                 [&] { sun_rle(data, size_t(n), size_t(row_bytes), size_t(rows), out); });
}

int qie_msp_rle(const uint8_t* data, long n, long row_bytes, long rows, uint8_t* out,
                char* err, int errlen) {
  return guarded(err, errlen,
                 [&] { msp_rle(data, size_t(n), size_t(row_bytes), size_t(rows), out); });
}

int qie_xbm(const uint8_t* data, long n, long size, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { xbm(data, size_t(n), size_t(size), out); });
}

int qie_icns_rle(const uint8_t* data, long n, long pixels, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] { icns_rle(data, size_t(n), size_t(pixels), out); });
}

}  // extern "C"
