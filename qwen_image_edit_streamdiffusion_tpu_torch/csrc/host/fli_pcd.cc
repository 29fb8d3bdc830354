// The frame chunks of FLI/FLC animations, the base image of a Kodak
// PhotoCD and IM's bit-packed float samples, on the host, as Pillow's C
// decoders decode them (core/codec.py reads the headers and palettes):
//
// - FLI (FliDecode.c): one call of the decoder on the bytes read so far, as
//   ImageFile.load makes it: a frame chunk whose size the bytes do not
//   reach (one pad byte allowed) asks for more; then its subchunks: SS2
//   word deltas (7), LC byte deltas (12), BLACK (13), BRUN byte runs (15),
//   COPY (16), the colour (4, 11) and postage-stamp (18) chunks skipped;
//   any other kind, a packet past its line, a line past the image or data
//   past the bytes is an error, and a COPY chunk that the bytes do not
//   reach returns the bytes before it as consumed;
// - PCD (PcdDecode.c): the 768 x 512 base image at 96 x 2048, each 2304
//   bytes two luma rows and a half-width row of each chroma, through
//   Pillow's PhotoYCC unpacker (UnpackYCC.c: additive tables, clamped);
// - IM's "F;n" samples (BitDecode.c, fill 3, pad 8, unsigned, bottom-up):
//   bits taken least significant first, each row from a fresh bit count
//   while the bits left over from the last row stay in the buffer.
//
// Every entry point returns a status, or a negative value with a message
// in `err`.

#include <cstring>

#include "codec_common.h"

namespace {

using qie::CodecError;
using qie::le16;

constexpr int kFliMore = -1;  // not an error: the frame is done

// ImagingFliDecode on `buf` (n bytes) into `im` (w x h, one byte a pixel).
// Returns the bytes consumed (the caller reads more and calls again), or
// kFliMore at the frame's end; throws on what Pillow reports as an error.
long fli_decode(const uint8_t* buf, long n, uint8_t* im, long w, long h) {
  if (n < 4) return 0;
  const uint8_t* ptr = buf;
  long bytes = n;
  // the sizes as unsigned: Pillow's build never sees a negative one
  int64_t framesize = qie::le32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;  // one pad byte allowed
  if (bytes < 8) throw CodecError("corrupt FLI: a frame chunk cut short");
  if (le16(ptr + 4) != 0xF1FA) throw CodecError("corrupt FLI: not a frame chunk");
  int chunks = int(le16(ptr + 6));
  ptr += 16;
  bytes -= 16;
  auto oob = [&](const uint8_t* data, long k) {
    if (data + k > ptr + bytes) throw CodecError("corrupt FLI: a chunk runs past its data");
  };
  const char* overrun = "corrupt FLI: a chunk runs past the image";
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) throw CodecError("corrupt FLI: a chunk header cut short");
    const uint8_t* data = ptr + 6;
    switch (le16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;  // colours (read with the header) and the postage stamp
      case 7: {  // SS2: word deltas
        long lines = le16(data), l, y;
        data += 2;
        for (l = y = 0; l < lines && y < h; l++, y++) {
          uint8_t* row = im + y * w;
          oob(data, 2);
          uint32_t packets = le16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - long(packets);  // lines skipped
              if (y >= h) throw CodecError(overrun);
              row = im + y * w;
            } else {
              row[w - 1] = uint8_t(packets);  // the last byte of an odd width
            }
            oob(data, 2);
            packets = le16(data);
            data += 2;
          }
          long p, x;
          for (p = x = 0; p < long(packets); p++) {
            oob(data, 2);
            x += data[0];
            if (data[1] >= 128) {
              oob(data, 4);
              long i = 256 - data[1];
              if (x + i + i > w) break;
              for (long j = 0; j < i; j++) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              long i = 2 * long(data[1]);
              if (x + i > w) break;
              oob(data, 2 + i);
              memcpy(row + x, data + 2, size_t(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < long(packets)) break;
        }
        if (l < lines) throw CodecError(overrun);
        break;
      }
      case 12: {  // LC: byte deltas
        long y = le16(data), ymax = y + long(le16(data + 2));
        data += 4;
        for (; y < ymax && y < h; y++) {
          uint8_t* row = im + y * w;
          oob(data, 1);
          long packets = *data++, p, x, i = 0;
          for (p = x = 0; p < packets; p++, x += i) {
            oob(data, 2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > w) break;
              oob(data, 3);
              memset(row + x, data[2], size_t(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > w) break;
              oob(data, 2 + i);
              memcpy(row + x, data + 2, size_t(i));
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) throw CodecError(overrun);
        break;
      }
      case 13:  // BLACK
        memset(im, 0, size_t(w * h));
        break;
      case 15:  // BRUN: byte runs, every line whole
        for (long y = 0; y < h; y++) {
          uint8_t* row = im + y * w;
          data += 1;  // the packet count, not used
          long x, i = 0;
          for (x = 0; x < w; x += i) {
            oob(data, 2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > w) break;
              oob(data, i + 1);
              memcpy(row + x, data + 1, size_t(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > w) break;
              memset(row + x, data[1], size_t(i));
              data += 2;
            }
          }
          if (x != w) throw CodecError(overrun);
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / w < h) throw CodecError(overrun);
        if (data + w * h > ptr + bytes) return long(ptr - buf);  // asks for more
        memcpy(im, data, size_t(w * h));
        break;
      default:
        throw CodecError("corrupt FLI: a chunk of unknown kind " +
                         std::to_string(le16(ptr + 4)));
    }
    int64_t advance = qie::le32(ptr);
    if (advance == 0) throw CodecError("corrupt FLI: a chunk of size 0");
    if (advance > bytes) throw CodecError("corrupt FLI: a chunk past the frame");
    ptr += advance;
    bytes -= advance;
  }
  return kFliMore;
}

// UnpackYCC.c's tables: L[y] = y * 1.3584 rounded; a chroma's share of
// blue and green (Cb) and of red and green (Cr).
const int16_t kCb[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314, -312,
    -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281, -278, -276,
    -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214, -212, -210, -207, -205,
    -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181, -179, -176, -174, -172, -170,
    -168, -165, -163, -161, -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63,
    -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7,
    9, 11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42,
    44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111, 113,
    115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220,
};
const int16_t kGb[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61,
    60, 60, 59, 59, 59, 58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54,
    53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40,
    40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33,
    33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19,
    19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12,
    12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0,
    -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6, -7, -7,
    -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21,
    -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42,
};
const int16_t kCr[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223, -221,
    -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196, -194, -192,
    -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141, -139, -137, -136, -134,
    -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114, -112, -110, -108, -106, -105,
    -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46,
    -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35, 36, 38, 40,
    42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69,
    71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128,
    129, 131, 133, 135, 137, 138, 140, 142, 144, 146, 148, 149, 151, 153, 155, 157,
    158, 160, 162, 164, 166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208, 209, 211, 213, 215,
};
const int16_t kGr[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    112, 111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98,
    97, 96, 95, 95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71, 70, 70, 69,
    68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54,
    53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24,
    23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9,
    8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19,
    -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34,
    -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79,
    -80, -81, -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108,
};

inline uint8_t clamp255(int v) { return uint8_t(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// PcdDecode.c + ImagingUnpackYCC: 256 chunks of 3 x 768 bytes at `p` into
// out (512, 768, 3).
void pcd(const uint8_t* p, size_t n, uint8_t* out) {
  const long w = 768, rows = 512, chunk = 3 * w;
  if (n < size_t(chunk * rows / 2))
    throw CodecError("truncated PCD: the image data ends before the base image is full");
  for (long y = 0; y < rows; y += 2, p += chunk) {
    for (long k = 0; k < 2; k++) {
      uint8_t* o = out + (y + k) * w * 3;
      for (long x = 0; x < w; x++, o += 3) {
        int l = (p[x + k * w] * 13584 + 5000) / 10000;
        int cb = p[(x + 4 * w) / 2], cr = p[(x + 5 * w) / 2];
        o[0] = clamp255(l + kCr[cr]);
        o[1] = clamp255(l + kGr[cr] + kGb[cb]);
        o[2] = clamp255(l + kCb[cb]);
      }
    }
  }
}

// BitDecode.c with fill 3 (bytes into the buffer's top, samples from its
// bottom), pad 8, unsigned samples, rows bottom-up, into out (h, w).
void im_bits(const uint8_t* p, size_t n, int bits, long w, long h, float* out) {
  if (bits < 1 || bits >= 32) throw CodecError("corrupt IM: samples of " +
                                               std::to_string(bits) + " bits");
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buffer = 0;
  int count = 0;
  long x = 0, y = h - 1;
  for (size_t k = 0; k < n; k++) {
    uint8_t byte = p[k];
    buffer |= uint64_t(byte) << count;
    count += 8;
    while (count >= bits) {
      uint64_t v = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[y * w + x] = float(v);
      if (++x >= w) {
        if (--y < 0) return;
        x = 0;
        count = 0;  // pad: a fresh count, the leftover bits kept
      }
    }
  }
  throw CodecError("truncated IM: the samples end before the image is full");
}

template <typename F>
long guarded(char* err, int errlen, F&& f) {
  try {
    return f();
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return -2;
  }
}

}  // namespace

extern "C" {

// >= 0: bytes consumed, more wanted; -1: the frame is done; -2: an error.
long qie_fli_frame(const uint8_t* data, long n, uint8_t* im, long w, long h, char* err,
                   int errlen) {
  return guarded(err, errlen, [&] { return fli_decode(data, n, im, w, h); });
}

long qie_pcd(const uint8_t* data, long n, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    pcd(data, size_t(n), out);
    return 0L;
  });
}

long qie_im_bits(const uint8_t* data, long n, int bits, long w, long h, float* out, char* err,
                 int errlen) {
  return guarded(err, errlen, [&] {
    im_bits(data, size_t(n), bits, w, h, out);
    return 0L;
  });
}

}  // extern "C"
