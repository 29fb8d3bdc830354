// What the host codec's sources share: the error they throw, the
// decompression-bomb limit and the message hand-off of the C entry points.

#pragma once

#include <cstdint>
#include <cstdio>
#include <stdexcept>
#include <string>

namespace qie {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Pillow's DecompressionBombError limit (2 * Image.MAX_IMAGE_PIXELS), checked
// before anything of an image is allocated (core/codec.py holds PNG to it).
constexpr int64_t kMaxPixels = 178956970;

inline void check_pixels(const char* format, int64_t w, int64_t h) {
  if (w <= 0 || h <= 0)
    throw CodecError(std::string("corrupt ") + format + ": zero width or height");
  if (w * h > kMaxPixels)
    throw CodecError(std::string("unsupported ") + format + ": " + std::to_string(w) + "x" +
                     std::to_string(h) + " pixels exceed the decompression-bomb limit");
}

inline void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | (uint32_t(p[1]) << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }

}  // namespace qie
