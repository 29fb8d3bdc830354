// AV1 still images as an AVIF item holds them: the OBUs, the sequence and
// frame headers of a key frame, tile info, the symbol decoder and its CDFs,
// the intra frame's block syntax and its lossless reconstruction (4x4
// coefficients through the inverse Walsh-Hadamard transform), with every
// intra prediction mode, filter intra, chroma from luma and the intra edge
// filter and upsampling. Written from the AV1 specification's decoding
// process; where a stream leaves that process undefined (symbols read past
// a tile's end, coefficients out of range) it does what dav1d 1.5.1 does,
// since that is what Pillow's libavif decodes with. Tiles decode on up to
// eight threads; each writes its own samples.
//
// Refused, each by name (the caller raises a ValueError naming AVIF and the
// feature): bit depths above 8, frames that are not lossless (base_q_idx or
// a segment's q index above 0), screen-content tools (palette, intra block
// copy), superres, film grain, several operating points, frames that are
// not shown key frames.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "av1_tables.h"
#include "codec_common.h"

namespace {

using qie::CodecError;

struct Refused : CodecError {
  using CodecError::CodecError;
};

[[noreturn]] void corrupt(const std::string& what) { throw CodecError("corrupt AVIF: " + what); }
[[noreturn]] void refuse(const std::string& what) { throw Refused(what); }

// ---------------------------------------------------------------------------
// Headers: big-endian bits
// ---------------------------------------------------------------------------

struct Bits {
  const uint8_t* p;
  size_t n;       // bytes
  size_t pos = 0; // bits
  Bits(const uint8_t* d, size_t len) : p(d), n(len) {}
  uint32_t f(int bits) {
    uint32_t x = 0;
    for (int i = 0; i < bits; i++) {
      if (pos >= 8 * n) corrupt("a header runs past its OBU");
      x = (x << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return x;
  }
  int32_t su(int bits) {
    int32_t v = int32_t(f(bits));
    int32_t sign = 1 << (bits - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t ns(uint32_t n_) {
    int w = 0;
    for (uint32_t x = n_; x; x >>= 1) w++;
    uint32_t m = (1u << w) - n_;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!f(1)) {
      if (++lz >= 32) return 0xFFFFFFFFu;
    }
    return lz ? f(lz) + (1u << lz) - 1 : 0;
  }
  void byte_align() {
    while (pos & 7) f(1);
  }
};

size_t leb128(const uint8_t* p, size_t n, size_t& at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    if (at >= n) corrupt("an OBU size runs past the item");
    uint8_t b = p[at++];
    v |= uint64_t(b & 0x7f) << (7 * i);
    if (!(b & 0x80)) break;
  }
  if (v > (1ull << 32) - 1) corrupt("an OBU size above 2^32 - 1");
  return size_t(v);
}

struct Sequence {
  int profile = 0, still = 0, reduced = 0;
  int op_count = 1, op_idc = 0;
  int decoder_model = 0, equal_picture_interval = 0, frame_presentation_bits = 0;
  int buffer_removal_bits = 0;
  int decoder_model_for_op[32] = {};
  int op_idc_all[32] = {};
  int width_bits = 0, height_bits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers = 0, delta_frame_id_bits = 0, frame_id_bits = 0;
  int sb128 = 0, filter_intra = 0, edge_filter = 0;
  int order_hint = 0, order_hint_bits = 0;
  int force_screen_content = 2, force_integer_mv = 2;
  int superres = 0, cdef = 0, restoration = 0;
  int bitdepth = 8, mono = 0, color_description = 0;
  int primaries = 2, transfer = 2, matrix = 2, range = 0;
  int ssx = 1, ssy = 1, separate_uv_delta_q = 0;
  int film_grain = 0;
  bool seen = false;
};

void parse_sequence(Bits& b, Sequence& s) {
  s = Sequence();
  s.profile = int(b.f(3));
  if (s.profile > 2) corrupt("seq_profile above 2");
  s.still = int(b.f(1));
  s.reduced = int(b.f(1));
  if (s.reduced && !s.still) corrupt("a reduced still-picture header on a moving sequence");
  if (s.reduced) {
    b.f(5);  // seq_level_idx[0]
  } else {
    int delay_bits = 0, timing = int(b.f(1));
    if (timing) {
      b.f(32);
      b.f(32);
      s.equal_picture_interval = int(b.f(1));
      if (s.equal_picture_interval && b.uvlc() == 0xFFFFFFFFu) corrupt("num_ticks_per_picture");
      s.decoder_model = int(b.f(1));
      if (s.decoder_model) {
        delay_bits = int(b.f(5)) + 1;
        b.f(32);
        s.buffer_removal_bits = int(b.f(5)) + 1;
        s.frame_presentation_bits = int(b.f(5)) + 1;
      }
    }
    int display_delay = int(b.f(1));
    s.op_count = int(b.f(5)) + 1;
    for (int i = 0; i < s.op_count; i++) {
      s.op_idc_all[i] = int(b.f(12));
      int level = int(b.f(5));
      if (level > 7) b.f(1);
      if (s.decoder_model) {
        s.decoder_model_for_op[i] = int(b.f(1));
        if (s.decoder_model_for_op[i]) {
          b.f(delay_bits);  // decoder and encoder buffer delays, low-delay mode
          b.f(delay_bits);
          b.f(1);
        }
      }
      if (display_delay && b.f(1)) b.f(4);
    }
    s.op_idc = s.op_idc_all[0];
  }
  s.width_bits = int(b.f(4)) + 1;
  s.height_bits = int(b.f(4)) + 1;
  s.max_w = int(b.f(s.width_bits)) + 1;
  s.max_h = int(b.f(s.height_bits)) + 1;
  if (!s.reduced) s.frame_id_numbers = int(b.f(1));
  if (s.frame_id_numbers) {
    s.delta_frame_id_bits = int(b.f(4)) + 2;
    s.frame_id_bits = int(b.f(3)) + 1 + s.delta_frame_id_bits;
  }
  s.sb128 = int(b.f(1));
  s.filter_intra = int(b.f(1));
  s.edge_filter = int(b.f(1));
  if (!s.reduced) {
    b.f(4);  // interintra, masked compound, warped motion, dual filter
    s.order_hint = int(b.f(1));
    if (s.order_hint) b.f(2);  // jnt_comp, ref_frame_mvs
    if (b.f(1)) {
      s.force_screen_content = 2;
    } else {
      s.force_screen_content = int(b.f(1));
    }
    if (s.force_screen_content > 0) {
      if (b.f(1)) s.force_integer_mv = 2;
      else s.force_integer_mv = int(b.f(1));
    } else {
      s.force_integer_mv = 2;
    }
    if (s.order_hint) s.order_hint_bits = int(b.f(3)) + 1;
  }
  s.superres = int(b.f(1));
  s.cdef = int(b.f(1));
  s.restoration = int(b.f(1));
  // color_config
  int high = int(b.f(1));
  if (s.profile == 2 && high) s.bitdepth = b.f(1) ? 12 : 10;
  else s.bitdepth = high ? 10 : 8;
  s.mono = s.profile == 1 ? 0 : int(b.f(1));
  s.color_description = int(b.f(1));
  if (s.color_description) {
    s.primaries = int(b.f(8));
    s.transfer = int(b.f(8));
    s.matrix = int(b.f(8));
  }
  if (s.mono) {
    s.range = int(b.f(1));
    s.ssx = s.ssy = 1;
    s.separate_uv_delta_q = 0;
  } else {
    if (s.primaries == 1 && s.transfer == 13 && s.matrix == 0) {
      s.range = 1;
      s.ssx = s.ssy = 0;
    } else {
      s.range = int(b.f(1));
      if (s.profile == 0) {
        s.ssx = s.ssy = 1;
      } else if (s.profile == 1) {
        s.ssx = s.ssy = 0;
      } else if (s.bitdepth == 12) {
        s.ssx = int(b.f(1));
        s.ssy = s.ssx ? int(b.f(1)) : 0;
      } else {
        s.ssx = 1;
        s.ssy = 0;
      }
      if (s.ssx && s.ssy) b.f(2);  // chroma_sample_position
    }
    s.separate_uv_delta_q = int(b.f(1));
  }
  s.film_grain = int(b.f(1));
  s.seen = true;
}

// ---------------------------------------------------------------------------
// Block sizes and their tables
// ---------------------------------------------------------------------------

enum { B4x4, B4x8, B8x4, B8x8, B8x16, B16x8, B16x16, B16x32, B32x16, B32x32, B32x64, B64x32,
       B64x64, B64x128, B128x64, B128x128, B4x16, B16x4, B8x32, B32x8, B16x64, B64x16,
       BLOCK_INVALID };
const int kW4[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const int kH4[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};

int log2i(int v) {
  int k = 0;
  while ((1 << (k + 1)) <= v) k++;
  return k;
}

int size_of(int w4, int h4) {
  for (int b = 0; b < 22; b++)
    if (kW4[b] == w4 && kH4[b] == h4) return b;
  return BLOCK_INVALID;
}

// Subsampled_Size[bsize][ssx][ssy]
int subsampled(int b, int ssx, int ssy) {
  if (b == BLOCK_INVALID) return BLOCK_INVALID;
  if (!ssx && !ssy) return b;
  int w4 = kW4[b], h4 = kH4[b];
  if (ssx && ssy) return size_of(std::max(1, w4 >> 1), std::max(1, h4 >> 1));
  if (ssx && !ssy) return w4 == 1 ? (h4 == 1 ? B4x4 : BLOCK_INVALID) : size_of(w4 >> 1, h4);
  return h4 == 1 ? (w4 == 1 ? B4x4 : BLOCK_INVALID) : size_of(w4, h4 >> 1);
}

enum { P_NONE, P_HORZ, P_VERT, P_SPLIT, P_HORZ_A, P_HORZ_B, P_VERT_A, P_VERT_B, P_HORZ_4,
       P_VERT_4 };

int subsize(int p, int b) {
  int w = kW4[b], h = kH4[b];
  switch (p) {
    case P_NONE: return b;
    case P_HORZ: case P_HORZ_A: case P_HORZ_B: return size_of(w, h / 2);
    case P_VERT: case P_VERT_A: case P_VERT_B: return size_of(w / 2, h);
    case P_SPLIT: return size_of(w / 2, h / 2);
    case P_HORZ_4: return size_of(w, h / 4);
    default: return size_of(w / 4, h);
  }
}

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
       D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

inline bool directional(int m) { return m >= V_PRED && m <= D67_PRED; }

// ---------------------------------------------------------------------------
// Frame header
// ---------------------------------------------------------------------------

struct Frame {
  int width = 0, height = 0, upscaled = 0;
  int mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0, screen_content = 0;
  int base_q = 0;
  int dq_ydc = 0, dq_udc = 0, dq_uac = 0, dq_vdc = 0, dq_vac = 0;
  int seg_enabled = 0, seg_pre_skip = 0, last_active_seg = 0;
  int feature_enabled[8][8] = {}, feature_data[8][8] = {};
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int tile_size_bytes = 4;
  std::vector<int> col_starts, row_starts;
  bool coded_lossless = false;
};

const int kSegBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

void parse_frame_header(Bits& b, const Sequence& s, Frame& f, int temporal_id, int spatial_id) {
  f = Frame();
  int frame_type = 0, show_frame = 1, showable = 0, error_resilient = 1;
  if (!s.reduced) {
    if (b.f(1)) refuse("a shown existing frame, not a key frame");
    frame_type = int(b.f(2));
    show_frame = int(b.f(1));
    if (frame_type != 0 || !show_frame) refuse("frames that are not shown key frames");
    if (show_frame && s.decoder_model && !s.equal_picture_interval)
      b.f(s.frame_presentation_bits);
    showable = 0;
    error_resilient = 1;
  }
  (void)showable;
  (void)error_resilient;
  f.disable_cdf_update = int(b.f(1));
  f.screen_content = s.force_screen_content == 2 ? int(b.f(1)) : s.force_screen_content;
  if (f.screen_content && s.force_integer_mv == 2) b.f(1);
  if (s.frame_id_numbers) b.f(s.frame_id_bits);
  int size_override = s.reduced ? 0 : int(b.f(1));
  b.f(s.order_hint_bits);  // order_hint
  // primary_ref_frame: none for a key frame
  if (s.decoder_model) {
    if (b.f(1)) {  // buffer_removal_time_present_flag
      for (int op = 0; op < s.op_count; op++) {
        if (!s.decoder_model_for_op[op]) continue;
        int idc = s.op_idc_all[op];
        bool in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
        if (idc == 0 || (in_t && in_s)) b.f(s.buffer_removal_bits);
      }
    }
  }
  // refresh_frame_flags: all, for a shown key frame
  // frame_size
  if (size_override) {
    f.width = int(b.f(s.width_bits)) + 1;
    f.height = int(b.f(s.height_bits)) + 1;
  } else {
    f.width = s.max_w;
    f.height = s.max_h;
  }
  if (s.superres && b.f(1)) refuse("superres");
  f.upscaled = f.width;
  f.mi_cols = 2 * ((f.width + 7) >> 3);
  f.mi_rows = 2 * ((f.height + 7) >> 3);
  if (b.f(1)) {  // render_and_frame_size_different
    b.f(16);
    b.f(16);
  }
  if (f.screen_content) refuse("screen-content tools (palette and intra block copy)");
  if (!s.reduced && !f.disable_cdf_update) b.f(1);  // disable_frame_end_update_cdf
  // tile_info
  int sb_cols = s.sb128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
  int sb_rows = s.sb128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
  int sb_shift = s.sb128 ? 5 : 4, sb_size = sb_shift + 2;
  int max_tile_width_sb = 4096 >> sb_size;
  int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  int min_log2_cols = tile_log2(max_tile_width_sb, sb_cols);
  int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
  int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
  int min_log2_tiles = std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  if (b.f(1)) {  // uniform_tile_spacing_flag
    f.tile_cols_log2 = min_log2_cols;
    while (f.tile_cols_log2 < max_log2_cols && b.f(1)) f.tile_cols_log2++;
    int w = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
    for (int start = 0; start < sb_cols; start += w) f.col_starts.push_back(start << sb_shift);
    f.col_starts.push_back(f.mi_cols);
    int min_log2_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
    f.tile_rows_log2 = min_log2_rows;
    while (f.tile_rows_log2 < max_log2_rows && b.f(1)) f.tile_rows_log2++;
    int h = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
    for (int start = 0; start < sb_rows; start += h) f.row_starts.push_back(start << sb_shift);
    f.row_starts.push_back(f.mi_rows);
  } else {
    int widest = 0;
    for (int start = 0; start < sb_cols;) {
      f.col_starts.push_back(start << sb_shift);
      int size = int(b.ns(uint32_t(std::min(sb_cols - start, max_tile_width_sb)))) + 1;
      widest = std::max(widest, size);
      start += size;
    }
    f.col_starts.push_back(f.mi_cols);
    int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                  : sb_rows * sb_cols;
    int max_h = std::max(area / widest, 1);
    for (int start = 0; start < sb_rows;) {
      f.row_starts.push_back(start << sb_shift);
      start += int(b.ns(uint32_t(std::min(sb_rows - start, max_h)))) + 1;
    }
    f.row_starts.push_back(f.mi_rows);
    f.tile_cols_log2 = tile_log2(1, int(f.col_starts.size()) - 1);
    f.tile_rows_log2 = tile_log2(1, int(f.row_starts.size()) - 1);
  }
  f.tile_cols = int(f.col_starts.size()) - 1;
  f.tile_rows = int(f.row_starts.size()) - 1;
  if (f.tile_cols > 64 || f.tile_rows > 64) corrupt("more than 64 tile columns or rows");
  if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
    b.f(f.tile_cols_log2 + f.tile_rows_log2);  // context_update_tile_id
    f.tile_size_bytes = int(b.f(2)) + 1;
  }
  // quantization_params
  f.base_q = int(b.f(8));
  f.dq_ydc = read_delta_q(b);
  if (!s.mono) {
    int diff = s.separate_uv_delta_q ? int(b.f(1)) : 0;
    f.dq_udc = read_delta_q(b);
    f.dq_uac = read_delta_q(b);
    if (diff) {
      f.dq_vdc = read_delta_q(b);
      f.dq_vac = read_delta_q(b);
    } else {
      f.dq_vdc = f.dq_udc;
      f.dq_vac = f.dq_uac;
    }
  }
  if (b.f(1)) {  // using_qmatrix
    b.f(4);
    b.f(4);
    if (s.separate_uv_delta_q) b.f(4);
  }
  // segmentation_params
  f.seg_enabled = int(b.f(1));
  if (f.seg_enabled) {
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int v = 0;
        f.feature_enabled[i][j] = int(b.f(1));
        if (f.feature_enabled[i][j]) {
          int bits = kSegBits[j], lim = kSegMax[j];
          if (kSegSigned[j]) v = std::clamp(b.su(1 + bits), -lim, lim);
          else v = std::clamp(int(b.f(bits)), 0, lim);
        }
        f.feature_data[i][j] = v;
      }
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (f.feature_enabled[i][j]) {
          f.last_active_seg = i;
          if (j >= 5) f.seg_pre_skip = 1;
        }
  }
  // delta_q_params: present only above q index 0
  if (f.base_q > 0) refuse("lossy frames (base_q_idx above 0)");
  f.coded_lossless = true;
  for (int seg = 0; seg < 8; seg++) {
    int q = f.base_q;
    if (f.seg_enabled && f.feature_enabled[seg][0])
      q = std::clamp(q + f.feature_data[seg][0], 0, 255);
    if (q != 0 || f.dq_ydc || f.dq_udc || f.dq_uac || f.dq_vdc || f.dq_vac)
      f.coded_lossless = false;
  }
  if (!f.coded_lossless) refuse("lossy frames (a q index or delta above 0)");
  // loop filter, CDEF and loop restoration are off in a coded lossless frame;
  // tx_mode is ONLY_4X4; an intra frame has no reference mode, skip mode,
  // warped motion or global motion
  b.f(1);  // reduced_tx_set
  if (s.film_grain && b.f(1)) refuse("film grain");
}

// ---------------------------------------------------------------------------
// The symbol decoder, as dav1d runs it past a tile's end (zero bytes)
// ---------------------------------------------------------------------------

struct Symbols {
  const uint8_t* p;
  size_t n, at = 0;
  uint32_t value = 0, range = 0;
  int max_bits = 0;
  bool update = true;
  uint32_t bits(int count) {
    uint32_t x = 0;
    for (int i = 0; i < count; i++) {
      size_t byte = at >> 3;
      uint32_t bit = byte < n ? (p[byte] >> (7 - (at & 7))) & 1 : 0;
      x = (x << 1) | bit;
      at++;
    }
    return x;
  }
  void init(const uint8_t* d, size_t len, bool adapt) {
    p = d;
    n = len;
    at = 0;
    update = adapt;
    int num = int(std::min<size_t>(len * 8, 15));
    uint32_t buf = bits(num);
    uint32_t padded = buf << (15 - num);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    max_bits = int(8 * len) - 15;
  }
  int read(uint16_t* cdf, int N) { return decode(cdf, N, update); }
  int decode(uint16_t* cdf, int N, bool adapt) {
    uint32_t cur = range, prev;
    int sym = -1;
    do {
      sym++;
      prev = cur;
      uint32_t fq = (1u << 15) - cdf[sym];
      cur = ((range >> 8) * (fq >> 6) >> 1) + 4 * uint32_t(N - sym - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int b = 15 - log2i(int(range));
    range <<= b;
    int num = std::min(b, std::max(0, max_bits));
    uint32_t data = bits(num);
    uint32_t padded = data << (b - num);
    value = padded ^ (((value + 1) << b) - 1);
    max_bits -= b;
    if (adapt) {
      int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(log2i(N), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < N - 1; i++) {
        tmp = i == sym ? (1u << 15) : tmp;
        if (tmp < cdf[i]) cdf[i] -= uint16_t((cdf[i] - tmp) >> rate);
        else cdf[i] += uint16_t((tmp - cdf[i]) >> rate);
      }
      cdf[N] += cdf[N] < 32;
    }
    return sym;
  }
  int boolean() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    return decode(cdf, 2, false);
  }
  uint32_t literal(int count) {
    uint32_t x = 0;
    for (int i = 0; i < count; i++) x = 2 * x + uint32_t(boolean());
    return x;
  }
};

// the CDFs a tile adapts: the defaults at q context 0 (a lossless frame's)
struct Cdfs {
  uint16_t partition8[4][5], partition16[4][11], partition32[4][11], partition64[4][11],
      partition128[4][9];
  uint16_t y_mode[5][5][14];
  uint16_t uv_nocfl[13][14], uv_cfl[13][15];
  uint16_t angle_delta[8][8];
  uint16_t filter_intra[22][3], filter_intra_mode[6];
  uint16_t cfl_sign[9], cfl_alpha[6][17];
  uint16_t skip[3][3], segment_id[3][9];
  uint16_t txb_skip[13][3], eob16[2][6], eob_extra[2][9][3], dc_sign[2][3][3];
  uint16_t base_eob[2][4][4], base[2][42][5], br[2][21][5];
  void init() {
    using namespace av1tab;
    memcpy(partition8, Default_Partition_W8_Cdf, sizeof partition8);
    memcpy(partition16, Default_Partition_W16_Cdf, sizeof partition16);
    memcpy(partition32, Default_Partition_W32_Cdf, sizeof partition32);
    memcpy(partition64, Default_Partition_W64_Cdf, sizeof partition64);
    memcpy(partition128, Default_Partition_W128_Cdf, sizeof partition128);
    memcpy(y_mode, Default_Intra_Frame_Y_Mode_Cdf, sizeof y_mode);
    memcpy(uv_nocfl, Default_Uv_Mode_Cfl_Not_Allowed_Cdf, sizeof uv_nocfl);
    memcpy(uv_cfl, Default_Uv_Mode_Cfl_Allowed_Cdf, sizeof uv_cfl);
    memcpy(angle_delta, Default_Angle_Delta_Cdf, sizeof angle_delta);
    memcpy(filter_intra, Default_Filter_Intra_Cdf, sizeof filter_intra);
    memcpy(filter_intra_mode, Default_Filter_Intra_Mode_Cdf, sizeof filter_intra_mode);
    memcpy(cfl_sign, Default_Cfl_Sign_Cdf, sizeof cfl_sign);
    memcpy(cfl_alpha, Default_Cfl_Alpha_Cdf, sizeof cfl_alpha);
    memcpy(skip, Default_Skip_Cdf, sizeof skip);
    memcpy(segment_id, Default_Segment_Id_Cdf, sizeof segment_id);
    // q context 0, TX_4X4
    memcpy(txb_skip, Default_Txb_Skip_Cdf[0][0], sizeof txb_skip);
    for (int pt = 0; pt < 2; pt++)
      memcpy(eob16[pt], Default_Eob_Pt_16_Cdf[0][pt][0], sizeof eob16[pt]);
    memcpy(eob_extra, Default_Eob_Extra_Cdf[0][0], sizeof eob_extra);
    memcpy(dc_sign, Default_Dc_Sign_Cdf[0], sizeof dc_sign);
    memcpy(base_eob, Default_Coeff_Base_Eob_Cdf[0][0], sizeof base_eob);
    memcpy(base, Default_Coeff_Base_Cdf[0][0], sizeof base);
    memcpy(br, Default_Coeff_Br_Cdf[0][0], sizeof br);
  }
};

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

struct Picture {
  int planes = 3, ssx = 1, ssy = 1;
  int w[3] = {}, h[3] = {};  // allocated: the mode-info grid's size
  std::vector<uint8_t> px[3];
  uint8_t* at(int plane, int y, int x) { return &px[plane][size_t(y) * w[plane] + x]; }
};

// what the blocks of the frame record for their neighbours (mi units)
struct ModeInfo {
  int cols = 0, rows = 0;
  std::vector<uint8_t> y_mode, uv_mode, skip, mi_size, seg;
  void init(int c, int r) {
    cols = c;
    rows = r;
    size_t n = size_t(c) * r;
    y_mode.assign(n, 0);
    uv_mode.assign(n, 0);
    skip.assign(n, 0);
    mi_size.assign(n, 0);
    seg.assign(n, 0);
  }
};

const int kSigRefOffset[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
const int kMagRefOffset[3][2] = {{0, 1}, {1, 0}, {1, 1}};
const int kCoeffBaseCtxOffset4[5][5] = {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21},
                                        {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}};
const int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline uint8_t clip1(int v) { return uint8_t(std::clamp(v, 0, 255)); }

struct Tile {
  const Sequence& s;
  const Frame& f;
  Picture& pic;
  ModeInfo& mi;
  int row_start, row_end, col_start, col_end;
  Symbols sym;
  Cdfs cdf;
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t decoded[3][35][35];  // BlockDecoded, offset by 1
  int max_luma_w = 0, max_luma_h = 0;
  // the block being decoded
  int mi_row = 0, mi_col = 0, mi_size = 0, has_chroma = 0;
  bool avail_u = false, avail_l = false, avail_u_chroma = false, avail_l_chroma = false;
  int skip = 0, segment = 0, y_mode = 0, uv_mode = 0, angle_y = 0, angle_uv = 0;
  int use_filter_intra = 0, filter_mode = 0, cfl_u = 0, cfl_v = 0;
  int32_t quant[16];

  Tile(const Sequence& s_, const Frame& f_, Picture& p, ModeInfo& m, int tr, int tc)
      : s(s_), f(f_), pic(p), mi(m) {
    row_start = f.row_starts[tr];
    row_end = std::min(f.row_starts[tr + 1], f.mi_rows);
    col_start = f.col_starts[tc];
    col_end = std::min(f.col_starts[tc + 1], f.mi_cols);
    for (int k = 0; k < 3; k++) {
      above_level[k].assign(f.mi_cols + 32, 0);
      above_dc[k].assign(f.mi_cols + 32, 0);
      left_level[k].assign(f.mi_rows + 32, 0);
      left_dc[k].assign(f.mi_rows + 32, 0);
    }
    cdf.init();
  }

  bool inside(int r, int c) const {
    return c >= col_start && c < col_end && r >= row_start && r < row_end;
  }
  size_t idx(int r, int c) const { return size_t(r) * mi.cols + c; }

  void decode(const uint8_t* data, size_t n) {
    sym.init(data, n, !f.disable_cdf_update);
    int sb4 = s.sb128 ? 32 : 16;
    int sb_size = s.sb128 ? B128x128 : B64x64;
    for (int r = row_start; r < row_end; r += sb4) {
      for (int k = 0; k < 3; k++) {
        std::fill(left_level[k].begin(), left_level[k].end(), 0);
        std::fill(left_dc[k].begin(), left_dc[k].end(), 0);
      }
      for (int c = col_start; c < col_end; c += sb4) {
        clear_block_decoded(r, c, sb4);
        partition(r, c, sb_size);
      }
      // dav1d ends a tile whose symbols were read 15 bits or more past its
      // data (its decode_tile_sbrow's overread check, after each row)
      if (sym.max_bits <= -15) corrupt("a tile's symbols run past its data");
    }
  }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int plane = 0; plane < pic.planes; plane++) {
      int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
      int w4 = (col_end - c) >> sx, h4 = (row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < w4) v = 1;
          else if (x < 0 && y < h4) v = 1;
          else v = 0;
          decoded[plane][y + 1][x + 1] = v;
        }
      decoded[plane][(sb4 >> sy) + 1][0] = 0;
    }
  }

  void partition(int r, int c, int bsize) {
    if (r >= f.mi_rows || c >= f.mi_cols) return;
    bool avail_up = inside(r - 1, c), avail_left = inside(r, c - 1);
    int num4 = kW4[bsize], half = num4 >> 1, quarter = half >> 1;
    bool has_rows = (r + half) < f.mi_rows, has_cols = (c + half) < f.mi_cols;
    int p;
    if (bsize < B8x8) {
      p = P_NONE;
    } else {
      int bsl = log2i(kW4[bsize]);
      int above = avail_up && log2i(kW4[mi.mi_size[idx(r - 1, c)]]) < bsl;
      int left = avail_left && log2i(kH4[mi.mi_size[idx(r, c - 1)]]) < bsl;
      int ctx = left * 2 + above;
      uint16_t* pc;
      int n;
      switch (bsl) {
        case 1: pc = cdf.partition8[ctx]; n = 4; break;
        case 2: pc = cdf.partition16[ctx]; n = 10; break;
        case 3: pc = cdf.partition32[ctx]; n = 10; break;
        case 4: pc = cdf.partition64[ctx]; n = 10; break;
        default: pc = cdf.partition128[ctx]; n = 8; break;
      }
      auto prob = [&](int e) { return int(pc[e]) - (e > 0 ? int(pc[e - 1]) : 0); };
      // dav1d refuses a vertical partition of a 4:2:2 frame (aom writes none)
      bool i422 = pic.planes > 1 && s.ssx && !s.ssy;
      if (has_rows && has_cols) {
        p = sym.read(pc, n);
        if (i422 && (p == P_VERT || p == P_VERT_4 || p == P_VERT_A || p == P_VERT_B))
          corrupt("a vertical partition of a 4:2:2 frame");
      } else if (has_cols) {  // the bottom half outside: the vertical-alike mass splits
        int psum = prob(P_VERT) + prob(P_SPLIT);
        if (bsize != B8x8) psum += prob(P_HORZ_A) + prob(P_VERT_A) + prob(P_VERT_B);
        if (bsize != B8x8 && bsize != B128x128) psum += prob(P_VERT_4);
        uint16_t tmp[3] = {uint16_t((1 << 15) - psum), 1 << 15, 0};
        p = sym.decode(tmp, 2, false) ? P_SPLIT : P_HORZ;
      } else if (has_rows) {  // the right half outside: the horizontal-alike mass
        int psum = prob(P_HORZ) + prob(P_SPLIT);
        if (bsize != B8x8) psum += prob(P_HORZ_A) + prob(P_HORZ_B) + prob(P_VERT_A);
        if (bsize != B8x8 && bsize != B128x128) psum += prob(P_HORZ_4);
        uint16_t tmp[3] = {uint16_t((1 << 15) - psum), 1 << 15, 0};
        p = sym.decode(tmp, 2, false) ? P_SPLIT : P_VERT;
        if (i422 && p == P_VERT) corrupt("a vertical partition of a 4:2:2 frame");
      } else {
        p = P_SPLIT;
      }
    }
    int sub = subsize(p, bsize), split = subsize(P_SPLIT, bsize);
    switch (p) {
      case P_NONE: block(r, c, sub); break;
      case P_HORZ:
        block(r, c, sub);
        if (has_rows) block(r + half, c, sub);
        break;
      case P_VERT:
        block(r, c, sub);
        if (has_cols) block(r, c + half, sub);
        break;
      case P_SPLIT:
        partition(r, c, sub);
        partition(r, c + half, sub);
        partition(r + half, c, sub);
        partition(r + half, c + half, sub);
        break;
      case P_HORZ_A:
        block(r, c, split);
        block(r, c + half, split);
        block(r + half, c, sub);
        break;
      case P_HORZ_B:
        block(r, c, sub);
        block(r + half, c, split);
        block(r + half, c + half, split);
        break;
      case P_VERT_A:
        block(r, c, split);
        block(r + half, c, split);
        block(r, c + half, sub);
        break;
      case P_VERT_B:
        block(r, c, sub);
        block(r, c + half, split);
        block(r + half, c + half, split);
        break;
      case P_HORZ_4:
        for (int k = 0; k < 4; k++)
          if (k < 3 || r + quarter * 3 < f.mi_rows) block(r + quarter * k, c, sub);
        break;
      default:
        for (int k = 0; k < 4; k++)
          if (k < 3 || c + quarter * 3 < f.mi_cols) block(r, c + quarter * k, sub);
        break;
    }
  }

  void block(int r, int c, int bsize) {
    if (bsize == BLOCK_INVALID) corrupt("an invalid block size");
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    int bw4 = kW4[bsize], bh4 = kH4[bsize];
    if (pic.planes > 1 && subsampled(bsize, s.ssx, s.ssy) == BLOCK_INVALID)
      corrupt("a block size the chroma subsampling does not allow");
    if (bh4 == 1 && s.ssy && (r & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && s.ssx && (c & 1) == 0) has_chroma = 0;
    else has_chroma = pic.planes > 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (s.ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (s.ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = false;
    }
    mode_info();
    if (skip) reset_block_context(bw4, bh4);
    for (int y = 0; y < bh4; y++) {
      if (r + y >= f.mi_rows) break;
      for (int x = 0; x < bw4; x++) {
        if (c + x >= f.mi_cols) break;
        size_t k = idx(r + y, c + x);
        mi.y_mode[k] = uint8_t(y_mode);
        if (has_chroma) mi.uv_mode[k] = uint8_t(uv_mode);
        mi.skip[k] = uint8_t(skip);
        mi.mi_size[k] = uint8_t(bsize);
        mi.seg[k] = uint8_t(segment);
      }
    }
    residual();
  }

  void read_segment_id() {
    int prev_ul = avail_u && avail_l ? mi.seg[idx(mi_row - 1, mi_col - 1)] : -1;
    int prev_u = avail_u ? mi.seg[idx(mi_row - 1, mi_col)] : -1;
    int prev_l = avail_l ? mi.seg[idx(mi_row, mi_col - 1)] : -1;
    int pred = prev_u == -1 ? (prev_l == -1 ? 0 : prev_l)
               : prev_l == -1 ? prev_u
               : (prev_ul == prev_u ? prev_u : prev_l);
    if (skip) {
      segment = pred;
      return;
    }
    int ctx = prev_ul < 0 ? 0
              : (prev_ul == prev_u && prev_ul == prev_l) ? 2
              : (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ? 1 : 0;
    int diff = sym.read(cdf.segment_id[ctx], 8);
    // neg_deinterleave
    int max = f.last_active_seg + 1, v;
    int near_ = (diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1);
    if (!pred) v = diff;
    else if (pred >= max - 1) v = max - diff - 1;
    else if (2 * pred < max) v = diff <= 2 * pred ? near_ : diff;
    else v = diff <= 2 * (max - pred - 1) ? near_ : max - (diff + 1);
    segment = std::clamp(v, 0, f.last_active_seg);
  }

  void mode_info() {
    skip = 0;
    segment = 0;
    if (f.seg_enabled && f.seg_pre_skip) read_segment_id();
    if (f.seg_pre_skip && f.seg_enabled && f.feature_enabled[segment][6]) {
      skip = 1;
    } else {
      int ctx = (avail_u ? mi.skip[idx(mi_row - 1, mi_col)] : 0) +
                (avail_l ? mi.skip[idx(mi_row, mi_col - 1)] : 0);
      skip = sym.read(cdf.skip[ctx], 2);
    }
    if (f.seg_enabled && !f.seg_pre_skip) read_segment_id();
    // no CDEF index, delta q or delta lf in a lossless frame; no intra block copy
    int above = avail_u ? int(mi.y_mode[idx(mi_row - 1, mi_col)]) : int(DC_PRED);
    int left = avail_l ? int(mi.y_mode[idx(mi_row, mi_col - 1)]) : int(DC_PRED);
    y_mode = sym.read(cdf.y_mode[kIntraModeContext[above]][kIntraModeContext[left]], 13);
    angle_y = 0;
    if (mi_size >= B8x8 && directional(y_mode))
      angle_y = sym.read(cdf.angle_delta[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    angle_uv = 0;
    cfl_u = cfl_v = 0;
    if (has_chroma) {
      bool cfl_allowed = subsampled(mi_size, s.ssx, s.ssy) == B4x4;  // lossless
      uv_mode = cfl_allowed ? sym.read(cdf.uv_cfl[y_mode], 14) : sym.read(cdf.uv_nocfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) {
        int signs = sym.read(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
          cfl_u = 1 + sym.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
          if (sign_u == 1) cfl_u = -cfl_u;
        }
        if (sign_v) {
          cfl_v = 1 + sym.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
          if (sign_v == 1) cfl_v = -cfl_v;
        }
      }
      if (mi_size >= B8x8 && directional(uv_mode))
        angle_uv = sym.read(cdf.angle_delta[uv_mode - V_PRED], 7) - 3;
    }
    use_filter_intra = 0;
    if (s.filter_intra && y_mode == DC_PRED && std::max(kW4[mi_size], kH4[mi_size]) <= 8) {
      use_filter_intra = sym.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_mode = sym.read(cdf.filter_intra_mode, 5);
    }
  }

  void reset_block_context(int bw4, int bh4) {
    for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
      int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4 - 1) >> sx) + 1; i++)
        above_level[plane][i] = above_dc[plane][i] = 0;
      for (int i = mi_row >> sy; i < ((mi_row + bh4 - 1) >> sy) + 1; i++)
        left_level[plane][i] = left_dc[plane][i] = 0;
    }
  }

  void residual() {
    int bw4 = kW4[mi_size], bh4 = kH4[mi_size];
    int wchunks = std::max(1, bw4 >> 4), hchunks = std::max(1, bh4 >> 4);
    for (int cy = 0; cy < hchunks; cy++)
      for (int cx = 0; cx < wchunks; cx++)
        for (int plane = 0; plane < 1 + 2 * has_chroma; plane++) {
          int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
          int psize = subsampled(mi_size, sx, sy);
          int n4w = kW4[psize], n4h = kH4[psize];
          int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> sy); y++)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x++)
              transform_block(plane, base_x, base_y, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
        }
  }

  void transform_block(int plane, int base_x, int base_y, int x, int y) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sb_mask = s.sb128 ? 31 : 15;
    int sub_row = row & sb_mask, sub_col = col & sb_mask;
    int max_x = f.mi_cols * 4 - 1, max_y = f.mi_rows * 4 - 1;
    if (start_x >= (max_x >> sx) + 1 || start_y >= (max_y >> sy) + 1) return;
    bool is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
    int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
    bool have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
    bool have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
    bool have_above_right = decoded[plane][(sub_row >> sy) - 1 + 1][(sub_col >> sx) + 1 + 1];
    bool have_below_left = decoded[plane][(sub_row >> sy) + 1 + 1][(sub_col >> sx) - 1 + 1];
    predict_intra(plane, start_x, start_y, have_left, have_above, have_above_right,
                  have_below_left, mode);
    if (is_cfl) predict_cfl(plane, start_x, start_y);
    if (plane == 0) {
      max_luma_w = start_x + 4;
      max_luma_h = start_y + 4;
    }
    if (!skip) {
      int eob = coeffs(plane, start_x, start_y);
      if (eob > 0) reconstruct(plane, start_x, start_y);
    }
    decoded[plane][(sub_row >> sy) + 1][(sub_col >> sx) + 1] = 1;
  }

  // --- intra prediction ----------------------------------------------------

  bool smooth_at(int r, int c, int plane) const {
    int m = plane == 0 ? mi.y_mode[idx(r, c)] : mi.uv_mode[idx(r, c)];
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }

  int filter_type(int plane) const {
    bool above = false, left = false;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (s.ssx && !(mi_col & 1)) c++;
        if (s.ssy && (mi_row & 1)) r--;
      }
      above = smooth_at(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (s.ssx && (mi_col & 1)) c--;
        if (s.ssy && !(mi_row & 1)) r++;
      }
      left = smooth_at(r, c, plane);
    }
    return above || left;
  }

  static int edge_strength(int w, int h, int type, int delta) {
    int d = std::abs(delta), wh = w + h, st = 0;
    if (type == 0) {
      if (wh <= 8) { if (d >= 56) st = 1; }
      else if (wh <= 12) { if (d >= 40) st = 1; }
      else if (wh <= 16) { if (d >= 40) st = 1; }
      else if (wh <= 24) { if (d >= 8) st = 1; if (d >= 16) st = 2; if (d >= 32) st = 3; }
      else if (wh <= 32) { if (d >= 1) st = 1; if (d >= 4) st = 2; if (d >= 32) st = 3; }
      else { if (d >= 1) st = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) st = 1; if (d >= 64) st = 2; }
      else if (wh <= 16) { if (d >= 20) st = 1; if (d >= 48) st = 2; }
      else if (wh <= 24) { if (d >= 4) st = 3; }
      else { if (d >= 1) st = 3; }
    }
    return st;
  }

  static bool use_upsample(int w, int h, int type, int delta) {
    int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return false;
    return type ? wh <= 8 : wh <= 16;
  }

  // edge[-1 .. sz - 2] filtered in place (edge points at element 0)
  static void edge_filter(int* edge, int sz, int strength) {
    if (!strength) return;
    int tmp[64];
    for (int i = 0; i < sz; i++) tmp[i] = edge[i - 1];
    for (int i = 1; i < sz; i++) {
      int sum = 0;
      for (int j = 0; j < 5; j++) {
        int k = std::clamp(i - 2 + j, 0, sz - 1);
        sum += kEdgeKernel[strength - 1][j] * tmp[k];
      }
      edge[i - 1] = (sum + 8) >> 4;
    }
  }

  static void edge_upsample(int* buf, int num) {
    int dup[64];
    dup[0] = buf[-1];
    for (int i = -1; i < num; i++) dup[i + 2] = buf[i];
    dup[num + 2] = buf[num - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num; i++) {
      int v = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      buf[2 * i - 1] = clip1(round2(v, 4));
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, bool have_left, bool have_above,
                     bool have_above_right, bool have_below_left, int mode) {
    const int w = 4, h = 4;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    int max_x = ((f.mi_cols * 4) >> sx) - 1, max_y = ((f.mi_rows * 4) >> sy) - 1;
    int above_buf[48], left_buf[48];
    int* above = above_buf + 16;  // indices -16 .. 31
    int* left = left_buf + 16;
    auto P = [&](int yy, int xx) { return int(*pic.at(plane, yy, xx)); };
    if (!have_above && have_left) {
      for (int i = 0; i < w + h; i++) above[i] = P(y, x - 1);
    } else if (!have_above && !have_left) {
      for (int i = 0; i < w + h; i++) above[i] = 127;
    } else {
      int limit = std::min(max_x, x + (have_above_right ? 2 * w : w) - 1);
      for (int i = 0; i < w + h; i++) above[i] = P(y - 1, std::min(limit, x + i));
    }
    if (!have_left && have_above) {
      for (int i = 0; i < w + h; i++) left[i] = P(y - 1, x);
    } else if (!have_left && !have_above) {
      for (int i = 0; i < w + h; i++) left[i] = 129;
    } else {
      int limit = std::min(max_y, y + (have_below_left ? 2 * h : h) - 1);
      for (int i = 0; i < w + h; i++) left[i] = P(std::min(limit, y + i), x - 1);
    }
    if (have_above && have_left) above[-1] = P(y - 1, x - 1);
    else if (have_above) above[-1] = P(y - 1, x);
    else if (have_left) above[-1] = P(y, x - 1);
    else above[-1] = 128;
    left[-1] = above[-1];
    int pred[4][4];
    if (plane == 0 && use_filter_intra) {
      for (int i2 = 0; i2 < h / 2; i2++)
        for (int j4 = 0; j4 < w / 4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
              else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
              else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++)
              pr += av1tab::Filter_Intra_Taps[(filter_mode * 8 + i) * 8 + j] * p[j];
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip1(round2signed(pr, 4));
          }
        }
    } else if (directional(mode)) {
      int angle = av1tab::Mode_To_Angle[mode] + 3 * (plane == 0 ? angle_y : angle_uv);
      int up_above = 0, up_left = 0;
      if (s.edge_filter) {
        if (angle != 90 && angle != 180) {
          if (angle > 90 && angle < 180 && (w + h) >= 24) {
            int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
            left[-1] = above[-1] = v;
          }
          int type = filter_type(plane);
          if (have_above) {
            int st = edge_strength(w, h, type, angle - 90);
            int num = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
            edge_filter(above, num, st);
          }
          if (have_left) {
            int st = edge_strength(w, h, type, angle - 180);
            int num = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
            edge_filter(left, num, st);
          }
        }
        int type = filter_type(plane);
        up_above = use_upsample(w, h, type, angle - 90);
        if (up_above) edge_upsample(above, w + (angle < 90 ? h : 0));
        up_left = use_upsample(w, h, type, angle - 180);
        if (up_left) edge_upsample(left, h + (angle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (angle < 90) dx = av1tab::Dr_Intra_Derivative[angle];
      else if (angle > 90 && angle < 180) dx = av1tab::Dr_Intra_Derivative[180 - angle];
      if (angle > 90 && angle < 180) dy = av1tab::Dr_Intra_Derivative[angle - 90];
      else if (angle > 180) dy = av1tab::Dr_Intra_Derivative[270 - angle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (angle == 90) {
            v = above[j];
          } else if (angle == 180) {
            v = left[i];
          } else if (angle < 90) {
            int id = (i + 1) * dx;
            int base = (id >> (6 - up_above)) + (j << up_above);
            int shift = ((id << up_above) >> 1) & 0x1F;
            int max_base = (w + h - 1) << up_above;
            v = base < max_base ? round2(above[base] * (32 - shift) + above[base + 1] * shift, 5)
                                : above[max_base];
          } else if (angle < 180) {
            int id = (j << 6) - (i + 1) * dx;
            int base = id >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              int shift = ((id * (1 << up_above)) >> 1) & 0x1F;
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            } else {
              id = (i << 6) - (j + 1) * dy;
              base = id >> (6 - up_left);
              int shift = ((id * (1 << up_left)) >> 1) & 0x1F;
              v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
            }
          } else {
            int id = (j + 1) * dy;
            int base = (id >> (6 - up_left)) + (i << up_left);
            int shift = ((id << up_left) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t* wt = av1tab::Sm_Weights;  // the 4-point weights
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          if (mode == SMOOTH_PRED) {
            int v = wt[i] * above[j] + (256 - wt[i]) * left[h - 1] + wt[j] * left[i] +
                    (256 - wt[j]) * above[w - 1];
            pred[i][j] = round2(v, 9);
          } else if (mode == SMOOTH_V_PRED) {
            pred[i][j] = round2(wt[i] * above[j] + (256 - wt[i]) * left[h - 1], 8);
          } else {
            pred[i][j] = round2(wt[j] * left[i] + (256 - wt[j]) * above[w - 1], 8);
          }
        }
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + (h >> 1)) >> 2;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        avg = (sum + (w >> 1)) >> 2;
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = above[j] + left[i] - above[-1];
          int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
              ptl = std::abs(base - above[-1]);
          pred[i][j] = (pl <= pt && pl <= ptl) ? left[i] : (pt <= ptl ? above[j] : above[-1]);
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *pic.at(plane, y + i, x + j) = uint8_t(pred[i][j]);
  }

  void predict_cfl(int plane, int sx0, int sy0) {
    int sx = s.ssx, sy = s.ssy;
    int alpha = plane == 1 ? cfl_u : cfl_v;
    int L[4][4], sum = 0;
    for (int i = 0; i < 4; i++) {
      int ly = std::min((sy0 + i) << sy, max_luma_h - (1 << sy));
      for (int j = 0; j < 4; j++) {
        int lx = std::min((sx0 + j) << sx, max_luma_w - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += *pic.at(0, ly + dy, lx + dx);
        L[i][j] = t << (3 - sx - sy);
        sum += L[i][j];
      }
    }
    int avg = round2(sum, 4);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        uint8_t* d = pic.at(plane, sy0 + i, sx0 + j);
        *d = clip1(*d + round2signed(alpha * (L[i][j] - avg), 6));
      }
  }

  // --- coefficients ----------------------------------------------------------

  int coeffs(int plane, int start_x, int start_y) {
    int x4 = start_x >> 2, y4 = start_y >> 2;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    int max_x4 = f.mi_cols >> sx, max_y4 = f.mi_rows >> sy;
    int ptype = plane > 0;
    memset(quant, 0, sizeof quant);
    int ctx;
    if (plane == 0) {
      int top = x4 < max_x4 ? above_level[0][x4] : 0;
      int lft = y4 < max_y4 ? left_level[0][y4] : 0;
      if (mi_size == B4x4) ctx = 0;
      else if (top == 0 && lft == 0) ctx = 1;
      else if (top == 0 || lft == 0) ctx = 2 + (std::max(top, lft) > 3);
      else if (std::max(top, lft) <= 3) ctx = 4;
      else if (std::min(top, lft) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int a = x4 < max_x4 ? (above_level[plane][x4] | above_dc[plane][x4]) : 0;
      int l = y4 < max_y4 ? (left_level[plane][y4] | left_dc[plane][y4]) : 0;
      ctx = (a != 0) + (l != 0) + 7;
      if (kW4[subsampled(mi_size, sx, sy)] * kH4[subsampled(mi_size, sx, sy)] > 1) ctx += 3;
    }
    int eob = 0;
    uint32_t cul = 0;
    int dc_cat = 0;
    if (sym.read(cdf.txb_skip[ctx], 2)) {
      // all zero
    } else {
      int eob_pt = sym.read(cdf.eob16[ptype], 5) + 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (sym.read(cdf.eob_extra[ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          shift = std::max(0, eob_pt - 2) - 1 - i;
          if (sym.literal(1)) eob += 1 << shift;
        }
      }
      const int16_t* scan = av1tab::Default_Scan_4x4;
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c], level;
        if (c == eob - 1) {
          int bctx = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
          level = sym.read(cdf.base_eob[ptype][bctx], 3) + 1;
        } else {
          level = sym.read(cdf.base[ptype][base_ctx(pos)], 4);
        }
        if (level > 2) {
          int bctx = br_ctx(pos);
          for (int k = 0; k < 4; k++) {
            int br = sym.read(cdf.br[ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        uint32_t tok = uint32_t(quant[pos]);
        if (!tok) continue;
        int sign;
        if (c == 0) {
          int dctx = dc_sign_ctx(plane, x4, y4, max_x4, max_y4);
          sign = sym.read(cdf.dc_sign[ptype][dctx], 2);
        } else {
          sign = sym.boolean();
        }
        uint32_t dq;
        if (tok >= 15) {
          tok = golomb() + 15;
          dq = (4u * tok) & 0xFFFFFF;
        } else {
          dq = 4u * tok;
        }
        dq = std::min<uint32_t>(dq, 32767u + uint32_t(sign));
        if (pos == 0) dc_cat = sign ? 1 : 2;
        cul += tok;
        quant[pos] = sign ? -int32_t(dq) : int32_t(dq);
      }
    }
    uint8_t level_ctx = uint8_t(std::min<uint32_t>(cul, 63));
    above_level[plane][x4] = level_ctx;
    above_dc[plane][x4] = uint8_t(dc_cat);
    left_level[plane][y4] = level_ctx;
    left_dc[plane][y4] = uint8_t(dc_cat);
    return eob;
  }

  uint32_t golomb() {
    int len = 0;
    while (!sym.boolean() && len < 32) len++;
    uint32_t v = 1;
    while (len--) v = (v << 1) + uint32_t(sym.boolean());
    return v - 1;
  }

  int base_ctx(int pos) const {
    int row = pos >> 2, col = pos & 3, mag = 0;
    for (const auto& o : kSigRefOffset) {
      int rr = row + o[0], cc = col + o[1];
      if (rr < 4 && cc < 4) mag += std::min(std::abs(quant[(rr << 2) + cc]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (pos == 0) return 0;
    return ctx + kCoeffBaseCtxOffset4[std::min(row, 4)][std::min(col, 4)];
  }

  int br_ctx(int pos) const {
    int row = pos >> 2, col = pos & 3, mag = 0;
    for (const auto& o : kMagRefOffset) {
      int rr = row + o[0], cc = col + o[1];
      if (rr < 4 && cc < 4) mag += std::min(quant[(rr << 2) + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
    return mag + 14;
  }

  int dc_sign_ctx(int plane, int x4, int y4, int max_x4, int max_y4) const {
    int v = 0;
    if (x4 < max_x4) v += above_dc[plane][x4] == 1 ? -1 : above_dc[plane][x4] == 2 ? 1 : 0;
    if (y4 < max_y4) v += left_dc[plane][y4] == 1 ? -1 : left_dc[plane][y4] == 2 ? 1 : 0;
    return v < 0 ? 1 : v > 0 ? 2 : 0;
  }

  // the inverse Walsh-Hadamard transform of a 4x4 block, added to the prediction
  void reconstruct(int plane, int x, int y) {
    int32_t t[4][4];
    auto wht = [](int32_t* a, int32_t* b, int32_t* c, int32_t* d, int shift) {
      int32_t A = *a >> shift, C = *b >> shift, D = *c >> shift, B = *d >> shift;
      A += C;
      D -= B;
      int32_t E = (A - D) >> 1;
      B = E - B;
      C = E - C;
      A -= B;
      D += C;
      *a = A;
      *b = B;
      *c = C;
      *d = D;
    };
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) t[i][j] = quant[i * 4 + j];
    for (int i = 0; i < 4; i++) wht(&t[i][0], &t[i][1], &t[i][2], &t[i][3], 2);
    for (int j = 0; j < 4; j++) wht(&t[0][j], &t[1][j], &t[2][j], &t[3][j], 0);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        uint8_t* d = pic.at(plane, y + i, x + j);
        *d = clip1(*d + t[i][j]);
      }
  }
};

// ---------------------------------------------------------------------------
// The stream: OBUs to a frame
// ---------------------------------------------------------------------------

struct Decoder {
  Sequence seq;
  Frame frame;
  bool have_frame = false;
  std::vector<std::pair<const uint8_t*, size_t>> tiles;  // by tile number

  // walk the OBUs: the first frame's headers and tiles; after its last tile
  // group the rest is parsed as dav1d parses the rest of the data it is
  // given (whole OBUs, sequence headers that parse), and not decoded
  void parse(const uint8_t* d, size_t n) {
    size_t at = 0;
    int next_tile = 0, num_tiles = 0;
    bool complete = false;
    while (at < n) {
      uint8_t h = d[at++];
      if (h & 0x80) corrupt("an OBU's forbidden bit is set");
      int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        if (at >= n) corrupt("an OBU header runs past the item");
        temporal_id = d[at] >> 5;
        spatial_id = (d[at] >> 3) & 3;
        at++;
      }
      size_t size = has_size ? leb128(d, n, at) : n - at;
      if (size > n - at) corrupt("an OBU runs past the item");
      const uint8_t* body = d + at;
      at += size;
      if (complete) {
        if (type == 1) {
          Bits b(body, size);
          Sequence later;
          parse_sequence(b, later);
        }
        continue;
      }
      if (type == 1) {  // OBU_SEQUENCE_HEADER
        Bits b(body, size);
        parse_sequence(b, seq);
        if (seq.op_count > 1) refuse("several operating points");
        if (seq.bitdepth != 8) refuse(std::to_string(seq.bitdepth) + "-bit streams");
      } else if (type == 3 || type == 6) {  // OBU_FRAME_HEADER, OBU_FRAME
        if (!seq.seen) corrupt("a frame before its sequence header");
        int idc = seq.op_idc;
        if (idc && (!((idc >> temporal_id) & 1) || !((idc >> (spatial_id + 8)) & 1))) continue;
        Bits b(body, size);
        parse_frame_header(b, seq, frame, temporal_id, spatial_id);
        have_frame = true;
        num_tiles = frame.tile_cols * frame.tile_rows;
        tiles.assign(size_t(num_tiles), {nullptr, 0});
        next_tile = 0;
        if (type == 6) {
          b.byte_align();
          size_t hb = b.pos / 8;
          next_tile = tile_group(body + hb, size - hb, num_tiles);
          complete = next_tile >= num_tiles;
        }
      } else if (type == 4) {  // OBU_TILE_GROUP
        if (!have_frame) corrupt("a tile group before its frame header");
        next_tile = tile_group(body, size, num_tiles);
        complete = next_tile >= num_tiles;
      } else if (type == 8) {
        refuse("tile lists");
      }
      // temporal delimiters, redundant frame headers, metadata and padding: skipped
    }
    if (!have_frame) corrupt("no frame in the item");
    if (!complete) corrupt("a frame's tiles end before its last tile");
  }

  // the tiles of one tile group; returns the tile after its last
  int tile_group(const uint8_t* d, size_t n, int num_tiles) {
    Bits b(d, n);
    int start = 0, end = num_tiles - 1;
    if (num_tiles > 1 && b.f(1)) {
      int bits = frame.tile_cols_log2 + frame.tile_rows_log2;
      start = int(b.f(bits));
      end = int(b.f(bits));
    }
    b.byte_align();
    size_t at = b.pos / 8;
    if (end < start || end >= num_tiles) corrupt("a tile group's tiles out of order");
    for (int t = start; t <= end; t++) {
      size_t size;
      if (t == end) {
        size = n - at;
      } else {
        if (at + size_t(frame.tile_size_bytes) > n) corrupt("a tile size runs past its OBU");
        size = 0;
        for (int k = 0; k < frame.tile_size_bytes; k++) size |= size_t(d[at + k]) << (8 * k);
        size += 1;
        at += size_t(frame.tile_size_bytes);
        if (size > n - at) corrupt("a tile runs past its OBU");
      }
      tiles[size_t(t)] = {d + at, size};
      at += size;
    }
    return end + 1;
  }
};

void decode_frame(Decoder& dec, Picture& pic) {
  const Sequence& s = dec.seq;
  const Frame& f = dec.frame;
  qie::check_pixels("AVIF", f.width, f.height);
  pic.planes = s.mono ? 1 : 3;
  pic.ssx = s.ssx;
  pic.ssy = s.ssy;
  for (int p = 0; p < pic.planes; p++) {
    int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
    pic.w[p] = (f.mi_cols * 4) >> sx;
    pic.h[p] = (f.mi_rows * 4) >> sy;
    pic.px[p].assign(size_t(pic.w[p]) * pic.h[p], 0);
  }
  ModeInfo mi;
  mi.init(f.mi_cols, f.mi_rows);
  size_t n = dec.tiles.size();
  size_t threads = std::min<size_t>({std::max(1u, std::thread::hardware_concurrency()), 8, n});
  std::atomic<size_t> next{0};
  std::atomic<bool> failed{false};
  std::string error;
  bool refused = false;
  std::mutex lock;
  auto work = [&]() {
    try {
      for (size_t t; !failed && (t = next++) < n;) {
        int row = int(t) / f.tile_cols, col = int(t) % f.tile_cols;
        auto tile = std::make_unique<Tile>(s, f, pic, mi, row, col);
        tile->decode(dec.tiles[t].first, dec.tiles[t].second);
      }
    } catch (const std::exception& e) {
      std::lock_guard<std::mutex> g(lock);
      if (!failed.exchange(true)) {
        error = e.what();
        refused = dynamic_cast<const Refused*>(&e) != nullptr;
      }
    }
  };
  std::vector<std::thread> pool;
  if (threads > 1) {
    pool.reserve(threads - 1);
    try {
      for (size_t t = 1; t < threads; t++) pool.emplace_back(work);
    } catch (const std::exception&) {
    }
  }
  work();
  for (auto& th : pool) th.join();
  if (failed) {
    if (refused) throw Refused(error);
    throw CodecError(error);
  }
}


// ---------------------------------------------------------------------------
// YUV to RGB as Pillow's libavif 1.3 converts it: libyuv 1909's fixed point
// (YuvPixel: 6 fraction bits, Y scaled by yg / 2^16 after * 0x0101) with the
// YuvConstants libavif picks by matrix and range, chroma upsampled as
// libyuv's *MatrixFilter functions do (kFilterBilinear: 3:1 taps, the first
// and last samples repeated); the identity matrix through libavif's own
// path (full range copies the planes, limited range scales in float)
// ---------------------------------------------------------------------------

struct YuvConstants {
  int yg, yb, ub, ug, vg, vr;
};
const YuvConstants kJPEG = {16320, 32, 113, 22, 46, 90};     // BT.601 full
const YuvConstants kI601 = {18997, -1160, 128, 25, 52, 102};  // BT.601 limited
const YuvConstants kF709 = {16320, 32, 119, 12, 30, 101};    // BT.709 full
const YuvConstants kH709 = {18997, -1160, 128, 14, 34, 115};  // BT.709 limited
const YuvConstants kV2020 = {16320, 32, 120, 11, 37, 94};    // BT.2020 full
const YuvConstants k2020 = {19003, -1160, 128, 12, 42, 107};  // BT.2020 limited

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline void yuv_pixel(int y, int u, int v, const YuvConstants& k, uint8_t* rgb) {
  int32_t y1 = int32_t(uint32_t(uint32_t(y) * 0x0101u * uint32_t(k.yg)) >> 16) + k.yb;
  int ui = u - 128, vi = v - 128;
  rgb[0] = clamp255((y1 + vi * k.vr) >> 6);
  rgb[1] = clamp255((y1 - (ui * k.ug + vi * k.vg)) >> 6);
  rgb[2] = clamp255((y1 + ui * k.ub) >> 6);
}

// one chroma row to full width: libyuv's ScaleRowUp2_Linear (the first
// sample repeated; an even width ends on the last sample)
void up_row(const int* src, int cw, int w, int* dst) {
  dst[0] = src[0];
  for (int x = 0; x + 1 < cw; x++) {
    if (2 * x + 1 < w) dst[2 * x + 1] = (3 * src[x] + src[x + 1] + 2) >> 2;
    if (2 * x + 2 < w) dst[2 * x + 2] = (src[x] + 3 * src[x + 1] + 2) >> 2;
  }
  if (w > 1) dst[w - 1] = src[cw - 1];
}

// two chroma rows, near (3/4) and far (1/4), to full width: the bilinear
// 9:3:3:1 taps, and 3:1 at the row's ends
void up_rows(const int* near_, const int* far_, int cw, int w, int* dst) {
  dst[0] = (3 * near_[0] + far_[0] + 2) >> 2;
  for (int x = 0; x + 1 < cw; x++) {
    if (2 * x + 1 < w)
      dst[2 * x + 1] = (9 * near_[x] + 3 * near_[x + 1] + 3 * far_[x] + far_[x + 1] + 8) >> 4;
    if (2 * x + 2 < w)
      dst[2 * x + 2] = (3 * near_[x] + 9 * near_[x + 1] + far_[x] + 3 * far_[x + 1] + 8) >> 4;
  }
  if (w > 1) dst[w - 1] = (3 * near_[cw - 1] + far_[cw - 1] + 2) >> 2;
}

// a chroma plane's full-resolution row r
void chroma_row(const uint8_t* plane, int cw, int ch, int ssx, int ssy, int w, int h, int r,
                std::vector<int>& a, std::vector<int>& b, int* dst) {
  auto load = [&](int row, std::vector<int>& out) {
    for (int x = 0; x < cw; x++) out[size_t(x)] = plane[size_t(row) * cw + x];
  };
  if (!ssx) {
    load(ssy ? r >> 1 : r, a);
    for (int x = 0; x < w; x++) dst[x] = a[size_t(x)];
    return;
  }
  if (!ssy) {
    load(r, a);
    up_row(a.data(), cw, w, dst);
    return;
  }
  // 4:2:0: row 0 and an even height's last row from one chroma row; the rest
  // between chroma rows (r - 1) / 2 and (r + 1) / 2, 3:1 toward the nearer
  if (r == 0 || (r == h - 1 && (h & 1) == 0)) {
    load(r == 0 ? 0 : ch - 1, a);
    up_row(a.data(), cw, w, dst);
    return;
  }
  int top = (r - 1) >> 1, bottom = std::min(top + 1, ch - 1);
  load(top, a);
  load(bottom, b);
  if (r & 1) up_rows(a.data(), b.data(), cw, w, dst);
  else up_rows(b.data(), a.data(), cw, w, dst);
}


int fail(const std::exception& e, char* err, int errlen) {
  qie::set_err(err, errlen, e.what());
  return dynamic_cast<const Refused*>(&e) ? -2 : -1;
}

}  // namespace

extern "C" {

// The headers of an AV1 still image (an av01 item's OBUs): info[0..11] =
// width, height, subsampling x and y, monochrome, bit depth, full range,
// colour description present, primaries, transfer, matrix, profile.
// 0, or -1 (corrupt) / -2 (refused: err names the feature).
int qie_av1_info(const uint8_t* data, long n, int* info, char* err, int errlen) {
  try {
    Decoder dec;
    dec.parse(data, size_t(n));
    const Sequence& s = dec.seq;
    int v[12] = {dec.frame.upscaled, dec.frame.height, s.ssx, s.ssy, s.mono, s.bitdepth,
                 s.range, s.color_description, s.primaries, s.transfer, s.matrix, s.profile};
    memcpy(info, v, sizeof v);
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// The frame's planes, cropped to its size: y (w x h), u and v (each
// ((w + ssx) >> ssx) x ((h + ssy) >> ssy); not written for a monochrome
// stream). 0, -1 or -2 as qie_av1_info.
int qie_av1_decode(const uint8_t* data, long n, uint8_t* y, uint8_t* u, uint8_t* v, char* err,
                   int errlen) {
  try {
    Decoder dec;
    dec.parse(data, size_t(n));
    Picture pic;
    decode_frame(dec, pic);
    int w = dec.frame.upscaled, h = dec.frame.height;
    uint8_t* out[3] = {y, u, v};
    for (int p = 0; p < pic.planes; p++) {
      int sx = p ? pic.ssx : 0, sy = p ? pic.ssy : 0;
      int pw = (w + sx) >> sx, ph = (h + sy) >> sy;
      for (int r = 0; r < ph; r++) memcpy(out[p] + size_t(r) * pw, pic.at(p, r, 0), size_t(pw));
    }
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// (h, w, 3) RGB from the planes; matrix and full range as libavif settles
// them. 0; -1 where libavif's reformat fails; -2 with the matrix named where
// libavif's own float path (not libyuv's) would convert it (BT.470M,
// SMPTE 240M, YCgCo, chroma-derived, YCgCo-Re).
int qie_avif_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h, int ssx,
                 int ssy, int mono, int matrix, int full, uint8_t* rgb, char* err, int errlen) {
  int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy;
  // the matrices libavif's reformat takes (YCgCo only at full range)
  bool known = matrix == 0 || matrix == 1 || matrix == 2 || (matrix >= 4 && matrix <= 7) ||
               matrix == 9 || matrix == 12 || matrix == 15 || (matrix == 8 && full);
  if (!known) {
    qie::set_err(err, errlen, ("corrupt AVIF: matrix coefficients " + std::to_string(matrix) +
                               " (libavif's reformat fails)").c_str());
    return -1;
  }
  if (mono) {  // gray: full range as it is, limited range scaled in float
    for (size_t i = 0; i < size_t(w) * h; i++) {
      float f = (float(y[i]) - 16.0f) / 219.0f;
      f = f < 0.0f ? 0.0f : f > 1.0f ? 1.0f : f;
      uint8_t g = full ? y[i] : uint8_t(0.5f + f * 255.0f);
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g;
    }
    return 0;
  }
  if (matrix == 0) {
    if (ssx || ssy) {  // libavif's reformat fails
      qie::set_err(err, errlen, "corrupt AVIF: the identity matrix over subsampled chroma");
      return -1;
    }
    for (size_t i = 0; i < size_t(w) * h; i++) {
      uint8_t gbr[3] = {v[i], y[i], u[i]};
      for (int c = 0; c < 3; c++) {
        if (full) {
          rgb[3 * i + c] = gbr[c];
        } else {
          float f = (float(gbr[c]) - 16.0f) / 219.0f;
          f = f < 0.0f ? 0.0f : f > 1.0f ? 1.0f : f;
          rgb[3 * i + c] = uint8_t(0.5f + f * 255.0f);
        }
      }
    }
    return 0;
  }
  const YuvConstants* k;
  switch (matrix) {
    case 1: k = full ? &kF709 : &kH709; break;
    case 2: case 5: case 6: k = full ? &kJPEG : &kI601; break;
    case 9: k = full ? &kV2020 : &k2020; break;
    default: {
      std::string what = "matrix coefficients " + std::to_string(matrix);
      qie::set_err(err, errlen, what.c_str());
      return -2;
    }
  }
  std::vector<int> ur(static_cast<size_t>(w)), vr(static_cast<size_t>(w));
  std::vector<int> a(static_cast<size_t>(cw)), b(static_cast<size_t>(cw));
  for (int r = 0; r < h; r++) {
    if (!mono) {
      chroma_row(u, cw, ch, ssx, ssy, w, h, r, a, b, ur.data());
      chroma_row(v, cw, ch, ssx, ssy, w, h, r, a, b, vr.data());
    }
    for (int x = 0; x < w; x++) {
      size_t i = size_t(r) * w + x;
      yuv_pixel(y[i], mono ? 128 : ur[size_t(x)], mono ? 128 : vr[size_t(x)], *k, rgb + 3 * i);
    }
  }
  return 0;
}

}  // extern "C"
