// JPEG 2000 (ISO/IEC 15444-1) tiles on the host, decoded to the integers
// OpenJPEG 2.5.4 hands Pillow for them. core/codec.py reads the boxes and
// the marker segments and passes one tile at a time: its rectangle, its
// coding parameters (COD/COC, QCD/QCC, RGN, POC as that tile sees them) and
// its tile-parts' bytes end to end. This decodes the tile as OpenJPEG does:
//
// - tier 2: OpenJPEG's packet iterator (the five progressions, POC entries,
//   each packet once), packet headers (tag trees, inclusion, zero bit-planes,
//   pass counts, Lblock, the segments each code-block style makes), SOP and
//   EPH where COD asks for them (a missing SOP is no error, a missing EPH is), a segment
//   longer than the tile's bytes an error (OpenJPEG's strict mode);
// - tier 1: the MQ decoder (its 0xFF 0xFF sentinel after each segment), the
//   significance, refinement and cleanup passes with their contexts, the
//   bypass (raw) passes, context reset, termination on each pass, the
//   vertically causal context and segmentation symbols; ROI max-shift;
// - dequantisation: reversible values halved; irreversible ones times half
//   the band's step size, in float;
// - the inverse DWT: 5/3 in integers, 9/7 lifting in float (below);
// - the inverse RCT or ICT on the first three components, then the DC level
//   shift, float rounded to the nearest even integer, and the clamp to the
//   component's precision.
//
// The output is each component's tile plane of int32 after the clamp (what
// opj_decode_tile_data writes before Pillow unpacks it). Code-blocks decode
// on up to eight threads, and a large tile's components each on its own;
// each writes its own samples, so the result is the one-thread result.
// Every entry point returns 0, or a negative value with a message in `err`.
//
// Floating point: the irreversible path must round where OpenJPEG rounds.
// Each float operation stands alone (OpenJPEG's SSE code multiplies and adds
// in separate instructions); the library's flags carry no -ffast-math and no
// -march, so the x86-64 build has no FMA to contract a*b+c into, and where
// the target has one (__FP_FAST_FMAF) contraction is switched off below.

#if defined(__FP_FAST_FMAF) && defined(__GNUC__) && !defined(__clang__)
#pragma GCC optimize("fp-contract=off")
#endif
#if defined(__clang__)
#pragma clang fp contract(off)
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "codec_common.h"

namespace {

using qie::CodecError;

// ------------------------------------------------------------- MQ decoder

struct MqState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

// ISO/IEC 15444-1 Table C.2
const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 magnitude, 17 run, 18 uniform
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kContexts = 19;

struct Mq {
  const uint8_t* bp = nullptr;  // a segment followed by 0xFF 0xFF
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t st[kContexts], mps[kContexts];

  void reset_contexts() {
    memset(st, 0, sizeof st);
    memset(mps, 0, sizeof mps);
    st[kCtxUni] = 46;
    st[kCtxAgg] = 3;
    st[0] = 4;
  }
  void bytein() {
    uint32_t next = bp[1];
    if (*bp == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p) {
    bp = p;
    c = uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[st[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        st[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return int((c >> ct) & 1);
  }
};

// ---------------------------------------------------------------- tier 1

// a sample's flags: its own state, then which of its eight neighbours are
// significant and the signs of the four it shares an edge with
constexpr uint32_t kSig = 1, kVisited = 2, kRefined = 4, kNeg = 8, kN = 16, kS = 32, kW = 64,
                   kE = 128, kNW = 256, kNE = 512, kSW = 1024, kSE = 2048, kNNeg = 4096,
                   kSNeg = 8192, kWNeg = 16384, kENeg = 32768, kNeighbours = 0xFF0;

struct Luts {
  uint8_t zc[4][256];       // by band (LL, HL, LH, HH), the neighbours' significance
  uint8_t sc[256], spb[256];  // by N, S, W, E significance and their signs
  Luts() {
    for (int orient = 0; orient < 4; orient++)
      for (int f = 0; f < 256; f++) {
        int h = ((f >> 2) & 1) + ((f >> 3) & 1), v = (f & 1) + ((f >> 1) & 1);
        int d = ((f >> 4) & 1) + ((f >> 5) & 1) + ((f >> 6) & 1) + ((f >> 7) & 1), n;
        if (orient == 1) std::swap(h, v);
        if (orient == 3) {
          int hv = h + v;
          n = d == 0 ? (hv == 0 ? 0 : hv == 1 ? 1 : 2)
              : d == 1 ? (hv == 0 ? 3 : hv == 1 ? 4 : 5)
              : d == 2 ? (hv == 0 ? 6 : 7) : 8;
        } else {
          n = h == 0 ? (v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4)
              : h == 1 ? (v == 0 ? (d == 0 ? 5 : 6) : 7) : 8;
        }
        zc[orient][f] = uint8_t(n);
      }
    for (int f = 0; f < 256; f++) {
      // bits 0-3: N, S, W, E significant; bits 4-7: their signs
      auto part = [&](int a, int b) {
        int pos = 0, neg = 0;
        for (int k : {a, b}) {
          if (f >> k & 1) (f >> (k + 4) & 1 ? neg : pos) = 1;
        }
        return pos - neg;
      };
      int hc = part(2, 3), vc = part(0, 1);
      spb[f] = uint8_t((hc == 0 && vc == 0) ? 0 : !(hc > 0 || (hc == 0 && vc > 0)));
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
      }
      int n = hc == 0 ? (vc == 0 ? 0 : 1) : (vc == -1 ? 2 : vc == 0 ? 3 : 4);
      sc[f] = uint8_t(kCtxSc + n);
    }
  }
};
const Luts kLuts;

struct Segment {
  const uint8_t* data;  // followed by 0xFF 0xFF
  uint32_t passes;
};

class Tier1 {
 public:
  int w = 0, h = 0, fs = 0;
  std::vector<int32_t> data;
  std::vector<uint32_t> flags;
  Mq mq;

  // OpenJPEG's opj_t1_decode_cblk: false where it gives up on the block
  bool decode(int bw, int bh, int orient, uint32_t roishift, uint32_t cblksty, uint32_t numbps,
              const std::vector<Segment>& segs, bool has_data) {
    w = bw;
    h = bh;
    fs = w + 2;
    data.assign(size_t(w) * h, 0);
    flags.assign(size_t(fs) * (h + 2), 0);
    int32_t bpno_plus_one = int32_t(roishift + numbps);
    if (bpno_plus_one >= 31) return false;
    mq.reset_contexts();
    if (!has_data) return true;
    orient_ = orient;
    vsc_ = (cblksty & 0x08) != 0;
    int passtype = 2;
    for (const Segment& seg : segs) {
      bool raw = bpno_plus_one <= int32_t(numbps) - 4 && passtype < 2 && (cblksty & 0x01);
      if (raw)
        mq.raw_init(seg.data);
      else
        mq.init(seg.data);
      for (uint32_t p = 0; p < seg.passes && bpno_plus_one >= 1; p++) {
        if (passtype == 0)
          raw ? sigpass<true>(bpno_plus_one) : sigpass<false>(bpno_plus_one);
        else if (passtype == 1)
          raw ? refpass<true>(bpno_plus_one) : refpass<false>(bpno_plus_one);
        else
          clnpass(bpno_plus_one, cblksty);
        if ((cblksty & 0x02) && !raw) mq.reset_contexts();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
    return true;
  }

 private:
  int orient_ = 0;
  bool vsc_ = false;

  uint32_t* flag(int y, int x) { return &flags[size_t(y + 1) * fs + x + 1]; }

  void set_sig(int y, int x, uint32_t neg) {
    uint32_t* f = flag(y, x);
    *f |= kSig | (neg ? kNeg : 0u);
    f[-1] |= kE | (neg ? kENeg : 0u);
    f[1] |= kW | (neg ? kWNeg : 0u);
    if (!(vsc_ && (y & 3) == 0)) {  // vertically causal: no look into the stripe above
      f[-fs] |= kS | (neg ? kSNeg : 0u);
      f[-fs - 1] |= kSE;
      f[-fs + 1] |= kSW;
    }
    f[fs] |= kN | (neg ? kNNeg : 0u);
    f[fs - 1] |= kNE;
    f[fs + 1] |= kNW;
  }

  int zc(uint32_t f) const { return kLuts.zc[orient_][(f >> 4) & 0xFF]; }

  void sign(int y, int x, int32_t oneplushalf) {
    uint32_t f = *flag(y, x);
    int idx = int(((f >> 4) & 0xF) | ((f >> 8) & 0xF0));
    uint32_t v = uint32_t(mq.decode(kLuts.sc[idx]) ^ kLuts.spb[idx]);
    data[size_t(y) * w + x] = v ? -oneplushalf : oneplushalf;
    set_sig(y, x, v);
  }

  template <bool Raw>
  void sigpass(int bpno) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < k + 4 && y < h; y++) {
          uint32_t* f = flag(y, x);
          if ((*f & (kSig | kVisited)) != 0 || (*f & kNeighbours) == 0) continue;
          if (Raw) {
            if (mq.raw()) {
              uint32_t v = uint32_t(mq.raw());
              data[size_t(y) * w + x] = v ? -oneplushalf : oneplushalf;
              set_sig(y, x, v);
            }
          } else if (mq.decode(zc(*f))) {
            sign(y, x, oneplushalf);
          }
          *f |= kVisited;
        }
  }

  template <bool Raw>
  void refpass(int bpno) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < k + 4 && y < h; y++) {
          uint32_t* f = flag(y, x);
          if ((*f & (kSig | kVisited)) != kSig) continue;
          int v;
          if (Raw) {
            v = mq.raw();
          } else {
            int cx = (*f & kRefined) ? kCtxMag + 2 : (*f & kNeighbours) ? kCtxMag + 1 : kCtxMag;
            v = mq.decode(cx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *f |= kRefined;
        }
  }

  void cln_step(int y, int x, int32_t oneplushalf) {
    uint32_t f = *flag(y, x);
    if (f & (kSig | kVisited)) return;
    if (mq.decode(zc(f))) sign(y, x, oneplushalf);
  }

  void clnpass(int bpno, uint32_t cblksty) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++) {
        if (k + 3 < h) {
          uint32_t any = *flag(k, x) | *flag(k + 1, x) | *flag(k + 2, x) | *flag(k + 3, x);
          if ((any & (kSig | kVisited | kNeighbours)) == 0) {
            if (mq.decode(kCtxAgg)) {
              int r = mq.decode(kCtxUni);
              r = (r << 1) | mq.decode(kCtxUni);
              sign(k + r, x, oneplushalf);
              for (int y = k + r + 1; y < k + 4; y++) cln_step(y, x, oneplushalf);
            }
          } else {
            for (int y = k; y < k + 4; y++) cln_step(y, x, oneplushalf);
          }
        } else {
          for (int y = k; y < h; y++) cln_step(y, x, oneplushalf);
        }
        for (int y = k; y < k + 4 && y < h; y++) *flag(y, x) &= ~kVisited;
      }
    if (cblksty & 0x20)
      for (int i = 0; i < 4; i++) mq.decode(kCtxUni);
  }
};

// ---------------------------------------------------------------- tier 2

inline int32_t ceildivpow2(int64_t a, int b) {
  return int32_t((a + (int64_t(1) << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }

// fn(i, thread) for i in [0, n) on up to eight threads, `grain` items a
// thread at least (work items are independent: code-blocks, components);
// the first error is rethrown once all stop
template <class Fn>
void parallel_for(size_t n, size_t grain, Fn fn) {
  size_t threads = std::min<size_t>({std::max(1u, std::thread::hardware_concurrency()), 8,
                                     (n + grain - 1) / std::max<size_t>(grain, 1)});
  if (threads <= 1) {
    for (size_t i = 0; i < n; i++) fn(i, 0);
    return;
  }
  std::atomic<size_t> next{0};
  std::atomic<bool> failed{false};
  std::string error;
  std::mutex lock;
  auto work = [&](size_t t) {
    try {
      for (size_t i; !failed && (i = next++) < n;) fn(i, t);
    } catch (const std::exception& e) {
      std::lock_guard<std::mutex> g(lock);
      if (!failed.exchange(true)) error = e.what();
    }
  };
  // a thread that cannot start (the process at its thread limit under many
  // uploads at once) leaves its items to the threads already running and
  // the caller: letting the error unwind past them would destroy joinable
  // threads, which aborts the whole process
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  try {
    for (size_t t = 1; t < threads; t++) pool.emplace_back(work, t);
  } catch (const std::exception&) {
  }
  work(0);
  for (auto& th : pool) th.join();
  if (failed) throw CodecError(error);
}

struct TagTree {
  struct Node {
    int parent;
    int32_t value, low;
  };
  std::vector<Node> nodes;

  void build(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    std::vector<uint32_t> lw{w}, lh{h}, start{0};
    uint32_t total = 0;
    while (true) {
      total += lw.back() * lh.back();
      if (lw.back() * lh.back() <= 1) break;
      start.push_back(total);
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    nodes.resize(total);
    for (size_t l = 0; l < lw.size(); l++)
      for (uint32_t y = 0; y < lh[l]; y++)
        for (uint32_t x = 0; x < lw[l]; x++) {
          Node& n = nodes[start[l] + y * lw[l] + x];
          n.parent = l + 1 < lw.size() ? int(start[l + 1] + (y / 2) * lw[l + 1] + x / 2) : -1;
        }
    reset();
  }
  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }
};

struct Bio {  // OpenJPEG's opj_bio, reading: zero bits past the end
  const uint8_t *start, *end, *bp;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, size_t len) : start(p), end(p + len), bp(p) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return;
    buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

// opj_tgt_decode: 1 where the leaf's value is below the threshold
uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
  int stk[32], sp = 0;
  int node = int(leaf);
  while (tree.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    TagTree::Node& n = tree.nodes[node];
    if (low > n.low)
      n.low = low;
    else
      low = n.low;
    while (low < threshold) {
      if (low >= n.value) break;
      if (bio.bit())
        n.value = low;
      else
        ++low;
    }
    n.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

struct Seg {
  uint32_t len = 0, numpasses = 0, maxpasses = 0, numnewpasses = 0, newlen = 0;
};

struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<size_t, uint32_t>> chunks;  // offset in the tile's bytes, length
};

struct Prec {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pdx, pdy, pw, ph;
  int numbands;
  Band bands[3];
};

constexpr int kMaxRes = 33, kMaxBands = 97;

struct CompParams {
  uint32_t dx, dy, prec, sgnd, numres, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits,
      roishift;
  uint32_t prcw[kMaxRes], prch[kMaxRes];
  int32_t expn[kMaxBands], mant[kMaxBands];
};

struct Comp {
  CompParams p;
  int32_t x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<uint32_t> buf;  // int32 or float bits, as OpenJPEG's tile data
};

struct Poc {
  uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct Packet {
  uint32_t compno, resno, precno, layno;
};

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 0x04)
    s.maxpasses = 1;
  else if (cblksty & 0x01)
    s.maxpasses = first ? 10
                        : ((cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10)
                               ? 2 : 1);
  else
    s.maxpasses = 109;
}

uint32_t numpasses(Bio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) {
    a >>= 1;
    l++;
  }
  return l;
}

class Tile {
 public:
  int32_t tx0, ty0, tx1, ty1;
  uint32_t numlayers, mct, csty, prg;
  std::vector<Comp> comps;
  std::vector<Poc> pocs;
  const uint8_t* src;
  size_t len;

  void geometry() {
    for (Comp& c : comps) {
      const CompParams& p = c.p;
      c.x0 = int32_t((int64_t(tx0) + p.dx - 1) / p.dx);
      c.y0 = int32_t((int64_t(ty0) + p.dy - 1) / p.dy);
      c.x1 = int32_t((int64_t(tx1) + p.dx - 1) / p.dx);
      c.y1 = int32_t((int64_t(ty1) + p.dy - 1) / p.dy);
      c.buf.assign(size_t(c.x1 - c.x0) * size_t(c.y1 - c.y0), 0);
      c.res.resize(p.numres);
      for (uint32_t r = 0; r < p.numres; r++) {
        Res& res = c.res[r];
        int level = int(p.numres - 1 - r);
        res.x0 = ceildivpow2(c.x0, level);
        res.y0 = ceildivpow2(c.y0, level);
        res.x1 = ceildivpow2(c.x1, level);
        res.y1 = ceildivpow2(c.y1, level);
        res.pdx = p.prcw[r];
        res.pdy = p.prch[r];
        int32_t px0 = floordivpow2(res.x0, int(res.pdx)) << res.pdx;
        int32_t py0 = floordivpow2(res.y0, int(res.pdy)) << res.pdy;
        int32_t px1 = ceildivpow2(res.x1, int(res.pdx)) << res.pdx;
        int32_t py1 = ceildivpow2(res.y1, int(res.pdy)) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : uint32_t((px1 - px0) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : uint32_t((py1 - py0) >> res.pdy);
        if (res.pw && uint64_t(res.pw) * res.ph > (1u << 26))
          throw CodecError("unsupported JPEG2000: too many precincts in a tile");
        int32_t cbgx0, cbgy0;
        uint32_t cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = res.pdx;
          cbgh = res.pdy;
        } else {
          cbgx0 = ceildivpow2(px0, 1);
          cbgy0 = ceildivpow2(py0, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
        }
        uint32_t cbw = std::min(p.cblkw, cbgw), cbh = std::min(p.cblkh, cbgh);
        res.numbands = r == 0 ? 1 : 3;
        for (int b = 0; b < res.numbands; b++) {
          Band& band = res.bands[b];
          if (r == 0) {
            band.bandno = 0;
            band.x0 = ceildivpow2(c.x0, level);
            band.y0 = ceildivpow2(c.y0, level);
            band.x1 = ceildivpow2(c.x1, level);
            band.y1 = ceildivpow2(c.y1, level);
          } else {
            band.bandno = b + 1;
            int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
            band.x0 = ceildivpow2(int64_t(c.x0) - (xob << level), level + 1);
            band.y0 = ceildivpow2(int64_t(c.y0) - (yob << level), level + 1);
            band.x1 = ceildivpow2(int64_t(c.x1) - (xob << level), level + 1);
            band.y1 = ceildivpow2(int64_t(c.y1) - (yob << level), level + 1);
          }
          int si = r == 0 ? 0 : int(3 * (r - 1) + b + 1);
          // irreversible decoding: no log2 gain (9/7 high bands are scaled in the DWT)
          int32_t rb = int32_t(p.prec) + (p.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0
                                                              : band.bandno == 3 ? 2 : 1));
          band.stepsize = float((1.0 + p.mant[si] / 2048.0) * pow(2.0, rb - p.expn[si]));
          band.numbps = p.expn[si] + int32_t(p.numgbits) - 1;
          if (band.empty()) continue;
          uint32_t nprec = res.pw * res.ph;
          band.precs.resize(nprec);
          for (uint32_t k = 0; k < nprec; k++) {
            Prec& pr = band.precs[k];
            int32_t cx = cbgx0 + int32_t(k % res.pw) * (1 << cbgw);
            int32_t cy = cbgy0 + int32_t(k / res.pw) * (1 << cbgh);
            pr.x0 = std::max(cx, band.x0);
            pr.y0 = std::max(cy, band.y0);
            pr.x1 = std::min(cx + (1 << cbgw), band.x1);
            pr.y1 = std::min(cy + (1 << cbgh), band.y1);
            int32_t bx0 = floordivpow2(pr.x0, int(cbw)) << cbw;
            int32_t by0 = floordivpow2(pr.y0, int(cbh)) << cbh;
            int32_t bx1 = ceildivpow2(pr.x1, int(cbw)) << cbw;
            int32_t by1 = ceildivpow2(pr.y1, int(cbh)) << cbh;
            if (bx1 < bx0 || by1 < by0)
              throw CodecError("corrupt JPEG2000: a precinct outside its band");
            pr.cw = uint32_t((bx1 - bx0) >> cbw);
            pr.ch = uint32_t((by1 - by0) >> cbh);
            pr.cblks.resize(size_t(pr.cw) * pr.ch);
            for (uint32_t j = 0; j < pr.cw * pr.ch; j++) {
              Cblk& cb = pr.cblks[j];
              int32_t x = bx0 + int32_t(j % pr.cw) * (1 << cbw);
              int32_t y = by0 + int32_t(j / pr.cw) * (1 << cbh);
              cb.x0 = std::max(x, pr.x0);
              cb.y0 = std::max(y, pr.y0);
              cb.x1 = std::min(x + (1 << cbw), pr.x1);
              cb.y1 = std::min(y + (1 << cbh), pr.y1);
            }
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  // OpenJPEG's opj_pi_next_* over each progression (the POC entries, or the
  // tile's one), a packet yielded the first time it comes
  std::vector<Packet> packets() {
    uint32_t maxres = 0, maxprec = 0, nc = uint32_t(comps.size());
    for (Comp& c : comps) {
      maxres = std::max(maxres, c.p.numres);
      for (Res& r : c.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    uint64_t step_c = maxprec, step_r = uint64_t(nc) * step_c, step_l = maxres * step_r;
    uint64_t include_size = (uint64_t(numlayers) + 1) * step_l;
    if (include_size > (uint64_t(1) << 31))
      throw CodecError("unsupported JPEG2000: too many packets in a tile");
    std::vector<uint8_t> include(include_size, 0);
    std::vector<Packet> out;
    std::vector<Poc> progs = pocs;
    if (progs.empty()) progs.push_back({0, 0, numlayers, maxres, nc, prg});
    for (Poc& poc : progs) {
      uint32_t layno1 = std::min(poc.layno1, numlayers), compno1 = std::min(poc.compno1, nc);
      auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
        uint64_t idx = l * step_l + r * step_r + c * step_c + p;
        if (idx < include_size && !include[idx]) {
          include[idx] = 1;
          out.push_back({c, r, p, l});
        }
      };
      switch (poc.prg) {
        case 0:  // LRCP
          for (uint32_t l = 0; l < layno1; l++)
            for (uint32_t r = poc.resno0; r < poc.resno1; r++)
              for (uint32_t c = poc.compno0; c < compno1; c++) {
                if (r >= comps[c].p.numres) continue;
                Res& res = comps[c].res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; p++) emit(l, r, c, p);
              }
          break;
        case 1:  // RLCP
          for (uint32_t r = poc.resno0; r < poc.resno1; r++)
            for (uint32_t l = 0; l < layno1; l++)
              for (uint32_t c = poc.compno0; c < compno1; c++) {
                if (r >= comps[c].p.numres) continue;
                Res& res = comps[c].res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; p++) emit(l, r, c, p);
              }
          break;
        case 2:
        case 3:
        case 4:
          positional(poc, layno1, compno1, emit);
          break;
        default:
          break;  // no packets
      }
    }
    return out;
  }

  template <class Emit>
  void positional(const Poc& poc, uint32_t layno1, uint32_t compno1, Emit& emit) {
    auto steps = [&](uint32_t c0, uint32_t c1, uint32_t& dx, uint32_t& dy) {
      dx = dy = 0;
      for (uint32_t c = c0; c < c1; c++) {
        const Comp& comp = comps[c];
        for (uint32_t r = 0; r < comp.p.numres; r++) {
          const Res& res = comp.res[r];
          uint32_t sx = res.pdx + comp.p.numres - 1 - r, sy = res.pdy + comp.p.numres - 1 - r;
          if (sx < 32 && comp.p.dx <= UINT32_MAX / (1u << sx)) {
            uint32_t v = comp.p.dx * (1u << sx);
            dx = !dx ? v : std::min(dx, v);
          }
          if (sy < 32 && comp.p.dy <= UINT32_MAX / (1u << sy)) {
            uint32_t v = comp.p.dy * (1u << sy);
            dy = !dy ? v : std::min(dy, v);
          }
        }
      }
      return dx != 0 && dy != 0;
    };
    // the precinct of component c, resolution r at (x, y), or -1
    auto precinct = [&](uint32_t c, uint32_t r, int32_t x, int32_t y) -> int64_t {
      const Comp& comp = comps[c];
      if (r >= comp.p.numres) return -1;
      const Res& res = comp.res[r];
      uint32_t levelno = comp.p.numres - 1 - r;
      if (levelno >= 32 || ((comp.p.dx << levelno) >> levelno) != comp.p.dx ||
          ((comp.p.dy << levelno) >> levelno) != comp.p.dy)
        return -1;
      int32_t dxl = int32_t(comp.p.dx << levelno), dyl = int32_t(comp.p.dy << levelno);
      auto ceildiv = [](int32_t a, int32_t b) { return int32_t((int64_t(a) + b - 1) / b); };
      int32_t trx0 = ceildiv(tx0, dxl), try0 = ceildiv(ty0, dyl);
      int32_t trx1 = ceildiv(tx1, dxl), try1 = ceildiv(ty1, dyl);
      uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 31 || ((comp.p.dx << rpx) >> rpx) != comp.p.dx || rpy >= 31 ||
          ((comp.p.dy << rpy) >> rpy) != comp.p.dy)
        return -1;
      if (!((y % int32_t(comp.p.dy << rpy) == 0) ||
            ((y == ty0) && ((int64_t(try0) << levelno) % (int64_t(1) << rpy)))))
        return -1;
      if (!((x % int32_t(comp.p.dx << rpx) == 0) ||
            ((x == tx0) && ((int64_t(trx0) << levelno) % (int64_t(1) << rpx)))))
        return -1;
      if (res.pw == 0 || res.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      int32_t prci = floordivpow2(ceildiv(x, dxl), int(res.pdx)) - floordivpow2(trx0, int(res.pdx));
      int32_t prcj = floordivpow2(ceildiv(y, dyl), int(res.pdy)) - floordivpow2(try0, int(res.pdy));
      return int64_t(uint32_t(prci + prcj * int32_t(res.pw)));
    };
    uint32_t dx, dy;
    auto next = [](int32_t v, uint32_t d) { return v + int32_t(d - uint32_t(v % int32_t(d))); };
    if (poc.prg == 4) {  // CPRL: the steps of each component
      for (uint32_t c = poc.compno0; c < compno1; c++) {
        if (!steps(c, c + 1, dx, dy)) return;
        for (int32_t y = ty0; y < ty1; y = next(y, dy))
          for (int32_t x = tx0; x < tx1; x = next(x, dx))
            for (uint32_t r = poc.resno0; r < std::min(poc.resno1, comps[c].p.numres); r++) {
              int64_t p = precinct(c, r, x, y);
              if (p < 0) continue;
              for (uint32_t l = 0; l < layno1; l++) emit(l, r, c, uint32_t(p));
            }
      }
      return;
    }
    if (!steps(0, uint32_t(comps.size()), dx, dy)) return;
    if (poc.prg == 2) {  // RPCL
      for (uint32_t r = poc.resno0; r < poc.resno1; r++)
        for (int32_t y = ty0; y < ty1; y = next(y, dy))
          for (int32_t x = tx0; x < tx1; x = next(x, dx))
            for (uint32_t c = poc.compno0; c < compno1; c++) {
              int64_t p = precinct(c, r, x, y);
              if (p < 0) continue;
              for (uint32_t l = 0; l < layno1; l++) emit(l, r, c, uint32_t(p));
            }
    } else {  // PCRL
      for (int32_t y = ty0; y < ty1; y = next(y, dy))
        for (int32_t x = tx0; x < tx1; x = next(x, dx))
          for (uint32_t c = poc.compno0; c < compno1; c++)
            for (uint32_t r = poc.resno0; r < std::min(poc.resno1, comps[c].p.numres); r++) {
              int64_t p = precinct(c, r, x, y);
              if (p < 0) continue;
              for (uint32_t l = 0; l < layno1; l++) emit(l, r, c, uint32_t(p));
            }
    }
  }

  // opj_t2_read_packet_header + opj_t2_read_packet_data; `at` advances
  void read_packet(const Packet& pk, size_t& at) {
    Comp& comp = comps[pk.compno];
    Res& res = comp.res[pk.resno];
    const uint32_t cblksty = comp.p.cblksty;
    if (pk.layno == 0) {
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (pk.precno >= band.precs.size()) throw CodecError("corrupt JPEG2000: invalid precinct");
        Prec& pr = band.precs[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (Cblk& cb : pr.cblks) cb.numsegs = 0;
      }
    }
    size_t max_length = len - at;
    size_t cur = at;
    if (csty & 0x02) {  // SOP: skipped where present
      if (max_length >= 6 && src[cur] == 0xFF && src[cur + 1] == 0x91) cur += 6;
    }
    size_t remaining = len - cur;
    Bio bio(src + cur, remaining);
    auto eph = [&](size_t hdr_end) {  // too little room for it is no error, a wrong one is
      if (!(csty & 0x04) || remaining - (hdr_end - cur) < 2) return hdr_end;
      if (src[hdr_end] != 0xFF || src[hdr_end + 1] != 0x92)
        throw CodecError("corrupt JPEG2000: a packet header without its EPH marker");
      return hdr_end + 2;
    };
    if (!bio.read(1)) {
      bio.inalign();
      at = eph(cur + bio.numbytes());
      return;
    }
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[pk.precno];
      for (uint32_t k = 0; k < pr.cblks.size(); k++) {
        Cblk& cb = pr.cblks[k];
        uint32_t included = !cb.numsegs ? tgt_decode(bio, pr.incl, k, int32_t(pk.layno + 1))
                                        : bio.read(1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          uint32_t i = 0;
          // ends by i = 1000 at most: a node's value starts at 999
          while (!tgt_decode(bio, pr.imsb, k, int32_t(i))) ++i;
          cb.numbps = uint32_t(band.numbps) + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = numpasses(bio);
        uint32_t increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        uint32_t segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        }
        int32_t n = int32_t(cb.numnewpasses);
        do {
          Seg& s = cb.segs[segno];
          s.numnewpasses = uint32_t(std::min<int64_t>(int64_t(s.maxpasses) - s.numpasses, n));
          uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
          if (bits > 32) throw CodecError("corrupt JPEG2000: a segment length of over 32 bits");
          s.newlen = bio.read(bits);
          n -= int32_t(s.numnewpasses);
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        } while (n > 0);
      }
    }
    bio.inalign();
    size_t data = eph(cur + bio.numbytes());
    // the packet's body
    size_t end = len;
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[pk.precno];
      for (Cblk& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        uint32_t si;
        if (!cb.numsegs) {
          si = 0;
          ++cb.numsegs;
        } else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
            ++si;
            ++cb.numsegs;
          }
        }
        do {
          Seg& s = cb.segs[si];
          if (data + s.newlen > end)
            throw CodecError("truncated JPEG2000: a code-block segment runs past the tile");
          cb.chunks.push_back({data, s.newlen});
          data += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          if (cb.numnewpasses > 0) {
            ++si;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
    at = data;
  }

  void decode(int32_t* out, int32_t* resno_decoded) {
    geometry();
    std::vector<Packet> pks = packets();
    size_t at = 0;
    for (const Packet& pk : pks) {
      read_packet(pk, at);
      resno_decoded[pk.compno] = std::max(resno_decoded[pk.compno], int32_t(pk.resno));
    }
    // tier 1 and dequantisation, code-block by code-block
    struct Job {
      Comp* comp;
      uint32_t r;
      Band* band;
      Cblk* cb;
    };
    std::vector<Job> jobs;
    for (Comp& comp : comps)
      for (uint32_t r = 0; r < comp.p.numres; r++)
        for (int b = 0; b < comp.res[r].numbands; b++) {
          Band& band = comp.res[r].bands[b];
          if (band.empty()) continue;
          for (Prec& pr : band.precs)
            for (Cblk& cb : pr.cblks) jobs.push_back({&comp, r, &band, &cb});
        }
    struct Scratch {
      Tier1 t1;
      std::vector<uint8_t> all, bytes;
      std::vector<size_t> starts;
      std::vector<Segment> segs;
    };
    std::vector<Scratch> scratch(8);
    parallel_for(jobs.size(), 64, [&](size_t i, size_t t) {
      decode_cblk(*jobs[i].comp, jobs[i].r, *jobs[i].band, *jobs[i].cb, scratch[t]);
    });
    // a component a thread where the tile is large enough to pay for them
    const size_t per_thread = comps[0].buf.size() >= (size_t(1) << 18) ? 1 : comps.size();
    parallel_for(comps.size(), per_thread, [&](size_t c, size_t) {
      uint32_t levels = uint32_t(resno_decoded[c]) + 1;
      if (comps[c].p.qmfbid == 1)
        idwt53(comps[c], levels);
      else
        idwt97(comps[c], levels);
    });
    if (mct && comps.size() >= 3) {
      if (resno_decoded[0] != resno_decoded[1] || resno_decoded[0] != resno_decoded[2] ||
          comps[0].buf.size() != comps[1].buf.size() || comps[0].buf.size() != comps[2].buf.size())
        throw CodecError("corrupt JPEG2000: components of different sizes under an MCT");
      size_t n = comps[0].buf.size();
      uint32_t *c0 = comps[0].buf.data(), *c1 = comps[1].buf.data(), *c2 = comps[2].buf.data();
      if (comps[0].p.qmfbid == 1) {
        for (size_t i = 0; i < n; i++) {  // RCT, in int32 as OpenJPEG wraps
          uint32_t y = c0[i], u = c1[i], v = c2[i];
          uint32_t g = y - uint32_t(int32_t(u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        for (size_t i = 0; i < n; i++) {  // ICT
          float y, u, v;
          memcpy(&y, &c0[i], 4);
          memcpy(&u, &c1[i], 4);
          memcpy(&v, &c2[i], 4);
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f);
          g = g - (v * 0.71414f);
          float b = y + (u * 1.772f);
          memcpy(&c0[i], &r, 4);
          memcpy(&c1[i], &g, 4);
          memcpy(&c2[i], &b, 4);
        }
      }
    }
    std::vector<int32_t*> outs;
    for (Comp& comp : comps) {
      outs.push_back(out);
      out += comp.buf.size();
    }
    parallel_for(comps.size(), per_thread,
                 [&](size_t c, size_t) { level_shift(comps[c], outs[c]); });
  }

 private:
  // the DC level shift, float rounded to the nearest even integer, and the
  // clamp to the component's precision, into `out`
  static void level_shift(const Comp& comp, int32_t* out) {
    const CompParams& p = comp.p;
    int64_t lo, hi, shift;
    if (p.sgnd) {
      lo = -(int64_t(1) << (p.prec - 1));
      hi = (int64_t(1) << (p.prec - 1)) - 1;
      shift = 0;
    } else {
      lo = 0;
      hi = (int64_t(1) << p.prec) - 1;
      shift = int64_t(1) << (p.prec - 1);
    }
    const size_t n = comp.buf.size();
    if (p.qmfbid == 1) {
      const int32_t* v = reinterpret_cast<const int32_t*>(comp.buf.data());
      for (size_t i = 0; i < n; i++)
        out[i] = int32_t(std::min(std::max(int64_t(v[i]) + shift, lo), hi));
    } else {
      const float* v = reinterpret_cast<const float*>(comp.buf.data());
      for (size_t i = 0; i < n; i++) {
        float f = v[i];
        int64_t r;
        if (f > float(INT32_MAX)) {
          r = hi;
        } else if (f < float(INT32_MIN)) {
          r = lo;
        } else {
          // lrintf (nearest, ties to even): below 2^22 adding and taking
          // away 1.5 * 2^23 rounds the same way, in float
          float m = f < 0 ? -f : f;
          r = (m < 4194304.0f ? int64_t((f + 12582912.0f) - 12582912.0f) : int64_t(lrintf(f)))
              + shift;
        }
        out[i] = int32_t(std::min(std::max(r, lo), hi));
      }
    }
  }

  template <class Scratch>
  void decode_cblk(Comp& comp, uint32_t r, Band& band, Cblk& cb, Scratch& sc) {
    const CompParams& p = comp.p;
    int32_t tw = comp.x1 - comp.x0;
    int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
    // the block's bytes end to end, each segment followed by 0xFF 0xFF
    sc.all.clear();
    for (auto& chunk : cb.chunks)
      sc.all.insert(sc.all.end(), src + chunk.first, src + chunk.first + chunk.second);
    sc.bytes.clear();
    sc.starts.clear();
    size_t off = 0;
    for (uint32_t s = 0; s < cb.numsegs; s++) {
      sc.starts.push_back(sc.bytes.size());
      sc.bytes.insert(sc.bytes.end(), sc.all.begin() + off,
                      sc.all.begin() + off + cb.segs[s].len);
      sc.bytes.push_back(0xFF);
      sc.bytes.push_back(0xFF);
      off += cb.segs[s].len;
    }
    sc.segs.clear();
    for (uint32_t s = 0; s < cb.numsegs; s++)
      sc.segs.push_back({sc.bytes.data() + sc.starts[s], cb.segs[s].numpasses});
    if (!sc.t1.decode(std::max(cw, 0), std::max(ch, 0), band.bandno, p.roishift, p.cblksty,
                      cb.numbps, sc.segs, !cb.chunks.empty()))
      throw CodecError("corrupt JPEG2000: a code-block of 31 bit-planes or more");
    if (cw <= 0 || ch <= 0) return;
    if (p.roishift) {
      if (p.roishift >= 31) {
        std::fill(sc.t1.data.begin(), sc.t1.data.end(), 0);
      } else {
        int32_t thresh = 1 << p.roishift;
        for (int32_t& v : sc.t1.data) {
          int32_t mag = v < 0 ? -v : v;
          if (mag >= thresh) {
            mag >>= p.roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
    int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
    if (band.bandno & 1) x += comp.res[r - 1].x1 - comp.res[r - 1].x0;
    if (band.bandno & 2) y += comp.res[r - 1].y1 - comp.res[r - 1].y0;
    const float step = 0.5f * band.stepsize;
    for (int j = 0; j < ch; j++) {
      uint32_t* row = &comp.buf[size_t(y + j) * tw + x];
      const int32_t* d = &sc.t1.data[size_t(j) * cw];
      for (int i = 0; i < cw; i++) {
        if (p.qmfbid == 1) {
          row[i] = uint32_t(d[i] / 2);
        } else {
          float f = float(d[i]) * step;
          memcpy(&row[i], &f, 4);
        }
      }
    }
  }

  // resolution r's width and height, and the parity of its origin
  static void level(const Comp& comp, uint32_t r, int32_t& w, int32_t& h, int& casx, int& casy) {
    const Res& res = comp.res[r];
    w = res.x1 - res.x0;
    h = res.y1 - res.y0;
    casx = int(uint32_t(res.x0) % 2);
    casy = int(uint32_t(res.y0) % 2);
  }

  // the reversible 5/3 synthesis (OpenJPEG's opj_idwt53_h/v) of n lines
  // at once, each `stride` apart in `x` and `width` samples wide: line k
  // holds low samples at coordinates of parity `cas`, high ones between;
  // whole-sample symmetric extension, int32 arithmetic wrapping as
  // OpenJPEG's does. A lone sample at an odd coordinate is halved.
  static void lift53(int32_t* x, size_t stride, int32_t n, int32_t width, int cas) {
    if (n == 1) {
      if (cas)
        for (int32_t i = 0; i < width; i++) x[i] /= 2;
      return;
    }
    if (n == 0) return;
    auto line = [&](int32_t k) {
      if (k < 0) k = -k;
      if (k >= n) k = 2 * (n - 1) - k;
      return x + size_t(k) * stride;
    };
    for (int32_t k = cas; k < n; k += 2) {  // low (even coordinates)
      int32_t *d = line(k);
      const int32_t *l = line(k - 1), *r = line(k + 1);
      for (int32_t i = 0; i < width; i++)
        d[i] = int32_t(uint32_t(d[i]) -
                       uint32_t(int32_t(uint32_t(l[i]) + uint32_t(r[i]) + 2u) >> 2));
    }
    for (int32_t k = 1 - cas; k < n; k += 2) {  // high (odd coordinates)
      int32_t *d = line(k);
      const int32_t *l = line(k - 1), *r = line(k + 1);
      for (int32_t i = 0; i < width; i++)
        d[i] = int32_t(uint32_t(d[i]) + uint32_t(int32_t(uint32_t(l[i]) + uint32_t(r[i])) >> 1));
    }
  }

  // `sn` low then `dn` high lines of `src` (`stride` apart, `width` wide)
  // into `dst` interleaved: low at cas + 2i, high at 1 - cas + 2i
  template <class T>
  static void interleave(const T* src, size_t stride, int32_t sn, int32_t dn, int cas,
                         int32_t width, T* dst, size_t dstride) {
    for (int32_t i = 0; i < sn; i++)
      memcpy(dst + size_t(cas + 2 * i) * dstride, src + size_t(i) * stride,
             size_t(width) * sizeof(T));
    for (int32_t i = 0; i < dn; i++)
      memcpy(dst + size_t(1 - cas + 2 * i) * dstride, src + size_t(sn + i) * stride,
             size_t(width) * sizeof(T));
  }

  void idwt53(Comp& comp, uint32_t numres) {
    if (numres > comp.res.size()) numres = uint32_t(comp.res.size());
    int32_t w = comp.x1 - comp.x0;
    int32_t* a = reinterpret_cast<int32_t*>(comp.buf.data());
    std::vector<int32_t> tmp;
    for (uint32_t r = 1; r < numres; r++) {
      int32_t rw, rh, pw, ph;
      int casx, casy, px, py;
      level(comp, r, rw, rh, casx, casy);
      level(comp, r - 1, pw, ph, px, py);
      tmp.resize(std::max(size_t(rw), size_t(rw) * rh));
      for (int32_t j = 0; j < rh; j++) {  // each row on its own
        int32_t* row = a + size_t(j) * w;
        for (int32_t i = 0; i < pw; i++) tmp[casx + 2 * i] = row[i];
        for (int32_t i = 0; i < rw - pw; i++) tmp[1 - casx + 2 * i] = row[pw + i];
        lift53(tmp.data(), 1, rw, 1, casx);
        memcpy(row, tmp.data(), size_t(rw) * 4);
      }
      // the columns, a whole row of them at a time
      interleave(a, size_t(w), ph, rh - ph, casy, rw, tmp.data(), size_t(rw));
      lift53(tmp.data(), size_t(rw), rh, rw, casy);
      for (int32_t j = 0; j < rh; j++)
        memcpy(a + size_t(j) * w, tmp.data() + size_t(j) * rw, size_t(rw) * 4);
    }
  }

  // the irreversible 9/7 synthesis of n lines at once, OpenJPEG's
  // opj_v8dwt_decode for each: the low band times K, the high band times
  // 2/K (OpenJPEG's 1.625732422, its step sizes carrying no gain), then the
  // four lifting steps, each w += (left + right) * c in float, an edge's one
  // neighbour taken twice. No multiply-add may be fused here: see the
  // file's head.
  static void lift97(float* x, size_t stride, int32_t sn, int32_t dn, int cas, int32_t width) {
    const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
    const float kDelta = -0.443506852f, kGamma = -0.882911075f, kBeta = 0.052980118f,
                kAlpha = 1.586134342f;
    int a, b;
    if (cas == 0) {
      if (!(dn > 0 || sn > 1)) return;
      a = 0;
      b = 1;
    } else {
      if (!(sn > 0 || dn > 1)) return;
      a = 1;
      b = 0;
    }
    auto line = [&](int32_t k) { return x + size_t(k) * stride; };
    for (int32_t k = 0; k < sn; k++) {
      float* d = line(a + 2 * k);
      for (int32_t i = 0; i < width; i++) d[i] = d[i] * kK;
    }
    for (int32_t k = 0; k < dn; k++) {
      float* d = line(b + 2 * k);
      for (int32_t i = 0; i < width; i++) d[i] = d[i] * kTwoInvK;
    }
    // opj_v8dwt_decode_step2(l, w, 0, end, m, c): lines lo, wo, wo + 2, ...
    auto step = [&](int lo, int wo, int32_t end, int32_t m, float c) {
      int32_t fl = lo, fw = wo;
      int32_t imax = std::min(end, m);
      for (int32_t k = 0; k < imax; k++) {
        float* d = line(fw - 1);
        const float *l = line(fl), *r = line(fw);
        for (int32_t i = 0; i < width; i++) d[i] = d[i] + (l[i] + r[i]) * c;
        fl = fw;
        fw += 2;
      }
      if (m < end) {
        float c2 = c + c;
        float* d = line(fw - 1);
        const float* l = line(fl);
        for (int32_t i = 0; i < width; i++) d[i] = d[i] + l[i] * c2;
      }
    };
    step(b, a + 1, sn, std::min(sn, dn - a), kDelta);
    step(a, b + 1, dn, std::min(dn, sn - b), kGamma);
    step(b, a + 1, sn, std::min(sn, dn - a), kBeta);
    step(a, b + 1, dn, std::min(dn, sn - b), kAlpha);
  }

  void idwt97(Comp& comp, uint32_t numres) {
    if (numres > comp.res.size()) numres = uint32_t(comp.res.size());
    int32_t w = comp.x1 - comp.x0;
    float* a = reinterpret_cast<float*>(comp.buf.data());
    std::vector<float> tmp;
    for (uint32_t r = 1; r < numres; r++) {
      int32_t rw, rh, pw, ph;
      int casx, casy, px, py;
      level(comp, r, rw, rh, casx, casy);
      level(comp, r - 1, pw, ph, px, py);
      tmp.resize(std::max(size_t(rw), size_t(rw) * rh));
      for (int32_t j = 0; j < rh; j++) {
        float* row = a + size_t(j) * w;
        for (int32_t i = 0; i < pw; i++) tmp[casx + 2 * i] = row[i];
        for (int32_t i = 0; i < rw - pw; i++) tmp[1 - casx + 2 * i] = row[pw + i];
        lift97(tmp.data(), 1, pw, rw - pw, casx, 1);
        memcpy(row, tmp.data(), size_t(rw) * 4);
      }
      interleave(a, size_t(w), ph, rh - ph, casy, rw, tmp.data(), size_t(rw));
      lift97(tmp.data(), size_t(rw), ph, rh - ph, casy, rw);
      for (int32_t j = 0; j < rh; j++)
        memcpy(a + size_t(j) * w, tmp.data() + size_t(j) * rw, size_t(rw) * 4);
    }
  }
};

constexpr int kHeader = 10, kCompInts = 12 + 2 * kMaxRes + 2 * kMaxBands, kPocInts = 6;

}  // namespace

extern "C" {

// One tile: `params` as core/codec.py packs them (header, then each
// component's parameters, then the POC entries), `data` the tile-parts'
// bytes end to end; `out` each component's plane of the tile, in order;
// `resno_decoded` each component's highest resolution decoded so far
// (OpenJPEG keeps it across tiles), updated.
int qie_j2k_tile(const int32_t* params, long nparams, const uint8_t* data, long len,
                 int32_t* out, int32_t* resno_decoded, char* err, int errlen) {
  try {
    if (nparams < kHeader) throw CodecError("JPEG2000: bad tile parameters");
    Tile t;
    t.tx0 = params[0];
    t.ty0 = params[1];
    t.tx1 = params[2];
    t.ty1 = params[3];
    uint32_t nc = uint32_t(params[4]);
    t.prg = uint32_t(params[5]);
    t.numlayers = uint32_t(params[6]);
    t.mct = uint32_t(params[7]);
    t.csty = uint32_t(params[8]);
    uint32_t npoc = uint32_t(params[9]);
    if (nparams != long(kHeader + nc * kCompInts + npoc * kPocInts))
      throw CodecError("JPEG2000: bad tile parameters");
    const int32_t* p = params + kHeader;
    t.comps.resize(nc);
    for (uint32_t c = 0; c < nc; c++, p += kCompInts) {
      CompParams& cp = t.comps[c].p;
      uint32_t* f = &cp.dx;
      for (int i = 0; i < 12; i++) f[i] = uint32_t(p[i]);
      for (int i = 0; i < kMaxRes; i++) {
        cp.prcw[i] = uint32_t(p[12 + i]);
        cp.prch[i] = uint32_t(p[12 + kMaxRes + i]);
      }
      for (int i = 0; i < kMaxBands; i++) {
        cp.expn[i] = p[12 + 2 * kMaxRes + i];
        cp.mant[i] = p[12 + 2 * kMaxRes + kMaxBands + i];
      }
    }
    for (uint32_t i = 0; i < npoc; i++, p += kPocInts)
      t.pocs.push_back({uint32_t(p[0]), uint32_t(p[1]), uint32_t(p[2]), uint32_t(p[3]),
                        uint32_t(p[4]), uint32_t(p[5])});
    t.src = data;
    t.len = size_t(len);
    t.decode(out, resno_decoded);
    return 0;
  } catch (const std::bad_alloc&) {
    qie::set_err(err, errlen, "unsupported JPEG2000: a tile too large to decode");
    return -1;
  } catch (const std::exception& e) {
    qie::set_err(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
