// Host-side pixel decoding of JPEG 2000 frames (a JP2 file's codestream or
// a raw one) for the serving pipeline and `load_image`, to the (C, H, W)
// uint8 layout the port's entry points take, with the values cv::imread
// gives (C = 1 IMREAD_GRAYSCALE, C = 3 IMREAD_COLOR, B, G, R planes).
//
// Replaces the cv2.imread fallback of of_dis_tpu/utils/io.py::load_image
// for JPEG 2000. Plain C entries, no CUDA, no codec library: Python parses
// the boxes and the codestream's main header (`utils/io.py::jp2_header`)
// into the parameters `of_jp2_decode` takes; this file walks the
// tile-parts, decodes the packets (tier-2), the code-blocks (tier-1: the
// MQ decoder and the three coding passes), dequantises, undoes the
// wavelet transform and the component transform and lays the planes out
// as cv::imread does. A ctypes call releases the interpreter lock, so a
// thread pool over frames runs it side by side.
//
// Which rules: OpenJPEG 2.5's, through which cv::imread reads JPEG 2000,
// held to cv2.imread plane for plane by tests/test_torch_jp2.py. Tier-1
// keeps one fractional bit and rebuilds a coefficient at the middle of
// the interval its decoded bit-planes leave (`one | one >> 1`); the 5/3
// path halves it by C's truncating division, the 9/7 path multiplies it
// by half the band's step. The 9/7 inverse follows OpenJPEG's lifting
// form, constants and order of operations in float32: the low band times
// K, the high band times 1.625732422 (OpenJPEG's 2/K, its step sizes use
// no band gain to make up for it), then x += (a + b) * c in four steps,
// rows before columns. The DC shift of the 9/7 path rounds to nearest
// even before the clamp. Samples above 8 bits are shifted down by the
// largest precision less 8, gray of three components is cvtColor's
// BGR2GRAY in 1/32768ths (gray.h). Only code-block style 0 and what the
// parser lets through are decoded; anything cut short, or any packet or
// code-block that does not fit its tile-part, is refused.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

#include "gray.h"

namespace {

enum Code {
  kOk = 0,
  kShort = -1,       // a tile-part, packet or code-block past its end
  kLayout = -2,      // parameters the decoder does not take
  kMarker = -3,      // a tile-part header the decoder does not take
  kPacket = -4,      // a packet header that does not decode
  kCodeblock = -5,   // a code-block of more bit-planes or passes than it may
  kNoMemory = -6,
  kTiles = -7,       // a tile missing, or its tile-parts out of order
  kCorrupt = -8,     // a marker other than SOT or EOC after a tile-part
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// ------------------------------------------------------------ parameters

// The layout of the int64 parameter array `utils/io.py::jp2_header`
// builds: the image, then one block of kCompStride values a component.
constexpr int kWidth = 0, kHeight = 1, kComps = 2, kTileW = 3, kTileH = 4,
              kLayers = 5, kProg = 6, kMct = 7, kShift = 8, kHead = 16;
constexpr int kMaxRes = 33, kMaxBands = 3 * (kMaxRes - 1) + 1;
constexpr int kPrec = 0, kNumRes = 1, kCblkW = 2, kCblkH = 3, kCblkSty = 4,
              kQmfb = 5, kGuard = 6, kPrcW = 8, kPrcH = kPrcW + kMaxRes,
              kExpn = kPrcH + kMaxRes, kMant = kExpn + kMaxBands,
              kCompStride = kMant + kMaxBands;

struct CompParams {
  int prec, numres, cblkw, cblkh, qmfbid, guard;
  int prcw[kMaxRes], prch[kMaxRes];
  int expn[kMaxBands], mant[kMaxBands];
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceil_pow2(int64_t a, int b) { return (a + (int64_t{1} << b) - 1) >> b; }
int64_t floor_pow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------ structures

struct Codeblock {
  int64_t x0, y0, x1, y1;
  bool included = false;
  int numbps = 0, lenbits = 3, passes = 0;
  std::vector<uint8_t> data;
};

// The tag tree of a precinct's code-blocks (B.10.2), as OpenJPEG decodes
// it: value 999 until a bit fixes it, `low` the lower bound known.
struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;

  void build(int64_t w, int64_t h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<std::pair<int64_t, int64_t>> dims;
    for (int64_t cw = w, ch = h;;) {
      dims.emplace_back(cw, ch);
      if (cw == 1 && ch == 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    std::vector<int64_t> start(dims.size());
    int64_t total = 0;
    for (size_t k = 0; k < dims.size(); ++k) {
      start[k] = total;
      total += dims[k].first * dims[k].second;
    }
    nodes.resize(static_cast<size_t>(total));
    for (size_t k = 0; k < dims.size(); ++k) {
      const int64_t cw = dims[k].first, ch = dims[k].second;
      for (int64_t y = 0; y < ch; ++y)
        for (int64_t x = 0; x < cw; ++x) {
          Node& n = nodes[static_cast<size_t>(start[k] + y * cw + x)];
          n.parent = k + 1 < dims.size()
                         ? static_cast<int>(start[k + 1]
                                            + (y / 2) * dims[k + 1].first
                                            + x / 2)
                         : -1;
        }
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

struct Precinct {
  int64_t cw = 0, ch = 0;
  std::vector<Codeblock> blocks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;              // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps;              // Mb
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy;
  int64_t pw, ph;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;   // 5/3
  std::vector<float> fdata;     // 9/7
};

// ------------------------------------------------------ packet header bits

// OpenJPEG's opj_bio reader: bits MSB first, 7 bits after a 0xFF byte;
// past the end it reads zeros (and `over` records that it did).
struct BitReader {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  bool over = false;

  BitReader(const uint8_t* p, const uint8_t* e) : start(p), bp(p), end(e) {}

  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end)
      buf |= *bp++;
    else
      over = true;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) {
      bytein();
      ct = 0;
    }
  }
  int64_t numbytes() const { return bp - start; }
};

// opj_tgt_decode: whether the leaf's value is below `threshold`
int tgt_decode(BitReader& bio, TagTree& tree, int64_t leaf, int threshold) {
  int stk[64];
  int depth = 0;
  int node = static_cast<int>(leaf);
  while (tree.nodes[node].parent >= 0) {
    if (depth == 64) fail(kPacket);
    stk[depth++] = node;
    node = tree.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& n = tree.nodes[node];
    if (low > n.low)
      n.low = low;
    else
      low = n.low;
    while (low < threshold && low < n.value) {
      if (bio.bit())
        n.value = low;
      else
        ++low;
    }
    n.low = low;
    if (depth == 0) break;
    node = stk[--depth];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

int num_passes(BitReader& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + static_cast<int>(n);
  n = bio.read(5);
  if (n != 31) return 6 + static_cast<int>(n);
  return 37 + static_cast<int>(bio.read(7));
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// One packet (layer `layno` of precinct `precno` of resolution `r`) from
// `data` at `*pos`: its header, then its code-blocks' bytes appended.
void read_packet(Resolution& res, int layno, int64_t precno,
                 const uint8_t* data, int64_t size, int64_t* pos) {
  if (precno >= res.pw * res.ph) fail(kPacket);
  if (layno == 0) {
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      Precinct& prc = band.precincts[static_cast<size_t>(precno)];
      prc.incl.reset();
      prc.imsb.reset();
    }
  }
  BitReader bio(data + *pos, data + size);
  if (!bio.read(1)) {  // an empty packet
    bio.inalign();
    if (bio.over) fail(kShort);
    *pos += bio.numbytes();
    return;
  }
  struct Pending {
    Codeblock* cb;
    uint32_t len;
    int passes;
  };
  std::vector<Pending> pending;
  for (Band& band : res.bands) {
    if (band.empty()) continue;
    Precinct& prc = band.precincts[static_cast<size_t>(precno)];
    const int64_t nblocks = prc.cw * prc.ch;
    for (int64_t k = 0; k < nblocks; ++k) {
      Codeblock& cb = prc.blocks[static_cast<size_t>(k)];
      int included;
      if (!cb.included)
        included = tgt_decode(bio, prc.incl, k, layno + 1);
      else
        included = static_cast<int>(bio.read(1));
      if (!included) continue;
      if (!cb.included) {
        int i = 0;
        while (!tgt_decode(bio, prc.imsb, k, i)) {
          ++i;
          if (i > 64) fail(kPacket);
        }
        cb.numbps = band.numbps + 1 - i;
        cb.lenbits = 3;
      }
      const int passes = num_passes(bio);
      int inc = 0;
      while (bio.read(1)) {
        if (++inc > 32) fail(kPacket);
      }
      cb.lenbits += inc;
      // one segment of at most 109 passes (code-block style 0)
      if (cb.passes + passes > 109) fail(kCodeblock);
      const int bits = cb.lenbits + floorlog2(static_cast<uint32_t>(passes));
      if (bits > 32) fail(kPacket);
      const uint32_t len = bio.read(bits);
      pending.push_back({&cb, len, passes});
    }
  }
  bio.inalign();
  if (bio.over) fail(kShort);
  int64_t at = *pos + bio.numbytes();
  for (const Pending& p : pending) {
    if (p.len > static_cast<uint64_t>(size - at)) fail(kShort);
    p.cb->data.insert(p.cb->data.end(), data + at, data + at + p.len);
    at += p.len;
    p.cb->passes += p.passes;
    p.cb->included = true;
  }
  *pos = at;
}

// ---------------------------------------------------------------- tier-1

// The MQ decoder of ISO 15444-1 C.3 as OpenJPEG writes it, over a buffer
// that ends in 0xFF 0xFF.
struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

struct Mq {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset_contexts() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  // `p` holds the segment's bytes and then 0xFF 0xFF
  void init(const uint8_t* p) {
    bp = p;
    c = static_cast<uint32_t>(*bp) << 16;
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
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(!mps[cx]);
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = static_cast<uint8_t>(!mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// Per-sample state: bits 0-7 the significance of the 8 neighbours (NW, N,
// NE, W, E, SW, S, SE), 8-11 whether the N, S, W, E neighbour is
// negative, then the sample's own significance, visit in this bit-plane,
// refinement and sign.
constexpr uint16_t kNbN = 1 << 1, kNbW = 1 << 3, kNbE = 1 << 4,
                   kNbS = 1 << 6;
constexpr uint16_t kNegN = 1 << 8, kNegS = 1 << 9, kNegW = 1 << 10,
                   kNegE = 1 << 11;
constexpr uint16_t kSig = 1 << 12, kVisit = 1 << 13, kRefined = 1 << 14,
                   kSign = 1 << 15;

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];    // context | xor bit << 7, by N S W E sig | neg << 4
  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int m = 0; m < 256; ++m) {
        int h = ((m >> 3) & 1) + ((m >> 4) & 1);
        int v = ((m >> 1) & 1) + ((m >> 6) & 1);
        const int d = (m & 1) + ((m >> 2) & 1) + ((m >> 5) & 1)
                      + ((m >> 7) & 1);
        int n;
        if (o == 3) {
          const int hv = h + v;
          if (d == 0)
            n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1)
            n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2)
            n = hv == 0 ? 6 : 7;
          else
            n = 8;
        } else {
          if (o == 1) {  // HL: vertical neighbours first
            const int t = h;
            h = v;
            v = t;
          }
          if (h == 0) {
            if (v == 0)
              n = d == 0 ? 0 : d == 1 ? 1 : 2;
            else
              n = v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        }
        zc[o][m] = static_cast<uint8_t>(n);
      }
    for (int m = 0; m < 256; ++m) {
      // bits 0-3: N, S, W, E significant; 4-7: negative
      auto contrib = [&](int k) {
        if (!((m >> k) & 1)) return 0;
        return ((m >> (k + 4)) & 1) ? -1 : 1;
      };
      int hc = contrib(2) + contrib(3), vc = contrib(0) + contrib(1);
      hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
      vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
      int ctx, x = 0;
      if (hc == 1)
        ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
      else if (hc == 0)
        ctx = vc == 1 ? 10 : vc == 0 ? 9 : 10;
      else
        ctx = vc == 1 ? 11 : vc == 0 ? 12 : 13;
      if (hc == -1 || (hc == 0 && vc == -1)) x = 1;
      sc[m] = static_cast<uint8_t>(ctx | (x << 7));
    }
  }
};

const Luts& luts() {
  static const Luts l;
  return l;
}

struct T1 {
  int64_t w, h, stride;
  std::vector<uint16_t> st;   // (h + 2) x (w + 2)
  std::vector<int32_t> data;  // h x w
  Mq mq;
  const uint8_t* zc;
  const uint8_t* sc = luts().sc;

  uint16_t* at(int64_t x, int64_t y) { return &st[(y + 1) * stride + x + 1]; }

  void make_significant(int64_t x, int64_t y, bool neg) {
    uint16_t* s = at(x, y);
    *s |= kSig | (neg ? kSign : 0);
    const int64_t S = stride;
    s[-S - 1] |= 1 << 7;  // we are its SE
    s[-S] |= kNbS | (neg ? kNegS : 0);
    s[-S + 1] |= 1 << 5;
    s[-1] |= kNbE | (neg ? kNegE : 0);
    s[1] |= kNbW | (neg ? kNegW : 0);
    s[S - 1] |= 1 << 2;
    s[S] |= kNbN | (neg ? kNegN : 0);
    s[S + 1] |= 1 << 0;
  }

  int sign_bit(uint16_t s) {
    const int m = ((s >> 1) & 1) | (((s >> 6) & 1) << 1) | (((s >> 3) & 1) << 2)
                  | (((s >> 4) & 1) << 3) | (((s >> 8) & 0xF) << 4);
    const uint8_t e = sc[m];
    return mq.decode(e & 0x7f) ^ (e >> 7);
  }

  void significance(int64_t x, int64_t y, int32_t oph) {
    const int neg = sign_bit(*at(x, y));
    data[y * w + x] = neg ? -oph : oph;
    make_significant(x, y, neg != 0);
  }

  void sigpass(int bpno) {
    const int32_t one = int32_t{1} << bpno, oph = one | (one >> 1);
    for (int64_t k = 0; k < h; k += 4)
      for (int64_t x = 0; x < w; ++x)
        for (int64_t y = k; y < k + 4 && y < h; ++y) {
          uint16_t* s = at(x, y);
          if ((*s & (kSig | kVisit)) == 0 && (*s & 0xff) != 0) {
            if (mq.decode(zc[*s & 0xff])) significance(x, y, oph);
            *s |= kVisit;
          }
        }
  }

  void refpass(int bpno) {
    const int32_t half = (int32_t{1} << bpno) >> 1;
    for (int64_t k = 0; k < h; k += 4)
      for (int64_t x = 0; x < w; ++x)
        for (int64_t y = k; y < k + 4 && y < h; ++y) {
          uint16_t* s = at(x, y);
          if ((*s & (kSig | kVisit)) == kSig) {
            const int ctx = (*s & kRefined) ? 16 : (*s & 0xff) ? 15 : 14;
            const int v = mq.decode(ctx);
            int32_t& d = data[y * w + x];
            d += (v ^ (d < 0)) ? half : -half;
            *s |= kRefined;
          }
        }
  }

  void clnpass(int bpno) {
    const int32_t one = int32_t{1} << bpno, oph = one | (one >> 1);
    for (int64_t k = 0; k < h; k += 4)
      for (int64_t x = 0; x < w; ++x) {
        int64_t y = k;
        if (k + 4 <= h && (*at(x, k) | *at(x, k + 1) | *at(x, k + 2)
                           | *at(x, k + 3)) == 0) {
          if (!mq.decode(kCtxAgg)) continue;
          int r = mq.decode(kCtxUni) << 1;
          r |= mq.decode(kCtxUni);
          y = k + r;
          significance(x, y, oph);
          ++y;
        }
        for (; y < k + 4 && y < h; ++y) {
          uint16_t* s = at(x, y);
          if ((*s & (kSig | kVisit)) == 0 && mq.decode(zc[*s & 0xff]))
            significance(x, y, oph);
        }
        for (int64_t yy = k; yy < k + 4 && yy < h; ++yy)
          *at(x, yy) &= static_cast<uint16_t>(~kVisit);
      }
  }

  // A code-block of numbps coded bit-planes and `passes` passes over its
  // bytes `buf` (followed by 0xFF 0xFF) into `data`.
  void decode(const Codeblock& cb, int orient, const uint8_t* buf) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    stride = w + 2;
    st.assign(static_cast<size_t>((h + 2) * stride), 0);
    data.assign(static_cast<size_t>(w * h), 0);
    zc = luts().zc[orient];
    mq.reset_contexts();
    mq.init(buf);
    int bpno = cb.numbps, type = 2;
    for (int p = 0; p < cb.passes && bpno >= 1; ++p) {
      if (type == 0)
        sigpass(bpno);
      else if (type == 1)
        refpass(bpno);
      else
        clnpass(bpno);
      if (++type == 3) {
        type = 0;
        --bpno;
      }
    }
  }
};

// -------------------------------------------------------- inverse wavelet

// The inverse transforms of one level along a line of n = sn + dn
// samples, low then high in `in` (sample k of lane l at in[k * is + l]),
// the first at an even (cas 0) or odd (cas 1) coordinate, interleaved
// into `out` (sample k of lane l at out[k * lanes + l]). A lane is one
// line: the rows are transformed one lane at a time, the columns of a
// level all at once, row by row, with the same arithmetic per sample.

// 5/3 (reversible), with OpenJPEG's wrap-around int32 arithmetic.
inline int32_t wrap(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

void idwt53(const int32_t* in, int64_t is, int64_t sn, int64_t dn, int cas,
            int32_t* out, int64_t lanes) {
  const int64_t n = sn + dn;
  if (n == 0) return;
  auto L = [&](int64_t i) { return in + i * is; };
  auto H = [&](int64_t i) { return in + (sn + i) * is; };
  auto X = [&](int64_t k) { return out + k * lanes; };
  if (n == 1) {
    for (int64_t l = 0; l < lanes; ++l)
      X(0)[l] = cas == 0 ? L(0)[l] : H(0)[l] / 2;
    return;
  }
  if (cas == 0) {
    for (int64_t i = 0; i < sn; ++i) {
      const int32_t* hl = H(i - 1 < 0 ? 0 : i - 1);
      const int32_t* hr = H(i < dn ? i : dn - 1);
      const int32_t* lo = L(i);
      int32_t* x = X(2 * i);
      for (int64_t l = 0; l < lanes; ++l)
        x[l] = wrap(lo[l] - ((int64_t{hl[l]} + hr[l] + 2) >> 2));
    }
    for (int64_t i = 0; i < dn; ++i) {
      const int32_t* xl = X(2 * i);
      const int32_t* xr = 2 * i + 2 < n ? X(2 * i + 2) : X(2 * i);
      const int32_t* hi = H(i);
      int32_t* x = X(2 * i + 1);
      for (int64_t l = 0; l < lanes; ++l)
        x[l] = wrap(hi[l] + ((int64_t{xl[l]} + xr[l]) >> 1));
    }
  } else {  // low samples at odd positions 2i + 1, high at even 2i
    for (int64_t i = 0; i < sn; ++i) {
      const int32_t* hl = H(i);
      const int32_t* hr = H(i + 1 < dn ? i + 1 : i);
      const int32_t* lo = L(i);
      int32_t* x = X(2 * i + 1);
      for (int64_t l = 0; l < lanes; ++l)
        x[l] = wrap(lo[l] - ((int64_t{hl[l]} + hr[l] + 2) >> 2));
    }
    for (int64_t i = 0; i < dn; ++i) {
      const int32_t* xl = 2 * i - 1 >= 0 ? X(2 * i - 1) : X(1);
      const int32_t* xr = 2 * i + 1 < n ? X(2 * i + 1) : xl;
      const int32_t* hi = H(i);
      int32_t* x = X(2 * i);
      for (int64_t l = 0; l < lanes; ++l)
        x[l] = wrap(hi[l] + ((int64_t{xl[l]} + xr[l]) >> 1));
    }
  }
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                kGamma = 0.882911075f, kDelta = 0.443506852f,
                kK = 1.230174105f, kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 on the interleaved samples `x`: from
// position wpos, x[wpos - 1 + 2i] += (left + x[wpos + 2i]) * c, the first
// left neighbour at lpos, then at the end one sample with only a left
// neighbour, x += left * (c + c).
void lift(float* x, int64_t lanes, int64_t lpos, int64_t wpos, int64_t end,
          int64_t m, float c) {
  const int64_t imax = end < m ? end : m;
  for (int64_t i = 0; i < imax; ++i) {
    const float* left = x + (i == 0 ? lpos : wpos + 2 * i - 2) * lanes;
    const float* right = x + (wpos + 2 * i) * lanes;
    float* t = x + (wpos - 1 + 2 * i) * lanes;
    for (int64_t l = 0; l < lanes; ++l)
      t[l] = t[l] + ((left[l] + right[l]) * c);
  }
  if (m < end) {
    const float* left = x + (m == 0 ? lpos : wpos + 2 * m - 2) * lanes;
    float* t = x + (wpos - 1 + 2 * m) * lanes;
    const float c2 = c + c;
    for (int64_t l = 0; l < lanes; ++l) t[l] = t[l] + left[l] * c2;
  }
}

// 9/7 (irreversible) as OpenJPEG 2.5's opj_v8dwt_decode
void idwt97(const float* in, int64_t is, int64_t sn, int64_t dn, int cas,
            float* x, int64_t lanes) {
  for (int64_t i = 0; i < sn; ++i)
    std::copy(in + i * is, in + i * is + lanes, x + (cas + 2 * i) * lanes);
  for (int64_t i = 0; i < dn; ++i)
    std::copy(in + (sn + i) * is, in + (sn + i) * is + lanes,
              x + (1 - cas + 2 * i) * lanes);
  int64_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int64_t i = 0; i < sn; ++i) {
    float* t = x + (a + 2 * i) * lanes;
    for (int64_t l = 0; l < lanes; ++l) t[l] = t[l] * kK;
  }
  for (int64_t i = 0; i < dn; ++i) {
    float* t = x + (b + 2 * i) * lanes;
    for (int64_t l = 0; l < lanes; ++l) t[l] = t[l] * kTwoInvK;
  }
  // OpenJPEG's (OPJ_UINT32)opj_int_min(p, q): a negative minimum wraps
  auto umin = [](int64_t p, int64_t q) {
    const int64_t v = p < q ? p : q;
    return v < 0 ? int64_t{1} << 40 : v;
  };
  const int64_t ml = umin(sn, dn - a), mh = umin(dn, sn - b);
  lift(x, lanes, b, a + 1, sn, ml, -kDelta);
  lift(x, lanes, a, b + 1, dn, mh, -kGamma);
  lift(x, lanes, b, a + 1, sn, ml, -kBeta);
  lift(x, lanes, a, b + 1, dn, mh, -kAlpha);
}

// Every level of a tile-component, rows then columns, as OpenJPEG's
// opj_dwt_decode_tile and opj_dwt_decode_tile_97.
template <typename T, typename Line>
void idwt_2d(TileComp& tc, T* d, Line line) {
  const int64_t w = tc.x1 - tc.x0;
  std::vector<T> out;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution& lo = tc.res[r - 1];
    const Resolution& hi = tc.res[r];
    const int64_t rw = hi.x1 - hi.x0, rh = hi.y1 - hi.y0;
    const int64_t snh = lo.x1 - lo.x0, snv = lo.y1 - lo.y0;
    const int cash = static_cast<int>(hi.x0 & 1),
              casv = static_cast<int>(hi.y0 & 1);
    out.resize(static_cast<size_t>((rw > rh ? rw : rh) * (rw > 0 ? rw : 1)));
    for (int64_t j = 0; j < rh; ++j) {
      T* row = d + j * w;
      line(row, 1, snh, rw - snh, cash, out.data(), 1);
      std::copy(out.begin(), out.begin() + rw, row);
    }
    if (rw == 0) continue;
    line(d, w, snv, rh - snv, casv, out.data(), rw);
    for (int64_t j = 0; j < rh; ++j)
      std::copy(out.begin() + j * rw, out.begin() + (j + 1) * rw, d + j * w);
  }
}

// ----------------------------------------------------------------- tiles

struct Tile {
  std::vector<uint8_t> data;
  int parts = 0, nparts = 0;
};

// The tile-component's resolutions, bands, precincts and code-blocks
// (B.5-B.7) as OpenJPEG lays them out.
void init_tilecomp(TileComp& tc, const CompParams& cp, int64_t tx0,
                   int64_t ty0, int64_t tx1, int64_t ty1) {
  tc.x0 = tx0;
  tc.y0 = ty0;
  tc.x1 = tx1;
  tc.y1 = ty1;
  tc.res.assign(static_cast<size_t>(cp.numres), Resolution{});
  int band_index = 0;
  for (int r = 0; r < cp.numres; ++r) {
    Resolution& res = tc.res[static_cast<size_t>(r)];
    const int level = cp.numres - 1 - r;
    res.x0 = ceil_pow2(tx0, level);
    res.y0 = ceil_pow2(ty0, level);
    res.x1 = ceil_pow2(tx1, level);
    res.y1 = ceil_pow2(ty1, level);
    res.pdx = cp.prcw[r];
    res.pdy = cp.prch[r];
    const int64_t px0 = floor_pow2(res.x0, res.pdx) << res.pdx;
    const int64_t py0 = floor_pow2(res.y0, res.pdy) << res.pdy;
    const int64_t px1 = ceil_pow2(res.x1, res.pdx) << res.pdx;
    const int64_t py1 = ceil_pow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> res.pdy;
    if (res.pw * res.ph > (int64_t{1} << 24)) fail(kLayout);
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceil_pow2(px0, 1);
      cbgy0 = ceil_pow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    const int cbw = cp.cblkw < cbgw ? cp.cblkw : cbgw;
    const int cbh = cp.cblkh < cbgh ? cp.cblkh : cbgh;
    const int nbands = r == 0 ? 1 : 3;
    res.bands.resize(static_cast<size_t>(nbands));
    for (int b = 0; b < nbands; ++b, ++band_index) {
      Band& band = res.bands[static_cast<size_t>(b)];
      if (r == 0) {
        band.bandno = 0;
        band.x0 = ceil_pow2(tx0, level);
        band.y0 = ceil_pow2(ty0, level);
        band.x1 = ceil_pow2(tx1, level);
        band.y1 = ceil_pow2(ty1, level);
      } else {
        band.bandno = b + 1;
        const int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
        band.x0 = ceil_pow2(tx0 - (xb << level), level + 1);
        band.y0 = ceil_pow2(ty0 - (yb << level), level + 1);
        band.x1 = ceil_pow2(tx1 - (xb << level), level + 1);
        band.y1 = ceil_pow2(ty1 - (yb << level), level + 1);
      }
      const int expn = cp.expn[band_index], mant = cp.mant[band_index];
      // no band gain on the 9/7 path (OpenJPEG's BUG_WEIRD_TWO_INVK)
      const int gain = cp.qmfbid == 0 ? 0
                       : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
      band.stepsize = static_cast<float>(
          (1.0 + mant / 2048.0) * std::pow(2.0, cp.prec + gain - expn));
      band.numbps = expn + cp.guard - 1;
      if (band.empty()) continue;
      band.precincts.resize(static_cast<size_t>(res.pw * res.ph));
      for (int64_t p = 0; p < res.pw * res.ph; ++p) {
        Precinct& prc = band.precincts[static_cast<size_t>(p)];
        const int64_t gx0 = cbgx0 + (p % res.pw) * (int64_t{1} << cbgw);
        const int64_t gy0 = cbgy0 + (p / res.pw) * (int64_t{1} << cbgh);
        const int64_t gx1 = gx0 + (int64_t{1} << cbgw);
        const int64_t gy1 = gy0 + (int64_t{1} << cbgh);
        const int64_t x0 = gx0 > band.x0 ? gx0 : band.x0;
        const int64_t y0 = gy0 > band.y0 ? gy0 : band.y0;
        const int64_t x1 = gx1 < band.x1 ? gx1 : band.x1;
        const int64_t y1 = gy1 < band.y1 ? gy1 : band.y1;
        const int64_t bx0 = floor_pow2(x0, cbw) << cbw;
        const int64_t by0 = floor_pow2(y0, cbh) << cbh;
        const int64_t bx1 = ceil_pow2(x1, cbw) << cbw;
        const int64_t by1 = ceil_pow2(y1, cbh) << cbh;
        prc.cw = (bx1 - bx0) >> cbw;
        prc.ch = (by1 - by0) >> cbh;
        if (prc.cw < 0 || prc.ch < 0) fail(kLayout);
        if (prc.cw * prc.ch > (int64_t{1} << 24)) fail(kLayout);
        prc.blocks.resize(static_cast<size_t>(prc.cw * prc.ch));
        for (int64_t k = 0; k < prc.cw * prc.ch; ++k) {
          Codeblock& cb = prc.blocks[static_cast<size_t>(k)];
          const int64_t cx0 = bx0 + (k % prc.cw) * (int64_t{1} << cbw);
          const int64_t cy0 = by0 + (k / prc.cw) * (int64_t{1} << cbh);
          cb.x0 = cx0 > x0 ? cx0 : x0;
          cb.y0 = cy0 > y0 ? cy0 : y0;
          cb.x1 = cx0 + (int64_t{1} << cbw) < x1 ? cx0 + (int64_t{1} << cbw)
                                                 : x1;
          cb.y1 = cy0 + (int64_t{1} << cbh) < y1 ? cy0 + (int64_t{1} << cbh)
                                                 : y1;
        }
        prc.incl.build(prc.cw, prc.ch);
        prc.imsb.build(prc.cw, prc.ch);
      }
    }
  }
}

struct PacketId {
  int layer, res, comp;
  int64_t prec;
};

// OpenJPEG's packet iterator (pi.c) for one tile without POC: the order
// the packets of the five progressions come in.
std::vector<PacketId> packet_order(const std::vector<TileComp>& tcs,
                                   const std::vector<CompParams>& cps,
                                   int layers, int prog, int64_t tx0,
                                   int64_t ty0, int64_t tx1, int64_t ty1) {
  const int nc = static_cast<int>(tcs.size());
  int maxres = 0;
  int64_t maxprec = 0;
  for (int c = 0; c < nc; ++c) {
    if (cps[c].numres > maxres) maxres = cps[c].numres;
    for (const Resolution& r : tcs[c].res)
      if (r.pw * r.ph > maxprec) maxprec = r.pw * r.ph;
  }
  const int64_t total = int64_t{layers} * maxres * nc * maxprec;
  if (total > (int64_t{1} << 26)) fail(kLayout);
  std::vector<uint8_t> seen(static_cast<size_t>(total), 0);
  std::vector<PacketId> order;
  auto emit = [&](int l, int r, int c, int64_t p) {
    const int64_t idx = ((int64_t{l} * maxres + r) * nc + c) * maxprec + p;
    if (p >= maxprec || seen[static_cast<size_t>(idx)]) return;
    seen[static_cast<size_t>(idx)] = 1;
    order.push_back({l, r, c, p});
  };
  // the precinct of resolution r of component c at reference-grid point
  // (x, y), or -1 where none starts there (B.12.1.3)
  auto prec_at = [&](int c, int r, int64_t x, int64_t y) -> int64_t {
    if (r >= cps[c].numres) return -1;
    const Resolution& res = tcs[c].res[static_cast<size_t>(r)];
    const int level = cps[c].numres - 1 - r;
    const int64_t trx0 = ceil_div(tx0, int64_t{1} << level);
    const int64_t try0 = ceil_div(ty0, int64_t{1} << level);
    const int64_t trx1 = ceil_div(tx1, int64_t{1} << level);
    const int64_t try1 = ceil_div(ty1, int64_t{1} << level);
    const int rpx = res.pdx + level, rpy = res.pdy + level;
    if (!(y % (int64_t{1} << rpy) == 0
          || (y == ty0 && ((try0 << level) % (int64_t{1} << rpy)) != 0)))
      return -1;
    if (!(x % (int64_t{1} << rpx) == 0
          || (x == tx0 && ((trx0 << level) % (int64_t{1} << rpx)) != 0)))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    const int64_t prci = floor_pow2(ceil_div(x, int64_t{1} << level),
                                    res.pdx) - floor_pow2(trx0, res.pdx);
    const int64_t prcj = floor_pow2(ceil_div(y, int64_t{1} << level),
                                    res.pdy) - floor_pow2(try0, res.pdy);
    return prci + prcj * res.pw;
  };
  auto steps = [&](int c0, int c1, int64_t* dx, int64_t* dy) {
    *dx = *dy = 0;
    for (int c = c0; c < c1; ++c)
      for (int r = 0; r < cps[c].numres; ++r) {
        const int level = cps[c].numres - 1 - r;
        const Resolution& res = tcs[c].res[static_cast<size_t>(r)];
        if (res.pdx + level < 32) {
          const int64_t v = int64_t{1} << (res.pdx + level);
          *dx = *dx == 0 ? v : (v < *dx ? v : *dx);
        }
        if (res.pdy + level < 32) {
          const int64_t v = int64_t{1} << (res.pdy + level);
          *dy = *dy == 0 ? v : (v < *dy ? v : *dy);
        }
      }
    if (*dx == 0 || *dy == 0) fail(kLayout);
  };
  auto layers_at = [&](int r, int c, int64_t p) {
    if (p < 0) return;
    for (int l = 0; l < layers; ++l) emit(l, r, c, p);
  };
  switch (prog) {
    case 0:  // LRCP
      for (int l = 0; l < layers; ++l)
        for (int r = 0; r < maxres; ++r)
          for (int c = 0; c < nc; ++c) {
            if (r >= cps[c].numres) continue;
            const Resolution& res = tcs[c].res[static_cast<size_t>(r)];
            for (int64_t p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
          }
      break;
    case 1:  // RLCP
      for (int r = 0; r < maxres; ++r)
        for (int l = 0; l < layers; ++l)
          for (int c = 0; c < nc; ++c) {
            if (r >= cps[c].numres) continue;
            const Resolution& res = tcs[c].res[static_cast<size_t>(r)];
            for (int64_t p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
          }
      break;
    case 2: {  // RPCL
      int64_t dx, dy;
      steps(0, nc, &dx, &dy);
      for (int r = 0; r < maxres; ++r)
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = 0; c < nc; ++c) layers_at(r, c, prec_at(c, r, x, y));
      break;
    }
    case 3: {  // PCRL
      int64_t dx, dy;
      steps(0, nc, &dx, &dy);
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
        for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
          for (int c = 0; c < nc; ++c)
            for (int r = 0; r < cps[c].numres; ++r)
              layers_at(r, c, prec_at(c, r, x, y));
      break;
    }
    case 4:  // CPRL
      for (int c = 0; c < nc; ++c) {
        int64_t dx, dy;
        steps(c, c + 1, &dx, &dy);
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int r = 0; r < cps[c].numres; ++r)
              layers_at(r, c, prec_at(c, r, x, y));
      }
      break;
    default:
      fail(kLayout);
  }
  return order;
}

// One tile: packets, code-blocks, dequantisation, inverse transforms, the
// component transform and the DC shift, into the image planes `img`.
void decode_tile(const Tile& tile, const std::vector<CompParams>& cps,
                 int layers, int prog, int mct, int64_t tx0, int64_t ty0,
                 int64_t tx1, int64_t ty1, int64_t W,
                 std::vector<std::vector<int32_t>>& img, T1& t1) {
  const int nc = static_cast<int>(cps.size());
  std::vector<TileComp> tcs(static_cast<size_t>(nc));
  for (int c = 0; c < nc; ++c)
    init_tilecomp(tcs[c], cps[c], tx0, ty0, tx1, ty1);
  const std::vector<PacketId> order =
      packet_order(tcs, cps, layers, prog, tx0, ty0, tx1, ty1);
  int64_t pos = 0;
  const int64_t size = static_cast<int64_t>(tile.data.size());
  for (const PacketId& id : order)
    read_packet(tcs[id.comp].res[static_cast<size_t>(id.res)], id.layer,
                id.prec, tile.data.data(), size, &pos);

  const int64_t tw = tx1 - tx0, th = ty1 - ty0;
  std::vector<uint8_t> buf;
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[c];
    const CompParams& cp = cps[c];
    const bool rev = cp.qmfbid == 1;
    if (rev)
      tc.idata.assign(static_cast<size_t>(tw * th), 0);
    else
      tc.fdata.assign(static_cast<size_t>(tw * th), 0.0f);
    for (size_t r = 0; r < tc.res.size(); ++r) {
      for (Band& band : tc.res[r].bands) {
        if (band.empty()) continue;
        int64_t ox = 0, oy = 0;
        if (band.bandno & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float step = 0.5f * band.stepsize;
        for (Precinct& prc : band.precincts)
          for (Codeblock& cb : prc.blocks) {
            if (!cb.included || cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            if (cb.numbps < 0 || cb.numbps >= 31) fail(kCodeblock);
            if (cb.passes > 3 * cb.numbps - 2) fail(kCodeblock);
            buf.assign(cb.data.begin(), cb.data.end());
            buf.push_back(0xff);
            buf.push_back(0xff);
            t1.decode(cb, band.bandno, buf.data());
            const int64_t x = cb.x0 - band.x0 + ox, y = cb.y0 - band.y0 + oy;
            const int64_t w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
            for (int64_t j = 0; j < h; ++j) {
              const int32_t* src = t1.data.data() + j * w;
              if (rev) {
                int32_t* dst = tc.idata.data() + (y + j) * tw + x;
                for (int64_t i = 0; i < w; ++i) dst[i] = src[i] / 2;
              } else {
                float* dst = tc.fdata.data() + (y + j) * tw + x;
                for (int64_t i = 0; i < w; ++i)
                  dst[i] = static_cast<float>(src[i]) * step;
              }
            }
          }
      }
    }
    if (rev)
      idwt_2d(tc, tc.idata.data(), idwt53);
    else
      idwt_2d(tc, tc.fdata.data(), idwt97);
  }

  if (mct) {
    if (nc < 3) fail(kLayout);
    const int64_t n = tw * th;
    if (cps[0].qmfbid == 1) {
      int32_t* c0 = tcs[0].idata.data();
      int32_t* c1 = tcs[1].idata.data();
      int32_t* c2 = tcs[2].idata.data();
      for (int64_t i = 0; i < n; ++i) {
        const int64_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = wrap(y - ((u + v) >> 2));
        c0[i] = wrap(v + g);
        c1[i] = g;
        c2[i] = wrap(u + g);
      }
    } else {
      float* c0 = tcs[0].fdata.data();
      float* c1 = tcs[1].fdata.data();
      float* c2 = tcs[2].fdata.data();
      for (int64_t i = 0; i < n; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        const float g = y - (u * 0.34413f) - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }

  for (int c = 0; c < nc; ++c) {
    const CompParams& cp = cps[c];
    const int32_t lo = 0, hi = static_cast<int32_t>((1u << cp.prec) - 1);
    const int64_t shift = int64_t{1} << (cp.prec - 1);
    int32_t* plane = img[static_cast<size_t>(c)].data();
    for (int64_t j = 0; j < th; ++j) {
      int32_t* dst = plane + (ty0 + j) * W + tx0;
      if (cp.qmfbid == 1) {
        const int32_t* src = tcs[c].idata.data() + j * tw;
        for (int64_t i = 0; i < tw; ++i) {
          const int32_t v = wrap(src[i] + shift);
          dst[i] = v < lo ? lo : v > hi ? hi : v;
        }
      } else {
        const float* src = tcs[c].fdata.data() + j * tw;
        for (int64_t i = 0; i < tw; ++i) {
          const float f = src[i];
          int32_t v;
          if (f > static_cast<float>(INT32_MAX)) {
            v = hi;
          } else if (f < static_cast<float>(INT32_MIN)) {
            v = lo;
          } else if (f != f) {
            v = lo;
          } else {
            const int64_t q = std::lrintf(f) + shift;
            v = q < lo ? lo : q > hi ? hi : static_cast<int32_t>(q);
          }
          dst[i] = v;
        }
      }
    }
  }
}

uint32_t be16(const uint8_t* p) { return (uint32_t{p[0]} << 8) | p[1]; }
uint32_t be32(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16)
         | (uint32_t{p[2]} << 8) | p[3];
}

// The tile-parts from `at` (the first SOT) to EOC, each tile's bodies in
// order.
std::vector<Tile> read_tiles(const uint8_t* cs, int64_t size, int64_t at,
                             int64_t ntiles) {
  std::vector<Tile> tiles(static_cast<size_t>(ntiles));
  for (;;) {
    if (at + 2 > size) fail(kShort);
    const uint32_t marker = be16(cs + at);
    if (marker == 0xffd9) break;  // EOC
    if (marker != 0xff90) fail(kCorrupt);
    if (at + 12 > size) fail(kShort);
    if (be16(cs + at + 2) != 10) fail(kMarker);
    const uint32_t isot = be16(cs + at + 4);
    const uint32_t psot = be32(cs + at + 6);
    const int tpsot = cs[at + 10], tnsot = cs[at + 11];
    if (isot >= ntiles) fail(kTiles);
    Tile& tile = tiles[isot];
    if (tpsot != tile.parts) fail(kTiles);
    if (tile.nparts != 0 && tnsot != 0 && tnsot != tile.nparts)
      fail(kTiles);
    if (tnsot != 0) tile.nparts = tnsot;
    if (tile.nparts != 0 && tpsot >= tile.nparts) fail(kTiles);
    ++tile.parts;
    int64_t end;
    if (psot == 0) {  // to the EOC
      if (size < at + 14 || be16(cs + size - 2) != 0xffd9) fail(kShort);
      end = size - 2;
    } else {
      if (psot < 14 || static_cast<int64_t>(psot) > size - at) fail(kShort);
      end = at + psot;
    }
    int64_t p = at + 12;
    for (;;) {  // the tile-part header: PLT and COM skipped
      if (p + 2 > end) fail(kShort);
      const uint32_t m = be16(cs + p);
      if (m == 0xff93) {  // SOD
        p += 2;
        break;
      }
      if (m != 0xff58 && m != 0xff64) fail(kMarker);
      if (p + 4 > end) fail(kShort);
      const uint32_t len = be16(cs + p + 2);
      if (len < 2 || p + 2 + int64_t{len} > end) fail(kShort);
      p += 2 + len;
    }
    tile.data.insert(tile.data.end(), cs + p, cs + end);
    at = end;
  }
  for (const Tile& t : tiles)
    if (t.parts == 0 || (t.nparts != 0 && t.parts != t.nparts))
      fail(kTiles);
  return tiles;
}

void decode(const uint8_t* cs, int64_t size, int64_t sot_at,
            const int64_t* params, int want, int layout, uint8_t* out) {
  const int64_t W = params[kWidth], H = params[kHeight];
  const int nc = static_cast<int>(params[kComps]);
  const int64_t tw = params[kTileW], th = params[kTileH];
  const int layers = static_cast<int>(params[kLayers]);
  const int prog = static_cast<int>(params[kProg]);
  const int mct = static_cast<int>(params[kMct]);
  const int shift = static_cast<int>(params[kShift]);
  if (W <= 0 || H <= 0 || nc < 1 || nc > 4 || tw <= 0 || th <= 0
      || layers < 1 || shift < 0 || shift > 8 || (want != 1 && want != 3)
      || sot_at < 0 || sot_at > size)
    fail(kLayout);
  std::vector<CompParams> cps(static_cast<size_t>(nc));
  for (int c = 0; c < nc; ++c) {
    const int64_t* p = params + kHead + c * kCompStride;
    CompParams& cp = cps[c];
    cp.prec = static_cast<int>(p[kPrec]);
    cp.numres = static_cast<int>(p[kNumRes]);
    cp.cblkw = static_cast<int>(p[kCblkW]);
    cp.cblkh = static_cast<int>(p[kCblkH]);
    cp.qmfbid = static_cast<int>(p[kQmfb]);
    cp.guard = static_cast<int>(p[kGuard]);
    if (cp.prec < 1 || cp.prec > 16 || cp.numres < 1 || cp.numres > 32
        || cp.cblkw < 2 || cp.cblkh < 2 || cp.cblkw + cp.cblkh > 12
        || p[kCblkSty] != 0 || (cp.qmfbid != 0 && cp.qmfbid != 1))
      fail(kLayout);
    for (int r = 0; r < kMaxRes; ++r) {
      cp.prcw[r] = static_cast<int>(p[kPrcW + r]);
      cp.prch[r] = static_cast<int>(p[kPrcH + r]);
      if (r < cp.numres
          && (cp.prcw[r] < (r ? 1 : 0) || cp.prcw[r] > 15
              || cp.prch[r] < (r ? 1 : 0) || cp.prch[r] > 15))
        fail(kLayout);
    }
    for (int b = 0; b < kMaxBands; ++b) {
      cp.expn[b] = static_cast<int>(p[kExpn + b]);
      cp.mant[b] = static_cast<int>(p[kMant + b]);
    }
  }
  if (mct && (nc < 3 || cps[0].qmfbid != cps[1].qmfbid
              || cps[0].qmfbid != cps[2].qmfbid))
    fail(kLayout);
  const int64_t ntx = ceil_div(W, tw), nty = ceil_div(H, th);
  if (ntx * nty > 65535) fail(kLayout);
  std::vector<Tile> tiles = read_tiles(cs, size, sot_at, ntx * nty);
  std::vector<std::vector<int32_t>> img(
      static_cast<size_t>(nc),
      std::vector<int32_t>(static_cast<size_t>(W * H)));
  T1 t1;
  for (int64_t t = 0; t < ntx * nty; ++t) {
    const int64_t p = t % ntx, q = t / ntx;
    const int64_t x0 = p * tw, y0 = q * th;
    const int64_t x1 = x0 + tw < W ? x0 + tw : W;
    const int64_t y1 = y0 + th < H ? y0 + th : H;
    decode_tile(tiles[static_cast<size_t>(t)], cps, layers, prog, mct, x0,
                y0, x1, y1, W, img, t1);
    std::vector<uint8_t>().swap(tiles[static_cast<size_t>(t)].data);
  }
  // cv::imread's planes: layout 0 component 0 (gray, or replicated for
  // a colour read of a gray image), 1 components 2, 1, 0 as B, G, R,
  // 2 BGR2GRAY of those
  const int64_t n = W * H;
  auto px = [&](int c, int64_t i) {
    return static_cast<uint8_t>(img[static_cast<size_t>(c)][i] >> shift);
  };
  if (layout == 0) {
    for (int k = 0; k < want; ++k)
      for (int64_t i = 0; i < n; ++i) out[k * n + i] = px(0, i);
  } else if (layout == 1 && want == 3 && nc >= 3) {
    for (int k = 0; k < 3; ++k)
      for (int64_t i = 0; i < n; ++i) out[k * n + i] = px(2 - k, i);
  } else if (layout == 2 && want == 1 && nc >= 3) {
    for (int64_t i = 0; i < n; ++i)
      out[i] = cvt_gray(px(2, i), px(1, i), px(0, i));
  } else {
    fail(kLayout);
  }
}

}  // namespace

// See `decode`: the codestream `cs` (`size` bytes, its first SOT at
// `sot_at`), the parameters of `utils/io.py::jp2_header`, `want` 1 or 3
// planes in `layout` 0 (component 0), 1 (B, G, R of components 2, 1, 0)
// or 2 (BGR2GRAY of those) into `out`. Returns 0 or a negative code
// (`of_jp2_strerror`).
extern "C" int of_jp2_decode(const uint8_t* cs, int64_t size, int64_t sot_at,
                             const int64_t* params, int want, int layout,
                             uint8_t* out) {
  try {
    decode(cs, size, sot_at, params, want, layout, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (const std::length_error&) {
    return kNoMemory;
  }
}

extern "C" const char* of_jp2_strerror(int code) {
  switch (code) {
    case kShort:
      return "JPEG 2000 codestream cut short (a tile-part, packet header or "
             "code-block past the end of its data)";
    case kLayout:
      return "JPEG 2000 coding parameters the decoder does not take";
    case kMarker:
      return "JPEG 2000 tile-part header marker other than PLT or COM is "
             "not supported (tile-specific COD, COC, QCD, QCC, POC, PPT, "
             "RGN)";
    case kPacket:
      return "corrupt JPEG 2000 packet header";
    case kCodeblock:
      return "corrupt JPEG 2000 code-block (above 30 bit-planes, or more "
             "coding passes than its bit-planes hold)";
    case kNoMemory:
      return "out of memory";
    case kTiles:
      return "JPEG 2000 tile-parts missing or out of order (cut short)";
    case kCorrupt:
      return "corrupt JPEG 2000 codestream (a marker other than SOT or EOC "
             "after a tile-part)";
    default:
      return "JPEG 2000 decoder error";
  }
}
