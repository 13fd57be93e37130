// Host-side frame decoding for the serving pipeline and `load_image`: the
// pixel work of PNG, PNM (P1-P6) and BMP frames, to the (C, H, W) uint8
// layout the port's entry points take, with the values cv::imread gives
// (C = 1 IMREAD_GRAYSCALE, C = 3 IMREAD_COLOR, B, G, R planes).
//
// Replaces: of_dis_tpu/native/io_native.cpp::decode_png (the unfilter loop,
// `paeth`), `decode_pnm` and `to_chw`, reached through of_dis_tpu/native/
// io.py::decode_batch, and the cv2.imread fallback of of_dis_tpu/utils/
// io.py::load_image and of_dis_tpu/pipeline.py::_decode_batch for every
// other PNG, PNM and BMP. Plain C entries, no CUDA and no zlib: Python
// parses the headers and chunks (`utils/io.py`) and inflates with
// `zlib.decompress`, and both release the interpreter lock on large
// buffers, as a ctypes call does, so a thread pool over frames runs these
// entries side by side.
//
// Which rules: OpenCV 5.0's readers (grfmt_png.cpp over libpng 1.6,
// grfmt_pxm.cpp, grfmt_bmp.cpp), held to cv2.imread pixel for pixel by
// tests/test_torch_image_formats.py. A PNG read as gray goes through
// libpng's png_set_rgb_to_gray(0.299, 0.587), not OpenCV's BGR2GRAY; PNM
// and BMP through OpenCV's fixed-point BGR2GRAY.
//
// What bounds it: the Average and Paeth filters depend on the pixel to the
// left, so a row is one dependent chain of bytes; the loops below are
// specialised by bytes per pixel so that the chain carries no branch on
// the filter type or the channel count.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "gray.h"

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- CRC-32

// zlib's CRC-32 (the reflected polynomial 0xEDB88320) of a PNG chunk,
// which libpng checks on every chunk it reads, IDAT included. On x86-64
// with PCLMULQDQ, 64-byte blocks are folded by carry-less multiplication
// (Intel's "Fast CRC Computation for Generic Polynomials Using PCLMULQDQ";
// the constants of Linux's crc32-pclmul_asm.S), several times zlib's
// table-driven rate on a core; elsewhere, and for the tail, eight tables.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const CrcTables kCrc;

// The running (not inverted) CRC `c` over n bytes, eight at a time on a
// little-endian host.
uint32_t crc_tables(uint32_t c, const uint8_t* p, size_t n) {
  const auto& t = kCrc.t;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  for (; n >= 8; p += 8, n -= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
        ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
        ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
#endif
  for (; n; ++p, --n) c = (c >> 8) ^ t[0][(c ^ *p) & 0xFF];
  return c;
}

#if defined(__x86_64__)
__attribute__((target("pclmul,sse4.1"))) inline __m128i crc_fold(
    __m128i x, __m128i k, __m128i next) {
  return _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x00),
                                     _mm_clmulepi64_si128(x, k, 0x11)),
                       next);
}

// The running CRC `c` over n bytes, n >= 64 and a multiple of 16.
__attribute__((target("pclmul,sse4.1"))) uint32_t crc_pclmul(
    uint32_t c, const uint8_t* p, size_t n) {
  const __m128i r2r1 = _mm_set_epi64x(0x1c6e41596, 0x154442bd4);
  const __m128i r4r3 = _mm_set_epi64x(0x0ccaa009e, 0x1751997d0);
  const __m128i r5 = _mm_set_epi64x(0, 0x163cd6124);
  const __m128i poly = _mm_set_epi64x(0x1f7011641, 0x1db710641);
  const __m128i mask32 = _mm_set_epi32(0, 0, 0, -1);
  auto at = [p](size_t k) {
    return _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + k));
  };
  __m128i x1 = _mm_xor_si128(at(0), _mm_cvtsi32_si128(static_cast<int>(c)));
  __m128i x2 = at(16), x3 = at(32), x4 = at(48);
  size_t k = 64;
  for (; k + 64 <= n; k += 64) {  // four lanes, 64 bytes a step
    x1 = crc_fold(x1, r2r1, at(k));
    x2 = crc_fold(x2, r2r1, at(k + 16));
    x3 = crc_fold(x3, r2r1, at(k + 32));
    x4 = crc_fold(x4, r2r1, at(k + 48));
  }
  x1 = crc_fold(x1, r4r3, x2);  // the lanes into one
  x1 = crc_fold(x1, r4r3, x3);
  x1 = crc_fold(x1, r4r3, x4);
  for (; k < n; k += 16) x1 = crc_fold(x1, r4r3, at(k));
  // 128 -> 64 bits, then 64 -> 32, then Barrett's reduction
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8),
                     _mm_clmulepi64_si128(r4r3, x1, 0x01));
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 4),
                     _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), r5,
                                          0x00));
  __m128i t = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x10);
  t = _mm_clmulepi64_si128(_mm_and_si128(t, mask32), poly, 0x00);
  return static_cast<uint32_t>(_mm_extract_epi32(_mm_xor_si128(x1, t), 1));
}

bool have_pclmul() {
  static const bool yes = [] {
    __builtin_cpu_init();
    return __builtin_cpu_supports("pclmul")
           && __builtin_cpu_supports("sse4.1");
  }();
  return yes;
}
#endif

// zlib.crc32(p[0:n], crc).
uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc) {
  uint32_t c = ~crc;
#if defined(__x86_64__)
  if (n >= 64 && have_pclmul()) {
    const size_t m = n & ~static_cast<size_t>(15);
    c = crc_pclmul(c, p, m);
    p += m;
    n -= m;
  }
#endif
  return ~crc_tables(c, p, n);
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16)
         | (uint32_t{p[2]} << 8) | p[3];
}

// ------------------------------------------------------------ PNG filters

// The Paeth predictor without branches: its choice follows the data, so a
// branch on it mispredicts on most bytes of a natural image; masks select.
inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c);          // |p - a| with p = a + b - c
  int pb = std::abs(a - c);          // |p - b|
  int pc = std::abs(a + b - 2 * c);  // |p - c|
  int take_b = -static_cast<int>(pb <= pc);
  int bc = c ^ ((b ^ c) & take_b);
  int take_a = -static_cast<int>((pa <= pb) & (pa <= pc));
  return bc ^ ((a ^ bc) & take_a);
}

// One row of `stride` bytes from its filtered bytes `src`, the row above
// `up` (zeros for the first row of a pass) into `dst`. BPP: bytes per
// complete pixel, at least 1 (PNG spec section 9); stride >= BPP, as a
// row of at least one pixel has. No branch on the stride in the set-up
// of Average and Paeth: with one, the compiler kept their left pixels in
// memory, a store and a load in the chain of every byte.
template <int BPP>
bool unfilter_row(int filter, const uint8_t* src, const uint8_t* up,
                  uint8_t* dst, int64_t stride) {
  switch (filter) {
    case 0:
      std::memcpy(dst, src, static_cast<size_t>(stride));
      return true;
    case 1:
      for (int64_t x = 0; x < BPP && x < stride; ++x) dst[x] = src[x];
      for (int64_t x = BPP; x < stride; ++x)
        dst[x] = static_cast<uint8_t>(src[x] + dst[x - BPP]);
      return true;
    case 2:
      for (int64_t x = 0; x < stride; ++x)
        dst[x] = static_cast<uint8_t>(src[x] + up[x]);
      return true;
    case 3: {
      // the left pixel rides in registers, not through a store and a load
      int left[BPP];
      for (int k = 0; k < BPP; ++k) {
        left[k] = static_cast<uint8_t>(src[k] + (up[k] >> 1));
        dst[k] = static_cast<uint8_t>(left[k]);
      }
      for (int64_t x = BPP; x < stride; x += BPP) {
        for (int k = 0; k < BPP; ++k) {
          left[k] = static_cast<uint8_t>(src[x + k]
                                         + ((left[k] + up[x + k]) >> 1));
          dst[x + k] = static_cast<uint8_t>(left[k]);
        }
      }
      return true;
    }
    case 4: {
      int left[BPP], upleft[BPP];
      for (int k = 0; k < BPP; ++k) {  // paeth(0, b, 0) = b
        left[k] = static_cast<uint8_t>(src[k] + up[k]);
        upleft[k] = up[k];
        dst[k] = static_cast<uint8_t>(left[k]);
      }
      for (int64_t x = BPP; x < stride; x += BPP) {
        for (int k = 0; k < BPP; ++k) {
          int b = up[x + k];
          left[k] = static_cast<uint8_t>(src[x + k]
                                         + paeth(left[k], b, upleft[k]));
          upleft[k] = b;
          dst[x + k] = static_cast<uint8_t>(left[k]);
        }
      }
      return true;
    }
    default:
      return false;
  }
}

// The rows of a non-interlaced 8-bit gray PNG unfiltered straight into
// `out`: 0, or 1 + the row of an unknown filter type. A function of its
// own: inlined into `of_png_decode`, its loop compiled a few percent
// slower.
__attribute__((noinline)) int64_t unfilter_plane(
    const uint8_t* src, int64_t height, int64_t width, const uint8_t* zeros,
    uint8_t* out) {
  const uint8_t* up = zeros;
  for (int64_t y = 0; y < height; ++y, src += width + 1) {
    uint8_t* dst = out + y * width;
    if (!unfilter_row<1>(src[0], src + 1, up, dst, width)) return y + 1;
    up = dst;
  }
  return 0;
}

bool unfilter_row_bpp(int bpp, int filter, const uint8_t* src,
                      const uint8_t* up, uint8_t* dst, int64_t stride) {
  switch (bpp) {
    case 1: return unfilter_row<1>(filter, src, up, dst, stride);
    case 2: return unfilter_row<2>(filter, src, up, dst, stride);
    case 3: return unfilter_row<3>(filter, src, up, dst, stride);
    case 4: return unfilter_row<4>(filter, src, up, dst, stride);
    case 6: return unfilter_row<6>(filter, src, up, dst, stride);
    default: return unfilter_row<8>(filter, src, up, dst, stride);
  }
}

// ------------------------------------------------- libpng's rgb_to_gray

// libpng's fixed-point gamma arithmetic (units of 1e-5, png.c), in double
// as libpng's floating-point build computes it.
constexpr int kFp1 = 100000;

bool gamma_significant(int64_t g) {
  return g < kFp1 - 5000 || g > kFp1 + 5000;
}

int64_t reciprocal(int64_t a) {  // floor(1e10 / a + .5), 0 on overflow
  double r = std::floor(1e10 / static_cast<double>(a) + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int64_t>(r)
                                                 : 0;
}

int64_t product(int64_t a, int64_t b) {  // floor(a * 1e-5 * b + .5)
  double r = static_cast<double>(a) * 1e-5;
  r *= static_cast<double>(b);
  r = std::floor(r + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int64_t>(r)
                                                 : 0;
}

// 8-bit table: v -> floor(255 (v/255)^(g 1e-5) + .5), the identity where
// the exponent is within 0.05 of 1.
void table8(int64_t g, int* t) {
  for (int v = 0; v < 256; ++v) {
    t[v] = v;
    if (gamma_significant(g) && v > 0 && v < 255)
      t[v] = static_cast<int>(std::floor(
          255. * std::pow(v / 255., static_cast<double>(g) * 1e-5) + .5));
  }
}

// 16-bit table over v >> shift (1 << (16 - shift) entries):
// floor(65535 ((v >> shift) / max)^(g 1e-5) + .5), else the value scaled
// to 16 bits with rounding.
std::vector<int> table16(int shift, int64_t g) {
  const int max = (1 << (16 - shift)) - 1;
  const double fmax = 1.0 / max;
  std::vector<int> t(max + 1);
  for (int i = 0; i <= max; ++i) {
    if (gamma_significant(g))
      t[i] = static_cast<int>(std::floor(
          65535. * std::pow(i * fmax, static_cast<double>(g) * 1e-5) + .5));
    else
      t[i] = static_cast<int>(
          (static_cast<uint32_t>(i) * 65535u + (1u << (15 - shift))) / max);
  }
  return t;
}

// libpng's table for a 16-bit sample headed for 8 bits (png_set_strip_16
// with gamma on): each 8-bit output i covers the inputs below the boundary
// of i + 0.5 through gamma g; the entry is the 16-bit value i * 257.
std::vector<int> table16to8(int shift, int64_t g) {
  const uint32_t num = 1u << (8 - shift);
  const uint32_t max = (1u << (16 - shift)) - 1u;
  std::vector<int> t(num << 8, 65535);
  uint32_t last = 0;
  for (uint32_t i = 0; i < 255; ++i) {
    const uint32_t out = i * 257u;
    uint32_t v = out + 128u, bound = v;
    if (v > 0 && v < 65535)
      bound = static_cast<uint32_t>(std::floor(
          65535. * std::pow(v / 65535., static_cast<double>(g) * 1e-5)
          + .5));
    bound = (bound * max + 32768u) / 65535u + 1u;
    for (; last < bound && last < (num << 8); ++last)
      t[last] = static_cast<int>(out);
  }
  return t;
}

// libpng 1.6's png_set_rgb_to_gray(png, 1, 0.299, 0.587), as OpenCV asks
// for it on a colour PNG read as gray: coefficients 9797, 19234, 3737 of
// 32768, applied after alpha is stripped and a palette expanded, and
// before 16-bit samples lose their low byte. Fitted rule, held to cv2 with
// 0 pixels differing:
//  - no gamma (no sRGB / gAMA chunk, or a gAMA whose exponent and inverse
//    both lie within 0.05 of 1): 8-bit (9797 R + 19234 G + 3737 B) >> 15,
//    truncated; 16-bit ((9797 R + 19234 G + 3737 B + 16384) >> 15) >> 8;
//  - gamma g (sRGB: 45455): 8-bit from1[(9797 to1[R] + 19234 to1[G] +
//    3737 to1[B] + 16384) >> 15], to1 = table8(1/g), from1 = table8(g);
//    16-bit the same on tables over v >> shift (shift = 16 - sBIT, at
//    least 5, at most 8) then >> 8; a pixel with R = G = B keeps its
//    value (8-bit), or is rounded to 8 bits by table16to8 (16-bit).
struct GrayRule {
  bool gamma = false;
  int to1[256], from1[256];
  int shift = 0;
  std::vector<int> to1_16, from1_16, same16;

  GrayRule(int64_t file_gamma, int bit_depth, int sig_bit) {
    if (file_gamma <= 0) return;
    const int64_t screen = reciprocal(file_gamma);
    gamma = gamma_significant(file_gamma) || gamma_significant(screen);
    if (!gamma) return;
    table8(screen, to1);
    table8(reciprocal(screen), from1);
    if (bit_depth == 16) {
      shift = (sig_bit > 0 && sig_bit < 16) ? 16 - sig_bit : 0;
      if (shift < 5) shift = 5;  // 16 - PNG_MAX_GAMMA_8: the output is 8-bit
      if (shift > 8) shift = 8;
      to1_16 = table16(shift, screen);
      from1_16 = table16(shift, reciprocal(screen));
      same16 = table16to8(shift, product(file_gamma, screen));
    }
  }

  uint8_t gray8(int r, int g, int b) const {
    if (!gamma) return static_cast<uint8_t>((9797 * r + 19234 * g
                                             + 3737 * b) >> 15);
    if (r == g && r == b) return static_cast<uint8_t>(r);
    return static_cast<uint8_t>(from1[(9797 * to1[r] + 19234 * to1[g]
                                       + 3737 * to1[b] + 16384) >> 15]);
  }

  uint8_t gray16(int r, int g, int b) const {
    if (!gamma) return static_cast<uint8_t>(
        ((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8);
    if (r == g && r == b) return static_cast<uint8_t>(same16[r >> shift] >> 8);
    int v = (9797 * to1_16[r >> shift] + 19234 * to1_16[g >> shift]
             + 3737 * to1_16[b >> shift] + 16384) >> 15;
    return static_cast<uint8_t>(from1_16[v >> shift] >> 8);
  }
};

// ------------------------------------------------------ PNG to C, H, W

struct PngImage {
  int64_t width, height;
  int bit_depth, color_type, nch;
  const uint8_t* palette;  // 256 RGB triples (black past PLTE's end)
  const GrayRule* rule;
  int want;
  uint8_t* out;
  uint8_t palette_gray[256];  // the rule applied to each palette entry
};

// Sample k of an unfiltered row of `bits`-bit samples, big-endian.
inline int sample(const uint8_t* row, int64_t k, int bits) {
  switch (bits) {
    case 8: return row[k];
    case 16: return (row[2 * k] << 8) | row[2 * k + 1];
    default: {
      const int64_t bit = k * bits;
      return (row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1 << bits) - 1);
    }
  }
}

// One unfiltered row of `pw` pixels into output row `y`, pixel k at
// x0 + k * dx. Gray samples of 1, 2 and 4 bits expand by replication
// (v * 255 / (2^b - 1)), 16-bit samples keep their high byte; a palette
// index past PLTE's end is black; alpha and tRNS are dropped.
void convert_row(const PngImage& im, const uint8_t* row, int64_t pw,
                 int64_t y, int64_t x0, int64_t dx) {
  const int64_t plane = im.height * im.width;
  uint8_t* o = im.out + y * im.width + x0;
  const int bits = im.bit_depth, nch = im.nch;
  const int ct = im.color_type;
  if (ct == 0 || ct == 4) {  // gray (+ alpha)
    const int scale = bits < 8 ? 255 / ((1 << bits) - 1) : 1;
    for (int64_t k = 0; k < pw; ++k) {
      int v = sample(row, k * nch, bits);
      v = bits == 16 ? v >> 8 : v * scale;
      for (int c = 0; c < im.want; ++c)
        o[c * plane + k * dx] = static_cast<uint8_t>(v);
    }
  } else if (ct == 3) {
    // the palette's gray (want 1) or BGR entries, looked up by index
    for (int64_t k = 0; k < pw; ++k) {
      const int idx = sample(row, k, bits);
      const uint8_t* p = im.palette + 3 * idx;
      if (im.want == 1) {
        o[k * dx] = im.palette_gray[idx];
      } else {
        o[k * dx] = p[2];
        o[plane + k * dx] = p[1];
        o[2 * plane + k * dx] = p[0];
      }
    }
  } else if (bits == 8) {  // RGB (+ alpha)
    if (im.want == 1 && !im.rule->gamma) {
      for (int64_t k = 0; k < pw; ++k) {
        const uint8_t* p = row + k * nch;
        o[k * dx] = static_cast<uint8_t>((9797 * p[0] + 19234 * p[1]
                                          + 3737 * p[2]) >> 15);
      }
    } else if (im.want == 1) {
      for (int64_t k = 0; k < pw; ++k) {
        const uint8_t* p = row + k * nch;
        o[k * dx] = im.rule->gray8(p[0], p[1], p[2]);
      }
    } else {
      for (int64_t k = 0; k < pw; ++k) {
        const uint8_t* p = row + k * nch;
        o[k * dx] = p[2];
        o[plane + k * dx] = p[1];
        o[2 * plane + k * dx] = p[0];
      }
    }
  } else {  // 16-bit RGB (+ alpha)
    for (int64_t k = 0; k < pw; ++k) {
      const int r = sample(row, k * nch, 16);
      const int g = sample(row, k * nch + 1, 16);
      const int b = sample(row, k * nch + 2, 16);
      if (im.want == 1) {
        o[k * dx] = im.rule->gray16(r, g, b);
      } else {
        o[k * dx] = static_cast<uint8_t>(b >> 8);
        o[plane + k * dx] = static_cast<uint8_t>(g >> 8);
        o[2 * plane + k * dx] = static_cast<uint8_t>(r >> 8);
      }
    }
  }
}

// Adam7: x0, y0, dx, dy of the seven passes.
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                              {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                              {0, 1, 1, 2}};

// ------------------------------------------------------------------ PNM

inline void put_bgr(uint8_t* out, int64_t plane, int64_t i, int want, int b,
                    int g, int r) {
  if (want == 1) {
    out[i] = bgr2gray(b, g, r);
  } else {
    out[i] = static_cast<uint8_t>(b);
    out[plane + i] = static_cast<uint8_t>(g);
    out[2 * plane + i] = static_cast<uint8_t>(r);
  }
}

// OpenCV's ReadNumber over an ASCII body: whitespace and '#' comments (to
// the end of the line) skipped, any other byte an error; then up to
// `maxdigits` digits (0: all), the byte after the last digit consumed.
// Returns the value, -1 at the end of the data, -2 on a bad byte or a
// value above INT_MAX.
int64_t read_number(const uint8_t* s, int64_t n, int64_t* pos,
                    int maxdigits) {
  int64_t p = *pos;
  if (p >= n) return -1;
  int code = s[p++];
  while (code < '0' || code > '9') {
    if (code == '#') {
      do {
        if (p >= n) return -1;
        code = s[p++];
      } while (code != '\n' && code != '\r');
      if (p >= n) return -1;
      code = s[p++];
    } else if (code == ' ' || (code >= '\t' && code <= '\r')) {
      if (p >= n) return -1;
      code = s[p++];
    } else {
      return -2;
    }
  }
  int64_t val = 0;
  int digits = 0;
  for (;;) {
    val = val * 10 + (code - '0');
    if (val > 2147483647) return -2;
    if (maxdigits != 0 && ++digits >= maxdigits) break;
    if (p >= n) return -1;
    code = s[p++];
    if (code < '0' || code > '9') break;
  }
  *pos = p;
  return val;
}

// ------------------------------------------------------------------ BMP

struct BmpImage {
  int64_t width, height;
  bool top_down;
  const uint8_t* palette;  // 256 B, G, R, reserved entries
  int want;
  uint8_t* out;
  uint8_t gray[256];

  // output pixel of file row y (bottom-up unless top_down), column x
  void put_index(int64_t y, int64_t x, int idx) const {
    const int64_t row = top_down ? y : height - 1 - y;
    const int64_t i = row * width + x;
    if (want == 1) {
      out[i] = gray[idx];
    } else {
      const int64_t plane = height * width;
      out[i] = palette[4 * idx];
      out[plane + i] = palette[4 * idx + 1];
      out[2 * plane + i] = palette[4 * idx + 2];
    }
  }
};

// OpenCV's FillUniColor: `count` pixels of palette entry `idx` from
// (y, x), clipped at each row's end and carried on to the next row's
// start, until the count or the image ends.
void fill_uni(const BmpImage& im, int64_t* y, int64_t* x, int64_t count,
              int idx) {
  do {
    int64_t end = *x + count;
    if (end > im.width) end = im.width;
    count -= end - *x;
    for (; *x < end; ++*x) im.put_index(*y, *x, idx);
    if (*x >= im.width) {
      *x = 0;
      if (++*y >= im.height) break;
    }
  } while (count > 0);
}

// BI_RLE8 (bits 8) or BI_RLE4 (bits 4) as OpenCV's BmpDecoder::readData
// walks it: runs, absolute runs (padded to 16 bits), end of line, end of
// bitmap and deltas; skipped pixels take palette entry 0; a run that
// would cross its row's end is an error. In RLE4 an end of bitmap acts as
// an end of line and a delta skips dx pixels only (dy is read and
// dropped): the stream goes on until the last row is done. Returns 0, -1 at the end of the
// data, -3 on a run crossing a row's end.
int64_t decode_rle(const BmpImage& im, const uint8_t* s, int64_t n,
                   int bits) {
  int64_t p = 0, y = 0, x = 0;
  bool line_end_flag = false;
  const int64_t W = im.width, H = im.height;
  for (;;) {
    if (p + 2 > n) return -1;
    const int len = s[p], code = s[p + 1];
    p += 2;
    if (len != 0) {  // a run
      if (x + len > W) return -3;
      if (bits == 8) {
        const int64_t prev_y = y;
        fill_uni(im, &y, &x, len, code);
        line_end_flag = y != prev_y;
        if (y >= H) break;
      } else {  // RLE4: two alternating entries, no carry to the next row
        const int c[2] = {code >> 4, code & 15};
        for (int k = 0; k < len; ++k) im.put_index(y, x++, c[k & 1]);
      }
    } else if (code > 2) {  // an absolute run of `code` indices
      if (x + code > W) return -3;
      const int64_t sz = bits == 8 ? (code + 1) & ~1
                                   : (((code + 1) >> 1) + 1) & ~1;
      if (p + sz > n) return -1;
      for (int k = 0; k < code; ++k) {
        const int idx = bits == 8 ? s[p + k]
                                  : (s[p + k / 2] >> (k & 1 ? 0 : 4)) & 15;
        im.put_index(y, x++, idx);
      }
      p += sz;
      line_end_flag = false;
    } else {  // 0 end of line, 1 end of bitmap, 2 delta
      int64_t x_shift = W - x, y_shift = H - y;
      // RLE8 drops an end of line right after a run that ended its row
      if (bits == 4 || code != 0 || !line_end_flag || x_shift < W) {
        if (code == 2) {
          if (p + 2 > n) return -1;
          x_shift = s[p];
          y_shift = s[p + 1];
          p += 2;
        }
        // RLE8: the end of bitmap fills the rest, a delta its rows too;
        // RLE4 (as OpenCV fills it) only the pixels of dx, or to the row's
        // end, carried on to the next row's start
        if (code != 0 && bits == 8) x_shift += y_shift * W;
        if (bits == 8 && y >= H) break;
        fill_uni(im, &y, &x, x_shift, 0);
        if (y >= H) break;
      }
      line_end_flag = false;
      if (y >= H) break;
    }
  }
  return 0;
}

}  // namespace

// zlib.crc32(p[0:n], crc), the PNG chunks' CRC-32 alone (for tests).
extern "C" uint32_t of_crc32(const uint8_t* p, int64_t n, uint32_t crc) {
  return crc32(p, n > 0 ? static_cast<size_t>(n) : 0, crc);
}

// A PNG file (`file`, `file_size` bytes) whose `n_idat` consecutive IDAT
// chunks start at offset `idat_at`, and its inflated image data `data`
// (`size` bytes: rows of one filter byte and their filtered bytes, pass
// after pass if `interlace` is 1) to (want, height, width) uint8 as
// cv::imread gives it: want 1 gray (gray samples as they are; colour
// through libpng's rgb_to_gray, `GrayRule`), want 3 B, G, R planes.
// `palette`: 256 RGB triples for colour type 3 (else unused); `gamma`:
// the file's gamma in units of 1e-5 (sRGB 45455), 0 for none; `sig_bit`:
// the sBIT of 16-bit colour, 0 for none. Returns 0; 1 + the row (counted
// over the passes) of an unknown filter type; -1 for no memory; -2 for a
// bad layout; -4 for data of the wrong size; -5 for an IDAT chunk whose
// CRC is wrong (checked before the pixels). The IDAT CRCs are checked
// here, in the call that decodes the pixels: each call from Python
// releases the interpreter lock, and on a pool of threads each release
// costs a wait to take it back.
extern "C" int64_t of_png_decode(const uint8_t* file, int64_t file_size,
                                 int64_t idat_at, int64_t n_idat,
                                 const uint8_t* data, int64_t size,
                                 int64_t width, int64_t height,
                                 int bit_depth, int color_type,
                                 int interlace, const uint8_t* palette,
                                 int64_t gamma, int sig_bit, int want,
                                 uint8_t* out) {
  for (int64_t i = 0, at = idat_at; i < n_idat; ++i) {
    if (at < 0 || at + 12 > file_size) return -2;
    const int64_t length = be32(file + at);
    if (at + 12 + length > file_size) return -2;
    if (crc32(file + at + 4, static_cast<size_t>(length) + 4, 0)
        != be32(file + at + 8 + length))
      return -5;
    at += 12 + length;
  }
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (color_type < 0 || color_type > 6 || kChannels[color_type] == 0
      || (want != 1 && want != 3) || width <= 0 || height <= 0)
    return -2;
  const int nch = kChannels[color_type];
  const int bpp = (nch * bit_depth + 7) / 8;
  const int passes = interlace ? 7 : 1;
  int64_t need = 0, widest = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int* a = interlace ? kAdam7[pass] : nullptr;
    const int64_t pw = a ? (width - a[0] + a[2] - 1) / a[2] : width;
    const int64_t ph = a ? (height - a[1] + a[3] - 1) / a[3] : height;
    if (pw <= 0 || ph <= 0) continue;
    const int64_t rb = (pw * nch * bit_depth + 7) / 8;
    need += ph * (rb + 1);
    if (rb > widest) widest = rb;
  }
  if (need != size) return -4;
  const GrayRule rule(color_type & 2 ? gamma : 0, bit_depth, sig_bit);
  PngImage im{width, height, bit_depth, color_type, nch, palette,
              &rule, want, out, {}};
  if (color_type == 3)
    for (int i = 0; i < 256; ++i)
      im.palette_gray[i] = rule.gray8(palette[3 * i], palette[3 * i + 1],
                                      palette[3 * i + 2]);
  std::vector<uint8_t> buf;
  try {
    buf.assign(static_cast<size_t>(3 * widest + 3), 0);
  } catch (...) {
    return -1;
  }
  uint8_t* zeros = buf.data();
  uint8_t* rows[2] = {buf.data() + widest + 1, buf.data() + 2 * widest + 2};
  const uint8_t* src = data;
  if (!interlace && color_type == 0 && bit_depth == 8) {
    // 8-bit gray: unfilter straight into the first plane, copy to the rest
    const int64_t bad = unfilter_plane(src, height, width, zeros, out);
    if (bad) return bad;
    for (int c = 1; c < want; ++c)
      std::memcpy(out + c * width * height, out,
                  static_cast<size_t>(width * height));
    return 0;
  }
  int64_t row_no = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int* a = interlace ? kAdam7[pass] : nullptr;
    const int64_t x0 = a ? a[0] : 0, y0 = a ? a[1] : 0;
    const int64_t dx = a ? a[2] : 1, dy = a ? a[3] : 1;
    const int64_t pw = (width - x0 + dx - 1) / dx;
    const int64_t ph = (height - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const int64_t rb = (pw * nch * bit_depth + 7) / 8;
    const uint8_t* up = zeros;
    for (int64_t r = 0; r < ph; ++r, ++row_no) {
      uint8_t* cur = rows[r & 1];
      if (!unfilter_row_bpp(bpp, src[0], src + 1, up, cur, rb))
        return row_no + 1;
      convert_row(im, cur, pw, y0 + r * dy, x0, dx);
      up = cur;
      src += rb + 1;
    }
  }
  return 0;
}

// A PNM's pixels, `body` (`size` bytes from the byte after the header's
// last number) of a P`kind` image, to (want, height, width) uint8 as
// OpenCV's PxM reader gives them: P1 / P4 bitmaps 1 -> 0, 0 -> 255 (P4
// rows padded to a byte); P5 / P6 samples as stored up to maxval 255, the
// high byte of big-endian 16-bit samples above; P2 / P3 ASCII values
// clamped to maxval, then v * 255 / maxval up to maxval 255, v >> 8
// above. Colour to gray by OpenCV's BGR2GRAY. Returns 0, -1 for data that
// ends early, -2 for a bad byte or number in ASCII data.
extern "C" int64_t of_pnm_decode(const uint8_t* body, int64_t size, int kind,
                                 int64_t width, int64_t height, int maxval,
                                 int want, uint8_t* out) {
  if (kind < 1 || kind > 6 || (want != 1 && want != 3) || maxval < 1
      || maxval > 65535)
    return -2;
  const int64_t plane = width * height;
  const int nch = (kind == 3 || kind == 6) ? 3 : 1;
  if (kind == 4) {
    const int64_t pitch = (width + 7) / 8;
    if (pitch * height > size) return -1;
    for (int64_t y = 0; y < height; ++y)
      for (int64_t x = 0; x < width; ++x) {
        const int v = (body[y * pitch + x / 8] >> (7 - (x & 7))) & 1 ? 0
                                                                      : 255;
        put_bgr(out, plane, y * width + x, want, v, v, v);
      }
    return 0;
  }
  if (kind >= 5) {
    const int wide = maxval > 255 ? 2 : 1;
    if (plane * nch * wide > size) return -1;
    for (int64_t i = 0; i < plane; ++i) {
      int v[3];
      for (int c = 0; c < nch; ++c)
        v[c] = body[(i * nch + c) * wide];  // the high byte if 16-bit
      if (nch == 1) put_bgr(out, plane, i, want, v[0], v[0], v[0]);
      else put_bgr(out, plane, i, want, v[2], v[1], v[0]);
    }
    return 0;
  }
  int64_t pos = 0;
  for (int64_t i = 0; i < plane; ++i) {
    int v[3];
    for (int c = 0; c < nch; ++c) {
      int64_t n = read_number(body, size, &pos, kind == 1 ? 1 : 0);
      if (n < 0) return n;
      if (kind == 1) {
        v[c] = n != 0 ? 0 : 255;
      } else {
        if (n > maxval) n = maxval;
        v[c] = maxval > 255 ? static_cast<int>(n >> 8)
                            : static_cast<int>(n * 255 / maxval);
      }
    }
    if (nch == 1) put_bgr(out, plane, i, want, v[0], v[0], v[0]);
    else put_bgr(out, plane, i, want, v[2], v[1], v[0]);
  }
  return 0;
}

// A BMP's pixels, from byte `offset` of the whole file `raw` (`size`
// bytes), to (want, height, width) uint8 as OpenCV's BMP reader gives
// them. `bpp`: 1, 4, 8 (palette: 256 B, G, R, reserved entries), 15 (5-5-5)
// and 16 (5-6-5) as x << 3 of each field with no replication, 24, 32 (the
// fourth byte ignored, or, where `masks` is given (R, G, B, all nonzero,
// from a header of 56 bytes or more), each field v of mask m scaled as
// (int)(v * (255.f / (m >> shift))) in float); `rle`: 0, 8 (BI_RLE8) or 4
// (BI_RLE4). Rows padded to 4 bytes, bottom-up unless `top_down`. Gray
// through OpenCV's BGR2GRAY (of the palette's entries for bpp <= 8), but
// for masked 32-bit pixels (int)(0.299f R + 0.587f G + 0.114f B) in float.
// Returns 0, -1 for data that ends early, -2 for a bad layout, -3 for an
// RLE run that crosses its row's end.
extern "C" int64_t of_bmp_decode(const uint8_t* raw, int64_t size,
                                 int64_t offset, int64_t width,
                                 int64_t height, int top_down, int bpp,
                                 int rle, const uint8_t* palette,
                                 const uint32_t* masks, int want,
                                 uint8_t* out) {
  if ((want != 1 && want != 3) || width <= 0 || height <= 0 || offset < 0)
    return -2;
  if (offset > size) return -1;
  BmpImage im{width, height, top_down != 0, palette, want, out, {}};
  for (int i = 0; i < 256; ++i)
    im.gray[i] = bgr2gray(palette[4 * i], palette[4 * i + 1],
                          palette[4 * i + 2]);
  const uint8_t* s = raw + offset;
  const int64_t n = size - offset;
  if (rle == 8 || rle == 4) return decode_rle(im, s, n, rle);
  if (rle != 0) return -2;
  const int64_t pitch = ((width * (bpp == 15 ? 16 : bpp) + 7) / 8 + 3) & ~3;
  if (pitch * height > n) return -1;
  const int64_t plane = width * height;
  int shift[3] = {0, 0, 0};
  float scale[3] = {0.f, 0.f, 0.f};
  for (int c = 0; masks && c < 3; ++c) {
    if (masks[c] == 0) return -2;
    while (!((masks[c] >> shift[c]) & 1u)) ++shift[c];
    scale[c] = 255.f / static_cast<float>(masks[c] >> shift[c]);
  }
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* row = s + y * pitch;
    const int64_t oy = top_down ? y : height - 1 - y;
    for (int64_t x = 0; x < width; ++x) {
      const int64_t i = oy * width + x;
      switch (bpp) {
        case 1: case 4: case 8: {
          const int64_t bit = x * bpp;
          const int idx = (row[bit >> 3] >> (8 - bpp - (bit & 7)))
                          & ((1 << bpp) - 1);
          im.put_index(y, x, idx);
          break;
        }
        case 15: case 16: {
          const int t = row[2 * x] | (row[2 * x + 1] << 8);
          const int b = (t << 3) & 0xf8;
          const int g = bpp == 15 ? (t >> 2) & 0xf8 : (t >> 3) & 0xfc;
          const int r = bpp == 15 ? (t >> 7) & 0xf8 : (t >> 8) & 0xf8;
          put_bgr(out, plane, i, want, b, g, r);
          break;
        }
        case 24: case 32: {
          const uint8_t* p = row + x * (bpp / 8);
          if (!masks) {
            put_bgr(out, plane, i, want, p[0], p[1], p[2]);
            break;
          }
          const uint32_t t = p[0] | (p[1] << 8) | (p[2] << 16)
                             | (static_cast<uint32_t>(p[3]) << 24);
          int v[3];  // R, G, B
          for (int c = 0; c < 3; ++c)
            v[c] = static_cast<int>(
                static_cast<float>((t & masks[c]) >> shift[c]) * scale[c]);
          if (want == 1)
            out[i] = static_cast<uint8_t>(static_cast<int>(
                0.299f * v[0] + 0.587f * v[1] + 0.114f * v[2]));
          else
            put_bgr(out, plane, i, want, v[2], v[1], v[0]);
          break;
        }
        default:
          return -2;
      }
    }
  }
  return 0;
}
