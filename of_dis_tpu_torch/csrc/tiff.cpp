// Host-side pixel decoding of TIFF frames for the serving pipeline and
// `load_image`, to the (C, H, W) uint8 layout the port's entry points
// take, with the values cv::imread gives (C = 1 IMREAD_GRAYSCALE, C = 3
// IMREAD_COLOR, B, G, R planes).
//
// Replaces the cv2.imread fallback of of_dis_tpu/utils/io.py::load_image
// for TIFF. Plain C entries, no CUDA, no codec library: Python parses the
// IFD (`utils/io.py::tiff_ifd`), inflates Deflate chunks with zlib (as
// PNG's image data) and has csrc/jpeg.cpp decode JPEG chunks; this file
// undoes LZW and PackBits, the fill order and predictor 2, unpacks the
// samples and converts them. A ctypes call releases the interpreter lock,
// so a thread pool over frames runs it side by side.
//
// Which rules: cv::imread reads an 8-bit TIFF through libtiff's
// TIFFReadRGBAStrip / TIFFReadRGBATile (OpenCV 5's grfmt_tiff.cpp, libtiff
// 4.7's tif_getimage.c), then takes B, G, R of the RGBA raster or its
// gray by the readers' BGR2GRAY in 1/16384ths (gray.h). So: gray samples
// through libtiff's map (1 bit 0 / 255, 16 bits the high byte, MINISWHITE
// inverted), palette entries shifted down 8 bits unless every entry is
// below 256, 16-bit colour samples (v + 128) / 257, unassociated alpha
// premultiplied (v * a + 127) / 255, CMYK as (255 - K) * (255 - C) / 255;
// planar gray goes through libtiff's planar RGB route (no inversion, 16
// bits by (v + 128) / 257, alpha premultiplied). The orientation tag
// flips as libtiff's raster and OpenCV's strip placement do: 2 mirrors
// each strip or tile in place, 4 flips the image upside down, 3 both.
// Held to cv2.imread pixel for pixel by tests/test_torch_tiff.py.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "gray.h"

namespace {

enum Param {
  kWidth, kHeight, kBits, kSpp, kCompression, kPhotometric, kPlanar,
  kPredictor, kFillOrder, kAlpha, kBigEndian, kTiled, kChunkW, kChunkH,
  kOrientation
};

enum Code {
  kOk = 0,
  kShort = -1,        // a chunk decodes to fewer bytes than it holds
  kLayout = -2,       // parameters the decoder does not take
  kLzw = -3,          // corrupt LZW data
  kNoMemory = -4,
  kOldLzw = -5,       // old-style (TIFF 5.0) LZW, LSB-first
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// TIFF LZW (tif_lzw.c LZWDecode, new style): codes MSB-first from 9 bits,
// one bit more once the next free entry reaches 2^n - 1 (early change),
// up to 12; Clear (256) first, End (257) or the end of the data last.
// Fills `out` with `need` bytes, the last string cut where it overruns;
// data that ends first, an undefined code or a full table fail, as
// libtiff fails.
void lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t need) {
  constexpr int kClear = 256, kEnd = 257, kFirst = 258;
  constexpr int kSize = 4095 + 1024;   // libtiff's CSIZE
  std::vector<int32_t> prev(kSize), len(kSize);
  std::vector<uint8_t> first(kSize), last(kSize);
  for (int i = 0; i < 256; ++i) {
    prev[i] = -1;
    len[i] = 1;
    first[i] = last[i] = static_cast<uint8_t>(i);
  }
  int64_t pos = 0, bitpos = 0;
  const int64_t nbits_total = n * 8;
  int nbits = 9;
  int free_ent = kFirst;
  int old = -1;  // none: the first code must be Clear
  auto next = [&]() -> int {
    if (bitpos + nbits > nbits_total) return kEnd;  // out of data: End
    int64_t v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v = (v << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return static_cast<int>(v);
  };
  auto emit = [&](int code) {  // the string of `code`, cut at `need`
    const int64_t l = len[code];
    int64_t at = pos + l - 1;
    for (int c = code; c >= 0; c = prev[c], --at)
      if (at < need) out[at] = last[c];
    pos += l;
  };
  while (pos < need) {
    int code = next();
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        for (int i = kFirst; i < kSize; ++i) len[i] = 0;
        code = next();
      } while (code == kClear);
      if (code == kEnd) break;
      if (code > kClear) fail(kLzw);
      out[pos++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code == kEnd) break;
    if (old < 0 || free_ent >= kSize) fail(kLzw);
    // the new entry: the previous string and the first byte of this one
    // (of the new entry itself where the code is the one being defined)
    const bool known = code < free_ent;
    if (!known && code != free_ent) fail(kLzw);
    prev[free_ent] = old;
    len[free_ent] = len[old] + 1;
    first[free_ent] = first[old];
    last[free_ent] = known ? first[code] : first[old];
    if (++free_ent > (1 << nbits) - 2 && nbits < 12) ++nbits;
    if (len[code] == 0) fail(kLzw);
    emit(code);
    old = code;
  }
  if (pos < need) fail(kShort);
}

// PackBits (tif_packbits.c PackBitsDecode): a run or a literal that
// overruns `need` is cut; data that ends before `need` bytes fails.
void packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t need) {
  int64_t i = 0, o = 0;
  while (i < n && o < need) {
    int c = in[i++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = 1 - c;
      if (run > need - o) run = need - o;
      if (i >= n) break;
      std::memset(out + o, in[i++], static_cast<size_t>(run));
      o += run;
    } else {
      int64_t lit = c + 1;
      if (lit > need - o) lit = need - o;
      if (n - i < lit) break;
      std::memcpy(out + o, in + i, static_cast<size_t>(lit));
      o += lit;
      i += lit;
    }
  }
  if (o < need) fail(kShort);
}

inline uint8_t reverse_bits(uint8_t v) {
  v = static_cast<uint8_t>((v & 0xF0) >> 4 | (v & 0x0F) << 4);
  v = static_cast<uint8_t>((v & 0xCC) >> 2 | (v & 0x33) << 2);
  return static_cast<uint8_t>((v & 0xAA) >> 1 | (v & 0x55) << 1);
}

struct Tiff {
  const int64_t* p;
  const uint8_t* pal;  // 256 R, G, B entries (8-bit), for a palette

  // One chunk (strip or tile of one plane) decoded: `rows` rows of `rb`
  // bytes, the fill order undone, 16-bit samples little-endian, the
  // predictor undone.
  void chunk(const uint8_t* src, int64_t size, int64_t rows, int64_t rb,
             int64_t spc, std::vector<uint8_t>* buf) const {
    const int64_t need = rows * rb;
    buf->resize(static_cast<size_t>(need));
    std::vector<uint8_t> rev;
    if (p[kFillOrder] == 2) {
      rev.resize(static_cast<size_t>(size));
      for (int64_t i = 0; i < size; ++i) rev[i] = reverse_bits(src[i]);
      src = rev.data();
    }
    switch (p[kCompression]) {
      case 1:
        if (size < need) fail(kShort);
        std::memcpy(buf->data(), src, static_cast<size_t>(need));
        break;
      case 5:
        // libtiff's test for the old, bit-reversed LZW (LZWPreDecode)
        if (size >= 2 && src[0] == 0 && (src[1] & 1)) fail(kOldLzw);
        lzw_decode(src, size, buf->data(), need);
        break;
      case 32773: packbits_decode(src, size, buf->data(), need); break;
      default: fail(kLayout);
    }
    uint8_t* d = buf->data();
    const bool wide = p[kBits] == 16;
    if (wide && p[kBigEndian]) {  // libtiff swabs 16-bit data to native
      for (int64_t i = 0; i + 1 < need; i += 2) {
        const uint8_t hi = d[i];
        d[i] = d[i + 1];
        d[i + 1] = hi;
      }
    }
    if (p[kPredictor] != 2) return;
    const int64_t n = rb / (wide ? 2 : 1);  // samples a row
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = d + r * rb;
      if (!wide) {
        for (int64_t i = spc; i < n; ++i)
          row[i] = static_cast<uint8_t>(row[i] + row[i - spc]);
        continue;
      }
      for (int64_t i = spc; i < n; ++i) {
        uint8_t* a = row + 2 * i;
        const uint8_t* b = row + 2 * (i - spc);
        const int v = ((a[0] | (a[1] << 8)) + (b[0] | (b[1] << 8))) & 0xFFFF;
        a[0] = static_cast<uint8_t>(v);
        a[1] = static_cast<uint8_t>(v >> 8);
      }
    }
  }

  // sample `s` of pixel `x` in a row of `spc` samples a pixel
  int sample(const uint8_t* row, int64_t x, int64_t spc, int s) const {
    const int64_t i = x * spc + s;
    switch (p[kBits]) {
      case 1: return (row[i >> 3] >> (7 - (i & 7))) & 1;
      case 4: return (row[i >> 1] >> (i & 1 ? 0 : 4)) & 15;
      case 8: return row[i];
      default: return row[2 * i] | (row[2 * i + 1] << 8);  // swabbed
    }
  }
};

inline int to8(int v) { return (v + 128) / 257; }  // Bitdepth16To8
inline int premul(int v, int a) { return (v * a + 127) / 255; }  // UaToAa

// The TIFF's pixels from its chunks (`chunks[i]`, `sizes[i]` bytes: as
// stored for compression 1, 5 and 32773, else already inflated or
// decoded and given as compression 1), `p` the parameters of enum Param
// (photometric 0 MINISWHITE, 1 MINISBLACK, 2 RGB, 3 PALETTE, 5 CMYK;
// alpha 0 none, 1 associated, 2 unassociated; tiled 0 or 1; chunk width
// and height the tile's, or the width and rows per strip), `pal` 256 R,
// G, B triples for a palette, into (want, height, width) uint8.
void decode(const uint8_t* const* chunks, const int64_t* sizes,
            int64_t nchunks, const int64_t* p, const uint8_t* pal, int want,
            uint8_t* out) {
  const int64_t W = p[kWidth], H = p[kHeight], bits = p[kBits];
  const int64_t spp = p[kSpp], cw = p[kChunkW], ch = p[kChunkH];
  const int phot = static_cast<int>(p[kPhotometric]);
  const bool planar = p[kPlanar] == 2 && spp > 1;
  const int alpha = static_cast<int>(p[kAlpha]);
  const int orient = static_cast<int>(p[kOrientation]);
  if ((want != 1 && want != 3) || W <= 0 || H <= 0 || cw <= 0 || ch <= 0
      || spp < 1 || spp > 4 || orient < 1 || orient > 4)
    fail(kLayout);
  const int64_t across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  const int64_t per_plane = across * down;
  if (nchunks != per_plane * (planar ? spp : 1)) fail(kLayout);
  const int64_t spc = planar ? 1 : spp;  // samples a pixel in a chunk
  const int64_t rb = (cw * spc * bits + 7) / 8;
  const bool gray = phot == 0 || phot == 1;
  // the planes a planar image reads: gray (+ alpha), R, G, B (+ alpha),
  // C, M, Y, K
  const int nplanes = !planar ? 1
                      : phot == 5 ? 4
                      : (gray ? 1 : 3) + (alpha ? 1 : 0);
  if (planar && nplanes > spp) fail(kLayout);
  const bool tiled = p[kTiled] != 0;
  const bool flip_x = orient == 2 || orient == 3;
  const bool flip_y = orient == 3 || orient == 4;
  const int64_t plane = W * H;
  Tiff t{p, pal};
  std::vector<uint8_t> buf[4];
  for (int64_t gy = 0; gy < down; ++gy) {
    const int64_t y0 = gy * ch;
    const int64_t vh = H - y0 < ch ? H - y0 : ch;
    // a strip holds only the rows inside the image; a tile is whole
    const int64_t rows = tiled ? ch : vh;
    for (int64_t gx = 0; gx < across; ++gx) {
      const int64_t x0 = gx * cw;
      const int64_t vw = W - x0 < cw ? W - x0 : cw;
      for (int k = 0; k < nplanes; ++k) {
        const int64_t i = k * per_plane + gy * across + gx;
        if (chunks[i] == nullptr) fail(kLayout);
        t.chunk(chunks[i], sizes[i], rows, rb, spc, &buf[k]);
      }
      // libtiff's putgreytile, put16bitbwtile and put8bitcmaptile step
      // past a clipped tile's right part by its width in pixels, not in
      // bytes: where a pixel is more than one byte, they read each row of
      // a tile the image cuts from there on
      int64_t stride = rb;
      const int64_t px_bytes = spc * bits / 8;
      if (tiled && !planar && vw < cw && px_bytes > 1
          && (gray || (phot == 3 && bits == 8)))
        stride = vw * px_bytes + (cw - vw);
      for (int64_t r = 0; r < vh; ++r) {
        const uint8_t* row[4];
        for (int k = 0; k < nplanes; ++k)
          row[k] = buf[k].data() + r * stride;
        const int64_t oy = flip_y ? H - 1 - (y0 + r) : y0 + r;
        for (int64_t c = 0; c < vw; ++c) {
          int R, G, B;
          if (planar) {
            if (phot == 5) {
              const int K = 255 - row[3][c];
              R = K * (255 - row[0][c]) / 255;
              G = K * (255 - row[1][c]) / 255;
              B = K * (255 - row[2][c]) / 255;
            } else {
              const int nc = gray ? 1 : 3;
              int v[3];
              for (int k = 0; k < nc; ++k) {
                v[k] = t.sample(row[k], c, 1, 0);
                if (bits == 16) v[k] = to8(v[k]);
              }
              if (gray) v[1] = v[2] = v[0];
              if (alpha == 2) {
                int a = t.sample(row[nc], c, 1, 0);
                if (bits == 16) a = to8(a);
                for (int k = 0; k < 3; ++k) v[k] = premul(v[k], a);
              }
              R = v[0];
              G = v[1];
              B = v[2];
            }
          } else if (gray) {
            int v = t.sample(row[0], c, spc, 0);
            v = bits == 1 ? (v ? 255 : 0) : bits == 16 ? v >> 8 : v;
            R = G = B = phot == 0 ? 255 - v : v;
          } else if (phot == 3) {
            const int idx = t.sample(row[0], c, spc, 0);
            R = pal[3 * idx];
            G = pal[3 * idx + 1];
            B = pal[3 * idx + 2];
          } else if (phot == 5) {
            const uint8_t* s = row[0] + c * spc;
            const int K = 255 - s[3];
            R = K * (255 - s[0]) / 255;
            G = K * (255 - s[1]) / 255;
            B = K * (255 - s[2]) / 255;
          } else {
            int v[3];
            for (int k = 0; k < 3; ++k) {
              v[k] = t.sample(row[0], c, spc, k);
              if (bits == 16) v[k] = to8(v[k]);
            }
            if (alpha == 2) {
              int a = t.sample(row[0], c, spc, 3);
              if (bits == 16) a = to8(a);
              for (int k = 0; k < 3; ++k) v[k] = premul(v[k], a);
            }
            R = v[0];
            G = v[1];
            B = v[2];
          }
          const int64_t ox = flip_x ? x0 + vw - 1 - c : x0 + c;
          const int64_t o = oy * W + ox;
          if (want == 1) {
            out[o] = bgr2gray(B, G, R);
          } else {
            out[o] = static_cast<uint8_t>(B);
            out[plane + o] = static_cast<uint8_t>(G);
            out[2 * plane + o] = static_cast<uint8_t>(R);
          }
        }
      }
    }
  }
}

}  // namespace

// See `decode`. Returns 0, -1 for a chunk that holds fewer bytes than its
// rows, -2 for parameters it does not take, -3 for corrupt LZW data, -4
// out of memory, -5 for old-style LZW.
extern "C" int64_t of_tiff_decode(const uint8_t* const* chunks,
                                  const int64_t* sizes, int64_t nchunks,
                                  const int64_t* params, const uint8_t* pal,
                                  int want, uint8_t* out) {
  try {
    decode(chunks, sizes, nchunks, params, pal, want, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}
