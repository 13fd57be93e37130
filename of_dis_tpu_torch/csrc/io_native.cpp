// Host-side frame decoding for the serving pipeline: the PNG row filters
// undone on an already inflated buffer, and 8-bit pixels converted to the
// (C, H, W) uint8 layout the port's entry points take.
//
// Replaces: of_dis_tpu/native/io_native.cpp::decode_png (the unfilter loop,
// `paeth`) and `to_chw`, reached through of_dis_tpu/native/io.py::
// decode_batch. Plain C entries, no CUDA and no zlib: Python parses the
// chunks and inflates with `zlib.decompress`, and both release the
// interpreter lock on large buffers, as a ctypes call does, so a thread
// pool over frames runs these entries side by side.
//
// What bounds it: the Average and Paeth filters depend on the pixel to the
// left, so a row is one dependent chain of bytes; the loops below are
// specialised by bytes per pixel so that the chain carries no branch on
// the filter type or the channel count.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

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
// `up` (zeros for the first row) into `dst`. BPP: bytes per pixel.
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

template <int BPP>
int64_t unfilter(const uint8_t* raw, int64_t height, int64_t stride,
                 uint8_t* out) {
  uint8_t* zeros = static_cast<uint8_t*>(std::calloc(
      static_cast<size_t>(stride) + 1, 1));
  if (!zeros) return -1;
  const uint8_t* up = zeros;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    uint8_t* dst = out + y * stride;
    if (!unfilter_row<BPP>(src[0], src + 1, up, dst, stride)) {
      std::free(zeros);
      return y + 1;
    }
    up = dst;
  }
  std::free(zeros);
  return 0;
}

}  // namespace

// Undo the PNG row filters (PNG spec section 9): `raw` holds `height` rows
// of one filter-type byte and `stride` filtered bytes each (the inflated
// IDAT stream of an 8-bit non-interlaced image), `bpp` bytes per pixel
// (1 gray, 2 gray+alpha, 3 RGB, 4 RGBA). Writes `height` rows of `stride`
// bytes to `out`. Returns 0; 1 + the row of an unknown filter type; -1 for
// a bad `bpp` or no memory.
extern "C" int64_t of_png_unfilter(const uint8_t* raw, int64_t height,
                                   int64_t stride, int bpp, uint8_t* out) {
  switch (bpp) {
    case 1: return unfilter<1>(raw, height, stride, out);
    case 2: return unfilter<2>(raw, height, stride, out);
    case 3: return unfilter<3>(raw, height, stride, out);
    case 4: return unfilter<4>(raw, height, stride, out);
    default: return -1;
  }
}

// Interleaved 8-bit pixels (height, width, nch) -> (want, height, width)
// uint8, as cv::imread gives them: want = 1 is OpenCV's fixed-point
// BGR2GRAY, (R*4899 + G*9617 + B*1868 + 8192) >> 14 (a gray pixel stays
// itself); want = 3 is B, G, R planes. nch: 1 gray, 2 gray+alpha, 3 RGB,
// 4 RGBA; alpha is dropped. Returns 0, or -1 for a bad nch or want.
extern "C" int of_to_chw(const uint8_t* pix, int64_t height, int64_t width,
                         int nch, int want, uint8_t* out) {
  if (nch < 1 || nch > 4 || (want != 1 && want != 3)) return -1;
  const int64_t plane = height * width;
  if (want == 1) {
    if (nch <= 2) {
      for (int64_t i = 0; i < plane; ++i) out[i] = pix[i * nch];
    } else {
      for (int64_t i = 0; i < plane; ++i) {
        const uint8_t* p = pix + i * nch;
        out[i] = static_cast<uint8_t>(
            (p[0] * 4899 + p[1] * 9617 + p[2] * 1868 + 8192) >> 14);
      }
    }
    return 0;
  }
  for (int64_t i = 0; i < plane; ++i) {
    const uint8_t* p = pix + i * nch;
    const uint8_t r = p[0];
    const uint8_t g = nch <= 2 ? p[0] : p[1];
    const uint8_t b = nch <= 2 ? p[0] : p[2];
    out[i] = b;
    out[plane + i] = g;
    out[2 * plane + i] = r;
  }
  return 0;
}
