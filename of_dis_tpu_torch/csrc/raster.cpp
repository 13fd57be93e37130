// Host-side pixel decoding of Sun raster, PAM (P7), Radiance HDR and PFM
// frames for the serving pipeline and `load_image`, to the (C, H, W) uint8
// layout the port's entry points take, with the values cv::imread gives
// (C = 1 IMREAD_GRAYSCALE, C = 3 IMREAD_COLOR, B, G, R planes).
//
// Replaces the cv2.imread fallback of of_dis_tpu/utils/io.py::load_image
// and of_dis_tpu/pipeline.py::_decode_batch for these formats. Plain C
// entries, no CUDA: Python parses the headers (`utils/io.py`: ras_header,
// pam_header, hdr_header, pfm_header) and a ctypes call releases the
// interpreter lock, so a thread pool over frames runs these entries side
// by side.
//
// Which rules: OpenCV 5.0's readers (grfmt_sunras.cpp, grfmt_pam.cpp,
// grfmt_hdr.cpp with rgbe.cpp, grfmt_pfm.cpp) and imread's conversions,
// held to cv2.imread pixel for pixel by tests/test_torch_raster_formats.py.
// Sun raster and PAM gray through the readers' fixed-point BGR2GRAY in
// 1/16384ths; a Radiance HDR through cvtColor's BGR2GRAY in 1/32768ths of
// its 8-bit colour (gray.h).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "gray.h"

namespace {

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

// OpenCV's saturate_cast<uchar>(float) on x86: cvRound (to nearest, ties
// to even), where a value outside int32 or NaN becomes INT_MIN and so 0.
inline uint8_t round_sat(float x) {
  if (!(x >= -2147483648.f && x < 2147483648.f)) return 0;
  const long r = std::lrintf(x);
  return static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
}

}  // namespace

// A Sun raster's pixels, from byte `offset` of the whole file `raw`
// (`size` bytes), to (want, height, width) uint8 as OpenCV's Sun raster
// reader gives them: rows padded to 16 bits, top-down; depth 1 (bits
// from the most significant) and 8 through `palette` (256 B, G, R
// triples) or, with no colour map, gray levels 0 / 255 and 0-255 in
// colour but 0 in gray (OpenCV converts only a colour map to gray);
// depth 24 B, G, R and depth 32 a pad byte then B, G, R. Gray by
// OpenCV's BGR2GRAY in 1/16384ths. Returns 0, -1 for data that ends
// early, -2 for a bad layout.
extern "C" int64_t of_ras_decode(const uint8_t* raw, int64_t size,
                                 int64_t offset, int64_t width,
                                 int64_t height, int depth,
                                 const uint8_t* palette, int want,
                                 uint8_t* out) {
  if ((want != 1 && want != 3) || width <= 0 || height <= 0 || offset < 0
      || (depth != 1 && depth != 8 && depth != 24 && depth != 32))
    return -2;
  const int64_t pitch = ((width * depth + 7) / 8 + 1) & ~int64_t{1};
  if (offset > size || pitch * height > size - offset) return -1;
  const int64_t plane = width * height;
  uint8_t lut[256][3], gray[256];  // index -> B, G, R and gray
  for (int i = 0; i < 256; ++i) {
    if (palette != nullptr) {
      for (int c = 0; c < 3; ++c) lut[i][c] = palette[3 * i + c];
      gray[i] = bgr2gray(lut[i][0], lut[i][1], lut[i][2]);
    } else {
      const int v = depth == 1 ? (i ? 255 : 0) : i;
      lut[i][0] = lut[i][1] = lut[i][2] = static_cast<uint8_t>(v);
      gray[i] = 0;
    }
  }
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* row = raw + offset + y * pitch;
    for (int64_t x = 0; x < width; ++x) {
      const int64_t i = y * width + x;
      if (depth <= 8) {
        const int idx = depth == 8 ? row[x]
                                   : (row[x >> 3] >> (7 - (x & 7))) & 1;
        if (want == 1) {
          out[i] = gray[idx];
        } else {
          out[i] = lut[idx][0];
          out[plane + i] = lut[idx][1];
          out[2 * plane + i] = lut[idx][2];
        }
      } else {
        const uint8_t* p = row + x * (depth / 8) + (depth == 32 ? 1 : 0);
        put_bgr(out, plane, i, want, p[0], p[1], p[2]);
      }
    }
  }
  return 0;
}

// A PAM's pixels (`body`, `size` bytes from the byte after ENDHDR's line
// end) of `depth` samples a pixel (1 or 3) to (want, height, width) uint8
// as OpenCV's PAM reader gives them: maxval 1 as rows of width * depth
// bytes whose leading bits are the pixels (1 -> 255); else samples as
// stored up to maxval 255, the high byte of big-endian 16-bit samples
// above; three samples in colour in the file's order (the reader copies
// them as they are), in gray as R, G, B through BGR2GRAY in 1/16384ths.
// Returns 0, -1 for data that ends early, -2 for a bad layout.
extern "C" int64_t of_pam_decode(const uint8_t* body, int64_t size,
                                 int64_t width, int64_t height, int depth,
                                 int maxval, int want, uint8_t* out) {
  if ((want != 1 && want != 3) || width <= 0 || height <= 0
      || (depth != 1 && depth != 3) || maxval < 1 || maxval > 65535)
    return -2;
  const int64_t plane = width * height;
  if (maxval == 1) {
    const int64_t stride = width * depth;
    if (stride * height > size) return -1;
    for (int64_t y = 0; y < height; ++y)
      for (int64_t x = 0; x < width; ++x) {
        const int v = (body[y * stride + (x >> 3)] >> (7 - (x & 7))) & 1
                      ? 255 : 0;
        for (int c = 0; c < want; ++c)
          out[c * plane + y * width + x] = static_cast<uint8_t>(v);
      }
    return 0;
  }
  const int wide = maxval > 255 ? 2 : 1;
  if (plane * depth * wide > size) return -1;
  for (int64_t i = 0; i < plane; ++i) {
    const uint8_t* p = body + i * depth * wide;
    if (depth == 1) {
      for (int c = 0; c < want; ++c) out[c * plane + i] = p[0];
    } else if (want == 3) {
      for (int c = 0; c < 3; ++c) out[c * plane + i] = p[c * wide];
    } else {
      out[i] = bgr2gray(p[2 * wide], p[wide], p[0]);
    }
  }
  return 0;
}

// A Radiance HDR's scanlines (`body`, `size` bytes from the byte after
// its resolution line) to (want, height, width) uint8 as cv::imread gives
// them: OpenCV's RGBE_ReadPixels_RLE (new-style run-length scanlines
// where the width is 8-32767 and a scanline starts 2, 2, else flat RGBE
// pixels to the end; no old-style runs), each component c of exponent
// e > 0 as c * 2^(e - 136) in float, times 255 in float, rounded as
// saturate_cast<uchar>; gray by cvtColor's BGR2GRAY of those bytes.
// Returns 0, -1 for data that ends early, -2 for a bad layout, -3 for a
// corrupt run-length scanline (cv::imread returns memory it never wrote
// for either of those).
extern "C" int64_t of_hdr_decode(const uint8_t* body, int64_t size,
                                 int64_t width, int64_t height, int want,
                                 uint8_t* out) {
  if ((want != 1 && want != 3) || width <= 0 || height <= 0) return -2;
  const int64_t plane = width * height;
  float scale[256];
  for (int e = 0; e < 256; ++e)
    scale[e] = e ? static_cast<float>(std::ldexp(1.0, e - 136)) : 0.f;
  auto put = [&](int64_t i, const uint8_t* rgbe) {
    const float f = scale[rgbe[3]];
    const uint8_t r = round_sat(static_cast<float>(rgbe[0]) * f * 255.f);
    const uint8_t g = round_sat(static_cast<float>(rgbe[1]) * f * 255.f);
    const uint8_t b = round_sat(static_cast<float>(rgbe[2]) * f * 255.f);
    if (want == 1) {
      out[i] = cvt_gray(b, g, r);
    } else {
      out[i] = b;
      out[plane + i] = g;
      out[2 * plane + i] = r;
    }
  };
  int64_t pos = 0, i = 0;
  auto flat = [&]() -> int64_t {  // the rest of the image, flat
    if ((plane - i) * 4 > size - pos) return -1;
    for (; i < plane; ++i, pos += 4) put(i, body + pos);
    return 0;
  };
  if (width < 8 || width > 0x7fff) return flat();
  std::vector<uint8_t> line(static_cast<size_t>(4 * width));
  for (int64_t y = 0; y < height; ++y) {
    if (pos + 4 > size) return -1;
    const uint8_t* head = body + pos;
    if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80)) return flat();
    if (((head[2] << 8) | head[3]) != width) return -3;
    pos += 4;
    for (int c = 0; c < 4; ++c) {
      uint8_t* ptr = line.data() + c * width;
      uint8_t* const end = ptr + width;
      while (ptr < end) {
        if (pos + 2 > size) return -1;
        int count = body[pos];
        if (count > 128) {
          count -= 128;
          if (count > end - ptr) return -3;
          std::memset(ptr, body[pos + 1], count);
          ptr += count;
          pos += 2;
        } else {
          if (count == 0 || count > end - ptr) return -3;
          if (pos + 1 + count > size) return -1;
          std::memcpy(ptr, body + pos + 1, count);
          ptr += count;
          pos += 1 + count;
        }
      }
    }
    for (int64_t x = 0; x < width; ++x, ++i) {
      const uint8_t rgbe[4] = {line[x], line[width + x], line[2 * width + x],
                               line[3 * width + x]};
      put(i, rgbe);
    }
  }
  return 0;
}

// A PFM's samples (`body`, `size` bytes from the byte after its scale),
// bottom-up rows of float32 in the byte order of the scale's sign, to
// (want, height, width) uint8 as cv::imread gives them: each sample times
// (float)(1 / |scale|) in float, then saturate_cast<uchar> (no factor of
// 255); gray `Pf` to want 1, colour `PF` (R, G, B) to want 3 in BGR
// order (cv::imread fails on the other two reads). Returns 0, -1 for data
// that ends early, -2 for a bad layout.
extern "C" int64_t of_pfm_decode(const uint8_t* body, int64_t size,
                                 int64_t width, int64_t height, int colour,
                                 int big_endian, double scale, int want,
                                 uint8_t* out) {
  const int nch = colour ? 3 : 1;
  if (want != nch || width <= 0 || height <= 0 || !(std::fabs(scale) > 0))
    return -2;
  const int64_t plane = width * height;
  if (plane * nch * 4 > size) return -1;
  const float inv = static_cast<float>(1.0 / std::fabs(scale));
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* row = body + r * width * nch * 4;
    const int64_t oy = height - 1 - r;
    for (int64_t x = 0; x < width; ++x)
      for (int c = 0; c < nch; ++c) {
        const uint8_t* p = row + (x * nch + c) * 4;
        const uint32_t u = big_endian
            ? (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16)
                  | (uint32_t{p[2]} << 8) | p[3]
            : (uint32_t{p[3]} << 24) | (uint32_t{p[2]} << 16)
                  | (uint32_t{p[1]} << 8) | p[0];
        float v;
        std::memcpy(&v, &u, 4);
        out[(nch - 1 - c) * plane + oy * width + x] = round_sat(v * inv);
      }
  }
  return 0;
}
