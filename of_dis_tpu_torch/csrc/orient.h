// EXIF orientation for the host decoders (csrc/jpeg.cpp, csrc/webp.cpp):
// a decoded plane turned as OpenCV's ApplyExifOrientation turns it, which
// cv::imread applies to a JPEG's and a WebP's pixels alike.

#ifndef OF_DIS_TPU_TORCH_CSRC_ORIENT_H_
#define OF_DIS_TPU_TORCH_CSRC_ORIENT_H_

#include <cstdint>
#include <cstring>

namespace {

// out[y][x] = src[base + y * sy + x * sx] over the oriented (oh, ow)
// grid: OpenCV's ApplyExifOrientation (1 identity, 2 flip left-right,
// 3 rotate 180, 4 flip up-down, 5 transpose, 6 transpose + flip
// left-right, 7 transpose + both flips, 8 transpose + flip up-down).
void orient_copy(const uint8_t* src, int stride, int w, int h, int o,
                 uint8_t* out) {
  const int64_t S = stride, W1 = w - 1, H1 = h - 1;
  int64_t base = 0, sy = S, sx = 1;
  int ow = w, oh = h;
  switch (o) {
    case 2: base = W1; sx = -1; break;
    case 3: base = H1 * S + W1; sy = -S; sx = -1; break;
    case 4: base = H1 * S; sy = -S; break;
    case 5: base = 0; sy = 1; sx = S; break;
    case 6: base = H1 * S; sy = 1; sx = -S; break;
    case 7: base = H1 * S + W1; sy = -1; sx = -S; break;
    case 8: base = W1; sy = -1; sx = S; break;
    default: break;
  }
  if (o >= 5 && o <= 8) {
    ow = h;
    oh = w;
  }
  for (int y = 0; y < oh; ++y) {
    const uint8_t* s = src + base + y * sy;
    uint8_t* d = out + static_cast<size_t>(y) * ow;
    if (sx == 1) {
      std::memcpy(d, s, static_cast<size_t>(ow));
    } else {
      for (int x = 0; x < ow; ++x) d[x] = s[x * sx];
    }
  }
}

}  // namespace

#endif  // OF_DIS_TPU_TORCH_CSRC_ORIENT_H_
