// The gray rules cv::imread applies to 8-bit B, G, R pixels, for the host
// decoders of csrc/io_native.cpp (PNM, BMP), csrc/raster.cpp,
// csrc/webp.cpp and csrc/jpeg.cpp (CMYK).

#ifndef OF_DIS_TPU_TORCH_CSRC_GRAY_H_
#define OF_DIS_TPU_TORCH_CSRC_GRAY_H_

#include <cstdint>

namespace {

// OpenCV's image readers' fixed-point BGR2GRAY (icvCvt_BGR2Gray_8u_C3C1R):
// 0.114 B + 0.587 G + 0.299 R in units of 2^-14, rounded.
inline uint8_t bgr2gray(int b, int g, int r) {
  return static_cast<uint8_t>((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14);
}

// OpenCV 5's cvtColor BGR2GRAY on 8-bit pixels: the same weights in units
// of 2^-15, rounded (where a reader decodes colour and cv::imread then
// converts it: WebP, Radiance HDR).
inline uint8_t cvt_gray(int b, int g, int r) {
  return static_cast<uint8_t>((b * 3735 + g * 19235 + r * 9798 + 16384)
                              >> 15);
}

// OpenCV's CMYK to BGR for a 4-component JPEG (icvCvt_CMYK2BGR_8u_C4C3R;
// C gives R, M G, Y B), to gray the same, then bgr2gray
// (icvCvt_CMYK2Gray_8u_C4C1R): one channel v under black k.
inline int cmyk_channel(int v, int k) { return k - (((255 - v) * k) >> 8); }

}  // namespace

#endif  // OF_DIS_TPU_TORCH_CSRC_GRAY_H_
