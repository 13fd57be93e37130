// Device functions shared by the two Gauss-Newton kernels: K1
// (gn_fused.cu, templates read from global memory) and K6 (gn_tiled.cu,
// templates built in the kernel). One warp owns one patch; lane l holds the
// pixels l + 32k of the patch, k < K, with all C channels of each.

#pragma once

#include <cuda_runtime.h>

namespace gn {

constexpr float kMinErrVal = 2.0f;   // MINERRVAL (oflow.h:76)
constexpr float kHuberBsq = 25.0f;   // NORMOUTLIER^2 (oflow.h:77)

struct GNArgs {
  int B, N, Hp, Wp, psz, pad, max_iter, min_iter, costfct, patnorm, nop,
      camlr;
  float tmp_lb, tmp_ubw, tmp_ubh, outlier, res_thresh, dp_thresh_sq,
      dr_thresh, novals;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Residual transform + weight per cost function (patch.cpp:221-273).
__device__ __forceinline__ void loss(float diff, int cost, float& pd,
                                     float& pw) {
  if (cost == 0) {
    pd = diff;
    pw = fabsf(diff);
  } else if (cost == 1) {
    float w = sqrtf(fabsf(diff));
    pw = w;
    pd = diff >= 0.0f ? w : -w;
  } else if (cost == 2) {
    float w = sqrtf(50.0f * (sqrtf(1.0f + diff * diff / kHuberBsq) - 1.0f));
    pw = w;
    pd = diff >= 0.0f ? w : -w;
  } else {
    pd = 0.0f;
    pw = 0.0f;
  }
}

__device__ __forceinline__ bool out_of_bounds(float x, float y,
                                              const GNArgs& a) {
  return x < a.tmp_lb || y < a.tmp_lb || x > a.tmp_ubw || y > a.tmp_ubh;
}

// Bilinear patch at float position (x, y) (patch.cpp:346-413): anchor
// ceil(pt + 1e-5), residual against floor(pt); y-lerp then x-lerp. im is
// the pair's (C, Hp, Wp) target planes; out[k * C + c] is channel c of
// pixel lane + 32k.
template <int K, int C>
__device__ __forceinline__ void extract(const float* im, float x, float y,
                                        int lane, const GNArgs& a,
                                        float (&out)[K * C]) {
  const int p_tot = a.psz * a.psz;
  const int plane = a.Hp * a.Wp;
  const float rx = x - floorf(x);
  const float ry = y - floorf(y);
  const int sx = static_cast<int>(ceilf(x + 1e-5f)) - a.psz / 2 - 1 + a.pad;
  const int sy = static_cast<int>(ceilf(y + 1e-5f)) - a.psz / 2 - 1 + a.pad;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    const bool valid = d < p_tot;
    const int j = d / a.psz, i = d - (d / a.psz) * a.psz;
    const int y0 = min(max(sy + j, 0), a.Hp - 1);
    const int y1 = min(max(sy + j + 1, 0), a.Hp - 1);
    const int x0 = min(max(sx + i, 0), a.Wp - 1);
    const int x1 = min(max(sx + i + 1, 0), a.Wp - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[k * C + c] = 0.0f;
      if (valid) {
        const float* pc = im + c * plane;
        const float v00 = pc[y0 * a.Wp + x0], v01 = pc[y0 * a.Wp + x1];
        const float v10 = pc[y1 * a.Wp + x0], v11 = pc[y1 * a.Wp + x1];
        const float g0 = (1.0f - ry) * v00 + ry * v10;
        const float g1 = (1.0f - ry) * v01 + ry * v11;
        out[k * C + c] = rx * g1 + (1.0f - rx) * g0;
      }
    }
  }
}

}  // namespace gn
