// Device functions shared by the Gauss-Newton kernels, K1 (gn_fused.cu,
// templates read from global memory) and K6 (gn_tiled.cu, templates built
// in the kernel), and by the per-stage ablation T2 (gn_stages.cu), which
// times `taps` and `lerp` as K1 runs them on a border window. K6 takes the
// arguments, the loss and the bounds test from here and keeps its own
// extraction (lanes on window columns). In `warp_sum`, `taps` and `lerp`
// one warp owns one patch; lane l holds the pixels l + 32k of the patch,
// k < K, with all C channels of each.

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

// A plane element as float: float planes as they are, 16-bit integer
// planes (value * 2^e, exact) times `scale` = 2^-e, which is exact too.
__device__ __forceinline__ float to_f32(float v, float) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v, float scale) {
  return static_cast<float>(v) * scale;
}

// The four bilinear taps of pixel lane + 32k, k < K, of a psz x psz patch
// whose (psz+1)^2 window starts at the integer anchor (sx, sy) of the
// (C, H, W) planes `im`, indices clamped to the planes: v00 / v01 at rows
// sy + j, columns sx + i / sx + i + 1, v10 / v11 one row below. Element
// k * C + c is channel c; pixels beyond psz^2 hold 0. `im` may point to
// global or shared memory. All loads come before any use: written per
// pixel, each lerp between its loads and the next pixel's, the large-level
// GN kernel ran 20% slower on an H100 (PERF.md, T2).
template <int K, int C, typename T>
__device__ __forceinline__ void taps(const T* im, int H, int W, int sx,
                                     int sy, int psz, int lane, float scale,
                                     float (&v00)[K * C], float (&v01)[K * C],
                                     float (&v10)[K * C],
                                     float (&v11)[K * C]) {
  const int plane = H * W;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    const bool valid = d < psz * psz;
    const int j = d / psz, i = d - (d / psz) * psz;
    const int y0 = min(max(sy + j, 0), H - 1);
    const int y1 = min(max(sy + j + 1, 0), H - 1);
    const int x0 = min(max(sx + i, 0), W - 1);
    const int x1 = min(max(sx + i + 1, 0), W - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = k * C + c;
      v00[e] = v01[e] = v10[e] = v11[e] = 0.0f;
      if (valid) {
        const T* pc = im + c * plane;
        v00[e] = to_f32(pc[y0 * W + x0], scale);
        v01[e] = to_f32(pc[y0 * W + x1], scale);
        v10[e] = to_f32(pc[y1 * W + x0], scale);
        v11[e] = to_f32(pc[y1 * W + x1], scale);
      }
    }
  }
}

// Bilinear interpolation of the taps with residuals (rx, ry): the y-lerp
// of each column pair, then the x-lerp (patch.cpp:346-413). Taps of 0
// give 0.
template <int E>
__device__ __forceinline__ void lerp(const float (&v00)[E],
                                     const float (&v01)[E],
                                     const float (&v10)[E],
                                     const float (&v11)[E], float rx,
                                     float ry, float (&out)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float g0 = (1.0f - ry) * v00[e] + ry * v10[e];
    const float g1 = (1.0f - ry) * v01[e] + ry * v11[e];
    out[e] = rx * g1 + (1.0f - rx) * g0;
  }
}

}  // namespace gn
