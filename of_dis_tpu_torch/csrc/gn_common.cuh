// Device functions shared by the Gauss-Newton kernels, K1 (gn_fused.cu,
// templates read from global memory) and K6 (gn_tiled.cu, templates built
// in the kernel), and by the per-stage ablation T2 (gn_stages.cu), which
// runs each GN kernel's extraction on its own layout:
//  - the lane layout (K1): one warp owns one patch; lane l holds the
//    pixels l + 32k of the patch, k < K, with all C channels of each
//    (`warp_sum`, `taps`, `lerp`, `lane_pixels`, `lane_taps`);
//  - the column layout (K6): a segment of S lanes owns one patch; lane i
//    of the segment holds column i of the patch's window (`seg_sum`,
//    `lane_total`, `window_cols`, `lerp_cols`, `cols_patch`).

#pragma once

#include <cuda_runtime.h>

namespace gn {

constexpr unsigned kFull = 0xffffffffu;
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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

// This lane's pixels lane + 32k, k < K, of a psz x psz patch: whether
// each lies in the patch, and its offset j * W + i from the window's
// corner in planes of row length W (0 for a pixel beyond psz^2). Computed
// once, before the trips.
template <int K>
__device__ __forceinline__ void lane_pixels(int psz, int W, int lane,
                                            int (&off)[K],
                                            bool (&valid)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    valid[k] = d < psz * psz;
    const int j = d / psz, i = d - (d / psz) * psz;
    off[k] = valid[k] ? j * W + i : 0;
  }
}

// The four bilinear taps of this lane's pixels (`taps`'s values): a
// window inside the (C, H, W) planes is read at the pixels' offsets `off`
// (`lane_pixels` with row length W) from its corner without clamps; a
// border window takes `taps`, which clamps.
template <int K, int C, typename T>
__device__ __forceinline__ void lane_taps(const T* im, int H, int W, int sx,
                                          int sy, int psz, int lane,
                                          float scale, const int (&off)[K],
                                          const bool (&valid)[K],
                                          float (&v00)[K * C],
                                          float (&v01)[K * C],
                                          float (&v10)[K * C],
                                          float (&v11)[K * C]) {
  if (sx >= 0 && sy >= 0 && sx + psz < W && sy + psz < H) {
    const T* corner = im + sy * W + sx;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = k * C + c;
        v00[e] = v01[e] = v10[e] = v11[e] = 0.0f;
        if (valid[k]) {
          const T* p = corner + c * H * W + off[k];
          v00[e] = to_f32(p[0], scale);
          v01[e] = to_f32(p[1], scale);
          v10[e] = to_f32(p[W], scale);
          v11[e] = to_f32(p[W + 1], scale);
        }
      }
    }
  } else {
    taps<K, C>(im, H, W, sx, sy, psz, lane, scale, v00, v01, v10, v11);
  }
}

// Sum over the S lanes of a patch's segment: a butterfly, offsets S/2 .. 1
// (every lane of the segment ends with the same bits).
template <int S>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A lane's elements (row j < psz, channel c) added in that order, from the
// first element; 0 on a lane without a column (col >= psz), whatever its
// elements hold.
template <int R, int C>
__device__ __forceinline__ float lane_total(const float (&v)[R * C],
                                            int psz, bool valid_col) {
  float s = v[0];
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((j > 0 || c > 0) && j < psz) s = s + v[j * C + c];
    }
  }
  return valid_col ? s : 0.0f;
}

// Column `col` of the (psz+1)^2 bilinear window whose corner is the
// integer anchor (sx, sy) of the (C, H, W) planes `im`, one load a row and
// channel: win[r * C + c] is row sy + r, column sx + col (the column
// clamped to the planes, the rows too where the window crosses their top
// or bottom), 0 for r > psz or col > psz. A window inside the planes' rows
// (all but the border patches) needs no row clamps: one offset a row (13%
// of K6's level-0 time on an NVIDIA H100 at 700 W, PERF.md). `im` may
// point to global or shared memory; 16-bit planes convert as `to_f32`.
template <int R, int C, typename T>
__device__ __forceinline__ void window_cols(const T* im, int H, int W,
                                            int psz, int sx, int sy, int col,
                                            float scale,
                                            float (&win)[(R + 1) * C]) {
  const int plane = H * W;
  const int xc = min(max(sx + col, 0), W - 1);
  const bool loads = col <= psz;
  if (sy >= 0 && sy + psz < H) {
    const T* top = im + sy * W + xc;
#pragma unroll
    for (int r = 0; r <= R; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        win[r * C + c] =
            loads && r <= psz ? to_f32(top[c * plane + r * W], scale) : 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const int yr = min(max(sy + r, 0), H - 1);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        win[r * C + c] = loads && r <= psz
                             ? to_f32(im[c * plane + yr * W + xc], scale)
                             : 0.0f;
      }
    }
  }
}

// Bilinear interpolation of the window's columns with residuals (rx, ry)
// (patch.cpp:346-413): the y-lerp of each row pair in registers, then the
// x-lerp with lane col + 1's y-lerp, taken with one shuffle — `lerp`'s
// operations in its order. out[j * C + c] is pixel (j, col), channel c,
// where col < psz and j < psz; elsewhere a finite value that the sums
// leave out. Every lane of the warp takes part.
template <int R, int C>
__device__ __forceinline__ void lerp_cols(const float (&win)[(R + 1) * C],
                                          float rx, float ry,
                                          float (&out)[R * C]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float g = (1.0f - ry) * win[j * C + c] + ry * win[(j + 1) * C + c];
      const float gr = __shfl_down_sync(kFull, g, 1);
      out[j * C + c] = rx * gr + (1.0f - rx) * g;
    }
  }
}

// Column `col` of the bilinear psz x psz patch at integer anchor (sx, sy)
// with residuals (rx, ry): `window_cols`, then `lerp_cols`.
template <int R, int C, typename T>
__device__ __forceinline__ void cols_patch(const T* im, int H, int W,
                                           int psz, int sx, int sy, float rx,
                                           float ry, int col, float scale,
                                           float (&out)[R * C]) {
  float win[(R + 1) * C];
  window_cols<R, C>(im, H, W, psz, sx, sy, col, scale, win);
  lerp_cols<R, C>(win, rx, ry, out);
}

}  // namespace gn
