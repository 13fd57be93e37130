// K3 — backward bilinear warp with replicate-clamped corners plus the
// in-bounds mask (image_warp, opticalflow_aux.c:33-75).
//
// Replaces: of_dis_tpu/ops/tv.py::warp_image_banded_pallas (used at the
// finest op-2 level) and ::_warp_coeffs_pallas (the corner/weight/mask
// kernel of the MXU one-hot route at the coarser levels). One gather kernel
// covers both, at any displacement: the r=4/r=16 banded cascade, the
// one-hot route and their runtime fallbacks are TPU devices.
//
// Bound on an H100: bytes. Each output pixel reads its flow (8 B), four
// source corners per channel (L1/L2 hits for smooth flows) and writes the
// warped value and the mask; there are ~20 flops per pixel.
//
// Design:
// - A 3-D grid (x tiles, row bands, batch): every index comes from
//   blockIdx / threadIdx, with no integer division. A block covers a 2-D
//   tile of up to 128 x 8 pixels (32 x 8 at one pixel a thread; narrow
//   levels: fewer columns, more rows), so the corner rows its threads
//   gather share L1 lines. The batch is the grid's z; a call of more than
//   65,535 pairs (z's limit) launches once for each chunk of as many.
// - On large calls with widths that are a multiple of 4 (and 16-byte
//   aligned fields) each thread owns 4 consecutive pixels of a row: one
//   16-byte load each of wx and wy, one 16-byte store of the mask and of
//   every channel's output.
// - Every other call takes one pixel a thread: levels of fewer than
//   of_warp_vec_min_pixels() pixels (two full blocks of 4-pixel threads on
//   every SM; op-2's coarser levels, the small batches), where with four
//   the grid leaves most SMs idle and each warp runs four pixels' work in a
//   row (the H100 measured them 0.1-0.8 us slower there, PERF.md), and the
//   ragged widths and unaligned fields, which no call of the path has.
// - The coefficients (corner offsets, fractions, mask) are computed once a
//   pixel and reused over the C channels; corners go through the read-only
//   path (__ldg). The lerp keeps the twin's four terms in their order, so
//   with --fmad=false it equals ops.tv.warp_image bit for bit.
// - A row origin (row0) and the source's own height (Hs) let a block of H
//   rows of a row-sharded level (parallel/spatial.py) sample the whole
//   frame: output row y samples at global row row0 + y, corners clamp to
//   [0, Hs - 1] and the mask to yy <= Hs - 1, as the JAX package's
//   spatial._warp_global does. A call of the whole frame (row0 = 0,
//   Hs = H, every call but a row-sharded level's) takes an instance
//   without them: with them the 4-pixel instance needs 80 registers in
//   place of 64 (3 blocks an SM in place of 4; capped at 64 it spills),
//   and its calls ran 20-30% longer on an H100 (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block

// kPix consecutive pixels a thread: 1, or 4 with 16-byte loads and stores;
// kRows: a block of rows of a taller source (row0, Hs), else the whole
// frame (row0 = 0, Hs = H, both unread)
template <int kPix, bool kRows>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ src, const float* __restrict__ wx,
                const float* __restrict__ wy, float* __restrict__ out,
                float* __restrict__ mask, int C, int H, int W, int row0,
                int Hs) {
  static_assert(kPix == 1 || kPix == 4, "one pixel or one vector");
  constexpr bool kVec = kPix == 4;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPix;
  if (y >= H || x0 >= W) return;
  const int b = blockIdx.z;
  const long long hw = static_cast<long long>(H) * W;
  const int hs = kRows ? Hs : H;
  const int gy = kRows ? row0 + y : y;
  // (b, y, x0) in the (B, H, W) fields; (y, x0) in an output plane
  const long long field = (static_cast<long long>(b) * H + y) * W + x0;
  const int in_plane = y * W + x0;

  float fx[kPix], fy[kPix];
  if constexpr (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(wx + field));
    const float4 c = __ldg(reinterpret_cast<const float4*>(wy + field));
    fx[0] = a.x; fx[1] = a.y; fx[2] = a.z; fx[3] = a.w;
    fy[0] = c.x; fy[1] = c.y; fy[2] = c.z; fy[3] = c.w;
  } else {
    fx[0] = __ldg(wx + field);
    fy[0] = __ldg(wy + field);
  }

  // per pixel: the four corners' offsets in a plane, the fractions, the
  // mask
  int o11[kPix], o12[kPix], o21[kPix], o22[kPix];
  float dx[kPix], dy[kPix], m[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float xx = static_cast<float>(x0 + k) + fx[k];
    const float yy = static_cast<float>(gy) + fy[k];
    m[k] = (xx >= 0.0f && xx <= static_cast<float>(W - 1) && yy >= 0.0f &&
            yy <= static_cast<float>(hs - 1))
               ? 1.0f
               : 0.0f;
    const float xf = floorf(xx), yf = floorf(yy);
    dx[k] = xx - xf;
    dy[k] = yy - yf;
    // clamp in float before the conversion so wild flows stay defined
    const int xi =
        static_cast<int>(fminf(fmaxf(xf, -1.0f), static_cast<float>(W)));
    const int yi =
        static_cast<int>(fminf(fmaxf(yf, -1.0f), static_cast<float>(hs)));
    const int x1 = min(max(xi, 0), W - 1), x2 = min(max(xi + 1, 0), W - 1);
    const int y1 = min(max(yi, 0), hs - 1), y2 = min(max(yi + 1, 0), hs - 1);
    o11[k] = y1 * W + x1;
    o12[k] = y1 * W + x2;
    o21[k] = y2 * W + x1;
    o22[k] = y2 * W + x2;
  }

  if constexpr (kVec) {
    *reinterpret_cast<float4*>(mask + field) =
        make_float4(m[0], m[1], m[2], m[3]);
  } else {
    mask[field] = m[0];
  }

  for (int c = 0; c < C; ++c) {
    const long long plane = (static_cast<long long>(b) * C + c) * hw;
    const float* s =
        src + (kRows ? (static_cast<long long>(b) * C + c) * hs * W : plane);
    float v[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float v11 = __ldg(s + o11[k]), v12 = __ldg(s + o12[k]);
      const float v21 = __ldg(s + o21[k]), v22 = __ldg(s + o22[k]);
      v[k] = v11 * (1.0f - dx[k]) * (1.0f - dy[k]) +
             v12 * dx[k] * (1.0f - dy[k]) + v21 * (1.0f - dx[k]) * dy[k] +
             v22 * dx[k] * dy[k];
    }
    float* o = out + plane + in_plane;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      o[0] = v[0];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

constexpr int kMaxDevices = 64;
constexpr int kMaxGridZ = 65535;

// The current device's SM count, read once per device.
int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) cached[dev] = sms;
  return sms;
}

}  // namespace

// The fewest pixels (B*H*W) of a call that take 4 pixels a thread: two full
// blocks of them on every SM of the current device.
extern "C" int of_warp_vec_min_pixels() {
  return 2 * sm_count() * kThreads * 4;
}

// C entry (bound with ctypes). src (B,C,Hs,W); out (B,C,H,W); wx, wy, mask
// (B,H,W); output row y samples at global row row0 + y of src. Returns the
// launch's cudaError_t.
extern "C" int of_warp(const float* src, const float* wx, const float* wy,
                       float* out, float* mask, int B, int C, int H, int W,
                       int row0, int Hs, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const bool vec =
      W % 4 == 0 && aligned16(wx) && aligned16(wy) && aligned16(out) &&
      aligned16(mask) &&
      static_cast<long long>(B) * H * W >= of_warp_vec_min_pixels();
  const bool rows = row0 != 0 || Hs != H;
  void (*kernel)(const float*, const float*, const float*, float*, float*,
                 int, int, int, int, int) =
      vec ? (rows ? warp_kernel<4, true> : warp_kernel<4, false>)
          : (rows ? warp_kernel<1, true> : warp_kernel<1, false>);
  const int pix = vec ? 4 : 1;
  // block: up to 32 threads across, the rest of 256 down, no taller than
  // the level
  const int groups = W / pix;  // threads a row (vec: W % 4 == 0)
  int bx = 1;
  while (bx < groups && bx < 32) bx *= 2;
  int by = 1;
  while (by < H && by < kThreads / bx) by *= 2;
  const dim3 block(bx, by);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hw = static_cast<long long>(H) * W;
  const long long hw_src = static_cast<long long>(Hs) * W;
  // chunks of at most kMaxGridZ pairs; a chunk's offset keeps the 16-byte
  // alignment of the vector route (W % 4 == 0)
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const dim3 grid((groups + bx - 1) / bx, (H + by - 1) / by,
                    std::min(B - b0, kMaxGridZ));
    const long long f = b0 * hw, p = f * C, ps = b0 * hw_src * C;
    kernel<<<grid, block, 0, s>>>(src + ps, wx + f, wy + f, out + p,
                                  mask + f, C, H, W, row0, Hs);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
