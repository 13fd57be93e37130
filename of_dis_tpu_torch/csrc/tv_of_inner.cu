// K2 — the TV (variational refinement) fixed-point loop of one pyramid
// level for optical flow, gray or RGB: n_inner x (smoothness weights ->
// robust data term -> sub_laplacian -> n_solver red-black coupled SOR
// sweeps), refine_variational.cpp:182-224.
//
// Replaces: of_dis_tpu/ops/tv.py::_of_inner_pallas_batched (and, with
// B = 1, _of_inner_pallas).
//
// Bound on an H100: per pair the loop touches 5 + 8 C (H, W) float fields once
// from device memory and does a few hundred flops per pixel per inner
// iteration; at DIS level sizes (up to 1024x448 at op-4) both the byte and
// the flop bound are microseconds. What bounds it is the chain of
// dependent stages: every stage needs its neighbours' results of the stage
// before, and every SOR colour needs the other colour's fresh values, so
// each inner iteration is 1 + 2 n_solver passes over the scratch, each
// behind a barrier; at op-4's level 0 the scratch of four pairs (66 MB)
// outgrows the 50 MB L2, and the passes stream it from device memory.
//
// Design: one launch per level, on one of two routes chosen by the
// caller from the level's shape (kernels/tv_of_inner.py:
// BLOCK_MAX_PIXELS, with the crossover measured on the H100):
// - the cooperative route (the rule from 1,024 pixels a pair on) fills
//   the card: the grid is as many 256-thread blocks as the device holds at
//   once (the occupancy of the instance times the SM count, read once per
//   device, no more than the pixels need), every pass grid-strides over the
//   B*H*W pixels of all pairs, and cooperative_groups' grid sync separates
//   the passes, so a 1024x448 level of four pairs spreads over every SM,
//   not four;
// - the block route (smaller pairs) keeps a pair on one 1,024-thread block,
//   passes separated by __syncthreads(): a grid-wide barrier costs more
//   than a pass over a few hundred pixels.
// Each inner iteration is 1 + 2 n_solver passes behind barriers. The first
// pass does what three did: the TV diffusivity (taken at the pixel and
// its four neighbours, so that the edge weights of the pixel and of its
// left and upper neighbours need no pass of their own), the edge weights,
// the robust data term, the sub-laplacian and the SOR terms hoisted out of
// the sweeps (omega / (a + wsum)); the first inner iteration reads the
// flow as uu / vv and du = dv = 0 and clears du, dv. Then the red-black
// SOR colours; the last one also writes uu = wx + du, vv = wy + dv of both
// colours. Every stage reads only what the barrier before it published.
// The per-pixel arithmetic is the twin's (ops/tv.py::_of_inner_loop,
// --fmad=false), so the kernel equals it bit for bit on either route.
// Fields live in a global scratch (9, B, H, W), field by field over all
// pairs, that the caller allocates: a field of pixel idx (flat over B*H*W)
// is at field * B*H*W + idx, its 4-neighbours at idx +-1 and idx +-W of
// the same pair. SOR updates du, then dv from the fresh du, in place per
// colour: every 4-neighbour of a red pixel is black, so the in-place sweep
// is race-free. Colour = (y + x + row_parity) % 2. The channel count C is
// a template parameter: C = 1 compiles the gray data term unchanged, C = 3
// the RGB one with the reference's two quirks (see data_rgb). Flat indices
// are 32-bit while every array's index fits and 64-bit beyond (kWide). A
// cooperative launch that the device refuses returns its error; there is
// no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kDataNorm = 0.010000000000000002f;   // 0.1^2
constexpr float kEps = 1e-6f;                         // 0.001^2
constexpr int kFields = 9;
constexpr int kCoopThreads = 256;    // threads a block, cooperative route
constexpr int kBlockThreads = 1024;  // threads a block (a pair), block route
constexpr int kMaxDevices = 64;

struct TVArgs {
  int H, W, n_inner, n_solver, row_parity, use_color;
  float quarter_alpha, hd3, hg3, omega, one_minus_omega;
};

// RGB data term at one pixel (compute_data, opticalflow_aux.c:408-594,
// SELECTCHANNEL==3): no x3 scaling. Kept as the run_OF_RGB binary has
// them: channel 0's colour term takes Iy of channel 1 (:496), and the
// gradient term's robust weight comes from channel 2 alone (:529, :538).
// I points at the pair's (8, 3, H, W) derivatives, i is the pixel.
__device__ __forceinline__ void data_rgb(const float* I, int HW, int i,
                                         float m, float u, float v,
                                         const TVArgs& a, float& A11,
                                         float& A12, float& A22, float& B1,
                                         float& B2) {
  float ix[3], iy[3], iz[3], ixx[3], ixy[3], iyy[3], ixz[3], iyz[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ix[c] = I[(0 * 3 + c) * HW + i];
    iy[c] = I[(1 * 3 + c) * HW + i];
    iz[c] = I[(2 * 3 + c) * HW + i];
    ixx[c] = I[(3 * 3 + c) * HW + i];
    ixy[c] = I[(4 * 3 + c) * HW + i];
    iyy[c] = I[(5 * 3 + c) * HW + i];
    ixz[c] = I[(6 * 3 + c) * HW + i];
    iyz[c] = I[(7 * 3 + c) * HW + i];
  }
  A11 = A12 = A22 = B1 = B2 = 0.0f;
  if (a.use_color) {
    float n[3], tsum = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      n[c] = kDataNorm + ix[c] * ix[c] + iy[c] * iy[c];
      const float t2 = iz[c] + ix[c] * u + iy[c] * v;
      tsum = tsum + t2 * t2 / n[c];
    }
    const float t = m * a.hd3 / sqrtf(kEps + tsum);
#pragma unroll
    for (int c = 2; c >= 0; --c) {
      const float iyu = c == 0 ? iy[1] : iy[c];
      const float t3 = t / n[c];
      const float tx = t3 * ix[c], ty = t3 * iyu;
      A11 = A11 + tx * ix[c];
      A12 = A12 + tx * iyu;
      A22 = A22 + ty * iyu;
      B1 = B1 - tx * iz[c];
      B2 = B2 - ty * iz[c];
    }
  }
  float nx[3], ny[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nx[c] = ixy[c] * ixy[c] + kDataNorm + ixx[c] * ixx[c];
    ny[c] = ixy[c] * ixy[c] + kDataNorm + iyy[c] * iyy[c];
  }
  const float t2 = ixz[2] + ixx[2] * u + ixy[2] * v;
  const float t3 = iyz[2] + ixy[2] * u + iyy[2] * v;
  const float tsum = t2 * t2 / nx[2] + t3 * t3 / ny[2];
  const float t = m * a.hg3 / sqrtf(kEps + tsum);
#pragma unroll
  for (int c = 2; c >= 0; --c) {
    const float tn2 = t / ny[c], tn1 = t / nx[c];
    A12 = A12 + (tn1 * ixx[c] + tn2 * iyy[c]) * ixy[c];
    B1 = B1 - tn1 * ixx[c] * ixz[c] - tn2 * ixy[c] * iyz[c];
    B2 = B2 - tn2 * iyy[c] * iyz[c] - tn1 * ixy[c] * ixz[c];
    A11 = A11 + tn1 * ixx[c] * ixx[c] + tn2 * ixy[c] * ixy[c];
    A22 = A22 + tn2 * iyy[c] * iyy[c] + tn1 * ixy[c] * ixy[c];
  }
}

template <bool kCoop>
__device__ __forceinline__ void barrier() {
  if constexpr (kCoop) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// TV diffusivity at (y, x) of the pair whose pixel (0, 0) is at `base`
// (compute_smoothness, opticalflow_aux.c:138-187): 3-tap central
// differences with replicate borders.
template <typename Index>
__device__ __forceinline__ float smoothness(const float* uu, const float* vv,
                                            Index base, int y, int x,
                                            const TVArgs& a) {
  const int W = a.W;
  const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
  const int yu = max(y - 1, 0), yd = min(y + 1, a.H - 1);
  const Index row = base + static_cast<Index>(y) * W;
  const Index up = base + static_cast<Index>(yu) * W + x;
  const Index down = base + static_cast<Index>(yd) * W + x;
  const float ux = 0.5f * (uu[row + xr] - uu[row + xl]);
  const float uy = 0.5f * (uu[down] - uu[up]);
  const float vx = 0.5f * (vv[row + xr] - vv[row + xl]);
  const float vy = 0.5f * (vv[down] - vv[up]);
  return a.quarter_alpha /
         sqrtf(kEps + ux * ux + uy * uy + vx * vx + vy * vy);
}

// The data term at pixel p of a pair (compute_data, opticalflow_aux.c:
// 408-594): gray with the x3 system scaling, RGB in data_rgb.
template <int C>
__device__ __forceinline__ void data_term(const float* I, int HW, int p,
                                          float m, float u, float v,
                                          const TVArgs& a, float& A11,
                                          float& A12, float& A22, float& B1,
                                          float& B2) {
  if constexpr (C == 1) {
    const float ix = I[p], iy = I[HW + p], iz = I[2 * HW + p];
    const float ixx = I[3 * HW + p], ixy = I[4 * HW + p];
    const float iyy = I[5 * HW + p], ixz = I[6 * HW + p];
    const float iyz = I[7 * HW + p];
    A11 = A12 = A22 = B1 = B2 = 0.0f;
    if (a.use_color) {
      const float t2 = iz + ix * u + iy * v;
      const float n1 = kDataNorm + ix * ix + iy * iy;
      const float tsum = t2 * t2 / n1;
      const float t = m * a.hd3 / sqrtf(kEps + 3.0f * tsum);
      const float t3 = t / n1;
      const float tx = t3 * ix, ty = t3 * iy;
      A11 = A11 + tx * ix;
      A12 = A12 + tx * iy;
      A22 = A22 + ty * iy;
      B1 = B1 - tx * iz;
      B2 = B2 - ty * iz;
    }
    const float t2 = ixz + ixx * u + ixy * v;
    const float t3 = iyz + ixy * u + iyy * v;
    const float xy2 = ixy * ixy;
    const float n1 = xy2 + kDataNorm + ixx * ixx;
    const float n2 = xy2 + kDataNorm + iyy * iyy;
    const float tsum = t2 * t2 / n1 + t3 * t3 / n2;
    const float t = m * a.hg3 / sqrtf(kEps + 3.0f * tsum);
    const float tn2 = t / n2, tn1 = t / n1;
    A12 = A12 + (tn1 * ixx + tn2 * iyy) * ixy;
    B1 = B1 - tn1 * ixx * ixz - tn2 * ixy * iyz;
    B2 = B2 - tn2 * iyy * iyz - tn1 * ixy * ixz;
    A11 = A11 + tn1 * ixx * ixx + tn2 * xy2;
    A22 = A22 + tn2 * iyy * iyy + tn1 * xy2;
    A11 = 3.0f * A11;
    A12 = 3.0f * A12;
    A22 = 3.0f * A22;
    B1 = 3.0f * B1;
    B2 = 3.0f * B2;
  } else {
    data_rgb(I, HW, p, m, u, v, a, A11, A12, A22, B1, B2);
  }
}

// The fixed-point loop over the pixels [begin, end) (step `step`) of the
// flat (B, H, W) fields: all pairs on the cooperative route, one pair on
// the block route. `total` = B*H*W sizes the scratch's fields.
template <int C, bool kCoop, typename Index>
__device__ __forceinline__ void run_loop(
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ mask, const float* __restrict__ deriv,
    float* uu, float* vv, float* scratch, Index total, Index begin,
    Index end, Index step, const TVArgs& a) {
  const int H = a.H, W = a.W, HW = H * W;
  float* du = scratch;
  float* dv = scratch + total;
  float* wh = scratch + 2 * total;
  float* wv = scratch + 3 * total;
  float* om11 = scratch + 4 * total;  // omega / (a11 + wsum)
  float* a12 = scratch + 5 * total;
  float* om22 = scratch + 6 * total;  // omega / (a22 + wsum)
  float* b1 = scratch + 7 * total;
  float* b2 = scratch + 8 * total;

  if (a.n_inner == 0) {
    for (Index i = begin; i < end; i += step) {
      uu[i] = wx[i];
      vv[i] = wy[i];
    }
  }
  for (int inner = 0; inner < a.n_inner; ++inner) {
    // the flow so far: uu = wx + du (the first iteration: wx, du = 0)
    const float* su = inner == 0 ? wx : uu;
    const float* sv = inner == 0 ? wy : vv;
    // 1. diffusivity, edge weights, data term, sub_laplacian
    //    (opticalflow_aux.c:138-223, 408-594), hoisted SOR terms
    for (Index i = begin; i < end; i += step) {
      const Index b = i / HW;
      const int p = static_cast<int>(i - b * HW);
      const int y = p / W, x = p - (p / W) * W;
      const Index base = b * HW;
      const float sc = smoothness(su, sv, base, y, x, a);
      const float wh_i =
          x < W - 1 ? sc + smoothness(su, sv, base, y, x + 1, a) : 0.0f;
      const float wv_i =
          y < H - 1 ? sc + smoothness(su, sv, base, y + 1, x, a) : 0.0f;
      const float whl =
          x > 0 ? smoothness(su, sv, base, y, x - 1, a) + sc : 0.0f;
      const float wvu =
          y > 0 ? smoothness(su, sv, base, y - 1, x, a) + sc : 0.0f;
      float u = 0.0f, v = 0.0f;
      if (inner == 0) {
        du[i] = 0.0f;
        dv[i] = 0.0f;
      } else {
        u = du[i];
        v = dv[i];
      }
      float A11, A12, A22, B1, B2;
      data_term<C>(deriv + b * 8 * C * HW, HW, p, mask[i], u, v, a, A11,
                   A12, A22, B1, B2);
      // b += div(w grad(w_xy)) (sub_laplacian, opticalflow_aux.c:194-223)
      const float* src[2] = {wx, wy};
      float bb[2] = {B1, B2};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* f = src[c];
        const float fr = x < W - 1 ? f[i + 1] : 0.0f;
        const float fd = y < H - 1 ? f[i + W] : 0.0f;
        const float th = wh_i * (fr - f[i]);
        const float thl = x > 0 ? whl * (f[i] - f[i - 1]) : 0.0f;
        const float tv = wv_i * (fd - f[i]);
        const float tvu = y > 0 ? wvu * (f[i] - f[i - W]) : 0.0f;
        float r = bb[c];
        r = r + th - thl;
        r = r + tv - tvu;
        bb[c] = r;
      }
      const float wsum = wvu + whl + wv_i + wh_i;
      wh[i] = wh_i;
      wv[i] = wv_i;
      om11[i] = a.omega / (A11 + wsum);
      a12[i] = A12;
      om22[i] = a.omega / (A22 + wsum);
      b1[i] = bb[0];
      b2[i] = bb[1];
    }
    barrier<kCoop>();

    // 2. coupled red-black SOR (sor_coupled_rb; solver.c:34-78 order
    //    within a pixel: du, then dv from the fresh du); the last colour of
    //    the last sweep writes uu, vv of every pixel
    for (int it = 0; it < a.n_solver; ++it) {
      for (int colour = 0; colour < 2; ++colour) {
        const bool last = it == a.n_solver - 1 && colour == 1;
        for (Index i = begin; i < end; i += step) {
          const int p = static_cast<int>(i % HW);
          const int y = p / W, x = p - (p / W) * W;
          if (((y + x + a.row_parity) & 1) != colour) {
            if (last) {
              uu[i] = wx[i] + du[i];
              vv[i] = wy[i] + dv[i];
            }
            continue;
          }
          const float upw = y > 0 ? wv[i - W] : 0.0f;
          const float lfw = x > 0 ? wh[i - 1] : 0.0f;
          const float duu = y > 0 ? du[i - W] : 0.0f;
          const float dul = x > 0 ? du[i - 1] : 0.0f;
          const float dud = y < H - 1 ? du[i + W] : 0.0f;
          const float dur = x < W - 1 ? du[i + 1] : 0.0f;
          const float dvu = y > 0 ? dv[i - W] : 0.0f;
          const float dvl = x > 0 ? dv[i - 1] : 0.0f;
          const float dvd = y < H - 1 ? dv[i + W] : 0.0f;
          const float dvr = x < W - 1 ? dv[i + 1] : 0.0f;
          const float b1n = b1[i] + (upw * duu + lfw * dul + wv[i] * dud +
                                     wh[i] * dur);
          const float b2n = b2[i] + (upw * dvu + lfw * dvl + wv[i] * dvd +
                                     wh[i] * dvr);
          const float u0 = du[i], v0 = dv[i], c12 = a12[i];
          const float u1 = a.one_minus_omega * u0 + om11[i] * (b1n - c12 * v0);
          const float v1 = a.one_minus_omega * v0 + om22[i] * (b2n - c12 * u1);
          du[i] = u1;
          dv[i] = v1;
          if (last) {
            uu[i] = wx[i] + u1;
            vv[i] = wy[i] + v1;
          }
        }
        if (!(last && inner == a.n_inner - 1)) barrier<kCoop>();
      }
    }
    if (a.n_solver == 0) {
      for (Index i = begin; i < end; i += step) {
        uu[i] = wx[i] + du[i];
        vv[i] = wy[i] + dv[i];
      }
      if (inner < a.n_inner - 1) barrier<kCoop>();
    }
  }
}

// Cooperative route: the grid strides over all pixels of all pairs.
template <int C, bool kWide>
__global__ void __launch_bounds__(kCoopThreads)
    tv_of_inner_coop(const float* __restrict__ wx,
                     const float* __restrict__ wy,
                     const float* __restrict__ mask,
                     const float* __restrict__ deriv, float* uu, float* vv,
                     float* scratch, int B, TVArgs a) {
  using Index = typename std::conditional<kWide, long long, int>::type;
  const Index total = static_cast<Index>(B) * a.H * a.W;
  const Index first =
      static_cast<Index>(blockIdx.x) * kCoopThreads + threadIdx.x;
  const Index stride = static_cast<Index>(gridDim.x) * kCoopThreads;
  run_loop<C, true, Index>(wx, wy, mask, deriv, uu, vv, scratch, total,
                           first, total, stride, a);
}

// Block route: block b runs pairs b, b + gridDim.x, ... alone.
template <int C, bool kWide>
__global__ void __launch_bounds__(kBlockThreads)
    tv_of_inner_block(const float* __restrict__ wx,
                      const float* __restrict__ wy,
                      const float* __restrict__ mask,
                      const float* __restrict__ deriv, float* uu, float* vv,
                      float* scratch, int B, TVArgs a) {
  using Index = typename std::conditional<kWide, long long, int>::type;
  const Index HW = static_cast<Index>(a.H) * a.W;
  const Index total = static_cast<Index>(B) * HW;
  for (Index b = blockIdx.x; b < B; b += gridDim.x) {
    run_loop<C, false, Index>(wx, wy, mask, deriv, uu, vv, scratch, total,
                              b * HW + threadIdx.x, (b + 1) * HW,
                              static_cast<Index>(kBlockThreads), a);
    __syncthreads();  // the next pair's first pass reuses no field
  }
}

template <int C, bool kWide>
cudaError_t launch(const float* wx, const float* wy, const float* mask,
                   const float* deriv, float* uu, float* vv, float* scratch,
                   int B, bool cooperative, const TVArgs& a, cudaStream_t s) {
  if (!cooperative) {
    tv_of_inner_block<C, kWide><<<static_cast<unsigned>(B), kBlockThreads, 0,
                                  s>>>(wx, wy, mask, deriv, uu, vv, scratch,
                                       B, a);
    return cudaGetLastError();
  }
  auto kernel = tv_of_inner_coop<C, kWide>;
  // blocks the device holds at once, read once per device
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int blocks = dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kCoopThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    blocks = per_sm * sms;
    if (dev < kMaxDevices) resident[dev] = blocks;
  }
  const long long total = static_cast<long long>(B) * a.H * a.W;
  const long long need = (total + kCoopThreads - 1) / kCoopThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(std::min<long long>(blocks, need)));
  cfg.blockDim = dim3(kCoopThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, wx, wy, mask, deriv, uu, vv, scratch,
                         B, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* wx, const float* wy, const float* mask,
                     const float* deriv, float* uu, float* vv, float* scratch,
                     int B, bool cooperative, const TVArgs& a,
                     cudaStream_t s) {
  // the largest flat index, of the scratch (9 fields) or the derivatives
  // (8 C), must fit 31 bits
  if (std::max<long long>(kFields, 8LL * C) * B * a.H * a.W < (1LL << 31))
    return launch<C, false>(wx, wy, mask, deriv, uu, vv, scratch, B,
                            cooperative, a, s);
  return launch<C, true>(wx, wy, mask, deriv, uu, vv, scratch, B,
                         cooperative, a, s);
}

}  // namespace

// C entry (bound with ctypes). wx, wy, mask (B,H,W); deriv (B,8,C,H,W) in
// the order ix, iy, iz, ixx, ixy, iyy, ixz, iyz, C = 1 or 3; outputs uu, vv
// (B,H,W); scratch (9,B,H,W); cooperative 1 for the cooperative route, 0
// for the block route. Returns the launch's cudaError_t.
extern "C" int of_tv_of_inner(const float* wx, const float* wy,
                              const float* mask, const float* deriv,
                              float* uu, float* vv, float* scratch, int B,
                              int C, int H, int W, int n_inner, int n_solver,
                              int row_parity, int use_color,
                              float quarter_alpha, float hd3, float hg3,
                              float omega, float one_minus_omega,
                              int cooperative, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  TVArgs a{H,     W,   n_inner, n_solver, row_parity,      use_color,
           quarter_alpha, hd3, hg3,     omega,    one_minus_omega};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return static_cast<int>(
        dispatch<1>(wx, wy, mask, deriv, uu, vv, scratch, B,
                    cooperative != 0, a, s));
  if (C == 3)
    return static_cast<int>(
        dispatch<3>(wx, wy, mask, deriv, uu, vv, scratch, B,
                    cooperative != 0, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The single-pair entry (K2'): of_tv_of_inner at B = 1, a C entry of its
// own so that its launches are counted apart from the batched ones.
extern "C" int of_tv_of_inner_single(
    const float* wx, const float* wy, const float* mask, const float* deriv,
    float* uu, float* vv, float* scratch, int B, int C, int H, int W,
    int n_inner, int n_solver, int row_parity, int use_color,
    float quarter_alpha, float hd3, float hg3, float omega,
    float one_minus_omega, int cooperative, void* stream) {
  return of_tv_of_inner(wx, wy, mask, deriv, uu, vv, scratch, B, C, H, W,
                        n_inner, n_solver, row_parity, use_color,
                        quarter_alpha, hd3, hg3, omega, one_minus_omega,
                        cooperative, stream);
}
