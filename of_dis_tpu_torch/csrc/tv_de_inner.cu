// K5 — the TV (variational refinement) fixed-point loop of one pyramid
// level for depth from stereo (one unknown, the horizontal disparity),
// gray or RGB: n_inner x (smoothness weights of (uu, 0) -> robust depth
// data term -> sub_laplacian on wx -> n_solver red-black SOR sweeps ->
// uu = wx + du clamped to the camera's sign),
// refine_variational.cpp:251-342.
//
// Replaces: of_dis_tpu/ops/tv.py::_de_inner_pallas_batched (and, with
// B = 1, _de_inner_pallas).
//
// Bound on an H100: per pair the loop touches 3 + 8 C (H, W) float fields
// once from device memory and does ~100-200 flops per pixel per inner
// iteration; at DIS level sizes (at most 56x128 at op-2) both bounds are
// microseconds. As for the flow kernel, what bounds it is the chain of
// dependent stages separated by block barriers.
//
// Design: the flow kernel's (tv_of_inner.cu), cut to one unknown. One
// thread block per stereo pair runs the whole loop with __syncthreads()
// between stages; six (H, W) scratch fields per pair in global memory
// (du, sm, wh, wv, om11, b1) stay in L1/L2. The in-place red-black sweep
// is race-free: every 4-neighbour of a red pixel is black. Colour =
// (y + x + row_parity) % 2. The sign clamp acts on uu only — du stays
// unclamped, and the next inner iteration's smoothness reads the clamped
// uu. The channel count C is a template parameter (1 gray, 3 RGB).

#include <cuda_runtime.h>

namespace {

constexpr float kDataNorm = 0.010000000000000002f;   // 0.1^2
constexpr float kEps = 1e-6f;                         // 0.001^2
constexpr int kFields = 6;
constexpr int kThreads = 1024;

struct DEArgs {
  int H, W, n_inner, n_solver, row_parity, use_color, camlr;
  float quarter_alpha, hd3, hg3, omega, one_minus_omega;
};

// Depth data term at pixel i (compute_data_DE, opticalflow_aux.c:601-747).
// I points at the pair's (8, C, H, W) derivatives in the order ix, iy, iz,
// ixx, ixy, iyy, ixz, iyz. Gray carries the x3 system scaling and 3*tsum
// inside the square roots; RGB has neither and accumulates both robust
// weights over all three channels.
template <int C>
__device__ __forceinline__ void data_de(const float* I, int HW, int i,
                                        float m, float u, const DEArgs& a,
                                        float& A11, float& B1) {
  float ix[C], iy[C], iz[C], ixx[C], ixy[C], iyy[C], ixz[C], iyz[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ix[c] = I[(0 * C + c) * HW + i];
    iy[c] = I[(1 * C + c) * HW + i];
    iz[c] = I[(2 * C + c) * HW + i];
    ixx[c] = I[(3 * C + c) * HW + i];
    ixy[c] = I[(4 * C + c) * HW + i];
    iyy[c] = I[(5 * C + c) * HW + i];
    ixz[c] = I[(6 * C + c) * HW + i];
    iyz[c] = I[(7 * C + c) * HW + i];
  }
  A11 = 0.0f;
  B1 = 0.0f;
  if constexpr (C == 1) {
    if (a.use_color) {
      const float t2 = iz[0] + ix[0] * u;
      const float n1 = kDataNorm + iy[0] * iy[0] + ix[0] * ix[0];
      const float tsum = t2 * t2 / n1;
      const float t = m * a.hd3 / sqrtf(kEps + 3.0f * tsum);
      const float tx = (t / n1) * ix[0];
      A11 = A11 + tx * ix[0];
      B1 = B1 - tx * iz[0];
    }
    const float xy2 = ixy[0] * ixy[0] + kDataNorm;
    const float n1 = xy2 + ixx[0] * ixx[0];
    const float n2 = xy2 + iyy[0] * iyy[0];
    const float t2y = iyz[0] + ixy[0] * u;
    const float t2x = ixz[0] + ixx[0] * u;
    const float tsum = t2y * t2y / n2 + t2x * t2x / n1;
    const float t = m * a.hg3 / sqrtf(kEps + 3.0f * tsum);
    const float t2 = (t / n2) * ixy[0];
    const float t3 = (t / n1) * ixx[0];
    A11 = A11 + t3 * ixx[0] + t2 * ixy[0];
    B1 = B1 - t3 * ixz[0] - t2 * iyz[0];
    A11 = 3.0f * A11;
    B1 = 3.0f * B1;
  } else {
    if (a.use_color) {
      float n[C], tsum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        n[c] = kDataNorm + iy[c] * iy[c] + ix[c] * ix[c];
        const float t2 = iz[c] + ix[c] * u;
        tsum = tsum + t2 * t2 / n[c];
      }
      const float t = m * a.hd3 / sqrtf(kEps + tsum);
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const float tx = (t / n[c]) * ix[c];
        A11 = A11 + tx * ix[c];
        B1 = B1 - tx * iz[c];
      }
    }
    float nx[C], ny[C], tsum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      nx[c] = ixy[c] * ixy[c] + kDataNorm + ixx[c] * ixx[c];
      ny[c] = ixy[c] * ixy[c] + kDataNorm + iyy[c] * iyy[c];
      const float t2y = iyz[c] + ixy[c] * u;
      const float t2x = ixz[c] + ixx[c] * u;
      tsum = tsum + t2y * t2y / ny[c] + t2x * t2x / nx[c];
    }
    const float t = m * a.hg3 / sqrtf(kEps + tsum);
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const float t2 = (t / ny[c]) * ixy[c];
      const float t3 = (t / nx[c]) * ixx[c];
      A11 = A11 + t3 * ixx[c] + t2 * ixy[c];
      B1 = B1 - t3 * ixz[c] - t2 * iyz[c];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    tv_de_inner_kernel(const float* wx_all, const float* mask_all,
                       const float* deriv_all, float* uu_all, float* scratch,
                       DEArgs a) {
  const int H = a.H, W = a.W, HW = H * W;
  const size_t b = blockIdx.x;
  const float* wx = wx_all + b * HW;
  const float* mask = mask_all + b * HW;
  const float* I = deriv_all + b * 8 * C * HW;
  float* uu = uu_all + b * HW;
  float* S = scratch + b * kFields * HW;
  float* du = S;
  float* sm = S + HW;
  float* wh = S + 2 * HW;
  float* wv = S + 3 * HW;
  float* om11 = S + 4 * HW;   // a11 until stage 3, then omega/(a11+wsum)
  float* b1 = S + 5 * HW;

  for (int i = threadIdx.x; i < HW; i += blockDim.x) {
    du[i] = 0.0f;
    uu[i] = wx[i];
  }
  __syncthreads();

  for (int inner = 0; inner < a.n_inner; ++inner) {
    // 1. TV diffusivity of (uu, 0) (compute_smoothness, opticalflow_aux.c:
    //    138-187): 3-tap central differences with replicate borders
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
      const int yu = max(y - 1, 0), yd = min(y + 1, H - 1);
      const float ux = 0.5f * (uu[y * W + xr] - uu[y * W + xl]);
      const float uy = 0.5f * (uu[yd * W + x] - uu[yu * W + x]);
      sm[i] = a.quarter_alpha / sqrtf(kEps + ux * ux + uy * uy);
    }
    __syncthreads();

    // 2. edge weights + depth data term
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      wh[i] = x < W - 1 ? sm[i] + sm[i + 1] : 0.0f;
      wv[i] = y < H - 1 ? sm[i] + sm[i + W] : 0.0f;
      float A11, B1;
      data_de<C>(I, HW, i, mask[i], du[i], a, A11, B1);
      om11[i] = A11;
      b1[i] = B1;
    }
    __syncthreads();

    // 3. b1 += div(w grad(wx)) (sub_laplacian, opticalflow_aux.c:194-223)
    //    and the SOR term hoisted out of the sweeps
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      const float whl = x > 0 ? wh[i - 1] : 0.0f;
      const float wvu = y > 0 ? wv[i - W] : 0.0f;
      const float fr = x < W - 1 ? wx[i + 1] : 0.0f;
      const float fd = y < H - 1 ? wx[i + W] : 0.0f;
      const float th = wh[i] * (fr - wx[i]);
      const float thl = x > 0 ? whl * (wx[i] - wx[i - 1]) : 0.0f;
      const float tv = wv[i] * (fd - wx[i]);
      const float tvu = y > 0 ? wvu * (wx[i] - wx[i - W]) : 0.0f;
      float r = b1[i];
      r = r + th - thl;
      r = r + tv - tvu;
      b1[i] = r;
      const float wsum = wvu + whl + wv[i] + wh[i];
      om11[i] = a.omega / (om11[i] + wsum);
    }
    __syncthreads();

    // 4. red-black SOR on du (sor_de_rb; solver.c:439-471)
    for (int it = 0; it < a.n_solver; ++it) {
      for (int colour = 0; colour < 2; ++colour) {
        for (int i = threadIdx.x; i < HW; i += blockDim.x) {
          const int y = i / W, x = i - (i / W) * W;
          if (((y + x + a.row_parity) & 1) != colour) continue;
          const float upw = y > 0 ? wv[i - W] : 0.0f;
          const float lfw = x > 0 ? wh[i - 1] : 0.0f;
          const float duu = y > 0 ? du[i - W] : 0.0f;
          const float dul = x > 0 ? du[i - 1] : 0.0f;
          const float dud = y < H - 1 ? du[i + W] : 0.0f;
          const float dur = x < W - 1 ? du[i + 1] : 0.0f;
          const float b1n = b1[i] + (upw * duu + lfw * dul + wv[i] * dud +
                                     wh[i] * dur);
          du[i] = a.one_minus_omega * du[i] + om11[i] * b1n;
        }
        __syncthreads();
      }
    }

    // 5. disparity, clamped to the camera's sign
    //    (refine_variational.cpp:305-320)
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const float s = wx[i] + du[i];
      uu[i] = a.camlr == 0 ? fminf(s, 0.0f) : fmaxf(s, 0.0f);
    }
    __syncthreads();
  }
}

}  // namespace

// C entry (bound with ctypes). wx, mask (B,H,W); deriv (B,8,C,H,W), C = 1
// or 3; output uu (B,H,W); scratch (B,6,H,W); camlr 0 clamps uu <= 0, 1
// clamps uu >= 0. Returns the launch's cudaError_t.
extern "C" int of_tv_de_inner(const float* wx, const float* mask,
                              const float* deriv, float* uu, float* scratch,
                              int B, int C, int H, int W, int n_inner,
                              int n_solver, int row_parity, int use_color,
                              int camlr, float quarter_alpha, float hd3,
                              float hg3, float omega, float one_minus_omega,
                              void* stream) {
  if (B == 0) return 0;
  DEArgs a{H,   W,   n_inner, n_solver, row_parity, use_color, camlr,
           quarter_alpha, hd3, hg3, omega, one_minus_omega};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    tv_de_inner_kernel<1><<<B, kThreads, 0, s>>>(wx, mask, deriv, uu, scratch,
                                                 a);
  } else if (C == 3) {
    tv_de_inner_kernel<3><<<B, kThreads, 0, s>>>(wx, mask, deriv, uu, scratch,
                                                 a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
