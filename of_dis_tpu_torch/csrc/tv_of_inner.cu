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
// iteration; at DIS level sizes (at most 56x128 at op-2) both the byte and
// the flop bound are microseconds. What bounds it is the chain of
// dependent stages: every stage needs its neighbours' results of the stage
// before, and every SOR colour needs the other colour's fresh values.
//
// Design: one thread block per frame pair runs the whole loop; stages are
// separated by __syncthreads(), so no grid-wide barrier is needed at any
// level size. Fields live in a global scratch (B, 10, H, W) that the caller
// allocates (it stays in L1/L2). SOR updates du, then dv from the fresh du,
// in place per colour: every 4-neighbour of a red pixel is black, so the
// in-place sweep is race-free. Colour = (y + x + row_parity) % 2. up_w,
// left_w, wsum and omega/(a + wsum) are hoisted per inner iteration as in
// sor_coupled_rb. At batch 64 the grid has 64 blocks — fewer than the 132
// SMs; filling the card is later work. The channel count C is a template
// parameter: C = 1 compiles the gray data term unchanged, C = 3 the RGB
// one with the reference's two quirks (see data_rgb).

#include <cuda_runtime.h>

namespace {

constexpr float kDataNorm = 0.010000000000000002f;   // 0.1^2
constexpr float kEps = 1e-6f;                         // 0.001^2
constexpr int kFields = 10;
constexpr int kThreads = 1024;

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

template <int C>
__global__ void __launch_bounds__(kThreads)
    tv_of_inner_kernel(const float* wx_all, const float* wy_all,
                       const float* mask_all, const float* deriv_all,
                       float* uu_all, float* vv_all, float* scratch,
                       TVArgs a) {
  const int H = a.H, W = a.W, HW = H * W;
  const size_t b = blockIdx.x;
  const float* wx = wx_all + b * HW;
  const float* wy = wy_all + b * HW;
  const float* mask = mask_all + b * HW;
  const float* I = deriv_all + b * 8 * C * HW;
  float* uu = uu_all + b * HW;
  float* vv = vv_all + b * HW;
  float* S = scratch + b * kFields * HW;
  float* du = S;
  float* dv = S + HW;
  float* sm = S + 2 * HW;
  float* wh = S + 3 * HW;
  float* wv = S + 4 * HW;
  float* om11 = S + 5 * HW;   // a11 until stage 3, then omega/(a11+wsum)
  float* a12 = S + 6 * HW;
  float* om22 = S + 7 * HW;   // a22 until stage 3, then omega/(a22+wsum)
  float* b1 = S + 8 * HW;
  float* b2 = S + 9 * HW;

  for (int i = threadIdx.x; i < HW; i += blockDim.x) {
    du[i] = 0.0f;
    dv[i] = 0.0f;
    uu[i] = wx[i];
    vv[i] = wy[i];
  }
  __syncthreads();

  for (int inner = 0; inner < a.n_inner; ++inner) {
    // 1. TV diffusivity (compute_smoothness, opticalflow_aux.c:138-187):
    //    3-tap central differences with replicate borders
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
      const int yu = max(y - 1, 0), yd = min(y + 1, H - 1);
      const float ux = 0.5f * (uu[y * W + xr] - uu[y * W + xl]);
      const float uy = 0.5f * (uu[yd * W + x] - uu[yu * W + x]);
      const float vx = 0.5f * (vv[y * W + xr] - vv[y * W + xl]);
      const float vy = 0.5f * (vv[yd * W + x] - vv[yu * W + x]);
      sm[i] = a.quarter_alpha /
              sqrtf(kEps + ux * ux + uy * uy + vx * vx + vy * vy);
    }
    __syncthreads();

    // 2. edge weights + data term (compute_data, opticalflow_aux.c:
    //    408-594; gray with the x3 system scaling, RGB in data_rgb)
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      wh[i] = x < W - 1 ? sm[i] + sm[i + 1] : 0.0f;
      wv[i] = y < H - 1 ? sm[i] + sm[i + W] : 0.0f;
      const float m = mask[i], u = du[i], v = dv[i];
      if constexpr (C == 1) {
        const float ix = I[i], iy = I[HW + i], iz = I[2 * HW + i];
        const float ixx = I[3 * HW + i], ixy = I[4 * HW + i];
        const float iyy = I[5 * HW + i], ixz = I[6 * HW + i];
        const float iyz = I[7 * HW + i];
        float A11 = 0.0f, A12 = 0.0f, A22 = 0.0f, B1 = 0.0f, B2 = 0.0f;
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
        om11[i] = 3.0f * A11;
        a12[i] = 3.0f * A12;
        om22[i] = 3.0f * A22;
        b1[i] = 3.0f * B1;
        b2[i] = 3.0f * B2;
      } else {
        float A11, A12, A22, B1, B2;
        data_rgb(I, HW, i, m, u, v, a, A11, A12, A22, B1, B2);
        om11[i] = A11;
        a12[i] = A12;
        om22[i] = A22;
        b1[i] = B1;
        b2[i] = B2;
      }
    }
    __syncthreads();

    // 3. b += div(w grad(w_xy)) (sub_laplacian, opticalflow_aux.c:194-223)
    //    and the SOR terms hoisted out of the sweeps
    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      const int y = i / W, x = i - (i / W) * W;
      const float whl = x > 0 ? wh[i - 1] : 0.0f;
      const float wvu = y > 0 ? wv[i - W] : 0.0f;
      const float* src[2] = {wx, wy};
      float* bb[2] = {b1, b2};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* f = src[c];
        const float fr = x < W - 1 ? f[i + 1] : 0.0f;
        const float fd = y < H - 1 ? f[i + W] : 0.0f;
        const float th = wh[i] * (fr - f[i]);
        const float thl = x > 0 ? whl * (f[i] - f[i - 1]) : 0.0f;
        const float tv = wv[i] * (fd - f[i]);
        const float tvu = y > 0 ? wvu * (f[i] - f[i - W]) : 0.0f;
        float r = bb[c][i];
        r = r + th - thl;
        r = r + tv - tvu;
        bb[c][i] = r;
      }
      const float wsum = wvu + whl + wv[i] + wh[i];
      om11[i] = a.omega / (om11[i] + wsum);
      om22[i] = a.omega / (om22[i] + wsum);
    }
    __syncthreads();

    // 4. coupled red-black SOR (sor_coupled_rb; solver.c:34-78 order
    //    within a pixel: du, then dv from the fresh du)
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
        }
        __syncthreads();
      }
    }

    for (int i = threadIdx.x; i < HW; i += blockDim.x) {
      uu[i] = wx[i] + du[i];
      vv[i] = wy[i] + dv[i];
    }
    __syncthreads();
  }
}

}  // namespace

// C entry (bound with ctypes). wx, wy, mask (B,H,W); deriv (B,8,C,H,W) in
// the order ix, iy, iz, ixx, ixy, iyy, ixz, iyz, C = 1 or 3; outputs uu, vv
// (B,H,W); scratch (B,10,H,W). Returns the launch's cudaError_t.
extern "C" int of_tv_of_inner(const float* wx, const float* wy,
                              const float* mask, const float* deriv,
                              float* uu, float* vv, float* scratch, int B,
                              int C, int H, int W, int n_inner, int n_solver,
                              int row_parity, int use_color,
                              float quarter_alpha, float hd3, float hg3,
                              float omega, float one_minus_omega,
                              void* stream) {
  if (B == 0) return 0;
  TVArgs a{H,     W,   n_inner, n_solver, row_parity,      use_color,
           quarter_alpha, hd3, hg3,     omega,    one_minus_omega};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    tv_of_inner_kernel<1><<<B, kThreads, 0, s>>>(wx, wy, mask, deriv, uu, vv,
                                                 scratch, a);
  } else if (C == 3) {
    tv_of_inner_kernel<3><<<B, kThreads, 0, s>>>(wx, wy, mask, deriv, uu, vv,
                                                 scratch, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
