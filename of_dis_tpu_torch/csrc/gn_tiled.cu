// K6 — the masked inverse-compositional Gauss-Newton loop of a LARGE
// pyramid level (thousands of patches a pair: the fine levels of op-3 and
// op-4), with the templates, their mean-normalisation and the Hessians
// built in the kernel from the source planes, and the splat weight taken
// from one extraction at the final position.
//
// Replaces: of_dis_tpu/ops/patch_solver.py::_gn_tiled_pallas (the TPU
// kernel with in-kernel templates; the semantics are those of its XLA twin
// _gn_xla_path on templates from extract_templates).
//
// Bound on an H100: operations. At op-4 a level runs 128 mandatory trips,
// each a bilinear extraction, a residual and two projections over psz^2 C
// elements of every patch (51,300 patches a pair at 1024x436, level 0):
// tens of GFLOP a pair against a few MB of planes, so the float32 rate
// bounds it, not the memory. K1 (gn_fused.cu) would read three (B, D, N)
// template arrays that plain gathers wrote to device memory first — 16
// times the source planes at patch size 12, overlap 0.75; here a warp
// reads its psz^2 template pixels straight from the source image and its
// two gradient planes at the patch's integer grid position, once.
//
// Design: one warp per patch, as K1 (see gn_fused.cu): lane l owns the
// pixels l + 32k with all C channels, template and gradients live in
// registers for the whole loop, the bilinear window is read from the
// target planes in global memory (L1 / L2 hold it: neighbouring patches
// overlap by 3/4), patch sums are butterfly shuffles, so every branch is
// warp-uniform and a warp leaves the loop when its patch stops. None of
// the TPU kernel's devices carries over (tiles and their VMEM windows,
// window validity and the fix-up passes, bf16 hi/lo planes, one-hot dots,
// band select, the extraction cache). The loop carries the two projections
// (rhs) instead of the residual image and no splat weight: extraction is a
// pure function of the position, so one extraction at the final position
// after the loop gives the weight the loop would have carried, bit for
// bit. Per-lane partial sums (template mean, Hessian entries, residual
// mean, projections) run over (pixel k, channel c) in that order before
// the butterfly; the plain twin (patch_solver._gn_tiled_plain) sums in the
// same order. `iters` is the atomicMax of the warps' trip counts.

#include "gn_common.cuh"

namespace {

using namespace gn;  // GNArgs, warp_sum, loss, out_of_bounds, extract

// Mean-normalised (when patnorm) bilinear patch at (x, y); elements of
// pixels beyond psz^2 hold 0 - mean and are masked by the callers.
template <int K, int C>
__device__ __forceinline__ void patch_at(const float* im, float x, float y,
                                         int lane, const GNArgs& a,
                                         float (&patch)[K * C]) {
  extract<K, C>(im, x, y, lane, a, patch);
  if (a.patnorm > 0) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < K * C; ++e) s += patch[e];
    const float mean = warp_sum(s) / static_cast<float>(a.psz * a.psz * C);
#pragma unroll
    for (int e = 0; e < K * C; ++e) patch[e] = patch[e] - mean;
  }
}

// Error at (x, y), reduced: the steepest-descent projections r0, r1 of the
// residual on the template gradients (patch.cpp:175-180) and the mean raw
// weight over all psz^2 C elements.
template <int K, int C>
__device__ __forceinline__ void err_rhs(const float* im, float x, float y,
                                        int lane, const GNArgs& a,
                                        const float (&tm)[K * C],
                                        const float (&tx)[K * C],
                                        const float (&ty)[K * C], float& r0,
                                        float& r1, float& mares) {
  const int p_tot = a.psz * a.psz;
  float patch[K * C];
  patch_at<K, C>(im, x, y, lane, a, patch);
  float wsum = 0.0f, s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool valid = lane + 32 * k < p_tot;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = k * C + c;
      float pd, w;
      loss(patch[e] - tm[e], a.costfct, pd, w);
      if (!valid) {
        pd = 0.0f;
        w = 0.0f;
      }
      wsum += w;
      s0 += tx[e] * pd;
      s1 += ty[e] * pd;
    }
  }
  r0 = warp_sum(s0);
  r1 = a.nop == 2 ? warp_sum(s1) : 0.0f;
  mares = warp_sum(wsum) / a.novals;
}

template <int K, int C>
__global__ void gn_tiled_kernel(const float* __restrict__ im,
                                const float* __restrict__ src_im,
                                const float* __restrict__ src_dx,
                                const float* __restrict__ src_dy,
                                const float* __restrict__ p_init,
                                const float* __restrict__ pt_ref,
                                float* __restrict__ p_out,
                                float* __restrict__ pw_out,
                                int* __restrict__ iters, GNArgs a) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps only: blockDim % 32 == 0
  if (warp >= static_cast<long long>(a.B) * a.N) return;
  const int b = static_cast<int>(warp / a.N);
  const int n = static_cast<int>(warp - static_cast<long long>(b) * a.N);
  const int p_tot = a.psz * a.psz;
  const bool flow = a.nop == 2;
  const size_t pair = static_cast<size_t>(b) * C * a.Hp * a.Wp;
  const float* imb = im + pair;
  const int plane = a.Hp * a.Wp;

  const size_t pb = static_cast<size_t>(b) * a.nop * a.N + n;
  const float pi0 = p_init[pb], pi1 = flow ? p_init[pb + a.N] : 0.0f;
  const float ref_x = pt_ref[n], ref_y = pt_ref[a.N + n];

  // Templates at the integer anchor of the grid position (never through
  // ceil(pt + 1e-5): the float32 sum rounds the 1e-5 away from 256 px on).
  const int ax = static_cast<int>(ref_x) - (a.psz + 1) / 2 + a.pad;
  const int ay = static_cast<int>(ref_y) - (a.psz + 1) / 2 + a.pad;
  float tm[K * C], tx[K * C], ty[K * C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    const bool v = d < p_tot;
    const int j = d / a.psz, i = d - (d / a.psz) * a.psz;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = pair + static_cast<size_t>(c) * plane +
                       static_cast<size_t>(ay + j) * a.Wp + (ax + i);
      tm[k * C + c] = v ? src_im[o] : 0.0f;
      tx[k * C + c] = v ? src_dx[o] : 0.0f;
      ty[k * C + c] = v && flow ? src_dy[o] : 0.0f;
    }
  }
  if (a.patnorm > 0) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < K * C; ++e) s += tm[e];
    const float mean = warp_sum(s) / static_cast<float>(p_tot * C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool v = lane + 32 * k < p_tot;
#pragma unroll
      for (int c = 0; c < C; ++c)
        tm[k * C + c] = v ? tm[k * C + c] - mean : 0.0f;
    }
  }
  // Hessian with the singular guard (patch.cpp:69-86)
  float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
#pragma unroll
  for (int e = 0; e < K * C; ++e) {
    h00 += tx[e] * tx[e];
    h01 += tx[e] * ty[e];
    h11 += ty[e] * ty[e];
  }
  h00 = warp_sum(h00);
  if (flow) {
    h01 = warp_sum(h01);
    h11 = warp_sum(h11);
    const float guard = h00 * h11 - h01 * h01 == 0.0f ? 1e-10f : 0.0f;
    h00 = h00 + guard;
    h11 = h11 + guard;
  } else {
    h00 = h00 + (h00 == 0.0f ? 1e-10f : 0.0f);
  }

  // depth moves along x only: pt = (pt_ref.x + p, pt_ref.y)
  const float pt0x = ref_x + pi0, pt0y = flow ? ref_y + pi1 : ref_y;
  const bool init_oob = out_of_bounds(pt0x, pt0y, a);

  // OptimizeStart (patch.cpp:118-154)
  float p0 = pi0, p1 = pi1;
  float r0 = 0.0f, r1 = 0.0f, mares = 0.0f;
  bool active;
  if (init_oob) {
    // never active: its projections are not needed, and its weight is the
    // template's (the documented deviation), taken after the loop
    active = false;
  } else {
    err_rhs<K, C>(imb, pt0x, pt0y, lane, a, tm, tx, ty, r0, r1, mares);
    active = a.max_iter > 0 && mares > a.res_thresh;
  }

  float dpn_init = 1e-10f;
  int trips = 0;
  for (int it = 1; it <= a.max_iter && active; ++it) {
    trips = it;
    float dp0, dp1, q0, q1, qx, qy;
    if (flow) {
      const float det = h00 * h11 - h01 * h01;
      dp0 = (h11 * r0 - h01 * r1) / det;
      dp1 = (h00 * r1 - h01 * r0) / det;
      q0 = p0 - dp0;
      q1 = p1 - dp1;
      qx = ref_x + q0;
      qy = ref_y + q1;
    } else {
      dp0 = r0 / h00;
      dp1 = 0.0f;
      q0 = p0 - dp0;
      q1 = 0.0f;
      // disparity sign clamp, before the reset test (patch.cpp:186-191)
      q0 = a.camlr == 0 ? fminf(q0, 0.0f) : fmaxf(q0, 0.0f);
      qx = ref_x + q0;
      qy = ref_y;
    }
    // outlier / out-of-bounds reset (patch.cpp:196-206)
    const float mx = qx - pt0x, my = qy - pt0y;
    const bool reset = sqrtf(mx * mx + my * my) > a.outlier ||
                       out_of_bounds(qx, qy, a);
    if (reset) {
      q0 = pi0;
      q1 = pi1;
      qx = pt0x;
      qy = pt0y;
    }
    float rn0, rn1, mn;
    err_rhs<K, C>(imb, qx, qy, lane, a, tm, tx, ty, rn0, rn1, mn);
    const float dsq = dp0 * dp0 + dp1 * dp1;
    if (it == 1) dpn_init = dsq;
    // convergence predicate with min_iter gating (patch.cpp:287-293)
    const bool gate = it < a.min_iter;
    const bool keep = it < a.max_iter && mn > a.res_thresh &&
                      (gate || dsq / dpn_init >= a.dp_thresh_sq) &&
                      (gate || mn / mares <= a.dr_thresh);
    p0 = q0;
    p1 = q1;
    r0 = rn0;
    r1 = rn1;
    mares = mn;
    active = keep && !reset;
  }

  if (lane == 0) {
    p_out[pb] = p0;
    if (flow) p_out[pb + a.N] = p1;
    if (trips > 0) atomicMax(iters, trips);
  }

  // Splat weight (B, psz^2, N), sum_c max(w_c, MINERRVAL)
  // (patchgrid.cpp:253-260), from one extraction at the final position;
  // a patch that started out of bounds takes its template's weight.
  float fin[K * C];
  if (init_oob) {
#pragma unroll
    for (int e = 0; e < K * C; ++e) fin[e] = tm[e];
  } else {
    patch_at<K, C>(imb, ref_x + p0, flow ? ref_y + p1 : ref_y, lane, a, fin);
#pragma unroll
    for (int e = 0; e < K * C; ++e) fin[e] = fin[e] - tm[e];
  }
  const size_t wb = static_cast<size_t>(b) * p_tot * a.N + n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    float dense = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float pd, w;
      loss(fin[k * C + c], a.costfct, pd, w);
      const float wc = fmaxf(w, kMinErrVal);
      dense = c == 0 ? wc : dense + wc;
    }
    if (d < p_tot) pw_out[wb + static_cast<size_t>(d) * a.N] = dense;
  }
}

template <int K, int C>
cudaError_t launch(const float* im, const float* src_im, const float* src_dx,
                   const float* src_dy, const float* p_init,
                   const float* pt_ref, float* p_out, float* pw_out,
                   int* iters, const GNArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 128;  // 4 patches per block
  const long long warps = static_cast<long long>(a.B) * a.N;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gn_tiled_kernel<K, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(im, src_im, src_dx, src_dy, p_init,
                                    pt_ref, p_out, pw_out, iters, a);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* im, const float* src_im,
                     const float* src_dx, const float* src_dy,
                     const float* p_init, const float* pt_ref, float* p_out,
                     float* pw_out, int* iters, const GNArgs& a,
                     cudaStream_t s) {
  switch ((a.psz * a.psz + 31) / 32) {
    case 1:
      return launch<1, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 2:
      return launch<2, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 3:
      return launch<3, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 4:
      return launch<4, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 5:
      return launch<5, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry (bound with ctypes). Tensors: im (B,C,Hp,Wp) target planes;
// src_im / src_dx / src_dy (B,C,Hp,Wp) source image and its gradients
// (src_dy is not read for nop 1); p_init (B,nop,N), pt_ref (2,N) integer
// grid positions; outputs p_out (B,nop,N), pw_out (B,psz^2,N), iters (1,)
// zero-initialised. C is 1 or 3, nop 2 (flow) or 1 (depth, with camlr 0:
// p <= 0, 1: p >= 0). Returns the launch's cudaError_t.
extern "C" int of_gn_tiled(const float* im, const float* src_im,
                           const float* src_dx, const float* src_dy,
                           const float* p_init, const float* pt_ref,
                           float* p_out, float* pw_out, int* iters, int B,
                           int N, int C, int Hp, int Wp, int psz, int pad,
                           int max_iter, int min_iter, int costfct,
                           int patnorm, int nop, int camlr, float tmp_lb,
                           float tmp_ubw, float tmp_ubh, float outlier,
                           float res_thresh, float dp_thresh_sq,
                           float dr_thresh, float novals, void* stream) {
  gn::GNArgs a{B,        N,       Hp,      Wp,  psz,   pad,     max_iter,
               min_iter, costfct, patnorm, nop, camlr, tmp_lb,  tmp_ubw,
               tmp_ubh,  outlier, res_thresh, dp_thresh_sq, dr_thresh,
               novals};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nop != 1 && nop != 2) || (camlr != 0 && camlr != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1)
    return static_cast<int>(dispatch<1>(im, src_im, src_dx, src_dy, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  if (C == 3)
    return static_cast<int>(dispatch<3>(im, src_im, src_dx, src_dy, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
