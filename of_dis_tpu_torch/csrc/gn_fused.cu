// K1 — the whole masked inverse-compositional Gauss-Newton loop of one
// pyramid level, for every patch of a batch of frame pairs.
//
// Replaces: of_dis_tpu/ops/patch_solver.py::_gn_fused_pallas (the TPU
// kernel; the semantics are those of its XLA twin _gn_xla_path).
//
// Bound on an H100: at the DIS level sizes neither bytes nor operations
// come close to the card's rates (a level moves a few tens of MB and does a
// few hundred MFLOP); what bounds it is latency — the 12 dependent trips,
// each a chain of window gathers, warp reductions and a 2x2 solve.
//
// Design: one warp per patch. Each lane owns psz^2/32 whole pixels of the
// patch (2 at psz 8: pixel = lane + 32k) with all C channels of each, and
// keeps their template, gradients, residual and weights in registers for
// the whole loop, so the channel-summed splat weight of a pixel needs no
// shuffle; the (psz+1)^2 bilinear window
// is read straight from the target plane in global memory (it stays in L1
// and L2), so none of the TPU kernel's devices (hi/lo bf16 planes, one-hot
// dots, band select, extraction cache, pair packing) is needed. Patch sums
// (mean, residual mean, the two steepest-descent projections) are
// butterfly __shfl_xor_sync reductions, which leave the bit-identical sum
// in every lane, so all control flow is warp-uniform. A warp whose patch
// stops leaves the loop: the masked fixed-trip loop's result is the same.
// `iters` (trips with any active patch) is the atomicMax of each warp's
// trip count — a max, hence deterministic. Pixels per lane K and channels
// C are template parameters; the parameter count nop (2 flow, 1 depth) is
// a warp-uniform run-time branch. Per-lane partial sums run over
// (pixel k, channel c) in that order before the butterfly; the plain twin
// sums in the same order (patch_solver._lane_sum).

#include "gn_common.cuh"

namespace {

using namespace gn;  // GNArgs, warp_sum, loss, out_of_bounds, extract

// Error image at (x, y): residual pd per element, the densify weight
// pw[k] = sum_c max(w_c, MINERRVAL) per pixel (patchgrid.cpp:253-260) and
// the mean raw weight over all psz^2 C elements.
template <int K, int C>
__device__ __forceinline__ void compute_err(const float* im, float x,
                                            float y, int lane,
                                            const GNArgs& a,
                                            const float (&tm)[K * C],
                                            float (&pd)[K * C],
                                            float (&pw)[K], float& mares) {
  const int p_tot = a.psz * a.psz;
  float patch[K * C];
  extract<K, C>(im, x, y, lane, a, patch);
  if (a.patnorm > 0) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < K * C; ++e) s += patch[e];
    const float mean = warp_sum(s) / static_cast<float>(p_tot * C);
#pragma unroll
    for (int e = 0; e < K * C; ++e) patch[e] = patch[e] - mean;
  }
  float wsum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool valid = lane + 32 * k < p_tot;
    float dense = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = k * C + c;
      float w;
      loss(patch[e] - tm[e], a.costfct, pd[e], w);
      if (!valid) {
        pd[e] = 0.0f;
        w = 0.0f;
      }
      wsum += w;
      const float wc = fmaxf(w, kMinErrVal);
      dense = c == 0 ? wc : dense + wc;
    }
    pw[k] = dense;
  }
  mares = warp_sum(wsum) / a.novals;
}

template <int K, int C>
__global__ void gn_fused_kernel(const float* __restrict__ im,
                                const float* __restrict__ tmpl,
                                const float* __restrict__ tdx,
                                const float* __restrict__ tdy,
                                const float* __restrict__ hes,
                                const float* __restrict__ p_init,
                                const float* __restrict__ pt_ref,
                                float* __restrict__ p_out,
                                float* __restrict__ pw_out,
                                int* __restrict__ iters, GNArgs a) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * a.N) return;  // whole warps only: blockDim % 32 == 0
  const int b = warp / a.N, n = warp - (warp / a.N) * a.N;
  const int p_tot = a.psz * a.psz;
  const bool flow = a.nop == 2;
  const float* imb = im + static_cast<size_t>(b) * C * a.Hp * a.Wp;
  // templates (B, D, N), D = (pixel, channel)
  const size_t tb = static_cast<size_t>(b) * p_tot * C * a.N + n;

  float tm[K * C], tx[K * C], ty[K * C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    const bool v = d < p_tot;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = tb + static_cast<size_t>(d * C + c) * a.N;
      tm[k * C + c] = v ? tmpl[o] : 0.0f;
      tx[k * C + c] = v ? tdx[o] : 0.0f;
      ty[k * C + c] = v && flow ? tdy[o] : 0.0f;
    }
  }
  // Hessian (B, 3, N) for flow, (B, 1, N) for depth
  const size_t hb = static_cast<size_t>(b) * (flow ? 3 : 1) * a.N + n;
  const float h00 = hes[hb];
  const float h01 = flow ? hes[hb + a.N] : 0.0f;
  const float h11 = flow ? hes[hb + 2 * a.N] : 0.0f;
  const size_t pb = static_cast<size_t>(b) * a.nop * a.N + n;
  const float pi0 = p_init[pb], pi1 = flow ? p_init[pb + a.N] : 0.0f;
  const float pr0 = pt_ref[n], pr1 = pt_ref[a.N + n];
  // depth moves along x only: pt = (pt_ref.x + p, pt_ref.y)
  const float pt0x = pr0 + pi0, pt0y = flow ? pr1 + pi1 : pr1;

  // OptimizeStart (patch.cpp:118-154)
  float p0 = pi0, p1 = pi1;
  float pd[K * C], pw[K], mares = 0.0f;
  bool active;
  if (out_of_bounds(pt0x, pt0y, a)) {
    // documented deviation: residual = template, weight from the template
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float dense = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = k * C + c;
        float w;
        loss(tm[e], a.costfct, pd[e], w);
        pd[e] = tm[e];
        const float wc = fmaxf(w, kMinErrVal);
        dense = c == 0 ? wc : dense + wc;
      }
      pw[k] = dense;
    }
    active = false;
  } else {
    compute_err<K, C>(imb, pt0x, pt0y, lane, a, tm, pd, pw, mares);
    active = a.max_iter > 0 && mares > a.res_thresh;
  }

  float dpn_init = 1e-10f;
  int trips = 0;
  for (int it = 1; it <= a.max_iter && active; ++it) {
    trips = it;
    // steepest-descent projection (patch.cpp:175-180)
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int e = 0; e < K * C; ++e) {
      r0 += tx[e] * pd[e];
      r1 += ty[e] * pd[e];
    }
    r0 = warp_sum(r0);
    float dp0, dp1, q0, q1, qx, qy;
    if (flow) {
      r1 = warp_sum(r1);
      const float det = h00 * h11 - h01 * h01;
      dp0 = (h11 * r0 - h01 * r1) / det;
      dp1 = (h00 * r1 - h01 * r0) / det;
      q0 = p0 - dp0;
      q1 = p1 - dp1;
      qx = pr0 + q0;
      qy = pr1 + q1;
    } else {
      dp0 = r0 / h00;
      dp1 = 0.0f;
      q0 = p0 - dp0;
      q1 = 0.0f;
      // disparity sign clamp, before the reset test (patch.cpp:186-191)
      q0 = a.camlr == 0 ? fminf(q0, 0.0f) : fmaxf(q0, 0.0f);
      qx = pr0 + q0;
      qy = pr1;
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
    float pdn[K * C], pwn[K], mn;
    compute_err<K, C>(imb, qx, qy, lane, a, tm, pdn, pwn, mn);
    const float dsq = dp0 * dp0 + dp1 * dp1;
    if (it == 1) dpn_init = dsq;
    // convergence predicate with min_iter gating (patch.cpp:287-293)
    const bool gate = it < a.min_iter;
    const bool keep = it < a.max_iter && mn > a.res_thresh &&
                      (gate || dsq / dpn_init >= a.dp_thresh_sq) &&
                      (gate || mn / mares <= a.dr_thresh);
    p0 = q0;
    p1 = q1;
#pragma unroll
    for (int e = 0; e < K * C; ++e) pd[e] = pdn[e];
#pragma unroll
    for (int k = 0; k < K; ++k) pw[k] = pwn[k];
    mares = mn;
    active = keep && !reset;
  }

  if (lane == 0) {
    p_out[pb] = p0;
    if (flow) p_out[pb + a.N] = p1;
    if (trips > 0) atomicMax(iters, trips);
  }
  // pweight (B, psz^2, N), channel-summed
  const size_t wb = static_cast<size_t>(b) * p_tot * a.N + n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    if (d < p_tot) pw_out[wb + static_cast<size_t>(d) * a.N] = pw[k];
  }
}

template <int K, int C>
cudaError_t launch(const float* im, const float* tmpl, const float* tdx,
                   const float* tdy, const float* hes, const float* p_init,
                   const float* pt_ref, float* p_out, float* pw_out,
                   int* iters, const GNArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 patches per block
  const long long threads = static_cast<long long>(a.B) * a.N * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (blocks == 0) return cudaSuccess;
  gn_fused_kernel<K, C><<<blocks, kThreads, 0, stream>>>(
      im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out, pw_out, iters, a);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* im, const float* tmpl, const float* tdx,
                     const float* tdy, const float* hes, const float* p_init,
                     const float* pt_ref, float* p_out, float* pw_out,
                     int* iters, const GNArgs& a, cudaStream_t s) {
  switch ((a.psz * a.psz + 31) / 32) {
    case 1:
      return launch<1, C>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 2:
      return launch<2, C>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 3:
      return launch<3, C>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 4:
      return launch<4, C>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    case 5:
      return launch<5, C>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                          pw_out, iters, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry (bound with ctypes). Tensors: im (B,C,Hp,Wp), tmpl/tdx/tdy
// (B,D,N) with D = psz^2 C in (pixel, channel) order, hes (B,3,N) for
// nop 2 or (B,1,N) for nop 1, p_init (B,nop,N), pt_ref (2,N); outputs
// p_out (B,nop,N), pw_out (B,psz^2,N), iters (1,) zero-initialised. C is 1
// or 3, nop 2 (flow) or 1 (depth, with camlr 0: p <= 0, 1: p >= 0).
// Returns the launch's cudaError_t.
extern "C" int of_gn_fused(const float* im, const float* tmpl,
                           const float* tdx, const float* tdy,
                           const float* hes, const float* p_init,
                           const float* pt_ref, float* p_out, float* pw_out,
                           int* iters, int B, int N, int C, int Hp, int Wp,
                           int psz, int pad, int max_iter, int min_iter,
                           int costfct, int patnorm, int nop, int camlr,
                           float tmp_lb, float tmp_ubw, float tmp_ubh,
                           float outlier, float res_thresh,
                           float dp_thresh_sq, float dr_thresh, float novals,
                           void* stream) {
  gn::GNArgs a{B,        N,       Hp,      Wp,  psz,   pad,     max_iter,
           min_iter, costfct, patnorm, nop, camlr, tmp_lb,  tmp_ubw,
           tmp_ubh,  outlier, res_thresh, dp_thresh_sq, dr_thresh, novals};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nop != 1 && nop != 2) || (camlr != 0 && camlr != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1)
    return static_cast<int>(dispatch<1>(im, tmpl, tdx, tdy, hes, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  if (C == 3)
    return static_cast<int>(dispatch<3>(im, tmpl, tdx, tdy, hes, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
