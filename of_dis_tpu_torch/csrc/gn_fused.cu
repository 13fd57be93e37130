// K1 — the whole masked inverse-compositional Gauss-Newton loop of one
// pyramid level, for every patch of a batch of frame pairs.
//
// Replaces: of_dis_tpu/ops/patch_solver.py::_gn_fused_pallas (the TPU
// kernel; the semantics are those of its XLA twin _gn_xla_path).
//
// Bound on an H100: at the DIS level sizes neither bytes nor operations
// come close to the card's rates (a level moves a few tens of MB and does a
// few hundred MFLOP); what bounds it is latency and issue — the 12
// dependent trips, each a chain of window gathers, warp reductions and a
// 2x2 solve, and the integer work that addresses the gathers.
//
// Design: one warp per patch. Each lane owns psz^2/32 whole pixels of the
// patch (2 at psz 8: pixel = lane + 32k) with all C channels of each, and
// keeps their template and gradients in registers for the whole loop, so
// the channel-summed splat weight of a pixel needs no shuffle; the
// (psz+1)^2 bilinear window is read straight from the target plane in
// global memory (it stays in L1 and L2), so none of the TPU kernel's
// devices (hi/lo bf16 planes, one-hot dots, band select, extraction cache,
// pair packing) is needed. Patch sums (mean, residual mean, the two
// steepest-descent projections) are butterfly __shfl_xor_sync reductions,
// which leave the bit-identical sum in every lane, so all control flow is
// warp-uniform. A warp whose patch stops leaves the loop: the masked
// fixed-trip loop's result is the same. Per-lane partial sums run over
// (pixel k, channel c) in that order before the butterfly; the plain twin
// sums in the same order (patch_solver._lane_sum).
//
// What costs less than in the first design (measured on an NVIDIA H100 at
// 700 W: 14% less device time over the kernel's 22 calls on the paths of
// chip_smoke.py, PERF.md):
//  - a lane's pixel rows and columns, and their offsets in the planes, are
//    computed once, not every trip; a window inside the planes (all but
//    the border patches) is read at one offset a pixel, without clamps
//    (gn::lane_pixels and gn::lane_taps of gn_common.cuh, shared with
//    T2; gn::taps, with its clamps, reads the border windows);
//  - patch sizes 8 (op-1, op-2) and 12 (op-3, op-4 at small levels) are
//    their own instances, so the patch size is a constant there (the
//    mean's division by 64 a multiply);
//  - blocks of 4 patches (2 measured 3% slower, 8 20% slower);
//  - the residual mean's and the two projections' butterflies run
//    together, and each trip's Gauss-Newton step is taken at the end of the
//    trip before, beside the stopping test, so that the two overlap (the
//    chain of a trip is what bounds the small levels: op-4's level 5 runs
//    128 trips on 220 warps);
//  - a register cap for each instance (MinBlocks);
//  - `iters` (trips with any active patch) is one atomicMax a warp, of its
//    trip count — a max, hence deterministic;
//  - the warp index is 64-bit.
// Tried and not kept: the taps shared across lanes with shuffles (the
// right neighbour from lane + 1, the row below from lane + psz; 4% slower);
// templates read, and splat weights written, through shared memory as runs
// of 4 consecutive floats rather than one float a 32-byte sector (as fast
// over the 22 calls: 4% faster at RGB's level 3, 5% slower at its level 4);
// `iters` as one atomicMax a block (1% slower); tighter register caps
// (spills).
// Pixels per lane K, channels C and the constant patch size P (0: the run
// time's) are template parameters; the parameter count nop (2 flow, 1
// depth) is a warp-uniform run-time branch.

#include "gn_common.cuh"

namespace {

using namespace gn;  // GNArgs, warp_sum, loss, out_of_bounds, lane_pixels,
                    // lane_taps, lerp

constexpr int kWarps = 4;  // patches a block
constexpr int kThreads = 32 * kWarps;

// Blocks an SM must hold, which caps a thread's registers (measured on an
// NVIDIA H100 at 700 W, PERF.md): op-1 / op-2's gray instance (patch size
// 8) runs fastest at 8 blocks of 4 warps (64 registers; 5% faster at
// level 3 than uncapped); the others at 1, which leaves the compiler all
// the registers it wants (without a count it kept op-3 / op-4's patch size
// 12 to 96, and those levels ran 6-9% slower; 64 for every instance
// spills).
template <int C, int P>
struct MinBlocks {
  static constexpr int value = C == 1 && P == 8 ? 8 : 1;
};

// Butterfly sums of N values at once, each as warp_sum adds it (the same
// bits), the N shuffles of a step issued together.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float t[N];
#pragma unroll
    for (int q = 0; q < N; ++q) t[q] = __shfl_xor_sync(0xffffffffu, v[q], o);
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += t[q];
  }
}

// Error image at (x, y), reduced to what the loop needs: the two
// steepest-descent projections r0 = sum tx * pd and r1 = sum ty * pd
// (patch.cpp:175-180; r1 only for flow), the densify weight pw[k] = sum_c
// max(w_c, MINERRVAL) per pixel (patchgrid.cpp:253-260) and the mean raw
// weight over all psz^2 C elements. A lane's partials run over its (k, c)
// in that order; the three butterflies run together.
template <int K, int C>
__device__ __forceinline__ void error_at(
    const float* im, float x, float y, int psz, int lane, const GNArgs& a,
    bool flow, const int (&off)[K], const bool (&valid)[K],
    const float (&tm)[K * C], const float (&tx)[K * C],
    const float (&ty)[K * C], float& r0, float& r1, float (&pw)[K],
    float& mares) {
  const float rx = x - floorf(x);
  const float ry = y - floorf(y);
  const int sx = static_cast<int>(ceilf(x + 1e-5f)) - psz / 2 - 1 + a.pad;
  const int sy = static_cast<int>(ceilf(y + 1e-5f)) - psz / 2 - 1 + a.pad;
  float v00[K * C], v01[K * C], v10[K * C], v11[K * C], patch[K * C];
  lane_taps<K, C>(im, a.Hp, a.Wp, sx, sy, psz, lane, 1.0f, off, valid, v00,
                  v01, v10, v11);
  lerp(v00, v01, v10, v11, rx, ry, patch);
  if (a.patnorm > 0) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < K * C; ++e) s += patch[e];
    const float mean = warp_sum(s) / static_cast<float>(psz * psz * C);
#pragma unroll
    for (int e = 0; e < K * C; ++e) patch[e] = patch[e] - mean;
  }
  float wsum = 0.0f, s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float dense = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = k * C + c;
      float pd, w;
      loss(patch[e] - tm[e], a.costfct, pd, w);
      if (!valid[k]) {
        pd = 0.0f;
        w = 0.0f;
      }
      wsum += w;
      s0 += tx[e] * pd;
      if (flow) s1 += ty[e] * pd;
      const float wc = fmaxf(w, kMinErrVal);
      dense = c == 0 ? wc : dense + wc;
    }
    pw[k] = dense;
  }
  if (flow) {
    float v[3] = {wsum, s0, s1};
    warp_sums(v);
    wsum = v[0];
    r0 = v[1];
    r1 = v[2];
  } else {
    float v[2] = {wsum, s0};
    warp_sums(v);
    wsum = v[0];
    r0 = v[1];
    r1 = 0.0f;
  }
  mares = wsum / a.novals;
}

// One Gauss-Newton step from p = (p0, p1) with projections (r0, r1)
// (patch.cpp:182-206): the closed-form 2x2 (or 1x1) solve dp (its
// determinant and numerators each one fmaf, as the JAX package's XLA
// contracts them and the twin's `_fms` computes them: a Hessian singular
// in float32, as a bilevel frame's edges give, takes a finite step), the new
// parameters q and position (qx, qy), the disparity sign clamp, and the
// outlier / out-of-bounds reset to the start.
__device__ __forceinline__ void step(const GNArgs& a, bool flow, float h00,
                                     float h01, float h11, float r0,
                                     float r1, float p0, float p1,
                                     float pi0, float pi1, float pr0,
                                     float pr1, float pt0x, float pt0y,
                                     float& dp0, float& dp1, float& q0,
                                     float& q1, float& qx, float& qy,
                                     bool& reset) {
  if (flow) {
    const float det = fmaf(h00, h11, -(h01 * h01));
    dp0 = fmaf(h11, r0, -(h01 * r1)) / det;
    dp1 = fmaf(h00, r1, -(h01 * r0)) / det;
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
  reset = sqrtf(mx * mx + my * my) > a.outlier || out_of_bounds(qx, qy, a);
  if (reset) {
    q0 = pi0;
    q1 = pi1;
    qx = pt0x;
    qy = pt0y;
  }
}

template <int K, int C, int P>
__global__ void __launch_bounds__(kThreads, MinBlocks<C, P>::value)
    gn_fused_kernel(const float* __restrict__ im,
                    const float* __restrict__ tmpl,
                    const float* __restrict__ tdx,
                    const float* __restrict__ tdy,
                    const float* __restrict__ hes,
                    const float* __restrict__ p_init,
                    const float* __restrict__ pt_ref,
                    float* __restrict__ p_out, float* __restrict__ pw_out,
                    int* __restrict__ iters, GNArgs a) {
  const int psz = P > 0 ? P : a.psz;
  const int p_tot = psz * psz;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long total = static_cast<long long>(a.B) * a.N;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + wib;
  const bool owner = g < total;
  const bool flow = a.nop == 2;

  // this lane's pixels: row, column, offset from the window's corner
  int off[K];
  bool valid[K];
  lane_pixels<K>(psz, a.Wp, lane, off, valid);

  // templates (B, D, N), D = (pixel, channel): element (pixel lane + 32k,
  // channel c) of the warp's patch
  const long long b = owner ? g / a.N : 0;
  const int n = static_cast<int>(g - b * a.N);
  const size_t tb = static_cast<size_t>(b) * p_tot * C * a.N + n;
  float tm[K * C], tx[K * C], ty[K * C];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = k * C + c;
      const size_t o = tb + static_cast<size_t>((lane + 32 * k) * C + c) * a.N;
      const bool v = owner && valid[k];
      tm[e] = v ? tmpl[o] : 0.0f;
      tx[e] = v ? tdx[o] : 0.0f;
      ty[e] = v && flow ? tdy[o] : 0.0f;
    }
  }

  float p0 = 0.0f, p1 = 0.0f, pw[K];
  int trips = 0;
  const size_t pb = static_cast<size_t>(b) * a.nop * a.N + n;
  if (owner) {
    const float* imb = im + static_cast<size_t>(b) * C * a.Hp * a.Wp;
    // Hessian (B, 3, N) for flow, (B, 1, N) for depth
    const size_t hb = static_cast<size_t>(b) * (flow ? 3 : 1) * a.N + n;
    const float h00 = hes[hb];
    const float h01 = flow ? hes[hb + a.N] : 0.0f;
    const float h11 = flow ? hes[hb + 2 * a.N] : 0.0f;
    const float pi0 = p_init[pb], pi1 = flow ? p_init[pb + a.N] : 0.0f;
    const float pr0 = pt_ref[n], pr1 = pt_ref[a.N + n];
    // depth moves along x only: pt = (pt_ref.x + p, pt_ref.y)
    const float pt0x = pr0 + pi0, pt0y = flow ? pr1 + pi1 : pr1;

    // OptimizeStart (patch.cpp:118-154)
    p0 = pi0;
    p1 = pi1;
    float r0 = 0.0f, r1 = 0.0f, mares = 0.0f;
    bool active;
    if (out_of_bounds(pt0x, pt0y, a)) {
      // documented deviation: residual = template, weight from the template
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float dense = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float pd, w;
          loss(tm[k * C + c], a.costfct, pd, w);
          const float wc = fmaxf(w, kMinErrVal);
          dense = c == 0 ? wc : dense + wc;
        }
        pw[k] = dense;
      }
      active = false;
    } else {
      error_at<K, C>(imb, pt0x, pt0y, psz, lane, a, flow, off, valid, tm, tx,
                     ty, r0, r1, pw, mares);
      active = a.max_iter > 0 && mares > a.res_thresh;
    }

    // Each trip's step is taken at the end of the trip before (the first
    // before the loop), beside the stopping test rather than after it, so
    // that the two overlap; the step after the last trip goes unused.
    float dp0, dp1, q0, q1, qx, qy;
    bool reset;
    step(a, flow, h00, h01, h11, r0, r1, p0, p1, pi0, pi1, pr0, pr1, pt0x,
         pt0y, dp0, dp1, q0, q1, qx, qy, reset);
    float dpn_init = 1e-10f;
    for (int it = 1; it <= a.max_iter && active; ++it) {
      trips = it;
      float mn;
      error_at<K, C>(imb, qx, qy, psz, lane, a, flow, off, valid, tm, tx, ty,
                     r0, r1, pw, mn);
      const float dsq = dp0 * dp0 + dp1 * dp1;
      if (it == 1) dpn_init = dsq;
      // convergence predicate with min_iter gating (patch.cpp:287-293)
      const bool gate = it < a.min_iter;
      const bool keep = it < a.max_iter && mn > a.res_thresh &&
                        (gate || dsq / dpn_init >= a.dp_thresh_sq) &&
                        (gate || mn / mares <= a.dr_thresh);
      p0 = q0;
      p1 = q1;
      mares = mn;
      active = keep && !reset;
      step(a, flow, h00, h01, h11, r0, r1, p0, p1, pi0, pi1, pr0, pr1, pt0x,
           pt0y, dp0, dp1, q0, q1, qx, qy, reset);
    }
    if (lane == 0) {
      p_out[pb] = p0;
      if (flow) p_out[pb + a.N] = p1;
      if (trips > 0) atomicMax(iters, trips);
    }
  }

  // pweight (B, psz^2, N), channel-summed
  if (owner) {
    float* po = pw_out + static_cast<size_t>(b) * p_tot * a.N + n;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (valid[k]) po[static_cast<size_t>(lane + 32 * k) * a.N] = pw[k];
  }
}

template <int K, int C, int P = 0>
cudaError_t launch(const float* im, const float* tmpl, const float* tdx,
                   const float* tdy, const float* hes, const float* p_init,
                   const float* pt_ref, float* p_out, float* pw_out,
                   int* iters, const GNArgs& a, cudaStream_t stream) {
  const long long patches = static_cast<long long>(a.B) * a.N;
  const long long blocks = (patches + kWarps - 1) / kWarps;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gn_fused_kernel<K, C, P><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(im, tmpl, tdx, tdy, hes, p_init,
                                       pt_ref, p_out, pw_out, iters, a);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* im, const float* tmpl, const float* tdx,
                     const float* tdy, const float* hes, const float* p_init,
                     const float* pt_ref, float* p_out, float* pw_out,
                     int* iters, const GNArgs& a, cudaStream_t s) {
  // op-1 / op-2's patch size, and op-3 / op-4's, have their own instances
  if (a.psz == 8)
    return launch<2, C, 8>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                           pw_out, iters, a, s);
  if (a.psz == 12)
    return launch<5, C, 12>(im, tmpl, tdx, tdy, hes, p_init, pt_ref, p_out,
                            pw_out, iters, a, s);
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
  if ((nop != 1 && nop != 2) || (camlr != 0 && camlr != 1) || psz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1)
    return static_cast<int>(dispatch<1>(im, tmpl, tdx, tdy, hes, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  if (C == 3)
    return static_cast<int>(dispatch<3>(im, tmpl, tdx, tdy, hes, p_init,
                                        pt_ref, p_out, pw_out, iters, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
