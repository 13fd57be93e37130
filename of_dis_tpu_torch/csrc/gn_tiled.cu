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
// times the source planes at patch size 12, overlap 0.75; here a patch's
// lanes read its psz^2 template pixels straight from the source image and
// its two gradient planes at the patch's integer grid position, once.
//
// What held the first design (one warp a patch, lane l on the pixels
// l + 32k) was the bilinear window's loads: 4 taps x ceil(psz^2 / 32)
// scattered 4-byte loads a lane and trip (20 at psz 12), each warp load
// spanning ~3 patch rows, half of level 0's time in the taps alone
// (PERF.md, T2). Design now: lanes on window columns, several patches a
// warp. A patch owns a segment of S lanes, S the smallest power of two
// above psz (16 at psz 8-12: two patches a warp; 8 at psz 4-7: four), and
// lane i of a segment holds column i of the patch — the pixels (j, i),
// j < psz, all C channels — for the whole loop: template and gradients in
// registers. An extraction loads the (psz+1)^2 window row by row, lane i
// column i (lane psz the window's right column): psz + 1 loads a channel,
// each one contiguous run of psz + 1 floats a patch (6.5 load instructions
// a patch and trip at psz 12, gray, against 20), takes the y-lerp in
// registers and the x-lerp's right-hand column from lane i + 1 with one
// shuffle. The lerps' operations and order are gn_common.cuh's `lerp`;
// the window, its lerps and the segment sums live there too, shared with
// T2's column layout. Patch sums add each lane's
// elements in (row j, channel c) order, then a butterfly over the
// segment's S lanes (4 steps at S = 16, shared by the warp's patches); the
// plain twin (patch_solver._gn_tiled_plain through _column_sum) sums in the
// same order. A warp runs its trips while any of its patches is active; a
// patch that has stopped keeps its state and only lends its lanes to the
// shuffles. The loop carries the two projections (rhs) instead of the
// residual image and no splat weight: extraction is a pure function of
// the position, so one extraction at the final position after the loop
// gives the weight the loop would have carried, bit for bit. None of the
// TPU kernel's devices carries over (tiles and their VMEM windows, window
// validity and the fix-up passes, bf16 hi/lo planes, one-hot dots, band
// select, the extraction cache). `iters` is the atomicMax of the patches'
// trip counts.

#include "gn_common.cuh"

namespace {

using namespace gn;  // GNArgs, kFull, loss, out_of_bounds, seg_sum,
                    // lane_total, cols_patch

constexpr int kThreads = 128;  // 4 warps a block
// blocks an SM should hold for a gray level: caps the registers a thread
// at 65536 / (5 * 128) = 102, five blocks (20 warps) an SM, to hide the
// loads' and shuffles' latency (RGB keeps three times the registers and no
// cap)
constexpr int kMinBlocks = 5;
constexpr int kMaxPsz = 12;

// Bilinear patch at float position (x, y) (patch.cpp:346-413): anchor
// ceil(pt + 1e-5), residual against floor(pt); the window's column and
// its lerps are gn::cols_patch's (gn_common.cuh, shared with T2). out[j *
// C + c] is pixel (j, col), channel c, where col < psz and j < psz;
// elsewhere a finite value that the sums leave out (lane_total, err_rhs).
template <int R, int C>
__device__ __forceinline__ void extract_cols(const float* im, float x,
                                             float y, int col,
                                             const GNArgs& a,
                                             float (&out)[R * C]) {
  const float rx = x - floorf(x);
  const float ry = y - floorf(y);
  const int sx = static_cast<int>(ceilf(x + 1e-5f)) - a.psz / 2 - 1 + a.pad;
  const int sy = static_cast<int>(ceilf(y + 1e-5f)) - a.psz / 2 - 1 + a.pad;
  cols_patch<R, C>(im, a.Hp, a.Wp, a.psz, sx, sy, rx, ry, col, 1.0f, out);
}

// Mean-normalised (when patnorm) bilinear patch at (x, y); elements
// outside the patch hold 0 - mean and are masked by the callers.
template <int S, int R, int C>
__device__ __forceinline__ void patch_at(const float* im, float x, float y,
                                         int col, const GNArgs& a,
                                         float (&patch)[R * C]) {
  extract_cols<R, C>(im, x, y, col, a, patch);
  if (a.patnorm > 0) {
    const float mean =
        seg_sum<S>(lane_total<R, C>(patch, a.psz, col < a.psz)) /
        static_cast<float>(a.psz * a.psz * C);
#pragma unroll
    for (int e = 0; e < R * C; ++e) patch[e] = patch[e] - mean;
  }
}

// Error at (x, y), reduced: the steepest-descent projections r0, r1 of the
// residual on the template gradients (patch.cpp:175-180) and the mean raw
// weight over all psz^2 C elements.
template <int S, int R, int C>
__device__ __forceinline__ void err_rhs(const float* im, float x, float y,
                                        int col, const GNArgs& a,
                                        const float (&tm)[R * C],
                                        const float (&tx)[R * C],
                                        const float (&ty)[R * C], float& r0,
                                        float& r1, float& mares) {
  float patch[R * C];
  patch_at<S, R, C>(im, x, y, col, a, patch);
  float wsum = 0.0f, s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = j * C + c;
      float pd, w;
      loss(patch[e] - tm[e], a.costfct, pd, w);
      if (e == 0) {
        wsum = w;
        s0 = tx[e] * pd;
        s1 = ty[e] * pd;
      } else if (j < a.psz) {
        wsum = wsum + w;
        s0 = s0 + tx[e] * pd;
        s1 = s1 + ty[e] * pd;
      }
    }
  }
  // a lane without a column adds 0 (its elements are not the patch's)
  const bool valid_col = col < a.psz;
  wsum = valid_col ? wsum : 0.0f;
  s0 = valid_col ? s0 : 0.0f;
  s1 = valid_col ? s1 : 0.0f;
  r0 = seg_sum<S>(s0);
  r1 = a.nop == 2 ? seg_sum<S>(s1) : 0.0f;
  mares = seg_sum<S>(wsum) / a.novals;
}

// P > 0: the patch size is the constant P (op-3's and op-4's 12 has its
// own instance: with the row guards and offsets folded, 9% less of level
// 0's time on an NVIDIA H100 at 700 W, PERF.md); P = 0: a.psz.
template <int S, int C, int P>
__global__ void __launch_bounds__(kThreads, C == 1 ? kMinBlocks : 1)
    gn_tiled_kernel(const float* __restrict__ im,
                    const float* __restrict__ src_im,
                    const float* __restrict__ src_dx,
                    const float* __restrict__ src_dy,
                    const float* __restrict__ p_init,
                    const float* __restrict__ pt_ref,
                    float* __restrict__ p_out, float* __restrict__ pw_out,
                    int* __restrict__ iters, GNArgs args) {
  GNArgs a = args;
  if constexpr (P > 0) a.psz = P;
  constexpr int R = S - 1 < kMaxPsz ? S - 1 : kMaxPsz;  // rows a lane holds
  constexpr int E = R * C;
  constexpr int kPatches = 32 / S;                         // patches a warp
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int col = lane % S;
  const long long total = static_cast<long long>(a.B) * a.N;
  // whole warps only (blockDim % 32 == 0): the exit is warp-uniform
  if (warp * kPatches >= total) return;
  // a slot past the last patch runs the last patch again and writes nothing
  const long long slot = warp * kPatches + lane / S;
  const bool owner = slot < total;
  const long long patch = owner ? slot : total - 1;
  const int b = static_cast<int>(patch / a.N);
  const int n = static_cast<int>(patch - static_cast<long long>(b) * a.N);
  const int psz = a.psz;
  const bool flow = a.nop == 2;
  const bool valid_col = col < psz;
  const size_t pair = static_cast<size_t>(b) * C * a.Hp * a.Wp;
  const float* imb = im + pair;
  const int plane = a.Hp * a.Wp;

  const size_t pb = static_cast<size_t>(b) * a.nop * a.N + n;
  const float pi0 = p_init[pb], pi1 = flow ? p_init[pb + a.N] : 0.0f;
  const float ref_x = pt_ref[n], ref_y = pt_ref[a.N + n];

  // Templates at the integer anchor of the grid position (never through
  // ceil(pt + 1e-5): the float32 sum rounds the 1e-5 away from 256 px on).
  const int ax = static_cast<int>(ref_x) - (psz + 1) / 2 + a.pad;
  const int ay = static_cast<int>(ref_y) - (psz + 1) / 2 + a.pad;
  float tm[E], tx[E], ty[E];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool v = valid_col && j < psz;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = pair + static_cast<size_t>(c) * plane +
                       static_cast<size_t>(ay + j) * a.Wp + (ax + col);
      tm[j * C + c] = v ? src_im[o] : 0.0f;
      tx[j * C + c] = v ? src_dx[o] : 0.0f;
      ty[j * C + c] = v && flow ? src_dy[o] : 0.0f;
    }
  }
  if (a.patnorm > 0) {
    const float mean = seg_sum<S>(lane_total<R, C>(tm, psz, valid_col)) /
                       static_cast<float>(psz * psz * C);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool v = valid_col && j < psz;
#pragma unroll
      for (int c = 0; c < C; ++c)
        tm[j * C + c] = v ? tm[j * C + c] - mean : 0.0f;
    }
  }
  // Hessian with the singular guard (patch.cpp:69-86)
  float q00[E], q01[E], q11[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    q00[e] = tx[e] * tx[e];
    q01[e] = tx[e] * ty[e];
    q11[e] = ty[e] * ty[e];
  }
  float h00 = seg_sum<S>(lane_total<R, C>(q00, psz, valid_col));
  float h01 = 0.0f, h11 = 0.0f;
  if (flow) {
    h01 = seg_sum<S>(lane_total<R, C>(q01, psz, valid_col));
    h11 = seg_sum<S>(lane_total<R, C>(q11, psz, valid_col));
    // the determinant as one fmaf here and in the solve (the twin's
    // `_det_zero` and `_fms`)
    const float guard =
        fmaf(h00, h11, -(h01 * h01)) == 0.0f ? 1e-10f : 0.0f;
    h00 = h00 + guard;
    h11 = h11 + guard;
  } else {
    h00 = h00 + (h00 == 0.0f ? 1e-10f : 0.0f);
  }

  // depth moves along x only: pt = (pt_ref.x + p, pt_ref.y)
  const float pt0x = ref_x + pi0, pt0y = flow ? ref_y + pi1 : ref_y;
  const bool init_oob = out_of_bounds(pt0x, pt0y, a);

  // OptimizeStart (patch.cpp:118-154). A patch that starts out of bounds
  // is never active: its projections are not needed, and its weight is the
  // template's (the documented deviation), taken after the loop; its lanes
  // still take part in the segment's shuffles, at its reference position.
  float p0 = pi0, p1 = pi1;
  float r0 = 0.0f, r1 = 0.0f, mares = 0.0f;
  err_rhs<S, R, C>(imb, init_oob ? ref_x : pt0x, init_oob ? ref_y : pt0y,
                   col, a, tm, tx, ty, r0, r1, mares);
  bool active = !init_oob && a.max_iter > 0 && mares > a.res_thresh;

  float dpn_init = 1e-10f;
  int trips = 0;
  for (int it = 1; it <= a.max_iter && __any_sync(kFull, active); ++it) {
    float dp0, dp1, q0, q1, qx, qy;
    if (flow) {
      const float det = fmaf(h00, h11, -(h01 * h01));
      dp0 = fmaf(h11, r0, -(h01 * r1)) / det;
      dp1 = fmaf(h00, r1, -(h01 * r0)) / det;
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
    // a stopped patch extracts at its final position (in bounds)
    if (!active) {
      qx = ref_x + p0;
      qy = flow ? ref_y + p1 : ref_y;
    }
    float rn0, rn1, mn;
    err_rhs<S, R, C>(imb, init_oob ? ref_x : qx, init_oob ? ref_y : qy, col,
                     a, tm, tx, ty, rn0, rn1, mn);
    if (active) {
      trips = it;
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
  }

  if (owner && col == 0) {
    p_out[pb] = p0;
    if (flow) p_out[pb + a.N] = p1;
    if (trips > 0) atomicMax(iters, trips);
  }

  // Splat weight (B, psz^2, N), sum_c max(w_c, MINERRVAL)
  // (patchgrid.cpp:253-260), from one extraction at the final position;
  // a patch that started out of bounds takes its template's weight.
  float fin[E];
  patch_at<S, R, C>(imb, init_oob ? ref_x : ref_x + p0,
                    init_oob || !flow ? ref_y : ref_y + p1, col, a, fin);
#pragma unroll
  for (int e = 0; e < E; ++e) fin[e] = init_oob ? tm[e] : fin[e] - tm[e];
  const size_t wb = static_cast<size_t>(b) * psz * psz * a.N + n;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float dense = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float pd, w;
      loss(fin[j * C + c], a.costfct, pd, w);
      const float wc = fmaxf(w, kMinErrVal);
      dense = c == 0 ? wc : dense + wc;
    }
    if (owner && valid_col && j < psz)
      pw_out[wb + static_cast<size_t>(j * psz + col) * a.N] = dense;
  }
}

template <int S, int C, int P = 0>
cudaError_t launch(const float* im, const float* src_im, const float* src_dx,
                   const float* src_dy, const float* p_init,
                   const float* pt_ref, float* p_out, float* pw_out,
                   int* iters, const GNArgs& a, cudaStream_t stream) {
  constexpr int kPatchesPerBlock = kThreads / S;
  const long long patches = static_cast<long long>(a.B) * a.N;
  const long long blocks =
      (patches + kPatchesPerBlock - 1) / kPatchesPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gn_tiled_kernel<S, C, P><<<static_cast<unsigned>(blocks), kThreads, 0,
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
  // the segment: the smallest power of two above psz
  if (a.psz < 1 || a.psz > kMaxPsz) return cudaErrorInvalidValue;
  if (a.psz < 2)
    return launch<2, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                        pw_out, iters, a, s);
  if (a.psz < 4)
    return launch<4, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                        pw_out, iters, a, s);
  if (a.psz < 8)
    return launch<8, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                        pw_out, iters, a, s);
  if (a.psz == 12)
    return launch<16, C, 12>(im, src_im, src_dx, src_dy, p_init, pt_ref,
                             p_out, pw_out, iters, a, s);
  return launch<16, C>(im, src_im, src_dx, src_dy, p_init, pt_ref, p_out,
                       pw_out, iters, a, s);
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
