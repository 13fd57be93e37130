// T2 — per-stage ablation of the Gauss-Newton iteration: where do the
// microseconds of one trip of the GN kernels (K1, K6) go? Each launch runs
// max_iter trips of one cumulative stage for every patch of a batch, on
// random templates and integer anchors that move every trip, and chains
// what the stage computes into a per-patch checksum, so nothing is dead.
//
// Replaces: tools/bench_gn_stages.py::main.make (the TPU kernel that times
// the stages of the Pallas GN kernel's extraction: one-hot dot, band select,
// roll, bilinear, loss and projections).
//
// Stages (cumulative), the device code of the production kernels — the
// taps and the lerp of gn_common.cuh that gn::extract calls:
//   W   the four tap loads per pixel (gn::taps), their sum;
//   A3  + the bilinear interpolation (gn::lerp), the patch sum;
//   A4  + the patch mean (one butterfly a trip), the residual against the
//       template, sum |residual| / psz^2 and the two projections.
// Variants of A4, each the same function bit for bit:
//   smem  each warp stages its (psz+1)^2 window in shared memory with
//         coalesced loads, and its lanes read the taps from there;
//   u16   16-bit integer planes of value * 4^lv (exact for lv <= 4: the
//         level values of u8 frames are multiples of 4^-lv), converted to
//         float after the load;
//   both  smem and u16 together.
// Trip i samples the window at (sx0 + i, sy0 + 3 (i % 2)) with residuals
// ry = 0.25 + 0.001 i, rx = 0.5 - 0.001 i, as the TPU tool does.
//
// Bound on an H100: at the tool's geometries neither bytes (the templates
// and gradients read once) nor operations (~18 float operations a pixel and
// trip) come near the card's rates; like K1 and K6, a warp's chain of
// dependent window loads and lane sums over max_iter trips is the limit.
//
// Design: one warp per patch, K pixels a lane (pixel lane + 32k), as K1 and
// K6. Each lane accumulates its own sums across the trips and the warp
// reduces them once after the loop, so a stage pays for no butterfly that
// the production trip does not have (A4's mean is the one it pays every
// trip). Out: one checksum per patch and pair.

#include "gn_common.cuh"

namespace {

enum Stage { kW = 0, kA3 = 1, kA4 = 2 };

struct StageArgs {
  int B, N, Hp, Wp, psz, max_iter;
  float scale;  // plane element -> value: 1 for float, 4^-lv for u16
};

template <int STAGE, bool SMEM, typename T, int K>
__global__ void gn_stages_kernel(const T* __restrict__ planes,
                                 const float* __restrict__ tmpl,
                                 const float* __restrict__ tdx,
                                 const float* __restrict__ tdy,
                                 const int* __restrict__ sx0,
                                 const int* __restrict__ sy0,
                                 float* __restrict__ out, StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * a.N) return;  // whole warps only: blockDim % 32 == 0
  const int b = warp / a.N;
  const int p_tot = a.psz * a.psz;
  const int w1 = a.psz + 1;
  const T* im = planes + static_cast<size_t>(b) * a.Hp * a.Wp;
  T* win = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * w1 * w1;

  // templates (B, N, psz^2): one patch's pixels are contiguous
  float tm[K], tx[K], ty[K];
  if (STAGE == kA4) {
    const size_t base = static_cast<size_t>(warp) * p_tot;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      const bool v = d < p_tot;
      tm[k] = v ? tmpl[base + d] : 0.0f;
      tx[k] = v ? tdx[base + d] : 0.0f;
      ty[k] = v ? tdy[base + d] : 0.0f;
    }
  }
  const int ax = sx0[warp], ay = sy0[warp];
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int i = 0; i < a.max_iter; ++i) {
    const int sx = ax + i, sy = ay + 3 * (i % 2);
    const float ry = 0.25f + 0.001f * static_cast<float>(i);
    const float rx = 0.5f - 0.001f * static_cast<float>(i);
    if (SMEM) {
      // the window's rows and columns clamped as gn::taps clamps them, so
      // the taps read from it equal those read from the planes
      for (int t = lane; t < w1 * w1; t += 32) {
        const int r = t / w1, c = t - (t / w1) * w1;
        const int y = min(max(sy + r, 0), a.Hp - 1);
        const int x = min(max(sx + c, 0), a.Wp - 1);
        win[t] = im[y * a.Wp + x];
      }
      __syncwarp();
    }
    // the taps, then the lerp, as gn::extract runs them
    float v00[K], v01[K], v10[K], v11[K];
    if (SMEM)
      gn::taps<K, 1>(win, w1, w1, 0, 0, a.psz, lane, a.scale, v00, v01, v10,
                     v11);
    else
      gn::taps<K, 1>(im, a.Hp, a.Wp, sx, sy, a.psz, lane, a.scale, v00, v01,
                     v10, v11);
    if (SMEM) __syncwarp();  // every lane has read the window
    if (STAGE == kW) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc0 += ((v00[k] + v01[k]) + v10[k]) + v11[k];
      continue;
    }
    float px[K];
    gn::lerp(v00, v01, v10, v11, rx, ry, px);
    if (STAGE == kA3) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc0 += px[k];  // 0 beyond psz^2
      continue;
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) s += px[k];
    const float mean = gn::warp_sum(s) / static_cast<float>(p_tot);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < p_tot) {
        const float pd = (px[k] - mean) - tm[k];
        acc0 += fabsf(pd);
        acc1 += tx[k] * pd;
        acc2 += ty[k] * pd;
      }
    }
  }
  float r = gn::warp_sum(acc0);
  if (STAGE == kA4) {
    r = r / static_cast<float>(p_tot) + gn::warp_sum(acc1);
    r = r + gn::warp_sum(acc2);
  }
  if (lane == 0) out[warp] = r;
}

template <int STAGE, bool SMEM, typename T>
cudaError_t launch_k(int K, const void* planes, const float* tmpl,
                     const float* tdx, const float* tdy, const int* sx0,
                     const int* sy0, float* out, const StageArgs& a,
                     cudaStream_t s) {
  constexpr int kThreads = 256;  // 8 patches per block
  const long long threads = static_cast<long long>(a.B) * a.N * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (blocks == 0) return cudaSuccess;
  const size_t shm =
      SMEM ? (kThreads / 32) * (a.psz + 1) * (a.psz + 1) * sizeof(T) : 0;
  const T* p = static_cast<const T*>(planes);
  switch (K) {
#define OF_GN_STAGES_K(KK)                                                  \
  case KK:                                                                  \
    gn_stages_kernel<STAGE, SMEM, T, KK><<<blocks, kThreads, shm, s>>>(     \
        p, tmpl, tdx, tdy, sx0, sy0, out, a);                               \
    break;
    OF_GN_STAGES_K(1)
    OF_GN_STAGES_K(2)
    OF_GN_STAGES_K(3)
    OF_GN_STAGES_K(4)
    OF_GN_STAGES_K(5)
#undef OF_GN_STAGES_K
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry (bound with ctypes). planes (B, Hp, Wp): float32, or uint16 of
// value * 4^lv for variants 2 and 3 (scale = 4^-lv); tmpl / tdx / tdy
// (B, N, psz^2) float32 (read by stage 2 only); sx0 / sy0 (B, N) int32
// window anchors of trip 0; out (B, N) float32. stage 0 W, 1 A3, 2 A4;
// variant (stage 2 only) 0 none, 1 smem, 2 u16, 3 smem + u16. psz <= 12
// (at most 5 pixels a lane). Returns the launch's cudaError_t.
extern "C" int of_gn_stages(const void* planes, const float* tmpl,
                            const float* tdx, const float* tdy,
                            const int* sx0, const int* sy0, float* out,
                            int B, int N, int Hp, int Wp, int psz,
                            int max_iter, float scale, int stage,
                            int variant, void* stream) {
  const StageArgs a{B, N, Hp, Wp, psz, max_iter, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (psz * psz + 31) / 32;
  if (psz < 1 || K > 5 || stage < 0 || stage > 2 || variant < 0 ||
      variant > 3 || (variant != 0 && stage != kA4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stage == kW)
    return static_cast<int>(launch_k<kW, false, float>(
        K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
  if (stage == kA3)
    return static_cast<int>(launch_k<kA3, false, float>(
        K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
  switch (variant) {
    case 0:
      return static_cast<int>(launch_k<kA4, false, float>(
          K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
    case 1:
      return static_cast<int>(launch_k<kA4, true, float>(
          K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
    case 2:
      return static_cast<int>(launch_k<kA4, false, unsigned short>(
          K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
    default:
      return static_cast<int>(launch_k<kA4, true, unsigned short>(
          K, planes, tmpl, tdx, tdy, sx0, sy0, out, a, s));
  }
}
