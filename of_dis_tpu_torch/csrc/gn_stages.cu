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
// Each stage runs on the layout, block size and register cap of the
// production kernel it attributes, through that kernel's own device code
// in gn_common.cuh, so its differences are that kernel's:
//  - layout 0, lanes (K1, gn_fused.cu): one warp a patch, 4 patches a
//    block; lane l holds the pixels l + 32k, their offsets computed once
//    (gn::lane_pixels); interior windows read at those offsets without
//    clamps, border windows through gn::taps (gn::lane_taps); patch sums
//    by warp butterflies; psz 8 its own instance (K1's cap of 8 blocks an
//    SM), any psz <= 12 a run-time instance;
//  - layout 1, columns (K6, gn_tiled.cu): a segment of 16 lanes a patch,
//    two patches a warp, 4 warps a block (K6's cap of 5 blocks an SM);
//    lane i holds column i: psz + 1 row loads a trip (gn::window_cols),
//    the y-lerp in registers and the x-lerp's right column from lane i + 1
//    by __shfl_down_sync (gn::lerp_cols); patch sums by gn::seg_sum<16>;
//    psz 12 its own instance, any psz <= 12 a run-time instance.
//
// Stages (cumulative), each the same function on both layouts:
//   W   the window's tap loads: the sum of the four taps of every pixel
//       (lanes: gn::lane_taps and three adds a pixel; columns: the window
//       column's psz + 1 loads, each times the number of pixels that read
//       it, 1, 2 or 4: exact, so no shuffle is needed);
//   A3  + the bilinear interpolation (lanes gn::lerp, columns
//       gn::lerp_cols with its shuffle), the patch sum;
//   A4  + the patch mean (one butterfly a trip), the residual against the
//       template, sum |residual| / psz^2 and the two projections.
// Variants of A4, each the same function bit for bit:
//   smem  each warp stages its windows in shared memory (lanes: its one
//         (psz+1)^2 window; columns: its two, row by row) with coalesced
//         loads, and its lanes read the taps from there;
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
// Each lane accumulates its own sums across the trips, in (trip, pixel k)
// order on lanes and (trip, row j) order on columns, and its warp or
// segment reduces them once after the loop, so a stage pays for no
// butterfly that the production trip does not have (A4's mean is the one
// it pays every trip). The plain twin (kernels/gn_stages.py::_plain) sums
// in the same orders. Out: one checksum per patch and pair.

#include "gn_common.cuh"

namespace {

using namespace gn;  // kFull, warp_sum, lane_pixels, lane_taps, lerp,
                     // seg_sum, lane_total, window_cols, lerp_cols

enum Stage { kW = 0, kA3 = 1, kA4 = 2 };
enum Layout { kLanes = 0, kColumns = 1 };

struct StageArgs {
  int B, N, Hp, Wp, psz, max_iter;
  float scale;  // plane element -> value: 1 for float, 4^-lv for u16
};

constexpr int kThreads = 128;  // 4 warps a block, as K1 and K6
constexpr int kSeg = 16;       // lanes a patch on the column layout
constexpr int kRows = 12;      // rows a lane holds there (psz <= 12)

// K1's register cap for its gray patch size 8 (8 blocks an SM), none
// otherwise (gn_fused.cu, MinBlocks); K6's for gray levels (gn_tiled.cu).
template <int P>
struct LaneMinBlocks {
  static constexpr int value = P == 8 ? 8 : 1;
};
constexpr int kColMinBlocks = 5;

// Trip i's window anchor and residuals.
__device__ __forceinline__ void trip(int i, int ax, int ay, int& sx, int& sy,
                                     float& rx, float& ry) {
  sx = ax + i;
  sy = ay + 3 * (i % 2);
  ry = 0.25f + 0.001f * static_cast<float>(i);
  rx = 0.5f - 0.001f * static_cast<float>(i);
}

// Layout 0: one warp per patch, K pixels a lane; P > 0 the constant patch
// size, else a.psz.
template <int STAGE, bool SMEM, typename T, int K, int P>
__global__ void __launch_bounds__(kThreads, LaneMinBlocks<P>::value)
    stages_lanes(const T* __restrict__ planes, const float* __restrict__ tmpl,
                 const float* __restrict__ tdx, const float* __restrict__ tdy,
                 const int* __restrict__ sx0, const int* __restrict__ sy0,
                 float* __restrict__ out, StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int psz = P > 0 ? P : a.psz;
  const int p_tot = psz * psz;
  const int w1 = psz + 1;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long patch =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + wib;
  // whole warps only: the exit is warp-uniform
  if (patch >= static_cast<long long>(a.B) * a.N) return;
  const int b = static_cast<int>(patch / a.N);
  const T* im = planes + static_cast<size_t>(b) * a.Hp * a.Wp;
  T* win = reinterpret_cast<T*>(smem_raw) + wib * w1 * w1;

  // the pixels' offsets from the window's corner, in the planes or in the
  // shared-memory window
  int off[K];
  bool valid[K];
  lane_pixels<K>(psz, SMEM ? w1 : a.Wp, lane, off, valid);

  // templates (B, N, psz^2): one patch's pixels are contiguous
  float tm[K], tx[K], ty[K];
  if (STAGE == kA4) {
    const size_t base = static_cast<size_t>(patch) * p_tot;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const size_t o = base + lane + 32 * k;
      tm[k] = valid[k] ? tmpl[o] : 0.0f;
      tx[k] = valid[k] ? tdx[o] : 0.0f;
      ty[k] = valid[k] ? tdy[o] : 0.0f;
    }
  }
  const int ax = sx0[patch], ay = sy0[patch];
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int i = 0; i < a.max_iter; ++i) {
    int sx, sy;
    float rx, ry;
    trip(i, ax, ay, sx, sy, rx, ry);
    float v00[K], v01[K], v10[K], v11[K];
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
      lane_taps<K, 1>(win, w1, w1, 0, 0, psz, lane, a.scale, off, valid, v00,
                      v01, v10, v11);
      __syncwarp();  // every lane has read the window
    } else {
      lane_taps<K, 1>(im, a.Hp, a.Wp, sx, sy, psz, lane, a.scale, off, valid,
                      v00, v01, v10, v11);
    }
    if (STAGE == kW) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc0 += ((v00[k] + v01[k]) + v10[k]) + v11[k];
      continue;
    }
    float px[K];
    lerp(v00, v01, v10, v11, rx, ry, px);
    if (STAGE == kA3) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc0 += px[k];  // 0 beyond psz^2
      continue;
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) s += px[k];
    const float mean = warp_sum(s) / static_cast<float>(p_tot);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (valid[k]) {
        const float pd = (px[k] - mean) - tm[k];
        acc0 += fabsf(pd);
        acc1 += tx[k] * pd;
        acc2 += ty[k] * pd;
      }
    }
  }
  float r = warp_sum(acc0);
  if (STAGE == kA4) {
    r = r / static_cast<float>(p_tot) + warp_sum(acc1);
    r = r + warp_sum(acc2);
  }
  if (lane == 0) out[patch] = r;
}

// Layout 1: a segment of kSeg lanes per patch, two patches a warp, lane
// `col` on column col; P > 0 the constant patch size, else a.psz.
template <int STAGE, bool SMEM, typename T, int P>
__global__ void __launch_bounds__(kThreads, kColMinBlocks)
    stages_columns(const T* __restrict__ planes,
                   const float* __restrict__ tmpl,
                   const float* __restrict__ tdx,
                   const float* __restrict__ tdy,
                   const int* __restrict__ sx0, const int* __restrict__ sy0,
                   float* __restrict__ out, StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = kRows, S = kSeg, kPatches = 32 / S;
  const int psz = P > 0 ? P : a.psz;
  const int p_tot = psz * psz;
  const int w1 = psz + 1;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int col = lane % S, seg = lane / S;
  const long long total = static_cast<long long>(a.B) * a.N;
  // whole warps only (blockDim % 32 == 0): the exit is warp-uniform
  if (warp * kPatches >= total) return;
  // a slot past the last patch runs the last patch again and writes nothing
  const long long slot = warp * kPatches + seg;
  const bool owner = slot < total;
  const long long patch = owner ? slot : total - 1;
  const int b = static_cast<int>(patch / a.N);
  const T* im = planes + static_cast<size_t>(b) * a.Hp * a.Wp;
  const bool valid_col = col < psz;

  // templates (B, N, psz^2): lane col holds column col, rows j < psz
  float tm[R], tx[R], ty[R];
  if (STAGE == kA4) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool v = valid_col && j < psz;
      const size_t o = static_cast<size_t>(patch) * p_tot + j * psz + col;
      tm[j] = v ? tmpl[o] : 0.0f;
      tx[j] = v ? tdx[o] : 0.0f;
      ty[j] = v ? tdy[o] : 0.0f;
    }
  }
  const int ax = sx0[patch], ay = sy0[patch];
  // the shared-memory variant stages both windows of the warp: each lane
  // needs both patches' planes and anchors
  const T* imq[kPatches];
  int axq[kPatches], ayq[kPatches];
  if (SMEM) {
#pragma unroll
    for (int q = 0; q < kPatches; ++q) {
      const long long sq = warp * kPatches + q;
      const long long pq = sq < total ? sq : total - 1;
      imq[q] = planes + static_cast<size_t>(pq / a.N) * a.Hp * a.Wp;
      axq[q] = sx0[pq];
      ayq[q] = sy0[pq];
    }
  }
  T* wins = reinterpret_cast<T*>(smem_raw) +
            (threadIdx.x >> 5) * kPatches * w1 * w1;
  // the pixels that read window column col: 1 at the window's first and
  // last column, else 2 (and the same for rows)
  const float cx = col == 0 || col == psz ? 1.0f : 2.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int i = 0; i < a.max_iter; ++i) {
    int sx, sy;
    float rx, ry;
    trip(i, ax, ay, sx, sy, rx, ry);
    float w[R + 1];
    if (SMEM) {
      // window q's element t: row t / w1, column t % w1, clamped to the
      // planes as gn::window_cols clamps them; rows are contiguous runs
      const int n_win = w1 * w1;
      for (int t = lane; t < kPatches * n_win; t += 32) {
        const int q = t / n_win, e = t - q * n_win;
        const int r = e / w1, c = e - r * w1;
        const int y = min(max(ayq[q] + 3 * (i % 2) + r, 0), a.Hp - 1);
        const int x = min(max(axq[q] + i + c, 0), a.Wp - 1);
        wins[t] = imq[q][y * a.Wp + x];
      }
      __syncwarp();
      window_cols<R, 1>(wins + seg * n_win, w1, w1, psz, 0, 0, col, a.scale,
                        w);
      __syncwarp();  // every lane has read the windows
    } else {
      window_cols<R, 1>(im, a.Hp, a.Wp, psz, sx, sy, col, a.scale, w);
    }
    if (STAGE == kW) {
      if (col <= psz) {
#pragma unroll
        for (int r = 0; r <= R; ++r) {
          if (r <= psz) {
            const float cy = r == 0 || r == psz ? 1.0f : 2.0f;
            acc0 += (cy * cx) * w[r];
          }
        }
      }
      continue;
    }
    float px[R];
    lerp_cols<R, 1>(w, rx, ry, px);
    if (STAGE == kA3) {
      if (valid_col) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (j < psz) acc0 += px[j];
      }
      continue;
    }
    const float mean = seg_sum<S>(lane_total<R, 1>(px, psz, valid_col)) /
                       static_cast<float>(p_tot);
    if (valid_col) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j < psz) {
          const float pd = (px[j] - mean) - tm[j];
          acc0 += fabsf(pd);
          acc1 += tx[j] * pd;
          acc2 += ty[j] * pd;
        }
      }
    }
  }
  float r = seg_sum<S>(acc0);
  if (STAGE == kA4) {
    r = r / static_cast<float>(p_tot) + seg_sum<S>(acc1);
    r = r + seg_sum<S>(acc2);
  }
  if (owner && col == 0) out[patch] = r;
}

struct Ptrs {
  const void* planes;
  const float *tmpl, *tdx, *tdy;
  const int *sx0, *sy0;
  float* out;
};

template <int STAGE, bool SMEM, typename T, int K, int P>
cudaError_t launch_lanes(const Ptrs& p, const StageArgs& a, cudaStream_t s) {
  const long long patches = static_cast<long long>(a.B) * a.N;
  const long long blocks = (patches + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t shm =
      SMEM ? (kThreads / 32) * (a.psz + 1) * (a.psz + 1) * sizeof(T) : 0;
  stages_lanes<STAGE, SMEM, T, K, P>
      <<<static_cast<unsigned>(blocks), kThreads, shm, s>>>(
          static_cast<const T*>(p.planes), p.tmpl, p.tdx, p.tdy, p.sx0, p.sy0,
          p.out, a);
  return cudaGetLastError();
}

template <int STAGE, bool SMEM, typename T, int P>
cudaError_t launch_columns(const Ptrs& p, const StageArgs& a,
                           cudaStream_t s) {
  constexpr int kPatchesPerBlock = kThreads / kSeg;
  const long long patches = static_cast<long long>(a.B) * a.N;
  const long long blocks =
      (patches + kPatchesPerBlock - 1) / kPatchesPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t shm = SMEM ? kPatchesPerBlock * (a.psz + 1) * (a.psz + 1) *
                                sizeof(T)
                          : 0;
  stages_columns<STAGE, SMEM, T, P>
      <<<static_cast<unsigned>(blocks), kThreads, shm, s>>>(
          static_cast<const T*>(p.planes), p.tmpl, p.tdx, p.tdy, p.sx0, p.sy0,
          p.out, a);
  return cudaGetLastError();
}

// One stage or variant on one layout: psz 8 (lanes) and 12 (columns) as
// their own instances, the rest at run time (lanes: K = ceil(psz^2 / 32)).
template <int STAGE, bool SMEM, typename T>
cudaError_t dispatch(int layout, const Ptrs& p, const StageArgs& a,
                     cudaStream_t s) {
  if (layout == kColumns) {
    if (a.psz == 12) return launch_columns<STAGE, SMEM, T, 12>(p, a, s);
    return launch_columns<STAGE, SMEM, T, 0>(p, a, s);
  }
  if (a.psz == 8) return launch_lanes<STAGE, SMEM, T, 2, 8>(p, a, s);
  switch ((a.psz * a.psz + 31) / 32) {
    case 1:
      return launch_lanes<STAGE, SMEM, T, 1, 0>(p, a, s);
    case 2:
      return launch_lanes<STAGE, SMEM, T, 2, 0>(p, a, s);
    case 3:
      return launch_lanes<STAGE, SMEM, T, 3, 0>(p, a, s);
    case 4:
      return launch_lanes<STAGE, SMEM, T, 4, 0>(p, a, s);
    case 5:
      return launch_lanes<STAGE, SMEM, T, 5, 0>(p, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry (bound with ctypes). planes (B, Hp, Wp): float32, or uint16 of
// value * 4^lv for variants 2 and 3 (scale = 4^-lv); tmpl / tdx / tdy
// (B, N, psz^2) float32 (read by stage 2 only); sx0 / sy0 (B, N) int32
// window anchors of trip 0; out (B, N) float32. stage 0 W, 1 A3, 2 A4;
// variant (stage 2 only) 0 none, 1 smem, 2 u16, 3 smem + u16; layout 0
// lanes (K1's), 1 columns (K6's). 1 <= psz <= 12. Returns the launch's
// cudaError_t.
extern "C" int of_gn_stages(const void* planes, const float* tmpl,
                            const float* tdx, const float* tdy,
                            const int* sx0, const int* sy0, float* out,
                            int B, int N, int Hp, int Wp, int psz,
                            int max_iter, float scale, int stage,
                            int variant, int layout, void* stream) {
  const StageArgs a{B, N, Hp, Wp, psz, max_iter, scale};
  const Ptrs p{planes, tmpl, tdx, tdy, sx0, sy0, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (psz < 1 || psz > kRows || stage < 0 || stage > 2 || variant < 0 ||
      variant > 3 || (variant != 0 && stage != kA4) ||
      (layout != kLanes && layout != kColumns))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stage == kW)
    return static_cast<int>(dispatch<kW, false, float>(layout, p, a, s));
  if (stage == kA3)
    return static_cast<int>(dispatch<kA3, false, float>(layout, p, a, s));
  switch (variant) {
    case 0:
      return static_cast<int>(dispatch<kA4, false, float>(layout, p, a, s));
    case 1:
      return static_cast<int>(dispatch<kA4, true, float>(layout, p, a, s));
    case 2:
      return static_cast<int>(
          dispatch<kA4, false, unsigned short>(layout, p, a, s));
    default:
      return static_cast<int>(
          dispatch<kA4, true, unsigned short>(layout, p, a, s));
  }
}
