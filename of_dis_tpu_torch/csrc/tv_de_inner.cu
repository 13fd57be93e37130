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
// Bound on an H100: per pair the loop reads 2 + 8 C (H, W) float fields
// and writes one, ~100-200 flops per pixel and inner iteration; at DIS
// level sizes both bounds are microseconds. What bounds it is the chain of
// dependent passes: each inner iteration is 1 + 2 n_solver passes over
// the pair, each needing its neighbours' results of the pass before, so
// each behind a barrier, and each pass's few instructions a pixel run on
// few warps. The TPU kernel keeps whole pairs in VMEM.
//
// Design: one launch a level, on one of two routes that the caller picks
// from the level's shape and batch (kernels/tv_de_inner.py: route, from
// the crossovers measured on the H100):
// - the cluster route: a pair is split into K bands of rows, one block a
//   band, the K blocks one thread-block cluster (K = 1 .. 16; above 8 a
//   non-portable size). A block keeps its band's six fields (du, wh, wv,
//   om11 = omega / (a11 + wsum), b1 and the diffusivity sm; 24 bytes a
//   pixel) in dynamic shared memory, so no pass touches device memory for
//   them; halo rows come from the neighbouring blocks' shared memory
//   through the cluster (map_shared_rank): the passes read du, sm and wv
//   one row away, so every band is at least two rows high, and rows whose
//   neighbours lie in the band read the block's own shared memory
//   directly. cluster.sync() separates the passes (__syncthreads() at
//   K = 1). A cluster barrier costs ~1 us, so small pairs keep K = 1 and
//   larger ones split only into bands of ~2,048 pixels, as many as fill
//   the card;
// - the cooperative route, for pairs no 16-block cluster holds (op-4's
//   1024x448 level 0, 11 MB of fields a pair): K2's design, the fields in a
//   global scratch (6, B, H, W) field by field over all pairs, every pass
//   grid-striding over the B*H*W pixels, a grid barrier between passes;
//   flat indices 64-bit where an array needs it (kWide).
// Each inner iteration is two passes and the SOR colours: the TV
// diffusivity of (uu, 0) at every pixel (uu = clamp(wx + du) recomputed,
// never stored; wx itself in the first iteration, which also clears du),
// then the edge weights from the diffusivities of the pixel and its four
// neighbours, the data term, the sub-laplacian and om11, with the first
// SOR colour of the first sweep in the same pass. Each SOR colour
// updates only its own pixels; the last colour of the last iteration
// writes the output uu = clamp(wx + du) of both colours. The per-pixel
// arithmetic is the twin's (ops/tv.py::_de_inner_loop, --fmad=false), so
// both routes equal it bit for bit. The in-place red-black sweep is
// race-free: every 4-neighbour of a red pixel is black. Colour = (y + x +
// row_parity) % 2. The sign clamp acts on uu only and passes NaN on as the
// twin's clamp does; du stays unclamped. A launch the device refuses (a
// cluster that cannot be resident, a cooperative grid) returns its error;
// there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kDataNorm = 0.010000000000000002f;   // 0.1^2
constexpr float kEps = 1e-6f;                         // 0.001^2
constexpr int kFields = 6;          // du, wh, wv, om11, b1, sm
constexpr int kClusterThreads = 1024;
constexpr int kCoopThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;    // a block's dynamic shared memory, H100
enum Field { kDu = 0, kWh = 1, kWv = 2, kOm11 = 3, kB1 = 4, kSm = 5 };

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
__device__ __forceinline__ void data_de(const float* __restrict__ I, int HW,
                                        int i, float m, float u,
                                        const DEArgs& a, float& A11,
                                        float& B1) {
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

// The disparity clamped to the camera's sign; NaN passes, as in the twin.
__device__ __forceinline__ float clamp_sign(float s, int camlr) {
  return camlr == 0 ? (s > 0.0f ? 0.0f : s) : (s < 0.0f ? 0.0f : s);
}

// TV diffusivity from the four uu values around a point (compute_smoothness,
// opticalflow_aux.c:138-187; vv = 0 adds nothing).
__device__ __forceinline__ float diffusivity(float l, float r, float u,
                                             float d, const DEArgs& a) {
  const float ux = 0.5f * (r - l);
  const float uy = 0.5f * (d - u);
  return a.quarter_alpha / sqrtf(kEps + ux * ux + uy * uy);
}

// Field accessors: row(f, y) is row y of field f (x = 0 first). Own: a
// block's band of rows [r0, ...) in its own shared memory, fields `stride`
// floats apart. Band: the same, and the rows above r0 in the previous
// block's shared memory, those from r1 on in the next block's (the same
// layout in every block of the cluster). Global: the cooperative route's
// scratch (6, B, H, W), `base` the pair's first pixel.
struct Own {
  float* own;
  int r0, W, stride;
  __device__ __forceinline__ float* row(int f, int y) const {
    return own + f * stride + (y - r0) * W;
  }
};

struct Band {
  float* own;
  float* up;
  float* down;
  int r0, r1, up0, down0, W, stride;
  __device__ __forceinline__ float* row(int f, int y) const {
    float* r = y < r0 ? up + (y - up0) * W
                      : (y >= r1 ? down + (y - down0) * W
                                 : own + (y - r0) * W);
    return r + f * stride;
  }
};

template <typename Index>
struct Global {
  float* S;
  Index total, base;
  int W;
  __device__ __forceinline__ float* row(int f, int y) const {
    return S + f * total + base + static_cast<Index>(y) * W;
  }
};

// The first pass of an inner iteration at pixel (y, x) of a pair: the TV
// diffusivity of (uu, 0), uu recomputed from wx and du (wx itself in the
// first iteration, which also clears du).
template <typename F>
__device__ __forceinline__ void diffusivity_pass(const F& f,
                                                 const float* __restrict__ wx,
                                                 int y, int x, bool first,
                                                 const DEArgs& a) {
  const int H = a.H, W = a.W;
  auto U = [&](int yy, int xx) -> float {
    const float w = wx[yy * W + xx];
    return first ? w : clamp_sign(w + f.row(kDu, yy)[xx], a.camlr);
  };
  const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
  const int yu = max(y - 1, 0), yd = min(y + 1, H - 1);
  f.row(kSm, y)[x] = diffusivity(U(y, xl), U(y, xr), U(yu, x), U(yd, x), a);
  if (first) f.row(kDu, y)[x] = 0.0f;
}

// The second pass at pixel (y, x): the edge weights from the diffusivity
// of the pixel and its four neighbours, the data term, the sub-laplacian
// and om11 = omega / (a11 + wsum); with `sor0`, a pixel of colour 0 also
// takes the first SOR colour of the first sweep. Its neighbours are of
// colour 1, which this pass does not update, and the weights it needs of
// them (wv of the pixel above, wh of the one to the left) are wvu and whl,
// the same sums those pixels store, so it needs no pass of its own.
template <int C, typename F>
__device__ __forceinline__ void merged_pass(const F& f,
                                            const float* __restrict__ wx,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ I,
                                            int y, int x, bool sor0,
                                            const DEArgs& a) {
  const int H = a.H, W = a.W, HW = H * W;
  const int p = y * W + x;
  const float* sm = f.row(kSm, y);
  const float sc = sm[x];
  const float wh = x < W - 1 ? sc + sm[x + 1] : 0.0f;
  const float wv = y < H - 1 ? sc + f.row(kSm, y + 1)[x] : 0.0f;
  const float whl = x > 0 ? sm[x - 1] + sc : 0.0f;
  const float wvu = y > 0 ? f.row(kSm, y - 1)[x] + sc : 0.0f;
  float* du = f.row(kDu, y);
  const float u = du[x];
  float A11, B1;
  data_de<C>(I, HW, p, mask[p], u, a, A11, B1);
  // b1 += div(w grad(wx)) (sub_laplacian, opticalflow_aux.c:194-223)
  const float w0 = wx[p];
  const float fr = x < W - 1 ? wx[p + 1] : 0.0f;
  const float fd = y < H - 1 ? wx[p + W] : 0.0f;
  const float th = wh * (fr - w0);
  const float thl = x > 0 ? whl * (w0 - wx[p - 1]) : 0.0f;
  const float tv = wv * (fd - w0);
  const float tvu = y > 0 ? wvu * (w0 - wx[p - W]) : 0.0f;
  float r = B1;
  r = r + th - thl;
  r = r + tv - tvu;
  const float wsum = wvu + whl + wv + wh;
  const float om11 = a.omega / (A11 + wsum);
  f.row(kWh, y)[x] = wh;
  f.row(kWv, y)[x] = wv;
  f.row(kOm11, y)[x] = om11;
  f.row(kB1, y)[x] = r;
  if (sor0 && ((y + x + a.row_parity) & 1) == 0) {
    const float duu = y > 0 ? f.row(kDu, y - 1)[x] : 0.0f;
    const float dul = x > 0 ? du[x - 1] : 0.0f;
    const float dud = y < H - 1 ? f.row(kDu, y + 1)[x] : 0.0f;
    const float dur = x < W - 1 ? du[x + 1] : 0.0f;
    const float b1n = r + (wvu * duu + whl * dul + wv * dud + wh * dur);
    du[x] = a.one_minus_omega * u + om11 * b1n;
  }
}

// One red-black SOR update of du at (y, x) (sor_de_rb; solver.c:439-471);
// returns the new du.
template <typename F>
__device__ __forceinline__ float sor_pixel(const F& f, int y, int x,
                                           const DEArgs& a) {
  float* du = f.row(kDu, y);
  const float* wv = f.row(kWv, y);
  const float* wh = f.row(kWh, y);
  const float upw = y > 0 ? f.row(kWv, y - 1)[x] : 0.0f;
  const float lfw = x > 0 ? wh[x - 1] : 0.0f;
  const float duu = y > 0 ? f.row(kDu, y - 1)[x] : 0.0f;
  const float dul = x > 0 ? du[x - 1] : 0.0f;
  const float dud = y < a.H - 1 ? f.row(kDu, y + 1)[x] : 0.0f;
  const float dur = x < a.W - 1 ? du[x + 1] : 0.0f;
  const float b1n = f.row(kB1, y)[x] +
                    (upw * duu + lfw * dul + wv[x] * dud + wh[x] * dur);
  const float d = a.one_minus_omega * du[x] + f.row(kOm11, y)[x] * b1n;
  du[x] = d;
  return d;
}

// The whole loop over one route's pixels. each(fn) calls fn(pair, y, x) for
// every pixel the thread owns, each_colour(c, fn) for those of colour c;
// sync() is the route's barrier. px gives the per-pixel steps of a pair:
// px.diffusivity(b, y, x, first), px.merged(b, y, x, sor0), px.sor(b, y, x)
// (the new du) and px.du(b, y, x).
template <typename Each, typename EachColour, typename Sync, typename Pixels,
          typename Pair>
__device__ __forceinline__ void run_loop(const Each& each,
                                         const EachColour& each_colour,
                                         const Sync& sync, const Pixels& px,
                                         const Pair& pair, float* uu,
                                         const DEArgs& a) {
  if (a.n_inner == 0) {
    each([&](long long b, int y, int x) {
      pair.uu(uu, b)[y * a.W + x] = pair.wx(b)[y * a.W + x];
    });
    return;
  }
  for (int inner = 0; inner < a.n_inner; ++inner) {
    const bool first = inner == 0;
    const bool last_inner = inner == a.n_inner - 1;
    each([&](long long b, int y, int x) { px.diffusivity(b, y, x, first); });
    sync();
    // with the first SOR colour of the first sweep
    each([&](long long b, int y, int x) {
      px.merged(b, y, x, a.n_solver > 0);
    });
    sync();
    for (int it = 0; it < a.n_solver; ++it) {
      for (int colour = it == 0 ? 1 : 0; colour < 2; ++colour) {
        const bool out = last_inner && it == a.n_solver - 1 && colour == 1;
        if (out) {
          // the last colour, and uu = clamp(wx + du) of both colours
          each([&](long long b, int y, int x) {
            const int p = y * a.W + x;
            const float d = ((y + x + a.row_parity) & 1) == colour
                                ? px.sor(b, y, x)
                                : px.du(b, y, x);
            pair.uu(uu, b)[p] = clamp_sign(pair.wx(b)[p] + d, a.camlr);
          });
        } else {
          each_colour(colour,
                      [&](long long b, int y, int x) { px.sor(b, y, x); });
          sync();
        }
      }
    }
  }
  if (a.n_solver == 0) {
    // du stays 0: uu = clamp(wx) (own pixels; sync() above published du)
    each([&](long long b, int y, int x) {
      const int p = y * a.W + x;
      pair.uu(uu, b)[p] = clamp_sign(pair.wx(b)[p] + px.du(b, y, x),
                                     a.camlr);
    });
  }
}

// Per-pair input pointers, 64-bit offsets.
template <int C>
struct Pair {
  const float* wx_all;
  const float* mask_all;
  const float* deriv_all;
  long long HW;
  __device__ __forceinline__ const float* wx(long long b) const {
    return wx_all + b * HW;
  }
  __device__ __forceinline__ const float* mask(long long b) const {
    return mask_all + b * HW;
  }
  __device__ __forceinline__ const float* deriv(long long b) const {
    return deriv_all + b * 8 * C * HW;
  }
  __device__ __forceinline__ float* uu(float* uu_all, long long b) const {
    return uu_all + b * HW;
  }
};

// The per-pixel steps of the cluster route: rows whose neighbours lie in
// the block's band (`in`) read its own shared memory directly, the band's
// edge rows go through the cluster.
template <int C, typename Inside>
struct ClusterPixels {
  Own own;
  Band band;
  Pair<C> pair;
  DEArgs a;
  Inside in;
  __device__ __forceinline__ void diffusivity(long long b, int y, int x,
                                              bool first) const {
    if (in(y, 1)) {
      diffusivity_pass(own, pair.wx(b), y, x, first, a);
    } else {
      diffusivity_pass(band, pair.wx(b), y, x, first, a);
    }
  }
  __device__ __forceinline__ void merged(long long b, int y, int x,
                                         bool sor0) const {
    if (in(y, 1)) {
      merged_pass<C>(own, pair.wx(b), pair.mask(b), pair.deriv(b), y, x,
                     sor0, a);
    } else {
      merged_pass<C>(band, pair.wx(b), pair.mask(b), pair.deriv(b), y, x,
                     sor0, a);
    }
  }
  __device__ __forceinline__ float sor(long long, int y, int x) const {
    return in(y, 1) ? sor_pixel(own, y, x, a) : sor_pixel(band, y, x, a);
  }
  __device__ __forceinline__ float du(long long, int y, int x) const {
    return own.row(kDu, y)[x];
  }
};

// The per-pixel steps of the cooperative route, on the global scratch.
template <int C, typename Index>
struct CoopPixels {
  float* S;
  Index total, HW;
  Pair<C> pair;
  DEArgs a;
  __device__ __forceinline__ Global<Index> at(long long b) const {
    return Global<Index>{S, total, static_cast<Index>(b) * HW, a.W};
  }
  __device__ __forceinline__ void diffusivity(long long b, int y, int x,
                                              bool first) const {
    diffusivity_pass(at(b), pair.wx(b), y, x, first, a);
  }
  __device__ __forceinline__ void merged(long long b, int y, int x,
                                         bool sor0) const {
    merged_pass<C>(at(b), pair.wx(b), pair.mask(b), pair.deriv(b), y, x,
                   sor0, a);
  }
  __device__ __forceinline__ float sor(long long b, int y, int x) const {
    return sor_pixel(at(b), y, x, a);
  }
  __device__ __forceinline__ float du(long long b, int y, int x) const {
    return at(b).row(kDu, y)[x];
  }
};

// Calls fn(y, x) for the pixels first, first + step, ... of `rows` rows of
// `cols` pixels from row r0, with x = 2 k + shift(y) where `twice` (the
// pixels of one colour, cols = ceil(W / 2)), else x = k; one division at
// the start, none a pixel.
template <typename Fn, typename Shift>
__device__ __forceinline__ void strided_rows(int first, int step, int r0,
                                             int rows, int cols, bool twice,
                                             const Shift& shift,
                                             const Fn& fn) {
  const int sy = step / cols, sx = step - sy * cols;
  int y = first / cols, k = first - y * cols;
  while (y < rows) {
    const int x = twice ? 2 * k + shift(r0 + y) : k;
    fn(r0 + y, x);
    k += sx;
    y += sy;
    if (k >= cols) {
      k -= cols;
      ++y;
    }
  }
}

// Cluster route: grid (K B), clusters of (K, 1, 1); block `rank` of pair
// blockIdx.x / K owns rows [rank H / K, (rank + 1) H / K). `rows_max` rows
// of each field in shared memory.
template <int C>
__global__ void __launch_bounds__(kClusterThreads, 1)
    tv_de_cluster(const float* __restrict__ wx, const float* __restrict__ mask,
                  const float* __restrict__ deriv, float* uu, int rows_max,
                  DEArgs a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = a.H, W = a.W;
  const int r0 = rank * H / K, r1 = (rank + 1) * H / K;
  const Own own{smem, r0, W, rows_max * W};
  Band band{smem, smem, smem, r0, r1, 0, r1, W, rows_max * W};
  if (K > 1) {
    if (rank > 0) {
      band.up = cluster.map_shared_rank(smem, rank - 1);
      band.up0 = (rank - 1) * H / K;
    }
    if (rank < K - 1) band.down = cluster.map_shared_rank(smem, rank + 1);
    cluster.sync();   // every block of the cluster runs before any reads
  }
  const long long b = blockIdx.x / K;
  const Pair<C> pair{wx, mask, deriv, static_cast<long long>(H) * W};
  const int tid = threadIdx.x, step = blockDim.x;
  // whether row y's neighbours `margin` rows away lie in the block's band
  auto inside = [&](int y, int margin) {
    return K == 1 || (y >= r0 + margin && y < r1 - margin);
  };
  auto each = [&](auto fn) {
    strided_rows(tid, step, r0, r1 - r0, W, false, [](int) { return 0; },
                 [&](int y, int x) { fn(b, y, x); });
  };
  auto each_colour = [&](int colour, auto fn) {
    strided_rows(tid, step, r0, r1 - r0, (W + 1) / 2, true,
                 [&](int y) { return (y + a.row_parity + colour) & 1; },
                 [&](int y, int x) {
                   if (x < W) fn(b, y, x);
                 });
  };
  auto sync = [&]() {
    if (K > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  const ClusterPixels<C, decltype(inside)> px{own, band, pair, a, inside};
  run_loop(each, each_colour, sync, px, pair, uu, a);
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster.sync();
}

// Cooperative route: the grid strides over all pixels of all pairs.
template <int C, bool kWide>
__global__ void __launch_bounds__(kCoopThreads)
    tv_de_coop(const float* __restrict__ wx, const float* __restrict__ mask,
               const float* __restrict__ deriv, float* uu, float* scratch,
               int B, DEArgs a) {
  using Index = typename std::conditional<kWide, long long, int>::type;
  const int W = a.W;
  const Index HW = static_cast<Index>(a.H) * W;
  const Index total = static_cast<Index>(B) * HW;
  const Index first = static_cast<Index>(blockIdx.x) * kCoopThreads +
                      threadIdx.x;
  const Index stride = static_cast<Index>(gridDim.x) * kCoopThreads;
  const int half = (W + 1) / 2;
  const Index halves = static_cast<Index>(B) * a.H * half;
  const Pair<C> pair{wx, mask, deriv, static_cast<long long>(HW)};
  auto each = [&](auto fn) {
    for (Index i = first; i < total; i += stride) {
      const Index b = i / HW;
      const int p = static_cast<int>(i - b * HW);
      const int y = p / W;
      fn(static_cast<long long>(b), y, p - y * W);
    }
  };
  auto each_colour = [&](int colour, auto fn) {
    for (Index i = first; i < halves; i += stride) {
      const Index row = i / half;             // b * H + y
      const int k = static_cast<int>(i - row * half);
      const Index b = row / a.H;
      const int y = static_cast<int>(row - b * a.H);
      const int x = 2 * k + ((y + a.row_parity + colour) & 1);
      if (x < W) fn(static_cast<long long>(b), y, x);
    }
  };
  auto sync = []() { cg::this_grid().sync(); };
  const CoopPixels<C, Index> px{scratch, total, HW, pair, a};
  run_loop(each, each_colour, sync, px, pair, uu, a);
}

int device_index() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// The cluster kernel's attributes, set once per device and instance: the
// largest dynamic shared memory and cluster sizes above 8.
template <int C>
cudaError_t prepare_cluster(int dev) {
  static bool done[kMaxDevices] = {};
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  auto kernel = tv_de_cluster<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <int C>
cudaLaunchConfig_t cluster_config(int B, int K, int H, int W,
                                  cudaLaunchAttribute* attr, cudaStream_t s,
                                  int* rows_max) {
  *rows_max = (H + K - 1) / K;
  const int pixels = *rows_max * W;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(K) * static_cast<unsigned>(B));
  cfg.blockDim =
      dim3(static_cast<unsigned>(std::min(kClusterThreads,
                                          (pixels + 31) / 32 * 32)));
  cfg.dynamicSmemBytes = static_cast<size_t>(kFields) * 4 * pixels;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(K);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of K blocks that the device holds at once for a level of H x W
// (cudaOccupancyMaxActiveClusters); 0 where none can be resident.
template <int C>
cudaError_t max_clusters(int K, int H, int W, int* count) {
  *count = 0;
  cudaError_t e = prepare_cluster<C>(device_index());
  if (e != cudaSuccess) return e;
  int rows_max = 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<C>(1, K, H, W, attr, 0, &rows_max);
  if (cfg.dynamicSmemBytes > static_cast<size_t>(kMaxSmem)) return cudaSuccess;
  e = cudaOccupancyMaxActiveClusters(count, tv_de_cluster<C>, &cfg);
  if (e != cudaSuccess) *count = 0;
  return e;
}

template <int C>
cudaError_t launch_cluster(const float* wx, const float* mask,
                           const float* deriv, float* uu, int B, int K,
                           const DEArgs& a, cudaStream_t s) {
  if (K < 1 || K > 16 || (K > 1 && a.H < 2 * K))
    return cudaErrorInvalidValue;
  // whether a cluster of K can be resident, read once per device, K and
  // band size (a launch that could never run is refused here)
  struct Seen { int dev, K, H, W, ok; };
  static Seen seen[64] = {};
  static int n_seen = 0;
  const int dev = device_index();
  int ok = -1;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].K == K && seen[i].H == a.H &&
        seen[i].W == a.W)
      ok = seen[i].ok;
  if (ok < 0) {
    int count = 0;
    cudaError_t e = max_clusters<C>(K, a.H, a.W, &count);
    if (e != cudaSuccess) return e;
    ok = count > 0;
    if (n_seen < 64) seen[n_seen++] = Seen{dev, K, a.H, a.W, ok};
  }
  if (!ok) return cudaErrorLaunchOutOfResources;
  int rows_max = 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<C>(B, K, a.H, a.W, attr, s,
                                             &rows_max);
  cudaError_t e = cudaLaunchKernelEx(&cfg, tv_de_cluster<C>, wx, mask, deriv,
                                     uu, rows_max, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C, bool kWide>
cudaError_t launch_coop(const float* wx, const float* mask,
                        const float* deriv, float* uu, float* scratch, int B,
                        const DEArgs& a, cudaStream_t s) {
  auto kernel = tv_de_coop<C, kWide>;
  // blocks the device holds at once, read once per device
  static int resident[kMaxDevices] = {};
  const int dev = device_index();
  int blocks = dev >= 0 && dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kCoopThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    blocks = per_sm * sms;
    if (dev >= 0 && dev < kMaxDevices) resident[dev] = blocks;
  }
  const long long total = static_cast<long long>(B) * a.H * a.W;
  const long long need = (total + kCoopThreads - 1) / kCoopThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>(std::min<long long>(blocks, need)));
  cfg.blockDim = dim3(kCoopThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, wx, mask, deriv, uu,
                                     scratch, B, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* wx, const float* mask, const float* deriv,
                     float* uu, float* scratch, int B, int K,
                     const DEArgs& a, cudaStream_t s) {
  if (K > 0) {
    cudaError_t e = prepare_cluster<C>(device_index());
    if (e != cudaSuccess) return e;
    return launch_cluster<C>(wx, mask, deriv, uu, B, K, a, s);
  }
  // the largest flat index, of the scratch (6 fields) or the derivatives
  // (8 C), must fit 31 bits
  if (8LL * C * B * a.H * a.W < (1LL << 31))
    return launch_coop<C, false>(wx, mask, deriv, uu, scratch, B, a, s);
  return launch_coop<C, true>(wx, mask, deriv, uu, scratch, B, a, s);
}

}  // namespace

// C entry (bound with ctypes). wx, mask (B,H,W); deriv (B,8,C,H,W), C = 1
// or 3; output uu (B,H,W); K 1..16 takes the cluster route with clusters
// of K blocks (scratch unused), K = 0 the cooperative route with scratch
// (6,B,H,W); camlr 0 clamps uu <= 0, 1 clamps uu >= 0. Returns the
// launch's cudaError_t.
extern "C" int of_tv_de_inner(const float* wx, const float* mask,
                              const float* deriv, float* uu, float* scratch,
                              int B, int C, int H, int W, int n_inner,
                              int n_solver, int row_parity, int use_color,
                              int camlr, float quarter_alpha, float hd3,
                              float hg3, float omega, float one_minus_omega,
                              int K, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  DEArgs a{H,   W,   n_inner, n_solver, row_parity, use_color, camlr,
           quarter_alpha, hd3, hg3, omega, one_minus_omega};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return static_cast<int>(
        dispatch<1>(wx, mask, deriv, uu, scratch, B, K, a, s));
  if (C == 3)
    return static_cast<int>(
        dispatch<3>(wx, mask, deriv, uu, scratch, B, K, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of K blocks (K 1..16) of the C-channel instance that the
// current device holds at once for an H x W level
// (cudaOccupancyMaxActiveClusters); 0 where none can be resident, minus the
// cudaError_t where the query fails.
extern "C" int of_tv_de_max_clusters(int C, int K, int H, int W) {
  int count = 0;
  cudaError_t e = C == 1 ? max_clusters<1>(K, H, W, &count)
                         : (C == 3 ? max_clusters<3>(K, H, W, &count)
                                   : cudaErrorInvalidValue);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}
