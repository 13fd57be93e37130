// K8 — the forward-backward merge (`usefbcon`): the complementary grid's
// patches splat their NEGATED displacements bilinearly at their converged
// positions, weighted per footprint pixel by 1 / pweight
// (patchgrid.cpp:278-375).
//
// Replaces: of_dis_tpu/ops/densify.py::aggregate_flow_dense's backward
// merge, which is no Pallas kernel: the JAX package leaves it to XLA as
// soft one-hot contractions. The port's plain twin,
// ops/densify.py::_backward_splat, places each patch with (n, psz, H) and
// (n, psz, W) soft one-hot matrices and contracts them in float64: 1.7
// TFLOP a pair at op-4's level 0 for ~89 M useful multiply-adds, in ~700
// chunks of ~25 launches each.
//
// Bound on an H100: bytes. A merged level reads pweight (psz^2 floats a
// patch, 29.5 MB a pair at op-4's level 0), p and pt once and writes
// (1 + nop) float32 planes; its operations (four taps x (1 + nop)
// multiply-adds a footprint pixel) are ~6 a byte, under the card's ~20.
//
// Semantics (the twin's, term for term): a patch's anchor is
// ceil(pt + 1e-5) and its residual r = pt - floor(pt), in float32;
// footprint pixel (j, i) lies at (anchor_y + lb + j, anchor_x + lb + i),
// lb = floor(-psz / 2), and is valid for 1 <= x < W-1, 1 <= y < H-1;
// its weight w = 1 / pweight (float32) goes to the cells t - 1 (weight
// 1 - r) and t (weight r) of each axis, the value -p. A pixel's sum is
// accumulated in float64 and rounded to float32 once.
//
// Design: a gather, deterministic by construction (no atomics), and a
// pair's result depends on that pair alone.
// - of_fb_splat_keys: each patch's anchor cell, cy * cw + cx, over the
//   cells of every anchor whose footprint can reach a valid pixel
//   (`Cells`); any other patch takes the key cw * ch and is never read.
// - The host sorts each pair's keys (torch.sort, stable): patches in
//   cell order, and in patch order within a cell.
// - of_fb_splat_index: each cell's first sorted position (a lower bound
//   over the sorted keys) and each sorted patch's record: its index,
//   anchor, residuals and negated displacement.
// - of_fb_splat: one thread an output pixel. The anchors that reach pixel
//   (X, Y) are the (psz + 1)^2 cells from (X - lb - psz + 1, Y - lb -
//   psz + 1) to (X - lb + 1, Y - lb + 1); the cells of one anchor row are
//   one contiguous run of sorted positions, so the thread walks psz + 1
//   runs, ~16 patches a pixel at op-4's stride of 3. Per patch it takes
//   the footprint pixels (j, i) that land on (X, Y), j then i ascending
//   (tap b, weight r, before tap a, weight 1 - r), and adds, in float64,
//   t = w * ty * tx (left to right) to the weight and t * -p to each
//   displacement. So every pixel sums its terms in one order, that of
//   (anchor cell row, anchor cell column, patch, j, i), whatever the
//   tiling or the batch: the order the benchmark's reference states
//   (dis_bench/reference/dis_flow_fb.py), term for term.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;                   // output columns a block
constexpr int kTY = kThreads / kTX;       // output rows a block
constexpr int kMaxGridZ = 65535;          // the grid's z: rows a launch

// The anchor cells: anchors ax in [ax0, ax0 + cw), ay in [ay0, ay0 + ch),
// the only ones whose footprint can reach a valid pixel.
struct Cells {
  int ax0, ay0, cw, ch;
};

// The anchor of a float32 position, or false where it lies outside the
// cells (NaN included).
__device__ __forceinline__ bool anchor(float x, int lo, int n, int* a) {
  const float c = ceilf(x + 1e-5f);
  if (!(c >= static_cast<float>(lo) && c < static_cast<float>(lo + n)))
    return false;
  *a = static_cast<int>(c);
  return true;
}

// One key a patch: row r of the keys (direction r / B, pair r % B).
__global__ void __launch_bounds__(kThreads)
    fb_splat_keys_kernel(const float* __restrict__ pt0,
                         const float* __restrict__ pt1,
                         int* __restrict__ keys, int B, int N, Cells g) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int R = (pt1 != nullptr ? 2 : 1) * B;
  if (t >= static_cast<long long>(R) * N) return;
  const int r = static_cast<int>(t / N), n = static_cast<int>(t % N);
  const float* pt = (r < B ? pt0 : pt1) + static_cast<long long>(r % B) * 2 * N;
  int ax, ay;
  const bool in = anchor(__ldg(pt + n), g.ax0, g.cw, &ax) &&
                  anchor(__ldg(pt + N + n), g.ay0, g.ch, &ay);
  keys[t] = in ? (ay - g.ay0) * g.cw + (ax - g.ax0) : g.cw * g.ch;
}

// Thread k of row r: the first sorted position of cell k (k <= cells) and
// the record of sorted position k (k < N).
__global__ void __launch_bounds__(kThreads)
    fb_splat_index_kernel(const int* __restrict__ sorted,
                          const long long* __restrict__ order,
                          const float* __restrict__ pt0,
                          const float* __restrict__ pt1,
                          const float* __restrict__ p0,
                          const float* __restrict__ p1,
                          int* __restrict__ starts, int4* __restrict__ rec_i,
                          float4* __restrict__ rec_f, int B, int N, int nop,
                          Cells g, int per_row) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int R = (pt1 != nullptr ? 2 : 1) * B;
  if (t >= static_cast<long long>(R) * per_row) return;
  const int r = static_cast<int>(t / per_row);
  const int k = static_cast<int>(t % per_row);
  const int cells = g.cw * g.ch;
  const int* keys = sorted + static_cast<long long>(r) * N;
  if (k <= cells) {
    int lo = 0, hi = N;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < k)
        lo = mid + 1;
      else
        hi = mid;
    }
    starts[static_cast<long long>(r) * (cells + 1) + k] = lo;
  }
  if (k < N) {
    const int n = static_cast<int>(__ldg(order + static_cast<long long>(r) * N + k));
    const long long q = static_cast<long long>(r % B);
    const float* pt = (r < B ? pt0 : pt1) + q * 2 * N;
    const float* p = (r < B ? p0 : p1) + q * nop * N;
    const float x = __ldg(pt + n), y = __ldg(pt + N + n);
    int ax = 0, ay = 0;
    anchor(x, g.ax0, g.cw, &ax);
    anchor(y, g.ay0, g.ch, &ay);
    const long long s = static_cast<long long>(r) * N + k;
    rec_i[s] = make_int4(n, ax, ay, 0);
    rec_f[s] = make_float4(x - floorf(x), y - floorf(y), -__ldg(p + n),
                           nop == 2 ? -__ldg(p + N + n) : 0.0f);
  }
}

template <int NOP>
__global__ void __launch_bounds__(kThreads)
    fb_splat_kernel(const float* __restrict__ pw0,
                    const float* __restrict__ pw1,
                    const int* __restrict__ starts,
                    const int4* __restrict__ rec_i,
                    const float4* __restrict__ rec_f, float* __restrict__ out,
                    int B, int N, int psz, int H, int W, Cells g, int r0) {
  const int r = r0 + static_cast<int>(blockIdx.z);
  const int X = static_cast<int>(blockIdx.x) * kTX + threadIdx.x % kTX;
  const int Y = static_cast<int>(blockIdx.y) * kTY + threadIdx.x / kTX;
  if (X >= W || Y >= H) return;
  const int lb = -((psz + 1) / 2);
  // tap a: the footprint row (column) at Y + 1 (X + 1), weight 1 - r;
  // tap b: the one at Y (X), weight r; each valid inside the border
  const bool ya = Y + 1 < H - 1, yb = Y >= 1 && Y < H - 1;
  const bool xa = X + 1 < W - 1, xb = X >= 1 && X < W - 1;
  double acc[1 + NOP];
#pragma unroll
  for (int f = 0; f <= NOP; ++f) acc[f] = 0.0;
  const int ax_lo = max(X - lb - psz + 1, g.ax0);
  const int ax_hi = min(X - lb + 1, g.ax0 + g.cw - 1);
  if ((ya || yb) && (xa || xb) && ax_lo <= ax_hi) {
    const int ay_lo = max(Y - lb - psz + 1, g.ay0);
    const int ay_hi = min(Y - lb + 1, g.ay0 + g.ch - 1);
    const long long q = static_cast<long long>(r % B);
    const float* pw = (r < B ? pw0 : pw1) + q * psz * psz * N;
    const int* st = starts + static_cast<long long>(r) * (g.cw * g.ch + 1);
    const int4* ri = rec_i + static_cast<long long>(r) * N;
    const float4* rf = rec_f + static_cast<long long>(r) * N;
    const long long col = N, row = static_cast<long long>(psz) * N;
    for (int ay = ay_lo; ay <= ay_hi; ++ay) {
      const int cell0 = (ay - g.ay0) * g.cw - g.ax0;
      const int s1 = __ldg(st + cell0 + ax_hi + 1);
      const int ja = Y + 1 - ay - lb;     // in [0, psz]
      const bool va = ya && ja < psz, vb = yb && ja >= 1;
      for (int s = __ldg(st + cell0 + ax_lo); s < s1; ++s) {
        const int4 id = __ldg(ri + s);
        const float4 v = __ldg(rf + s);
        const int ia = X + 1 - id.y - lb;   // in [0, psz]
        const bool ca = xa && ia < psz, cb = xb && ia >= 1;
        const float* pn = pw + id.x;
        const float tys[2] = {v.y, 1.0f - v.y}, txs[2] = {v.x, 1.0f - v.x};
        const double neg[2] = {static_cast<double>(v.z),
                               static_cast<double>(v.w)};
        // rows ja - 1 (tap b) then ja (tap a); in each, columns ia - 1
        // (tap b) then ia (tap a)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a == 0 ? !vb : !va) continue;
          const float* pr = pn + (ja - 1 + a) * row;
          const double ty = static_cast<double>(tys[a]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (c == 0 ? !cb : !ca) continue;
            const float w = 1.0f / __ldg(pr + (ia - 1 + c) * col);
            const double t = static_cast<double>(w) * ty *
                             static_cast<double>(txs[c]);
            acc[0] = acc[0] + t;
#pragma unroll
            for (int f = 0; f < NOP; ++f) acc[1 + f] = acc[1 + f] + t * neg[f];
          }
        }
      }
    }
  }
  const long long plane = static_cast<long long>(H) * W;
  float* o = out + static_cast<long long>(r) * (1 + NOP) * plane +
             static_cast<long long>(Y) * W + X;
#pragma unroll
  for (int f = 0; f <= NOP; ++f) o[f * plane] = static_cast<float>(acc[f]);
}

unsigned blocks(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int NOP>
cudaError_t splat(const float* pw0, const float* pw1, const int* starts,
                  const int4* rec_i, const float4* rec_f, float* out, int R,
                  int B, int N, int psz, int H, int W, Cells g,
                  cudaStream_t s) {
  for (int r0 = 0; r0 < R; r0 += kMaxGridZ) {
    const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY,
                    std::min(R - r0, kMaxGridZ));
    fb_splat_kernel<NOP><<<grid, kThreads, 0, s>>>(
        pw0, pw1, starts, rec_i, rec_f, out, B, N, psz, H, W, g, r0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// C entries (bound with ctypes). A row r of 2B (pt1 given: both
// directions) or B rows is direction r / B, pair r % B. pt (B, 2, N)
// positions, p (B, nop, N) displacements, pweight (B, psz, psz, N), each
// of the direction's complementary grid; the cells (ax0, ay0, cw, ch) of
// the anchors that can reach a valid pixel (cw, ch > 0). Each returns its
// launch's cudaError_t.

// keys (R, N) int32: each patch's anchor cell, or cw * ch.
extern "C" int of_fb_splat_keys(const float* pt0, const float* pt1,
                                int* keys, int B, int N, int ax0, int ay0,
                                int cw, int ch, void* stream) {
  const int R = (pt1 != nullptr ? 2 : 1) * B;
  if (R == 0 || N == 0) return 0;
  fb_splat_keys_kernel<<<blocks(static_cast<long long>(R) * N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pt0, pt1, keys, B, N, Cells{ax0, ay0, cw, ch});
  return static_cast<int>(cudaGetLastError());
}

// sorted (R, N) int32 keys in order, order (R, N) int64 their patches ->
// starts (R, cw * ch + 1) int32 (each cell's first sorted position),
// rec_i (R, N) int4 (patch, anchor x, anchor y, 0) and rec_f (R, N)
// float4 (rx, ry, -p0, -p1 or 0) of each sorted position.
extern "C" int of_fb_splat_index(const int* sorted, const long long* order,
                                 const float* pt0, const float* pt1,
                                 const float* p0, const float* p1,
                                 int* starts, void* rec_i, void* rec_f,
                                 int B, int N, int nop, int ax0, int ay0,
                                 int cw, int ch, void* stream) {
  const int R = (pt1 != nullptr ? 2 : 1) * B;
  const int per_row = std::max(N, cw * ch + 1);
  if (R == 0) return 0;
  fb_splat_index_kernel<<<blocks(static_cast<long long>(R) * per_row),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted, order, pt0, pt1, p0, p1, starts, static_cast<int4*>(rec_i),
      static_cast<float4*>(rec_f), B, N, nop, Cells{ax0, ay0, cw, ch},
      per_row);
  return static_cast<int>(cudaGetLastError());
}

// out (R, 1 + nop, H, W) float32: per pixel the weight and the weighted
// negated displacements, every pixel written.
extern "C" int of_fb_splat(const float* pw0, const float* pw1,
                           const int* starts, const void* rec_i,
                           const void* rec_f, float* out, int B, int N,
                           int nop, int psz, int H, int W, int ax0, int ay0,
                           int cw, int ch, void* stream) {
  const int R = (pw1 != nullptr ? 2 : 1) * B;
  if (R == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cells g{ax0, ay0, cw, ch};
  const int4* ri = static_cast<const int4*>(rec_i);
  const float4* rf = static_cast<const float4*>(rec_f);
  if (nop == 1)
    return static_cast<int>(
        splat<1>(pw0, pw1, starts, ri, rf, out, R, B, N, psz, H, W, g, s));
  if (nop == 2)
    return static_cast<int>(
        splat<2>(pw0, pw1, starts, ri, rf, out, R, B, N, psz, H, W, g, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
