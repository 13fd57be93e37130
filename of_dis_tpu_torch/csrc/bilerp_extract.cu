// K7 — bilinear patch extraction at float positions: every patch of a level
// read out of the target planes as a (B, D, N) array, D = psz^2 C in
// (row j, column i, channel c) order, for the unfused Gauss-Newton route
// (patch_solver.gn_unfused), whose loop runs in PyTorch and calls this
// kernel once at the start and once per trip.
//
// Replaces: of_dis_tpu/ops/patch_solver.py::_bilerp_select_pallas (the TPU
// kernel that selects each patch's rows and applies the y- and x-lerp after
// the column one-hot matrix product of extract_bilinear_mxu_batched; on a
// GPU the column select is an index, so this kernel computes the whole of
// extract_bilinear_mxu_batched: getPatchStaticBil, patch.cpp:346-413).
//
// Bound on an H100: bytes — the (B, D, N) output written once is psz^2 /
// steps^2 times the planes it is read from (16 times at patch size 16,
// overlap 0.75); nine float operations per element.
//
// What held the first design (one thread per output element, grid (N/128,
// psz^2, B)) was the traffic from L2: each warp instruction gathered the
// four taps of 32 patches ~4 px apart (~20 cache lines for 128 bytes
// stored), every patch's position was read again for each of its psz^2
// pixels, and the blocks swept the whole level plane once per patch pixel;
// the batch sat on the grid's z axis, which holds at most 65,535 pairs.
//
// Design: a block takes a run of kPatches = 32 consecutive patches of one
// pair, one channel and one band of window rows, on a 1-D grid indexed in
// 64 bits (any batch). The block's first warp reads the 32 positions once
// and keeps each patch's anchor and residuals in shared memory. Then, for
// each tile of the band (the whole band, unless a window row is longer
// than half the room: then bands of columns too):
//   phase 1, the block stages the tile of all 32 windows: consecutive
//     threads on consecutive columns of a window row, so each row is one
//     coalesced run, kLoads loads in flight a thread, the element's (patch,
//     row, column) carried from one load to the next without a division;
//     indices outside the planes clamp, as the twin's;
//   phase 2, lane = patch: the warps share the tile's output rows (split
//     into runs of columns where the tile has fewer rows than warps), each
//     y-lerping window rows j and j + 1 column by column and x-lerping
//     neighbours, and store out[b, (j psz + i) C + c, n0 + lane]: one
//     128-byte store per warp and output element. A window's stride in
//     shared memory is odd, so the 32 lanes' reads fall in 32 banks.
// A band is the whole (psz+1)^2 window where 32 of them fit the block's
// shared memory (37 KB at patch size 16) and the grid has kTargetBlocks
// blocks without bands; else it is cut into bands of fewer rows (two at
// least), which read their last window row twice: the coarse levels of a
// small batch (tens of blocks with whole windows) fill the card this way.
// On an NVIDIA H100 at 700 W, path H's 68 calls (batch 4, patch size 16)
// took 0.85 ms against 2.38 for the first design (PERF.md; whole windows
// only, bands of one row or four, 16 loads in flight, 256 threads, and a
// thread walking its column down the rows all measured slower).
// Anchor ceil(pt + 1e-5) and residual against floor(pt), both float32;
// y-lerp then x-lerp, the formulas of the plain twin
// (patch_solver.extract_bilinear) term by term (built with --fmad=false):
// equal to it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kPatches = 32;   // patches a block: one per lane
constexpr int kLoads = 8;      // loads in flight a thread in phase 1
// blocks the grid should have before a band is cut (eight on each of an
// H100's 132 SMs)
constexpr long long kTargetBlocks = 1024;
// shared floats a window tile may take: 32 tiles and the block's positions
// (4 x 32 words) in 48 KB, the shared memory a block gets without opting in
constexpr int kTileFloats = (48 * 1024 / 4 - 4 * kPatches) / kPatches;

__global__ void __launch_bounds__(kThreads)
    bilerp_extract_kernel(const float* __restrict__ im,
                          const float* __restrict__ pts,
                          float* __restrict__ out, int C, int Hp, int Wp,
                          int N, int psz, int pad, int band_rows,
                          int band_cols, int stride, long long runs,
                          int bands) {
  extern __shared__ float win[];  // kPatches window tiles, `stride` apart
  __shared__ int s_sx[kPatches], s_sy[kPatches];
  __shared__ float s_rx[kPatches], s_ry[kPatches];
  // block -> (pair b, run of patches, channel c, band of rows)
  long long blk = blockIdx.x;
  const int band = static_cast<int>(blk % bands);
  blk /= bands;
  const int c = static_cast<int>(blk % C);
  blk /= C;
  const long long b = blk / runs;
  const int n0 = static_cast<int>(blk - b * runs) * kPatches;
  const int j0 = band * band_rows;
  const int rows = min(band_rows, psz - j0);  // output rows of the band
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = min(kPatches, N - n0);    // patches of this block
  if (tid < kPatches) {
    const long long n = n0 + min(tid, count - 1);
    const float x = pts[(b * N + n) * 2], y = pts[(b * N + n) * 2 + 1];
    s_rx[tid] = x - floorf(x);
    s_ry[tid] = y - floorf(y);
    s_sx[tid] = static_cast<int>(ceilf(x + 1e-5f)) - psz / 2 - 1 + pad;
    s_sy[tid] = static_cast<int>(ceilf(y + 1e-5f)) - psz / 2 - 1 + pad;
  }
  __syncthreads();
  const float rx = s_rx[lane], ry = s_ry[lane];
  const size_t plane = static_cast<size_t>(Hp) * Wp;
  const float* pc = im + (static_cast<size_t>(b) * C + c) * plane;
  // out[b, d, n0 + lane], d = (j psz + i) C + c
  float* po = out + static_cast<size_t>(b) * psz * psz * C * N + n0 + lane;
  const float* wl = win + lane * stride;  // this lane's window tile

  for (int i0 = 0; i0 < psz; i0 += band_cols) {
    const int cols = min(band_cols, psz - i0);
    const int tw = cols + 1;                  // the tile's window extent
    const int tile = tw * (rows + 1);
    if (i0 > 0) __syncthreads();  // phase 2 of the previous tile is done
    // phase 1: element e = tid + kThreads t of the block's tiles, row-major
    // per patch, as (patch p, row r, column col); kThreads in the same
    // digits (sp, sr, scol), added with carries
    int p = tid / tile, r = (tid - p * tile) / tw;
    int col = tid - p * tile - r * tw;
    const int sp = kThreads / tile, sr = (kThreads - sp * tile) / tw;
    const int scol = kThreads - sp * tile - sr * tw;
    while (p < count) {
      float v[kLoads];
      int at[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        at[u] = -1;
        if (p < count) {
          const int yy = min(max(s_sy[p] + j0 + r, 0), Hp - 1);
          const int xx = min(max(s_sx[p] + i0 + col, 0), Wp - 1);
          v[u] = pc[static_cast<size_t>(yy) * Wp + xx];
          at[u] = p * stride + r * tw + col;
        }
        col += scol;
        if (col >= tw) {
          col -= tw;
          ++r;
        }
        r += sr;
        if (r > rows) {
          r -= rows + 1;
          ++p;
        }
        p += sp;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (at[u] >= 0) win[at[u]] = v[u];
    }
    __syncthreads();
    // phase 2: lane = patch; the warps take (row, run of columns) units,
    // each y-lerping the window down its columns and x-lerping neighbours
    if (lane < count) {
      const int runs_row = max(1, (kThreads / 32) / rows);
      const int run_cols = (cols + runs_row - 1) / runs_row;
      for (int q = warp; q < rows * runs_row; q += kThreads / 32) {
        const int rr = q / runs_row;
        const int i_lo = (q - rr * runs_row) * run_cols;
        const int i_hi = min(cols, i_lo + run_cols);
        if (i_lo >= i_hi) continue;
        const float* top = wl + rr * tw;
        const float* bot = top + tw;
        float* o = po + (static_cast<size_t>((j0 + rr) * psz + i0 + i_lo) * C +
                         c) * N;
        float g0 = (1.0f - ry) * top[i_lo] + ry * bot[i_lo];
        for (int i = i_lo + 1; i <= i_hi; ++i) {
          const float g1 = (1.0f - ry) * top[i] + ry * bot[i];
          *o = rx * g1 + (1.0f - rx) * g0;
          o += static_cast<size_t>(C) * N;
          g0 = g1;
        }
      }
    }
  }
}

}  // namespace

// C entry (bound with ctypes). Tensors: im (B,C,Hp,Wp) padded level planes,
// pts (B,N,2) float positions (x, y) in unpadded level coordinates; output
// out (B, psz^2 C, N). Any batch and patch count; one launch. Returns the
// launch's cudaError_t.
extern "C" int of_bilerp_extract(const float* im, const float* pts,
                                 float* out, int B, int C, int Hp, int Wp,
                                 int N, int psz, int pad, void* stream) {
  if (B < 0 || C < 1 || N < 0 || psz < 1 || Hp < 1 || Wp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  // The tile: the whole (psz+1)^2 window where it fits, else bands of
  // full-width rows, else (a window row longer than half the room) two
  // rows of a band of columns. A tile takes at most kTileFloats - 1 floats,
  // so that its odd stride fits too.
  constexpr int kTile = kTileFloats - 1;
  const long long w1 = psz + 1;
  int band_rows = psz, band_cols = psz;
  if (w1 * w1 > kTile) {
    if (2 * w1 <= kTile) {
      band_rows = static_cast<int>(kTile / w1) - 1;
    } else {
      band_rows = 1;
      band_cols = kTile / 2 - 1;
    }
  }
  // fewer rows a band (but two at least) where the grid would hold too
  // few blocks
  const long long runs = (N + kPatches - 1) / kPatches;
  const long long base = static_cast<long long>(B) * runs * C;
  if (base < kTargetBlocks) {
    const long long want = (kTargetBlocks + base - 1) / base;  // bands
    const int rows = static_cast<int>((psz + want - 1) / want);
    band_rows = min(band_rows, max(rows, 2));
  }
  const int bands = (psz + band_rows - 1) / band_rows;
  const int stride = ((band_rows + 1) * (band_cols + 1)) | 1;
  const long long blocks = base * bands;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kPatches) * stride * 4;
  bilerp_extract_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      im, pts, out, C, Hp, Wp, N, psz, pad, band_rows, band_cols, stride,
      runs, bands);
  return static_cast<int>(cudaGetLastError());
}
