// K4 — cv::INTER_LINEAR upscale of the final flow by 2^sc_l, values scaled
// by 2^sc_l (run_dense.cpp:408-412), written channels-last.
//
// Replaces: of_dis_tpu/models/dis.py::_upscale_cf_pallas.
//
// Bound on an H100: bytes, and almost all of them are the output write:
// B*H*W*nop*4 bytes (235 MB at batch 64, 1024x448, nop 2) against a
// 1/64 as large input that L2 serves.
//
// Design:
// - Each axis takes its two taps from index/weight tables built on the host
//   from the INTER_LINEAR interpolation matrix (the value scale folded into
//   the vertical weights), so the sum is the matrix product's, term for
//   term: ga*(fa*a + fb*b) + gb*(fa*c + fb*d).
// - A 3-D grid (x tiles, bands of kRows output rows, batch), with no
//   integer division; a call of more than 65,535 pairs (z's limit)
//   launches once for each chunk of as many. A tile is kTile floats of one output row (512 pixels
//   at nop 2, 1,024 at nop 1); each of the 256 threads owns one 16-byte
//   vector of it (4/nop pixels x nop channels) in every row of the band.
// - A thread's column taps are loaded once and stay in registers over the
//   band; a row's taps are uniform. The block stages the window of the two
//   input rows its tile reads (from its first column tap to its last; at
//   most `win` columns, from the host, which reads kTile from
//   of_upscale_tile_floats()) in shared memory, once for each new pair of
//   input rows.
// - Stores: one 16-byte vector store a thread (a channels-last output row
//   is one contiguous W*nop*4-byte run). Rows that do not start on a
//   16-byte boundary, and the last partial vector of a row, take scalar
//   stores. (Writing each tile row by one bulk async copy from shared
//   memory, cp.async.bulk, was measured 9-27% slower on the H100 at op-2's
//   x8: the block waits on its copies; PERF.md.)

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // floats a thread writes a row
constexpr int kTile = kThreads * kVec;    // floats of a row a block writes
constexpr int kRows = 8;                  // output rows a block
constexpr int kMaxGridZ = 65535;          // the grid's z: pairs a launch

// NOP consecutive floats of a staged row, as one load where they fit one
template <int NOP>
__device__ __forceinline__ void load_px(const float* p, float* v) {
  if constexpr (NOP == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < NOP; ++c) v[c] = p[c];
  }
}

template <int NOP>
__global__ void __launch_bounds__(kThreads)
    upscale_kernel(const float* __restrict__ in, const int* __restrict__ ty0,
                   const int* __restrict__ ty1, const float* __restrict__ wy0,
                   const float* __restrict__ wy1, const int* __restrict__ tx0,
                   const int* __restrict__ tx1, const float* __restrict__ wx0,
                   const float* __restrict__ wx1, float* __restrict__ out,
                   int h, int w, int H, int W, int stage, bool aligned) {
  constexpr int P = kVec / NOP;           // pixels a thread
  extern __shared__ float4 smem4[];
  float* const ra = reinterpret_cast<float*>(smem4);  // stage floats
  float* const rb = ra + stage;                        // stage floats

  const int b = blockIdx.z;
  const int xt = blockIdx.x * (kTile / NOP);  // the tile's first pixel
  const int xe = min(W, xt + kTile / NOP);    // one past its last
  const int c0 = __ldg(tx0 + xt);             // the window's first column
  const int ncol = (__ldg(tx1 + xe - 1) - c0 + 1) * NOP;
  const int px = xt + static_cast<int>(threadIdx.x) * P;
  // the floats of the row this thread writes (none where <= 0)
  const int nvalid = min(kVec, (W - px) * NOP);

  int xa[P], xb[P];
  float fa[P], fb[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int x = min(px + k, W - 1);
    xa[k] = (__ldg(tx0 + x) - c0) * NOP;
    xb[k] = (__ldg(tx1 + x) - c0) * NOP;
    fa[k] = __ldg(wx0 + x);
    fb[k] = __ldg(wx1 + x);
  }

  const float* const in_b = in + static_cast<long long>(b) * h * w * NOP;
  int staged_a = -1, staged_b = -1;
  const int y_end = min(H, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int y = blockIdx.y * kRows; y < y_end; ++y) {
    const int ya = __ldg(ty0 + y), yb = __ldg(ty1 + y);
    const float ga = __ldg(wy0 + y), gb = __ldg(wy1 + y);
    if (ya != staged_a || yb != staged_b) {  // uniform over the block
      __syncthreads();                       // the last rows' reads are done
      const float* sa = in_b + (static_cast<long long>(ya) * w + c0) * NOP;
      const float* sb = in_b + (static_cast<long long>(yb) * w + c0) * NOP;
      for (int i = threadIdx.x; i < ncol; i += kThreads) {
        ra[i] = __ldg(sa + i);
        rb[i] = __ldg(sb + i);
      }
      __syncthreads();
      staged_a = ya;
      staged_b = yb;
    }
    float v[kVec];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float a0[NOP], a1[NOP], b0[NOP], b1[NOP];
      load_px<NOP>(ra + xa[k], a0);
      load_px<NOP>(ra + xb[k], a1);
      load_px<NOP>(rb + xa[k], b0);
      load_px<NOP>(rb + xb[k], b1);
#pragma unroll
      for (int c = 0; c < NOP; ++c) {
        const float t0 = fa[k] * a0[c] + fb[k] * a1[c];
        const float t1 = fa[k] * b0[c] + fb[k] * b1[c];
        v[k * NOP + c] = ga * t0 + gb * t1;
      }
    }
    // the tile's first float of this row, counted from `out`
    const long long first =
        ((static_cast<long long>(b) * H + y) * W + xt) * NOP;
    float* const o = out + first + (px - xt) * NOP;
    if (aligned && (first & 3) == 0 && nvalid == kVec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < nvalid; ++i) o[i] = v[i];
    }
  }
}

template <int NOP>
cudaError_t launch(const float* in, const int* ty0, const int* ty1,
                   const float* wy0, const float* wy1, const int* tx0,
                   const int* tx1, const float* wx0, const float* wx1,
                   float* out, int B, int h, int w, int H, int W, int win,
                   cudaStream_t s) {
  // each staged row rounded up to whole 16-byte vectors
  const int stage = (win * NOP + 3) / 4 * 4;
  const size_t smem = sizeof(float) * 2 * stage;
  auto kernel = upscale_kernel<NOP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // chunks of at most kMaxGridZ pairs, each its own launch
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const float* in_c = in + static_cast<long long>(b0) * h * w * NOP;
    float* out_c = out + static_cast<long long>(b0) * H * W * NOP;
    const bool aligned =
        (reinterpret_cast<std::uintptr_t>(out_c) & 15) == 0;
    const dim3 grid((W + kTile / NOP - 1) / (kTile / NOP),
                    (H + kRows - 1) / kRows, std::min(B - b0, kMaxGridZ));
    kernel<<<grid, kThreads, smem, s>>>(in_c, ty0, ty1, wy0, wy1, tx0, tx1,
                                        wx0, wx1, out_c, h, w, H, W, stage,
                                        aligned);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of an output row one block writes: a tile is kTile / nop output
// columns, the unit of the `win` the host passes.
extern "C" int of_upscale_tile_floats() { return kTile; }

// C entry (bound with ctypes). in (B,h,w,nop) channels-last, nop 1 or 2;
// row tables ty0/ty1/wy0/wy1 (H,), column tables tx0/tx1/wx0/wx1 (W,);
// out (B,H,W,nop); win: the most input columns the taps of one tile of
// kTile / nop output columns span.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for another nop).
extern "C" int of_upscale(const float* in, const int* ty0, const int* ty1,
                          const float* wy0, const float* wy1, const int* tx0,
                          const int* tx1, const float* wx0, const float* wx1,
                          float* out, int B, int h, int w, int H, int W,
                          int nop, int win, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nop == 1) {
    return static_cast<int>(launch<1>(in, ty0, ty1, wy0, wy1, tx0, tx1, wx0,
                                      wx1, out, B, h, w, H, W, win, s));
  }
  if (nop == 2) {
    return static_cast<int>(launch<2>(in, ty0, ty1, wy0, wy1, tx0, tx1, wx0,
                                      wx1, out, B, h, w, H, W, win, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
