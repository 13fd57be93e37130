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
// Design: one thread per (pair b, patch pixel d, patch n). The grid is
// (blocks over n, d, b), so a block shares its pixel's row and column and
// does no index division; a warp writes 32 consecutive floats of one
// output row and reads 32 neighbouring patches' positions; its four window
// reads per channel hit L1 / L2 (neighbouring patches overlap). Anchor
// ceil(pt + 1e-5) and residual against floor(pt), both float32; y-lerp
// then x-lerp, the formulas of the plain twin
// (patch_solver.extract_bilinear) term by term (built with --fmad=false).
// Window indices outside the planes clamp.

#include <cuda_runtime.h>

namespace {

__global__ void bilerp_extract_kernel(const float* __restrict__ im,
                                      const float* __restrict__ pts,
                                      float* __restrict__ out, int B, int C,
                                      int Hp, int Wp, int N, int psz,
                                      int pad) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int d = blockIdx.y, b = blockIdx.z;
  const int pix = psz * psz;

  const size_t pb = (static_cast<size_t>(b) * N + n) * 2;
  const float x = pts[pb], y = pts[pb + 1];
  const float rx = x - floorf(x);
  const float ry = y - floorf(y);
  const int sx = static_cast<int>(ceilf(x + 1e-5f)) - psz / 2 - 1 + pad;
  const int sy = static_cast<int>(ceilf(y + 1e-5f)) - psz / 2 - 1 + pad;
  const int j = d / psz, i = d - j * psz;
  const int y0 = min(max(sy + j, 0), Hp - 1);
  const int y1 = min(max(sy + j + 1, 0), Hp - 1);
  const int x0 = min(max(sx + i, 0), Wp - 1);
  const int x1 = min(max(sx + i + 1, 0), Wp - 1);

  const size_t plane = static_cast<size_t>(Hp) * Wp;
  const float* pc = im + static_cast<size_t>(b) * C * plane;
  float* po = out + (static_cast<size_t>(b) * pix + d) * C * N + n;
  for (int c = 0; c < C; ++c, pc += plane, po += N) {
    const float v00 = pc[static_cast<size_t>(y0) * Wp + x0];
    const float v01 = pc[static_cast<size_t>(y0) * Wp + x1];
    const float v10 = pc[static_cast<size_t>(y1) * Wp + x0];
    const float v11 = pc[static_cast<size_t>(y1) * Wp + x1];
    const float g0 = (1.0f - ry) * v00 + ry * v10;
    const float g1 = (1.0f - ry) * v01 + ry * v11;
    *po = rx * g1 + (1.0f - rx) * g0;
  }
}

}  // namespace

// C entry (bound with ctypes). Tensors: im (B,C,Hp,Wp) padded level planes,
// pts (B,N,2) float positions (x, y) in unpadded level coordinates; output
// out (B, psz^2 C, N). Returns the launch's cudaError_t.
extern "C" int of_bilerp_extract(const float* im, const float* pts,
                                 float* out, int B, int C, int Hp, int Wp,
                                 int N, int psz, int pad, void* stream) {
  if (B < 0 || C < 1 || N < 0 || psz < 1 || Hp < 1 || Wp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  // grid y and z hold at most 65,535 blocks each
  if (psz * psz > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads - 1) / kThreads, psz * psz, B);
  bilerp_extract_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      im, pts, out, B, C, Hp, Wp, N, psz, pad);
  return static_cast<int>(cudaGetLastError());
}
