// T1 — tensor-core dot microbenchmark: out[g] = sum_{i < reps} A @ B_i for
// g < grid, B_i = B[:, n i : n i + n], in two instantiations: int8 x int8 ->
// int32 and bf16 x bf16 -> float32. It asks how fast the card's integer
// tensor-core path runs beside the bf16 one at the GN extraction's product
// shape ((832, 256) @ (256, 256) by default).
//
// Replaces: tools/bench_i8_dot.py::main.make (the TPU kernel that runs
// `reps` int8 or bf16 MXU dots of one (m, k) block into one accumulator,
// repeated over `grid` programs).
//
// Bound on an H100: operations — 2 m k n reps grid of them on the tensor
// cores (1,979 TOP/s int8, 989 TFLOP/s bf16, dense); A and B are read from
// L2 again and again, but once from device memory.
//
// Design: a simple, right kernel, not yet a fast one. A block of four warps
// owns a 64 x 64 tile of one out[g]; each warp a 32 x 32 quarter of it,
// 2 x 4 tiles of 16 x 8 for `mma.sync`. Per repetition and per 128-byte
// slice of k, the block copies its 64 rows of A and its 64 columns of B_i
// into shared memory (16-byte loads, zero beyond m, n and k), and every
// warp runs four k-steps of 32 bytes: m16n8k32 for int8, m16n8k16 for bf16
// — one k-step is 32 bytes of k in both, and the fragments of A and of B sit
// at the same byte offsets, so one kernel body serves both types. B comes
// transposed, Bt (reps n, k) (the mma's "col" operand: k contiguous per
// column; `ldmatrix.trans` does not transpose 8-bit data); the caller makes
// it once. Rows of the shared tiles are 144 bytes apart, so the fragment
// loads of a warp hit 32 different banks. Each g writes its own out[g]: no
// two blocks write one address. Both sums are exact for integer inputs
// below 2^24 in magnitude (the float32 one too), whatever the order.
// Later work: wgmma, TMA, a ring of stages, A kept across the repetitions.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64, kBN = 64;  // block tile of out
constexpr int kKB = 128;           // bytes of k per shared-memory slice
constexpr int kLds = kKB + 16;     // row stride of the shared tiles, bytes
constexpr int kThreads = 128;

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [r0, r0 + 64) (of `rows` valid ones) and bytes [kb, kb + 128)
// (of `kbytes`) of a row-major byte matrix into a shared tile; zeros
// outside.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int r0,
                                      int rows, int kb, int kbytes) {
  for (int c = threadIdx.x; c < kBM * (kKB / 16); c += kThreads) {
    const int row = c / (kKB / 16), col = (c % (kKB / 16)) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + row < rows && kb + col < kbytes)
      v = *reinterpret_cast<const int4*>(
          src + static_cast<size_t>(r0 + row) * kbytes + kb + col);
    *reinterpret_cast<int4*>(dst + row * kLds + col) = v;
  }
}

// ACC int: int8 operands; float: bf16 operands. kbytes = k * element size.
template <typename ACC>
__global__ void __launch_bounds__(kThreads)
    dot_sum_kernel(const unsigned char* __restrict__ a,
                   const unsigned char* __restrict__ bt,
                   ACC* __restrict__ out, int m, int kbytes, int n,
                   int reps) {
  __shared__ __align__(16) unsigned char sa[kBM * kLds];
  __shared__ __align__(16) unsigned char sb[kBN * kLds];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  ACC acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = ACC(0);

  for (int r = 0; r < reps; ++r) {
    // columns n0.. of B_r are rows r n + n0.. of Bt; none past n
    const unsigned char* btr = bt + static_cast<size_t>(r) * n * kbytes;
    for (int kb = 0; kb < kbytes; kb += kKB) {
      stage(sa, a, m0, m, kb, kbytes);
      stage(sb, btr, n0, n, kb, kbytes);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKB; ks += 32) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p = sa + (wm + mi * 16 + g) * kLds + ks + 4 * t;
          af[mi][0] = ld32(p);
          af[mi][1] = ld32(p + 8 * kLds);
          af[mi][2] = ld32(p + 16);
          af[mi][3] = ld32(p + 8 * kLds + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned char* p = sb + (wn + ni * 8 + g) * kLds + ks + 4 * t;
          bf[ni][0] = ld32(p);
          bf[ni][1] = ld32(p + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
  }

  ACC* o = out + static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (row < m && col < n) o[static_cast<size_t>(row) * n + col] =
            acc[mi][ni][e];
      }
    }
  }
}

}  // namespace

// C entry (bound with ctypes). a (m, k) row-major, bt (reps n, k) row-major
// (B transposed), both int8 when bf16 == 0 (out int32) or bf16 when
// bf16 == 1 (out float32); out (grid, m, n). k times the element size must
// be a multiple of 16 and both pointers 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int of_i8_dot(const void* a, const void* bt, void* out, int m,
                         int k, int n, int reps, int grid, int bf16,
                         void* stream) {
  const int kbytes = k * (bf16 ? 2 : 1);
  if (m < 0 || n < 0 || reps < 0 || grid < 0 || kbytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0 || grid == 0) return 0;
  const dim3 blocks((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(bt);
  if (bf16)
    dot_sum_kernel<float><<<blocks, kThreads, 0, s>>>(
        pa, pb, static_cast<float*>(out), m, kbytes, n, reps);
  else
    dot_sum_kernel<int><<<blocks, kThreads, 0, s>>>(
        pa, pb, static_cast<int*>(out), m, kbytes, n, reps);
  return static_cast<int>(cudaGetLastError());
}
