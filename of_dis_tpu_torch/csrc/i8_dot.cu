// T1 — tensor-core dot microbenchmark: out[g] = sum_{i < reps} A @ B_i for
// g < grid, B_i = B[:, n i : n i + n], in two instantiations: int8 x int8 ->
// int32 and bf16 x bf16 -> float32. It asks how fast the card's integer
// tensor-core path runs beside the bf16 one at the GN extraction's product
// shape ((832, 256) @ (256, 256) by default).
//
// Replaces: tools/bench_i8_dot.py::main.make (the TPU kernel that runs
// `reps` int8 or bf16 MXU dots of one (m, k) block into one accumulator,
// repeated over `grid` programs; it keeps A and B in VMEM).
//
// Bound on an H100: operations — 2 m k n reps grid of them on the tensor
// cores (1,979 TOP/s int8, 989 TFLOP/s bf16, dense): 0.2257 ms int8 and
// 0.4516 ms bf16 at the defaults. Device memory is no limit (A and B, 4.2
// MB int8, are read once from it), but the L2 may be: every block reads
// all of B for its tile of out. With tiles of 64 rows, B (4 MB int8, 8 MB
// bf16) would cross the L2 13 x 64 times, 3.4 GB int8 / 6.7 GB bf16, above
// the operation bound at the L2's few TB/s; tiles of 128 rows x 256
// columns read it 7 x 64 times, 1.8 GB int8 / 3.7 GB bf16, about the
// operation bound for int8 and within 1.5x of it for bf16. (On an H100
// 80GB HBM3 at 700 W, tiles of 256 x 128, which read B 4 x 64 times, ran
// 7-10% slower: the L2 is not what holds this kernel; PERF.md.)
//
// Design: a product of K' = reps k, A repeated: Sum_i A @ B_i. A block of
// three warpgroups owns a 128 x 256 tile of one out[g]. Warpgroup 0 is the
// producer: one thread loads the block's A stripe (128 rows, all of k) once
// by TMA into shared memory, where it stays across the reps (as the TPU
// kernel keeps A in VMEM), then streams B_i in 128-byte slices of k (256
// rows x 128 bytes, 32 KB) into a ring of 2-6 stages, each guarded by a
// `full` and an `empty` mbarrier. Warpgroups 1 and 2 are the consumers,
// 64 rows each: per slice four `wgmma.mma_async` of 32 bytes of k
// (m64n256k32 s8 -> s32, m64n256k16 bf16 -> f32), both operands K-major in
// 128-byte swizzled shared memory addressed by matrix descriptors, into
// 128 accumulator registers a thread that stay there across all reps; a
// slice's stage is released when the next slice's products are issued and
// its own have completed (wgmma.wait_group 1). The tensor maps come from
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (no -lcuda);
// TMA fills rows and k beyond the arrays with zeros, which add nothing, and
// columns past n (the next rep's rows of Bt) are computed and not stored.
// A warpgroup whose 64 rows all lie past m issues no products. Each g
// computes and writes its own out[g], two neighbouring columns a store. Both sums are exact for integer
// inputs below 2^24 in magnitude (the float32 one too), whatever the
// order.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 128, kBN = 256;   // block tile of out
constexpr int kSlice = 128;           // bytes of k in a shared slice
constexpr int kASlice = kBM * kSlice;   // 16 KB: A's rows, one slice
constexpr int kBSlice = kBN * kSlice;   // 32 KB: one stage of B
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kMaxStages = 6;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Matrix descriptor of a K-major tile in 128-byte swizzled shared memory:
// rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO), the leading
// offset unused; the start moves by 32 bytes a k-step inside the swizzle.
__device__ __forceinline__ uint64_t descriptor(const void* p) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d += A B over one 32-byte k-step (scale-d true: accumulate).
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a,
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// ACC int: int8 operands; float: bf16 operands. Both tensor maps address
// the operands in 128-byte slices of k: A (m, k) in boxes of 128 rows, Bt
// (reps n, k) in boxes of 256 rows.
template <typename ACC>
__global__ void __launch_bounds__(kThreads, 1)
    dot_sum_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   ACC* __restrict__ out, int m, int n, int slices, int reps,
                   int stages, int slice_elems) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = base;
  uint8_t* sb = base + slices * kASlice;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + stages * kBSlice);
  uint64_t* empty = full + kMaxStages;
  uint64_t* a_full = empty + kMaxStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wg = threadIdx.x / 128;
  const int total = reps * slices;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);   // the consumers' eight warps
    }
    bar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: A once, then B_i slice by slice through the ring
    if (threadIdx.x == 0) {
      bar_expect(a_full, slices * kASlice);
      for (int c = 0; c < slices; ++c)
        tma_load(sa + c * kASlice, &ta, c * slice_elems, m0, a_full);
      for (int t = 0; t < total; ++t) {
        const int s = t % stages, round = t / stages;
        if (round > 0) bar_wait(&empty[s], (round - 1) & 1);
        bar_expect(&full[s], kBSlice);
        const int r = t / slices, c = t - r * slices;
        tma_load(sb + s * kBSlice, &tb, c * slice_elems, r * n + n0,
                 &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup 1 rows m0 .. m0 + 63, warpgroup 2 the next 64
  const int cw = wg - 1;
  const bool active = m0 + 64 * cw < m;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  ACC d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = ACC(0);
  bar_wait(a_full, 0);
  for (int t = 0; t < total; ++t) {
    const int s = t % stages, round = t / stages;
    const int c = t % slices;
    bar_wait(&full[s], round & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (active) {
      const uint8_t* a = sa + c * kASlice + cw * (kASlice / 2);
      const uint8_t* b = sb + s * kBSlice;
#pragma unroll
      for (int ks = 0; ks < kSlice; ks += 32)
        wgmma(d, descriptor(a + ks), descriptor(b + ks));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the slice before this one is done: its stage goes back to the ring
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (t > 0 && lane == 0) bar_arrive(&empty[(t - 1) % stages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // d[4 j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
  // 8 j + 2 (lane % 4) + (e & 1)
  ACC* o = out + static_cast<size_t>(blockIdx.z) * m * n;
  const int row = m0 + 64 * cw + 16 * warp + lane / 4;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + h * 8;
      const int col = n0 + 8 * j + 2 * (lane % 4);
      ACC* q = o + static_cast<size_t>(r) * n + col;
      if (r < m && col + 1 < n && pairs) {
        // two neighbouring columns in one 8-byte store (n even: aligned)
        using V = typename std::conditional<std::is_same<ACC, int>::value,
                                            int2, float2>::type;
        V v;
        v.x = d[4 * j + 2 * h];
        v.y = d[4 * j + 2 * h + 1];
        *reinterpret_cast<V*>(q) = v;
      } else {
        if (r < m && col < n) q[0] = d[4 * j + 2 * h];
        if (r < m && col + 1 < n) q[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D tensor map of a row-major (rows, k) matrix in boxes of `box_rows`
// rows x 128 bytes, 128-byte swizzle, zeros beyond the matrix.
bool encode(CUtensorMap* map, const void* ptr, int rows, int k, bool bf16,
            int box_rows) {
  auto fn = encoder();
  if (fn == nullptr) return false;
  const int esize = bf16 ? 2 : 1;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * esize};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlice / esize),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map,
                  bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  2, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <typename ACC>
cudaError_t launch(const void* a, const void* bt, ACC* out, int m, int k,
                   int n, int reps, int grid, bool bf16, cudaStream_t s) {
  const int kbytes = k * (bf16 ? 2 : 1);
  const int slices = (kbytes + kSlice - 1) / kSlice;
  const int fixed = 1024 + slices * kASlice + 8 * (2 * kMaxStages + 1);
  const int stages = std::min(kMaxStages, (kMaxSmem - fixed) / kBSlice);
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = fixed + stages * kBSlice;
  auto kernel = dot_sum_kernel<ACC>;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  CUtensorMap ta, tb;
  if (!encode(&ta, a, m, k, bf16, kBM) ||
      !encode(&tb, bt, reps * n, k, bf16, kBN))
    return cudaErrorInvalidValue;
  const dim3 blocks((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, grid);
  kernel<<<blocks, kThreads, smem, s>>>(ta, tb, out, m, n, slices, reps,
                                        stages, kSlice / (bf16 ? 2 : 1));
  return cudaGetLastError();
}

}  // namespace

// C entry (bound with ctypes). a (m, k) row-major, bt (reps n, k) row-major
// (B transposed), both int8 when bf16 == 0 (out int32) or bf16 when
// bf16 == 1 (out float32); out (grid, m, n). k times the element size must
// be a multiple of 16 and at most 1,280 bytes (A's stripe stays in shared
// memory), both pointers 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int of_i8_dot(const void* a, const void* bt, void* out, int m,
                         int k, int n, int reps, int grid, int bf16,
                         void* stream) {
  const int kbytes = k * (bf16 ? 2 : 1);
  if (m < 0 || n < 0 || k < 0 || reps < 0 || grid < 0 || kbytes % 16 != 0 ||
      kbytes > 1280 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0 || grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0 || reps == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(grid) * m * n * 4, s));
  if (bf16)
    return static_cast<int>(launch<float>(a, bt, static_cast<float*>(out), m,
                                          k, n, reps, grid, true, s));
  return static_cast<int>(launch<int>(a, bt, static_cast<int*>(out), m, k, n,
                                      reps, grid, false, s));
}
