// Hopper (sm_90a) instructions the tools' kernels (probes.cu, roofline.cu)
// emit as inline PTX: warp-level bf16 tensor-core products (mma.sync),
// mbarriers, and TMA tensor-tile loads. The tensor map a TMA load reads is
// encoded on the host (encode_tensor_map_tiled) through the entry point
// cudaGetDriverEntryPoint hands out, so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: a 16 x 16 (row-major fragment, 4 regs), b 16 x 8 (column
// fragment, 2 regs), bf16 operands, fp32 accumulators d[4]. Fragment
// layout (lane = 4 * g + t): a{0,1,2,3} hold (row g | g+8, cols 2t..2t+1 |
// 2t+8..2t+9) as (g, lo-k), (g+8, lo-k), (g, hi-k), (g+8, hi-k); b{0,1} hold
// (k 2t..2t+1 | 2t+8..2t+9, col g); d holds (row g, cols 2t, 2t+1) and
// (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's earlier shared-memory accesses before later TMA
// writes into the same buffer
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a rank-4 tensor map into shared memory (128-byte aligned);
// completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Host side: cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no link against libcuda). dims / box innermost
// first, strides in bytes of dims 1..rank-1. Returns 0 or an error code.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline int encode_tensor_map_tiled(CUtensorMap* map, CUtensorMapDataType type,
                                   int rank, const void* base,
                                   const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
  if (err != cudaSuccess) return (int)err;
  if (fn == nullptr || q != cudaDriverEntryPointSuccess) return -2;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = reinterpret_cast<EncodeTiledFn>(fn)(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace
