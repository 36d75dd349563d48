// Unit-rate micro-kernels for NVIDIA Hopper (sm_90a): the JAX package's
// tools/roofline.py (T3) `_vpu_kernel` (:86) and `_mxu_kernel` (:115),
// asked of this card. mmde_tpu_torch/tools/roofline.py times each at two
// in-kernel iteration counts and reads a sustained rate off the difference
// (launch cost cancels), as the JAX tool's `microbench` does, and holds
// every kernel to a plain PyTorch version.
//
//   mmde_roofline_chain   a (512, 1024) fp32 array held in registers (four
//                         independent elements a thread, blocks over all
//                         SMs), 8 dependent ops an iteration: add (the JAX
//                         tool's x + 1.0009765625), fma (x * a + b, the fp32
//                         FMA rate), expf(x * 1e-4) (the JAX tool's exp) and
//                         __expf(x * 1e-4) (ex2.approx: what the kernels'
//                         exp_<true> compiles to)
//   mmde_roofline_rowsum  the JAX tool's row-sum chain over 1024-wide rows,
//                         x += rowsum(x) * 1e-6: a warp a row, 32 elements a
//                         lane, the row reduced by shuffles
//   mmde_roofline_dot     the attention dot pattern at Dh = 32: acc (304,
//                         912) += sum over 4 heads of q_h (304, 32) k_h (912,
//                         32)^T, acc loop-carried; 64 x 64 output tiles a
//                         block, `copies` independent copies to fill the
//                         SMs; fp32 FMAs on 8 x 4 register tiles (the
//                         window-attention kernels' product today) or bf16
//                         mma.sync m16n8k16 with fp32 accumulation
//   mmde_roofline_copy    a 16-byte vector copy, grid-stride (bandwidth)
//
// Each is bound by the unit it isolates (FMA pipe, MUFU, shuffles, tensor
// cores, DRAM); that is the point. The rates are of this code on this
// card, not the datasheet's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int NT = 256;
enum Op { ADD = 0, FMA = 1, EXPF = 2, FASTEXP = 3 };
constexpr float FMA_A = 0.999f, FMA_B = 1e-3f;

template <int OP>
__device__ __forceinline__ float op(float x) {
  if (OP == ADD) return x + 1.0009765625f;
  if (OP == FMA) return fmaf(x, FMA_A, FMA_B);
  if (OP == EXPF) return expf(x * 1e-4f);
  return __expf(x * 1e-4f);
}

template <int OP>
__global__ void __launch_bounds__(NT)
chain_kernel(float4* __restrict__ x, int n4, int iters) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n4) return;
  float4 v = x[i];
  float a[4] = {v.x, v.y, v.z, v.w};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = op<OP>(a[j]);
  }
  x[i] = make_float4(a[0], a[1], a[2], a[3]);
}

constexpr int ROW = 1024;   // row width of the row-sum chain

__global__ void __launch_bounds__(128)
rowsum_kernel(float* __restrict__ x, int rows, int iters) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float* xr = x + (size_t)row * ROW;
  float a[ROW / 32];
#pragma unroll
  for (int j = 0; j < ROW / 32; ++j) a[j] = xr[j * 32 + lane];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < ROW / 32; ++j) s += a[j];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const float d = s * 1e-6f;
#pragma unroll
      for (int j = 0; j < ROW / 32; ++j) a[j] += d;
    }
  }
#pragma unroll
  for (int j = 0; j < ROW / 32; ++j) xr[j * 32 + lane] = a[j];
}

// ---------------------------------------------------------------------------
// the attention dot pattern
// ---------------------------------------------------------------------------
constexpr int DK = 128;    // 4 heads x Dh 32, summed into one accumulator
constexpr int TT = 64;     // output tile edge
constexpr int F_LD = TT + 4;       // fp32 tiles [d][row], padded
constexpr int B_LD = DK + 8;       // bf16 tiles [row][d], padded

// grid (tiles along np, tiles along bq, copies); fp32: 128 threads, each
// an 8 x 4 register tile of the 64 x 64 output (as K1's logits phase)
__global__ void __launch_bounds__(128)
dot_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                float* __restrict__ acc, int bq, int np, int iters) {
  extern __shared__ __align__(16) float sm[];
  float* sQt = sm;                 // [DK][F_LD]
  float* sKt = sm + DK * F_LD;     // [DK][F_LD]
  const int r0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  for (int e = threadIdx.x; e < DK * TT; e += 128) {
    const int d = e % DK, r = e / DK;
    sQt[d * F_LD + r] = r0 + r < bq ? q[(size_t)(r0 + r) * DK + d] : 0.0f;
    sKt[d * F_LD + r] = c0 + r < np ? k[(size_t)(c0 + r) * DK + d] : 0.0f;
  }
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    for (int h = 0; h < 4; ++h) {
#pragma unroll 8
      for (int d = h * 32; d < h * 32 + 32; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * F_LD + ty * 8]);
        const float4 qb =
            *reinterpret_cast<const float4*>(&sQt[d * F_LD + ty * 8 + 4]);
        const float4 kk = *reinterpret_cast<const float4*>(&sKt[d * F_LD + tx * 4]);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
  }
  float* out = acc + (size_t)blockIdx.z * bq * np;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty * 8 + i, c = c0 + tx * 4 + j;
      if (r < bq && c < np) out[(size_t)r * np + c] = s[i][j];
    }
}

// bf16: 128 threads, warp w owns output rows 16w..16w+15 and all 8 n8
// tiles of the 64 x 64 output; per head two k16 steps of mma.sync
__global__ void __launch_bounds__(128)
dot_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k, float* __restrict__ acc,
                int bq, int np, int iters) {
  extern __shared__ __align__(16) __nv_bfloat16 smb[];
  __nv_bfloat16* sQ = smb;               // [TT][B_LD]
  __nv_bfloat16* sK = smb + TT * B_LD;   // [TT][B_LD]
  const int r0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int e = threadIdx.x; e < TT * DK; e += 128) {
    const int r = e / DK, d = e % DK;
    sQ[r * B_LD + d] = r0 + r < bq ? q[(size_t)(r0 + r) * DK + d] : zero;
    sK[r * B_LD + d] = c0 + r < np ? k[(size_t)(c0 + r) * DK + d] : zero;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;
  float d[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[n][c] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {   // 4 heads x 2 k16 steps
      const int kk = ks * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sQ[ra * B_LD + kk]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sQ[(ra + 8) * B_LD + kk]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sQ[ra * B_LD + kk + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sQ[(ra + 8) * B_LD + kk + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&sK[(n * 8 + g) * B_LD + kk]);
        b[1] = *reinterpret_cast<const uint32_t*>(
            &sK[(n * 8 + g) * B_LD + kk + 8]);
        mma_bf16_16816(d[n], a, b);
      }
    }
  }
  float* out = acc + (size_t)blockIdx.z * bq * np;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    const int rr[2] = {r0 + ra, r0 + ra + 8};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rr[h] < bq && c < np)   // np even: c + 1 < np too
        *reinterpret_cast<float2*>(out + (size_t)rr[h] * np + c) =
            make_float2(d[n][2 * h], d[n][2 * h + 1]);
  }
}

// four 16-byte loads in flight a thread before their stores
constexpr int COPY_UNROLL = 4;

__global__ void __launch_bounds__(NT)
copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
            long long n4) {
  const long long stride = (long long)gridDim.x * NT;
  long long i = blockIdx.x * (long long)NT + threadIdx.x;
  for (; i + (COPY_UNROLL - 1) * stride < n4; i += COPY_UNROLL * stride) {
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) v[u] = __ldg(src + i + u * stride);
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n4; i += stride) dst[i] = __ldg(src + i);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace

// Plain C entries: device pointers, launch on `stream`, allocate nothing,
// return cudaGetLastError() of the launch or -1 for arguments they do not
// take. In place: x is read, the chain applied `iters` times, written back.
extern "C" int mmde_roofline_chain(void* x, int n, int op_code, int iters,
                                   void* stream) {
  if (n <= 0 || n % 4 || iters < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return -1;
  const int n4 = n / 4, blocks = (n4 + NT - 1) / NT;
  cudaStream_t s = (cudaStream_t)stream;
  float4* p = (float4*)x;
  switch (op_code) {
    case ADD: chain_kernel<ADD><<<blocks, NT, 0, s>>>(p, n4, iters); break;
    case FMA: chain_kernel<FMA><<<blocks, NT, 0, s>>>(p, n4, iters); break;
    case EXPF: chain_kernel<EXPF><<<blocks, NT, 0, s>>>(p, n4, iters); break;
    case FASTEXP:
      chain_kernel<FASTEXP><<<blocks, NT, 0, s>>>(p, n4, iters);
      break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// x (rows, 1024) fp32, in place
extern "C" int mmde_roofline_rowsum(void* x, int rows, int cols, int iters,
                                    void* stream) {
  if (rows <= 0 || cols != ROW || iters < 0) return -1;
  rowsum_kernel<<<(rows + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (float*)x, rows, iters);
  return (int)cudaGetLastError();
}

// acc (copies, bq, np) fp32 = iters * sum_h q_h k_h^T, q (bq, 128) and
// k (np, 128) both fp32 or both bf16 (bf16 = 1); np even
extern "C" int mmde_roofline_dot(const void* q, const void* k, void* acc,
                                 int bq, int np, int iters, int copies,
                                 int bf16, void* stream) {
  if (bq <= 0 || np <= 0 || np % 2 || iters < 0 || copies <= 0 ||
      copies > 65535)
    return -1;
  dim3 grid((np + TT - 1) / TT, (bq + TT - 1) / TT, copies);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const int bytes = 2 * TT * B_LD * 2;
    dot_bf16_kernel<<<grid, 128, bytes, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (float*)acc, bq, np,
        iters);
  } else {
    const int bytes = 2 * DK * F_LD * 4;
    cudaError_t err = cudaFuncSetAttribute(
        dot_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    dot_fp32_kernel<<<grid, 128, bytes, s>>>((const float*)q, (const float*)k,
                                             (float*)acc, bq, np, iters);
  }
  return (int)cudaGetLastError();
}

// dst = src, n floats (a multiple of 4), 16-byte aligned
extern "C" int mmde_roofline_copy(const void* src, void* dst, long long n,
                                  void* stream) {
  if (n <= 0 || n % 4 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return -1;
  const int blocks = sm_count() * 8;
  copy_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (float4*)dst, n / 4);
  return (int)cudaGetLastError();
}
