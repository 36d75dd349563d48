// Layout probes for NVIDIA Hopper (sm_90a): the six probes of the JAX
// package's tools/probe_mosaic.py (T1), asked of this card instead of the
// TPU's Mosaic compiler. Each answers whether a layout trick the
// window-attention kernels (or their tensor-core rewrite) would rely on
// works here, and each is held to a plain PyTorch version by
// mmde_tpu_torch/tools/probe_layouts.py.
//
//   probe_mosaic.py                   here
//   probe_lane_carved_blockspec :41   mmde_probe_lane_carved: block h reads
//                                     columns 32h..32h+31 of (N, C) fp32
//                                     rows with 16-byte loads, writes x2
//   probe_inkernel_window_reshape :60 mmde_probe_window_rows (back = 0): a
//   probe_inkernel_reshape_back :78   ws x ws window of a (B, Hp, Wp, C)
//                                     map to (ws*ws, C) rows, +1, and back
//                                     (back = 1), x3: the slab kernels'
//                                     window addressing (MapRows)
//   probe_static_lane_slice :100      mmde_probe_static_slice: the sum of
//                                     the C/32 column slices, unrolled
//   probe_dynamic_lane_slice :119     mmde_probe_dynamic_slice: rows staged
//                                     whole in shared memory, the slice at
//                                     blockIdx.x * 32 read back, x2
//   probe_rank4_map_block_matmul :142 mmde_probe_rank4_matmul: one block per
//                                     window of a (B, Hp, Wp, 128) map; the
//                                     window tile comes in through a rank-4
//                                     TMA tensor map, a few window rows per
//                                     box (a 30 x 30 x 128 window is 460.8
//                                     KB in fp32, 230.4 KB in bf16: more
//                                     than a block's 227 KB), two boxes in
//                                     flight on two mbarriers; each box is
//                                     multiplied by a (128, 128) matrix
//                                     (fp32 FMAs, or bf16 mma.sync m16n8k16
//                                     with fp32 accumulation) and written
//                                     back to the output map.
//
// What bounds them: all but the last move a few hundred KB (bytes, a few
// microseconds at 3.35 TB/s, so launch latency decides); the fp32 product
// is bound by the FMA rate (2 * 10800 * 128 * 128 flops a map), the bf16
// one by the bytes of its fp32 output. None of them is tuned: a probe
// asks whether the pattern builds, runs and gives the right numbers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "window_attention_common.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int SLICE = 32;   // columns per slice (a head's width)

__global__ void __launch_bounds__(NT)
lane_carved_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int N, int C) {
  const int c0 = blockIdx.x * SLICE;   // this block's column block
  for (int e = threadIdx.x; e < N * (SLICE / 4); e += NT) {
    const int r = e / (SLICE / 4), c = c0 + (e % (SLICE / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * C + c));
    *reinterpret_cast<float4*>(out + (size_t)r * C + c) =
        make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  }
}

constexpr int DYN_ROWS = 16;   // rows staged per step

__global__ void __launch_bounds__(NT)
dynamic_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int N, int C) {
  extern __shared__ __align__(16) float srow[];   // [DYN_ROWS][C]
  const int c0 = blockIdx.x * SLICE;   // known at run time only
  for (int r0 = 0; r0 < N; r0 += DYN_ROWS) {
    const int rows = min(DYN_ROWS, N - r0);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * C / 4; e += NT)
      reinterpret_cast<float4*>(srow)[e] =
          __ldg(reinterpret_cast<const float4*>(x + (size_t)r0 * C) + e);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * SLICE; e += NT) {
      const int r = e / SLICE, c = e % SLICE;
      out[(size_t)(r0 + r) * C + c0 + c] = srow[r * C + c0 + c] * 2.0f;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(NT)
static_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int N) {
  const int r = blockIdx.x * (NT / SLICE) + threadIdx.x / SLICE;
  const int c = threadIdx.x % SLICE;
  if (r >= N) return;
  const float* row = x + (size_t)r * H * SLICE;
  float acc = 0.0f;
#pragma unroll
  for (int h = 0; h < H; ++h) acc += row[h * SLICE + c];
  out[(size_t)r * SLICE + c] = acc;
}

// one block per window; back = 0: rows[b] = window b of the map + 1,
// back = 1: window b of the map = rows[b] * 3
__global__ void __launch_bounds__(NT)
window_rows_kernel(MapRows<float> map, float* __restrict__ rows, int N,
                   int C, int back) {
  const int b = blockIdx.x;
  float* head = map.head(b, 0);
  float* rb = rows + (size_t)b * N * C;
  for (int e = threadIdx.x; e < N * C / 4; e += NT) {
    const int r = e / (C / 4), c = (e % (C / 4)) * 4;
    float4* px = reinterpret_cast<float4*>(head + map.off(r) + c);
    float4* pr = reinterpret_cast<float4*>(rb + (size_t)r * C + c);
    if (back) {
      const float4 v = *pr;
      *px = make_float4(v.x * 3.0f, v.y * 3.0f, v.z * 3.0f, v.w * 3.0f);
    } else {
      const float4 v = *px;
      *pr = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// rank-4 map tile x (128, 128) matrix, through TMA
// ---------------------------------------------------------------------------
constexpr int MC = 128;          // channels: the box's inner extent
constexpr int RT = 15;           // fp32 path: output rows per thread step
constexpr int WT_LD = MC + 8;    // bf16 path: padded rows of w^T

// window rows per TMA box: 76.8 KB a box at ws = 30 in either type
template <typename T>
__host__ __device__ constexpr int box_rows() { return sizeof(T) == 4 ? 5 : 10; }

template <typename T>
__host__ __device__ constexpr int matrix_bytes() {
  return sizeof(T) == 4 ? MC * MC * 4 : MC * WT_LD * 2;
}

// the fp32 product of one box: out rows (M of them, the box's pixels in
// row-major order) = box @ w, w [k][n] in shared memory
__device__ __forceinline__ void box_matmul(const float* __restrict__ sA,
                                           const float* __restrict__ sW,
                                           int M, float* __restrict__ out,
                                           const int* __restrict__ pix) {
  const int c = threadIdx.x % MC;
  const int half = threadIdx.x / MC;      // two halves of the rows
  for (int r0 = half * RT; r0 < M; r0 += 2 * RT) {
    float acc[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[j] = 0.0f;
    for (int k = 0; k < MC; k += 4) {
      const float w0 = sW[(k + 0) * MC + c], w1 = sW[(k + 1) * MC + c];
      const float w2 = sW[(k + 2) * MC + c], w3 = sW[(k + 3) * MC + c];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int r = min(r0 + j, M - 1);
        const float4 a = *reinterpret_cast<const float4*>(&sA[r * MC + k]);
        acc[j] = fmaf(a.x, w0, acc[j]);
        acc[j] = fmaf(a.y, w1, acc[j]);
        acc[j] = fmaf(a.z, w2, acc[j]);
        acc[j] = fmaf(a.w, w3, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (r0 + j < M) out[(size_t)pix[r0 + j] * MC + c] = acc[j];
  }
}

// the bf16 product of one box on the tensor cores: warp w owns output
// columns 16w..16w+15 (two n8 tiles) and walks the m16 tiles; w^T [n][k]
// (padded rows) in shared memory, its fragments held in registers
__device__ __forceinline__ void box_mma(const __nv_bfloat16* __restrict__ sA,
                                        const uint32_t (&bf)[8][2][2], int M,
                                        float* __restrict__ out,
                                        const int* __restrict__ pix) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * 16;
  for (int m0 = 0; m0 < M; m0 += 16) {
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int ra = m0 + g, rb = m0 + g + 8;
#pragma unroll
    for (int ks = 0; ks < MC / 16; ++ks) {
      const int k = ks * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ra < M ? *reinterpret_cast<const uint32_t*>(&sA[ra * MC + k]) : 0u;
      a[1] = rb < M ? *reinterpret_cast<const uint32_t*>(&sA[rb * MC + k]) : 0u;
      a[2] = ra < M ? *reinterpret_cast<const uint32_t*>(&sA[ra * MC + k + 8]) : 0u;
      a[3] = rb < M ? *reinterpret_cast<const uint32_t*>(&sA[rb * MC + k + 8]) : 0u;
      mma_bf16_16816(d[0], a, bf[ks][0]);
      mma_bf16_16816(d[1], a, bf[ks][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      if (ra < M)
        *reinterpret_cast<float2*>(out + (size_t)pix[ra] * MC + col) =
            make_float2(d[nt][0], d[nt][1]);
      if (rb < M)
        *reinterpret_cast<float2*>(out + (size_t)pix[rb] * MC + col) =
            make_float2(d[nt][2], d[nt][3]);
    }
  }
}

// grid (B, Hp / ws, Wp / ws): block (b, wi, wj) owns one window
template <typename T>
__global__ void __launch_bounds__(NT)
rank4_matmul_kernel(const __grid_constant__ CUtensorMap tmap,
                    const T* __restrict__ w, float* __restrict__ out, int Hp,
                    int Wp, int ws) {
  constexpr int R = box_rows<T>();
  extern __shared__ unsigned char smem_raw[];
  // 128-byte aligned base for the TMA boxes
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int M = R * ws;                       // pixels per box
  const int box_bytes = M * MC * (int)sizeof(T);
  T* buf[2] = {reinterpret_cast<T*>(base),
               reinterpret_cast<T*>(base + box_bytes)};
  unsigned char* sWraw = base + 2 * box_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sWraw + matrix_bytes<T>());
  int* pix = reinterpret_cast<int*>(bar + 2);  // [M] output pixel of a row

  const int b = blockIdx.x, wi = blockIdx.y, wj = blockIdx.z;
  const int chunks = ws / R;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  // the matrix: fp32 [k][n]; bf16 [n][k] (w^T, padded rows)
  for (int e = threadIdx.x; e < MC * MC; e += NT) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float*>(sWraw)[e] = w[e];
    } else {
      const int k = e / MC, n = e % MC;
      reinterpret_cast<__nv_bfloat16*>(sWraw)[n * WT_LD + k] = w[e];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 && i < chunks; ++i) {
      mbar_arrive_expect_tx(&bar[i], box_bytes);
      tma_load_4d(buf[i], &tmap, &bar[i], 0, wj * ws, wi * ws + i * R, b);
    }
  }
  uint32_t bf[8][2][2];       // bf16 path: w^T fragments of this warp
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* sWt = reinterpret_cast<const __nv_bfloat16*>(sWraw);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < MC / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = warp * 16 + nt * 8 + g, k = ks * 16 + 2 * t;
        bf[ks][nt][0] = *reinterpret_cast<const uint32_t*>(&sWt[n * WT_LD + k]);
        bf[ks][nt][1] =
            *reinterpret_cast<const uint32_t*>(&sWt[n * WT_LD + k + 8]);
      }
  }
  for (int i = 0; i < chunks; ++i) {
    // output pixel (flat index into the map) of each row of this box
    for (int r = threadIdx.x; r < M; r += NT)
      pix[r] = (b * Hp + wi * ws + i * R + r / ws) * Wp + wj * ws + r % ws;
    __syncthreads();
    mbar_wait(&bar[i & 1], (i >> 1) & 1);
    if constexpr (sizeof(T) == 4) {
      box_matmul(reinterpret_cast<const float*>(buf[i & 1]),
                 reinterpret_cast<const float*>(sWraw), M, out, pix);
    } else {
      box_mma(reinterpret_cast<const __nv_bfloat16*>(buf[i & 1]), bf, M, out,
              pix);
    }
    __syncthreads();      // every thread is done with this buffer and pix
    if (threadIdx.x == 0 && i + 2 < chunks) {
      fence_proxy_async();
      mbar_arrive_expect_tx(&bar[i & 1], box_bytes);
      tma_load_4d(buf[i & 1], &tmap, &bar[i & 1], 0, wj * ws,
                  wi * ws + (i + 2) * R, b);
    }
  }
}

template <typename T>
int launch_rank4(const void* x, const void* w, float* out, int B, int Hp,
                 int Wp, int C, int ws, cudaStream_t stream) {
  constexpr int R = box_rows<T>();
  if (C != MC || ws <= 0 || ws > 256 || Hp % ws || Wp % ws || ws % R ||
      B > 65535 || Hp / ws > 65535 || Wp / ws > 65535)
    return -1;
  if (reinterpret_cast<uintptr_t>(x) % 16) return -1;
  CUtensorMap tmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Wp, (cuuint64_t)Hp,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T),
                                 (cuuint64_t)Wp * C * sizeof(T),
                                 (cuuint64_t)Hp * Wp * C * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)ws, (cuuint32_t)R, 1};
  const int enc = encode_tensor_map_tiled(
      &tmap,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, x, dims, strides, box);
  if (enc != 0) return enc;
  const int M = R * ws;
  const int bytes = 128 + 2 * M * MC * (int)sizeof(T) + matrix_bytes<T>() +
                    16 + M * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rank4_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hp / ws, Wp / ws);
  rank4_matmul_kernel<T><<<grid, NT, bytes, stream>>>(
      tmap, (const T*)w, out, Hp, Wp, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries: device pointers, fp32 unless said; each launches on
// `stream`, allocates nothing and returns cudaGetLastError() of its launch,
// or -1 for a shape it does not take (C a multiple of 32 and of 4 rows'
// 16-byte alignment throughout).
extern "C" int mmde_probe_lane_carved(const void* x, void* out, int N, int C,
                                      void* stream) {
  if (N <= 0 || C <= 0 || C % SLICE) return -1;
  lane_carved_kernel<<<C / SLICE, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, C);
  return (int)cudaGetLastError();
}

extern "C" int mmde_probe_dynamic_slice(const void* x, void* out, int N,
                                        int C, void* stream) {
  if (N <= 0 || C <= 0 || C % SLICE || C > 2048) return -1;
  const int bytes = DYN_ROWS * C * (int)sizeof(float);
  dynamic_slice_kernel<<<C / SLICE, NT, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N, C);
  return (int)cudaGetLastError();
}

// out (N, 32) = the sum of x's (N, 512) sixteen 32-column slices
extern "C" int mmde_probe_static_slice(const void* x, void* out, int N,
                                       int C, void* stream) {
  if (N <= 0 || C != 16 * SLICE) return -1;
  const int blocks = (N + NT / SLICE - 1) / (NT / SLICE);
  static_slice_kernel<16><<<blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, N);
  return (int)cudaGetLastError();
}

// map (B, Hp, Wp, C) <-> rows (B * (Hp/ws) * (Wp/ws), ws*ws, C), windows
// image-major and row-major; back = 0: rows = map windows + 1, back = 1:
// map windows = rows * 3
extern "C" int mmde_probe_window_rows(void* map, void* rows, int B, int Hp,
                                      int Wp, int C, int ws, int back,
                                      void* stream) {
  if (B <= 0 || ws <= 0 || Hp % ws || Wp % ws || C % 4 ||
      reinterpret_cast<uintptr_t>(map) % 16 ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return -1;
  const long long nW = (long long)B * (Hp / ws) * (Wp / ws);
  if (nW > 65535 || (long long)ws * ws * ws >= (1ll << 32)) return -1;
  const MapRows<float> m = map_rows((float*)map, 0, C, 1, Hp, Wp, ws, 0);
  window_rows_kernel<<<(int)nW, NT, 0, (cudaStream_t)stream>>>(
      m, (float*)rows, ws * ws, C, back);
  return (int)cudaGetLastError();
}

// out (B, Hp, Wp, 128) fp32 = x (B, Hp, Wp, 128) @ w (128, 128), one block
// per ws x ws window; x and w both fp32 (FMAs) or both bf16 (x_bf16 = 1,
// mma.sync). ws a multiple of 5 (fp32) / 10 (bf16), at most 256.
extern "C" int mmde_probe_rank4_matmul(const void* x, const void* w,
                                       void* out, int B, int Hp, int Wp,
                                       int C, int ws, int x_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return launch_rank4<__nv_bfloat16>(x, w, (float*)out, B, Hp, Wp, C, ws,
                                       s);
  return launch_rank4<float>(x, w, (float*)out, B, Hp, Wp, C, ws, s);
}
