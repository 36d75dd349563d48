// Device helpers shared by the window-attention kernels
// (window_attention_fwd.cu, window_attention_bwd.cu,
// window_attention_bwd_resident.cu).
//
// Every operand of shape (window b, head h, token r, channel d) is handed to
// a kernel as a layout struct with two methods: head(b, h), the address of
// the head's token 0, and off(r), token r's offset from there; the channel
// axis is unit-stride. The kernels are templates over that struct.
//
//   Rows     a base pointer and three element strides. The packed entry
//            points describe q, k and v as the three column blocks of the
//            qkv Linear's (B_, N, 3C) output (strides N*3C, 32, 3C), the
//            head-split entry points pass the strides of whatever
//            (B_, nH, N, 32) view the caller holds - the permuted view of
//            that same qkv tensor, or a contiguous one.
//   MapRows  the slab entry points: windows read straight off the
//            (B, Hp, Wp, parts*C) map (see below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
struct Rows {
  T* p;
  long long sb, sh, sn;  // element strides of window, head, token
  __device__ __forceinline__ T* head(int b, int h) const {
    return p + (long long)b * sb + (long long)h * sh;
  }
  __device__ __forceinline__ size_t off(int r) const {
    return (size_t)r * sn;
  }
};

// The map layout of the slab path. Window b of the kernels' B*nW grid is
// (image, window row wi, window column wj) over (Hp/ws) x (Wp/ws) windows,
// image-major and row-major - the order of window_partition and of the
// shifted-window mask's rows, so the mask row stays b % nW. Its token r is
// pixel (wi*ws + r/ws, wj*ws + r%ws), and the head's 32 channels sit at
// column part*C + h*32 of that pixel: each row stays contiguous and, with
// 3C*esize and 32*esize multiples of 16, 16-byte aligned. r/ws is a 64-bit
// multiply by the host's ceil(2^32 / ws) and a shift, exact for
// r * ws < 2^32 (the entry points check N * ws), not a divide on the
// key-loading loop.
template <typename T>
struct MapRows {
  T* p;                    // map base + part*C
  long long s, rs, si, sh; // element strides of pixel, map row, image, head
  int ws, nww, nW;         // window edge; windows per window row, per image
  int wp;                  // pixels per map row (rs / s)
  unsigned long long inv_ws;
  __device__ __forceinline__ T* head(int b, int h) const {
    const int img = b / nW, w = b - img * nW;
    const int wi = w / nww, wj = w - wi * nww;
    return p + img * si + (long long)(wi * ws) * rs +
           (long long)(wj * ws) * s + (long long)h * sh;
  }
  __device__ __forceinline__ size_t off(int r) const {
    const int t = (int)(((unsigned long long)r * inv_ws) >> 32);
    return (size_t)t * rs + (size_t)(r - t * ws) * s;
  }
  // token r's pixel from the window's corner, off(r) = pix(r) * s (the
  // tensor-core kernels' tile tables; the entries check ws * Wp < 2^31)
  __device__ __forceinline__ int pix(int r) const {
    const int t = (int)(((unsigned long long)r * inv_ws) >> 32);
    return t * wp + (r - t * ws);
  }
};

// Host side: the strides a (B_, N, parts*C) tensor gives the head-split
// view of column block `part`, or a contiguous (B_, nH, N, dh) tensor.
template <typename T>
Rows<T> packed_rows(T* base, int part, int N, int C, int parts, int dh) {
  return {base + (long long)part * C, (long long)N * parts * C, dh,
          (long long)parts * C};
}
template <typename T>
Rows<T> contiguous_rows(T* base, int nH, int N, int dh) {
  return {base, (long long)nH * N * dh, (long long)N * dh, dh};
}

// Host side: column block `part` of a (B, Hp, Wp, parts*C) map, windows
// of ws x ws.
template <typename T>
MapRows<T> map_rows(T* base, int part, int C, int parts, int Hp, int Wp,
                    int ws, int dh) {
  MapRows<T> m;
  m.p = base + (long long)part * C;
  m.s = (long long)parts * C;
  m.rs = (long long)Wp * m.s;
  m.si = (long long)Hp * m.rs;
  m.sh = dh;
  m.ws = ws;
  m.nww = Wp / ws;
  m.nW = (Hp / ws) * m.nww;
  m.wp = Wp;
  m.inv_ws = ((1ull << 32) + ws - 1) / ws;
  return m;
}

// Rows are read with 16-byte vector loads: the base and every stride must
// keep each row 16-byte aligned.
template <typename T>
bool rows_aligned(const Rows<T>& r) {
  const long long e = sizeof(*r.p);
  return r.p != nullptr && reinterpret_cast<uintptr_t>(r.p) % 16 == 0 &&
         (r.sb * e) % 16 == 0 && (r.sh * e) % 16 == 0 && (r.sn * e) % 16 == 0;
}
template <typename T>
bool rows_aligned(const MapRows<T>& r) {
  const long long e = sizeof(*r.p);
  return r.p != nullptr && reinterpret_cast<uintptr_t>(r.p) % 16 == 0 &&
         (r.s * e) % 16 == 0 && (r.sh * e) % 16 == 0;
}

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[D]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    float4 v = __ldg(p4 + i);
    x[4 * i + 0] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&x)[D]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    uint4 v = __ldg(p4 + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
      x[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float ldf(const float* __restrict__ p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float ldf(const __nv_bfloat16* __restrict__ p,
                                     size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

template <bool FAST>
__device__ __forceinline__ float exp_(float x) {
  return FAST ? __expf(x) : expf(x);
}

// The packed kernels' body precision (the JAX package's `mxu` argument,
// MMDE_ATTN_MXU), a template parameter of their bodies:
//   MXU_FP32  s = scale * (q^ k^T), every product on fp32 operands;
//   MXU_FOLD  s = (q^ * scale) k^T: the scale folded into q^ before the
//             product (one multiply per row element, not per logit);
//   MXU_BF16  fold, and every product's operands rounded to bf16 where the
//             JAX body casts them (q^*scale and k^; p and v; g and v for
//             dp; p and g for dv; ds for dq and dk), fp32 accumulation;
//   MXU_FOLD_PV  fold, with only p and v rounded (a benchmark variant of
//             the forward, tools/bench_attention_variants.py's v4; never on
//             the model's path).
// The packed C entry points take the mode as a runtime argument (these
// codes) and switch to its instantiation (by_mode); the head-split and slab
// entry points take none (MXU_FP32). MXU_FOLD_PV is instantiated only in a
// build with MMDE_FOLD_PV=1 (the benchmark tool's own library).
constexpr int MXU_FP32 = 0;
constexpr int MXU_FOLD = 1;
constexpr int MXU_BF16 = 2;
constexpr int MXU_FOLD_PV = 3;
#ifndef MMDE_FOLD_PV
#define MMDE_FOLD_PV 0
#endif

// f(std::integral_constant<int, MXU>()) for the runtime mode code `mxu`;
// -1 for a code this build does not instantiate
template <class F>
int by_mode(int mxu, F&& f) {
  switch (mxu) {
    case MXU_FP32: return f(std::integral_constant<int, MXU_FP32>());
    case MXU_FOLD: return f(std::integral_constant<int, MXU_FOLD>());
    case MXU_BF16: return f(std::integral_constant<int, MXU_BF16>());
#if MMDE_FOLD_PV
    case MXU_FOLD_PV: return f(std::integral_constant<int, MXU_FOLD_PV>());
#endif
    default: return -1;
  }
}

// x rounded to the nearest bf16 (ties to even), kept as fp32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <bool ROUND>
__device__ __forceinline__ float rnd(float x) {
  return ROUND ? bf16r(x) : x;
}

// channels 4c..4c+3 of the token row at p, as fp32
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p,
                                      float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// token row r of the head whose token 0 is at `base`, in layout `rows`;
// zeros past the edge
template <typename T, class R, int D>
__device__ __forceinline__ void fetch_row(const T* __restrict__ base,
                                          const R& rows, int r, int N,
                                          float (&x)[D]) {
  if (r < N) {
    load_row(base + rows.off(r), x);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = 0.0f;
  }
}

// x <- x * rsqrt(sum(x^2) + 1e-12); returns the factor. The sum is one
// fused multiply-add chain over the channels in order: every kernel - the
// fp32-FMA bodies here and the tensor-core ones (window_attention_tc.cuh
// gathers a row into one lane for it) - takes the same chain, so that a
// forward and a backward that meet the same row in different kernels get
// the same norm to the bit (in the bf16 mode a last-bit difference can move
// a rounded operand by a bf16 ulp). The intrinsic keeps every compilation
// to the fused form.
template <int D>
__device__ __forceinline__ float normalise(float (&x)[D]) {
  float ss = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) ss = __fmaf_rn(x[d], x[d], ss);
  const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] *= inv;
  return inv;
}

// rows r0.. and columns c0.. of the (N, N) bias of one head as a fp32
// ROWS x COLS tile with row stride LD in shared memory, 0 past the edge;
// the NT threads of the block share the work
template <int ROWS, int COLS, int LD, int NT, typename TB>
__device__ __forceinline__ void stage_bias(float* __restrict__ sB,
                                           const TB* __restrict__ bias_h,
                                           int r0, int c0, int N, int tid) {
  for (int e = tid; e < ROWS * COLS; e += NT) {
    const int r = e / COLS, c = e - (e / COLS) * COLS;
    const int row = r0 + r, col = c0 + c;
    sB[r * LD + c] = (row < N && col < N)
                         ? ldf(bias_h, (size_t)row * N + col) : 0.0f;
  }
}

// sum over the 16 lanes (one half warp) that share a row of an N x N tile
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sum over the 8 lanes that share a row of an N x 32 tile
__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
