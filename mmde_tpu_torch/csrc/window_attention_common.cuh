// Device helpers shared by the window-attention kernels
// (window_attention_fwd.cu, window_attention_bwd.cu).
//
// Every operand of shape (window b, head h, token r, channel d) is handed to
// a kernel as `Rows`: a base pointer and three element strides, with the
// channel axis unit-stride. The packed entry points describe q, k and v as
// the three column blocks of the qkv Linear's (B_, N, 3C) output
// (strides N*3C, 32, 3C), the head-split entry points pass the strides of
// whatever (B_, nH, N, 32) view the caller holds - the permuted view of that
// same qkv tensor, or a contiguous one. One kernel body serves both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Rows {
  T* p;
  long long sb, sh, sn;  // element strides of window, head, token
  __device__ __forceinline__ T* head(int b, int h) const {
    return p + (long long)b * sb + (long long)h * sh;
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

// Rows are read with 16-byte vector loads: the base and every stride must
// keep each row 16-byte aligned.
template <typename T>
bool rows_aligned(const Rows<T>& r) {
  const long long e = sizeof(*r.p);
  return r.p != nullptr && reinterpret_cast<uintptr_t>(r.p) % 16 == 0 &&
         (r.sb * e) % 16 == 0 && (r.sh * e) % 16 == 0 && (r.sn * e) % 16 == 0;
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

}  // namespace
