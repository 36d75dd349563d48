// Fused SwinV2 cosine window attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels, one kernel body here:
//   K1  mmde_tpu/ops/window_attention_packed.py::_fwd_body (driven by
//       _pallas_forward), on qkv as the Linear emits it;
//   K6  mmde_tpu/ops/window_attention_pallas.py::_kernel (driven by
//       _pallas_forward), on head-split q, k, v (B_, nH, N, Dh).
// Same function, re-tiled for a GPU:
//
//   per (window b, head h):
//     q^ = q * rsqrt(sum(q^2) + 1e-12),  k^ likewise            (fp32)
//     s  = exp(min(logit_scale[h], ln 100)) * q^ k^T
//          + bias[h] + mask[b % nW]
//     o  = softmax(s) v
//
// q, k, v and the output are `Rows` (window_attention_common.cuh): a base
// and (window, head, token) strides. The packed entry points read qkv
// exactly as the Linear layer emits it, (B_, N, 3C) with the head's 32
// channels at column  part*C + h*32, and write (B_, N, C); the head-split
// entry points take the strides of the caller's (B_, nH, N, 32) views (the
// model's permuted view of that same qkv: no copy) and write a contiguous
// (B_, nH, N, 32). On a GPU the TPU's head-split layout is only a matter of
// strides. bias is plain (nH, N, N), mask plain (nW, N, N); the ragged edge
// (N = 900 = 14*64 + 4, N = 225 = 3*64 + 33) is masked in the kernel, so
// nothing is padded or packed on the host.
//
// One thread block (128 threads) owns one (window, head, 64-query tile) and
// loops over 64-key blocks: K and V stream through shared memory, the
// 64x64 logits tile lives in registers and shared memory only, and the
// N x N logits never reach device memory.
//
// Softmax: the TPU kernel replaces the row maximum by the static per-head
// shift (scale + 16): logits are bounded above by it (cos <= 1, bias in
// (0, 16) for the 16*sigmoid continuous position bias, mask <= 0), so exp
// never overflows, the key loop keeps only a running row sum and never
// rescales the accumulator. That kernel also assumes every row holds a
// logit near the bound (its note argues cos(q_i, k_i) = 1, which does not
// hold: q and k are different projections). The row's largest logit can sit
// as low as -scale, a gap of 2*scale + 16 below the shift; at scale = 100
// every exp underflows in fp32 and the row sum is lost. So this kernel
// takes the static shift only for heads with scale <= 30 (gap <= 76, inside
// fp32's normal range, e^-87), and a running row maximum with rescaling
// (online softmax) for hotter heads, and for every head when the caller
// says its bias is not bounded that way (maxfree = 0). The choice is
// uniform over a block. The head-split entry points always pass maxfree = 0:
// the TPU kernel they replace takes the row maximum for every head.
//
// What bounds it on an H100 at the flagship shapes (Dh = 32, N = 900):
// bytes are small - qkv read once and out written once (13 MB fp32 at
// stage 1) plus bias once from device memory and then from L2 (52 MB fp32 /
// 26 MB bf16 at stage 3 against a 50 MB L2) - while the work is
// 4*B_*nH*N^2*Dh flops and B_*nH*N^2 exps. For fp32 inputs that makes the
// kernel bound by operations (fp32 FMA rate); for bf16 inputs the same work
// at the tensor-core rate would be bound by those few bytes. Both products
// run here as fp32 FMAs on register tiles (8x4 logits and 4x4 outputs per
// thread), which keeps fp32 inputs in true fp32; bf16 inputs are widened on
// load and take the same path, far from their bound. Tensor-core products
// (mma.sync / wgmma for bf16) are the known next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

constexpr int DH = 32;        // head dim of every swin variant
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per loop step
constexpr int NT = 128;       // threads per block
constexpr int V_LD = DH + 4;  // padded rows: conflict-free 128-bit stores
constexpr int P_LD = BK + 4;
constexpr float LN100 = 4.605170185988091f;
constexpr float MAXFREE_MAX_SCALE = 30.0f;

// T: q / k / v / out element type; TB: bias / mask element type.
template <typename T, typename TB, bool FASTEXP>
__global__ void __launch_bounds__(NT)
window_attention_fwd_kernel(Rows<const T> q, Rows<const T> k,
                            Rows<const T> v,
                            const float* __restrict__ logit_scale,
                            const TB* __restrict__ bias,
                            const TB* __restrict__ mask, Rows<T> out,
                            float* __restrict__ lse, int N, int nW,
                            int maxfree) {
  __shared__ __align__(16) float sQt[DH * BQ];   // q^ transposed [d][row]
  __shared__ __align__(16) float sKt[DH * BK];   // k^ transposed [d][key]
  __shared__ __align__(16) float sV[BK * V_LD];  // v [key][d]
  __shared__ __align__(16) float sP[BQ * P_LD];  // p [row][key]
  __shared__ float sAlpha[BQ];
  __shared__ float sL[BQ];
  __shared__ float sM[BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q_bh = q.head(b, h);
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w =
      mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;

  const float scale = expf(fminf(logit_scale[h], LN100));
  const float shift = scale + 16.0f;
  const bool mf = maxfree != 0 && scale <= MAXFREE_MAX_SCALE;

  // logits phase: thread (ty, tx) owns rows ty*8..+7, keys tx*4..+3
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // output phase: thread (py, px) owns rows py + 16*r, channels px*4..+3
  const int px = tid & 7;
  const int py = tid >> 3;

  if (tid < BQ) {
    float x[DH];
    const int r = q0 + tid;
    if (r < N) {
      load_row(q_bh + (size_t)r * q.sn, x);
      float ss = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) ss += x[d] * x[d];
      const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
      for (int d = 0; d < DH; ++d) x[d] *= inv;
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) x[d] = 0.0f;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) sQt[d * BQ + tid] = x[d];
  }

  float m_run[8];
  float l_part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_part[i] = 0.0f;
  }
  float o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.0f;

  // threads 0..63 load key rows, 64..127 value rows
  const bool is_k = tid < BK;
  const T* kv_bh = is_k ? k.head(b, h) : v.head(b, h);
  const size_t kv_ld = is_k ? k.sn : v.sn;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous step's reads of sKt / sV / sP are done
    {
      float x[DH];
      const int j = tid & (BK - 1);
      const int r = k0 + j;
      if (r < N) {
        load_row(kv_bh + (size_t)r * kv_ld, x);
      } else {
#pragma unroll
        for (int d = 0; d < DH; ++d) x[d] = 0.0f;
      }
      if (is_k) {
        float ss = 0.0f;
#pragma unroll
        for (int d = 0; d < DH; ++d) ss += x[d] * x[d];
        const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
        for (int d = 0; d < DH; ++d) sKt[d * BK + j] = x[d] * inv;
      } else {
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          store4(&sV[j * V_LD + d], x[d], x[d + 1], x[d + 2], x[d + 3]);
      }
    }
    __syncthreads();

    // ---- logits tile: s = q^ k^T over Dh ----
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * BQ + ty * 8]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&sQt[d * BQ + ty * 8 + 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&sKt[d * BK + tx * 4]);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // ---- scale + bias + mask, exp, row sums ----
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty * 8 + i;
      const bool row_ok = row < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float logit;
        if (col >= N) {
          logit = -INFINITY;
        } else if (!row_ok) {
          logit = 0.0f;  // rows past the edge: finite filler, never stored
        } else {
          const size_t idx = (size_t)row * N + col;
          logit = fmaf(s[i][j], scale, ldf(bias_h, idx));
          if (mask_w != nullptr) logit += ldf(mask_w, idx);
        }
        s[i][j] = logit;
      }
      float p[4];
      if (mf) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = exp_<FASTEXP>(s[i][j] - shift);  // exp(-inf) = 0 past the edge
          sum += p[j];
        }
        l_part[i] += sum;
      } else {
        float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        // the 16 threads of one row share a half warp
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_run[i], tmax);
        const float alpha = exp_<FASTEXP>(m_run[i] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = exp_<FASTEXP>(s[i][j] - m_new);
          sum += p[j];
        }
        l_part[i] = l_part[i] * alpha + sum;
        m_run[i] = m_new;
        if (tx == 0) sAlpha[ty * 8 + i] = alpha;
      }
      store4(&sP[(ty * 8 + i) * P_LD + tx * 4], p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // ---- o += p v ----
    if (!mf) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = sAlpha[py + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] *= a;
      }
    }
#pragma unroll 4
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t =
            *reinterpret_cast<const float4*>(&sP[(py + 16 * r) * P_LD + j0]);
        pr[r][0] = t.x;
        pr[r][1] = t.y;
        pr[r][2] = t.z;
        pr[r][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[(j0 + jj) * V_LD + px * 4]);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            o[r][c] = fmaf(pr[r][jj], vc[c], o[r][c]);
      }
    }
  }

  // ---- row denominators: sum the 16 partial sums of each row ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_part[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tx == 0) {
      sL[ty * 8 + i] = l;
      sM[ty * 8 + i] = mf ? shift : m_run[i];
    }
  }
  __syncthreads();

  // the statistic the backward kernel rebuilds p from, for either softmax
  // form: p = exp(s - lse), lse = shift-or-maximum + log(row sum)
  if (lse != nullptr && tid < BQ && q0 + tid < N)
    lse[((size_t)b * gridDim.y + h) * N + q0 + tid] = sM[tid] + logf(sL[tid]);

  T* out_b = out.head(b, h) + px * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = py + 16 * r;
    const int row = q0 + lr;
    if (row < N) {
      const float den = sL[lr];  // > 0: see the note on the softmax
      store4(out_b + (size_t)row * out.sn, o[r][0] / den, o[r][1] / den,
             o[r][2] / den, o[r][3] / den);
    }
  }
}

template <typename T, typename TB, bool FASTEXP>
cudaError_t launch(const Rows<const T>& q, const Rows<const T>& k,
                   const Rows<const T>& v, const void* ls, const void* bias,
                   const void* mask, const Rows<T>& out, void* lse, int B_,
                   int N, int nH, int nW, int maxfree, cudaStream_t stream) {
  dim3 grid((N + BQ - 1) / BQ, nH, B_);
  window_attention_fwd_kernel<T, TB, FASTEXP><<<grid, NT, 0, stream>>>(
      q, k, v, (const float*)ls, (const TB*)bias, (const TB*)mask, out,
      (float*)lse, N, nW, maxfree);
  return cudaGetLastError();
}

// The operands' layout: `packed` = qkv (B_, N, 3C) and out (B_, N, C);
// otherwise q, k, v with the nine host strides `st` (q, k, v: window, head,
// token) and a contiguous out (B_, nH, N, DH).
template <typename T, typename TB, bool FASTEXP>
int launch_layout(bool packed, const void* q, const void* k, const void* v,
                  const long long* st, const void* ls, const void* bias,
                  const void* mask, void* out, void* lse, int B_, int N,
                  int nH, int nW, int maxfree, cudaStream_t stream) {
  const int C = nH * DH;
  Rows<const T> rq, rk, rv;
  Rows<T> ro;
  if (packed) {
    rq = packed_rows((const T*)q, 0, N, C, 3, DH);
    rk = packed_rows((const T*)q, 1, N, C, 3, DH);
    rv = packed_rows((const T*)q, 2, N, C, 3, DH);
    ro = packed_rows((T*)out, 0, N, C, 1, DH);
  } else {
    rq = {(const T*)q, st[0], st[1], st[2]};
    rk = {(const T*)k, st[3], st[4], st[5]};
    rv = {(const T*)v, st[6], st[7], st[8]};
    ro = contiguous_rows((T*)out, nH, N, DH);
  }
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(ro))
    return -1;
  return (int)launch<T, TB, FASTEXP>(rq, rk, rv, ls, bias, mask, ro, lse, B_,
                                     N, nH, nW, maxfree, stream);
}

int dispatch(bool packed, const void* q, const void* k, const void* v,
             const long long* st, const void* ls, const void* bias,
             const void* mask, void* out, void* lse, int B_, int N, int nH,
             int nW, int qkv_bf16, int bias_bf16, int maxfree, void* stream) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || B_ > 65535 || nH > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16 && !bias_bf16)
    return launch_layout<float, float, false>(packed, q, k, v, st, ls, bias,
                                              mask, out, lse, B_, N, nH, nW,
                                              maxfree, s);
  if (qkv_bf16 && bias_bf16)
    return launch_layout<__nv_bfloat16, __nv_bfloat16, true>(
        packed, q, k, v, st, ls, bias, mask, out, lse, B_, N, nH, nW,
        maxfree, s);
  if (qkv_bf16 && !bias_bf16)
    return launch_layout<__nv_bfloat16, float, true>(
        packed, q, k, v, st, ls, bias, mask, out, lse, B_, N, nH, nW,
        maxfree, s);
  return -1;
}

}  // namespace

// Plain C entries. Pointers are device pointers; `mask` may be null (then nW
// is ignored). qkv_bf16 / bias_bf16 select the element types (0 = fp32);
// fp32 qkv requires fp32 bias. `lse` (B_, nH, N) fp32, when not null,
// receives each row's log-sum-exp for the backward kernel. All return
// cudaGetLastError() of the launch, or -1 for an argument combination the
// kernel does not take. They launch on `stream`, do not synchronise and
// allocate nothing.
extern "C" int mmde_window_attention_fwd_stats(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int maxfree, void* stream) {
  if (C != nH * DH) return -1;
  return dispatch(true, qkv, nullptr, nullptr, nullptr, logit_scale, bias,
                  mask, out, lse, B_, N, nH, nW, qkv_bf16, bias_bf16, maxfree,
                  stream);
}

// The serving entry: the forward alone, no statistics.
extern "C" int mmde_window_attention_fwd(const void* qkv,
                                         const void* logit_scale,
                                         const void* bias, const void* mask,
                                         void* out, int B_, int N, int C,
                                         int nH, int nW, int qkv_bf16,
                                         int bias_bf16, int maxfree,
                                         void* stream) {
  return mmde_window_attention_fwd_stats(qkv, logit_scale, bias, mask, out,
                                         nullptr, B_, N, C, nH, nW, qkv_bf16,
                                         bias_bf16, maxfree, stream);
}

// Head-split entries (K6's counterpart): q, k, v (B_, nH, N, 32) of one
// element type, each at its own base with the strides `strides` gives, a
// host array of nine: q, k, v, each (window, head, token), in elements; the
// channel axis is unit-stride and every row 16-byte aligned. out is a
// contiguous (B_, nH, N, 32) of the same type. Row maximum for every head.
extern "C" int mmde_window_attention_headsplit_fwd_stats(
    const void* q, const void* k, const void* v, const void* strides,
    const void* logit_scale, const void* bias, const void* mask, void* out,
    void* lse, int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
    void* stream) {
  if (strides == nullptr) return -1;
  return dispatch(false, q, k, v, (const long long*)strides, logit_scale,
                  bias, mask, out, lse, B_, N, nH, nW, qkv_bf16, bias_bf16,
                  0, stream);
}

extern "C" int mmde_window_attention_headsplit_fwd(
    const void* q, const void* k, const void* v, const void* strides,
    const void* logit_scale, const void* bias, const void* mask, void* out,
    int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
    void* stream) {
  return mmde_window_attention_headsplit_fwd_stats(
      q, k, v, strides, logit_scale, bias, mask, out, nullptr, B_, N, nH, nW,
      qkv_bf16, bias_bf16, stream);
}
