// Fused SwinV2 cosine window attention, backward in one pass, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel K4, mmde_tpu/ops/window_attention_packed.py::
// _bwd_body_v4 (driven by _pallas_backward_v4), the backward that
// MMDE_ATTN_GRID=bias_resident selects, on qkv as the Linear emits it,
// (B_, N, 3C); bf16 and fp32 qkv run window_attention_bwd_resident_tc.cu
// (the tensor cores), for which this body is the same-card comparison.
// Per (window b, head h), with q^ = q * rq, k^ = k * rk (rq, rk
// = rsqrt(sum(x^2) + 1e-12)) and scale = exp(min(logit_scale[h], ln 100)):
//
//   s  = scale * q^ k^T + bias[h] + mask[b % nW],  p = softmax(s)  (fp32)
//   dp = g v^T,  ds = p * (dp - rowsum(p * dp))
//   dq = rq * (dqn - q^ * rowsum(dqn * q^)),  dqn = scale * ds k^
//   dk^ += scale * ds^T q^,  dv += p^T g       (summed over query tiles)
//   dbias[h] += ds                             (summed over windows, fp32)
//   dlogit_scale[h] += sum(ds * scale * q^ k^T), 0 where the clamp binds
//
// The design point kept from the TPU kernel: one sweep computes p once per
// (window, head, query tile) and all five N x N x 32 products follow from
// it (K2 computes p in its dq pass and again in its dk/dv pass: eight
// products), and dbias is summed over windows inside the block, in fp32,
// without atomics, so it is the same bits on every run. The TPU block is
// not carried over: Mosaic can only accumulate across consecutive grid
// steps, so the TPU kernel dumps (nQ, B_, Np, C) dk/dv partials per query
// tile (some 2.5 GB at flagship stage 1 at a 16-row tile); blocks of a GPU
// grid run in any order and nothing carries over between them.
//
// One block of 128 threads owns (16 query rows, head h, a chunk of the
// windows) and keeps three 16 x N fp32 rows in shared memory: the logits
// (then p), dp (then ds) and the dbias accumulator - 186 KB at N = 900, one
// block per SM. Per window:
//   sweep A  64-key tiles of k^ and v stream through shared memory; s and
//            dp land in their rows, all N keys;
//   rows     exact row maximum (for every head: with the whole row in hand
//            this is the same function as the static shift of the TPU
//            kernel, without its underflow at the ln 100 clamp), p, delta,
//            ds, and dbias += ds, by 8 threads per row;
//   sweep B  64-key tiles of k^ again: dq accumulates in registers and is
//            complete at the end of the window; the tile's dk^ and dv
//            partials over the block's 16 rows are added by fp32 atomics
//            into a (B_, N, 2C) fp32 scratch, and the k^ . dk^ dots of the
//            normalise-VJP give the block's share of dlogit_scale (summed
//            in fp64 into per-block partials, as K2 does).
// The normalise-VJP of k and the casts to qkv's type run after the kernel,
// in PyTorch, as the TPU package runs them in XLA after its kernel.
//
// Why atomics for dk/dv and not a thread-block cluster over the query
// tiles: a cluster reduction in distributed shared memory needs every
// query tile of a window resident at once (57 blocks of 186 KB at N = 900,
// past any cluster), so it would need a second, smaller block shape; the
// atomics keep one simple block. Their cost is counted in PERF.md:
// B_ * nH * ceil(N / 16) * N * 64 adds, 1.3 G at flagship stage 1. dk and
// dv are therefore summed in whatever order the blocks arrive; dq, dbias
// and dlogit_scale are not.
//
// Parallelism: nH * ceil(N / 16) blocks (228 at flagship stage 1) are under
// two waves of 132 SMs, so the window sweep is cut into `splits` chunks
// (the caller picks them, ~4 blocks per SM); each chunk writes its own fp32
// dbias partial, and the caller sums them in a fixed order.
//
// What bounds it on an H100: the five products, 10 * B_ * nH * N^2 * 32
// flops, run as fp32 FMAs here, so the kernel is bound by operations, far
// above the bytes it must move (qkv, g, dqkv once; bias, mask once; dbias
// once). The fp32 atomics into the dk/dv scratch and the per-window
// re-reads of k and v (from L2) come on top.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

constexpr int DH = 32;        // head dim of every swin variant
constexpr int RQ = 16;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int NT = 128;       // threads per block
constexpr int R_LD = DH + 4;  // [row][d] tiles, padded for 128-bit access
constexpr float LN100 = 4.605170185988091f;

// row stride of the three 16 x N rows: whole key tiles plus 8, so that the
// four rows a warp's row pass reads sit on distinct banks
__host__ __device__ __forceinline__ int row_ld(int N) {
  return ((N + BK - 1) / BK) * BK + 8;
}

// dynamic shared memory, in floats: 4 doubles, the three rows, the k^ / v
// staging, q^ and g rows, rq
__host__ __forceinline__ long long smem_floats(int N) {
  return 8 + 3LL * RQ * row_ld(N) + 2 * DH * BK + 2 * RQ * R_LD + RQ;
}

template <typename T, typename TB, bool FASTEXP>
__global__ void __launch_bounds__(NT)
bwd_resident_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                    Rows<const T> g, const float* __restrict__ logit_scale,
                    const TB* __restrict__ bias, const TB* __restrict__ mask,
                    Rows<T> dq, float* __restrict__ dkv,
                    float* __restrict__ dbias_part,
                    double* __restrict__ dls_part, int B_, int N, int nW,
                    int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int LD = row_ld(N);
  const int NP = LD - 8;              // N rounded up to whole key tiles
  double* sRed = reinterpret_cast<double*>(smem);  // [4]
  float* sS = smem + 8;               // [RQ][LD] logits, then p
  float* sD = sS + RQ * LD;           // [RQ][LD] dp, then ds
  float* sAcc = sD + RQ * LD;         // [RQ][LD] dbias over the chunk
  float* sKt = sAcc + RQ * LD;        // [DH][BK] k^   (sweep A)
  float* sVt = sKt + DH * BK;         // [DH][BK] v    (sweep A)
  float* sK = sKt;                    // [BK][R_LD] k^ (sweep B, over them)
  float* sQ = sVt + DH * BK;          // [RQ][R_LD] q^
  float* sG = sQ + RQ * R_LD;         // [RQ][R_LD] g
  float* sRq = sG + RQ * R_LD;        // [RQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * RQ;
  const int h = blockIdx.y;
  const int nH = gridDim.y;
  const int C = nH * DH;
  const int b_end = min(B_, (int)(blockIdx.z + 1) * chunk);
  const TB* bias_h = bias + (size_t)h * N * N;
  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, LN100));

  // sweep A: rows ty*2..+1, keys tx*4..+3 of the 16 x 64 tile
  const int tx = tid & 15, ty = tid >> 4;
  // row passes and dq: row rr, lane l8 of its 8 (channels l8*4..+3 for dq)
  const int rr = tid >> 3, l8 = tid & 7;
  // sweep B's dk^ / dv partials: key kj of the tile, channels kc..kc+15
  const int kj = tid >> 1, kc = (tid & 1) * 16;

  for (int e = tid; e < RQ * LD; e += NT) sAcc[e] = 0.0f;
  double dls = 0.0;

  for (int b = blockIdx.z * chunk; b < b_end; ++b) {
    const TB* mask_w =
        mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
    __syncthreads();  // the previous window's reads of sQ, sG, sS, sD done
    if (tid < 2 * RQ) {
      float x[DH];
      const int j = tid & (RQ - 1);
      if (tid < RQ) {
        fetch_row(q.head(b, h), q, q0 + j, N, x);
        sRq[j] = normalise(x);
      } else {
        fetch_row(g.head(b, h), g, q0 + j, N, x);
      }
      float* dst = (tid < RQ ? sQ : sG) + j * R_LD;
#pragma unroll
      for (int d = 0; d < DH; d += 4)
        store4(dst + d, x[d], x[d + 1], x[d + 2], x[d + 3]);
    }

    // ---- sweep A: logits and dp, every key ----
    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();  // q^ / g rows written; the last tile's reads done
      {
        float x[DH];
        const int j = tid & (BK - 1);
        if (tid < BK) {
          fetch_row(k.head(b, h), k, k0 + j, N, x);
          normalise(x);
        } else {
          fetch_row(v.head(b, h), v, k0 + j, N, x);
        }
        float* dst = tid < BK ? sKt : sVt;
#pragma unroll
        for (int d = 0; d < DH; ++d) dst[d * BK + j] = x[d];
      }
      __syncthreads();
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&sKt[d * BK + tx * 4]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&sVt[d * BK + tx * 4]);
        const float kc4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vc4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float qv = sQ[(ty * 2 + i) * R_LD + d];
          const float gv = sG[(ty * 2 + i) * R_LD + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv, kc4[j], s[i][j]);
            dp[i][j] = fmaf(gv, vc4[j], dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lr = ty * 2 + i;
        const int row = q0 + lr;
        float lg[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx * 4 + j;
          if (row < N && col < N) {
            const size_t idx = (size_t)row * N + col;
            lg[j] = fmaf(s[i][j], scale, ldf(bias_h, idx));
            if (mask_w != nullptr) lg[j] += ldf(mask_w, idx);
          } else {
            lg[j] = -INFINITY;  // p = 0 there; dp is 0 (zero rows of v / g)
          }
        }
        store4(&sS[lr * LD + k0 + tx * 4], lg[0], lg[1], lg[2], lg[3]);
        store4(&sD[lr * LD + k0 + tx * 4], dp[i][0], dp[i][1], dp[i][2],
               dp[i][3]);
      }
    }
    __syncthreads();

    // ---- rows: p, delta, ds, dbias; 8 threads per row ----
    {
      const bool ok = q0 + rr < N;
      float* srow = sS + rr * LD;
      float* drow = sD + rr * LD;
      float* arow = sAcc + rr * LD;
      float m = -INFINITY;
      for (int c = l8; c < N; c += 8) m = fmaxf(m, srow[c]);
#pragma unroll
      for (int off = 4; off >= 1; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (!ok) m = 0.0f;  // a row past the edge is all -inf: p = 0
      float sum = 0.0f, edp = 0.0f;
      for (int c = l8; c < N; c += 8) {
        const float e = exp_<FASTEXP>(srow[c] - m);
        srow[c] = e;
        sum += e;
        edp = fmaf(e, drow[c], edp);
      }
#pragma unroll
      for (int off = 4; off >= 1; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        edp += __shfl_xor_sync(0xffffffffu, edp, off);
      }
      const float inv = ok ? 1.0f / sum : 0.0f;
      const float delta = edp * inv;
      for (int c = l8; c < NP; c += 8) {
        float p = 0.0f, ds = 0.0f;
        if (c < N) {
          p = srow[c] * inv;
          ds = p * (drow[c] - delta);
          arow[c] += ds;
        }
        srow[c] = p;
        drow[c] = ds;
      }
    }

    // ---- sweep B: dq (registers), dk^ / dv partials (atomics) ----
    float dqa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();  // row passes done / the last tile's reads of sK done
      if (tid < BK) {
        float x[DH];
        fetch_row(k.head(b, h), k, k0 + tid, N, x);
        normalise(x);
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          store4(&sK[tid * R_LD + d], x[d], x[d + 1], x[d + 2], x[d + 3]);
      }
      __syncthreads();
      {
        const float* drow = sD + rr * LD + k0;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) {
          const float dsv = drow[j];
          const float4 kk =
              *reinterpret_cast<const float4*>(&sK[j * R_LD + l8 * 4]);
          dqa[0] = fmaf(dsv, kk.x, dqa[0]);
          dqa[1] = fmaf(dsv, kk.y, dqa[1]);
          dqa[2] = fmaf(dsv, kk.z, dqa[2]);
          dqa[3] = fmaf(dsv, kk.w, dqa[3]);
        }
      }
      const int key = k0 + kj;
      float dk[16], dv[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) dk[c] = dv[c] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < RQ; ++i) {
        const float dsv = sD[i * LD + k0 + kj];
        const float pv = sS[i * LD + k0 + kj];
#pragma unroll
        for (int c = 0; c < 16; c += 4) {
          const float4 qq =
              *reinterpret_cast<const float4*>(&sQ[i * R_LD + kc + c]);
          const float4 gg =
              *reinterpret_cast<const float4*>(&sG[i * R_LD + kc + c]);
          dk[c + 0] = fmaf(dsv, qq.x, dk[c + 0]);
          dk[c + 1] = fmaf(dsv, qq.y, dk[c + 1]);
          dk[c + 2] = fmaf(dsv, qq.z, dk[c + 2]);
          dk[c + 3] = fmaf(dsv, qq.w, dk[c + 3]);
          dv[c + 0] = fmaf(pv, gg.x, dv[c + 0]);
          dv[c + 1] = fmaf(pv, gg.y, dv[c + 1]);
          dv[c + 2] = fmaf(pv, gg.z, dv[c + 2]);
          dv[c + 3] = fmaf(pv, gg.w, dv[c + 3]);
        }
      }
      if (key < N) {
        float* dst = dkv + ((size_t)b * N + key) * (2 * C) + h * DH + kc;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float dkn = scale * dk[c];
          atomicAdd(dst + c, dkn);
          atomicAdd(dst + C + c, dv[c]);
          dot = fmaf(sK[kj * R_LD + kc + c], dkn, dot);
        }
        dls += dot;
      }
    }

    // ---- dq = rq (dqn - q^ <dqn, q^>), dqn = scale * ds k^ ----
    {
      float dqn[4], qn[4];
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dqn[c] = scale * dqa[c];
        qn[c] = sQ[rr * R_LD + l8 * 4 + c];
        dot = fmaf(dqn[c], qn[c], dot);
      }
      dot = row_sum8(dot);
      const float rq = sRq[rr];
      if (q0 + rr < N)
        store4(dq.head(b, h) + dq.off(q0 + rr) + l8 * 4,
               rq * (dqn[0] - qn[0] * dot), rq * (dqn[1] - qn[1] * dot),
               rq * (dqn[2] - qn[2] * dot), rq * (dqn[3] - qn[3] * dot));
    }
  }

  // ---- the chunk's dbias rows and dlogit_scale share ----
  __syncthreads();
  float* dst = dbias_part + ((size_t)blockIdx.z * nH + h) * N * N;
  for (int r = 0; r < RQ && q0 + r < N; ++r)
    for (int c = tid; c < N; c += NT)
      dst[(size_t)(q0 + r) * N + c] = sAcc[r * LD + c];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    dls += __shfl_xor_sync(0xffffffffu, dls, off);
  if ((tid & 31) == 0) sRed[tid >> 5] = dls;
  __syncthreads();
  if (tid == 0) {
    const double tot = sRed[0] + sRed[1] + sRed[2] + sRed[3];
    dls_part[((size_t)blockIdx.z * gridDim.x + blockIdx.x) * nH + h] =
        ls < LN100 ? tot : 0.0;
  }
}

template <typename T, typename TB, bool FASTEXP>
int launch(const void* qkv, const void* ls, const void* bias,
           const void* mask, const void* g, void* dqkv, void* dkv,
           void* dbias_part, void* dls_part, int B_, int N, int nH, int nW,
           int splits, cudaStream_t stream) {
  const int C = nH * DH;
  const Rows<const T> rq = packed_rows((const T*)qkv, 0, N, C, 3, DH);
  const Rows<const T> rk = packed_rows((const T*)qkv, 1, N, C, 3, DH);
  const Rows<const T> rv = packed_rows((const T*)qkv, 2, N, C, 3, DH);
  const Rows<const T> rg = packed_rows((const T*)g, 0, N, C, 1, DH);
  const Rows<T> rdq = packed_rows((T*)dqkv, 0, N, C, 3, DH);
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(rg) || !rows_aligned(rdq))
    return -1;
  const long long bytes = smem_floats(N) * (long long)sizeof(float);
  if (bytes > (1ll << 30)) return -1;
  // windows too long for three 16 x N rows: the attribute is refused
  cudaError_t err = cudaFuncSetAttribute(
      bwd_resident_kernel<T, TB, FASTEXP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int chunk = (B_ + splits - 1) / splits;
  dim3 grid((N + RQ - 1) / RQ, nH, splits);
  bwd_resident_kernel<T, TB, FASTEXP><<<grid, NT, (int)bytes, stream>>>(
      rq, rk, rv, rg, (const float*)ls, (const TB*)bias, (const TB*)mask,
      rdq, (float*)dkv, (float*)dbias_part, (double*)dls_part, B_, N, nW,
      chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry. Pointers are device pointers. qkv (B_, N, 3C), g (B_, N, C)
// and dqkv (B_, N, 3C) share an element type (qkv_bf16: 0 = fp32); bias
// (nH, N, N) and mask (nW, N, N; may be null) share one (bias_bf16); fp32
// qkv requires fp32 bias. The kernel writes dq, the first C columns of
// dqkv, complete; adds scale * ds^T q^ (dk^, before the normalise-VJP) and
// p^T g (dv) into dkv (B_, N, 2C) fp32, which the caller zeroes first;
// writes one fp32 dbias partial per window chunk into dbias_part
// (splits, nH, N, N) and one fp64 dlogit_scale partial per block into
// dls_part (splits * ceil(N / 16), nH). The windows are cut into `splits`
// chunks of ceil(B_ / splits). Returns the first CUDA error of the launch,
// or -1 for arguments the kernel does not take. Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int mmde_window_attention_bwd_resident(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* g, void* dqkv, void* dkv,
    void* dbias_part, void* dls_part, int B_, int N, int C, int nH, int nW,
    int qkv_bf16, int bias_bf16, int splits, void* stream) {
  if (C != nH * DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535) return -1;
  if (splits <= 0 || splits > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16 && !bias_bf16)
    return launch<float, float, false>(qkv, logit_scale, bias, mask, g, dqkv,
                                       dkv, dbias_part, dls_part, B_, N, nH,
                                       nW, splits, s);
  if (qkv_bf16 && bias_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, true>(
        qkv, logit_scale, bias, mask, g, dqkv, dkv, dbias_part, dls_part, B_,
        N, nH, nW, splits, s);
  if (qkv_bf16 && !bias_bf16)
    return launch<__nv_bfloat16, float, true>(
        qkv, logit_scale, bias, mask, g, dqkv, dkv, dbias_part, dls_part, B_,
        N, nH, nW, splits, s);
  return -1;
}
