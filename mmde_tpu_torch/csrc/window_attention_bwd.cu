// Fused SwinV2 cosine window attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels mmde_tpu/ops/window_attention_packed.py::_bwd_body
// (K2, driven by _pallas_backward) and, with dbias_mode = 2, its dbias-only
// pass ::_dbias_body (K3, driven by _pallas_dbias), on qkv as the Linear
// emits it; and mmde_tpu/ops/window_attention_pallas.py::_bwd_kernel (K7,
// driven by _pallas_backward) on head-split q, k, v (B_, nH, N, Dh): the
// operands are `Rows` (window_attention_common.cuh), base + (window, head,
// token) strides, so one set of kernels serves both layouts. Same function,
// re-derived for a GPU. Per (window b, head h), with
//
//   q^ = q * rq, rq = rsqrt(sum(q^2) + 1e-12),   k^ = k * rk likewise
//   scale = exp(min(logit_scale[h], ln 100))
//   sc = scale * q^ k^T,  s = sc + bias[h] + mask[b % nW]
//   p  = exp(s - lse)           lse: the forward's row log-sum-exp
//   g  = incoming gradient of the output, per (window, head) N x 32
//
// it computes
//
//   dv  = p^T g
//   dp  = g v^T,  delta = rowsum(p * dp),  ds = p * (dp - delta)
//   dq  = rq * (dqn - q^ * rowsum(dqn * q^)),  dqn = scale * ds k^
//   dk  = rk * (dkn - k^ * rowsum(dkn * k^)),  dkn = scale * ds^T q^
//   dlogit_scale[h] = sum_b sum(ds * sc) * [logit_scale[h] < ln 100]
//   dbias[h] = sum_b ds
//
// The forward kernel (window_attention_fwd.cu) hands over one fp32 number
// per (window, head, row), lse = m + log(sum exp(s - m)), where m is
// whichever shift that head's softmax used there (the static scale + 16, or
// the running row maximum for hot heads). exp(s - lse) is that kernel's p
// for either form, so the backward needs no per-head case.
//
// The TPU kernel walks its grid in order, carries dk/dv from one query tile
// to the next in the output block and dumps ds per window because Mosaic
// cannot accumulate otherwise. Blocks of a GPU grid run in any order, so the
// sums are re-cut into three __global__ functions:
//
//   bwd_dq_kernel    one block per (window, head, 64-query tile), loop over
//                    64-key tiles. delta needs the whole row before ds is
//                    known; instead of a second sweep the block accumulates
//                    A = (p*dp) k^ and B = p k^ and forms
//                    ds k^ = A - delta * B at the end (one extra product, no
//                    second pass, delta exact in fp32). Writes dq and delta.
//   bwd_dkv_kernel   one block per (window, head, 64-key tile), loop over
//                    64-query tiles with delta and lse read back: the sum
//                    over query tiles stays inside the block, in fp32
//                    registers, rounded once on the way out (the TPU kernel
//                    rounds dk/dv to qkv's type between query tiles). The
//                    normalise-VJP of k is applied after that sum. Its dot
//                    k^_j . dkn_j is sum_i ds_ij sc_ij, so the block's
//                    share of dlogit_scale is the sum of those dots over its
//                    keys, at no cost in the loop; summed in fp64 into a
//                    partials buffer that the caller sums: no atomics,
//                    reproducible. (A per-row sum(p*dp*sc) -
//                    delta*sum(p*sc) in the dq pass, in fp32, cancels and
//                    lost ~1e-3 of a hot head's dlogit_scale; a sum of
//                    ds * sc inside the loop cost this pass 3-5 %.)
//                    With dbias_mode = 1 it also adds its ds tile into
//                    dbias (nH, N, N) fp32 with atomics (sum over windows in
//                    whatever order the blocks arrive).
//   bwd_dbias_kernel dbias_mode = 2: one block per (head, query tile, key
//                    tile), windows innermost, ds accumulated in registers,
//                    written once. No atomics, reproducible; costs two more
//                    N x N x 32 products.
//
// K7's TPU kernel instead dumps ds per window in the input type and sums it
// in XLA; here K7' takes K2's default, fp32 atomics from the dk/dv pass, so
// its dbias is summed once in fp32 but is not bit-reproducible either.
//
// Ragged edge (N = 900 = 14*64 + 4, N = 225 = 3*64 + 33): rows and keys
// past N are loaded as zeros and their p is forced to 0, so they add nothing
// to any sum and are never stored.
//
// What bounds it on an H100 (Dh = 32, N = 900): bytes are few - qkv, g and
// dqkv once each, bias and mask once, lse/delta, dbias once - against
// 2 * 5 * B_*nH*N^2*Dh flops for the five products the function needs. This
// version spends eight (nine to ten with dbias) N x N x 32 products, all as
// fp32 FMAs on register tiles (8x4 per thread for the N x N tiles, 4x4 for
// the N x 32 outputs), which keeps fp32 inputs in true fp32 and leaves bf16
// inputs far from their tensor-core bound. Tensor-core products and a
// one-pass dq/dk/dv are the known next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

constexpr int DH = 32;        // head dim of every swin variant
constexpr int BT = 64;        // tile edge: query rows and keys per tile
constexpr int NT = 128;       // threads per block
constexpr int R_LD = DH + 4;  // [row][d] tiles, padded for 128-bit access
constexpr int P_LD = BT + 4;  // [row][key] / [key][row] tiles
constexpr float LN100 = 4.605170185988091f;

constexpr int DQ_SMEM_FLOATS =
    4 * DH * BT + BT * R_LD + 2 * BT * P_LD + 3 * BT;
constexpr int DKV_SMEM_FLOATS =
    4 * DH * BT + 2 * BT * R_LD + 2 * BT * P_LD + 3 * BT + 8;

// row r of a (rows, ld) array whose first wanted column is at `base`; zeros
// past the edge
template <typename T>
__device__ __forceinline__ void fetch_row(const T* __restrict__ base,
                                          size_t ld, int r, int N,
                                          float (&x)[DH]) {
  if (r < N) {
    load_row(base + (size_t)r * ld, x);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) x[d] = 0.0f;
  }
}

// x <- x * rsqrt(sum(x^2) + 1e-12); returns the factor
__device__ __forceinline__ float normalise(float (&x)[DH]) {
  float ss = 0.0f;
#pragma unroll
  for (int d = 0; d < DH; ++d) ss += x[d] * x[d];
  const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
  for (int d = 0; d < DH; ++d) x[d] *= inv;
  return inv;
}

// tile stored transposed, [d][j]
__device__ __forceinline__ void put_t(float* st, int j,
                                      const float (&x)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) st[d * BT + j] = x[d];
}

// tile stored row-major, [j][d] with padded rows
__device__ __forceinline__ void put_r(float* sr, int j,
                                      const float (&x)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; d += 4)
    *reinterpret_cast<float4*>(&sr[j * R_LD + d]) =
        make_float4(x[d], x[d + 1], x[d + 2], x[d + 3]);
}

// acc[i][j] = sum_d A[d][ty*8 + i] * B[d][tx*4 + j]
__device__ __forceinline__ void tile_dot(const float* __restrict__ sAt,
                                         const float* __restrict__ sBt,
                                         int ty, int tx, float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(&sAt[d * BT + ty * 8]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&sAt[d * BT + ty * 8 + 4]);
    const float4 bb = *reinterpret_cast<const float4*>(&sBt[d * BT + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// in: s = q^ k^T of the tile. out: s = sc = scale * q^ k^T and
// p = exp(sc + bias + mask - lse); both 0 past the edge.
template <typename TB, bool FASTEXP>
__device__ __forceinline__ void probabilities(
    float (&s)[8][4], float (&p)[8][4], const TB* __restrict__ bias_h,
    const TB* __restrict__ mask_w, const float* __restrict__ sLse,
    float scale, int q0, int k0, int ty, int tx, int N) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    const float lse = sLse[ty * 8 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (row < N && col < N) {
        const size_t idx = (size_t)row * N + col;
        const float sc = s[i][j] * scale;
        float v = sc + ldf(bias_h, idx);
        if (mask_w != nullptr) v += ldf(mask_w, idx);
        s[i][j] = sc;
        p[i][j] = exp_<FASTEXP>(v - lse);
      } else {
        s[i][j] = 0.0f;
        p[i][j] = 0.0f;
      }
    }
  }
}

// sum over the 16 lanes (one half warp) that share a row of the N x N tile
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sum over the 8 lanes that share a row of an N x 32 output tile
__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// dq, delta, dlogit_scale partials: one block per (query tile, head, window)
// ---------------------------------------------------------------------------
template <typename T, typename TB, bool FASTEXP>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
              Rows<const T> g, const float* __restrict__ logit_scale,
              const TB* __restrict__ bias, const TB* __restrict__ mask,
              const float* __restrict__ lse, Rows<T> dq,
              float* __restrict__ delta, int N, int nW) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;               // [DH][BT] q^
  float* sGt = sQt + DH * BT;      // [DH][BT] g
  float* sKt = sGt + DH * BT;      // [DH][BT] k^
  float* sVt = sKt + DH * BT;      // [DH][BT] v
  float* sK = sVt + DH * BT;       // [BT][R_LD] k^
  float* sP = sK + BT * R_LD;      // [BT][P_LD] p
  float* sW = sP + BT * P_LD;      // [BT][P_LD] p * dp
  float* sRq = sW + BT * P_LD;     // [BT]
  float* sLse = sRq + BT;          // [BT]
  float* sDelta = sLse + BT;       // [BT]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nH = gridDim.y;
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w =
      mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
  const size_t stat0 = ((size_t)b * nH + h) * N;

  const float scale = expf(fminf(logit_scale[h], LN100));

  const int tx = tid & 15;  // N x N tiles: rows ty*8..+7, keys tx*4..+3
  const int ty = tid >> 4;
  const int px = tid & 7;   // N x 32 tiles: rows py + 16*r, channels px*4..+3
  const int py = tid >> 3;

  {
    float x[DH];
    const int j = tid & (BT - 1);
    const int r = q0 + j;
    if (tid < BT) {
      fetch_row(q.head(b, h), q.sn, r, N, x);
      sRq[j] = normalise(x);
      put_t(sQt, j, x);
      sLse[j] = r < N ? lse[stat0 + r] : 0.0f;
    } else {
      fetch_row(g.head(b, h), g.sn, r, N, x);
      put_t(sGt, j, x);
    }
  }

  // threads 0..63 load key rows, 64..127 value rows
  const T* kv_bh = tid < BT ? k.head(b, h) : v.head(b, h);
  const size_t kv_ld = tid < BT ? k.sn : v.sn;

  float d_part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d_part[i] = 0.0f;
  float accA[4][4], accB[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) accA[r][c] = accB[r][c] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += BT) {
    __syncthreads();  // the previous step's reads of the key tiles are done
    {
      float x[DH];
      const int j = tid & (BT - 1);
      const int r = k0 + j;
      fetch_row(kv_bh, kv_ld, r, N, x);
      if (tid < BT) {
        normalise(x);
        put_t(sKt, j, x);
        put_r(sK, j, x);
      } else {
        put_t(sVt, j, x);
      }
    }
    __syncthreads();

    float s[8][4], p[8][4], dp[8][4];
    tile_dot(sQt, sKt, ty, tx, s);
    probabilities<TB, FASTEXP>(s, p, bias_h, mask_w, sLse, scale, q0, k0, ty,
                               tx, N);
    tile_dot(sGt, sVt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = p[i][j] * dp[i][j];
        d_part[i] += w[j];
      }
      store4(&sP[(ty * 8 + i) * P_LD + tx * 4], p[i][0], p[i][1], p[i][2],
             p[i][3]);
      store4(&sW[(ty * 8 + i) * P_LD + tx * 4], w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    // A += (p*dp) k^,  B += p k^
#pragma unroll 2
    for (int j0 = 0; j0 < BT; j0 += 4) {
      float pr[4][4], wr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t =
            *reinterpret_cast<const float4*>(&sP[(py + 16 * r) * P_LD + j0]);
        const float4 u =
            *reinterpret_cast<const float4*>(&sW[(py + 16 * r) * P_LD + j0]);
        pr[r][0] = t.x; pr[r][1] = t.y; pr[r][2] = t.z; pr[r][3] = t.w;
        wr[r][0] = u.x; wr[r][1] = u.y; wr[r][2] = u.z; wr[r][3] = u.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&sK[(j0 + jj) * R_LD + px * 4]);
        const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accA[r][c] = fmaf(wr[r][jj], kc[c], accA[r][c]);
            accB[r][c] = fmaf(pr[r][jj], kc[c], accB[r][c]);
          }
      }
    }
  }

  // delta per row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = row_sum16(d_part[i]);
    if (tx == 0) sDelta[ty * 8 + i] = d;
  }
  __syncthreads();

  if (tid < BT && q0 + tid < N) delta[stat0 + q0 + tid] = sDelta[tid];

  T* dq_b = dq.head(b, h) + px * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = py + 16 * r;
    const int row = q0 + lr;
    const float dl = sDelta[lr];
    float dqn[4], qn[4];
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dqn[c] = scale * (accA[r][c] - dl * accB[r][c]);
      qn[c] = sQt[(px * 4 + c) * BT + lr];
      dot = fmaf(dqn[c], qn[c], dot);
    }
    dot = row_sum8(dot);
    const float rq = sRq[lr];
    if (row < N)
      store4(dq_b + (size_t)row * dq.sn, rq * (dqn[0] - qn[0] * dot),
             rq * (dqn[1] - qn[1] * dot), rq * (dqn[2] - qn[2] * dot),
             rq * (dqn[3] - qn[3] * dot));
  }
}

// ---------------------------------------------------------------------------
// dk, dv (and dbias by atomics): one block per (key tile, head, window)
// ---------------------------------------------------------------------------
template <typename T, typename TB, bool FASTEXP>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
               Rows<const T> g, const float* __restrict__ logit_scale,
               const TB* __restrict__ bias, const TB* __restrict__ mask,
               const float* __restrict__ lse, const float* __restrict__ delta,
               Rows<T> dk, Rows<T> dv, double* __restrict__ dls_part,
               float* __restrict__ dbias, int N, int nW) {
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;               // [DH][BT] k^
  float* sVt = sKt + DH * BT;      // [DH][BT] v
  float* sQt = sVt + DH * BT;      // [DH][BT] q^
  float* sGt = sQt + DH * BT;      // [DH][BT] g
  float* sQ = sGt + DH * BT;       // [BT][R_LD] q^
  float* sG = sQ + BT * R_LD;      // [BT][R_LD] g
  float* sPt = sG + BT * R_LD;     // [BT keys][P_LD rows] p
  float* sDSt = sPt + BT * P_LD;   // [BT keys][P_LD rows] ds
  float* sRk = sDSt + BT * P_LD;   // [BT]
  float* sLse = sRk + BT;          // [BT]
  float* sDelta = sLse + BT;       // [BT]
  // [4] doubles; the offset (21696 floats) keeps them 8-byte aligned
  double* sRed = reinterpret_cast<double*>(sDelta + BT);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nH = gridDim.y;
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w =
      mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
  float* dbias_h = dbias != nullptr ? dbias + (size_t)h * N * N : nullptr;
  const size_t stat0 = ((size_t)b * nH + h) * N;

  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, LN100));

  const int tx = tid & 15;  // N x N tiles: query rows ty*8..+7, keys tx*4..+3
  const int ty = tid >> 4;
  const int px = tid & 7;   // N x 32 tiles: keys py + 16*r, channels px*4..+3
  const int py = tid >> 3;

  {
    float x[DH];
    const int j = tid & (BT - 1);
    const int r = k0 + j;
    if (tid < BT) {
      fetch_row(k.head(b, h), k.sn, r, N, x);
      sRk[j] = normalise(x);
      put_t(sKt, j, x);
    } else {
      fetch_row(v.head(b, h), v.sn, r, N, x);
      put_t(sVt, j, x);
    }
  }

  // threads 0..63 load query rows, 64..127 rows of g
  const T* qg_bh = tid < BT ? q.head(b, h) : g.head(b, h);
  const size_t qg_ld = tid < BT ? q.sn : g.sn;

  float accV[4][4], accK[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) accV[r][c] = accK[r][c] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += BT) {
    __syncthreads();  // the previous step's reads of the query tiles are done
    {
      float x[DH];
      const int j = tid & (BT - 1);
      const int r = q0 + j;
      fetch_row(qg_bh, qg_ld, r, N, x);
      if (tid < BT) {
        normalise(x);
        put_t(sQt, j, x);
        put_r(sQ, j, x);
        sLse[j] = r < N ? lse[stat0 + r] : 0.0f;
      } else {
        put_t(sGt, j, x);
        put_r(sG, j, x);
        sDelta[j] = r < N ? delta[stat0 + r] : 0.0f;
      }
    }
    __syncthreads();

    float s[8][4], p[8][4], ds[8][4];
    tile_dot(sQt, sKt, ty, tx, s);
    probabilities<TB, FASTEXP>(s, p, bias_h, mask_w, sLse, scale, q0, k0, ty,
                               tx, N);
    tile_dot(sGt, sVt, ty, tx, ds);  // dp for now
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dl = sDelta[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[i][j] = p[i][j] * (ds[i][j] - dl);
    }
    if (dbias_h != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = q0 + ty * 8 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx * 4 + j;
          if (row < N && col < N)
            atomicAdd(dbias_h + (size_t)row * N + col, ds[i][j]);
        }
      }
    }
    // transposed, [key][row]: the next products sum over query rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* pp = &sPt[(tx * 4 + j) * P_LD + ty * 8];
      float* dd = &sDSt[(tx * 4 + j) * P_LD + ty * 8];
      store4(pp, p[0][j], p[1][j], p[2][j], p[3][j]);
      store4(pp + 4, p[4][j], p[5][j], p[6][j], p[7][j]);
      store4(dd, ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
      store4(dd + 4, ds[4][j], ds[5][j], ds[6][j], ds[7][j]);
    }
    __syncthreads();

    // dv += p^T g,  dkn += ds^T q^
#pragma unroll 2
    for (int i0 = 0; i0 < BT; i0 += 4) {
      float pr[4][4], dr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t =
            *reinterpret_cast<const float4*>(&sPt[(py + 16 * r) * P_LD + i0]);
        const float4 u = *reinterpret_cast<const float4*>(
            &sDSt[(py + 16 * r) * P_LD + i0]);
        pr[r][0] = t.x; pr[r][1] = t.y; pr[r][2] = t.z; pr[r][3] = t.w;
        dr[r][0] = u.x; dr[r][1] = u.y; dr[r][2] = u.z; dr[r][3] = u.w;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 gg =
            *reinterpret_cast<const float4*>(&sG[(i0 + ii) * R_LD + px * 4]);
        const float4 qq =
            *reinterpret_cast<const float4*>(&sQ[(i0 + ii) * R_LD + px * 4]);
        const float gc[4] = {gg.x, gg.y, gg.z, gg.w};
        const float qc[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accV[r][c] = fmaf(pr[r][ii], gc[c], accV[r][c]);
            accK[r][c] = fmaf(dr[r][ii], qc[c], accK[r][c]);
          }
      }
    }
  }

  T* dk_b = dk.head(b, h) + px * 4;
  T* dv_b = dv.head(b, h) + px * 4;
  // k^ . dkn = sum_i ds_ij sc_ij for key j: this block's dlogit_scale share
  double dls = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lk = py + 16 * r;
    const int key = k0 + lk;
    float dkn[4], kn[4];
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dkn[c] = scale * accK[r][c];
      kn[c] = sKt[(px * 4 + c) * BT + lk];
      dot = fmaf(dkn[c], kn[c], dot);
    }
    dot = row_sum8(dot);
    const float rk = sRk[lk];
    if (key < N) {
      store4(dk_b + (size_t)key * dk.sn, rk * (dkn[0] - kn[0] * dot),
             rk * (dkn[1] - kn[1] * dot), rk * (dkn[2] - kn[2] * dot),
             rk * (dkn[3] - kn[3] * dot));
      store4(dv_b + (size_t)key * dv.sn, accV[r][0], accV[r][1], accV[r][2],
             accV[r][3]);
      if (px == 0) dls += dot;    // the 8 lanes of a key hold the same dot
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    dls += __shfl_xor_sync(0xffffffffu, dls, off);
  if ((tid & 31) == 0) sRed[tid >> 5] = dls;
  __syncthreads();
  if (tid == 0) {
    const double tot = sRed[0] + sRed[1] + sRed[2] + sRed[3];
    dls_part[((size_t)b * gridDim.x + blockIdx.x) * nH + h] =
        ls < LN100 ? tot : 0.0;
  }
}

// ---------------------------------------------------------------------------
// dbias alone, windows innermost: one block per (key tile, query tile, head)
// ---------------------------------------------------------------------------
template <typename T, typename TB, bool FASTEXP>
__global__ void __launch_bounds__(NT)
bwd_dbias_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                 Rows<const T> g, const float* __restrict__ logit_scale,
                 const TB* __restrict__ bias, const TB* __restrict__ mask,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dbias,
                 int B_, int N, int nW) {
  __shared__ __align__(16) float sQt[DH * BT];
  __shared__ __align__(16) float sGt[DH * BT];
  __shared__ __align__(16) float sKt[DH * BT];
  __shared__ __align__(16) float sVt[DH * BT];
  __shared__ float sLse[BT];
  __shared__ float sDelta[BT];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int q0 = blockIdx.y * BT;
  const int h = blockIdx.z;
  const int nH = gridDim.z;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], LN100));
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b = 0; b < B_; ++b) {
    const TB* mask_w =
        mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
    const size_t stat0 = ((size_t)b * nH + h) * N;
    __syncthreads();  // the previous window's reads of the tiles are done
    {
      float x[DH];
      const int j = tid & (BT - 1);
      if (tid < BT) {
        fetch_row(q.head(b, h), q.sn, q0 + j, N, x);
        normalise(x);
        put_t(sQt, j, x);
        sLse[j] = q0 + j < N ? lse[stat0 + q0 + j] : 0.0f;
        fetch_row(k.head(b, h), k.sn, k0 + j, N, x);
        normalise(x);
        put_t(sKt, j, x);
      } else {
        fetch_row(g.head(b, h), g.sn, q0 + j, N, x);
        put_t(sGt, j, x);
        sDelta[j] = q0 + j < N ? delta[stat0 + q0 + j] : 0.0f;
        fetch_row(v.head(b, h), v.sn, k0 + j, N, x);
        put_t(sVt, j, x);
      }
    }
    __syncthreads();

    float s[8][4], p[8][4], dp[8][4];
    tile_dot(sQt, sKt, ty, tx, s);
    probabilities<TB, FASTEXP>(s, p, bias_h, mask_w, sLse, scale, q0, k0, ty,
                               tx, N);
    tile_dot(sGt, sVt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dl = sDelta[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(p[i][j], dp[i][j] - dl, acc[i][j]);
    }
  }

  float* dbias_h = dbias + (size_t)h * N * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (row < N && col < N) dbias_h[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// The operands' (window, head, token) layout, on the host.
template <typename T>
struct Operands {
  Rows<const T> q, k, v, g;
  Rows<T> dq, dk, dv;
  bool aligned() const {
    return rows_aligned(q) && rows_aligned(k) && rows_aligned(v) &&
           rows_aligned(g) && rows_aligned(dq) && rows_aligned(dk) &&
           rows_aligned(dv);
  }
};

template <typename T, typename TB, bool FASTEXP>
cudaError_t launch(const Operands<T>& o, const void* ls, const void* bias,
                   const void* mask, const void* lse, void* delta,
                   void* dls_part, void* dbias, int B_, int N, int nH, int nW,
                   int dbias_mode, cudaStream_t stream) {
  const int nT = (N + BT - 1) / BT;
  const int dq_bytes = DQ_SMEM_FLOATS * (int)sizeof(float);
  const int dkv_bytes = DKV_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, TB, FASTEXP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_kernel<T, TB, FASTEXP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return err;

  dim3 grid(nT, nH, B_);
  bwd_dq_kernel<T, TB, FASTEXP><<<grid, NT, dq_bytes, stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, o.dq, (float*)delta, N, nW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bwd_dkv_kernel<T, TB, FASTEXP><<<grid, NT, dkv_bytes, stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, (const float*)delta, o.dk, o.dv,
      (double*)dls_part, dbias_mode == 1 ? (float*)dbias : nullptr, N, nW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (dbias_mode == 2) {
    dim3 grid_b(nT, nT, nH);
    bwd_dbias_kernel<T, TB, FASTEXP><<<grid_b, NT, 0, stream>>>(
        o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
        (const TB*)mask, (const float*)lse, (const float*)delta,
        (float*)dbias, B_, N, nW);
    err = cudaGetLastError();
  }
  return err;
}

// `packed`: q = qkv (B_, N, 3C), g (B_, N, C), dq = dqkv (B_, N, 3C), each
// by column block. Otherwise: q, k, v, g at their own bases with the twelve
// host strides `st` (q, k, v, g: window, head, token) and contiguous
// (B_, nH, N, DH) dq, dk, dv.
template <typename T, typename TB, bool FASTEXP>
int launch_layout(bool packed, const void* q, const void* k, const void* v,
                  const void* g, const long long* st, const void* ls,
                  const void* bias, const void* mask, const void* lse,
                  void* dq, void* dk, void* dv, void* delta, void* dls_part,
                  void* dbias, int B_, int N, int nH, int nW, int dbias_mode,
                  cudaStream_t stream) {
  const int C = nH * DH;
  Operands<T> o;
  if (packed) {
    o.q = packed_rows((const T*)q, 0, N, C, 3, DH);
    o.k = packed_rows((const T*)q, 1, N, C, 3, DH);
    o.v = packed_rows((const T*)q, 2, N, C, 3, DH);
    o.g = packed_rows((const T*)g, 0, N, C, 1, DH);
    o.dq = packed_rows((T*)dq, 0, N, C, 3, DH);
    o.dk = packed_rows((T*)dq, 1, N, C, 3, DH);
    o.dv = packed_rows((T*)dq, 2, N, C, 3, DH);
  } else {
    o.q = {(const T*)q, st[0], st[1], st[2]};
    o.k = {(const T*)k, st[3], st[4], st[5]};
    o.v = {(const T*)v, st[6], st[7], st[8]};
    o.g = {(const T*)g, st[9], st[10], st[11]};
    o.dq = contiguous_rows((T*)dq, nH, N, DH);
    o.dk = contiguous_rows((T*)dk, nH, N, DH);
    o.dv = contiguous_rows((T*)dv, nH, N, DH);
  }
  if (!o.aligned()) return -1;
  return (int)launch<T, TB, FASTEXP>(o, ls, bias, mask, lse, delta, dls_part,
                                     dbias, B_, N, nH, nW, dbias_mode,
                                     stream);
}

int dispatch(bool packed, const void* q, const void* k, const void* v,
             const void* g, const long long* st, const void* ls,
             const void* bias, const void* mask, const void* lse, void* dq,
             void* dk, void* dv, void* delta, void* dls_part, void* dbias,
             int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
             int dbias_mode, void* stream) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || B_ > 65535 || nH > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  if (dbias_mode < 0 || dbias_mode > 2) return -1;
  if (dbias_mode != 0 && dbias == nullptr) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16 && !bias_bf16)
    return launch_layout<float, float, false>(
        packed, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  if (qkv_bf16 && bias_bf16)
    return launch_layout<__nv_bfloat16, __nv_bfloat16, true>(
        packed, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  if (qkv_bf16 && !bias_bf16)
    return launch_layout<__nv_bfloat16, float, true>(
        packed, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  return -1;
}

}  // namespace

// Plain C entry. Pointers are device pointers. qkv (B_, N, 3C), g (B_, N, C)
// and dqkv (B_, N, 3C) share an element type (qkv_bf16: 0 = fp32); bias
// (nH, N, N) and mask (nW, N, N; may be null) share one (bias_bf16); fp32
// qkv requires fp32 bias. lse (B_, nH, N) fp32 comes from the forward
// kernel; delta (B_, nH, N) fp32 and dls_part (B_ * ceil(N / 64), nH) fp64
// are scratch and output (the caller sums dls_part over its first axis).
// dbias (nH, N, N) fp32: dbias_mode 0 = not computed (may be null),
// 1 = added with atomics (the caller zeroes it first), 2 = written by the
// windows-innermost pass. Returns the first CUDA error of the launches, or
// -1 for arguments the kernels do not take. Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int mmde_window_attention_bwd(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int dbias_mode, void* stream) {
  if (C != nH * DH) return -1;
  return dispatch(true, qkv, nullptr, nullptr, g, nullptr, logit_scale, bias,
                  mask, lse, dqkv, nullptr, nullptr, delta, dls_part, dbias,
                  B_, N, nH, nW, qkv_bf16, bias_bf16, dbias_mode, stream);
}

// Head-split entry (K7's counterpart): q, k, v and g (B_, nH, N, 32) of one
// element type, each at its own base with the strides `strides` gives, a
// host array of twelve: q, k, v, g, each (window, head, token), in
// elements; the channel axis is unit-stride and every row 16-byte aligned.
// dq, dk, dv: contiguous (B_, nH, N, 32) of that type. The other arguments
// as for mmde_window_attention_bwd.
extern "C" int mmde_window_attention_headsplit_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* strides, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int nH, int nW,
    int qkv_bf16, int bias_bf16, int dbias_mode, void* stream) {
  if (strides == nullptr) return -1;
  return dispatch(false, q, k, v, g, (const long long*)strides, logit_scale,
                  bias, mask, lse, dq, dk, dv, delta, dls_part, dbias, B_, N,
                  nH, nW, qkv_bf16, bias_bf16, dbias_mode, stream);
}
