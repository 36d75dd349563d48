// Fused SwinV2 cosine window attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels mmde_tpu/ops/window_attention_packed.py::_bwd_body
// (K2, driven by _pallas_backward) and, with dbias_mode = 2, its dbias-only
// pass ::_dbias_body (K3, driven by _pallas_dbias), on qkv as the Linear
// emits it; mmde_tpu/ops/window_attention_pallas.py::_bwd_kernel (K7,
// driven by _pallas_backward) on head-split q, k, v (B_, nH, N, Dh); and
// mmde_tpu/ops/window_attention_slab.py::_bwd_body (K9, driven by
// _pallas_backward) on the (B, Hp, Wp, 3C) map, reading g and writing dqkv
// as maps too; and, in kernels of their own (bwd_dq_w_kernel,
// bwd_dkv_w_kernel), K5: K2's w > 1 path (the same _bwd_body with W windows
// per grid cell, which MMDE_ATTN_W selects through _choose_w). The
// operands are layout structs (window_attention_common.cuh)
// and the kernels templates over them, so one set of kernels serves the
// three layouts. Same function, re-derived for a GPU. Per (window b, head
// h), with
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
// for either form, so the backward needs no per-head case. The head-split
// and slab entries hand over two (fault F3): one rounding of lse ~ 60 (half
// an fp32 ulp, 4e-6) scales every p of its row alike, which the cancelling
// sum of dlogit_scale does not average away (1.5e-4 of it at swin_tiny
// stage 1, fp32). There the forward keeps m + log(l) in fp64 as fp32 hi +
// lo, and p = exp((s - hi) - lo): s - hi is exact where p is not
// negligible, and lo takes the rounding out. Every entry of this file reads
// the pair (the packed ones since K1's and K5's FMA forwards write it; K3's
// entry reads one number behind the bf16 tensor-core passes, whose forward
// writes one, lse_pair = 0).
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
// its dbias is summed once in fp32 but is not bit-reproducible either. K9's
// TPU kernel accumulates dbias in fp32 in its resident output block across
// the consecutive (image, window row) sweep of a head group; K9' takes the
// same fp32 atomics, the values agreeing up to the order of an fp32 sum, and
// computes dq, dk, dv per window in the two passes above, written straight
// into the dqkv map.
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
// inputs far from their tensor-core bound. The port's packed launches, bf16
// and fp32 (K2, and K5 at W > 1; fp32 operands in three bf16 pieces), run
// window_attention_bwd_tc.cu instead (bf16 mma.sync); under
// MMDE_ATTN_GRID=split K3's pass alone follows them
// (mmde_window_attention_dbias), and the head-split and slab launches of
// either type run the tensor-core passes too. This body is their same-card
// comparison (the wrappers' private `_fma`).
//
// Precision modes (MXU, window_attention_common.cuh; the JAX package's
// `mxu`, an argument of the packed entries): the packed passes (K2, K3, K5)
// rebuild p with the forward's ops ("fold": logits from q^*scale; "bf16":
// from bf16 operands) and, under "bf16", round the products' operands where
// the TPU body casts them: g and v for dp, p and g for dv, ds for dq and dk
// (ds and p enter dbias, delta and dlogit_scale unrounded). Two
// consequences: the dq pass cannot round ds inside A - delta * B, so under
// "bf16" it sweeps the keys twice (delta first, then ds k^); and k^ . dkn
// is no longer sum_i ds_ij sc_ij, so the dk/dv pass sums ds * sc itself
// for dlogit_scale. The head-split and slab entries take no mode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "window_attention_common.cuh"

namespace {

constexpr int DH = 32;        // head dim of every swin variant
constexpr int BT = 64;        // tile edge: query rows and keys per tile
constexpr int NT = 128;       // threads per block
constexpr int R_LD = DH + 4;  // [row][d] tiles, padded for 128-bit access
constexpr int P_LD = BT + 4;  // [row][key] / [key][row] tiles
constexpr float LN100 = 4.605170185988091f;

constexpr int DQ_SMEM_FLOATS =
    4 * DH * BT + BT * R_LD + 2 * BT * P_LD + 4 * BT;
constexpr int DKV_SMEM_FLOATS =
    4 * DH * BT + 2 * BT * R_LD + 2 * BT * P_LD + 4 * BT + 8;

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

// x <- the operand a product of mode MXU takes: times `scale` (a q^ row
// under the folded modes, scale = 1 for the others) and rounded to bf16
// where the mode rounds that operand (ROUND: MXU_BF16)
template <bool ROUND>
__device__ __forceinline__ void operand(float (&x)[DH], float scale) {
#pragma unroll
  for (int d = 0; d < DH; ++d) x[d] = rnd<ROUND>(x[d] * scale);
}

// the four channels px*4.. of the normalised row r (0 past the edge), from
// device memory: q^ / k^ in fp32 where the staged tile holds the scaled or
// rounded operand
template <typename T, class R>
__device__ __forceinline__ void unit_row4(const T* __restrict__ base,
                                          const R& rows, int r, int N, int px,
                                          float inv, float (&x)[4]) {
  if (r < N) {
    load4(base + rows.off(r) + px * 4, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] *= inv;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = 0.0f;
  }
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

// in: s = q^ k^T of the tile (FOLD: (q^ * scale) k^T). out: s = sc =
// scale * q^ k^T (FOLD: s as it is) and p = exp(sc + bias + mask - lse)
// (LO, the head-split and slab entries: exp((sc + bias + mask - lse) -
// lo), lo the log-sum-exp's low part); both 0 past the edge.
template <typename TB, bool FASTEXP, bool FOLD, bool LO>
__device__ __forceinline__ void probabilities(
    float (&s)[8][4], float (&p)[8][4], const TB* __restrict__ bias_h,
    const TB* __restrict__ mask_w, const float* __restrict__ sLse,
    const float* __restrict__ sLo, float scale, int q0, int k0, int ty,
    int tx, int N) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    const float lse = sLse[ty * 8 + i];
    const float lo = LO ? sLo[ty * 8 + i] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (row < N && col < N) {
        const size_t idx = (size_t)row * N + col;
        const float sc = FOLD ? s[i][j] : s[i][j] * scale;
        float v = sc + ldf(bias_h, idx);
        if (mask_w != nullptr) v += ldf(mask_w, idx);
        s[i][j] = sc;
        p[i][j] = exp_<FASTEXP>(LO ? (v - lse) - lo : v - lse);
      } else {
        s[i][j] = 0.0f;
        p[i][j] = 0.0f;
      }
    }
  }
}

// the low part of a row's log-sum-exp, 0 past the edge
__device__ __forceinline__ float lse_low(const float* __restrict__ lse_lo,
                                         size_t i, bool ok) {
  return ok ? lse_lo[i] : 0.0f;
}

// ---------------------------------------------------------------------------
// dq, delta, dlogit_scale partials: one block per (query tile, head, window)
// ---------------------------------------------------------------------------
// MXU_BF16 rounds ds itself before its product with k^, so that mode cannot
// use A - delta * B: a first sweep over the keys sums delta (p and dp), the
// second forms ds and its product.
template <template <typename> class L, typename T, typename TB, bool FASTEXP,
          int MXU, bool LO>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(L<const T> q, L<const T> k, L<const T> v, L<const T> g,
              const float* __restrict__ logit_scale,
              const TB* __restrict__ bias, const TB* __restrict__ mask,
              const float* __restrict__ lse,
              const float* __restrict__ lse_lo, L<T> dq,
              float* __restrict__ delta, int N, int nW) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;               // [DH][BT] q^ (folded: q^ * scale)
  float* sGt = sQt + DH * BT;      // [DH][BT] g
  float* sKt = sGt + DH * BT;      // [DH][BT] k^
  float* sVt = sKt + DH * BT;      // [DH][BT] v
  float* sK = sVt + DH * BT;       // [BT][R_LD] k^
  float* sP = sK + BT * R_LD;      // [BT][P_LD] p
  float* sW = sP + BT * P_LD;      // [BT][P_LD] p * dp (MXU_BF16: ds)
  float* sRq = sW + BT * P_LD;     // [BT]
  float* sLse = sRq + BT;          // [BT]
  float* sDelta = sLse + BT;       // [BT]
  float* sLo = sDelta + BT;        // [BT]

  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RB = MXU == MXU_BF16;
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
      fetch_row(q.head(b, h), q, r, N, x);
      sRq[j] = normalise(x);
      operand<RB>(x, FOLD ? scale : 1.0f);
      put_t(sQt, j, x);
      sLse[j] = r < N ? lse[stat0 + r] : 0.0f;
      if (LO) sLo[j] = lse_low(lse_lo, stat0 + r, r < N);
    } else {
      fetch_row(g.head(b, h), g, r, N, x);
      operand<RB>(x, 1.0f);
      put_t(sGt, j, x);
    }
  }

  // threads 0..63 load key rows, 64..127 value rows
  const T* kv_bh = tid < BT ? k.head(b, h) : v.head(b, h);
  const L<const T> kv = tid < BT ? k : v;

  float d_part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d_part[i] = 0.0f;
  float accA[4][4], accB[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) accA[r][c] = accB[r][c] = 0.0f;

  for (int pass = RB ? 0 : 1; pass < 2; ++pass) {
    if (RB && pass == 1) {   // delta of the first sweep, per row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = row_sum16(d_part[i]);
        if (tx == 0) sDelta[ty * 8 + i] = d;
      }
    }
    for (int k0 = 0; k0 < N; k0 += BT) {
      __syncthreads();  // the previous step's reads of the key tiles are done
      {
        float x[DH];
        const int j = tid & (BT - 1);
        const int r = k0 + j;
        fetch_row(kv_bh, kv, r, N, x);
        if (tid < BT) {
          normalise(x);
          operand<RB>(x, 1.0f);
          put_t(sKt, j, x);
          put_r(sK, j, x);
        } else {
          operand<RB>(x, 1.0f);
          put_t(sVt, j, x);
        }
      }
      __syncthreads();

      float s[8][4], p[8][4], dp[8][4];
      tile_dot(sQt, sKt, ty, tx, s);
      probabilities<TB, FASTEXP, FOLD, LO>(s, p, bias_h, mask_w, sLse, sLo,
                                           scale, q0, k0, ty, tx, N);
      tile_dot(sGt, sVt, ty, tx, dp);
      if (RB && pass == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d_part[i] += p[i][j] * dp[i][j];
        continue;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float w[4];
        if constexpr (RB) {
          const float dl = sDelta[ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = bf16r(p[i][j] * (dp[i][j] - dl));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[j] = p[i][j] * dp[i][j];
            d_part[i] += w[j];
          }
          store4(&sP[(ty * 8 + i) * P_LD + tx * 4], p[i][0], p[i][1],
                 p[i][2], p[i][3]);
        }
        store4(&sW[(ty * 8 + i) * P_LD + tx * 4], w[0], w[1], w[2], w[3]);
      }
      __syncthreads();

      // A += (p*dp) k^,  B += p k^  (MXU_BF16: A += ds k^)
#pragma unroll 2
      for (int j0 = 0; j0 < BT; j0 += 4) {
        float pr[4][4], wr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 u = *reinterpret_cast<const float4*>(
              &sW[(py + 16 * r) * P_LD + j0]);
          wr[r][0] = u.x; wr[r][1] = u.y; wr[r][2] = u.z; wr[r][3] = u.w;
          if constexpr (!RB) {
            const float4 t = *reinterpret_cast<const float4*>(
                &sP[(py + 16 * r) * P_LD + j0]);
            pr[r][0] = t.x; pr[r][1] = t.y; pr[r][2] = t.z; pr[r][3] = t.w;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(
              &sK[(j0 + jj) * R_LD + px * 4]);
          const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              accA[r][c] = fmaf(wr[r][jj], kc[c], accA[r][c]);
              if constexpr (!RB) accB[r][c] = fmaf(pr[r][jj], kc[c], accB[r][c]);
            }
        }
      }
    }
  }

  // delta per row
  if constexpr (!RB) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = row_sum16(d_part[i]);
      if (tx == 0) sDelta[ty * 8 + i] = d;
    }
  }
  __syncthreads();

  if (tid < BT && q0 + tid < N) delta[stat0 + q0 + tid] = sDelta[tid];

  T* dq_b = dq.head(b, h) + px * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = py + 16 * r;
    const int row = q0 + lr;
    const float dl = sDelta[lr];
    const float rq = sRq[lr];
    float dqn[4], qn[4];
    if constexpr (FOLD) {     // sQt holds the folded operand
      unit_row4(q.head(b, h), q, row, N, px, rq, qn);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) qn[c] = sQt[(px * 4 + c) * BT + lr];
    }
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dqn[c] = scale * (RB ? accA[r][c] : accA[r][c] - dl * accB[r][c]);
      dot = fmaf(dqn[c], qn[c], dot);
    }
    dot = row_sum8(dot);
    if (row < N)
      store4(dq_b + dq.off(row), rq * (dqn[0] - qn[0] * dot),
             rq * (dqn[1] - qn[1] * dot), rq * (dqn[2] - qn[2] * dot),
             rq * (dqn[3] - qn[3] * dot));
  }
}

// ---------------------------------------------------------------------------
// dk, dv (and dbias by atomics): one block per (key tile, head, window)
// ---------------------------------------------------------------------------
template <template <typename> class L, typename T, typename TB, bool FASTEXP,
          int MXU, bool LO>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(L<const T> q, L<const T> k, L<const T> v, L<const T> g,
               const float* __restrict__ logit_scale,
               const TB* __restrict__ bias, const TB* __restrict__ mask,
               const float* __restrict__ lse,
               const float* __restrict__ lse_lo,
               const float* __restrict__ delta, L<T> dk, L<T> dv,
               double* __restrict__ dls_part, float* __restrict__ dbias,
               int N, int nW) {
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
  float* sLo = sDelta + BT;        // [BT]
  // [4] doubles; the offset (21760 floats) keeps them 8-byte aligned
  double* sRed = reinterpret_cast<double*>(sLo + BT);

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
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RB = MXU == MXU_BF16;

  const int tx = tid & 15;  // N x N tiles: query rows ty*8..+7, keys tx*4..+3
  const int ty = tid >> 4;
  const int px = tid & 7;   // N x 32 tiles: keys py + 16*r, channels px*4..+3
  const int py = tid >> 3;

  {
    float x[DH];
    const int j = tid & (BT - 1);
    const int r = k0 + j;
    if (tid < BT) {
      fetch_row(k.head(b, h), k, r, N, x);
      sRk[j] = normalise(x);
      operand<RB>(x, 1.0f);
      put_t(sKt, j, x);
    } else {
      fetch_row(v.head(b, h), v, r, N, x);
      operand<RB>(x, 1.0f);
      put_t(sVt, j, x);
    }
  }

  // threads 0..63 load query rows, 64..127 rows of g
  const T* qg_bh = tid < BT ? q.head(b, h) : g.head(b, h);
  const L<const T> qg = tid < BT ? q : g;

  float accV[4][4], accK[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) accV[r][c] = accK[r][c] = 0.0f;
  // MXU_BF16: k^ . dkn is no longer sum_i ds_ij sc_ij (ds is rounded in its
  // product), so the block sums ds * sc itself, tile by tile
  double dls_tiles = 0.0;

  for (int q0 = 0; q0 < N; q0 += BT) {
    __syncthreads();  // the previous step's reads of the query tiles are done
    {
      float x[DH];
      const int j = tid & (BT - 1);
      const int r = q0 + j;
      fetch_row(qg_bh, qg, r, N, x);
      if (tid < BT) {
        normalise(x);
        operand<RB>(x, FOLD ? scale : 1.0f);
        put_t(sQt, j, x);
        put_r(sQ, j, x);
        sLse[j] = r < N ? lse[stat0 + r] : 0.0f;
        if (LO) sLo[j] = lse_low(lse_lo, stat0 + r, r < N);
      } else {
        operand<RB>(x, 1.0f);
        put_t(sGt, j, x);
        put_r(sG, j, x);
        sDelta[j] = r < N ? delta[stat0 + r] : 0.0f;
      }
    }
    __syncthreads();

    float s[8][4], p[8][4], ds[8][4];
    tile_dot(sQt, sKt, ty, tx, s);
    probabilities<TB, FASTEXP, FOLD, LO>(s, p, bias_h, mask_w, sLse, sLo,
                                         scale, q0, k0, ty, tx, N);
    tile_dot(sGt, sVt, ty, tx, ds);  // dp for now
    float dls_t = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dl = sDelta[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ds[i][j] = p[i][j] * (ds[i][j] - dl);
        if (RB) dls_t = fmaf(ds[i][j], s[i][j], dls_t);
      }
    }
    if (RB) dls_tiles += dls_t;
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
    // transposed, [key][row]: the next products sum over query rows; their
    // operands (MXU_BF16 rounds p and ds here, the sums above took them as
    // they are)
    if constexpr (RB) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = bf16r(p[i][j]);
          ds[i][j] = bf16r(ds[i][j]);
        }
    }
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

    // dv += p^T g,  dkn += ds^T q^  (folded: ds^T (q^ * scale))
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
  // (MXU_BF16: the sum the loop took)
  double dls = RB ? dls_tiles : 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lk = py + 16 * r;
    const int key = k0 + lk;
    const float rk = sRk[lk];
    float dkn[4], kn[4];
    if constexpr (RB) {       // sKt holds the rounded operand
      unit_row4(k.head(b, h), k, key, N, px, rk, kn);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) kn[c] = sKt[(px * 4 + c) * BT + lk];
    }
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dkn[c] = FOLD ? accK[r][c] : scale * accK[r][c];
      dot = fmaf(dkn[c], kn[c], dot);
    }
    dot = row_sum8(dot);
    if (key < N) {
      store4(dk_b + dk.off(key), rk * (dkn[0] - kn[0] * dot),
             rk * (dkn[1] - kn[1] * dot), rk * (dkn[2] - kn[2] * dot),
             rk * (dkn[3] - kn[3] * dot));
      store4(dv_b + dv.off(key), accV[r][0], accV[r][1], accV[r][2],
             accV[r][3]);
      if (!RB && px == 0) dls += dot;  // the 8 lanes of a key hold one dot
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
template <template <typename> class L, typename T, typename TB, bool FASTEXP,
          int MXU, bool LO>
__global__ void __launch_bounds__(NT)
bwd_dbias_kernel(L<const T> q, L<const T> k, L<const T> v, L<const T> g,
                 const float* __restrict__ logit_scale,
                 const TB* __restrict__ bias, const TB* __restrict__ mask,
                 const float* __restrict__ lse,
                 const float* __restrict__ lse_lo,
                 const float* __restrict__ delta, float* __restrict__ dbias,
                 int B_, int N, int nW) {
  __shared__ __align__(16) float sQt[DH * BT];
  __shared__ __align__(16) float sGt[DH * BT];
  __shared__ __align__(16) float sKt[DH * BT];
  __shared__ __align__(16) float sVt[DH * BT];
  __shared__ float sLse[BT];
  __shared__ float sLo[BT];
  __shared__ float sDelta[BT];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int q0 = blockIdx.y * BT;
  const int h = blockIdx.z;
  const int nH = gridDim.z;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], LN100));
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RB = MXU == MXU_BF16;
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
        fetch_row(q.head(b, h), q, q0 + j, N, x);
        normalise(x);
        operand<RB>(x, FOLD ? scale : 1.0f);
        put_t(sQt, j, x);
        sLse[j] = q0 + j < N ? lse[stat0 + q0 + j] : 0.0f;
        if (LO) sLo[j] = lse_low(lse_lo, stat0 + q0 + j, q0 + j < N);
        fetch_row(k.head(b, h), k, k0 + j, N, x);
        normalise(x);
        operand<RB>(x, 1.0f);
        put_t(sKt, j, x);
      } else {
        fetch_row(g.head(b, h), g, q0 + j, N, x);
        operand<RB>(x, 1.0f);
        put_t(sGt, j, x);
        sDelta[j] = q0 + j < N ? delta[stat0 + q0 + j] : 0.0f;
        fetch_row(v.head(b, h), v, k0 + j, N, x);
        operand<RB>(x, 1.0f);
        put_t(sVt, j, x);
      }
    }
    __syncthreads();

    float s[8][4], p[8][4], dp[8][4];
    tile_dot(sQt, sKt, ty, tx, s);
    probabilities<TB, FASTEXP, FOLD, LO>(s, p, bias_h, mask_w, sLse, sLo,
                                         scale, q0, k0, ty, tx, N);
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

// ---------------------------------------------------------------------------
// K5: the dq and dk/dv passes with W consecutive windows per block
// ---------------------------------------------------------------------------
// The block owns one (query tile | key tile, head) of W windows and walks the
// other tile axis outermost; for each step it stages the 64 x 64 bias tile
// once in shared memory (fp32) and then runs the W windows' tile products
// against it. What a window carries from one step to the next - the dq
// pass's A / B accumulators and delta, the dk/dv pass's dv / dk^
// accumulators - lives in shared memory, one slot per window; the q / g /
// k / v tiles are re-read for each (step, window) (from L2). The tile
// products' staging and the p / ds tiles share one region, which the two
// use in turn. The dk/dv pass sums the W windows' ds tiles in registers
// before its fp32 atomics into dbias: one atomic per element per W windows.

// `probabilities` with the bias read from the staged tile, the log-sum-exp
// as hi (sLse) + lo (sLo), F3
template <typename TB, bool FASTEXP, bool FOLD>
__device__ __forceinline__ void probabilities_staged(
    float (&s)[8][4], float (&p)[8][4], const float* __restrict__ sB,
    const TB* __restrict__ mask_w, const float* __restrict__ sLse,
    const float* __restrict__ sLo, float scale, int q0, int k0, int ty,
    int tx, int N) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    const float lse = sLse[ty * 8 + i];
    const float lo = sLo[ty * 8 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (row < N && col < N) {
        const float sc = FOLD ? s[i][j] : s[i][j] * scale;
        float v = sc + sB[(ty * 8 + i) * P_LD + tx * 4 + j];
        if (mask_w != nullptr) v += ldf(mask_w, (size_t)row * N + col);
        s[i][j] = sc;
        p[i][j] = exp_<FASTEXP>((v - lse) - lo);
      } else {
        s[i][j] = 0.0f;
        p[i][j] = 0.0f;
      }
    }
  }
}

// shared memory of the W-window passes, in floats: the part every block
// has, and one window's slot
constexpr int DQW_BASE_FLOATS = 2 * BT * P_LD + BT * R_LD + BT * P_LD + BT;
constexpr int DQW_WIN_FLOATS = 2 * BT * R_LD + 3 * BT;
constexpr int DKVW_BASE_FLOATS =
    8 + 2 * BT * P_LD + 2 * BT * R_LD + BT * P_LD + 4 * BT;
constexpr int DKVW_WIN_FLOATS = 2 * BT * R_LD;
static_assert(2 * BT * P_LD >= 4 * DH * BT, "p / ds tiles cover the staging");

template <typename T, typename TB, bool FASTEXP, int MXU>
__global__ void __launch_bounds__(NT)
bwd_dq_w_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                Rows<const T> g, const float* __restrict__ logit_scale,
                const TB* __restrict__ bias, const TB* __restrict__ mask,
                const float* __restrict__ lse,
                const float* __restrict__ lse_lo, Rows<T> dq,
                float* __restrict__ delta, int N, int nW, int W) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                   // [DH][BT] q^   } the tile products
  float* sGt = sQt + DH * BT;          // [DH][BT] g    }
  float* sKt = sGt + DH * BT;          // [DH][BT] k^   }
  float* sVt = sKt + DH * BT;          // [DH][BT] v    }
  float* sP = smem;                    // [BT][P_LD] p       } then, in turn
  float* sW = sP + BT * P_LD;          // [BT][P_LD] p * dp  }
  float* sK = smem + 2 * BT * P_LD;    // [BT][R_LD] k^
  float* sB = sK + BT * R_LD;          // [BT][P_LD] bias tile
  float* sRq = sB + BT * P_LD;         // [BT]
  float* sWin = sRq + BT;              // W x {A, B [BT][R_LD]; delta, lse
                                       //      hi, lo}

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int nH = gridDim.y;
  const int b0 = blockIdx.z * W;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], LN100));
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RB = MXU == MXU_BF16;
  const int tx = tid & 15, ty = tid >> 4;
  const int px = tid & 7, py = tid >> 3;

  for (int w = 0; w < W; ++w) {
    float* wA = sWin + w * DQW_WIN_FLOATS;
    float* wD = wA + 2 * BT * R_LD;
    float* wL = wD + BT;
    for (int e = tid; e < 2 * BT * R_LD; e += NT) wA[e] = 0.0f;
    if (tid < BT) {
      const int r = q0 + tid;
      const size_t i = ((size_t)(b0 + w) * nH + h) * N + r;
      wD[tid] = 0.0f;
      wL[tid] = r < N ? lse[i] : 0.0f;
      wL[BT + tid] = r < N ? lse_lo[i] : 0.0f;
    }
  }

  // MXU_BF16 rounds ds itself before its product with k^: a first sweep
  // sums every window's delta, the second forms ds (as bwd_dq_kernel)
  for (int pass = RB ? 0 : 1; pass < 2; ++pass) {
  for (int k0 = 0; k0 < N; k0 += BT) {
    __syncthreads();  // the previous key tile's reads of sB and sK are done
    stage_bias<BT, BT, P_LD, NT>(sB, bias_h, q0, k0, N, tid);
    for (int w = 0; w < W; ++w) {
      const int b = b0 + w;
      float* wA = sWin + w * DQW_WIN_FLOATS;
      float* wB = wA + BT * R_LD;
      float* wD = wB + BT * R_LD;
      const float* wL = wD + BT;
      const TB* mask_w =
          mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
      __syncthreads();  // sB staged; the last window's reads of sP/sW/sK done
      {
        float x[DH];
        const int j = tid & (BT - 1);
        if (tid < BT) {
          fetch_row(q.head(b, h), q, q0 + j, N, x);
          normalise(x);
          operand<RB>(x, FOLD ? scale : 1.0f);
          put_t(sQt, j, x);
          fetch_row(k.head(b, h), k, k0 + j, N, x);
          normalise(x);
          operand<RB>(x, 1.0f);
          put_t(sKt, j, x);
          put_r(sK, j, x);
        } else {
          fetch_row(g.head(b, h), g, q0 + j, N, x);
          operand<RB>(x, 1.0f);
          put_t(sGt, j, x);
          fetch_row(v.head(b, h), v, k0 + j, N, x);
          operand<RB>(x, 1.0f);
          put_t(sVt, j, x);
        }
      }
      __syncthreads();

      float s[8][4], p[8][4], dp[8][4];
      tile_dot(sQt, sKt, ty, tx, s);
      probabilities_staged<TB, FASTEXP, FOLD>(s, p, sB, mask_w, wL, wL + BT,
                                              scale, q0, k0, ty, tx, N);
      tile_dot(sGt, sVt, ty, tx, dp);
      if (!RB || pass == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float d = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) d += p[i][j] * dp[i][j];
          d = row_sum16(d);
          if (tx == 0) wD[ty * 8 + i] += d;
        }
        if (RB) continue;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dl = RB ? wD[ty * 8 + i] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)   // p * dp (MXU_BF16: ds, rounded)
          dp[i][j] = RB ? bf16r(p[i][j] * (dp[i][j] - dl)) : p[i][j] * dp[i][j];
      }
      __syncthreads();  // the products' reads of the staging are done
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!RB)
          store4(&sP[(ty * 8 + i) * P_LD + tx * 4], p[i][0], p[i][1],
                 p[i][2], p[i][3]);
        store4(&sW[(ty * 8 + i) * P_LD + tx * 4], dp[i][0], dp[i][1],
               dp[i][2], dp[i][3]);
      }
      __syncthreads();

      // A += (p*dp) k^,  B += p k^ (MXU_BF16: A += ds k^), this window's slot
      float accA[4][4], accB[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(
            &wA[(py + 16 * r) * R_LD + px * 4]);
        accA[r][0] = a.x; accA[r][1] = a.y; accA[r][2] = a.z; accA[r][3] = a.w;
        if constexpr (!RB) {
          const float4 c = *reinterpret_cast<const float4*>(
              &wB[(py + 16 * r) * R_LD + px * 4]);
          accB[r][0] = c.x; accB[r][1] = c.y; accB[r][2] = c.z;
          accB[r][3] = c.w;
        }
      }
#pragma unroll 2
      for (int j0 = 0; j0 < BT; j0 += 4) {
        float pr[4][4], wr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 u = *reinterpret_cast<const float4*>(
              &sW[(py + 16 * r) * P_LD + j0]);
          wr[r][0] = u.x; wr[r][1] = u.y; wr[r][2] = u.z; wr[r][3] = u.w;
          if constexpr (!RB) {
            const float4 t = *reinterpret_cast<const float4*>(
                &sP[(py + 16 * r) * P_LD + j0]);
            pr[r][0] = t.x; pr[r][1] = t.y; pr[r][2] = t.z; pr[r][3] = t.w;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(
              &sK[(j0 + jj) * R_LD + px * 4]);
          const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              accA[r][c] = fmaf(wr[r][jj], kc[c], accA[r][c]);
              if constexpr (!RB) accB[r][c] = fmaf(pr[r][jj], kc[c], accB[r][c]);
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        store4(&wA[(py + 16 * r) * R_LD + px * 4], accA[r][0], accA[r][1],
               accA[r][2], accA[r][3]);
        if constexpr (!RB)
          store4(&wB[(py + 16 * r) * R_LD + px * 4], accB[r][0], accB[r][1],
                 accB[r][2], accB[r][3]);
      }
    }
  }
  }

  // per window: delta out, dq = rq (dqn - q^ <dqn, q^>), dqn = scale (A - delta B)
  for (int w = 0; w < W; ++w) {
    const int b = b0 + w;
    const float* wA = sWin + w * DQW_WIN_FLOATS;
    const float* wB = wA + BT * R_LD;
    const float* wD = wB + BT * R_LD;
    const size_t stat0 = ((size_t)b * nH + h) * N;
    __syncthreads();  // the last reads of sP / sW / sQt are done
    if (tid < BT) {
      float x[DH];
      fetch_row(q.head(b, h), q, q0 + tid, N, x);
      sRq[tid] = normalise(x);
      put_t(sQt, tid, x);
      if (q0 + tid < N) delta[stat0 + q0 + tid] = wD[tid];
    }
    __syncthreads();
    T* dq_b = dq.head(b, h) + px * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = py + 16 * r;
      const int row = q0 + lr;
      const float dl = wD[lr];
      float dqn[4], qn[4];
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dqn[c] = scale * (RB ? wA[lr * R_LD + px * 4 + c]
                             : wA[lr * R_LD + px * 4 + c] -
                                   dl * wB[lr * R_LD + px * 4 + c]);
        qn[c] = sQt[(px * 4 + c) * BT + lr];
        dot = fmaf(dqn[c], qn[c], dot);
      }
      dot = row_sum8(dot);
      const float rq = sRq[lr];
      if (row < N)
        store4(dq_b + dq.off(row), rq * (dqn[0] - qn[0] * dot),
               rq * (dqn[1] - qn[1] * dot), rq * (dqn[2] - qn[2] * dot),
               rq * (dqn[3] - qn[3] * dot));
    }
  }
}

template <typename T, typename TB, bool FASTEXP, int MXU>
__global__ void __launch_bounds__(NT)
bwd_dkv_w_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                 Rows<const T> g, const float* __restrict__ logit_scale,
                 const TB* __restrict__ bias, const TB* __restrict__ mask,
                 const float* __restrict__ lse,
                 const float* __restrict__ lse_lo,
                 const float* __restrict__ delta, Rows<T> dk, Rows<T> dv,
                 double* __restrict__ dls_part, float* __restrict__ dbias,
                 int N, int nW, int W) {
  extern __shared__ __align__(16) float smem[];
  double* sRed = reinterpret_cast<double*>(smem);  // [4]
  float* sKt = smem + 8;               // [DH][BT] k^   } the tile products
  float* sVt = sKt + DH * BT;          // [DH][BT] v    }
  float* sQt = sVt + DH * BT;          // [DH][BT] q^   }
  float* sGt = sQt + DH * BT;          // [DH][BT] g    }
  float* sPt = smem + 8;               // [BT keys][P_LD rows] p   } then
  float* sDSt = sPt + BT * P_LD;       // [BT keys][P_LD rows] ds  }
  float* sQ = smem + 8 + 2 * BT * P_LD;  // [BT][R_LD] q^
  float* sG = sQ + BT * R_LD;          // [BT][R_LD] g
  float* sB = sG + BT * R_LD;          // [BT rows][P_LD keys] bias tile
  float* sRk = sB + BT * P_LD;         // [BT]
  float* sLse = sRk + BT;              // [BT]
  float* sDelta = sLse + BT;           // [BT]
  float* sLo = sDelta + BT;            // [BT] the log-sum-exp's lo (F3)
  float* sWin = sLo + BT;              // W x {dv, dk^ [BT][R_LD]}

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int nH = gridDim.y;
  const int b0 = blockIdx.z * W;
  const TB* bias_h = bias + (size_t)h * N * N;
  float* dbias_h = dbias != nullptr ? dbias + (size_t)h * N * N : nullptr;
  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, LN100));
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RB = MXU == MXU_BF16;
  const int tx = tid & 15, ty = tid >> 4;
  const int px = tid & 7, py = tid >> 3;
  double dls_tiles = 0.0;   // MXU_BF16: the sum of ds * sc, as bwd_dkv_kernel

  for (int e = tid; e < W * DKVW_WIN_FLOATS; e += NT) sWin[e] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += BT) {
    __syncthreads();  // the previous query tile's reads of sB are done
    stage_bias<BT, BT, P_LD, NT>(sB, bias_h, q0, k0, N, tid);
    float dsum[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsum[i][j] = 0.0f;
    for (int w = 0; w < W; ++w) {
      const int b = b0 + w;
      float* wV = sWin + w * DKVW_WIN_FLOATS;
      float* wK = wV + BT * R_LD;
      const TB* mask_w =
          mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
      const size_t stat0 = ((size_t)b * nH + h) * N;
      __syncthreads();  // sB staged; the last window's reads of the tiles done
      {
        float x[DH];
        const int j = tid & (BT - 1);
        const int r = q0 + j;
        if (tid < BT) {
          fetch_row(q.head(b, h), q, r, N, x);
          normalise(x);
          operand<RB>(x, FOLD ? scale : 1.0f);
          put_t(sQt, j, x);
          put_r(sQ, j, x);
          sLse[j] = r < N ? lse[stat0 + r] : 0.0f;
          sLo[j] = r < N ? lse_lo[stat0 + r] : 0.0f;
          fetch_row(k.head(b, h), k, k0 + j, N, x);
          normalise(x);
          operand<RB>(x, 1.0f);
          put_t(sKt, j, x);
        } else {
          fetch_row(g.head(b, h), g, r, N, x);
          operand<RB>(x, 1.0f);
          put_t(sGt, j, x);
          put_r(sG, j, x);
          sDelta[j] = r < N ? delta[stat0 + r] : 0.0f;
          fetch_row(v.head(b, h), v, k0 + j, N, x);
          operand<RB>(x, 1.0f);
          put_t(sVt, j, x);
        }
      }
      __syncthreads();

      float s[8][4], p[8][4], ds[8][4];
      tile_dot(sQt, sKt, ty, tx, s);
      probabilities_staged<TB, FASTEXP, FOLD>(s, p, sB, mask_w, sLse, sLo,
                                              scale, q0, k0, ty, tx, N);
      tile_dot(sGt, sVt, ty, tx, ds);  // dp for now
      float dls_t = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dl = sDelta[ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ds[i][j] = p[i][j] * (ds[i][j] - dl);
          dsum[i][j] += ds[i][j];
          if (RB) {
            dls_t = fmaf(ds[i][j], s[i][j], dls_t);
            p[i][j] = bf16r(p[i][j]);      // the operands of dv and dk^
            ds[i][j] = bf16r(ds[i][j]);
          }
        }
      }
      if (RB) dls_tiles += dls_t;
      __syncthreads();  // the products' reads of the staging are done
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

      // dv += p^T g,  dkn += ds^T q^, this window's slot
      float accV[4][4], accK[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(
            &wV[(py + 16 * r) * R_LD + px * 4]);
        const float4 c = *reinterpret_cast<const float4*>(
            &wK[(py + 16 * r) * R_LD + px * 4]);
        accV[r][0] = a.x; accV[r][1] = a.y; accV[r][2] = a.z; accV[r][3] = a.w;
        accK[r][0] = c.x; accK[r][1] = c.y; accK[r][2] = c.z; accK[r][3] = c.w;
      }
#pragma unroll 2
      for (int i0 = 0; i0 < BT; i0 += 4) {
        float pr[4][4], dr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 t = *reinterpret_cast<const float4*>(
              &sPt[(py + 16 * r) * P_LD + i0]);
          const float4 u = *reinterpret_cast<const float4*>(
              &sDSt[(py + 16 * r) * P_LD + i0]);
          pr[r][0] = t.x; pr[r][1] = t.y; pr[r][2] = t.z; pr[r][3] = t.w;
          dr[r][0] = u.x; dr[r][1] = u.y; dr[r][2] = u.z; dr[r][3] = u.w;
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 gg = *reinterpret_cast<const float4*>(
              &sG[(i0 + ii) * R_LD + px * 4]);
          const float4 qq = *reinterpret_cast<const float4*>(
              &sQ[(i0 + ii) * R_LD + px * 4]);
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
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        store4(&wV[(py + 16 * r) * R_LD + px * 4], accV[r][0], accV[r][1],
               accV[r][2], accV[r][3]);
        store4(&wK[(py + 16 * r) * R_LD + px * 4], accK[r][0], accK[r][1],
               accK[r][2], accK[r][3]);
      }
    }
    if (dbias_h != nullptr) {   // the W windows' ds, one atomic per element
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = q0 + ty * 8 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx * 4 + j;
          if (row < N && col < N)
            atomicAdd(dbias_h + (size_t)row * N + col, dsum[i][j]);
        }
      }
    }
  }

  // per window: dk = rk (dkn - k^ <dkn, k^>), dkn = scale * acc (folded:
  // acc); dv
  double dls = RB ? dls_tiles : 0.0;
  for (int w = 0; w < W; ++w) {
    const int b = b0 + w;
    const float* wV = sWin + w * DKVW_WIN_FLOATS;
    const float* wK = wV + BT * R_LD;
    __syncthreads();  // the last reads of sPt / sDSt (over sKt) are done
    if (tid < BT) {
      float x[DH];
      fetch_row(k.head(b, h), k, k0 + tid, N, x);
      sRk[tid] = normalise(x);
      put_t(sKt, tid, x);
    }
    __syncthreads();
    T* dk_b = dk.head(b, h) + px * 4;
    T* dv_b = dv.head(b, h) + px * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lk = py + 16 * r;
      const int key = k0 + lk;
      float dkn[4], kn[4];
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dkn[c] = FOLD ? wK[lk * R_LD + px * 4 + c]
                      : scale * wK[lk * R_LD + px * 4 + c];
        kn[c] = sKt[(px * 4 + c) * BT + lk];
        dot = fmaf(dkn[c], kn[c], dot);
      }
      dot = row_sum8(dot);
      const float rk = sRk[lk];
      if (key < N) {
        store4(dk_b + dk.off(key), rk * (dkn[0] - kn[0] * dot),
               rk * (dkn[1] - kn[1] * dot), rk * (dkn[2] - kn[2] * dot),
               rk * (dkn[3] - kn[3] * dot));
        const float* av = &wV[lk * R_LD + px * 4];
        store4(dv_b + dv.off(key), av[0], av[1], av[2], av[3]);
        if (!RB && px == 0) dls += dot;  // the 8 lanes of a key: one dot
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    dls += __shfl_xor_sync(0xffffffffu, dls, off);
  __syncthreads();
  if ((tid & 31) == 0) sRed[tid >> 5] = dls;
  __syncthreads();
  if (tid == 0) {
    const double tot = sRed[0] + sRed[1] + sRed[2] + sRed[3];
    dls_part[((size_t)blockIdx.z * gridDim.x + blockIdx.x) * nH + h] =
        ls < LN100 ? tot : 0.0;
  }
}

// The operands' (window, head, token) layout, on the host.
template <template <typename> class L, typename T>
struct Operands {
  L<const T> q, k, v, g;
  L<T> dq, dk, dv;
  bool aligned() const {
    return rows_aligned(q) && rows_aligned(k) && rows_aligned(v) &&
           rows_aligned(g) && rows_aligned(dq) && rows_aligned(dk) &&
           rows_aligned(dv);
  }
};

template <template <typename> class L, typename T, typename TB,
          bool FASTEXP, int MXU, bool LO>
int launch(const Operands<L, T>& o, const void* ls, const void* bias,
           const void* mask, const void* lse, const float* lse_lo,
           void* delta, void* dls_part, void* dbias, int B_, int N, int nH,
           int nW, int dbias_mode, cudaStream_t stream) {
  if (!o.aligned()) return -1;
  const int nT = (N + BT - 1) / BT;
  const int dq_bytes = DQ_SMEM_FLOATS * (int)sizeof(float);
  const int dkv_bytes = DKV_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<L, T, TB, FASTEXP, MXU, LO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkv_kernel<L, T, TB, FASTEXP, MXU, LO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;

  dim3 grid(nT, nH, B_);
  bwd_dq_kernel<L, T, TB, FASTEXP, MXU, LO><<<grid, NT, dq_bytes, stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, lse_lo, o.dq, (float*)delta, N,
      nW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  bwd_dkv_kernel<L, T, TB, FASTEXP, MXU, LO>
      <<<grid, NT, dkv_bytes, stream>>>(
          o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
          (const TB*)mask, (const float*)lse, lse_lo, (const float*)delta,
          o.dk, o.dv, (double*)dls_part,
          dbias_mode == 1 ? (float*)dbias : nullptr, N, nW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the windows-innermost dbias pass serves the packed and head-split
  // layouts (MMDE_ATTN_GRID=split); the slab entry sums dbias by atomics
  if constexpr (std::is_same<L<T>, Rows<T>>::value) {
    if (dbias_mode != 2) return (int)err;
    dim3 grid_b(nT, nT, nH);
    bwd_dbias_kernel<L, T, TB, FASTEXP, MXU, LO><<<grid_b, NT, 0, stream>>>(
        o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
        (const TB*)mask, (const float*)lse, lse_lo, (const float*)delta,
        (float*)dbias, B_, N, nW);
    err = cudaGetLastError();
  }
  return (int)err;
}

// K5's two passes (and, with dbias_mode = 2, K3's pass at one window) on
// the packed layout, W windows per block of the dq and dk/dv passes.
template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_w(const Operands<Rows, T>& o, const void* ls, const void* bias,
             const void* mask, const void* lse, void* delta, void* dls_part,
             void* dbias, int B_, int N, int nH, int nW, int dbias_mode,
             int W, cudaStream_t stream) {
  if (!o.aligned()) return -1;
  if (W < 2 || B_ % W != 0) return -1;
  const int nT = (N + BT - 1) / BT;
  const long long dq_bytes =
      (long long)(DQW_BASE_FLOATS + (long long)W * DQW_WIN_FLOATS) * 4;
  const long long dkv_bytes =
      (long long)(DKVW_BASE_FLOATS + (long long)W * DKVW_WIN_FLOATS) * 4;
  if (dq_bytes > (1ll << 30) || dkv_bytes > (1ll << 30)) return -1;
  // more windows than the shared memory holds: the attribute is refused
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_w_kernel<T, TB, FASTEXP, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dkv_w_kernel<T, TB, FASTEXP, MXU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_bytes);
  if (err != cudaSuccess) return (int)err;

  dim3 grid(nT, nH, B_ / W);
  // F3: lse is (2, B_, nH, N), hi then lo
  const float* lo = (const float*)lse + (size_t)B_ * nH * N;
  bwd_dq_w_kernel<T, TB, FASTEXP, MXU><<<grid, NT, (int)dq_bytes, stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, lo, o.dq, (float*)delta, N, nW, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  bwd_dkv_w_kernel<T, TB, FASTEXP, MXU>
      <<<grid, NT, (int)dkv_bytes, stream>>>(
          o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
          (const TB*)mask, (const float*)lse, lo, (const float*)delta,
          o.dk, o.dv, (double*)dls_part,
          dbias_mode == 1 ? (float*)dbias : nullptr, N, nW, W);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias_mode != 2) return (int)err;

  dim3 grid_b(nT, nT, nH);
  bwd_dbias_kernel<Rows, T, TB, FASTEXP, MXU, true>
      <<<grid_b, NT, 0, stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias, (const TB*)mask,
      (const float*)lse, lo, (const float*)delta, (float*)dbias, B_, N, nW);
  return (int)cudaGetLastError();
}

template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_packed_w(const void* qkv, const void* g, const void* ls,
                    const void* bias, const void* mask, const void* lse,
                    void* dqkv, void* delta, void* dls_part, void* dbias,
                    int B_, int N, int nH, int nW, int dbias_mode, int W,
                    cudaStream_t stream) {
  const int C = nH * DH;
  Operands<Rows, T> o;
  o.q = packed_rows((const T*)qkv, 0, N, C, 3, DH);
  o.k = packed_rows((const T*)qkv, 1, N, C, 3, DH);
  o.v = packed_rows((const T*)qkv, 2, N, C, 3, DH);
  o.g = packed_rows((const T*)g, 0, N, C, 1, DH);
  o.dq = packed_rows((T*)dqkv, 0, N, C, 3, DH);
  o.dk = packed_rows((T*)dqkv, 1, N, C, 3, DH);
  o.dv = packed_rows((T*)dqkv, 2, N, C, 3, DH);
  return launch_w<T, TB, FASTEXP, MXU>(o, ls, bias, mask, lse, delta,
                                       dls_part, dbias, B_, N, nH, nW,
                                       dbias_mode, W, stream);
}

// K3 alone on the packed layout, after the tensor-core passes
// (window_attention_bwd_tc.cu) wrote delta
template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_dbias(const void* qkv, const void* g, const void* ls,
                 const void* bias, const void* mask, const void* lse,
                 const void* delta, void* dbias, int B_, int N, int nH,
                 int nW, int lse_pair, cudaStream_t stream) {
  const int C = nH * DH;
  const Rows<const T> q = packed_rows((const T*)qkv, 0, N, C, 3, DH);
  const Rows<const T> k = packed_rows((const T*)qkv, 1, N, C, 3, DH);
  const Rows<const T> v = packed_rows((const T*)qkv, 2, N, C, 3, DH);
  const Rows<const T> gg = packed_rows((const T*)g, 0, N, C, 1, DH);
  if (!rows_aligned(q) || !rows_aligned(k) || !rows_aligned(v) ||
      !rows_aligned(gg))
    return -1;
  const int nT = (N + BT - 1) / BT;
  dim3 grid(nT, nT, nH);
  if (lse_pair)   // F3: (2, B_, nH, N), hi then lo
    bwd_dbias_kernel<Rows, T, TB, FASTEXP, MXU, true><<<grid, NT, 0, stream>>>(q, k, v, gg, (const float*)ls, (const TB*)bias, (const TB*)mask, (const float*)lse, (const float*)lse + (size_t)B_ * nH * N, (const float*)delta, (float*)dbias, B_, N, nW);
  else
    bwd_dbias_kernel<Rows, T, TB, FASTEXP, MXU, false><<<grid, NT, 0, stream>>>(q, k, v, gg, (const float*)ls, (const TB*)bias, (const TB*)mask, (const float*)lse, nullptr, (const float*)delta, (float*)dbias, B_, N, nW);
  return (int)cudaGetLastError();
}

enum Layout { PACKED, STRIDED, MAP };

// PACKED: q = qkv (B_, N, 3C), g (B_, N, C), dq = dqkv (B_, N, 3C), each by
// column block. STRIDED: q, k, v, g at their own bases with the twelve host
// strides `st` (q, k, v, g: window, head, token) and contiguous
// (B_, nH, N, DH) dq, dk, dv. MAP: as PACKED on (B, Hp, Wp, 3C) / (.., C)
// maps, `st` = {Hp, Wp, ws}. Only PACKED takes a precision mode other than
// MXU_FP32 (as in the forward), so only the MXU_FP32 instantiation holds
// the other two.
template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_layout(Layout layout, const void* q, const void* k,
                  const void* v, const void* g, const long long* st,
                  const void* ls, const void* bias, const void* mask,
                  const void* lse, void* dq, void* dk, void* dv, void* delta,
                  void* dls_part, void* dbias, int B_, int N, int nH, int nW,
                  int dbias_mode, cudaStream_t stream) {
  const int C = nH * DH;
  if (layout == MAP) {
    if constexpr (MXU != MXU_FP32) {
      return -1;
    } else {
      const int Hp = (int)st[0], Wp = (int)st[1], ws = (int)st[2];
      Operands<MapRows, T> m;
      m.q = map_rows((const T*)q, 0, C, 3, Hp, Wp, ws, DH);
      m.k = map_rows((const T*)q, 1, C, 3, Hp, Wp, ws, DH);
      m.v = map_rows((const T*)q, 2, C, 3, Hp, Wp, ws, DH);
      m.g = map_rows((const T*)g, 0, C, 1, Hp, Wp, ws, DH);
      m.dq = map_rows((T*)dq, 0, C, 3, Hp, Wp, ws, DH);
      m.dk = map_rows((T*)dq, 1, C, 3, Hp, Wp, ws, DH);
      m.dv = map_rows((T*)dq, 2, C, 3, Hp, Wp, ws, DH);
      // F3: lse is (2, B_, nH, N), hi then lo
      return launch<MapRows, T, TB, FASTEXP, MXU, true>(
          m, ls, bias, mask, lse, (const float*)lse + (size_t)B_ * nH * N,
          delta, dls_part, dbias, B_, N, nH, nW, dbias_mode, stream);
    }
  } else {
    Operands<Rows, T> o;
    if (layout == PACKED) {
      o.q = packed_rows((const T*)q, 0, N, C, 3, DH);
      o.k = packed_rows((const T*)q, 1, N, C, 3, DH);
      o.v = packed_rows((const T*)q, 2, N, C, 3, DH);
      o.g = packed_rows((const T*)g, 0, N, C, 1, DH);
      o.dq = packed_rows((T*)dq, 0, N, C, 3, DH);
      o.dk = packed_rows((T*)dq, 1, N, C, 3, DH);
      o.dv = packed_rows((T*)dq, 2, N, C, 3, DH);
      // F3: lse is (2, B_, nH, N), hi then lo
      return launch<Rows, T, TB, FASTEXP, MXU, true>(
          o, ls, bias, mask, lse, (const float*)lse + (size_t)B_ * nH * N,
          delta, dls_part, dbias, B_, N, nH, nW, dbias_mode, stream);
    }
    if constexpr (MXU != MXU_FP32) {
      return -1;
    } else {
      if (layout != STRIDED) return -1;
      o.q = {(const T*)q, st[0], st[1], st[2]};
      o.k = {(const T*)k, st[3], st[4], st[5]};
      o.v = {(const T*)v, st[6], st[7], st[8]};
      o.g = {(const T*)g, st[9], st[10], st[11]};
      o.dq = contiguous_rows((T*)dq, nH, N, DH);
      o.dk = contiguous_rows((T*)dk, nH, N, DH);
      o.dv = contiguous_rows((T*)dv, nH, N, DH);
      // F3: lse is (2, B_, nH, N), hi then lo
      return launch<Rows, T, TB, FASTEXP, MXU, true>(
          o, ls, bias, mask, lse, (const float*)lse + (size_t)B_ * nH * N,
          delta, dls_part, dbias, B_, N, nH, nW, dbias_mode, stream);
    }
  }
}

template <int MXU>
int dispatch(Layout layout, const void* q, const void* k, const void* v,
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
    return launch_layout<float, float, false, MXU>(
        layout, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  if (qkv_bf16 && bias_bf16)
    return launch_layout<__nv_bfloat16, __nv_bfloat16, true, MXU>(
        layout, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  if (qkv_bf16 && !bias_bf16)
    return launch_layout<__nv_bfloat16, float, true, MXU>(
        layout, q, k, v, g, st, ls, bias, mask, lse, dq, dk, dv, delta,
        dls_part, dbias, B_, N, nH, nW, dbias_mode, s);
  return -1;
}

}  // namespace

// Plain C entry. Pointers are device pointers. qkv (B_, N, 3C), g (B_, N, C)
// and dqkv (B_, N, 3C) share an element type (qkv_bf16: 0 = fp32); bias
// (nH, N, N) and mask (nW, N, N; may be null) share one (bias_bf16); fp32
// qkv requires fp32 bias. lse (2, B_, nH, N) fp32 comes from the forward
// kernel, hi then lo (F3); delta (B_, nH, N) fp32 and dls_part (B_ * ceil(N / 64), nH) fp64
// are scratch and output (the caller sums dls_part over its first axis).
// dbias (nH, N, N) fp32: dbias_mode 0 = not computed (may be null),
// 1 = added with atomics (the caller zeroes it first), 2 = written by the
// windows-innermost pass. Returns the first CUDA error of the launches, or
// -1 for arguments the kernels do not take. Launches on `stream`, does not
// synchronise, allocates nothing. The packed entries (this one and
// mmde_window_attention_bwd_w) run the bodies in precision mode `mxu`
// (MXU_FP32 / MXU_FOLD / MXU_BF16, window_attention_common.cuh; -1 for
// another code).
extern "C" int mmde_window_attention_bwd(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int dbias_mode, int mxu,
    void* stream) {
  if (C != nH * DH) return -1;
  return by_mode(mxu, [&](auto m) {
    return dispatch<decltype(m)::value>(
        PACKED, qkv, nullptr, nullptr, g, nullptr, logit_scale, bias, mask,
        lse, dqkv, nullptr, nullptr, delta, dls_part, dbias, B_, N, nH, nW,
        qkv_bf16, bias_bf16, dbias_mode, stream);
  });
}

// K3's pass alone (MMDE_ATTN_GRID=split behind the tensor-core passes of
// window_attention_bwd_tc.cu, which write delta): dbias (nH, N, N) fp32,
// every element written once. lse_pair: lse is (2, B_, nH, N), hi then lo
// (F3: the fp32 tensor-core forward's), else (B_, nH, N) (the bf16 one's).
// The other arguments as for mmde_window_attention_bwd; delta as the
// tensor-core passes leave it.
extern "C" int mmde_window_attention_dbias(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, const void* delta,
    void* dbias, int B_, int N, int C, int nH, int nW, int qkv_bf16,
    int bias_bf16, int lse_pair, int mxu, void* stream) {
  if (C != nH * DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535 ||
      dbias == nullptr)
    return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if (!qkv_bf16 && !bias_bf16)
      return launch_dbias<float, float, false, MXU>(
          qkv, g, logit_scale, bias, mask, lse, delta, dbias, B_, N, nH, nW,
          lse_pair, s);
    if (qkv_bf16 && bias_bf16)
      return launch_dbias<__nv_bfloat16, __nv_bfloat16, true, MXU>(
          qkv, g, logit_scale, bias, mask, lse, delta, dbias, B_, N, nH, nW,
          lse_pair, s);
    if (qkv_bf16 && !bias_bf16)
      return launch_dbias<__nv_bfloat16, float, true, MXU>(
          qkv, g, logit_scale, bias, mask, lse, delta, dbias, B_, N, nH, nW,
          lse_pair, s);
    return -1;
  });
}

// Head-split entry (K7's counterpart): q, k, v and g (B_, nH, N, 32) of one
// element type, each at its own base with the strides `strides` gives, a
// host array of twelve: q, k, v, g, each (window, head, token), in
// elements; the channel axis is unit-stride and every row 16-byte aligned.
// dq, dk, dv: contiguous (B_, nH, N, 32) of that type. lse is (2, B_, nH,
// N) fp32, each row's log-sum-exp as hi and lo, as
// mmde_window_attention_headsplit_fwd_stats writes it (F3). The other
// arguments as for mmde_window_attention_bwd.
extern "C" int mmde_window_attention_headsplit_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* strides, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int nH, int nW,
    int qkv_bf16, int bias_bf16, int dbias_mode, void* stream) {
  if (strides == nullptr) return -1;
  return dispatch<MXU_FP32>(STRIDED, q, k, v, g, (const long long*)strides,
                            logit_scale, bias, mask, lse, dq, dk, dv, delta,
                            dls_part, dbias, B_, N, nH, nW, qkv_bf16,
                            bias_bf16, dbias_mode, stream);
}

// Slab entry (K9's counterpart): qkv (B, Hp, Wp, 3C), g (B, Hp, Wp, C) and
// dqkv (B, Hp, Wp, 3C) maps of one element type, Hp and Wp multiples of ws;
// the B * (Hp/ws) * (Wp/ws) windows image-major and row-major, N = ws*ws.
// lse is (2, B * nW, nH, N), hi and lo, as
// mmde_window_attention_slab_fwd_stats writes it (F3); delta (B * nW, nH, N)
// in that window order, dls_part
// (B * nW * ceil(N / 64), nH); a mask (nW, N, N) holds one row per window of
// an image (nW = (Hp/ws) * (Wp/ws)). dbias_mode 0 or 1 (atomics); the other
// arguments as for mmde_window_attention_bwd.
extern "C" int mmde_window_attention_slab_bwd(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B, int Hp, int Wp, int C,
    int nH, int ws, int qkv_bf16, int bias_bf16, int dbias_mode,
    void* stream) {
  if (C != nH * DH || B <= 0 || ws <= 0 || Hp <= 0 || Wp <= 0 ||
      Hp % ws != 0 || Wp % ws != 0)
    return -1;
  const long long N = (long long)ws * ws;
  const long long nW = (long long)(Hp / ws) * (Wp / ws);
  if (N * ws >= (1ll << 32) || (long long)B * nW > 65535) return -1;
  if (dbias_mode == 2) return -1;     // no windows-innermost pass for maps
  const long long geom[3] = {Hp, Wp, ws};
  return dispatch<MXU_FP32>(MAP, qkv, nullptr, nullptr, g, geom,
                            logit_scale, bias, mask, lse, dqkv, nullptr,
                            nullptr, delta, dls_part, dbias, (int)(B * nW),
                            (int)N, nH, (int)nW, qkv_bf16, bias_bf16,
                            dbias_mode, stream);
}

// K5's entry: as mmde_window_attention_bwd, with W (>= 2, dividing B_)
// consecutive windows per block of the dq and dk/dv passes; dls_part is
// (B_ / W * ceil(N / 64), nH). Returns the attribute's error when W windows'
// accumulators do not fit in a block's shared memory (W > 8).
extern "C" int mmde_window_attention_bwd_w(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int dbias_mode, int W, int mxu,
    void* stream) {
  if (C != nH * DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  if (dbias_mode < 0 || dbias_mode > 2) return -1;
  if (dbias_mode != 0 && dbias == nullptr) return -1;
  if (W < 2 || B_ % W != 0 || B_ / W > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if (!qkv_bf16 && !bias_bf16)
      return launch_packed_w<float, float, false, MXU>(
          qkv, g, logit_scale, bias, mask, lse, dqkv, delta, dls_part, dbias,
          B_, N, nH, nW, dbias_mode, W, s);
    if (qkv_bf16 && bias_bf16)
      return launch_packed_w<__nv_bfloat16, __nv_bfloat16, true, MXU>(
          qkv, g, logit_scale, bias, mask, lse, dqkv, delta, dls_part, dbias,
          B_, N, nH, nW, dbias_mode, W, s);
    if (qkv_bf16 && !bias_bf16)
      return launch_packed_w<__nv_bfloat16, float, true, MXU>(
          qkv, g, logit_scale, bias, mask, lse, dqkv, delta, dls_part, dbias,
          B_, N, nH, nW, dbias_mode, W, s);
    return -1;
  });
}
