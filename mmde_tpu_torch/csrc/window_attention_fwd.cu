// Fused SwinV2 cosine window attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels, one kernel body here:
//   K1  mmde_tpu/ops/window_attention_packed.py::_fwd_body (driven by
//       _pallas_forward), on qkv as the Linear emits it;
//   K6  mmde_tpu/ops/window_attention_pallas.py::_kernel (driven by
//       _pallas_forward), on head-split q, k, v (B_, nH, N, Dh);
//   K8  mmde_tpu/ops/window_attention_slab.py::_fwd_body (driven by
//       _pallas_forward), on the (B, Hp, Wp, 3C) map, windows read in place;
// and, in a kernel of its own (window_attention_fwd_w_kernel), K5: K1's
// w > 1 path (the same _fwd_body with W windows per grid cell, which
// MMDE_ATTN_W selects through _choose_w). Same function, re-tiled for a GPU:
//
//   per (window b, head h):
//     q^ = q * rsqrt(sum(q^2) + 1e-12),  k^ likewise            (fp32)
//     s  = exp(min(logit_scale[h], ln 100)) * q^ k^T
//          + bias[h] + mask[b % nW]
//     o  = softmax(s) v
//
// q, k, v and the output are layout structs (window_attention_common.cuh),
// a template parameter of the kernel. The packed entry points read qkv
// exactly as the Linear layer emits it, (B_, N, 3C) with the head's 32
// channels at column  part*C + h*32, and write (B_, N, C); the head-split
// entry points take the strides of the caller's (B_, nH, N, 32) views (the
// model's permuted view of that same qkv: no copy) and write a contiguous
// (B_, nH, N, 32). On a GPU the TPU's head-split layout is only a matter of
// strides. The slab entry points read q, k, v straight off the padded,
// rolled (B, Hp, Wp, 3C) map and write the (B, Hp, Wp, C) map: no window
// partition before the kernel and no reverse after it. The TPU slab
// kernel's grid (nG, B, nwh), its static sublane slices and in-kernel
// reshapes are Mosaic workarounds with no counterpart here; on a GPU the
// map layout is only another address per token row (MapRows). bias is
// plain (nH, N, N), mask plain (nW, N, N); the ragged edge
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
// uniform over a block. The head-split and slab entry points always pass
// maxfree = 0: the TPU kernels they replace take the row maximum for every
// head.
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
// load and take the same path, far from their bound. The port's packed
// launches, bf16 and fp32 (K1, and K5 at W > 1; fp32 operands in three bf16
// pieces), run window_attention_fwd_tc.cu instead (bf16 mma.sync), and so
// do the head-split and slab launches of either type; this body is the
// tensor-core kernels' same-card comparison (the wrappers' private `_fma`).
//
// Precision modes (MXU, window_attention_common.cuh; the JAX package's
// `mxu`): the packed bodies (K1, K5) are templates over it, and their C
// entries take it as an argument. "fold" multiplies q^ by the scale before the
// product; "bf16" also rounds q^*scale, k^, p and v to bf16 where the TPU
// body casts them (p after the row sums took it, before the product);
// MXU_FOLD_PV (T2's v4) rounds p and v only. The head-split and slab
// entries take no mode, as the TPU kernels they replace.
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

// L: the operands' layout (Rows, MapRows); T: q / k / v / out element
// type; TB: bias / mask element type; MXU: the body's precision mode
// (window_attention_common.cuh).
template <template <typename> class L, typename T, typename TB, bool FASTEXP,
          int MXU>
__global__ void __launch_bounds__(NT)
window_attention_fwd_kernel(L<const T> q, L<const T> k, L<const T> v,
                            const float* __restrict__ logit_scale,
                            const TB* __restrict__ bias,
                            const TB* __restrict__ mask, L<T> out,
                            float* __restrict__ lse,
                            float* __restrict__ lse_lo, int N, int nW,
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
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RQK = MXU == MXU_BF16;     // bf16 operands of q^ k^T
  constexpr bool RPV = MXU == MXU_BF16 || MXU == MXU_FOLD_PV;  // of p v
  // A mode that rounds p rounds exp(s - m) against the row's exact maximum,
  // as the TPU body does with the whole key row at hand (a running maximum
  // would round other numbers): pass 0 sweeps the logits alone for it, and
  // pass 1 then runs with that fixed shift, without rescaling o.
  const bool max_first = RPV && !mf;
  const bool fixed = mf || max_first;

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
      load_row(q_bh + q.off(r), x);
      normalise(x);
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) x[d] = 0.0f;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d)
      sQt[d * BQ + tid] = rnd<RQK>(FOLD ? x[d] * scale : x[d]);
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
  const L<const T> kv = is_k ? k : v;

  for (int pass = max_first ? 0 : 1; pass < 2; ++pass)
  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous step's reads of sKt / sV / sP are done
    {
      float x[DH];
      const int j = tid & (BK - 1);
      const int r = k0 + j;
      if (r < N) {
        load_row(kv_bh + kv.off(r), x);
      } else {
#pragma unroll
        for (int d = 0; d < DH; ++d) x[d] = 0.0f;
      }
      if (is_k) {
        normalise(x);
#pragma unroll
        for (int d = 0; d < DH; ++d) sKt[d * BK + j] = rnd<RQK>(x[d]);
      } else {
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          store4(&sV[j * V_LD + d], rnd<RPV>(x[d]), rnd<RPV>(x[d + 1]),
                 rnd<RPV>(x[d + 2]), rnd<RPV>(x[d + 3]));
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
          logit = FOLD ? s[i][j] + ldf(bias_h, idx)
                       : fmaf(s[i][j], scale, ldf(bias_h, idx));
          if (mask_w != nullptr) logit += ldf(mask_w, idx);
        }
        s[i][j] = logit;
      }
      if (pass == 0) {  // the row maximum alone
        float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        m_run[i] = fmaxf(m_run[i], tmax);
        continue;
      }
      float p[4];
      if (fixed) {
        const float sh = mf ? shift : m_run[i];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = exp_<FASTEXP>(s[i][j] - sh);  // exp(-inf) = 0 past the edge
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
      // the row sums above take p as it is, the product its operand
      store4(&sP[(ty * 8 + i) * P_LD + tx * 4], rnd<RPV>(p[0]),
             rnd<RPV>(p[1]), rnd<RPV>(p[2]), rnd<RPV>(p[3]));
    }
    if (pass == 0) continue;
    __syncthreads();

    // ---- o += p v ----
    if (!fixed) {
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
  // form: p = exp(s - lse), lse = shift-or-maximum + log(row sum). With
  // lse_lo (every entry, F3) m + log(l) is formed in
  // fp64 and kept as fp32 hi + lo, so that p = exp((s - hi) - lo) carries
  // no rounding of lse ~ 60 into a whole row.
  if (lse != nullptr && tid < BQ && q0 + tid < N) {
    const size_t i = ((size_t)b * gridDim.y + h) * N + q0 + tid;
    const double x = (double)sM[tid] + log((double)sL[tid]);
    const float hi = (float)x;
    lse[i] = hi;
    lse_lo[i] = (float)(x - (double)hi);
  }

  T* out_b = out.head(b, h) + px * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = py + 16 * r;
    const int row = q0 + lr;
    if (row < N) {
      const float den = sL[lr];  // > 0: see the note on the softmax
      store4(out_b + out.off(row), o[r][0] / den, o[r][1] / den,
             o[r][2] / den, o[r][3] / den);
    }
  }
}

// K5: W consecutive windows per block (W divides B_). The block owns one
// (query tile, head) of its W windows and walks the key tiles outermost;
// each step stages the 64 x 64 bias tile once, in fp32 shared memory, and
// runs the W windows' tile products against it. What a window carries from
// one key tile to the next - its q^ tile, output accumulator, row maximum
// and row sum - lives in shared memory, one slot per window; K and V of
// each (key tile, window) stream through the staging K1 uses. Same
// function, same softmax forms and log-sum-exp as K1; the row sums are
// reduced per key tile instead of once at the end.
constexpr int W_BASE_FLOATS = DH * BK + BK * V_LD + 2 * BQ * P_LD + BQ;
constexpr int W_WIN_FLOATS = DH * BQ + BQ * V_LD + 2 * BQ;

template <typename T, typename TB, bool FASTEXP, int MXU>
__global__ void __launch_bounds__(NT)
window_attention_fwd_w_kernel(Rows<const T> q, Rows<const T> k,
                              Rows<const T> v,
                              const float* __restrict__ logit_scale,
                              const TB* __restrict__ bias,
                              const TB* __restrict__ mask, Rows<T> out,
                              float* __restrict__ lse,
                              float* __restrict__ lse_lo, int N, int nW,
                              int maxfree, int W) {
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                 // [DH][BK] k^ of one window's key tile
  float* sV = sKt + DH * BK;         // [BK][V_LD] its v
  float* sP = sV + BK * V_LD;        // [BQ][P_LD] p
  float* sB = sP + BQ * P_LD;        // [BQ][P_LD] bias tile, the W windows'
  float* sAlpha = sB + BQ * P_LD;    // [BQ]
  float* sWin = sAlpha + BQ;         // W x {q^ [DH][BQ], o [BQ][V_LD], m, l}

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * W;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], LN100));
  const float shift = scale + 16.0f;
  const bool mf = maxfree != 0 && scale <= MAXFREE_MAX_SCALE;
  constexpr bool FOLD = MXU != MXU_FP32;
  constexpr bool RQK = MXU == MXU_BF16;
  constexpr bool RPV = MXU == MXU_BF16 || MXU == MXU_FOLD_PV;
  // as in K1: with p rounded, pass 0 finds each row's exact maximum, pass 1
  // runs with it fixed
  const bool max_first = RPV && !mf;
  const bool fixed = mf || max_first;
  const int tx = tid & 15, ty = tid >> 4;
  const int px = tid & 7, py = tid >> 3;

  for (int w = 0; w < W; ++w) {
    float* wq = sWin + w * W_WIN_FLOATS;
    float* wo = wq + DH * BQ;
    float* wm = wo + BQ * V_LD;
    float* wl = wm + BQ;
    if (tid < BQ) {
      float x[DH];
      fetch_row(q.head(b0 + w, h), q, q0 + tid, N, x);  // zeros past the edge
      normalise(x);
#pragma unroll
      for (int d = 0; d < DH; ++d)
        wq[d * BQ + tid] = rnd<RQK>(FOLD ? x[d] * scale : x[d]);
      wm[tid] = mf ? shift : -INFINITY;
      wl[tid] = 0.0f;
    }
    for (int e = tid; e < BQ * V_LD; e += NT) wo[e] = 0.0f;
  }

  // threads 0..63 load key rows, 64..127 value rows
  const bool is_k = tid < BK;
  const Rows<const T> kv = is_k ? k : v;

  for (int pass = max_first ? 0 : 1; pass < 2; ++pass)
  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous key tile's reads of sB are done
    stage_bias<BQ, BK, P_LD, NT>(sB, bias_h, q0, k0, N, tid);
    for (int w = 0; w < W; ++w) {
      const int b = b0 + w;
      const float* wq = sWin + w * W_WIN_FLOATS;
      float* wo = sWin + w * W_WIN_FLOATS + DH * BQ;
      float* wm = wo + BQ * V_LD;
      float* wl = wm + BQ;
      const TB* mask_w =
          mask != nullptr ? mask + (size_t)(b % nW) * N * N : nullptr;
      __syncthreads();  // sB staged; the last window's reads of sKt/sV/sP done
      {
        float x[DH];
        const int j = tid & (BK - 1);
        fetch_row(kv.head(b, h), kv, k0 + j, N, x);
        if (is_k) {
          normalise(x);
#pragma unroll
          for (int d = 0; d < DH; ++d) sKt[d * BK + j] = rnd<RQK>(x[d]);
        } else {
#pragma unroll
          for (int d = 0; d < DH; d += 4)
            store4(&sV[j * V_LD + d], rnd<RPV>(x[d]), rnd<RPV>(x[d + 1]),
                   rnd<RPV>(x[d + 2]), rnd<RPV>(x[d + 3]));
        }
      }
      __syncthreads();

      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float4 qa =
            *reinterpret_cast<const float4*>(&wq[d * BQ + ty * 8]);
        const float4 qb =
            *reinterpret_cast<const float4*>(&wq[d * BQ + ty * 8 + 4]);
        const float4 kk =
            *reinterpret_cast<const float4*>(&sKt[d * BK + tx * 4]);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv4[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int lr = ty * 8 + i;
        const bool row_ok = q0 + lr < N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx * 4 + j;
          float logit;
          if (col >= N) {
            logit = -INFINITY;
          } else if (!row_ok) {
            logit = 0.0f;  // rows past the edge: finite filler, never stored
          } else {
            logit = FOLD ? s[i][j] + sB[lr * P_LD + tx * 4 + j]
                         : fmaf(s[i][j], scale, sB[lr * P_LD + tx * 4 + j]);
            if (mask_w != nullptr)
              logit += ldf(mask_w, (size_t)(q0 + lr) * N + col);
          }
          s[i][j] = logit;
        }
        if (pass == 0) {  // the row maximum alone (only lane tx 0 writes)
          float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int off = 8; off >= 1; off >>= 1)
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
          if (tx == 0) wm[lr] = fmaxf(wm[lr], tmax);
          continue;
        }
        float p[4];
        if (fixed) {
          const float sh = wm[lr];  // the static shift, or the row maximum
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = exp_<FASTEXP>(s[i][j] - sh);
            sum += p[j];
          }
          sum = row_sum16(sum);
          if (tx == 0) wl[lr] += sum;
        } else {
          const float m_old = wm[lr];
          float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int off = 8; off >= 1; off >>= 1)
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
          const float m_new = fmaxf(m_old, tmax);
          const float alpha = exp_<FASTEXP>(m_old - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = exp_<FASTEXP>(s[i][j] - m_new);
            sum += p[j];
          }
          sum = row_sum16(sum);
          __syncwarp();  // every lane of the row has read wm[lr]
          if (tx == 0) {
            wm[lr] = m_new;
            wl[lr] = wl[lr] * alpha + sum;
            sAlpha[lr] = alpha;
          }
        }
        store4(&sP[lr * P_LD + tx * 4], rnd<RPV>(p[0]), rnd<RPV>(p[1]),
               rnd<RPV>(p[2]), rnd<RPV>(p[3]));
      }
      if (pass == 0) continue;
      __syncthreads();

      // ---- o += p v, this window's slot ----
      float o[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(
            &wo[(py + 16 * r) * V_LD + px * 4]);
        const float a = fixed ? 1.0f : sAlpha[py + 16 * r];
        o[r][0] = t.x * a;
        o[r][1] = t.y * a;
        o[r][2] = t.z * a;
        o[r][3] = t.w * a;
      }
#pragma unroll 4
      for (int j0 = 0; j0 < BK; j0 += 4) {
        float pr[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 t = *reinterpret_cast<const float4*>(
              &sP[(py + 16 * r) * P_LD + j0]);
          pr[r][0] = t.x;
          pr[r][1] = t.y;
          pr[r][2] = t.z;
          pr[r][3] = t.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(j0 + jj) * V_LD + px * 4]);
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[r][c] = fmaf(pr[r][jj], vc[c], o[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(&wo[(py + 16 * r) * V_LD + px * 4], o[r][0], o[r][1], o[r][2],
               o[r][3]);
    }
  }
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int b = b0 + w;
    const float* wo = sWin + w * W_WIN_FLOATS + DH * BQ;
    const float* wm = wo + BQ * V_LD;
    const float* wl = wm + BQ;
    if (lse != nullptr && tid < BQ && q0 + tid < N) {   // hi + lo, as K1
      const size_t i = ((size_t)b * gridDim.y + h) * N + q0 + tid;
      const double x = (double)wm[tid] + log((double)wl[tid]);
      lse[i] = (float)x;
      lse_lo[i] = (float)(x - (double)(float)x);
    }
    T* out_b = out.head(b, h) + px * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = py + 16 * r;
      const int row = q0 + lr;
      if (row < N) {
        const float den = wl[lr];
        const float* ov = &wo[lr * V_LD + px * 4];
        store4(out_b + out.off(row), ov[0] / den, ov[1] / den, ov[2] / den,
               ov[3] / den);
      }
    }
  }
}

template <template <typename> class L, typename T, typename TB,
          bool FASTEXP, int MXU>
int launch(const L<const T>& q, const L<const T>& k, const L<const T>& v,
           const void* ls, const void* bias, const void* mask,
           const L<T>& out, void* lse, float* lse_lo, int B_, int N, int nH,
           int nW, int maxfree, cudaStream_t stream) {
  if (!rows_aligned(q) || !rows_aligned(k) || !rows_aligned(v) ||
      !rows_aligned(out))
    return -1;
  dim3 grid((N + BQ - 1) / BQ, nH, B_);
  window_attention_fwd_kernel<L, T, TB, FASTEXP, MXU>
      <<<grid, NT, 0, stream>>>(q, k, v, (const float*)ls, (const TB*)bias,
                                (const TB*)mask, out, (float*)lse, lse_lo,
                                N, nW, maxfree);
  return (int)cudaGetLastError();
}

// K5 on the packed layout: qkv (B_, N, 3C), out (B_, N, C)
template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_w(const void* qkv, const void* ls, const void* bias,
             const void* mask, void* out, void* lse, int B_, int N, int nH,
             int nW, int maxfree, int W, cudaStream_t stream) {
  const int C = nH * DH;
  const Rows<const T> rq = packed_rows((const T*)qkv, 0, N, C, 3, DH);
  const Rows<const T> rk = packed_rows((const T*)qkv, 1, N, C, 3, DH);
  const Rows<const T> rv = packed_rows((const T*)qkv, 2, N, C, 3, DH);
  const Rows<T> ro = packed_rows((T*)out, 0, N, C, 1, DH);
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(ro))
    return -1;
  const long long bytes =
      (W_BASE_FLOATS + (long long)W * W_WIN_FLOATS) * (long long)sizeof(float);
  if (bytes > (1ll << 30)) return -1;
  // more windows than the shared memory holds: the attribute is refused
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_w_kernel<T, TB, FASTEXP, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, nH, B_ / W);
  float* lo = lse != nullptr ? (float*)lse + (size_t)B_ * nH * N : nullptr;
  window_attention_fwd_w_kernel<T, TB, FASTEXP, MXU>
      <<<grid, NT, (int)bytes, stream>>>(rq, rk, rv, (const float*)ls,
                                         (const TB*)bias, (const TB*)mask, ro,
                                         (float*)lse, lo, N, nW, maxfree, W);
  return (int)cudaGetLastError();
}

enum Layout { PACKED, STRIDED, MAP };

// The operands' layout: PACKED = qkv (B_, N, 3C) and out (B_, N, C);
// STRIDED = q, k, v with the nine host strides `st` (q, k, v: window, head,
// token) and a contiguous out (B_, nH, N, DH); MAP = qkv (B, Hp, Wp, 3C) and
// out (B, Hp, Wp, C), `st` = {Hp, Wp, ws}. Only PACKED takes a precision
// mode other than MXU_FP32 (the TPU's head-split and slab kernels have
// none), so only the MXU_FP32 instantiation holds the other two.
template <typename T, typename TB, bool FASTEXP, int MXU>
int launch_layout(Layout layout, const void* q, const void* k,
                  const void* v, const long long* st, const void* ls,
                  const void* bias, const void* mask, void* out, void* lse,
                  int B_, int N, int nH, int nW, int maxfree,
                  cudaStream_t stream) {
  const int C = nH * DH;
  // F3: every entry's lse is (2, B_, nH, N), hi then lo
  float* lo = lse != nullptr ? (float*)lse + (size_t)B_ * nH * N : nullptr;
  if (layout == PACKED)
    return launch<Rows, T, TB, FASTEXP, MXU>(
        packed_rows((const T*)q, 0, N, C, 3, DH),
        packed_rows((const T*)q, 1, N, C, 3, DH),
        packed_rows((const T*)q, 2, N, C, 3, DH), ls, bias, mask,
        packed_rows((T*)out, 0, N, C, 1, DH), lse, lo, B_, N, nH, nW,
        maxfree, stream);
  if constexpr (MXU != MXU_FP32) {
    return -1;
  } else {
    if (layout == MAP) {
      const int Hp = (int)st[0], Wp = (int)st[1], ws = (int)st[2];
      return launch<MapRows, T, TB, FASTEXP, MXU>(
          map_rows((const T*)q, 0, C, 3, Hp, Wp, ws, DH),
          map_rows((const T*)q, 1, C, 3, Hp, Wp, ws, DH),
          map_rows((const T*)q, 2, C, 3, Hp, Wp, ws, DH), ls, bias, mask,
          map_rows((T*)out, 0, C, 1, Hp, Wp, ws, DH), lse, lo, B_, N, nH, nW,
          maxfree, stream);
    }
    const Rows<const T> rq = {(const T*)q, st[0], st[1], st[2]};
    const Rows<const T> rk = {(const T*)k, st[3], st[4], st[5]};
    const Rows<const T> rv = {(const T*)v, st[6], st[7], st[8]};
    return launch<Rows, T, TB, FASTEXP, MXU>(
        rq, rk, rv, ls, bias, mask, contiguous_rows((T*)out, nH, N, DH), lse,
        lo, B_, N, nH, nW, maxfree, stream);
  }
}

template <int MXU>
int dispatch(Layout layout, const void* q, const void* k, const void* v,
             const long long* st, const void* ls, const void* bias,
             const void* mask, void* out, void* lse, int B_, int N, int nH,
             int nW, int qkv_bf16, int bias_bf16, int maxfree, void* stream) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || B_ > 65535 || nH > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16 && !bias_bf16)
    return launch_layout<float, float, false, MXU>(
        layout, q, k, v, st, ls, bias, mask, out, lse, B_, N, nH, nW,
        maxfree, s);
  if (qkv_bf16 && bias_bf16)
    return launch_layout<__nv_bfloat16, __nv_bfloat16, true, MXU>(
        layout, q, k, v, st, ls, bias, mask, out, lse, B_, N, nH, nW,
        maxfree, s);
  if (qkv_bf16 && !bias_bf16)
    return launch_layout<__nv_bfloat16, float, true, MXU>(
        layout, q, k, v, st, ls, bias, mask, out, lse, B_, N, nH, nW,
        maxfree, s);
  return -1;
}

}  // namespace

// Plain C entries. Pointers are device pointers; `mask` may be null (then nW
// is ignored). qkv_bf16 / bias_bf16 select the element types (0 = fp32);
// fp32 qkv requires fp32 bias. `lse` (2, B_, nH, N) fp32, when not null,
// receives each row's log-sum-exp for the backward kernel as hi then lo
// (F3: m + log(l) formed in fp64). All return
// cudaGetLastError() of the launch, or -1 for an argument combination the
// kernel does not take. They launch on `stream`, do not synchronise and
// allocate nothing. The packed entries (these two and
// mmde_window_attention_fwd_w) run the body in precision mode `mxu`
// (MXU_FP32 / MXU_FOLD / MXU_BF16, window_attention_common.cuh; -1 for
// another code).
extern "C" int mmde_window_attention_fwd_stats(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int maxfree, int mxu,
    void* stream) {
  if (C != nH * DH) return -1;
  return by_mode(mxu, [&](auto m) {
    return dispatch<decltype(m)::value>(
        PACKED, qkv, nullptr, nullptr, nullptr, logit_scale, bias, mask, out,
        lse, B_, N, nH, nW, qkv_bf16, bias_bf16, maxfree, stream);
  });
}

// The serving entry: the forward alone, no statistics.
extern "C" int mmde_window_attention_fwd(const void* qkv,
                                         const void* logit_scale,
                                         const void* bias, const void* mask,
                                         void* out, int B_, int N, int C,
                                         int nH, int nW, int qkv_bf16,
                                         int bias_bf16, int maxfree, int mxu,
                                         void* stream) {
  return mmde_window_attention_fwd_stats(qkv, logit_scale, bias, mask, out,
                                         nullptr, B_, N, C, nH, nW, qkv_bf16,
                                         bias_bf16, maxfree, mxu, stream);
}

// Head-split entries (K6's counterpart): q, k, v (B_, nH, N, 32) of one
// element type, each at its own base with the strides `strides` gives, a
// host array of nine: q, k, v, each (window, head, token), in elements; the
// channel axis is unit-stride and every row 16-byte aligned. out is a
// contiguous (B_, nH, N, 32) of the same type. Row maximum for every head.
// `lse`, when not null, is (2, B_, nH, N) fp32: each row's log-sum-exp as
// hi and lo (F3), which mmde_window_attention_headsplit_bwd reads.
extern "C" int mmde_window_attention_headsplit_fwd_stats(
    const void* q, const void* k, const void* v, const void* strides,
    const void* logit_scale, const void* bias, const void* mask, void* out,
    void* lse, int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
    void* stream) {
  if (strides == nullptr) return -1;
  return dispatch<MXU_FP32>(STRIDED, q, k, v, (const long long*)strides,
                            logit_scale, bias, mask, out, lse, B_, N, nH, nW,
                            qkv_bf16, bias_bf16, 0, stream);
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

// Slab entries (K8's counterpart): qkv is the (B, Hp, Wp, 3C) map the qkv
// Linear emits on the padded (and, for shifted blocks, rolled) feature map,
// Hp and Wp multiples of ws; out is a (B, Hp, Wp, C) map of its type. The
// kernels' windows are the B * (Hp/ws) * (Wp/ws) windows of the map, image-
// major and row-major, N = ws*ws tokens each; `lse` (when not null) is
// (2, B * nW, nH, N) in that window order, each row's log-sum-exp as hi and
// lo (F3), which mmde_window_attention_slab_bwd reads; a mask (nW, N, N)
// must hold one row per window of an image (nW = (Hp/ws) * (Wp/ws)). Row
// maximum for every head. The other arguments as for
// mmde_window_attention_fwd_stats. bf16 maps run the tensor-core entry
// (mmde_window_attention_slab_fwd_tc, window_attention_fwd_tc.cu); these
// serve fp32 maps and are its same-card comparison.
extern "C" int mmde_window_attention_slab_fwd_stats(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B, int Hp, int Wp, int C,
    int nH, int ws, int qkv_bf16, int bias_bf16, void* stream) {
  if (C != nH * DH || B <= 0 || ws <= 0 || Hp <= 0 || Wp <= 0 ||
      Hp % ws != 0 || Wp % ws != 0)
    return -1;
  const long long N = (long long)ws * ws;
  const long long nW = (long long)(Hp / ws) * (Wp / ws);
  if (N * ws >= (1ll << 32) || (long long)B * nW > 65535) return -1;
  const long long geom[3] = {Hp, Wp, ws};
  return dispatch<MXU_FP32>(MAP, qkv, nullptr, nullptr, geom, logit_scale,
                            bias, mask, out, lse, (int)(B * nW), (int)N, nH,
                            (int)nW, qkv_bf16, bias_bf16, 0, stream);
}

extern "C" int mmde_window_attention_slab_fwd(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, int B, int Hp, int Wp, int C, int nH,
    int ws, int qkv_bf16, int bias_bf16, void* stream) {
  return mmde_window_attention_slab_fwd_stats(qkv, logit_scale, bias, mask,
                                              out, nullptr, B, Hp, Wp, C, nH,
                                              ws, qkv_bf16, bias_bf16,
                                              stream);
}

// K5's entry (the JAX package's W windows per cell): as
// mmde_window_attention_fwd_stats, `lse` may be null (serving), with W
// (>= 2, dividing B_) consecutive windows per block. Returns the
// attribute's error when W windows' state does not fit in a block's shared
// memory (W > 10).
extern "C" int mmde_window_attention_fwd_w(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int maxfree, int W, int mxu,
    void* stream) {
  if (C != nH * DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  if (W < 2 || B_ % W != 0 || B_ / W > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if (!qkv_bf16 && !bias_bf16)
      return launch_w<float, float, false, MXU>(qkv, logit_scale, bias, mask,
                                                out, lse, B_, N, nH, nW,
                                                maxfree, W, s);
    if (qkv_bf16 && bias_bf16)
      return launch_w<__nv_bfloat16, __nv_bfloat16, true, MXU>(
          qkv, logit_scale, bias, mask, out, lse, B_, N, nH, nW, maxfree, W,
          s);
    if (qkv_bf16 && !bias_bf16)
      return launch_w<__nv_bfloat16, float, true, MXU>(
          qkv, logit_scale, bias, mask, out, lse, B_, N, nH, nW, maxfree, W,
          s);
    return -1;
  });
}
