// Fused SwinV2 cosine window attention, forward, on Hopper's tensor cores
// (sm_90a, bf16 mma.sync), for bf16 or fp32 q, k, v: in the packed layout
// (qkv as the Linear emits it, (B_, N, 3C); out (B_, N, C)) at one window
// per block or W (fwd_tc_w_kernel, below), on head-split operands (any
// (B_, nH, N, 32) strides; out contiguous; bf16 or fp32), and on the slab
// path's (B, Hp, Wp, 3C) map (windows read in place, out the (B, Hp, Wp,
// C) map; bf16 or fp32).
//
// Replaces mmde_tpu/ops/window_attention_packed.py::_fwd_body (K1, driven by
// _pallas_forward) for every packed launch at w = 1 - the flagship's and
// swin_large's default serving and training path, in bf16 and in fp32 - and
// with w > 1 (K5, MMDE_ATTN_W), in all three precision modes; and
// mmde_tpu/ops/window_attention_pallas.py::_kernel (K6, driven by
// _pallas_forward) for every head-split launch, bf16 and fp32 (swin_large
// stage 1, swin_tiny / swin_huge stages 1-2), and
// mmde_tpu/ops/window_attention_slab.py::_fwd_body (K8, driven by
// _pallas_forward) for every slab launch, bf16 and fp32 (attn_impl
// "pallas_slab"), in those kernels' function (mode fp32, the row maximum
// for every head, fp32 bias and mask tiles). fwd_tc_kernel is a template
// over the operands' layout (window_attention_common.cuh): Rows for the
// packed and head-split entries, MapRows for the slab entry, whose token
// rows sit at (wi*ws + r/ws, wj*ws + r%ws) of the map; every row address
// goes through L::head(b, h) + L::off(r) (the map's tile loads through a
// shared table of the tile's pixels, TileRows in window_attention_tc.cuh),
// so the arithmetic is the same. It is a template over the operand type
// too: fp32 q, k, v (packed, head-split and slab) take every operand in
// three bf16 pieces (below), as K5's fp32 instantiation does, the map's
// fp32 tiles staged through the same table; window_attention_fwd.cu keeps
// the fp32-FMA body as the same-card A/B partner; the function, the
// softmax forms and the log-sum-exp handed to the backward are the same.
//
//   per (window b, head h):
//     q^ = q * rq, rq = rsqrt(sum(q^2) + 1e-12),  k^ = k * rk likewise
//     s  = scale * q^ k^T + bias[h] + mask[b % nW],  o = softmax(s) v
//
// What bounds it on an H100: the bytes are few (qkv once, out once, bias
// and mask from L2), the work is two N x N x 32 products and N^2 exps per
// (window, head): at 989 TFLOP/s bf16 it would be bound by bytes, at the
// fp32-FMA rate K1's body reaches (38.5 TFLOP/s for its tile pattern) by
// operations. This body puts both products on bf16 mma.sync (275 TFLOP/s
// for the same pattern on this card) without changing the function:
//
//   * q and k are bf16 values, and a product of two bf16 values is exact in
//     fp32; mma.sync accumulates in fp32. So S = q k^T is taken on the raw
//     values and normalised afterwards, a rank-1 fp32 epilogue on the
//     accumulator: "fold" s = S * (scale * rq_i) * rk_j, "fp32"
//     s = (S * rq_i * rk_j) * scale - q^ k^T up to fp32 rounding order.
//   * v is bf16 (exact); p is fp32, so p v runs as two products, p split
//     into bf16(p) and bf16(p - bf16(p)): what is left is ~2^-17 * p, far
//     below the output's own bf16 rounding.
//   * "bf16" mode takes the JAX body's rounded operands instead:
//     bf16(q^ * scale), bf16(k^) (k^ formed in shared memory once per key
//     tile) and bf16(p) against the exact row maximum (a logits-only sweep
//     first, as K1), each product one mma.sync.
//
// Structure: a block (4 warps) owns one (window, head, 64-query tile); each
// warp 16 query rows, whose q stays in registers as A fragments for the
// whole key loop. Key and value tiles of 64 rows (raw bf16, rows padded to
// 80 bytes) are double-buffered in shared memory by 16-byte cp.async and
// read as fragments by ldmatrix (.trans for v). The logits accumulators
// become the A fragments of p v directly: p never touches shared memory.
// Bias and mask tiles (64 x 64, the accumulators' rows and cols) come by
// 8-byte cp.async beside K and V, double-buffered too (plain loads where N
// rows are not 8-byte aligned, N = 225), and are read at each accumulator
// element's (row, col) from shared memory; fp32 tiles (the head-split
// stages) keep one mask tile, folded into the stage's bias tile on arrival
// (BiasTiles, window_attention_tc.cuh). Row maximum and row sum stay
// inside a quad (the 4 lanes that hold a row). Softmax forms as K1: the
// static shift scale + 16 for heads with scale <= 30 under maxfree, an
// online maximum otherwise (F1); the ragged edge (N = 900 = 14*64 + 4,
// N = 225 = 3*64 + 33) is masked here. Two __syncthreads a key tile: the
// tile's arrival, and its norms (and, in the bf16 mode, its rounded k^)
// being written.
//
// fp32 q, k, v (T = float): every operand in three bf16 pieces, x1 =
// bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), each product the six
// piece products whose indices sum to at most 2 (window_attention_tc.cuh;
// the "bf16" mode: one rounding, as for bf16 qkv). q stays in registers as
// A fragments in three pieces (three times the bf16 kernel's); K and V
// tiles arrive in fp32 by 16-byte cp.async into one staging buffer, and a
// split pass (warps 0-1 a K row each with its norm, warps 2-3 a V row)
// writes their pieces into bf16 planes that ldmatrix reads as it reads a
// bf16 tile; the next step's copies are issued once the split pass is done
// (one staging buffer: the planes decouple it from the products). p leaves
// the accumulators in three pieces. Each step's p v products go into fresh
// registers and are added to the running o by the CUDA cores (round to
// nearest): the tensor cores round each sum toward zero, and an o left in
// their accumulator over the key tiles would drift low. p is exp(s - m),
// the difference formed first (as the FMA body does), so that no rounding
// of the shift scales a whole row. The statistic is hi + lo, m + log(l)
// formed in fp64, (2, B_, nH, N) (F3), as the fp32 K5 forward writes it;
// the backward rebuilds p from it with the same arithmetic
// (window_attention_bwd_tc.cu).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

// fp32 operands (T = float): pieces a staged tile and q are cut into (PS),
// pieces of an operand formed in registers, p (PR); the dynamic shared
// memory they take before the bias tiles (one fp32 staging buffer of K and
// V, PS planes of each)
template <typename T, int MXU>
struct Pieces {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool RB = MXU == MXU_BF16;
  static constexpr int PS = F32 && !RB ? 3 : 1;
  static constexpr int PR = RB ? 1 : F32 ? 3 : 2;
  static constexpr int kTiles =
      F32 ? 2 * TC_STAGE_F32 * 4 + 2 * PS * TC_PLANE * 2 : 0;
};

// L: the operands' layout (Rows; MapRows for the slab entry); T: their type
template <template <typename> class L, typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT)
fwd_tc_kernel(L<const T> q, L<const T> k, L<const T> v,
              const float* __restrict__ logit_scale,
              const TB* __restrict__ bias, const TB* __restrict__ mask,
              L<T> out, float* __restrict__ lse, int N, int nW,
              int maxfree) {
  using P = Pieces<T, MXU>;
  constexpr bool F32 = P::F32;
  constexpr int PS = P::PS, PR = P::PR;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sK[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRk[2][TC_BT];
  // MapRows: the stages' tile tables (TileRows), K and V rows' pixels
  __shared__ int sTab[2][TC_BT];
  // fp32: the K / V staging and planes (Pieces::kTiles), then the stages'
  // bias (and mask) tiles: BiasTiles
  extern __shared__ __align__(128) char sBM[];

  constexpr bool RB = MXU == MXU_BF16;
  constexpr bool TAB = TileRows<L<const T>>::kTable;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, h = blockIdx.y, b = blockIdx.z;
  const T* k_bh = k.head(b, h);
  const T* v_bh = v.head(b, h);
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w = mask != nullptr ? mask + (size_t)(b % nW) * N * N
                                     : nullptr;
  float* sStg = reinterpret_cast<float*>(sBM);
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 2 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;

  const float scale = expf(fminf(logit_scale[h], TC_LN100));
  const float shift = scale + 16.0f;
  const bool mf = maxfree != 0 && scale <= TC_MAXFREE_MAX_SCALE;
  // the bf16 mode rounds p against the row's exact maximum: a first sweep
  // of the logits alone finds it
  const bool max_first = RB && !mf;
  const bool fixed = mf || max_first;
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int steps = (max_first ? 2 : 1) * nt;
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  const BiasTiles<TB> bt{sBM + P::kTiles, mask_w != nullptr};

  // step `s`'s tile table (MapRows) into stage s & 1
  auto fill = [&](int s) {
    if (s < steps)
      TileRows<L<const T>>::fill(sTab[s & 1], k, (s % nt) * TC_BT, tid);
  };
  // step `s`'s K (and V, outside the bf16 mode's first sweep), bias and
  // mask tiles into stage s & 1 (fp32: K and V into the staging)
  auto issue = [&](int s) {
    const int st = s & 1, kn = (s % nt) * TC_BT;
    if constexpr (F32) {
      load_tile_f32(sStg, k_bh, k, sTab[st], kn, N, tid);
      if (!(max_first && s < nt))
        load_tile_f32(sStg + TC_STAGE_F32, v_bh, v, sTab[st], kn, N, tid);
    } else {
      load_tile(sK[st], k_bh, k, sTab[st], kn, N, tid);
      if (!(max_first && s < nt))
        load_tile(sV[st], v_bh, v, sTab[st], kn, N, tid);
    }
    if (async_b)
      stage_bias_tiles(bt, st, bias_h, mask_w, q0, kn, N, tid, true);
    cp_async_commit();
  };
  if constexpr (TAB) {
    fill(0);
    fill(1);
    __syncthreads();
  }
  issue(0);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[PS][2][4];
  float rq0, rq1;
  if constexpr (F32) {
    float2 qx[2][4];
    load_afrag_f32(qx, q.head(b, h), q, r0, N, t);
    finish_operand<PS, true, RB || FQ>(qx, qa, lane, rq0, rq1, scale);
  } else {
    load_afrag(qa[0], q.head(b, h), q, r0, N, t);
    row_norms(qa[0], rq0, rq1, lane);
    if constexpr (RB) scale_afrag(qa[0], rq0, rq1, scale);
  }
  // the rank-1 epilogue's row factor (fp32 mode: scale applied last)
  const float c0 = FQ ? 1.0f : MXU == MXU_FP32 ? rq0 : rq0 * scale;
  const float c1 = FQ ? 1.0f : MXU == MXU_FP32 ? rq1 : rq1 * scale;
  const bool ok0 = r0 < N, ok1 = r1 < N;

  float m0 = mf ? shift : -INFINITY, m1 = m0;
  float l0 = 0.0f, l1 = 0.0f;
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    const int k0 = (step % nt) * TC_BT;
    const bool sweep = max_first && step < nt;  // the logits-only sweep
    cp_async_wait_all();
    __syncthreads();  // tile `step` arrived; every warp left step - 1
    if constexpr (!F32) {
      if (step + 1 < steps && !bt.fold()) issue(step + 1);
    }
    const char* tb = bt.bias(st);
    const char* tm = bt.mask(st);
    if (!async_b)
      stage_bias_tiles(bt, st, bias_h, mask_w, q0, k0, N, tid, false);
    else if (bt.fold())
      fold_mask(bt, st, tid);
    if constexpr (F32) {
      // the split pass: warps 0-1 a K row each (its norm; "bf16": k^
      // rounded), warps 2-3 a V row (outside the logits-only sweep)
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      if (tid < TC_BT) {
        staged_row(sStg, r, x);
        const float rn = row_rnorm(x);
        sRk[st][r] = rn;
        put_row<PS, RB>(sKp, r, x, rn, 1.0f);
      } else if (!sweep) {
        staged_row(sStg + TC_STAGE_F32, r, x);
        put_row<PS, false>(sVp, r, x, 1.0f, 1.0f);
      }
    } else {
      // k^'s norms (the bf16 mode: k^ rounded in place; its second sweep
      // reloads the raw tile and rounds it again)
      tile_norms<RB>(sK[st], sRk[st], 1.0f, tid);
    }
    __syncthreads();
    if constexpr (F32) {
      // the next step's copies wait for the split pass (one staging
      // buffer), as they wait for the fold where the tiles fold
      if (step + 1 < steps) issue(step + 1);
    } else {
      if (step + 1 < steps && bt.fold()) issue(step + 1);
    }
    // stage st's table is free again (issue(step) read it before this
    // step's first barrier); issue(step + 2) reads it after the next one
    if constexpr (TAB) fill(step + 2);

    // ---- S = q k^T (raw or rounded operands), the epilogue ----
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      if constexpr (F32) {
        uint32_t kb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(kb[p], sKp + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(s[j], qa, kb);
      } else {
        uint32_t kb[4];
        frag_rows(kb, sK[st], j, lane);
        mma(s[j], qa[0][0], kb[0], kb[1]);
        mma(s[j], qa[0][1], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * t;       // tile column of elements 0 / 2
      const int col = k0 + cl;
      const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = warp * 16 + (lane >> 2) + 8 * half;   // tile row
        const float c = half ? c1 : c0;
        float* x = &s[j][2 * half];
        if (col >= N || !(half ? ok1 : ok0)) {
          // past the edge: keys -inf (p = 0), rows a finite filler
          x[0] = col < N ? 0.0f : -INFINITY;
          x[1] = col + 1 < N ? 0.0f : -INFINITY;
          continue;
        }
        const bool in1 = col + 1 < N;
        float2 bm = btile_pair(tb, rl, cl, TB());
        if (bt.add_mask()) {
          const float2 mm = btile_pair(tm, rl, cl, TB());
          bm.x += mm.x;
          bm.y += mm.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = x[e];
          if constexpr (MXU == MXU_FP32) y = y * c * rk[e] * scale;
          else if constexpr (MXU == MXU_FOLD) y = y * c * rk[e];
          x[e] = y + (e ? bm.y : bm.x);
        }
        if (!in1) x[1] = -INFINITY;
      }
    }

    float tm0 = -INFINITY, tm1 = -INFINITY;
    if (sweep || !fixed) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
        tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
      }
      tm0 = quad_max(tm0);
      tm1 = quad_max(tm1);
    }
    if (sweep) {
      m0 = fmaxf(m0, tm0);
      m1 = fmaxf(m1, tm1);
      continue;
    }
    float ra0 = 1.0f, ra1 = 1.0f;   // fp32: o's rescale, applied after
    if (!fixed) {   // online maximum: rescale what was summed so far
      const float n0 = fmaxf(m0, tm0), n1 = fmaxf(m1, tm1);
      const float a0 = ex2((m0 - n0) * TC_LOG2E);
      const float a1 = ex2((m1 - n1) * TC_LOG2E);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
      if constexpr (F32) {
        ra0 = a0;
        ra1 = a1;
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[n][0] *= a0;
          o[n][1] *= a0;
          o[n][2] *= a1;
          o[n][3] *= a1;
        }
      }
    }
    if constexpr (F32) {
      // exp(s - m): the difference first, as the FMA body forms it. The
      // shift m * log2(e) rounded on its own (a number near 110 at scale
      // 60 + 16) would scale the whole row's p and its sum l alike, and
      // with them the statistic - F3's fault, which dlogit_scale's
      // cancelling sum keeps
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2((s[j][0] - m0) * TC_LOG2E);
        s[j][1] = ex2((s[j][1] - m0) * TC_LOG2E);
        s[j][2] = ex2((s[j][2] - m1) * TC_LOG2E);
        s[j][3] = ex2((s[j][3] - m1) * TC_LOG2E);
        l0 += s[j][0] + s[j][1];   // the row sums take p unrounded
        l1 += s[j][2] + s[j][3];
      }
    } else {
      const float sh0 = m0 * TC_LOG2E, sh1 = m1 * TC_LOG2E;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2(fmaf(s[j][0], TC_LOG2E, -sh0));
        s[j][1] = ex2(fmaf(s[j][1], TC_LOG2E, -sh0));
        s[j][2] = ex2(fmaf(s[j][2], TC_LOG2E, -sh1));
        s[j][3] = ex2(fmaf(s[j][3], TC_LOG2E, -sh1));
        l0 += s[j][0] + s[j][1];   // the row sums take p unrounded
        l1 += s[j][2] + s[j][3];
      }
    }

    // ---- o += p v: p from the accumulators, split (or rounded) ----
    const float one[2] = {1.0f, 1.0f};
    if constexpr (F32) {
      // this step's products in fresh registers, then o = o * rescale +
      // them on the CUDA cores
      float os[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) os[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[PR][4];
        afrag_p<PR>(s[2 * kk], s[2 * kk + 1], one, one, pa);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t vb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(vb[p], sVp + p * TC_PLANE, kk, c, lane);
          mma_cols<PR, PS>(os[2 * c], os[2 * c + 1], pa, vb);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n][0] = fmaf(o[n][0], ra0, os[n][0]);
        o[n][1] = fmaf(o[n][1], ra0, os[n][1]);
        o[n][2] = fmaf(o[n][2], ra1, os[n][2]);
        o[n][3] = fmaf(o[n][3], ra1, os[n][3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        afrag<!RB>(s[2 * kk], s[2 * kk + 1], one, one, ph, pl);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t vb[4];
          frag_cols(vb, sV[st], kk, c, lane);
          mma(o[2 * c], ph, vb[0], vb[1]);
          mma(o[2 * c + 1], ph, vb[2], vb[3]);
          if constexpr (!RB) {
            mma(o[2 * c], pl, vb[0], vb[1]);
            mma(o[2 * c + 1], pl, vb[2], vb[3]);
          }
        }
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // p = exp(s - lse) for either softmax form: the backward's statistic
  // (fp32: hi + lo, m + log(l) formed in fp64; (2, B_, nH, N))
  if (lse != nullptr && t == 0) {
    const size_t stat0 = ((size_t)b * gridDim.y + h) * N;
    if constexpr (F32) {
      float* lo = lse + (size_t)gridDim.z * gridDim.y * N;
      const double x0 = (double)m0 + log((double)l0);
      const double x1 = (double)m1 + log((double)l1);
      if (ok0) {
        lse[stat0 + r0] = (float)x0;
        lo[stat0 + r0] = (float)(x0 - (double)(float)x0);
      }
      if (ok1) {
        lse[stat0 + r1] = (float)x1;
        lo[stat0 + r1] = (float)(x1 - (double)(float)x1);
      }
    } else {
      if (ok0) lse[stat0 + r0] = m0 + logf(l0);
      if (ok1) lse[stat0 + r1] = m1 + logf(l1);
    }
  }
  T* out_bh = out.head(b, h) + 2 * t;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (ok0) store_pair(out_bh + out.off(r0) + 8 * n, o[n][0] / l0,
                        o[n][1] / l0);
    if (ok1) store_pair(out_bh + out.off(r1) + 8 * n, o[n][2] / l1,
                        o[n][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// K5: W consecutive windows per block (mmde_tpu/ops/window_attention_packed.py
// ::_fwd_body with w > 1, W from the JAX rule choose_w). The block owns one
// (64-query tile, head) of its W windows and walks the key tiles outermost,
// the windows innermost: each key tile's bias tile is staged once, by
// cp.async, for the W windows. The block is two groups of 4 warps; each
// step takes a pair of windows, one a group (windows 2p and 2p + 1; a
// group idles on an odd W's last pair), each streaming its window's K and
// V tiles and its own mask tile (window b uses b % nW; nW is a multiple of
// W, so the W masks differ) through two stages. What a window carries from
// one key tile to the next - its o accumulators and each row's m and l -
// lives in shared memory in fragment order (a lane's own float4s: no bank
// conflicts, no layout change); q comes back from L2 as A fragments each
// step, its norms recomputed by the same chain (so the same bits). Per
// window the arithmetic is fwd_tc_kernel's, step for step: same products,
// same epilogue, same online rescaling in the same key order. Why two
// groups: W windows' state (10 KB each) leaves one block an SM at W = 8,
// so the block brings twice the warps to it.
// ---------------------------------------------------------------------------
constexpr int W_MAX = 8;   // windows a block holds (W x 10 KB of state)
constexpr int W_GROUPS = 2;  // warp groups of the block, a window each

// fp32 qkv (T = float): every operand in three bf16 pieces (the "bf16"
// mode: one rounding), K and V tiles staged in fp32 and split into bf16
// planes once they arrived (window_attention_tc.cuh); the staging and the
// planes leave room for one warp group at W = 8 with fp32 bias and mask
// tiles, so an fp32 block is one group (G = 1) that walks its W windows in
// turn. Per window the arithmetic is the bf16 kernel's with split products.
template <typename T, int MXU>
struct WPieces {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool RB = MXU == MXU_BF16;
  static constexpr int PS = F32 && !RB ? 3 : 1;   // staged / loaded
  static constexpr int PR = RB ? 1 : F32 ? 3 : 2;  // formed in registers
  static constexpr int G = F32 ? 1 : W_GROUPS;     // warp groups
};

template <typename T, typename TB, int MXU>
__global__ void __launch_bounds__(WPieces<T, MXU>::G * TC_NT)
fwd_tc_w_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                const float* __restrict__ logit_scale,
                const TB* __restrict__ bias, const TB* __restrict__ mask,
                Rows<T> out, float* __restrict__ lse, int N, int nW,
                int maxfree, int W) {
  using WP = WPieces<T, MXU>;
  constexpr bool F32 = WP::F32;
  constexpr int PS = WP::PS, PR = WP::PR, G = WP::G;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sK[2][G][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][G][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRk[2][G][TC_BT];
  // dynamic: bias tiles [2] (by key tile), mask tiles [2][G] (by step and
  // group), then per window o [4 warps][4 n][32 lanes] and {m0, m1, l0,
  // l1} [4][32]; fp32: K / V staging [2 stages][2], K / V planes [PS] each
  extern __shared__ __align__(128) char sW[];
  const bool masked = mask != nullptr;
  char* sB = sW;
  char* sM = sB + 2 * btile_bytes<TB>();
  float4* sO = reinterpret_cast<float4*>(
      sM + (masked ? 2 * G : 0) * btile_bytes<TB>());
  float4* sS = sO + W * 4 * 4 * 32;
  float* sStg = reinterpret_cast<float*>(sS + W * 4 * 32);
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 4 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;

  constexpr bool RB = MXU == MXU_BF16;
  const int grp = threadIdx.x / TC_NT, tid = threadIdx.x % TC_NT;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, h = blockIdx.y, b0 = blockIdx.z * W;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], TC_LN100));
  const float shift = scale + 16.0f;
  const bool mf = maxfree != 0 && scale <= TC_MAXFREE_MAX_SCALE;
  const bool max_first = RB && !mf;
  const bool fixed = mf || max_first;
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int pairs = (W + G - 1) / G;
  const int per_pass = nt * pairs;
  const int steps = (max_first ? 2 : 1) * per_pass;
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  auto mask_tile = [&](int st) {
    return sM + (st * G + grp) * btile_bytes<TB>();
  };

  // step s = (pass, key tile, pair): the group's window's K (and V outside
  // the bf16 mode's first sweep) and mask tile -> stage s & 1; with a key
  // tile's first pair, its bias tile (group 0) -> stage (s / pairs) & 1
  auto issue = [&](int s) {
    const int st = s & 1, rr = s % per_pass, kn = (rr / pairs) * TC_BT;
    const int w = G * (rr % pairs) + grp, b = b0 + w;
    if (w < W) {
      const bool want_v = !(max_first && s < per_pass);
      if constexpr (F32) {
        load_tile_f32(sStg + 2 * st * TC_STAGE_F32, k.head(b, h), k, kn, N,
                      tid);
        if (want_v)
          load_tile_f32(sStg + (2 * st + 1) * TC_STAGE_F32, v.head(b, h), v,
                        kn, N, tid);
      } else {
        load_tile(sK[st][grp], k.head(b, h), k, kn, N, tid);
        if (want_v) load_tile(sV[st][grp], v.head(b, h), v, kn, N, tid);
      }
      if (async_b && masked)
        load_btile(mask_tile(st), mask + (size_t)(b % nW) * N * N, q0, kn,
                   N, tid, true);
    }
    if (async_b && grp == 0 && rr % pairs == 0)
      load_btile(sB + ((s / pairs) & 1) * btile_bytes<TB>(), bias_h, q0, kn,
                 N, tid, true);
    cp_async_commit();
  };
  issue(0);

  for (int i = threadIdx.x; i < W * 4 * 4 * 32; i += G * TC_NT)
    sO[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float m_init = mf ? shift : -INFINITY;
  for (int i = threadIdx.x; i < W * 4 * 32; i += G * TC_NT)
    sS[i] = make_float4(m_init, m_init, 0.0f, 0.0f);

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1, rr = step % per_pass;
    const int w = G * (rr % pairs) + grp;
    const bool active = w < W;
    const int b = b0 + (active ? w : 0), k0 = (rr / pairs) * TC_BT;
    const bool sweep = max_first && step < per_pass;  // logits-only sweep
    uint32_t qa[PS][2][4];
    float2 qx[2][4];   // fp32: the raw rows, split after the barriers
    if constexpr (F32)
      load_afrag_f32(qx, q.head(b, h), q, r0, N, t);
    else
      load_afrag(qa[0], q.head(b, h), q, r0, N, t);  // lands during the waits
    cp_async_wait_all();
    __syncthreads();  // tile `step` arrived; every warp left step - 1
    if (step + 1 < steps) issue(step + 1);
    const char* tb = sB + ((step / pairs) & 1) * btile_bytes<TB>();
    const char* tm = mask_tile(st);
    if (!async_b) {
      if (grp == 0 && rr % pairs == 0)
        load_btile(const_cast<char*>(tb), bias_h, q0, k0, N, tid, false);
      if (masked && active)
        load_btile(const_cast<char*>(tm), mask + (size_t)(b % nW) * N * N,
                   q0, k0, N, tid, false);
    }
    if constexpr (F32) {
      // the split pass: warps 0-1 a K row each (its norm; "bf16": k^
      // rounded), warps 2-3 a V row (outside the logits-only sweep)
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      if (tid < TC_BT) {
        staged_row(sStg + 2 * st * TC_STAGE_F32, r, x);
        const float rn = row_rnorm(x);
        sRk[st][0][r] = rn;
        put_row<PS, RB>(sKp, r, x, rn, 1.0f);
      } else if (!sweep) {
        staged_row(sStg + (2 * st + 1) * TC_STAGE_F32, r, x);
        put_row<PS, false>(sVp, r, x, 1.0f, 1.0f);
      }
    } else {
      if (active) tile_norms<RB>(sK[st][grp], sRk[st][grp], 1.0f, tid);
    }
    __syncthreads();
    if (!active) continue;

    float rq0, rq1;
    if constexpr (F32) {
      finish_operand<PS, true, RB || FQ>(qx, qa, lane, rq0, rq1, scale);
    } else {
      row_norms(qa[0], rq0, rq1, lane);
      if constexpr (RB) scale_afrag(qa[0], rq0, rq1, scale);
    }
    const float c0 = FQ ? 1.0f : MXU == MXU_FP32 ? rq0 : rq0 * scale;
    const float c1 = FQ ? 1.0f : MXU == MXU_FP32 ? rq1 : rq1 * scale;
    float4* so = sO + (w * 4 + warp) * 4 * 32 + lane;
    float4* ss = sS + (w * 4 + warp) * 32 + lane;
    float4 mls = *ss;
    float m0 = mls.x, m1 = mls.y, l0 = mls.z, l1 = mls.w;
    const bf16* sk = sK[st][grp];
    const bf16* sv = sV[st][grp];
    if constexpr (F32) {
      sk = sKp;
      sv = sVp;
    }
    const float* rks = sRk[st][grp];

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      uint32_t kb[PS][4];
#pragma unroll
      for (int p = 0; p < PS; ++p) frag_rows(kb[p], sk + p * TC_PLANE, j, lane);
      mma_rows<PS, PS>(s[j], qa, kb);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * t;
      const int col = k0 + cl;
      const float rk[2] = {rks[cl], rks[cl + 1]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = warp * 16 + (lane >> 2) + 8 * half;
        const float c = half ? c1 : c0;
        float* x = &s[j][2 * half];
        if (col >= N || !(half ? ok1 : ok0)) {
          x[0] = col < N ? 0.0f : -INFINITY;
          x[1] = col + 1 < N ? 0.0f : -INFINITY;
          continue;
        }
        const bool in1 = col + 1 < N;
        float2 bm = btile_pair(tb, rl, cl, TB());
        if (masked) {
          const float2 mm = btile_pair(tm, rl, cl, TB());
          bm.x += mm.x;
          bm.y += mm.y;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = x[e];
          if constexpr (MXU == MXU_FP32) y = y * c * rk[e] * scale;
          else if constexpr (MXU == MXU_FOLD) y = y * c * rk[e];
          x[e] = y + (e ? bm.y : bm.x);
        }
        if (!in1) x[1] = -INFINITY;
      }
    }

    float tm0 = -INFINITY, tm1 = -INFINITY;
    if (sweep || !fixed) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
        tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
      }
      tm0 = quad_max(tm0);
      tm1 = quad_max(tm1);
    }
    if (sweep) {
      *ss = make_float4(fmaxf(m0, tm0), fmaxf(m1, tm1), l0, l1);
      continue;
    }
    // fp32: this step's products in fresh registers, added to the
    // window's o by the CUDA cores after them (round to nearest): the tensor
    // cores round each sum toward zero, and an o kept in their accumulator
    // over the key tiles would drift low by about half an ulp a step
    float o[4][4], ra0 = 1.0f, ra1 = 1.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if constexpr (F32) {
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      } else {
        const float4 x = so[n * 32];
        o[n][0] = x.x;
        o[n][1] = x.y;
        o[n][2] = x.z;
        o[n][3] = x.w;
      }
    }
    if (!fixed) {   // online maximum: rescale what was summed so far
      const float n0 = fmaxf(m0, tm0), n1 = fmaxf(m1, tm1);
      const float a0 = ex2((m0 - n0) * TC_LOG2E);
      const float a1 = ex2((m1 - n1) * TC_LOG2E);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
      if constexpr (F32) {
        ra0 = a0;
        ra1 = a1;
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[n][0] *= a0;
          o[n][1] *= a0;
          o[n][2] *= a1;
          o[n][3] *= a1;
        }
      }
    }
    if constexpr (F32) {
      // exp(s - m), the difference first, as fwd_tc_kernel's fp32 branch
      // forms it: a shift m * log2(e) rounded on its own scales the whole
      // row's p, its sum and the statistic alike (F3)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2((s[j][0] - m0) * TC_LOG2E);
        s[j][1] = ex2((s[j][1] - m0) * TC_LOG2E);
        s[j][2] = ex2((s[j][2] - m1) * TC_LOG2E);
        s[j][3] = ex2((s[j][3] - m1) * TC_LOG2E);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
    } else {
      const float sh0 = m0 * TC_LOG2E, sh1 = m1 * TC_LOG2E;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2(fmaf(s[j][0], TC_LOG2E, -sh0));
        s[j][1] = ex2(fmaf(s[j][1], TC_LOG2E, -sh0));
        s[j][2] = ex2(fmaf(s[j][2], TC_LOG2E, -sh1));
        s[j][3] = ex2(fmaf(s[j][3], TC_LOG2E, -sh1));
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
    }
    const float one[2] = {1.0f, 1.0f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[PR][4];
      afrag_p<PR>(s[2 * kk], s[2 * kk + 1], one, one, pa);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t vb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_cols(vb[p], sv + p * TC_PLANE, kk, c, lane);
        mma_cols<PR, PS>(o[2 * c], o[2 * c + 1], pa, vb);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if constexpr (F32) {   // o = o_before * rescale + this step's
        const float4 x = so[n * 32];
        o[n][0] = fmaf(x.x, ra0, o[n][0]);
        o[n][1] = fmaf(x.y, ra0, o[n][1]);
        o[n][2] = fmaf(x.z, ra1, o[n][2]);
        o[n][3] = fmaf(x.w, ra1, o[n][3]);
      }
      so[n * 32] = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    }
    *ss = make_float4(m0, m1, l0, l1);
  }

  // the group's windows' output and log-sum-exp (each lane reads back its
  // own state: no barrier needed); fp32: the statistic as hi + lo, m +
  // log(l) formed in fp64 (F3; (2, B_, nH, N))
  for (int w = grp; w < W; w += G) {
    const int b = b0 + w;
    const float4* so = sO + (w * 4 + warp) * 4 * 32 + lane;
    const float4 mls = sS[(w * 4 + warp) * 32 + lane];
    const float l0 = quad_sum(mls.z), l1 = quad_sum(mls.w);
    if (lse != nullptr && t == 0) {
      const size_t stat0 = ((size_t)b * gridDim.y + h) * N;
      if constexpr (F32) {
        float* lo = lse + (size_t)gridDim.z * W * gridDim.y * N;
        const double x0 = (double)mls.x + log((double)l0);
        const double x1 = (double)mls.y + log((double)l1);
        if (ok0) {
          lse[stat0 + r0] = (float)x0;
          lo[stat0 + r0] = (float)(x0 - (double)(float)x0);
        }
        if (ok1) {
          lse[stat0 + r1] = (float)x1;
          lo[stat0 + r1] = (float)(x1 - (double)(float)x1);
        }
      } else {
        if (ok0) lse[stat0 + r0] = mls.x + logf(l0);
        if (ok1) lse[stat0 + r1] = mls.y + logf(l1);
      }
    }
    T* out_bh = out.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 x = so[n * 32];
      if (ok0) store_pair(out_bh + out.off(r0) + 8 * n, x.x / l0, x.y / l0);
      if (ok1) store_pair(out_bh + out.off(r1) + 8 * n, x.z / l1, x.w / l1);
    }
  }
}

// dynamic shared memory of fwd_tc_w_kernel: bias and mask tiles, W windows'
// state; fp32: the K / V staging and planes
template <typename T, typename TB, int MXU>
int w_fwd_bytes(bool masked, int W) {
  using WP = WPieces<T, MXU>;
  return (2 + (masked ? 2 * WP::G : 0)) * btile_bytes<TB>() +
         W * (4 * 4 * 32 + 4 * 32) * 16 +
         (WP::F32 ? 4 * TC_STAGE_F32 * 4 + 2 * WP::PS * TC_PLANE * 2 : 0);
}

// dynamic shared memory of fwd_tc_kernel: fp32's staging and planes, then
// the bias and mask tiles
template <typename T, typename TB, int MXU>
int tc_fwd_bytes(bool masked) {
  return Pieces<T, MXU>::kTiles + bias_tiles_bytes<TB>(masked);
}

// Lets fwd_tc_kernel take its masked (largest) dynamic shared memory.
template <template <typename> class L, typename T, typename TB, int MXU>
cudaError_t allow_tc_fwd_bytes() {
  return cudaFuncSetAttribute(fwd_tc_kernel<L, T, TB, MXU>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              tc_fwd_bytes<T, TB, MXU>(true));
}

// The launch on operands already described in layout L (Rows: any
// (window, head, token) strides; MapRows: windows of a map) of type T, rows
// 16-byte aligned; -1 where a row is not.
template <template <typename> class L, typename T, typename TB, int MXU>
int launch(const L<const T>& rq, const L<const T>& rk, const L<const T>& rv,
           const L<T>& ro, const void* ls, const void* bias,
           const void* mask, void* lse, int B_, int N, int nH, int nW,
           int maxfree, cudaStream_t stream) {
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(ro))
    return -1;
  cudaError_t err = allow_tc_fwd_bytes<L, T, TB, MXU>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, B_);
  fwd_tc_kernel<L, T, TB, MXU>
      <<<grid, TC_NT, tc_fwd_bytes<T, TB, MXU>(mask != nullptr), stream>>>(
      rq, rk, rv, (const float*)ls, (const TB*)bias, (const TB*)mask, ro,
      (float*)lse, N, nW, maxfree);
  return (int)cudaGetLastError();
}

// qkv (B_, N, 3C) and out (B_, N, C): the packed layout's Rows; T = float:
// fp32 qkv and out, lse (2, B_, nH, N) hi then lo
template <typename T, typename TB, int MXU>
int launch_packed(const void* qkv, const void* ls, const void* bias,
                  const void* mask, void* out, void* lse, int B_, int N,
                  int nH, int nW, int maxfree, cudaStream_t stream) {
  const int C = nH * TC_DH;
  return launch<Rows, T, TB, MXU>(
      packed_rows((const T*)qkv, 0, N, C, 3, TC_DH),
      packed_rows((const T*)qkv, 1, N, C, 3, TC_DH),
      packed_rows((const T*)qkv, 2, N, C, 3, TC_DH),
      packed_rows((T*)out, 0, N, C, 1, TC_DH), ls, bias, mask, lse, B_, N,
      nH, nW, maxfree, stream);
}

// K5 on the packed layout: W windows per block; T = float: fp32 qkv and
// out, lse (2, B_, nH, N) hi then lo
template <typename T, typename TB, int MXU>
int launch_packed_w(const void* qkv, const void* ls, const void* bias,
                    const void* mask, void* out, void* lse, int B_, int N,
                    int nH, int nW, int maxfree, int W,
                    cudaStream_t stream) {
  const int C = nH * TC_DH;
  const Rows<const T> rq = packed_rows((const T*)qkv, 0, N, C, 3, TC_DH);
  const Rows<const T> rk = packed_rows((const T*)qkv, 1, N, C, 3, TC_DH);
  const Rows<const T> rv = packed_rows((const T*)qkv, 2, N, C, 3, TC_DH);
  const Rows<T> ro = packed_rows((T*)out, 0, N, C, 1, TC_DH);
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(ro))
    return -1;
  const int smem = w_fwd_bytes<T, TB, MXU>(mask != nullptr, W);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_w_kernel<T, TB, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      w_fwd_bytes<T, TB, MXU>(true, W_MAX));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, B_ / W);
  fwd_tc_w_kernel<T, TB, MXU><<<grid, WPieces<T, MXU>::G * TC_NT, smem, stream>>>(
      rq, rk, rv, (const float*)ls, (const TB*)bias, (const TB*)mask, ro,
      (float*)lse, N, nW, maxfree, W);
  return (int)cudaGetLastError();
}

// The slab layout: qkv the (B, Hp, Wp, 3C) map, out the (B, Hp, Wp, C)
// map, both of type T, windows of ws x ws read in place (MapRows); mode
// MXU_FP32, maxfree 0. T = float: lse (2, B_, nH, N) hi then lo
template <typename T, typename TB>
int launch_slab(const void* qkv, const void* ls, const void* bias,
                const void* mask, void* out, void* lse, int B_, int Hp,
                int Wp, int C, int nH, int ws, cudaStream_t stream) {
  return launch<MapRows, T, TB, MXU_FP32>(
      map_rows((const T*)qkv, 0, C, 3, Hp, Wp, ws, TC_DH),
      map_rows((const T*)qkv, 1, C, 3, Hp, Wp, ws, TC_DH),
      map_rows((const T*)qkv, 2, C, 3, Hp, Wp, ws, TC_DH),
      map_rows((T*)out, 0, C, 1, Hp, Wp, ws, TC_DH), ls, bias, mask, lse, B_,
      ws * ws, nH, (Hp / ws) * (Wp / ws), 0, stream);
}

bool shape_ok(int B_, int N, int nH, int nW, const void* mask) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || B_ > 65535 || nH > 65535) return false;
  return mask == nullptr || (nW > 0 && B_ % nW == 0);
}

}  // namespace

// Plain C entry. qkv (B_, N, 3C) and out (B_, N, C) bf16, C = 32 * nH;
// bias (nH, N, N) and mask (nW, N, N; may be null) bf16 when bias_bf16, else
// fp32; `lse` (B_, nH, N) fp32, when not null, receives each row's
// log-sum-exp, as mmde_window_attention_fwd_stats writes it. qkv_bf16 0:
// fp32 qkv and out (and fp32 bias), every operand in three bf16 pieces,
// `lse` (2, B_, nH, N) hi then lo (F3). mxu: the precision mode (MXU_FP32 /
// MXU_FOLD / MXU_BF16, window_attention_common.cuh; -1 for another code).
// Returns cudaGetLastError() of the launch, or -1 for arguments the kernel
// does not take. Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int mmde_window_attention_fwd_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int maxfree, int mxu,
    void* stream) {
  if (C != nH * TC_DH || !shape_ok(B_, N, nH, nW, mask)) return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if constexpr (MXU == MXU_FOLD_PV) {
      return -1;
    } else if (!qkv_bf16) {
      return launch_packed<float, float, MXU>(qkv, logit_scale, bias, mask,
                                              out, lse, B_, N, nH, nW,
                                              maxfree, s);
    } else if (bias_bf16) {
      return launch_packed<bf16, bf16, MXU>(qkv, logit_scale, bias, mask,
                                            out, lse, B_, N, nH, nW, maxfree,
                                            s);
    } else {
      return launch_packed<bf16, float, MXU>(qkv, logit_scale, bias, mask,
                                             out, lse, B_, N, nH, nW,
                                             maxfree, s);
    }
  });
}

// K5's entry on the tensor cores: as mmde_window_attention_fwd_tc, with W
// (2 .. W_MAX, dividing B_, and nW where there is a mask) consecutive
// windows per block; `lse` may be null (serving). qkv_bf16 0: fp32 qkv and
// out (and fp32 bias), every operand in three bf16 pieces, `lse` (2, B_,
// nH, N) hi then lo (F3). -1 for a W or a type it does not take.
extern "C" int mmde_window_attention_fwd_tc_w(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int maxfree, int W, int mxu,
    void* stream) {
  if (C != nH * TC_DH || !shape_ok(B_, N, nH, nW, mask)) return -1;
  if (W < 2 || W > W_MAX || B_ % W != 0 || (mask != nullptr && nW % W != 0))
    return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if constexpr (MXU == MXU_FOLD_PV) {
      return -1;
    } else if (!qkv_bf16) {
      return launch_packed_w<float, float, MXU>(qkv, logit_scale, bias, mask,
                                                out, lse, B_, N, nH, nW,
                                                maxfree, W, s);
    } else if (bias_bf16) {
      return launch_packed_w<bf16, bf16, MXU>(qkv, logit_scale, bias, mask,
                                              out, lse, B_, N, nH, nW,
                                              maxfree, W, s);
    } else {
      return launch_packed_w<bf16, float, MXU>(qkv, logit_scale, bias, mask,
                                               out, lse, B_, N, nH, nW,
                                               maxfree, W, s);
    }
  });
}

// Head-split entry (K6's counterpart on the tensor cores): q, k, v
// (B_, nH, N, 32), each at its own base with the strides `strides` gives, a
// host array of nine: q, k, v, each (window, head, token), in elements
// (the model's permuted views of its qkv tensor: no copy); out a contiguous
// (B_, nH, N, 32) of q's type. qkv_bf16 1: bf16 q, k, v and out; bias
// (nH, N, N) and mask (nW, N, N; may be null) bf16 when bias_bf16, else
// fp32 (the head-split stages stream them in fp32, as the TPU kernel does);
// `lse` (B_, nH, N) fp32 when not null, as mmde_window_attention_fwd_tc
// writes it. qkv_bf16 0: fp32 q, k, v and out, every operand in three bf16
// pieces, fp32 bias and mask (a bf16 bias is refused), `lse` (2, B_, nH, N)
// hi then lo, m + log(l) formed in fp64 (F3), as the packed fp32 forward
// writes it. The TPU kernel's function only: mode MXU_FP32, the running row
// maximum for every head (maxfree 0). Returns cudaGetLastError() of the
// launch, or -1 for arguments the kernel does not take (a row that is not
// 16-byte aligned among them).
extern "C" int mmde_window_attention_headsplit_fwd_tc(
    const void* q, const void* k, const void* v, const void* strides,
    const void* logit_scale, const void* bias, const void* mask, void* out,
    void* lse, int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
    void* stream) {
  if (strides == nullptr || !shape_ok(B_, N, nH, nW, mask)) return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  const long long* st = (const long long*)strides;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16) {
    const Rows<const float> rq = {(const float*)q, st[0], st[1], st[2]};
    const Rows<const float> rk = {(const float*)k, st[3], st[4], st[5]};
    const Rows<const float> rv = {(const float*)v, st[6], st[7], st[8]};
    const Rows<float> ro = contiguous_rows((float*)out, nH, N, TC_DH);
    return launch<Rows, float, float, MXU_FP32>(rq, rk, rv, ro, logit_scale,
                                                bias, mask, lse, B_, N, nH,
                                                nW, 0, s);
  }
  const Rows<const bf16> rq = {(const bf16*)q, st[0], st[1], st[2]};
  const Rows<const bf16> rk = {(const bf16*)k, st[3], st[4], st[5]};
  const Rows<const bf16> rv = {(const bf16*)v, st[6], st[7], st[8]};
  const Rows<bf16> ro = contiguous_rows((bf16*)out, nH, N, TC_DH);
  if (bias_bf16)
    return launch<Rows, bf16, bf16, MXU_FP32>(rq, rk, rv, ro, logit_scale,
                                              bias, mask, lse, B_, N, nH, nW,
                                              0, s);
  return launch<Rows, bf16, float, MXU_FP32>(rq, rk, rv, ro, logit_scale,
                                             bias, mask, lse, B_, N, nH, nW,
                                             0, s);
}

// Slab entry (K8's counterpart on the tensor cores): qkv the
// (B, Hp, Wp, 3C) map the qkv Linear emits on the padded (and, in a shifted
// block, rolled) feature map, Hp and Wp multiples of ws; out the
// (B, Hp, Wp, C) map of qkv's type. The kernel's windows are the
// B * (Hp/ws) * (Wp/ws) windows of the map, image-major and row-major
// (window_partition's order), N = ws*ws tokens each, every token row read
// and written in place (MapRows): no partition before the kernel, no
// reverse after it. qkv_bf16 1: a bf16 map; bias (nH, N, N) and mask
// (nW, N, N; may be null; one row per window of an image, nW = (Hp/ws) *
// (Wp/ws)) bf16 when bias_bf16, else fp32 (the model streams them in fp32);
// `lse` (B * nW, nH, N) fp32 when not null (training), one number a row in
// that window order, as mmde_window_attention_fwd_tc writes it. qkv_bf16 0:
// an fp32 map and out, every operand in three bf16 pieces (the packed fp32
// instantiation's arithmetic over MapRows), fp32 bias and mask (a bf16 bias
// is refused), `lse` (2, B * nW, nH, N) hi then lo, m + log(l) formed in
// fp64 (F3). Null `lse` serves. The TPU kernel's function: mode MXU_FP32,
// the running row maximum for every head (maxfree 0). Returns
// cudaGetLastError() of the launch, or -1 for arguments the kernel does not
// take (a map that is not whole windows, N * ws >= 2^32 for MapRows'
// multiply-shift, ws * Wp >= 2^31 for its pixel index, more than 65535
// windows, a row that is not 16-byte aligned). Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int mmde_window_attention_slab_fwd_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, void* out, void* lse, int B, int Hp, int Wp, int C,
    int nH, int ws, int qkv_bf16, int bias_bf16, void* stream) {
  if (C != nH * TC_DH || B <= 0 || ws <= 0 || Hp <= 0 || Wp <= 0 ||
      Hp % ws != 0 || Wp % ws != 0)
    return -1;
  const long long N = (long long)ws * ws;
  const long long nW = (long long)(Hp / ws) * (Wp / ws);
  if (N * ws >= (1ll << 32) || (long long)B * nW > 65535) return -1;
  if ((long long)ws * Wp >= (1ll << 31)) return -1;   // MapRows::pix
  const int B_ = (int)(B * nW);
  if (!shape_ok(B_, (int)N, nH, (int)nW, mask)) return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16)
    return launch_slab<float, float>(qkv, logit_scale, bias, mask, out, lse,
                                     B_, Hp, Wp, C, nH, ws, s);
  if (bias_bf16)
    return launch_slab<bf16, bf16>(qkv, logit_scale, bias, mask, out, lse, B_,
                                   Hp, Wp, C, nH, ws, s);
  return launch_slab<bf16, float>(qkv, logit_scale, bias, mask, out, lse, B_,
                                  Hp, Wp, C, nH, ws, s);
}

// Blocks of the slab entry's fwd_tc_kernel an SM holds at its launch
// (qkv_bf16 as that entry takes it, fp32 bias and mask as the model
// streams them, with or without the mask), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers and static and
// dynamic shared memory together. Written to *blocks; returns the CUDA
// error. No launch.
extern "C" int mmde_window_attention_slab_fwd_tc_occupancy(int qkv_bf16,
                                                           int masked,
                                                           int* blocks) {
  auto query = [&](auto t) {
    using T = decltype(t);
    cudaError_t err = allow_tc_fwd_bytes<MapRows, T, float, MXU_FP32>();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fwd_tc_kernel<MapRows, T, float, MXU_FP32>, TC_NT,
        tc_fwd_bytes<T, float, MXU_FP32>(masked != 0));
  };
  return qkv_bf16 ? query(bf16()) : query(0.0f);
}
