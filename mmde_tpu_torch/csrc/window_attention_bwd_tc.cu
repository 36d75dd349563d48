// Fused SwinV2 cosine window attention, backward, on Hopper's tensor cores
// (sm_90a, bf16 mma.sync), for bf16 or fp32 q, k, v and g: in the packed
// layout at one window per block or W (the _w kernels, below), on
// head-split operands (bf16 or fp32), and on the slab path's (B, Hp, Wp,
// 3C) map (bf16 or fp32).
//
// Replaces mmde_tpu/ops/window_attention_packed.py::_bwd_body (K2, driven
// by _pallas_backward) for every packed launch, bf16 and fp32, at w = 1
// and with w > 1 (K5, MMDE_ATTN_W), in all three precision modes: dqkv,
// dlogit_scale and (dbias_mode 1) dbias; and
// mmde_tpu/ops/window_attention_pallas.py::_bwd_kernel (K7, driven by
// _pallas_backward) for every head-split launch, bf16 and fp32, in its
// function (mode fp32, fp32 bias and mask tiles): dq, dk, dv into
// contiguous (B_, nH, N, 32), dlogit_scale, dbias by the same atomics; and
// mmde_tpu/ops/window_attention_slab.py::_bwd_body (K9, driven by
// _pallas_backward) for every slab launch, bf16 and fp32, in the same
// function: dqkv
// written into the (B, Hp, Wp, 3C) map in place, dbias summed over windows
// by the same atomics (the TPU kernel's resident fp32 block). The two
// passes are templates over the operands' layout (Rows; MapRows for the
// slab entry, window_attention_common.cuh), every row address L::head(b, h)
// + L::off(r) (the map's tile loads through TileRows' shared table), and
// over their type: fp32 operands (packed, head-split and slab) take every
// operand in three bf16 pieces (Pieces, below), as K5's fp32 passes do, the
// map's fp32 tiles staged through the same table. And
// mmde_tpu/ops/window_attention_packed.py::_dbias_body (K3, driven by
// _pallas_dbias; MMDE_ATTN_GRID=split) for every packed and head-split
// launch, bf16 and fp32, in every mode: the caller passes dbias_mode 0 to
// the passes and runs bwd_dbias_tc_kernel (below) on the delta they wrote
// and the forward's statistic, dbias summed over the windows in one fixed
// order, the same bits on every run; the slab entry's K3
// (mmde_window_attention_slab_dbias_tc) is the same kernel over MapRows,
// each window's rows read in place off the map.
// window_attention_bwd.cu keeps K2's and K3's fp32-FMA bodies as the
// same-card A/B partner. Same function and the same two passes as K2 (its
// header has the formulas):
//
//   dq/delta pass    one block per (window, head, 64-query tile), two
//                    sweeps over 64-key tiles, each S = q k^T and dP = g v^T
//                    with p rebuilt from the forward's log-sum-exp: the
//                    first sums delta (exact, fp32), the second forms
//                    ds = p (dp - delta) and dqn = sum_j ds_ij f_j k_j,
//                    f_j = scale * rk_j. (K2's one sweep, dqn = A - delta B
//                    with A = sum_j (p dp)_ij f_j k_j and B = sum_j p_ij f_j
//                    k_j, was faster on the card, but its two sums cancel
//                    where p sits on keys with dp near delta (hot heads) and
//                    the operands' split residual (2^-17) then shows at
//                    ~2e-5 of dq, over the 1e-5 the fp32 function is held
//                    to; PERF.md has both times.)
//   dk/dv pass       one block per (window, head, 64-key tile), a loop over
//                    64-query tiles with lse and delta read back. It forms
//                    S^T = k q^T and dP^T = v g^T directly, so p^T and ds^T
//                    sit in the accumulators as the A fragments of dv += p^T
//                    g and dkn += sum_i ds_ij (scale * rq_i) q_i; dk and dv
//                    are summed over the query tiles in fp32 registers.
//                    dlogit_scale: sum(ds * sc) from the fp32 accumulators
//                    in every mode (K2's shortcut k^ . dkn would carry dkn's
//                    split residual into a sum whose terms cancel), fp64
//                    partials per block, no atomics. dbias: fp32 atomics
//                    into (nH, query, key): a 4 x 4 transpose over the four
//                    lanes of a fragment's column group (three shuffles)
//                    hands each lane 4 consecutive keys of one query, one
//                    16-byte vector atomic where N % 4 == 0, scalar atomics
//                    elsewhere.
//
// What bounds it on an H100: bytes are few (qkv, g and dqkv once, bias and
// mask from L2, dbias once), the work five N x N x 32 products and two exp
// passes per (window, head); K2's body runs its eight products as fp32
// FMAs. Here every product is bf16 mma.sync with fp32 accumulation and the
// function stays the fp32 one: q, k, v and g are bf16 values (exact
// operands), the fp32 factors rq, rk and scale are applied to accumulators
// or folded into the fp32 operand that is split in two (bf16 hi + bf16 lo,
// ~2^-17 left over). S, dP: 1 mma each (twice in the dq pass); ds k, dv,
// dk: 2 each (12 N x N x 32 units issued, where the function needs 8 with
// its split operands). The bf16 mode takes the JAX body's rounded operands
// - bf16(q^ * scale), bf16(k^), bf16(p), bf16(ds) - one mma each (9 issued,
// 5 needed). Tiles, fragments and the softmax rebuild follow
// window_attention_fwd_tc.cu: raw bf16 tiles double-buffered by cp.async,
// ldmatrix (.trans where the k of a product runs over the tile's rows),
// rows of a fragment reduced inside their quad.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

// 4 bytes global -> shared, asynchronous; zero when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// fp32 operands (T = float), at one window a block: every operand in three
// bf16 pieces (PS staged, PR formed in registers; the "bf16" mode one
// rounding), the block's own rows (q, g; k, v) held in registers as A
// fragments in PS pieces for the whole sweep, the streamed tiles arriving
// in fp32 into one staging buffer and split into bf16 planes (the next
// step's copies issued once the split pass is done), the statistic read as
// hi + lo (F3): p = exp((s - hi) - lo), as the fp32 forward wrote it. Each
// step's products go into fresh registers and are added by the CUDA cores
// (round to nearest) to the running dq, dk^ and dv, which live in shared
// memory in fragment order (a lane's own float4s), as K5's do. kTiles: the
// dynamic shared memory of the staging and the planes; kState: of the
// running sums (dq pass: dq; dk/dv pass: dk^ and dv).
template <typename T, int MXU>
struct Pieces {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool RB = MXU == MXU_BF16;
  static constexpr int PS = F32 && !RB ? 3 : 1;
  static constexpr int PR = RB ? 1 : F32 ? 3 : 2;
  static constexpr int kTiles =
      F32 ? 2 * TC_STAGE_F32 * 4 + 2 * PS * TC_PLANE * 2 : 0;
  static constexpr int kState = 4 * 4 * 32 * 16;   // one float4 set a lane
};

// ---------------------------------------------------------------------------
// dq and delta: one block per (query tile, head, window)
// ---------------------------------------------------------------------------
// L: the operands' layout (Rows; MapRows for the slab entry); T: their type
template <template <typename> class L, typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_tc_kernel(L<const T> q, L<const T> k, L<const T> v,
                 L<const T> g, const float* __restrict__ logit_scale,
                 const TB* __restrict__ bias, const TB* __restrict__ mask,
                 const float* __restrict__ lse, L<T> dq,
                 float* __restrict__ delta, int N, int nW) {
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
  // fp32: the K / V staging and planes, the running dq (Pieces), then the
  // stages' bias (and mask) tiles: BiasTiles
  extern __shared__ __align__(128) char sBM[];

  constexpr bool RB = MXU == MXU_BF16;
  constexpr bool TAB = TileRows<L<const T>>::kTable;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, h = blockIdx.y, b = blockIdx.z;
  const T* k_bh = k.head(b, h);
  const T* v_bh = v.head(b, h);
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w = mask != nullptr ? mask + (size_t)(b % nW) * N * N
                                     : nullptr;
  const size_t stat0 = ((size_t)b * gridDim.y + h) * N;
  const float scale = expf(fminf(logit_scale[h], TC_LN100));
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int steps = 2 * nt;     // delta first, then ds
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  float* sStg = reinterpret_cast<float*>(sBM);
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 2 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;
  float4* sA = reinterpret_cast<float4*>(sBM + P::kTiles) +
               warp * 4 * 32 + lane;   // the lane's running dq (fp32)
  const BiasTiles<TB> bt{sBM + (F32 ? P::kTiles + P::kState : 0),
                         mask_w != nullptr};

  auto fill = [&](int s) {      // step s's tile table -> stage s & 1
    if (s < steps)
      TileRows<L<const T>>::fill(sTab[s & 1], k, (s % nt) * TC_BT, tid);
  };
  auto issue = [&](int s) {     // step s's K, V, bias, mask -> stage s & 1
    const int st = s & 1, kn = (s % nt) * TC_BT;
    if constexpr (F32) {
      load_tile_f32(sStg, k_bh, k, sTab[st], kn, N, tid);
      load_tile_f32(sStg + TC_STAGE_F32, v_bh, v, sTab[st], kn, N, tid);
    } else {
      load_tile(sK[st], k_bh, k, sTab[st], kn, N, tid);
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

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  uint32_t qa[PS][2][4], qs[2][4], ga[PS][2][4];
  float rq0, rq1;
  if constexpr (F32) {
    float2 qx[2][4], gx[2][4];
    load_afrag_f32(qx, q.head(b, h), q, r0, N, t);
    load_afrag_f32(gx, g.head(b, h), g, r0, N, t);
    float none0, none1;
    finish_operand<PS, true, RB || FQ>(qx, qa, lane, rq0, rq1, scale);
    finish_operand<PS, false, false>(gx, ga, lane, none0, none1, 1.0f);
#pragma unroll
    for (int n = 0; n < 4; ++n) sA[n * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    load_afrag(qa[0], q.head(b, h), q, r0, N, t);
    load_afrag(ga[0], g.head(b, h), g, r0, N, t);
    row_norms(qa[0], rq0, rq1, lane);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) qs[ks][i] = qa[0][ks][i];
    if constexpr (RB) scale_afrag(qs, rq0, rq1, scale);
  }
  const float c0 = FQ ? 1.0f : MXU == MXU_FP32 ? rq0 : rq0 * scale;
  const float c1 = FQ ? 1.0f : MXU == MXU_FP32 ? rq1 : rq1 * scale;
  const float lse0 = ok0 ? lse[stat0 + r0] : 0.0f;
  const float lse1 = ok1 ? lse[stat0 + r1] : 0.0f;
  // fp32: the statistic's lo, (2, B_, nH, N) (F3)
  float lo0 = 0.0f, lo1 = 0.0f;
  if constexpr (F32) {
    const float* lo = lse + (size_t)gridDim.z * gridDim.y * N;
    lo0 = ok0 ? lo[stat0 + r0] : 0.0f;
    lo1 = ok1 ? lo[stat0 + r1] : 0.0f;
  }

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float dpart0 = 0.0f, dpart1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    const int k0 = (step % nt) * TC_BT;
    const bool first = step < nt;   // the delta sweep
    if (step == nt) {
      dl0 = quad_sum(dpart0);
      dl1 = quad_sum(dpart1);
    }
    cp_async_wait_all();
    __syncthreads();
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
      // rounded), warps 2-3 a V row
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      staged_row(sStg + (tid < TC_BT ? 0 : TC_STAGE_F32), r, x);
      if (tid < TC_BT) {
        const float rn = row_rnorm(x);
        sRk[st][r] = rn;
        put_row<PS, RB>(sKp, r, x, rn, 1.0f);
      } else {
        put_row<PS, false>(sVp, r, x, 1.0f, 1.0f);
      }
    } else {
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
    // stage st's table is free again (see fwd_tc_kernel)
    if constexpr (TAB) fill(step + 2);
    if constexpr (F32) {   // this step's products in fresh registers
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4], f[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        if constexpr (F32) {
          uint32_t kb[PS][4], vb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(kb[p], sKp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(s[jj], qa, kb);
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(vb[p], sVp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(dp[jj], ga, vb);
        } else {
          uint32_t kb[4], vb[4];
          frag_rows(kb, sK[st], j, lane);
          mma(s[jj], qs[0], kb[0], kb[1]);
          mma(s[jj], qs[1], kb[2], kb[3]);
          frag_rows(vb, sV[st], j, lane);
          mma(dp[jj], ga[0][0], vb[0], vb[1]);
          mma(dp[jj], ga[0][1], vb[2], vb[3]);
        }
      }
      // p = exp(s - lse), 0 past the edge
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int col = k0 + cl;
        const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
        f[jj][0] = RB ? 1.0f : scale * rk[0];   // the bf16 mode: ds as it is
        f[jj][1] = RB ? 1.0f : scale * rk[1];
        const bool in1 = col + 1 < N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* x = &s[jj][2 * half];
          if (col >= N || !(half ? ok1 : ok0)) {
            x[0] = x[1] = 0.0f;
            continue;
          }
          const int rl = warp * 16 + (lane >> 2) + 8 * half;  // tile row
          const float c = half ? c1 : c0;
          const float ls2 = (half ? lse1 : lse0) * TC_LOG2E;
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
            if constexpr (F32)   // F3: p = exp((s - hi) - lo)
              x[e] = ex2((((y + (e ? bm.y : bm.x)) - (half ? lse1 : lse0)) -
                          (half ? lo1 : lo0)) * TC_LOG2E);
            else
              x[e] = ex2(fmaf(y + (e ? bm.y : bm.x), TC_LOG2E, -ls2));
          }
          if (!in1) x[1] = 0.0f;
        }
      }
      if (first) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          dpart0 += s[jj][0] * dp[jj][0] + s[jj][1] * dp[jj][1];
          dpart1 += s[jj][2] * dp[jj][2] + s[jj][3] * dp[jj][3];
        }
        continue;
      }
      // ds = p (dp - delta); the bf16 mode rounds ds itself (f = 1)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        dp[jj][0] = s[jj][0] * (dp[jj][0] - dl0);
        dp[jj][1] = s[jj][1] * (dp[jj][1] - dl0);
        dp[jj][2] = s[jj][2] * (dp[jj][2] - dl1);
        dp[jj][3] = s[jj][3] * (dp[jj][3] - dl1);
      }
      if constexpr (F32) {
        uint32_t a[PR][4];
        afrag_p<PR>(dp[0], dp[1], f[0], f[1], a);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t kb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(kb[p], sKp + p * TC_PLANE, kk, c, lane);
          mma_cols<PR, PS>(acc[2 * c], acc[2 * c + 1], a, kb);
        }
      } else {
        uint32_t ah[4], al[4];
        afrag<!RB>(dp[0], dp[1], f[0], f[1], ah, al);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t kb[4];
          frag_cols(kb, sK[st], kk, c, lane);
          mma(acc[2 * c], ah, kb[0], kb[1]);
          mma(acc[2 * c + 1], ah, kb[2], kb[3]);
          if constexpr (!RB) {
            mma(acc[2 * c], al, kb[0], kb[1]);
            mma(acc[2 * c + 1], al, kb[2], kb[3]);
          }
        }
      }
    }
    if constexpr (F32) {   // the running dq += this step's, round to nearest
      if (!first) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 x = sA[n * 32];
          sA[n * 32] = make_float4(x.x + acc[n][0], x.y + acc[n][1],
                                   x.z + acc[n][2], x.w + acc[n][3]);
        }
      }
    }
  }
  if (t == 0) {
    if (ok0) delta[stat0 + r0] = dl0;
    if (ok1) delta[stat0 + r1] = dl1;
  }

  // dq = rq (dqn - q^ (dqn . q^)), q^ from the raw q fragments (fp32: the
  // raw q again, exact in three pieces; the running dq)
  if constexpr (F32) {
    uint32_t qr[3][2][4];
    load_operand<T, 3, true, false>(qr, q.head(b, h), q, r0, N, lane, rq0,
                                    rq1, 1.0f);
    float dqn[4][4], dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 a = sA[n * 32];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = av[e];
        if constexpr (RB) x *= scale;
        const float qn = raw_at(qr, n, e >> 1, e & 1) * (e < 2 ? rq0 : rq1);
        dqn[n][e] = x;
        if (e < 2) dot0 = fmaf(x, qn, dot0);
        else dot1 = fmaf(x, qn, dot1);
      }
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dq_bh = dq.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const float rq = half ? rq1 : rq0, dot = half ? dot1 : dot0;
        store_pair(dq_bh + dq.off(half ? r1 : r0) + 8 * n,
                   rq * (dqn[n][2 * half] - raw_at(qr, n, half, 0) * rq * dot),
                   rq * (dqn[n][2 * half + 1] -
                         raw_at(qr, n, half, 1) * rq * dot));
      }
  } else {
    float dqn[4][4], dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc[n][e];
        if constexpr (RB) x *= scale;
        const uint32_t w = afrag_at(qa[0], n, e >> 1);
        const float qn = ((e & 1) ? hi_f(w) : lo_f(w)) * (e < 2 ? rq0 : rq1);
        dqn[n][e] = x;
        if (e < 2) dot0 = fmaf(x, qn, dot0);
        else dot1 = fmaf(x, qn, dot1);
      }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dq_bh = dq.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const float rq = half ? rq1 : rq0, dot = half ? dot1 : dot0;
        const uint32_t w = afrag_at(qa[0], n, half);
        store_pair(dq_bh + dq.off(half ? r1 : r0) + 8 * n,
                   rq * (dqn[n][2 * half] - lo_f(w) * rq * dot),
                   rq * (dqn[n][2 * half + 1] - hi_f(w) * rq * dot));
      }
  }
}

// dbias[query][key..key+3] += (a, b, c, d): one 16-byte vector atomic
__device__ __forceinline__ void atomic_add4(float* p, float a, float b,
                                            float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// x[i] for a lane-dependent i in 0..3, by selects (no local memory)
__device__ __forceinline__ float pick4(const float* x, int i) {
  return i & 2 ? (i & 1 ? x[3] : x[2]) : (i & 1 ? x[1] : x[0]);
}

// ---------------------------------------------------------------------------
// dk, dv, dlogit_scale partials, dbias: one block per (key tile, head,
// window)
// ---------------------------------------------------------------------------
template <template <typename> class L, typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT)
bwd_dkv_tc_kernel(L<const T> q, L<const T> k, L<const T> v,
                  L<const T> g, const float* __restrict__ logit_scale,
                  const TB* __restrict__ bias, const TB* __restrict__ mask,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, L<T> dk,
                  L<T> dv, double* __restrict__ dls_part,
                  float* __restrict__ dbias, int N, int nW) {
  using P = Pieces<T, MXU>;
  constexpr bool F32 = P::F32;
  constexpr int PS = P::PS, PR = P::PR;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sQ[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sG[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRq[2][TC_BT];
  __shared__ float sLse[2][TC_BT];
  __shared__ float sDl[2][TC_BT];
  __shared__ float sLo[2][F32 ? TC_BT : 1];   // fp32: the statistic's lo
  __shared__ double sRed[4];
  // MapRows: the stages' tile tables (TileRows), Q and G rows' pixels
  __shared__ int sTab[2][TC_BT];
  // fp32: the Q / G staging and planes, the running dv and dk^ (Pieces),
  // then the stages' bias (and mask) tiles: BiasTiles
  extern __shared__ __align__(128) char sBM[];

  constexpr bool RB = MXU == MXU_BF16;
  constexpr bool TAB = TileRows<L<const T>>::kTable;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int k0 = blockIdx.x * TC_BT, h = blockIdx.y, b = blockIdx.z;
  const int nH = gridDim.y;
  const T* q_bh = q.head(b, h);
  const T* g_bh = g.head(b, h);
  const TB* bias_h = bias + (size_t)h * N * N;
  const TB* mask_w = mask != nullptr ? mask + (size_t)(b % nW) * N * N
                                     : nullptr;
  float* dbias_h = dbias != nullptr ? dbias + (size_t)h * N * N : nullptr;
  const size_t stat0 = ((size_t)b * nH + h) * N;
  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, TC_LN100));
  const int nt = (N + TC_BT - 1) / TC_BT;
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  float* sStg = reinterpret_cast<float*>(sBM);
  bf16* sQp = reinterpret_cast<bf16*>(sStg + 2 * TC_STAGE_F32);
  bf16* sGp = sQp + PS * TC_PLANE;
  // the lane's running dv and dk^ (fp32)
  float4* sv = reinterpret_cast<float4*>(sBM + P::kTiles) +
               warp * 4 * 32 + lane;
  float4* sk = sv + 4 * 4 * 32;
  const BiasTiles<TB> bt{sBM + (F32 ? P::kTiles + 2 * P::kState : 0),
                         mask_w != nullptr};

  // query tile it's table (MapRows) -> stage it & 1
  auto fill = [&](int it) {
    if (it < nt)
      TileRows<L<const T>>::fill(sTab[it & 1], q, it * TC_BT, tid);
  };
  // query tile q0's Q, G, lse, delta, bias and mask (rows: queries, cols:
  // this block's keys) -> stage st (fp32: Q and G into the staging, lse's
  // lo too)
  auto load = [&](int st, int q0) {
    if constexpr (F32) {
      load_tile_f32(sStg, q_bh, q, sTab[st], q0, N, tid);
      load_tile_f32(sStg + TC_STAGE_F32, g_bh, g, sTab[st], q0, N, tid);
    } else {
      load_tile(sQ[st], q_bh, q, sTab[st], q0, N, tid);
      load_tile(sG[st], g_bh, g, sTab[st], q0, N, tid);
    }
    if (async_b)
      stage_bias_tiles(bt, st, bias_h, mask_w, q0, k0, N, tid, true);
    const int j = tid & (TC_BT - 1);
    const bool ok = q0 + j < N;
    const float* src = (tid < TC_BT ? lse : delta) + stat0 + (ok ? q0 + j : 0);
    cp_async4(tid < TC_BT ? &sLse[st][j] : &sDl[st][j], src, ok);
    if constexpr (F32) {   // F3: lo, (2, B_, nH, N)
      if (tid < TC_BT)
        cp_async4(&sLo[st][j],
                  lse + (size_t)gridDim.z * nH * N + stat0 +
                      (ok ? q0 + j : 0),
                  ok);
    }
    cp_async_commit();
  };
  if constexpr (TAB) {
    fill(0);
    fill(1);
    __syncthreads();
  }
  load(0, 0);

  const int r0 = k0 + warp * 16 + (lane >> 2), r1 = r0 + 8;   // keys
  const bool ok0 = r0 < N, ok1 = r1 < N;
  uint32_t ka[PS][2][4], ks_[2][4], va[PS][2][4];
  float rk0, rk1;
  if constexpr (F32) {
    float2 kx[2][4], vx[2][4];
    load_afrag_f32(kx, k.head(b, h), k, r0, N, t);
    load_afrag_f32(vx, v.head(b, h), v, r0, N, t);
    float none0, none1;
    finish_operand<PS, true, RB>(kx, ka, lane, rk0, rk1, 1.0f);
    finish_operand<PS, false, false>(vx, va, lane, none0, none1, 1.0f);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      sv[n * 32] = sk[n * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    load_afrag(ka[0], k.head(b, h), k, r0, N, t);
    load_afrag(va[0], v.head(b, h), v, r0, N, t);
    row_norms(ka[0], rk0, rk1, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) ks_[s][i] = ka[0][s][i];
    if constexpr (RB) scale_afrag(ks_, rk0, rk1, 1.0f);   // bf16(k^)
  }

  float accV[4][4], accK[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accV[n][e] = accK[n][e] = 0.0f;
  double dls = 0.0;

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    const int q0 = it * TC_BT;
    cp_async_wait_all();
    __syncthreads();
    if constexpr (!F32) {
      if (it + 1 < nt && !bt.fold()) load(st ^ 1, q0 + TC_BT);
    }
    const char* tb = bt.bias(st);
    const char* tm = bt.mask(st);
    if (!async_b)
      stage_bias_tiles(bt, st, bias_h, mask_w, q0, k0, N, tid, false);
    else if (bt.fold())
      fold_mask(bt, st, tid);
    if constexpr (F32) {
      // the split pass: warps 0-1 a Q row each (its norm; "bf16" / fold:
      // q^ * scale, rounded / in pieces), warps 2-3 a G row
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      staged_row(sStg + (tid < TC_BT ? 0 : TC_STAGE_F32), r, x);
      if (tid < TC_BT) {
        const float rn = row_rnorm(x);
        sRq[st][r] = rn;
        put_row<PS, RB || FQ>(sQp, r, x, rn, scale);
      } else {
        put_row<PS, false>(sGp, r, x, 1.0f, 1.0f);
      }
    } else {
      // the bf16 mode's q operand, bf16(q^ * scale), in place
      tile_norms<RB>(sQ[st], sRq[st], scale, tid);
    }
    __syncthreads();
    if constexpr (F32) {
      // the next tile's copies wait for the split pass (one staging
      // buffer), as they wait for the fold where the tiles fold
      if (it + 1 < nt) load(st ^ 1, q0 + TC_BT);
    } else {
      if (it + 1 < nt && bt.fold()) load(st ^ 1, q0 + TC_BT);
    }
    // stage st's table is free again (see fwd_tc_kernel)
    if constexpr (TAB) fill(it + 2);
    if constexpr (F32) {   // this tile's products in fresh registers
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) accV[n][e] = accK[n][e] = 0.0f;
    }

    float dls_t = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4], f[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        if constexpr (F32) {
          uint32_t qb[PS][4], gb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(qb[p], sQp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(s[jj], ka, qb);
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(gb[p], sGp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(dp[jj], va, gb);
        } else {
          uint32_t qb[4], gb[4];
          frag_rows(qb, sQ[st], j, lane);
          mma(s[jj], ks_[0], qb[0], qb[1]);
          mma(s[jj], ks_[1], qb[2], qb[3]);
          frag_rows(gb, sG[st], j, lane);
          mma(dp[jj], va[0][0], gb[0], gb[1]);
          mma(dp[jj], va[0][1], gb[2], gb[3]);
        }
      }
      // p^T, ds^T (rows: keys r0 / r1, cols: queries i, i + 1)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int i = q0 + cl;
        const float rq[2] = {sRq[st][cl], sRq[st][cl + 1]};
        const float ls2[2] = {sLse[st][cl] * TC_LOG2E,
                              sLse[st][cl + 1] * TC_LOG2E};
        float hi2[2] = {0.0f, 0.0f}, lo2[2] = {0.0f, 0.0f};
        if constexpr (F32) {
          hi2[0] = sLse[st][cl];
          hi2[1] = sLse[st][cl + 1];
          lo2[0] = sLo[st][cl];
          lo2[1] = sLo[st][cl + 1];
        }
        const float dl[2] = {sDl[st][cl], sDl[st][cl + 1]};
        // the bf16 mode (and fp32 fold, whose q operand is q^ * scale): ds
        // as it is
        f[jj][0] = RB || FQ ? 1.0f : scale * rq[0];
        f[jj][1] = RB || FQ ? 1.0f : scale * rq[1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kl = warp * 16 + (lane >> 2) + 8 * half;   // tile col
          const float rk = half ? rk1 : rk0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[jj][2 * half + e];
            float& d = dp[jj][2 * half + e];
            if (!(half ? ok1 : ok0) || i + e >= N) {
              x = d = 0.0f;
              continue;
            }
            float sc = x;
            if constexpr (MXU == MXU_FP32) sc = sc * rq[e] * rk * scale;
            else if constexpr (FQ) sc = sc * rk;
            else if constexpr (MXU == MXU_FOLD) sc = sc * (scale * rq[e]) * rk;
            float y = sc + btile_at<TB>(tb, cl + e, kl);
            if (bt.add_mask()) y += btile_at<TB>(tm, cl + e, kl);
            if constexpr (F32)   // F3: p = exp((s - hi) - lo)
              x = ex2(((y - hi2[e]) - lo2[e]) * TC_LOG2E);
            else
              x = ex2(fmaf(y, TC_LOG2E, -ls2[e]));
            d = x * (d - dl[e]);
            // fp32: sum(ds * (sc - lse)), the same sum (a row of ds sums to
            // zero), without ~60 times the rounding of that row sum
            if constexpr (F32) dls_t = fmaf(d, sc - hi2[e], dls_t);
            else dls_t = fmaf(d, sc, dls_t);
          }
        }
      }
      if (dbias_h != nullptr) {
        // lane 4 (4a + m) + t holds ds of keys kb + m (x[0], x[1]) and
        // kb + 8 + m (x[2], x[3]), kb = k0 + 16 warp + 4a, for queries
        // i, i + 1
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int i = q0 + 8 * (2 * kk + jj) + 2 * t;
          const float* x = dp[jj];
          if ((N & 3) == 0) {
            // 4 x 4 transpose over the lanes m = 0..3 of one (a, t): round
            // r trades with lane m ^ r, which sends its x[m], so lane m
            // gathers x[m] of all four - keys kb + 8 (m >> 1) .. + 3 of
            // query i + (m & 1)
            const int m = (lane >> 2) & 3;
            float got[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float send = pick4(x, m ^ r);
              got[r] = r == 0 ? send
                              : __shfl_xor_sync(0xffffffffu, send, 4 * r);
            }
            const int key = k0 + warp * 16 + 4 * (lane >> 4) + 8 * (m >> 1);
            const int qi = i + (m & 1);
            if (key < N && qi < N)
              atomic_add4(dbias_h + (size_t)qi * N + key, pick4(got, m),
                          pick4(got, m ^ 1), pick4(got, m ^ 2),
                          pick4(got, m ^ 3));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = e < 2 ? r0 : r1, ii = i + (e & 1);
              if (key < N && ii < N)
                atomicAdd(dbias_h + (size_t)ii * N + key, x[e]);
            }
          }
        }
      }
      // dv += p^T g, dkn += ds^T (scale rq q) (the bf16 mode: bf16(ds)^T
      // bf16(q^ scale))
      const float one[2] = {1.0f, 1.0f};
      if constexpr (F32) {
        uint32_t pa[PR][4], da[PR][4];
        afrag_p<PR>(s[0], s[1], one, one, pa);
        afrag_p<PR>(dp[0], dp[1], f[0], f[1], da);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t gb[PS][4], qb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(gb[p], sGp + p * TC_PLANE, kk, c, lane);
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(qb[p], sQp + p * TC_PLANE, kk, c, lane);
          mma_cols2<PR, PS>(accV[2 * c], accV[2 * c + 1], pa, gb,
                            accK[2 * c], accK[2 * c + 1], da, qb);
        }
      } else {
        uint32_t ph[4], pl[4], dh[4], dl4[4];
        afrag<!RB>(s[0], s[1], one, one, ph, pl);
        afrag<!RB>(dp[0], dp[1], f[0], f[1], dh, dl4);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t gb[4], qb[4];
          frag_cols(gb, sG[st], kk, c, lane);
          frag_cols(qb, sQ[st], kk, c, lane);
          mma(accV[2 * c], ph, gb[0], gb[1]);
          mma(accV[2 * c + 1], ph, gb[2], gb[3]);
          mma(accK[2 * c], dh, qb[0], qb[1]);
          mma(accK[2 * c + 1], dh, qb[2], qb[3]);
          if constexpr (!RB) {
            mma(accV[2 * c], pl, gb[0], gb[1]);
            mma(accV[2 * c + 1], pl, gb[2], gb[3]);
            mma(accK[2 * c], dl4, qb[0], qb[1]);
            mma(accK[2 * c + 1], dl4, qb[2], qb[3]);
          }
        }
      }
    }
    dls += dls_t;
    if constexpr (F32) {   // the running dv, dk^ += this tile's, nearest
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 x = sv[n * 32], y = sk[n * 32];
        sv[n * 32] = make_float4(x.x + accV[n][0], x.y + accV[n][1],
                                 x.z + accV[n][2], x.w + accV[n][3]);
        sk[n * 32] = make_float4(y.x + accK[n][0], y.y + accK[n][1],
                                 y.z + accK[n][2], y.w + accK[n][3]);
      }
    }
  }

  // dk = rk (dkn - k^ (dkn . k^)) (fp32: the running sums, the raw k again,
  // exact in three pieces)
  if constexpr (F32) {
    uint32_t kr[3][2][4];
    load_operand<T, 3, true, false>(kr, k.head(b, h), k, r0, N, lane, rk0,
                                    rk1, 1.0f);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 x = sv[n * 32], y = sk[n * 32];
      accV[n][0] = x.x; accV[n][1] = x.y; accV[n][2] = x.z; accV[n][3] = x.w;
      accK[n][0] = y.x; accK[n][1] = y.y; accK[n][2] = y.z; accK[n][3] = y.w;
    }
    float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kn = raw_at(kr, n, e >> 1, e & 1) * (e < 2 ? rk0 : rk1);
        if (e < 2) dot0 = fmaf(accK[n][e], kn, dot0);
        else dot1 = fmaf(accK[n][e], kn, dot1);
      }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dk_bh = dk.head(b, h) + 2 * t;
    T* dv_bh = dv.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const int key = half ? r1 : r0;
        const float rk = half ? rk1 : rk0, dot = half ? dot1 : dot0;
        store_pair(dk_bh + dk.off(key) + 8 * n,
                   rk * (accK[n][2 * half] - raw_at(kr, n, half, 0) * rk * dot),
                   rk * (accK[n][2 * half + 1] -
                         raw_at(kr, n, half, 1) * rk * dot));
        store_pair(dv_bh + dv.off(key) + 8 * n, accV[n][2 * half],
                   accV[n][2 * half + 1]);
      }
  } else {
    float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = afrag_at(ka[0], n, e >> 1);
        const float kn = ((e & 1) ? hi_f(w) : lo_f(w)) * (e < 2 ? rk0 : rk1);
        if (e < 2) dot0 = fmaf(accK[n][e], kn, dot0);
        else dot1 = fmaf(accK[n][e], kn, dot1);
      }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dk_bh = dk.head(b, h) + 2 * t;
    T* dv_bh = dv.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const int key = half ? r1 : r0;
        const float rk = half ? rk1 : rk0, dot = half ? dot1 : dot0;
        const uint32_t w = afrag_at(ka[0], n, half);
        store_pair(dk_bh + dk.off(key) + 8 * n,
                   rk * (accK[n][2 * half] - lo_f(w) * rk * dot),
                   rk * (accK[n][2 * half + 1] - hi_f(w) * rk * dot));
        store_pair(dv_bh + dv.off(key) + 8 * n, accV[n][2 * half],
                   accV[n][2 * half + 1]);
      }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    dls += __shfl_xor_sync(0xffffffffu, dls, off);
  if (lane == 0) sRed[warp] = dls;
  __syncthreads();
  if (tid == 0) {
    const double tot = sRed[0] + sRed[1] + sRed[2] + sRed[3];
    dls_part[((size_t)b * gridDim.x + blockIdx.x) * nH + h] =
        ls < TC_LN100 ? tot : 0.0;
  }
}

// ---------------------------------------------------------------------------
// K3: dbias alone, windows innermost (mmde_tpu/ops/window_attention_packed.py
// ::_dbias_body, driven by _pallas_dbias; MMDE_ATTN_GRID=split). One block
// per (64-query tile, 64-key tile, head) sweeps every window in one fixed
// order and keeps its 64 x 64 fp32 dbias tile in accumulator layout in
// registers (each warp 16 query rows x 64 keys, 32 floats a lane), stored
// once: no atomics, the same bits on every run. Per window it forms S and
// dP as the dq pass (bwd_dq_tc_kernel) forms them - the same operands,
// norms, products and epilogue, in the same order - rebuilds p from the
// forward's statistic (fp32: hi + lo, F3) and adds p (dP - delta) with the
// dq pass's delta. With a mask the windows go type-major, b = s nW + t for
// each type t and sample s (the JAX grid's (nW, S) order): the mask tile
// is staged once a type (two buffers, by the type's parity), the bias tile
// once a block. The K / V tiles are double-buffered across windows by
// cp.async (fp32: one staging buffer, split into bf16 planes, the next
// window's copies issued after the split pass), the block's own q and g
// rows come as A fragments straight from L2, issued before each window's
// barrier. Bound on an H100: two N x N x 32 products a (window, head), no
// output but dbias itself; the products' operands stream from L2 (the k
// and v tiles are read by every query tile of their head).
// ---------------------------------------------------------------------------
template <template <typename> class L, typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT)
bwd_dbias_tc_kernel(L<const T> q, L<const T> k, L<const T> v,
                    L<const T> g, const float* __restrict__ logit_scale,
                    const TB* __restrict__ bias, const TB* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dbias, int B_, int N, int nW) {
  using P = Pieces<T, MXU>;
  constexpr bool F32 = P::F32;
  constexpr int PS = P::PS;
  constexpr bool RB = MXU == MXU_BF16;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sK[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRk[2][TC_BT];
  // fp32: the K / V staging and planes (Pieces); then the bias tile and,
  // masked, the two mask tiles
  extern __shared__ __align__(128) char sBM[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, k0 = blockIdx.y * TC_BT;
  const int h = blockIdx.z, nH = gridDim.z;
  const bool masked = mask != nullptr;
  const int S = masked ? B_ / nW : B_;   // samples a window type
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], TC_LN100));
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  float* sStg = reinterpret_cast<float*>(sBM);
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 2 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;
  char* sB = sBM + P::kTiles;
  auto mask_tile = [&](int type) {
    return sB + (1 + (type & 1)) * btile_bytes<TB>();
  };
  // step s's window: type-major where masked
  auto window = [&](int s) { return masked ? (s % S) * nW + s / S : s; };

  // MapRows: the key tile's pixels from a window's corner (TileRows), the
  // same in every window, so filled once for the whole sweep; Rows ignores
  // the table
  __shared__ int sTab[TC_BT];
  if constexpr (TileRows<L<const T>>::kTable) {
    TileRows<L<const T>>::fill(sTab, k, k0, tid);
    __syncthreads();
  }

  auto issue = [&](int s) {     // step s's K, V (bias, mask) -> stage s & 1
    const int st = s & 1, b = window(s);
    if constexpr (F32) {
      load_tile_f32(sStg, k.head(b, h), k, sTab, k0, N, tid);
      load_tile_f32(sStg + TC_STAGE_F32, v.head(b, h), v, sTab, k0, N, tid);
    } else {
      load_tile(sK[st], k.head(b, h), k, sTab, k0, N, tid);
      load_tile(sV[st], v.head(b, h), v, sTab, k0, N, tid);
    }
    if (async_b) {
      if (s == 0) load_btile(sB, bias_h, q0, k0, N, tid, true);
      if (masked && s % S == 0)
        load_btile(mask_tile(s / S), mask + (size_t)(b % nW) * N * N, q0,
                   k0, N, tid, true);
    }
    cp_async_commit();
  };
  issue(0);

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const float* lo_base = lse + (size_t)B_ * nH * N;   // fp32: lo (F3)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int step = 0; step < B_; ++step) {
    const int st = step & 1, b = window(step);
    const size_t stat0 = ((size_t)b * nH + h) * N;
    // the block's own rows of this window, issued before the wait
    uint32_t qa[PS][2][4], qs[2][4], ga[PS][2][4];
    float2 qx[2][4], gx[2][4];
    if constexpr (F32) {
      load_afrag_f32(qx, q.head(b, h), q, r0, N, t);
      load_afrag_f32(gx, g.head(b, h), g, r0, N, t);
    } else {
      load_afrag(qa[0], q.head(b, h), q, r0, N, t);
      load_afrag(ga[0], g.head(b, h), g, r0, N, t);
    }
    const float lse0 = ok0 ? lse[stat0 + r0] : 0.0f;
    const float lse1 = ok1 ? lse[stat0 + r1] : 0.0f;
    const float dl0 = ok0 ? delta[stat0 + r0] : 0.0f;
    const float dl1 = ok1 ? delta[stat0 + r1] : 0.0f;
    float lo0 = 0.0f, lo1 = 0.0f;
    if constexpr (F32) {
      lo0 = ok0 ? lo_base[stat0 + r0] : 0.0f;
      lo1 = ok1 ? lo_base[stat0 + r1] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (!F32) {
      if (step + 1 < B_) issue(step + 1);
    }
    if (!async_b) {
      if (step == 0) load_btile(sB, bias_h, q0, k0, N, tid, false);
      if (masked && step % S == 0)
        load_btile(mask_tile(step / S), mask + (size_t)(b % nW) * N * N, q0,
                   k0, N, tid, false);
    }
    if constexpr (F32) {
      // the split pass: warps 0-1 a K row each (its norm; "bf16": k^
      // rounded), warps 2-3 a V row
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      staged_row(sStg + (tid < TC_BT ? 0 : TC_STAGE_F32), r, x);
      if (tid < TC_BT) {
        const float rn = row_rnorm(x);
        sRk[st][r] = rn;
        put_row<PS, RB>(sKp, r, x, rn, 1.0f);
      } else {
        put_row<PS, false>(sVp, r, x, 1.0f, 1.0f);
      }
    } else {
      tile_norms<RB>(sK[st], sRk[st], 1.0f, tid);
    }
    __syncthreads();
    if constexpr (F32) {   // the staging is free again
      if (step + 1 < B_) issue(step + 1);
    }

    float rq0, rq1;
    if constexpr (F32) {
      float none0, none1;
      finish_operand<PS, true, RB || FQ>(qx, qa, lane, rq0, rq1, scale);
      finish_operand<PS, false, false>(gx, ga, lane, none0, none1, 1.0f);
    } else {
      row_norms(qa[0], rq0, rq1, lane);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) qs[ks][i] = qa[0][ks][i];
      if constexpr (RB) scale_afrag(qs, rq0, rq1, scale);
    }
    const float c0 = FQ ? 1.0f : MXU == MXU_FP32 ? rq0 : rq0 * scale;
    const float c1 = FQ ? 1.0f : MXU == MXU_FP32 ? rq1 : rq1 * scale;
    const char* tb = sB;
    const char* tm = mask_tile(masked ? step / S : 0);

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        if constexpr (F32) {
          uint32_t kb[PS][4], vb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(kb[p], sKp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(s[jj], qa, kb);
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_rows(vb[p], sVp + p * TC_PLANE, j, lane);
          mma_rows<PS, PS>(dp[jj], ga, vb);
        } else {
          uint32_t kb[4], vb[4];
          frag_rows(kb, sK[st], j, lane);
          mma(s[jj], qs[0], kb[0], kb[1]);
          mma(s[jj], qs[1], kb[2], kb[3]);
          frag_rows(vb, sV[st], j, lane);
          mma(dp[jj], ga[0][0], vb[0], vb[1]);
          mma(dp[jj], ga[0][1], vb[2], vb[3]);
        }
      }
      // p = exp(s - lse), 0 past the edge: the dq pass's epilogue
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int col = k0 + cl;
        const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
        const bool in1 = col + 1 < N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* x = &s[jj][2 * half];
          if (col >= N || !(half ? ok1 : ok0)) {
            x[0] = x[1] = 0.0f;
            continue;
          }
          const int rl = warp * 16 + (lane >> 2) + 8 * half;  // tile row
          const float c = half ? c1 : c0;
          const float ls2 = (half ? lse1 : lse0) * TC_LOG2E;
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
            if constexpr (F32)   // F3: p = exp((s - hi) - lo)
              x[e] = ex2((((y + (e ? bm.y : bm.x)) - (half ? lse1 : lse0)) -
                          (half ? lo1 : lo0)) * TC_LOG2E);
            else
              x[e] = ex2(fmaf(y + (e ? bm.y : bm.x), TC_LOG2E, -ls2));
          }
          if (!in1) x[1] = 0.0f;
        }
      }
      // dbias += p (dp - delta), window after window
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float* a = acc[2 * kk + jj];
        a[0] = fmaf(s[jj][0], dp[jj][0] - dl0, a[0]);
        a[1] = fmaf(s[jj][1], dp[jj][1] - dl0, a[1]);
        a[2] = fmaf(s[jj][2], dp[jj][2] - dl1, a[2]);
        a[3] = fmaf(s[jj][3], dp[jj][3] - dl1, a[3]);
      }
    }
  }

  float* dbias_h = dbias + (size_t)h * N * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = k0 + 8 * n + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      if (row >= N) continue;
      if (col < N) dbias_h[(size_t)row * N + col] = acc[n][2 * half];
      if (col + 1 < N) dbias_h[(size_t)row * N + col + 1] = acc[n][2 * half + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// K5: W consecutive windows per block (mmde_tpu/ops/window_attention_packed.py
// ::_bwd_body with w > 1). Both passes walk their tile axis outermost and the
// W windows innermost: each outer tile's bias tile is staged once for the W
// windows, each (tile, window) step streams that window's tiles and its own
// mask tile. What a window carries between outer tiles lives in shared
// memory in fragment order (a lane's own float4s): the dq pass's dq
// accumulators and {lse, delta} of its rows, the dk/dv pass's dk^ and dv
// accumulators. The A fragments of the block's own rows (q, g; k, v) come
// back from L2 each step, their norms recomputed by the same chain. Per
// window the arithmetic is the W = 1 passes', step for step. The dk/dv pass
// sums the W windows' ds tiles in registers, in window order, before its
// 16-byte dbias atomics: W times fewer atomics, each adding a W-window sum
// (dbias is therefore summed in another order than at W = 1: in fp32, within
// the same tolerance).
// ---------------------------------------------------------------------------
constexpr int W_MAX = 8;   // windows a block holds

// fp32 qkv (T = float): every operand in three bf16 pieces (the "bf16"
// mode: one rounding), the streamed tiles staged in fp32 and split into
// bf16 planes once they arrived (window_attention_tc.cuh), the forward's
// statistic read as hi + lo (F3): p = exp((s - hi) - lo), dlogit_scale
// summed as ds * (sc - hi), as the W = 1 passes sum it. Per window the
// arithmetic is the bf16 passes' with split products.
template <typename T, int MXU>
struct WPieces {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool RB = MXU == MXU_BF16;
  static constexpr int PS = F32 && !RB ? 3 : 1;   // staged / loaded
  static constexpr int PR = RB ? 1 : F32 ? 3 : 2;  // formed in registers
};

// Both W passes bound to one block an SM at least: ptxas then takes the
// registers they need (without it, 4 bytes spilled in the bf16 mode's dq
// pass and the fp32-tile dk/dv pass); shared memory decides how many fit.
template <typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT, 1)
bwd_dq_tc_w_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                   Rows<const T> g, const float* __restrict__ logit_scale,
                   const TB* __restrict__ bias, const TB* __restrict__ mask,
                   const float* __restrict__ lse, Rows<T> dq,
                   float* __restrict__ delta, int N, int nW, int W) {
  using WP = WPieces<T, MXU>;
  constexpr bool F32 = WP::F32;
  constexpr int PS = WP::PS, PR = WP::PR;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sK[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRk[2][TC_BT];
  // dynamic: bias tiles [2] (by key tile), mask tiles [2] (by step), then
  // per window dq [4 warps][4 n][32 lanes] and {lse0, lse1, d0, d1} [4][32]
  // (d: the lane's delta partial, over the first sweep); fp32: per window
  // {lo0, lo1} [4][32], the K / V staging [2 stages][2] and planes
  extern __shared__ __align__(128) char sW[];
  const bool masked = mask != nullptr;
  char* sB = sW;
  char* sM = sB + 2 * btile_bytes<TB>();
  float4* sA = reinterpret_cast<float4*>(sM + (masked ? 2 : 0) *
                                                  btile_bytes<TB>());
  float4* sS = sA + W * 4 * 4 * 32;
  float2* sLo = reinterpret_cast<float2*>(sS + W * 4 * 32);
  float* sStg = reinterpret_cast<float*>(sLo + W * 4 * 32);
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 4 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;

  constexpr bool RB = MXU == MXU_BF16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, h = blockIdx.y, b0 = blockIdx.z * W;
  const int nH = gridDim.y;
  const TB* bias_h = bias + (size_t)h * N * N;
  const float scale = expf(fminf(logit_scale[h], TC_LN100));
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int per_pass = nt * W;
  const int steps = 2 * per_pass;   // delta first, then ds
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;

  auto issue = [&](int s) {
    const int st = s & 1, rr = s % per_pass, kn = (rr / W) * TC_BT;
    const int b = b0 + rr % W;
    if constexpr (F32) {
      load_tile_f32(sStg + 2 * st * TC_STAGE_F32, k.head(b, h), k, kn, N,
                    tid);
      load_tile_f32(sStg + (2 * st + 1) * TC_STAGE_F32, v.head(b, h), v, kn,
                    N, tid);
    } else {
      load_tile(sK[st], k.head(b, h), k, kn, N, tid);
      load_tile(sV[st], v.head(b, h), v, kn, N, tid);
    }
    if (async_b) {
      if (rr % W == 0)
        load_btile(sB + ((s / W) & 1) * btile_bytes<TB>(), bias_h, q0, kn, N,
                   tid, true);
      if (masked)
        load_btile(sM + st * btile_bytes<TB>(),
                   mask + (size_t)(b % nW) * N * N, q0, kn, N, tid, true);
    }
    cp_async_commit();
  };
  issue(0);

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  for (int i = tid; i < W * 4 * 4 * 32; i += TC_NT)
    sA[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int w = 0; w < W; ++w) {   // each lane its own rows' lse
    const size_t stat0 = ((size_t)(b0 + w) * nH + h) * N;
    sS[(w * 4 + warp) * 32 + lane] =
        make_float4(ok0 ? lse[stat0 + r0] : 0.0f,
                    ok1 ? lse[stat0 + r1] : 0.0f, 0.0f, 0.0f);
    if constexpr (F32) {   // F3: the statistic's lo, (2, B_, nH, N)
      const float* lo = lse + (size_t)gridDim.z * W * nH * N;
      sLo[(w * 4 + warp) * 32 + lane] =
          make_float2(ok0 ? lo[stat0 + r0] : 0.0f,
                      ok1 ? lo[stat0 + r1] : 0.0f);
    }
  }

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1, rr = step % per_pass, w = rr % W;
    const int b = b0 + w, k0 = (rr / W) * TC_BT;
    const bool first = step < per_pass;   // the delta sweep
    uint32_t qa[PS][2][4], ga[PS][2][4];
    float2 qx[2][4], gx[2][4];   // fp32: the raw rows, split after the waits
    if constexpr (F32) {
      load_afrag_f32(qx, q.head(b, h), q, r0, N, t);
      load_afrag_f32(gx, g.head(b, h), g, r0, N, t);
    } else {
      load_afrag(qa[0], q.head(b, h), q, r0, N, t);
      load_afrag(ga[0], g.head(b, h), g, r0, N, t);
    }
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) issue(step + 1);
    const char* tb = sB + ((step / W) & 1) * btile_bytes<TB>();
    const char* tm = sM + st * btile_bytes<TB>();
    if (!async_b) {
      if (w == 0)
        load_btile(const_cast<char*>(tb), bias_h, q0, k0, N, tid, false);
      if (masked)
        load_btile(const_cast<char*>(tm), mask + (size_t)(b % nW) * N * N,
                   q0, k0, N, tid, false);
    }
    if constexpr (F32) {
      // the split pass: warps 0-1 a K row each (its norm; "bf16": k^
      // rounded), warps 2-3 a V row
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      staged_row(sStg + (2 * st + (tid < TC_BT ? 0 : 1)) * TC_STAGE_F32, r,
                 x);
      if (tid < TC_BT) {
        const float rn = row_rnorm(x);
        sRk[st][r] = rn;
        put_row<PS, RB>(sKp, r, x, rn, 1.0f);
      } else {
        put_row<PS, false>(sVp, r, x, 1.0f, 1.0f);
      }
    } else {
      tile_norms<RB>(sK[st], sRk[st], 1.0f, tid);
    }
    __syncthreads();
    const bf16* kt = sK[st];
    const bf16* vt = sV[st];
    if constexpr (F32) {
      kt = sKp;
      vt = sVp;
    }

    float rq0, rq1;
    if constexpr (F32) {
      float none0, none1;
      finish_operand<PS, true, RB || FQ>(qx, qa, lane, rq0, rq1, scale);
      finish_operand<PS, false, false>(gx, ga, lane, none0, none1, 1.0f);
    } else {
      row_norms(qa[0], rq0, rq1, lane);
      if constexpr (RB) scale_afrag(qa[0], rq0, rq1, scale);   // qs
    }
    const float c0 = FQ ? 1.0f : MXU == MXU_FP32 ? rq0 : rq0 * scale;
    const float c1 = FQ ? 1.0f : MXU == MXU_FP32 ? rq1 : rq1 * scale;
    float4* sa = sA + (w * 4 + warp) * 4 * 32 + lane;
    float4* ss = sS + (w * 4 + warp) * 32 + lane;
    const float4 stat = *ss;
    const float lse0 = stat.x, lse1 = stat.y;
    float2 lo = make_float2(0.0f, 0.0f);
    if constexpr (F32) lo = sLo[(w * 4 + warp) * 32 + lane];
    float dpart0 = stat.z, dpart1 = stat.w, dl0 = 0.0f, dl1 = 0.0f;
    // fp32: this step's products in fresh registers, added to the window's
    // dq by the CUDA cores (round to nearest; the tensor cores' sums round
    // toward zero, a running sum in their accumulator would drift low)
    float acc[4][4];
    if (!first) {
      dl0 = quad_sum(dpart0);
      dl1 = quad_sum(dpart1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if constexpr (F32) {
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
        } else {
          const float4 x = sa[n * 32];
          acc[n][0] = x.x;
          acc[n][1] = x.y;
          acc[n][2] = x.z;
          acc[n][3] = x.w;
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4], f[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        uint32_t kb[PS][4], vb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(kb[p], kt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(s[jj], qa, kb);
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(vb[p], vt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(dp[jj], ga, vb);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int col = k0 + cl;
        const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
        f[jj][0] = RB ? 1.0f : scale * rk[0];
        f[jj][1] = RB ? 1.0f : scale * rk[1];
        const bool in1 = col + 1 < N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* x = &s[jj][2 * half];
          if (col >= N || !(half ? ok1 : ok0)) {
            x[0] = x[1] = 0.0f;
            continue;
          }
          const int rl = warp * 16 + (lane >> 2) + 8 * half;
          const float c = half ? c1 : c0;
          const float ls2 = (half ? lse1 : lse0) * TC_LOG2E;
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
            if constexpr (F32)   // F3: p = exp((s - hi) - lo)
              x[e] = ex2((((y + (e ? bm.y : bm.x)) - (half ? lse1 : lse0)) -
                          (half ? lo.y : lo.x)) * TC_LOG2E);
            else
              x[e] = ex2(fmaf(y + (e ? bm.y : bm.x), TC_LOG2E, -ls2));
          }
          if (!in1) x[1] = 0.0f;
        }
      }
      if (first) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          dpart0 += s[jj][0] * dp[jj][0] + s[jj][1] * dp[jj][1];
          dpart1 += s[jj][2] * dp[jj][2] + s[jj][3] * dp[jj][3];
        }
        continue;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        dp[jj][0] = s[jj][0] * (dp[jj][0] - dl0);
        dp[jj][1] = s[jj][1] * (dp[jj][1] - dl0);
        dp[jj][2] = s[jj][2] * (dp[jj][2] - dl1);
        dp[jj][3] = s[jj][3] * (dp[jj][3] - dl1);
      }
      uint32_t a[PR][4];
      afrag_p<PR>(dp[0], dp[1], f[0], f[1], a);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t kb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_cols(kb[p], kt + p * TC_PLANE, kk, c, lane);
        mma_cols<PR, PS>(acc[2 * c], acc[2 * c + 1], a, kb);
      }
    }
    if (first) {
      *ss = make_float4(lse0, lse1, dpart0, dpart1);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if constexpr (F32) {
          const float4 x = sa[n * 32];
          acc[n][0] += x.x;
          acc[n][1] += x.y;
          acc[n][2] += x.z;
          acc[n][3] += x.w;
        }
        sa[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      }
    }
  }

  // every window: delta out, dq = rq (dqn - q^ (dqn . q^)) (each lane reads
  // back its own state)
  for (int w = 0; w < W; ++w) {
    const int b = b0 + w;
    const size_t stat0 = ((size_t)b * nH + h) * N;
    const float4* sa = sA + (w * 4 + warp) * 4 * 32 + lane;
    const float4 stat = sS[(w * 4 + warp) * 32 + lane];
    const float dl0 = quad_sum(stat.z), dl1 = quad_sum(stat.w);
    if (t == 0) {
      if (ok0) delta[stat0 + r0] = dl0;
      if (ok1) delta[stat0 + r1] = dl1;
    }
    uint32_t qa[F32 ? 3 : 1][2][4];   // the raw q (fp32: exact in three)
    float rq0, rq1;
    load_operand<T, F32 ? 3 : 1, true, false>(qa, q.head(b, h), q, r0, N,
                                              lane, rq0, rq1, 1.0f);
    float dqn[4][4], dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 a = sa[n * 32];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = av[e];
        if constexpr (RB) x *= scale;
        const float qn = raw_at(qa, n, e >> 1, e & 1) * (e < 2 ? rq0 : rq1);
        dqn[n][e] = x;
        if (e < 2) dot0 = fmaf(x, qn, dot0);
        else dot1 = fmaf(x, qn, dot1);
      }
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dq_bh = dq.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const float rq = half ? rq1 : rq0, dot = half ? dot1 : dot0;
        store_pair(dq_bh + dq.off(half ? r1 : r0) + 8 * n,
                   rq * (dqn[n][2 * half] - raw_at(qa, n, half, 0) * rq * dot),
                   rq * (dqn[n][2 * half + 1] -
                         raw_at(qa, n, half, 1) * rq * dot));
      }
  }
}

template <typename T, typename TB, int MXU>
__global__ void __launch_bounds__(TC_NT, 1)
bwd_dkv_tc_w_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                    Rows<const T> g, const float* __restrict__ logit_scale,
                    const TB* __restrict__ bias, const TB* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Rows<T> dk, Rows<T> dv,
                    double* __restrict__ dls_part, float* __restrict__ dbias,
                    int N, int nW, int W) {
  using WP = WPieces<T, MXU>;
  constexpr bool F32 = WP::F32;
  constexpr int PS = WP::PS, PR = WP::PR;
  // fp32 "fold": the folded q^ * scale is the operand split in three
  constexpr bool FQ = F32 && MXU == MXU_FOLD;
  __shared__ __align__(128) bf16 sQ[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sG[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRq[2][TC_BT];
  __shared__ float sLse[2][TC_BT];
  __shared__ float sDl[2][TC_BT];
  __shared__ float sLo[2][F32 ? TC_BT : 1];   // fp32: the statistic's lo
  __shared__ double sRed[4];
  // dynamic: bias tiles [2] (by query tile), mask tiles [2] (by step), then
  // per window dv and dk^ [2][4 warps][4 n][32 lanes]; fp32: the Q / G
  // staging [2 stages][2] and planes
  extern __shared__ __align__(128) char sW[];
  const bool masked = mask != nullptr;
  char* sB = sW;
  char* sM = sB + 2 * btile_bytes<TB>();
  float4* sAcc = reinterpret_cast<float4*>(sM + (masked ? 2 : 0) *
                                                    btile_bytes<TB>());
  float* sStg = reinterpret_cast<float*>(sAcc + W * 2 * 4 * 4 * 32);
  bf16* sQp = reinterpret_cast<bf16*>(sStg + 4 * TC_STAGE_F32);
  bf16* sGp = sQp + PS * TC_PLANE;

  constexpr bool RB = MXU == MXU_BF16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int k0 = blockIdx.x * TC_BT, h = blockIdx.y, b0 = blockIdx.z * W;
  const int nH = gridDim.y;
  const TB* bias_h = bias + (size_t)h * N * N;
  float* dbias_h = dbias != nullptr ? dbias + (size_t)h * N * N : nullptr;
  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, TC_LN100));
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int steps = nt * W;
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;

  // step s = (query tile, window): Q, G, lse, delta and the window's mask
  // tile -> stage s & 1; with the first window of a query tile its bias
  // tile -> stage (s / W) & 1
  auto load = [&](int s) {
    const int st = s & 1, q0 = (s / W) * TC_BT, b = b0 + s % W;
    const size_t stat0 = ((size_t)b * nH + h) * N;
    if constexpr (F32) {
      load_tile_f32(sStg + 2 * st * TC_STAGE_F32, q.head(b, h), q, q0, N,
                    tid);
      load_tile_f32(sStg + (2 * st + 1) * TC_STAGE_F32, g.head(b, h), g, q0,
                    N, tid);
    } else {
      load_tile(sQ[st], q.head(b, h), q, q0, N, tid);
      load_tile(sG[st], g.head(b, h), g, q0, N, tid);
    }
    if (async_b) {
      if (s % W == 0)
        load_btile(sB + ((s / W) & 1) * btile_bytes<TB>(), bias_h, q0, k0, N,
                   tid, true);
      if (masked)
        load_btile(sM + st * btile_bytes<TB>(),
                   mask + (size_t)(b % nW) * N * N, q0, k0, N, tid, true);
    }
    const int j = tid & (TC_BT - 1);
    const bool ok = q0 + j < N;
    const float* src = (tid < TC_BT ? lse : delta) + stat0 + (ok ? q0 + j : 0);
    cp_async4(tid < TC_BT ? &sLse[st][j] : &sDl[st][j], src, ok);
    if constexpr (F32) {   // F3: lo, (2, B_, nH, N)
      if (tid < TC_BT)
        cp_async4(&sLo[st][j],
                  lse + (size_t)gridDim.z * W * nH * N + stat0 +
                      (ok ? q0 + j : 0),
                  ok);
    }
    cp_async_commit();
  };
  load(0);

  for (int i = tid; i < W * 2 * 4 * 4 * 32; i += TC_NT)
    sAcc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int r0 = k0 + warp * 16 + (lane >> 2), r1 = r0 + 8;   // keys
  const bool ok0 = r0 < N, ok1 = r1 < N;
  float dsum[8][4];   // ds over the W windows of one query tile
  double dls = 0.0;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1, w = step % W, b = b0 + w;
    const int q0 = (step / W) * TC_BT;
    uint32_t ka[PS][2][4], va[PS][2][4];
    float2 kx[2][4], vx[2][4];   // fp32: the raw rows, split after the waits
    if constexpr (F32) {
      load_afrag_f32(kx, k.head(b, h), k, r0, N, t);
      load_afrag_f32(vx, v.head(b, h), v, r0, N, t);
    } else {
      load_afrag(ka[0], k.head(b, h), k, r0, N, t);
      load_afrag(va[0], v.head(b, h), v, r0, N, t);
    }
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    const char* tb = sB + ((step / W) & 1) * btile_bytes<TB>();
    const char* tm = sM + st * btile_bytes<TB>();
    if (!async_b) {
      if (w == 0)
        load_btile(const_cast<char*>(tb), bias_h, q0, k0, N, tid, false);
      if (masked)
        load_btile(const_cast<char*>(tm), mask + (size_t)(b % nW) * N * N,
                   q0, k0, N, tid, false);
    }
    if constexpr (F32) {
      // the split pass: warps 0-1 a Q row each (its norm; "bf16": q^ *
      // scale rounded), warps 2-3 a G row
      const int r = tid & (TC_BT - 1);
      float x[TC_DH];
      staged_row(sStg + (2 * st + (tid < TC_BT ? 0 : 1)) * TC_STAGE_F32, r,
                 x);
      if (tid < TC_BT) {
        const float rn = row_rnorm(x);
        sRq[st][r] = rn;
        put_row<PS, RB || FQ>(sQp, r, x, rn, scale);
      } else {
        put_row<PS, false>(sGp, r, x, 1.0f, 1.0f);
      }
    } else {
      tile_norms<RB>(sQ[st], sRq[st], scale, tid);
    }
    __syncthreads();
    const bf16* qt = sQ[st];
    const bf16* gt = sG[st];
    if constexpr (F32) {
      qt = sQp;
      gt = sGp;
    }

    float rk0, rk1;
    if constexpr (F32) {
      float none0, none1;
      finish_operand<PS, true, RB>(kx, ka, lane, rk0, rk1, 1.0f);
      finish_operand<PS, false, false>(vx, va, lane, none0, none1, 1.0f);
    } else {
      row_norms(ka[0], rk0, rk1, lane);
      if constexpr (RB) scale_afrag(ka[0], rk0, rk1, 1.0f);   // bf16(k^)
    }
    float4* sv = sAcc + ((w * 2) * 4 + warp) * 4 * 32 + lane;
    float4* sk = sAcc + ((w * 2 + 1) * 4 + warp) * 4 * 32 + lane;
    // fp32: this step's products in fresh registers, added to the window's
    // dv and dk^ by the CUDA cores after them (as the dq pass)
    float accV[4][4], accK[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if constexpr (F32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) accV[n][e] = accK[n][e] = 0.0f;
      } else {
        const float4 x = sv[n * 32], y = sk[n * 32];
        accV[n][0] = x.x; accV[n][1] = x.y; accV[n][2] = x.z;
        accV[n][3] = x.w;
        accK[n][0] = y.x; accK[n][1] = y.y; accK[n][2] = y.z;
        accK[n][3] = y.w;
      }
    }

    float dls_t = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], dp[2][4], f[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        uint32_t qb[PS][4], gb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(qb[p], qt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(s[jj], ka, qb);
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(gb[p], gt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(dp[jj], va, gb);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int i = q0 + cl;
        const float rq[2] = {sRq[st][cl], sRq[st][cl + 1]};
        const float ls2[2] = {sLse[st][cl] * TC_LOG2E,
                              sLse[st][cl + 1] * TC_LOG2E};
        float hi2[2] = {0.0f, 0.0f}, lo2[2] = {0.0f, 0.0f};
        if constexpr (F32) {
          hi2[0] = sLse[st][cl];
          hi2[1] = sLse[st][cl + 1];
          lo2[0] = sLo[st][cl];
          lo2[1] = sLo[st][cl + 1];
        }
        const float dl[2] = {sDl[st][cl], sDl[st][cl + 1]};
        f[jj][0] = RB || FQ ? 1.0f : scale * rq[0];
        f[jj][1] = RB || FQ ? 1.0f : scale * rq[1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kl = warp * 16 + (lane >> 2) + 8 * half;
          const float rk = half ? rk1 : rk0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[jj][2 * half + e];
            float& d = dp[jj][2 * half + e];
            if (!(half ? ok1 : ok0) || i + e >= N) {
              x = d = 0.0f;
              continue;
            }
            float sc = x;
            if constexpr (MXU == MXU_FP32) sc = sc * rq[e] * rk * scale;
            else if constexpr (FQ) sc = sc * rk;
            else if constexpr (MXU == MXU_FOLD) sc = sc * (scale * rq[e]) * rk;
            float y = sc + btile_at<TB>(tb, cl + e, kl);
            if (masked) y += btile_at<TB>(tm, cl + e, kl);
            if constexpr (F32)   // F3: p = exp((s - hi) - lo)
              x = ex2(((y - hi2[e]) - lo2[e]) * TC_LOG2E);
            else
              x = ex2(fmaf(y, TC_LOG2E, -ls2[e]));
            d = x * (d - dl[e]);
            // fp32: sum(ds * (sc - lse)), as bwd_dkv_tc_kernel sums it
            if constexpr (F32) dls_t = fmaf(d, sc - hi2[e], dls_t);
            else dls_t = fmaf(d, sc, dls_t);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsum[2 * kk + jj][e] =
              w == 0 ? dp[jj][e] : dsum[2 * kk + jj][e] + dp[jj][e];
      }
      if (dbias_h != nullptr && w == W - 1) {
        // the W windows' ds: bwd_dkv_tc_kernel's transpose and atomics
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int i = q0 + 8 * (2 * kk + jj) + 2 * t;
          const float* x = dsum[2 * kk + jj];
          if ((N & 3) == 0) {
            const int m = (lane >> 2) & 3;
            float got[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float send = pick4(x, m ^ r);
              got[r] = r == 0 ? send
                              : __shfl_xor_sync(0xffffffffu, send, 4 * r);
            }
            const int key = k0 + warp * 16 + 4 * (lane >> 4) + 8 * (m >> 1);
            const int qi = i + (m & 1);
            if (key < N && qi < N)
              atomic_add4(dbias_h + (size_t)qi * N + key, pick4(got, m),
                          pick4(got, m ^ 1), pick4(got, m ^ 2),
                          pick4(got, m ^ 3));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = e < 2 ? r0 : r1, ii = i + (e & 1);
              if (key < N && ii < N)
                atomicAdd(dbias_h + (size_t)ii * N + key, x[e]);
            }
          }
        }
      }
      uint32_t pa[PR][4], da[PR][4];
      const float one[2] = {1.0f, 1.0f};
      afrag_p<PR>(s[0], s[1], one, one, pa);
      afrag_p<PR>(dp[0], dp[1], f[0], f[1], da);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t gb[PS][4], qb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_cols(gb[p], gt + p * TC_PLANE, kk, c, lane);
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_cols(qb[p], qt + p * TC_PLANE, kk, c, lane);
        mma_cols2<PR, PS>(accV[2 * c], accV[2 * c + 1], pa, gb, accK[2 * c],
                          accK[2 * c + 1], da, qb);
      }
    }
    dls += dls_t;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if constexpr (F32) {
        const float4 x = sv[n * 32], y = sk[n * 32];
        accV[n][0] += x.x; accV[n][1] += x.y; accV[n][2] += x.z;
        accV[n][3] += x.w;
        accK[n][0] += y.x; accK[n][1] += y.y; accK[n][2] += y.z;
        accK[n][3] += y.w;
      }
      sv[n * 32] = make_float4(accV[n][0], accV[n][1], accV[n][2], accV[n][3]);
      sk[n * 32] = make_float4(accK[n][0], accK[n][1], accK[n][2], accK[n][3]);
    }
  }

  // every window: dk = rk (dkn - k^ (dkn . k^)), dv (each lane reads back
  // its own state)
  for (int w = 0; w < W; ++w) {
    const int b = b0 + w;
    const float4* sv = sAcc + ((w * 2) * 4 + warp) * 4 * 32 + lane;
    const float4* sk = sAcc + ((w * 2 + 1) * 4 + warp) * 4 * 32 + lane;
    uint32_t ka[F32 ? 3 : 1][2][4];   // the raw k (fp32: exact in three)
    float rk0, rk1;
    load_operand<T, F32 ? 3 : 1, true, false>(ka, k.head(b, h), k, r0, N,
                                              lane, rk0, rk1, 1.0f);
    float accK[4][4], accV[4][4], dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 x = sv[n * 32], y = sk[n * 32];
      accV[n][0] = x.x; accV[n][1] = x.y; accV[n][2] = x.z; accV[n][3] = x.w;
      accK[n][0] = y.x; accK[n][1] = y.y; accK[n][2] = y.z; accK[n][3] = y.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kn = raw_at(ka, n, e >> 1, e & 1) * (e < 2 ? rk0 : rk1);
        if (e < 2) dot0 = fmaf(accK[n][e], kn, dot0);
        else dot1 = fmaf(accK[n][e], kn, dot1);
      }
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    T* dk_bh = dk.head(b, h) + 2 * t;
    T* dv_bh = dv.head(b, h) + 2 * t;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? ok1 : ok0)) continue;
        const int key = half ? r1 : r0;
        const float rk = half ? rk1 : rk0, dot = half ? dot1 : dot0;
        store_pair(dk_bh + dk.off(key) + 8 * n,
                   rk * (accK[n][2 * half] - raw_at(ka, n, half, 0) * rk * dot),
                   rk * (accK[n][2 * half + 1] -
                         raw_at(ka, n, half, 1) * rk * dot));
        store_pair(dv_bh + dv.off(key) + 8 * n, accV[n][2 * half],
                   accV[n][2 * half + 1]);
      }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    dls += __shfl_xor_sync(0xffffffffu, dls, off);
  if (lane == 0) sRed[warp] = dls;
  __syncthreads();
  if (tid == 0) {
    const double tot = sRed[0] + sRed[1] + sRed[2] + sRed[3];
    dls_part[((size_t)blockIdx.z * gridDim.x + blockIdx.x) * nH + h] =
        ls < TC_LN100 ? tot : 0.0;
  }
}

// dynamic shared memory of the W passes: bias and mask tiles, W windows'
// state (dq pass: dq and 4 floats a lane; dk/dv pass: dk^ and dv); fp32:
// the dq pass's 2 more floats a lane, the staging and the planes
template <typename T, typename TB, int MXU>
int w_bwd_bytes(bool masked, int W, bool dkv) {
  using WP = WPieces<T, MXU>;
  return (masked ? 4 : 2) * btile_bytes<TB>() +
         W * (dkv ? 2 * 4 * 4 * 32 : 4 * 4 * 32 + 4 * 32) * 16 +
         (WP::F32 ? (dkv ? 0 : W * 4 * 32 * 8) + 4 * TC_STAGE_F32 * 4 +
                        2 * WP::PS * TC_PLANE * 2
                  : 0);
}

// The operands' (window, head, token) layout, on the host.
template <template <typename> class L, typename T = bf16>
struct Operands {
  L<const T> q, k, v, g;
  L<T> dq, dk, dv;
  bool aligned() const {
    return rows_aligned(q) && rows_aligned(k) && rows_aligned(v) &&
           rows_aligned(g) && rows_aligned(dq) && rows_aligned(dk) &&
           rows_aligned(dv);
  }
};

// dynamic shared memory of the two passes: fp32 adds the staging, the
// planes and the running sums (dq pass one set, dk/dv pass two) before the
// bias and mask tiles
template <typename T, typename TB, int MXU>
int tc_bwd_bytes(bool masked, bool dkv) {
  using P = Pieces<T, MXU>;
  return (P::F32 ? P::kTiles + (dkv ? 2 : 1) * P::kState : 0) +
         bias_tiles_bytes<TB>(masked);
}

// Lets both passes take their masked (largest) dynamic shared memory.
template <template <typename> class L, typename T, typename TB, int MXU>
cudaError_t allow_tc_bwd_bytes() {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_tc_kernel<L, T, TB, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_bwd_bytes<T, TB, MXU>(true, false));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bwd_dkv_tc_kernel<L, T, TB, MXU>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              tc_bwd_bytes<T, TB, MXU>(true, true));
}

// The two passes on operands already described in layout L (Rows: any
// (window, head, token) strides; MapRows: windows of a map) of type T, rows
// 16-byte aligned; -1 where a row is not.
template <template <typename> class L, typename T, typename TB, int MXU>
int launch(const Operands<L, T>& o, const void* ls, const void* bias,
           const void* mask, const void* lse, void* delta, void* dls_part,
           void* dbias, int B_, int N, int nH, int nW, cudaStream_t stream) {
  if (!o.aligned()) return -1;
  const bool masked = mask != nullptr;
  cudaError_t err = allow_tc_bwd_bytes<L, T, TB, MXU>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, B_);
  bwd_dq_tc_kernel<L, T, TB, MXU>
      <<<grid, TC_NT, tc_bwd_bytes<T, TB, MXU>(masked, false), stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, o.dq, (float*)delta, N, nW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_tc_kernel<L, T, TB, MXU>
      <<<grid, TC_NT, tc_bwd_bytes<T, TB, MXU>(masked, true), stream>>>(
      o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
      (const TB*)mask, (const float*)lse, (const float*)delta, o.dk, o.dv,
      (double*)dls_part, (float*)dbias, N, nW);
  return (int)cudaGetLastError();
}

// qkv (B_, N, 3C), g (B_, N, C), dqkv (B_, N, 3C): the packed layout's Rows;
// T = float: fp32 qkv, g and dqkv, lse (2, B_, nH, N) hi then lo
template <typename T, typename TB, int MXU>
int launch_packed(const void* qkv, const void* g, const void* ls,
                  const void* bias, const void* mask, const void* lse,
                  void* dqkv, void* delta, void* dls_part, void* dbias,
                  int B_, int N, int nH, int nW, cudaStream_t stream) {
  const int C = nH * TC_DH;
  Operands<Rows, T> o;
  o.q = packed_rows((const T*)qkv, 0, N, C, 3, TC_DH);
  o.k = packed_rows((const T*)qkv, 1, N, C, 3, TC_DH);
  o.v = packed_rows((const T*)qkv, 2, N, C, 3, TC_DH);
  o.g = packed_rows((const T*)g, 0, N, C, 1, TC_DH);
  o.dq = packed_rows((T*)dqkv, 0, N, C, 3, TC_DH);
  o.dk = packed_rows((T*)dqkv, 1, N, C, 3, TC_DH);
  o.dv = packed_rows((T*)dqkv, 2, N, C, 3, TC_DH);
  return launch<Rows, T, TB, MXU>(o, ls, bias, mask, lse, delta, dls_part,
                                  dbias, B_, N, nH, nW, stream);
}

// The slab layout: qkv (B, Hp, Wp, 3C), g (B, Hp, Wp, C) and dqkv maps of
// type T, windows of ws x ws read and written in place (MapRows); mode
// MXU_FP32. T = float: lse (2, B_, nH, N) hi then lo
template <typename T, typename TB>
int launch_slab(const void* qkv, const void* g, const void* ls,
                const void* bias, const void* mask, const void* lse,
                void* dqkv, void* delta, void* dls_part, void* dbias, int B_,
                int Hp, int Wp, int C, int nH, int ws, cudaStream_t stream) {
  Operands<MapRows, T> o;
  o.q = map_rows((const T*)qkv, 0, C, 3, Hp, Wp, ws, TC_DH);
  o.k = map_rows((const T*)qkv, 1, C, 3, Hp, Wp, ws, TC_DH);
  o.v = map_rows((const T*)qkv, 2, C, 3, Hp, Wp, ws, TC_DH);
  o.g = map_rows((const T*)g, 0, C, 1, Hp, Wp, ws, TC_DH);
  o.dq = map_rows((T*)dqkv, 0, C, 3, Hp, Wp, ws, TC_DH);
  o.dk = map_rows((T*)dqkv, 1, C, 3, Hp, Wp, ws, TC_DH);
  o.dv = map_rows((T*)dqkv, 2, C, 3, Hp, Wp, ws, TC_DH);
  return launch<MapRows, T, TB, MXU_FP32>(o, ls, bias, mask, lse, delta,
                                          dls_part, dbias, B_, ws * ws, nH,
                                          (Hp / ws) * (Wp / ws), stream);
}

// Windows the dk/dv pass holds a block: W, or for fp32 qkv the largest
// divisor of W whose dk^ / dv state fits beside the staging, the planes and
// the static arrays (masked, 8 windows take 254 KB of the 227 KB a block may
// have: the pass then runs 4 windows a block, twice the blocks, and the dq
// pass keeps W). Decided from the shape and the device, before any launch.
template <typename T, typename TB, int MXU>
int dkv_windows(bool masked, int W) {
  if (!WPieces<T, MXU>::F32) return W;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, bwd_dkv_tc_w_kernel<T, TB, MXU>) !=
          cudaSuccess)
    return -1;
  int wd = W;
  while (wd > 1 && w_bwd_bytes<T, TB, MXU>(masked, wd, true) +
                           (int)fa.sharedSizeBytes > optin) {
    --wd;
    while (W % wd != 0) --wd;
  }
  return wd;
}

// K5's two passes on the packed layout, W windows per block (the dk/dv
// pass: dkv_windows); T = float: fp32 qkv, g and dqkv, lse (2, B_, nH, N)
// hi then lo. The bf16 passes take the shared memory of W_MAX masked
// windows once; the fp32 ones that of the launch
template <typename T, typename TB, int MXU>
int launch_packed_w(const void* qkv, const void* g, const void* ls,
                    const void* bias, const void* mask, const void* lse,
                    void* dqkv, void* delta, void* dls_part, void* dbias,
                    int B_, int N, int nH, int nW, int W,
                    cudaStream_t stream) {
  const int C = nH * TC_DH;
  Operands<Rows, T> o;
  o.q = packed_rows((const T*)qkv, 0, N, C, 3, TC_DH);
  o.k = packed_rows((const T*)qkv, 1, N, C, 3, TC_DH);
  o.v = packed_rows((const T*)qkv, 2, N, C, 3, TC_DH);
  o.g = packed_rows((const T*)g, 0, N, C, 1, TC_DH);
  o.dq = packed_rows((T*)dqkv, 0, N, C, 3, TC_DH);
  o.dk = packed_rows((T*)dqkv, 1, N, C, 3, TC_DH);
  o.dv = packed_rows((T*)dqkv, 2, N, C, 3, TC_DH);
  if (!o.aligned()) return -1;
  const bool masked = mask != nullptr;
  const bool f32 = WPieces<T, MXU>::F32;
  const int Wd = dkv_windows<T, TB, MXU>(masked, W);
  if (Wd < 1) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_tc_w_kernel<T, TB, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      f32 ? w_bwd_bytes<T, TB, MXU>(masked, W, false)
          : w_bwd_bytes<T, TB, MXU>(true, W_MAX, false));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd_dkv_tc_w_kernel<T, TB, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      f32 ? w_bwd_bytes<T, TB, MXU>(masked, Wd, true)
          : w_bwd_bytes<T, TB, MXU>(true, W_MAX, true));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, B_ / W);
  bwd_dq_tc_w_kernel<T, TB, MXU>
      <<<grid, TC_NT, w_bwd_bytes<T, TB, MXU>(masked, W, false), stream>>>(
          o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
          (const TB*)mask, (const float*)lse, o.dq, (float*)delta, N, nW, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grid.z = B_ / Wd;
  bwd_dkv_tc_w_kernel<T, TB, MXU>
      <<<grid, TC_NT, w_bwd_bytes<T, TB, MXU>(masked, Wd, true), stream>>>(
          o.q, o.k, o.v, o.g, (const float*)ls, (const TB*)bias,
          (const TB*)mask, (const float*)lse, (const float*)delta, o.dk,
          o.dv, (double*)dls_part, (float*)dbias, N, nW, Wd);
  return (int)cudaGetLastError();
}

// dynamic shared memory of K3: fp32 adds the staging and the planes before
// the bias tile and, masked, the two mask tiles
template <typename T, typename TB, int MXU>
int dbias_tc_bytes(bool masked) {
  return Pieces<T, MXU>::kTiles + (masked ? 3 : 1) * btile_bytes<TB>();
}

// K3 on operands already described in layout L (Rows: the packed layout's
// column blocks or the head-split views' strides; MapRows: the slab's
// windows of a map), rows 16-byte aligned; -1 where a row is not. dbias
// (nH, N, N) fp32, every element written once.
template <template <typename> class L, typename T, typename TB, int MXU>
int launch_dbias(const L<const T>& q, const L<const T>& k,
                 const L<const T>& v, const L<const T>& g,
                 const void* ls, const void* bias, const void* mask,
                 const void* lse, const void* delta, void* dbias, int B_,
                 int N, int nH, int nW, cudaStream_t stream) {
  if (!rows_aligned(q) || !rows_aligned(k) || !rows_aligned(v) ||
      !rows_aligned(g))
    return -1;
  const bool masked = mask != nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dbias_tc_kernel<L, T, TB, MXU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      dbias_tc_bytes<T, TB, MXU>(true));
  if (err != cudaSuccess) return (int)err;
  const int nt = (N + TC_BT - 1) / TC_BT;
  dim3 grid(nt, nt, nH);
  bwd_dbias_tc_kernel<L, T, TB, MXU>
      <<<grid, TC_NT, dbias_tc_bytes<T, TB, MXU>(masked), stream>>>(
          q, k, v, g, (const float*)ls, (const TB*)bias, (const TB*)mask,
          (const float*)lse, (const float*)delta, (float*)dbias, B_, N, nW);
  return (int)cudaGetLastError();
}

// K3's arguments as the two entries check them
bool dbias_shape_ok(int B_, int N, int nH, int nW, const void* mask,
                    const void* dbias, int qkv_bf16, int bias_bf16) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535 || dbias == nullptr)
    return false;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return false;
  return qkv_bf16 || !bias_bf16;
}

bool shape_ok(int B_, int N, int nH, int nW, const void* mask,
              int dbias_mode, const void* dbias) {
  if (B_ <= 0 || N <= 0 || nH <= 0 || B_ > 65535 || nH > 65535) return false;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return false;
  if (dbias_mode < 0 || dbias_mode > 1) return false;
  return dbias_mode == 0 || dbias != nullptr;
}

}  // namespace

// Plain C entry. qkv (B_, N, 3C), g (B_, N, C) and dqkv (B_, N, 3C) bf16,
// C = 32 * nH; bias (nH, N, N) and mask (nW, N, N; may be null) bf16 when
// bias_bf16, else fp32. lse (B_, nH, N) fp32 from the forward; delta
// (B_, nH, N) fp32 and dls_part (B_ * ceil(N / 64), nH) fp64 are written
// (the caller sums dls_part over its first axis). dbias (nH, N, N) fp32
// receives dbias by atomics when dbias_mode = 1 (the caller zeroes it
// first); dbias_mode 0: no dbias (may be null). qkv_bf16 0: fp32 qkv, g and
// dqkv (and fp32 bias), every operand in three bf16 pieces, lse (2, B_, nH,
// N) hi then lo as mmde_window_attention_fwd_tc writes it (F3). mxu:
// MXU_FP32 / MXU_FOLD / MXU_BF16 (window_attention_common.cuh; -1 for
// another code). Returns the first CUDA error of the two launches, or -1
// for arguments the kernels do not take. Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int mmde_window_attention_bwd_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int dbias_mode, int mxu,
    void* stream) {
  if (C != nH * TC_DH || !shape_ok(B_, N, nH, nW, mask, dbias_mode, dbias))
    return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  void* db = dbias_mode == 1 ? dbias : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if constexpr (MXU == MXU_FOLD_PV) {
      return -1;
    } else if (!qkv_bf16) {
      return launch_packed<float, float, MXU>(qkv, g, logit_scale, bias,
                                              mask, lse, dqkv, delta,
                                              dls_part, db, B_, N, nH, nW, s);
    } else if (bias_bf16) {
      return launch_packed<bf16, bf16, MXU>(qkv, g, logit_scale, bias, mask,
                                            lse, dqkv, delta, dls_part, db,
                                            B_, N, nH, nW, s);
    } else {
      return launch_packed<bf16, float, MXU>(qkv, g, logit_scale, bias, mask,
                                             lse, dqkv, delta, dls_part, db,
                                             B_, N, nH, nW, s);
    }
  });
}

// K5's entry on the tensor cores: as mmde_window_attention_bwd_tc, with W
// (2 .. W_MAX, dividing B_, and nW where there is a mask) consecutive
// windows per block in both passes (fp32: the dk/dv pass at a divisor of W
// where W windows do not fit, dkv_windows); dls_part is (B_ * ceil(N / 64),
// nH), zeroed: the dk/dv pass writes one row a block, the rest stay 0.
// qkv_bf16 0: fp32 qkv, g and dqkv (and fp32 bias), every operand in three
// bf16 pieces, lse (2, B_, nH, N) hi then lo as
// mmde_window_attention_fwd_tc_w writes it (F3). -1 for a W or a type it
// does not take.
extern "C" int mmde_window_attention_bwd_tc_w(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int C, int nH,
    int nW, int qkv_bf16, int bias_bf16, int dbias_mode, int W, int mxu,
    void* stream) {
  if (C != nH * TC_DH || !shape_ok(B_, N, nH, nW, mask, dbias_mode, dbias))
    return -1;
  if (W < 2 || W > W_MAX || B_ % W != 0 || (mask != nullptr && nW % W != 0))
    return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  void* db = dbias_mode == 1 ? dbias : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if constexpr (MXU == MXU_FOLD_PV) {
      return -1;
    } else if (!qkv_bf16) {
      return launch_packed_w<float, float, MXU>(qkv, g, logit_scale, bias,
                                                mask, lse, dqkv, delta,
                                                dls_part, db, B_, N, nH, nW,
                                                W, s);
    } else if (bias_bf16) {
      return launch_packed_w<bf16, bf16, MXU>(qkv, g, logit_scale, bias,
                                              mask, lse, dqkv, delta,
                                              dls_part, db, B_, N, nH, nW, W,
                                              s);
    } else {
      return launch_packed_w<bf16, float, MXU>(qkv, g, logit_scale, bias,
                                               mask, lse, dqkv, delta,
                                               dls_part, db, B_, N, nH, nW, W,
                                               s);
    }
  });
}

// K3's pass alone on the tensor cores (MMDE_ATTN_GRID=split, after
// mmde_window_attention_bwd_tc or _tc_w with dbias_mode 0, on the delta
// they wrote): dbias (nH, N, N) fp32, every element written once, summed
// over the windows in one fixed order (type-major where masked): the same
// bits on every run. qkv, g, bias, mask, delta and the mode as for
// mmde_window_attention_bwd_tc; lse as that entry's forward wrote it: bf16
// qkv (B_, nH, N), fp32 qkv (2, B_, nH, N) hi then lo - lse_pair says
// which, and must be 0 for bf16 qkv and 1 for fp32 (the arithmetic that
// reads it is the dq pass's). Returns the CUDA error of the launch, or -1
// for arguments the kernel does not take. Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int mmde_window_attention_dbias_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, const void* delta,
    void* dbias, int B_, int N, int C, int nH, int nW, int qkv_bf16,
    int bias_bf16, int lse_pair, int mxu, void* stream) {
  if (C != nH * TC_DH ||
      !dbias_shape_ok(B_, N, nH, nW, mask, dbias, qkv_bf16, bias_bf16))
    return -1;
  if (lse_pair != (qkv_bf16 ? 0 : 1)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto t, auto tb, auto m) {
    using T = decltype(t);
    using TB = decltype(tb);
    constexpr int MXU = decltype(m)::value;
    return launch_dbias<Rows, T, TB, MXU>(
        packed_rows((const T*)qkv, 0, N, C, 3, TC_DH),
        packed_rows((const T*)qkv, 1, N, C, 3, TC_DH),
        packed_rows((const T*)qkv, 2, N, C, 3, TC_DH),
        packed_rows((const T*)g, 0, N, C, 1, TC_DH), logit_scale, bias, mask,
        lse, delta, dbias, B_, N, nH, nW, s);
  };
  return by_mode(mxu, [&](auto m) {
    constexpr int MXU = decltype(m)::value;
    if constexpr (MXU == MXU_FOLD_PV) {
      return -1;
    } else if (!qkv_bf16) {
      return run(0.0f, 0.0f, m);
    } else if (bias_bf16) {
      return run(bf16(), bf16(), m);
    } else {
      return run(bf16(), 0.0f, m);
    }
  });
}

// Head-split entry of K3 on the tensor cores (MMDE_ATTN_GRID=split, after
// mmde_window_attention_headsplit_bwd_tc with dbias_mode 0, on its delta):
// q, k, v, g, the twelve strides, bias, mask, lse, qkv_bf16 and bias_bf16
// as that entry takes them (mode MXU_FP32; bf16: lse (B_, nH, N), fp32:
// (2, B_, nH, N) hi then lo); dbias (nH, N, N) fp32, every element written
// once, windows type-major where masked. Returns the CUDA error of the
// launch, or -1 for arguments the kernel does not take (a row that is not
// 16-byte aligned among them). Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int mmde_window_attention_headsplit_dbias_tc(
    const void* q, const void* k, const void* v, const void* g,
    const void* strides, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* delta, void* dbias,
    int B_, int N, int nH, int nW, int qkv_bf16, int bias_bf16,
    void* stream) {
  if (strides == nullptr ||
      !dbias_shape_ok(B_, N, nH, nW, mask, dbias, qkv_bf16, bias_bf16))
    return -1;
  const long long* st = (const long long*)strides;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto t, auto tb) {
    using T = decltype(t);
    using TB = decltype(tb);
    return launch_dbias<Rows, T, TB, MXU_FP32>(
        {(const T*)q, st[0], st[1], st[2]}, {(const T*)k, st[3], st[4], st[5]},
        {(const T*)v, st[6], st[7], st[8]},
        {(const T*)g, st[9], st[10], st[11]}, logit_scale, bias, mask, lse,
        delta, dbias, B_, N, nH, nW, s);
  };
  if (!qkv_bf16) return run(0.0f, 0.0f);
  return bias_bf16 ? run(bf16(), bf16()) : run(bf16(), 0.0f);
}

// Head-split entry (K7's counterpart on the tensor cores): q, k, v and g
// (B_, nH, N, 32), each at its own base with the strides `strides` gives,
// a host array of twelve: q, k, v, g, each (window, head, token), in
// elements (the model's permuted views: no copy); dq, dk, dv contiguous
// (B_, nH, N, 32), of q's type. qkv_bf16 1: bf16 operands, bias and mask
// bf16 when bias_bf16, else fp32, lse (B_, nH, N) from
// mmde_window_attention_headsplit_fwd_tc; qkv_bf16 0: fp32 q, k, v, g and
// dq, dk, dv, every operand in three bf16 pieces, fp32 bias and mask, lse
// (2, B_, nH, N) hi then lo as that entry writes it for fp32 (F3). The TPU
// kernel's function (mode MXU_FP32); delta (B_, nH, N) fp32 and dls_part
// (B_ * ceil(N / 64), nH) fp64 written (the caller sums dls_part over its
// first axis); dbias (nH, N, N) fp32 receives dbias by 16-byte vector
// atomics when dbias_mode = 1 (the caller zeroes it first), none when 0.
// Returns the first CUDA error of the two launches, or -1 for arguments the
// kernels do not take (a row that is not 16-byte aligned among them).
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int mmde_window_attention_headsplit_bwd_tc(
    const void* q, const void* k, const void* v, const void* g,
    const void* strides, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* dls_part, void* dbias, int B_, int N, int nH, int nW,
    int qkv_bf16, int bias_bf16, int dbias_mode, void* stream) {
  if (strides == nullptr || !shape_ok(B_, N, nH, nW, mask, dbias_mode, dbias))
    return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  const long long* st = (const long long*)strides;
  void* db = dbias_mode == 1 ? dbias : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16) {
    Operands<Rows, float> o;
    o.q = {(const float*)q, st[0], st[1], st[2]};
    o.k = {(const float*)k, st[3], st[4], st[5]};
    o.v = {(const float*)v, st[6], st[7], st[8]};
    o.g = {(const float*)g, st[9], st[10], st[11]};
    o.dq = contiguous_rows((float*)dq, nH, N, TC_DH);
    o.dk = contiguous_rows((float*)dk, nH, N, TC_DH);
    o.dv = contiguous_rows((float*)dv, nH, N, TC_DH);
    return launch<Rows, float, float, MXU_FP32>(o, logit_scale, bias, mask,
                                                lse, delta, dls_part, db, B_,
                                                N, nH, nW, s);
  }
  Operands<Rows> o;
  o.q = {(const bf16*)q, st[0], st[1], st[2]};
  o.k = {(const bf16*)k, st[3], st[4], st[5]};
  o.v = {(const bf16*)v, st[6], st[7], st[8]};
  o.g = {(const bf16*)g, st[9], st[10], st[11]};
  o.dq = contiguous_rows((bf16*)dq, nH, N, TC_DH);
  o.dk = contiguous_rows((bf16*)dk, nH, N, TC_DH);
  o.dv = contiguous_rows((bf16*)dv, nH, N, TC_DH);
  if (bias_bf16)
    return launch<Rows, bf16, bf16, MXU_FP32>(o, logit_scale, bias, mask,
                                              lse, delta, dls_part, db, B_, N,
                                              nH, nW, s);
  return launch<Rows, bf16, float, MXU_FP32>(o, logit_scale, bias, mask, lse,
                                             delta, dls_part, db, B_, N, nH,
                                             nW, s);
}

// Slab entry (K9's counterpart on the tensor cores): qkv (B, Hp, Wp, 3C),
// g (B, Hp, Wp, C) and dqkv (B, Hp, Wp, 3C) maps, Hp and Wp multiples of
// ws; the B * (Hp/ws) * (Wp/ws) windows image-major and row-major, N =
// ws*ws, every token row read and written in place (MapRows). qkv_bf16 1:
// bf16 maps, bias and mask (one row per window of an image) bf16 when
// bias_bf16, else fp32, lse (B * nW, nH, N) from
// mmde_window_attention_slab_fwd_tc; qkv_bf16 0: fp32 maps, every operand
// in three bf16 pieces, fp32 bias and mask (a bf16 bias is refused), lse
// (2, B * nW, nH, N) hi then lo as that entry writes it for fp32 (F3). The
// TPU kernel's function (mode MXU_FP32); delta (B * nW, nH, N) fp32 and
// dls_part (B * nW * ceil(N / 64), nH) fp64 written (the caller sums
// dls_part over its first axis); dbias (nH, N, N) fp32 receives dbias
// summed over the windows by 16-byte vector atomics when dbias_mode = 1
// (the caller zeroes it first), none when 0. Returns the first CUDA error of
// the two launches, or -1 for arguments the kernels do not take (as
// mmde_window_attention_slab_fwd_tc). Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int mmde_window_attention_slab_bwd_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, void* dqkv,
    void* delta, void* dls_part, void* dbias, int B, int Hp, int Wp, int C,
    int nH, int ws, int qkv_bf16, int bias_bf16, int dbias_mode,
    void* stream) {
  if (C != nH * TC_DH || B <= 0 || ws <= 0 || Hp <= 0 || Wp <= 0 ||
      Hp % ws != 0 || Wp % ws != 0)
    return -1;
  const long long N = (long long)ws * ws;
  const long long nW = (long long)(Hp / ws) * (Wp / ws);
  if (N * ws >= (1ll << 32) || (long long)B * nW > 65535) return -1;
  if ((long long)ws * Wp >= (1ll << 31)) return -1;   // MapRows::pix
  const int B_ = (int)(B * nW);
  if (!shape_ok(B_, (int)N, nH, (int)nW, mask, dbias_mode, dbias)) return -1;
  if (!qkv_bf16 && bias_bf16) return -1;
  void* db = dbias_mode == 1 ? dbias : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16)
    return launch_slab<float, float>(qkv, g, logit_scale, bias, mask, lse,
                                     dqkv, delta, dls_part, db, B_, Hp, Wp,
                                     C, nH, ws, s);
  if (bias_bf16)
    return launch_slab<bf16, bf16>(qkv, g, logit_scale, bias, mask, lse, dqkv,
                                   delta, dls_part, db, B_, Hp, Wp, C, nH, ws,
                                   s);
  return launch_slab<bf16, float>(qkv, g, logit_scale, bias, mask, lse, dqkv,
                                  delta, dls_part, db, B_, Hp, Wp, C, nH, ws,
                                  s);
}

// Slab entry of K3 on the tensor cores (MMDE_ATTN_GRID=split and
// deterministic mode, after mmde_window_attention_slab_bwd_tc with
// dbias_mode 0, on the delta it wrote): qkv (B, Hp, Wp, 3C) and g (B, Hp,
// Wp, C) maps, bias, mask, lse, qkv_bf16 and bias_bf16 as that entry takes
// them (mode MXU_FP32; bf16: lse (B * nW, nH, N), fp32: (2, B * nW, nH, N)
// hi then lo); each window's rows read in place off the map (MapRows, the
// key tile's pixels in a table filled once a block). dbias (nH, N, N)
// fp32, every element written once, the windows summed in one fixed order
// (type-major where masked: the mask row is b % nW): the same bits on every
// run. Returns the CUDA error of the launch, or -1 for arguments the
// kernel does not take (as mmde_window_attention_slab_bwd_tc). Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int mmde_window_attention_slab_dbias_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* lse, const void* g, const void* delta,
    void* dbias, int B, int Hp, int Wp, int C, int nH, int ws, int qkv_bf16,
    int bias_bf16, void* stream) {
  if (C != nH * TC_DH || B <= 0 || ws <= 0 || Hp <= 0 || Wp <= 0 ||
      Hp % ws != 0 || Wp % ws != 0)
    return -1;
  const long long N = (long long)ws * ws;
  const long long nW = (long long)(Hp / ws) * (Wp / ws);
  if (N * ws >= (1ll << 32) || (long long)B * nW > 65535) return -1;
  if ((long long)ws * Wp >= (1ll << 31)) return -1;   // MapRows::pix
  const int B_ = (int)(B * nW);
  if (!dbias_shape_ok(B_, (int)N, nH, (int)nW, mask, dbias, qkv_bf16,
                      bias_bf16))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto t, auto tb) {
    using T = decltype(t);
    using TB = decltype(tb);
    return launch_dbias<MapRows, T, TB, MXU_FP32>(
        map_rows((const T*)qkv, 0, C, 3, Hp, Wp, ws, TC_DH),
        map_rows((const T*)qkv, 1, C, 3, Hp, Wp, ws, TC_DH),
        map_rows((const T*)qkv, 2, C, 3, Hp, Wp, ws, TC_DH),
        map_rows((const T*)g, 0, C, 1, Hp, Wp, ws, TC_DH), logit_scale, bias,
        mask, lse, delta, dbias, B_, (int)N, nH, (int)nW, s);
  };
  if (!qkv_bf16) return run(0.0f, 0.0f);
  return bias_bf16 ? run(bf16(), bf16()) : run(bf16(), 0.0f);
}

// Blocks of the slab entry's two passes an SM holds at their launch
// (qkv_bf16 as that entry takes it, fp32 bias and mask, with or without the
// mask), from cudaOccupancyMaxActiveBlocksPerMultiprocessor: dq pass to
// *dq_blocks, dk/dv pass to *dkv_blocks. Returns the first CUDA error. No
// launch.
extern "C" int mmde_window_attention_slab_bwd_tc_occupancy(int qkv_bf16,
                                                           int masked,
                                                           int* dq_blocks,
                                                           int* dkv_blocks) {
  auto query = [&](auto t) {
    using T = decltype(t);
    cudaError_t err = allow_tc_bwd_bytes<MapRows, T, float, MXU_FP32>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          dq_blocks, bwd_dq_tc_kernel<MapRows, T, float, MXU_FP32>, TC_NT,
          tc_bwd_bytes<T, float, MXU_FP32>(masked != 0, false));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          dkv_blocks, bwd_dkv_tc_kernel<MapRows, T, float, MXU_FP32>, TC_NT,
          tc_bwd_bytes<T, float, MXU_FP32>(masked != 0, true));
    return (int)err;
  };
  return qkv_bf16 ? query(bf16()) : query(0.0f);
}
