// Fused SwinV2 cosine window attention, backward in one pass, on Hopper's
// tensor cores (sm_90a, bf16 mma.sync), for bf16 qkv in the packed layout.
//
// Replaces the TPU kernel K4, mmde_tpu/ops/window_attention_packed.py::
// _bwd_body_v4 (driven by _pallas_backward_v4), the backward that
// MMDE_ATTN_GRID=bias_resident selects, for every bf16 launch; fp32 qkv
// keeps the fp32-FMA body (window_attention_bwd_resident.cu), which is also
// this kernel's same-card A/B partner. The function is that body's - always
// the exact ("fp32") one, whatever MMDE_ATTN_MXU says, as in the JAX package.
// Per (window b, head h), q^ = q * rq, k^ = k * rk, scale = exp(min(ls, ln
// 100)):
//
//   s  = scale * q^ k^T + bias[h] + mask[b % nW],  p = softmax(s)
//   dp = g v^T,  ds = p * (dp - rowsum(p * dp))
//   dq = rq * (dqn - q^ * rowsum(dqn * q^)),  dqn = scale * ds k^
//   dk^ += scale * ds^T q^,  dv += p^T g       (summed over query tiles)
//   dbias[h] += ds                             (summed over windows, fp32)
//   dlogit_scale[h] += sum(ds * scale * q^ k^T), 0 where the clamp binds
//
// What it keeps from the TPU design: the block forms the softmax itself (no
// log-sum-exp from the forward, which under bias_resident writes none) and
// dbias is summed over windows inside the block, in fp32, in a fixed order
// and without atomics, so two launches give the same bits.
//
// One block of 4 warps owns (64 query rows, head h, a chunk of consecutive
// windows); each warp 16 query rows, whose q and g stay in registers as A
// fragments for the window. Per window, two sweeps over 64-key tiles (raw
// bf16 k and v, double-buffered by cp.async with the bias and mask tiles,
// as window_attention_fwd_tc.cu stages them):
//   sweep 1  S = q k^T and dP = g v^T (raw bf16 operands, exact products,
//            fp32 accumulators; rq, rk and scale as a rank-1 fp32
//            epilogue): each row's running maximum m, sum l of exp(s - m)
//            and D = sum exp(s - m) dp, rescaled as m grows. At its end m is
//            the row's exact maximum (every head: F1 cannot arise), and
//            delta = D / l. m and l stay apart - p = exp(s - m) / l - so no
//            rounded lse = m + log l stands between them (F3).
//   sweep 2  S and dP again; p, ds, and from them: dqn += (ds f_k) k with
//            f_k = scale * rk (dq complete in the block), dbias, dk^ and
//            dv. The fp32 operands (ds * factor, p) are split into bf16 hi +
//            lo, two products each, ~2^-17 of the operand left over, as the
//            tensor-core K2 does. p and ds * scale * rq go through shared
//            memory as bf16 hi / lo tiles, from which ldmatrix.trans reads
//            p^T and ds^T: each warp then forms the dv and dk^ partials of 16
//            keys over the block's 64 queries, added by 16-byte fp32 vector
//            atomics into a (B_, N, 2C) scratch (B_ nH ceil(N/64) N 16 of
//            them, 4x fewer than the FMA body's 16-row tiles).
// That is 10 N x N x 32 units a (window, head) on the tensor cores (K2 on
// them issues 12): S, dP twice; dq, dk, dv split.
//
// dbias: each lane adds its ds elements to the block's own rows of the
// chunk's fp32 partial (splits, nH, N, N) - a plain load, add and store,
// window after window in order, each element by the same lane every time -
// and the caller sums the chunks in a fixed order. dlogit_scale: sum(ds *
// sc) from the fp32 accumulators, in fp64 per block. k's normalise-VJP and
// the casts of dk and dv run after the kernel, in PyTorch, as the TPU
// package runs them in XLA.
//
// What bounds it on an H100: bytes are few (qkv, g, dqkv once; bias, mask
// once; dbias once per chunk), the ten products per (window, head) set the
// bound at the bf16 mma.sync rate; the dbias partial's read and write per
// window (from L2), the atomics and the two sweeps' k / v streams from L2
// come on top. Shared memory ~100 KB at bf16 bias and mask: two blocks an
// SM; `splits` (the caller's) cuts the window sweep for about one wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

constexpr int RT_LDP = 72;   // bf16 per row of a p / ds tile: 128 bytes + 16
                             // of pad (ldmatrix's 8 rows on 8 bank groups)

// A fragments (16 rows m0.. x 16 k k0..) of X^T, X staged [k][m] with `ld`
// bf16 per row: ldmatrix.trans, matrices {m lo, k lo}, {m hi, k lo}, {m lo,
// k hi}, {m hi, k hi}
__device__ __forceinline__ void frag_t(uint32_t (&r)[4], const bf16* s,
                                       int ld, int k0, int m0, int lane) {
  ldsm4_t(r, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                 ((lane >> 3) & 1) * 8);
}

// The accumulator acc (rows key0 | key0 + 8, channels 8n + 2t, +1) added
// into dst rows by one 16-byte vector atomic a lane: lanes t, t ^ 1 trade
// half their values, so the even lane holds 4 channels of key0 and the odd
// one 4 channels of key0 + 8.
__device__ __forceinline__ void atomic_rows(float* dst, const float (&a)[4],
                                            int key0, int n, int t, int N,
                                            long long row_stride) {
  const bool odd = t & 1;
  const float s0 = odd ? a[0] : a[2], s1 = odd ? a[1] : a[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const int key = odd ? key0 + 8 : key0;
  if (key >= N) return;
  const float4 val = odd ? make_float4(r0, r1, a[2], a[3])
                         : make_float4(a[0], a[1], r0, r1);
  atomicAdd(reinterpret_cast<float4*>(dst + (long long)key * row_stride +
                                      8 * n + 2 * (t & ~1)),
            val);
}

// elements (row, col), (row, col + 1) of an (N, N) fp32 matrix, col even;
// 0 past the edge (one 8-byte access where N is even)
__device__ __forceinline__ float2 load_pair(const float* m, int row, int col,
                                            int N) {
  if (row >= N || col >= N) return make_float2(0.0f, 0.0f);
  const float* p = m + (size_t)row * N + col;
  if ((N & 1) == 0) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], col + 1 < N ? p[1] : 0.0f);
}
__device__ __forceinline__ void store_pair(float* m, int row, int col, int N,
                                           float a, float b) {
  if (row >= N || col >= N) return;
  float* p = m + (size_t)row * N + col;
  if ((N & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (col + 1 < N) p[1] = b;
  }
}

// One block of 4 warps an SM at least (the bound lets ptxas take the
// registers it needs: without it the fp32-tile instantiation spilled;
// shared memory holds two blocks an SM either way).
template <typename TB>
__global__ void __launch_bounds__(TC_NT, 1)
bwd_resident_tc_kernel(Rows<const bf16> q, Rows<const bf16> k,
                       Rows<const bf16> v, Rows<const bf16> g,
                       const float* __restrict__ logit_scale,
                       const TB* __restrict__ bias,
                       const TB* __restrict__ mask, Rows<bf16> dq,
                       float* __restrict__ dkv, float* __restrict__ dbias_part,
                       double* __restrict__ dls_part, int B_, int N, int nW,
                       int chunk) {
  __shared__ __align__(128) bf16 sK[2][TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][TC_BT * TC_LD];
  __shared__ float sRk[2][TC_BT];
  __shared__ double sRed[4];
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [64][TC_LD] the window's q
  bf16* sG = sQ + TC_BT * TC_LD;              // [64][TC_LD] its g
  bf16* sPh = sG + TC_BT * TC_LD;             // [64 q][RT_LDP] p, hi
  bf16* sPl = sPh + TC_BT * RT_LDP;           //                p, lo
  bf16* sDh = sPl + TC_BT * RT_LDP;           // ds * scale * rq_i, hi
  bf16* sDl = sDh + TC_BT * RT_LDP;           //                    lo
  // the stages' bias (and mask) tiles: BiasTiles
  char* sBM = reinterpret_cast<char*>(sDl + TC_BT * RT_LDP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * TC_BT, h = blockIdx.y, nH = gridDim.y;
  const int C = nH * TC_DH;
  const int b_beg = blockIdx.z * chunk;
  const int nwin = min(B_, b_beg + chunk) - b_beg;
  const TB* bias_h = bias + (size_t)h * N * N;
  float* dbp = dbias_part + ((size_t)blockIdx.z * nH + h) * N * N;
  const float ls = logit_scale[h];
  const float scale = expf(fminf(ls, TC_LN100));
  const int nt = (N + TC_BT - 1) / TC_BT;
  const int per_win = 2 * nt;   // sweep 1, then sweep 2
  const int steps = nwin * per_win;
  const bool async_b = (N * (int)sizeof(TB)) % 8 == 0;
  const BiasTiles<TB> bt{sBM, mask != nullptr};

  // step s's K, V, bias and mask tiles -> stage s & 1; the window's q and g
  // tiles (read by sweep 2's dk / dv products) with its sweep 2's first
  auto issue = [&](int s) {
    const int st = s & 1, b = b_beg + s / per_win, r = s % per_win;
    const int kn = (r % nt) * TC_BT;
    load_tile(sK[st], k.head(b, h), k, kn, N, tid);
    load_tile(sV[st], v.head(b, h), v, kn, N, tid);
    if (r == nt) {
      load_tile(sQ, q.head(b, h), q, q0, N, tid);
      load_tile(sG, g.head(b, h), g, q0, N, tid);
    }
    if (async_b)
      stage_bias_tiles(bt, st, bias_h,
                       bt.masked ? mask + (size_t)(b % nW) * N * N : nullptr,
                       q0, kn, N, tid, true);
    cp_async_commit();
  };
  if (steps > 0) issue(0);

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  uint32_t qa[2][4], ga[2][4];
  float rq0 = 0.0f, rq1 = 0.0f;
  float m0 = 0.0f, m1 = 0.0f, l0 = 0.0f, l1 = 0.0f, D0 = 0.0f, D1 = 0.0f;
  float il0 = 0.0f, il1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  float acc[4][4];
  double dls = 0.0;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    const int wi = step / per_win, r = step % per_win;
    const int b = b_beg + wi;
    const bool grad = r >= nt;
    const int k0 = (r % nt) * TC_BT;
    if (r == 0) {   // a new window: its fragments, norms, fresh statistics
      load_afrag(qa, q.head(b, h), q, r0, N, t);
      load_afrag(ga, g.head(b, h), g, r0, N, t);
      row_norms(qa, rq0, rq1, lane);
      m0 = m1 = -INFINITY;
      l0 = l1 = D0 = D1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }
    if (r == nt) {  // sweep 1 done: the rows' statistics
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      il0 = 1.0f / l0;
      il1 = 1.0f / l1;
      dl0 = quad_sum(D0) * il0;
      dl1 = quad_sum(D1) * il1;
    }
    cp_async_wait_all();
    __syncthreads();  // tile `step` arrived; every warp left step - 1
    if (step + 1 < steps && !bt.fold()) issue(step + 1);
    const char* tb = bt.bias(st);
    const char* tm = bt.mask(st);
    if (!async_b)
      stage_bias_tiles(bt, st, bias_h,
                       bt.masked ? mask + (size_t)(b % nW) * N * N : nullptr,
                       q0, k0, N, tid, false);
    else if (bt.fold())
      fold_mask(bt, st, tid);
    tile_norms<false>(sK[st], sRk[st], 1.0f, tid);
    __syncthreads();
    if (step + 1 < steps && bt.fold()) issue(step + 1);

    if (!grad) {
      // ---- sweep 1: S, the logits, online m; then dP a column block at a
      // time into l and D ----
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
        uint32_t kb[4];
        frag_rows(kb, sK[st], j, lane);
        mma(s[j], qa[0], kb[0], kb[1]);
        mma(s[j], qa[1], kb[2], kb[3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * t;
        const int col = k0 + cl;
        const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = warp * 16 + (lane >> 2) + 8 * half;
          float* x = &s[j][2 * half];
          if (col >= N || !(half ? ok1 : ok0)) {
            // past the edge: keys -inf (p = 0), rows a finite filler
            x[0] = col < N ? 0.0f : -INFINITY;
            x[1] = col + 1 < N ? 0.0f : -INFINITY;
            continue;
          }
          const float c = half ? rq1 : rq0;
          float2 bm = btile_pair(tb, rl, cl, TB());
          if (bt.add_mask()) {
            const float2 mm = btile_pair(tm, rl, cl, TB());
            bm.x += mm.x;
            bm.y += mm.y;
          }
          x[0] = x[0] * c * rk[0] * scale + bm.x;
          x[1] = col + 1 < N ? x[1] * c * rk[1] * scale + bm.y : -INFINITY;
        }
      }
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
        tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
      }
      tm0 = fmaxf(m0, quad_max(tm0));
      tm1 = fmaxf(m1, quad_max(tm1));
      const float a0 = ex2((m0 - tm0) * TC_LOG2E);
      const float a1 = ex2((m1 - tm1) * TC_LOG2E);
      m0 = tm0;
      m1 = tm1;
      l0 *= a0;
      D0 *= a0;
      l1 *= a1;
      D1 *= a1;
      const float sh0 = m0 * TC_LOG2E, sh1 = m1 * TC_LOG2E;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t vb[4];
        frag_rows(vb, sV[st], j, lane);
        mma(dp, ga[0], vb[0], vb[1]);
        mma(dp, ga[1], vb[2], vb[3]);
        const float e0 = ex2(fmaf(s[j][0], TC_LOG2E, -sh0));
        const float e1 = ex2(fmaf(s[j][1], TC_LOG2E, -sh0));
        const float e2 = ex2(fmaf(s[j][2], TC_LOG2E, -sh1));
        const float e3 = ex2(fmaf(s[j][3], TC_LOG2E, -sh1));
        l0 += e0 + e1;
        l1 += e2 + e3;
        D0 = fmaf(e0, dp[0], fmaf(e1, dp[1], D0));
        D1 = fmaf(e2, dp[2], fmaf(e3, dp[3], D1));
      }
      continue;
    }

    // ---- sweep 2: p, ds; dq, dbias, and p / ds staged for dk^ / dv ----
    // this tile's dbias partial so far (earlier windows of the chunk), lane
    // (row r0 | r1, cols 8j + 2t, +1), one column block ahead of its use
    auto partial = [&](int kk, float2 (&o)[2][2]) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          o[jj][half] = wi > 0 ? load_pair(dbp, half ? r1 : r0,
                                           k0 + 16 * kk + 8 * jj + 2 * t, N)
                               : make_float2(0.0f, 0.0f);
    };
    float2 old[2][2];
    partial(0, old);
    const float fr0 = scale * rq0, fr1 = scale * rq1;
    float dls_t = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float2 ahead[2][2];
      if (kk < 3) partial(kk + 1, ahead);
      float s[2][4], dp[2][4], f[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.0f;
        uint32_t kb[4], vb[4];
        frag_rows(kb, sK[st], j, lane);
        mma(s[jj], qa[0], kb[0], kb[1]);
        mma(s[jj], qa[1], kb[2], kb[3]);
        frag_rows(vb, sV[st], j, lane);
        mma(dp[jj], ga[0], vb[0], vb[1]);
        mma(dp[jj], ga[1], vb[2], vb[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cl = 8 * (2 * kk + jj) + 2 * t;
        const int col = k0 + cl;
        const float rk[2] = {sRk[st][cl], sRk[st][cl + 1]};
        f[jj][0] = scale * rk[0];
        f[jj][1] = scale * rk[1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* x = &s[jj][2 * half];
          float* d = &dp[jj][2 * half];
          if (col >= N || !(half ? ok1 : ok0)) {
            x[0] = x[1] = d[0] = d[1] = 0.0f;
            continue;
          }
          const int rl = warp * 16 + (lane >> 2) + 8 * half;
          const float c = half ? rq1 : rq0;
          const float sh = (half ? m1 : m0) * TC_LOG2E;
          const float il = half ? il1 : il0, dl = half ? dl1 : dl0;
          float2 bm = btile_pair(tb, rl, cl, TB());
          if (bt.add_mask()) {
            const float2 mm = btile_pair(tm, rl, cl, TB());
            bm.x += mm.x;
            bm.y += mm.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= N) {
              x[e] = d[e] = 0.0f;
              continue;
            }
            const float sc = x[e] * c * rk[e] * scale;
            const float p =
                ex2(fmaf(sc + (e ? bm.y : bm.x), TC_LOG2E, -sh)) * il;
            const float ds = p * (d[e] - dl);
            dls_t = fmaf(ds, sc, dls_t);
            x[e] = p;
            d[e] = ds;
          }
        }
      }
      // dbias += ds, the block's own rows of the chunk's partial
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 o = old[jj][half];
          store_pair(dbp, half ? r1 : r0, k0 + 16 * kk + 8 * jj + 2 * t, N,
                     o.x + dp[jj][2 * half], o.y + dp[jj][2 * half + 1]);
          if (kk < 3) old[jj][half] = ahead[jj][half];
        }
      // p and ds * scale * rq_i, split, into their tiles ([query][key])
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (warp * 16 + (lane >> 2) + 8 * half) * RT_LDP +
                        16 * kk + 8 * jj + 2 * t;
          const float fr = half ? fr1 : fr0;
          uint32_t hi, lo;
          split2(s[jj][2 * half], s[jj][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sPh + o) = hi;
          *reinterpret_cast<uint32_t*>(sPl + o) = lo;
          split2(dp[jj][2 * half] * fr, dp[jj][2 * half + 1] * fr, hi, lo);
          *reinterpret_cast<uint32_t*>(sDh + o) = hi;
          *reinterpret_cast<uint32_t*>(sDl + o) = lo;
        }
      // dqn += (ds scale rk_j) k_j, split
      uint32_t ah[4], al[4];
      afrag<true>(dp[0], dp[1], f[0], f[1], ah, al);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t kb[4];
        frag_cols(kb, sK[st], kk, c, lane);
        mma(acc[2 * c], ah, kb[0], kb[1]);
        mma(acc[2 * c + 1], ah, kb[2], kb[3]);
        mma(acc[2 * c], al, kb[0], kb[1]);
        mma(acc[2 * c + 1], al, kb[2], kb[3]);
      }
    }
    dls += dls_t;
    __syncthreads();  // the p / ds tiles complete

    // ---- dk^ and dv partials of the warp's 16 keys over the 64 queries ----
    {
      float accK[4][4], accV[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) accK[n][e] = accV[n][e] = 0.0f;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        uint32_t ph[4], pl[4], dh[4], dlo[4];
        frag_t(ph, sPh, RT_LDP, 16 * kq, 16 * warp, lane);
        frag_t(pl, sPl, RT_LDP, 16 * kq, 16 * warp, lane);
        frag_t(dh, sDh, RT_LDP, 16 * kq, 16 * warp, lane);
        frag_t(dlo, sDl, RT_LDP, 16 * kq, 16 * warp, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t gb[4], qb[4];
          frag_cols(gb, sG, kq, c, lane);
          frag_cols(qb, sQ, kq, c, lane);
          mma(accV[2 * c], ph, gb[0], gb[1]);
          mma(accV[2 * c + 1], ph, gb[2], gb[3]);
          mma(accV[2 * c], pl, gb[0], gb[1]);
          mma(accV[2 * c + 1], pl, gb[2], gb[3]);
          mma(accK[2 * c], dh, qb[0], qb[1]);
          mma(accK[2 * c + 1], dh, qb[2], qb[3]);
          mma(accK[2 * c], dlo, qb[0], qb[1]);
          mma(accK[2 * c + 1], dlo, qb[2], qb[3]);
        }
      }
      float* dk_b = dkv + (size_t)b * N * 2 * C + h * TC_DH;
      const int key0 = k0 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        atomic_rows(dk_b, accK[n], key0, n, t, N, 2 * C);
        atomic_rows(dk_b + C, accV[n], key0, n, t, N, 2 * C);
      }
    }

    if (r == per_win - 1) {
      // ---- the window's dq = rq (dqn - q^ (dqn . q^)) ----
      float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = afrag_at(qa, n, e >> 1);
          const float qn =
              ((e & 1) ? hi_f(w) : lo_f(w)) * (e < 2 ? rq0 : rq1);
          if (e < 2) dot0 = fmaf(acc[n][e], qn, dot0);
          else dot1 = fmaf(acc[n][e], qn, dot1);
        }
      dot0 = quad_sum(dot0);
      dot1 = quad_sum(dot1);
      bf16* dq_bh = dq.head(b, h) + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(half ? ok1 : ok0)) continue;
          const float rq = half ? rq1 : rq0, dot = half ? dot1 : dot0;
          const uint32_t w = afrag_at(qa, n, half);
          store_pair(dq_bh + dq.off(half ? r1 : r0) + 8 * n,
                     rq * (acc[n][2 * half] - lo_f(w) * rq * dot),
                     rq * (acc[n][2 * half + 1] - hi_f(w) * rq * dot));
        }
    }
  }

  // ---- the block's dlogit_scale share ----
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

// dynamic shared memory: the q / g tiles, the p / ds tiles, BiasTiles
template <typename TB>
int dyn_bytes() {
  return 2 * TC_BT * TC_LD * 2 + 4 * TC_BT * RT_LDP * 2 +
         bias_tiles_bytes<TB>(true);
}

template <typename TB>
int launch(const void* qkv, const void* ls, const void* bias,
           const void* mask, const void* g, void* dqkv, void* dkv,
           void* dbias_part, void* dls_part, int B_, int N, int nH, int nW,
           int splits, cudaStream_t stream) {
  const int C = nH * TC_DH;
  const Rows<const bf16> rq = packed_rows((const bf16*)qkv, 0, N, C, 3, TC_DH);
  const Rows<const bf16> rk = packed_rows((const bf16*)qkv, 1, N, C, 3, TC_DH);
  const Rows<const bf16> rv = packed_rows((const bf16*)qkv, 2, N, C, 3, TC_DH);
  const Rows<const bf16> rg = packed_rows((const bf16*)g, 0, N, C, 1, TC_DH);
  const Rows<bf16> rdq = packed_rows((bf16*)dqkv, 0, N, C, 3, TC_DH);
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(rg) || !rows_aligned(rdq) ||
      reinterpret_cast<uintptr_t>(dkv) % 16 != 0)
    return -1;
  const int chunk = (B_ + splits - 1) / splits;
  if ((long long)(splits - 1) * chunk >= B_) return -1;  // an empty chunk
  cudaError_t err = cudaFuncSetAttribute(
      bwd_resident_tc_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn_bytes<TB>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, splits);
  bwd_resident_tc_kernel<TB><<<grid, TC_NT, dyn_bytes<TB>(), stream>>>(
      rq, rk, rv, rg, (const float*)ls, (const TB*)bias, (const TB*)mask,
      rdq, (float*)dkv, (float*)dbias_part, (double*)dls_part, B_, N, nW,
      chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry. qkv (B_, N, 3C), g (B_, N, C) and dqkv (B_, N, 3C) bf16,
// C = 32 * nH; bias (nH, N, N) and mask (nW, N, N; may be null) bf16 when
// bias_bf16, else fp32. Writes dq, the first C columns of dqkv, complete;
// adds scale * ds^T q^ (dk^, before the normalise-VJP) and p^T g (dv) into
// dkv (B_, N, 2C) fp32, which the caller zeroes first; writes one fp32
// dbias partial per window chunk into dbias_part (splits, nH, N, N), every
// element, and one fp64 dlogit_scale partial per block into dls_part
// (splits * ceil(N / 64), nH). The windows are cut into `splits` chunks of
// ceil(B_ / splits), none of them empty (-1 otherwise). Returns the CUDA
// error of the launch, or -1 for arguments the kernel does not take.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int mmde_window_attention_bwd_resident_tc(
    const void* qkv, const void* logit_scale, const void* bias,
    const void* mask, const void* g, void* dqkv, void* dkv,
    void* dbias_part, void* dls_part, int B_, int N, int C, int nH, int nW,
    int bias_bf16, int splits, void* stream) {
  if (C != nH * TC_DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535)
    return -1;
  if (splits <= 0 || splits > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_bf16)
    return launch<bf16>(qkv, logit_scale, bias, mask, g, dqkv, dkv,
                        dbias_part, dls_part, B_, N, nH, nW, splits, s);
  return launch<float>(qkv, logit_scale, bias, mask, g, dqkv, dkv,
                       dbias_part, dls_part, B_, N, nH, nW, splits, s);
}
