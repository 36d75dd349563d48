// Fused SwinV2 cosine window attention, backward in one pass, on Hopper's
// tensor cores (sm_90a, bf16 mma.sync), for bf16 and fp32 qkv in the packed
// layout.
//
// Replaces the TPU kernel K4, mmde_tpu/ops/window_attention_packed.py::
// _bwd_body_v4 (driven by _pallas_backward_v4), the backward that
// MMDE_ATTN_GRID=bias_resident selects, for every launch; the fp32-FMA body
// (window_attention_bwd_resident.cu) is its same-card A/B partner. The function is that body's - always
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
//
// fp32 qkv (T = float): no fp32 operand is exact in bf16, so each is split
// into three bf16 pieces and every product taken as the six piece products
// whose indices sum to at most 2 (window_attention_tc.cuh): 42 units a
// (window, head), ~2^-24 of each product left out. q and g stay in
// registers as three A-fragment pieces; k and v arrive as fp32 tiles by
// cp.async (two stages) and a split pass writes their three bf16 planes
// (one stage: the step's first barrier frees them), the window's q and g
// tiles likewise at its sweep 2; p and ds * factor go through shared
// memory in three planes each. ~199 KB of shared memory with fp32 bias and
// mask tiles: one block an SM. The tensor cores round each sum toward
// zero, a few fp32 ulps below round-to-nearest; the block's own m and l
// normalise p from those same logits, so no statistic of other arithmetic
// meets them (K5's backward reads its forward's). Both sweeps form exp(s -
// m) with the difference first, and dlogit_scale sums ds * (sc - (m +
// log l)), the same sum (a row of ds sums to zero) without ~60 times the
// rounding of that row sum at a hot head (F3; fwd_tc_kernel and
// bwd_dkv_tc_kernel take both rules).
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

// Operand pieces (window_attention_tc.cuh): T = bf16 takes q, k, v, g as
// they are (one piece) and splits p and ds * factor in two; T = float
// splits every operand in three - q and g A fragments in registers, k, v
// and the window's q and g tiles staged as three bf16 planes each, p and ds
// * factor in three.
template <typename T>
struct ResidentPieces {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int PS = F32 ? 3 : 1;   // a loaded or staged operand
  static constexpr int PR = F32 ? 3 : 2;   // an operand formed in registers
};

// One block of 4 warps an SM at least (the bound lets ptxas take the
// registers it needs: without it the fp32-tile instantiation spilled;
// shared memory holds two blocks an SM for bf16 qkv, one for fp32).
template <typename T, typename TB>
__global__ void __launch_bounds__(TC_NT, 1)
bwd_resident_tc_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                       Rows<const T> g, const float* __restrict__ logit_scale,
                       const TB* __restrict__ bias,
                       const TB* __restrict__ mask, Rows<T> dq,
                       float* __restrict__ dkv, float* __restrict__ dbias_part,
                       double* __restrict__ dls_part, int B_, int N, int nW,
                       int chunk) {
  constexpr bool F32 = ResidentPieces<T>::F32;
  constexpr int PS = ResidentPieces<T>::PS, PR = ResidentPieces<T>::PR;
  // bf16: the K / V tiles, double-buffered (fp32 stages them in dynamic
  // shared memory, below)
  __shared__ __align__(128) bf16 sK[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ __align__(128) bf16 sV[2][F32 ? 8 : TC_BT * TC_LD];
  __shared__ float sRk[2][TC_BT];
  __shared__ double sRed[4];
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [PS][64][TC_LD] window's q
  bf16* sG = sQ + PS * TC_PLANE;              // [PS][64][TC_LD] its g
  bf16* sP = sG + PS * TC_PLANE;              // [PR][64 q][RT_LDP] p
  bf16* sD = sP + PR * TC_BT * RT_LDP;        // [PR] ds * scale * rq_i
  // bf16 stores and reads p and ds through these named hi / lo tiles: with
  // plane-generic addresses (sP + p * plane) nvcc keeps every sweep-2
  // fragment address in a register of its own (200 registers instead of
  // 188 with fp32 bias tiles); named tiles have them formed at each use
  bf16* sPh = sP;
  bf16* sPl = sP + TC_BT * RT_LDP;
  bf16* sDh = sD;
  bf16* sDl = sD + TC_BT * RT_LDP;
  // the stages' bias (and mask) tiles: BiasTiles
  char* sBM = reinterpret_cast<char*>(sD + PR * TC_BT * RT_LDP);
  // fp32: K and V staging [2 stages][K, V], then their planes [PS] each
  float* sStg = reinterpret_cast<float*>(
      sBM + (BiasTiles<TB>::kFold ? 3 : 4) * btile_bytes<TB>());
  bf16* sKp = reinterpret_cast<bf16*>(sStg + 4 * TC_STAGE_F32);
  bf16* sVp = sKp + PS * TC_PLANE;

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
  // (fp32: split from device memory at that step, below)
  auto issue = [&](int s) {
    const int st = s & 1, b = b_beg + s / per_win, r = s % per_win;
    const int kn = (r % nt) * TC_BT;
    if constexpr (F32) {
      load_tile_f32(sStg + 2 * st * TC_STAGE_F32, k.head(b, h), k, kn, N,
                    tid);
      load_tile_f32(sStg + (2 * st + 1) * TC_STAGE_F32, v.head(b, h), v, kn,
                    N, tid);
    } else {
      load_tile(sK[st], k.head(b, h), k, kn, N, tid);
      load_tile(sV[st], v.head(b, h), v, kn, N, tid);
      if (r == nt) {
        load_tile(sQ, q.head(b, h), q, q0, N, tid);
        load_tile(sG, g.head(b, h), g, q0, N, tid);
      }
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
  uint32_t qa[PS][2][4], ga[PS][2][4];
  float rq0 = 0.0f, rq1 = 0.0f;
  float m0 = 0.0f, m1 = 0.0f, l0 = 0.0f, l1 = 0.0f, D0 = 0.0f, D1 = 0.0f;
  float il0 = 0.0f, il1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  float lc0 = 0.0f, lc1 = 0.0f;   // fp32: the rows' m + log(l)
  float acc[4][4];
  double dls = 0.0;

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    const int wi = step / per_win, r = step % per_win;
    const int b = b_beg + wi;
    const bool grad = r >= nt;
    const int k0 = (r % nt) * TC_BT;
    if (r == 0) {   // a new window: its fragments, norms, fresh statistics
      if constexpr (F32) {
        float none0, none1;
        load_operand<T, PS, true, false>(qa, q.head(b, h), q, r0, N, lane,
                                         rq0, rq1, 1.0f);
        load_operand<T, PS, false, false>(ga, g.head(b, h), g, r0, N, lane,
                                          none0, none1, 1.0f);
      } else {
        load_afrag(qa[0], q.head(b, h), q, r0, N, t);
        load_afrag(ga[0], g.head(b, h), g, r0, N, t);
        row_norms(qa[0], rq0, rq1, lane);
      }
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
      if constexpr (F32) {
        lc0 = m0 + logf(l0);
        lc1 = m1 + logf(l1);
      }
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
    if constexpr (F32) {
      // the split pass: warps 0-1 a K row each (and its norm), warps 2-3 a
      // V row; at sweep 2's first step the window's q / g rows too
      const int rr = tid & (TC_BT - 1);
      const bool isk = tid < TC_BT;
      float x[TC_DH];
      staged_row(sStg + (2 * st + (isk ? 0 : 1)) * TC_STAGE_F32, rr, x);
      if (isk) sRk[st][rr] = row_rnorm(x);
      put_row<PS, false>(isk ? sKp : sVp, rr, x, 1.0f, 1.0f);
      if (r == nt) {
        const int row = q0 + rr;
        if (row < N)
          load_row(isk ? q.head(b, h) + q.off(row) : g.head(b, h) + g.off(row),
                   x);
        else
#pragma unroll
          for (int d = 0; d < TC_DH; ++d) x[d] = 0.0f;
        put_row<PS, false>(isk ? sQ : sG, rr, x, 1.0f, 1.0f);
      }
    } else {
      tile_norms<false>(sK[st], sRk[st], 1.0f, tid);
    }
    __syncthreads();
    if (step + 1 < steps && bt.fold()) issue(step + 1);
    // the step's K / V tile (fp32: its first plane, PS planes apart)
    const bf16* kt = sK[st];
    const bf16* vt = sV[st];
    if constexpr (F32) {
      kt = sKp;
      vt = sVp;
    }

    if (!grad) {
      // ---- sweep 1: S, the logits, online m; then dP a column block at a
      // time into l and D ----
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
        uint32_t kb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(kb[p], kt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(s[j], qa, kb);
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
        uint32_t vb[PS][4];
#pragma unroll
        for (int p = 0; p < PS; ++p)
          frag_rows(vb[p], vt + p * TC_PLANE, j, lane);
        mma_rows<PS, PS>(dp, ga, vb);
        float e0, e1, e2, e3;
        if constexpr (F32) {
          // exp(s - m), the difference first: a shift m * log2(e) rounded
          // on its own scales the whole row's l and D alike (F3)
          e0 = ex2((s[j][0] - m0) * TC_LOG2E);
          e1 = ex2((s[j][1] - m0) * TC_LOG2E);
          e2 = ex2((s[j][2] - m1) * TC_LOG2E);
          e3 = ex2((s[j][3] - m1) * TC_LOG2E);
        } else {
          e0 = ex2(fmaf(s[j][0], TC_LOG2E, -sh0));
          e1 = ex2(fmaf(s[j][1], TC_LOG2E, -sh0));
          e2 = ex2(fmaf(s[j][2], TC_LOG2E, -sh1));
          e3 = ex2(fmaf(s[j][3], TC_LOG2E, -sh1));
        }
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
            float p;
            if constexpr (F32)   // exp(s - m), the difference first (F3)
              p = ex2(((sc + (e ? bm.y : bm.x)) - (half ? m1 : m0)) *
                      TC_LOG2E) * il;
            else
              p = ex2(fmaf(sc + (e ? bm.y : bm.x), TC_LOG2E, -sh)) * il;
            const float ds = p * (d[e] - dl);
            // fp32: sum(ds * (sc - lse)) with the block's own lse = m +
            // log(l): the same sum (a row of ds sums to zero), without ~60
            // times the rounding of that row sum
            if constexpr (F32)
              dls_t = fmaf(ds, sc - (half ? lc1 : lc0), dls_t);
            else
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
          if constexpr (F32) {
            uint32_t w[PR];
            pieces<PR>(s[jj][2 * half], s[jj][2 * half + 1], w);
#pragma unroll
            for (int p = 0; p < PR; ++p)
              *reinterpret_cast<uint32_t*>(sP + p * TC_BT * RT_LDP + o) =
                  w[p];
            pieces<PR>(dp[jj][2 * half] * fr, dp[jj][2 * half + 1] * fr, w);
#pragma unroll
            for (int p = 0; p < PR; ++p)
              *reinterpret_cast<uint32_t*>(sD + p * TC_BT * RT_LDP + o) =
                  w[p];
          } else {
            uint32_t hi, lo;
            split2(s[jj][2 * half], s[jj][2 * half + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sPh + o) = hi;
            *reinterpret_cast<uint32_t*>(sPl + o) = lo;
            split2(dp[jj][2 * half] * fr, dp[jj][2 * half + 1] * fr, hi, lo);
            *reinterpret_cast<uint32_t*>(sDh + o) = hi;
            *reinterpret_cast<uint32_t*>(sDl + o) = lo;
          }
        }
      // dqn += (ds scale rk_j) k_j, split
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
        uint32_t pa[PR][4], da[PR][4];
        if constexpr (F32) {
#pragma unroll
          for (int p = 0; p < PR; ++p)
            frag_t(pa[p], sP + p * TC_BT * RT_LDP, RT_LDP, 16 * kq,
                   16 * warp, lane);
#pragma unroll
          for (int p = 0; p < PR; ++p)
            frag_t(da[p], sD + p * TC_BT * RT_LDP, RT_LDP, 16 * kq,
                   16 * warp, lane);
        } else {
          frag_t(pa[0], sPh, RT_LDP, 16 * kq, 16 * warp, lane);
          frag_t(pa[1], sPl, RT_LDP, 16 * kq, 16 * warp, lane);
          frag_t(da[0], sDh, RT_LDP, 16 * kq, 16 * warp, lane);
          frag_t(da[1], sDl, RT_LDP, 16 * kq, 16 * warp, lane);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t gb[PS][4], qb[PS][4];
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(gb[p], sG + p * TC_PLANE, kq, c, lane);
#pragma unroll
          for (int p = 0; p < PS; ++p)
            frag_cols(qb[p], sQ + p * TC_PLANE, kq, c, lane);
          mma_cols<PR, PS>(accV[2 * c], accV[2 * c + 1], pa, gb);
          mma_cols<PR, PS>(accK[2 * c], accK[2 * c + 1], da, qb);
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
          const float qn =
              raw_at<PS>(qa, n, e >> 1, e & 1) * (e < 2 ? rq0 : rq1);
          if (e < 2) dot0 = fmaf(acc[n][e], qn, dot0);
          else dot1 = fmaf(acc[n][e], qn, dot1);
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
                     rq * (acc[n][2 * half] -
                           raw_at<PS>(qa, n, half, 0) * rq * dot),
                     rq * (acc[n][2 * half + 1] -
                           raw_at<PS>(qa, n, half, 1) * rq * dot));
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

// dynamic shared memory: the q / g tiles, the p / ds tiles, BiasTiles;
// fp32: the K / V staging and planes
template <typename T, typename TB>
int dyn_bytes() {
  constexpr int PS = ResidentPieces<T>::PS, PR = ResidentPieces<T>::PR;
  return 2 * PS * TC_PLANE * 2 + 2 * PR * TC_BT * RT_LDP * 2 +
         bias_tiles_bytes<TB>(true) +
         (ResidentPieces<T>::F32 ? 4 * TC_STAGE_F32 * 4 + 2 * PS * TC_PLANE * 2
                                 : 0);
}

template <typename T, typename TB>
int launch(const void* qkv, const void* ls, const void* bias,
           const void* mask, const void* g, void* dqkv, void* dkv,
           void* dbias_part, void* dls_part, int B_, int N, int nH, int nW,
           int splits, cudaStream_t stream) {
  const int C = nH * TC_DH;
  const Rows<const T> rq = packed_rows((const T*)qkv, 0, N, C, 3, TC_DH);
  const Rows<const T> rk = packed_rows((const T*)qkv, 1, N, C, 3, TC_DH);
  const Rows<const T> rv = packed_rows((const T*)qkv, 2, N, C, 3, TC_DH);
  const Rows<const T> rg = packed_rows((const T*)g, 0, N, C, 1, TC_DH);
  const Rows<T> rdq = packed_rows((T*)dqkv, 0, N, C, 3, TC_DH);
  if (!rows_aligned(rq) || !rows_aligned(rk) || !rows_aligned(rv) ||
      !rows_aligned(rg) || !rows_aligned(rdq) ||
      reinterpret_cast<uintptr_t>(dkv) % 16 != 0)
    return -1;
  const int chunk = (B_ + splits - 1) / splits;
  if ((long long)(splits - 1) * chunk >= B_) return -1;  // an empty chunk
  cudaError_t err = cudaFuncSetAttribute(
      bwd_resident_tc_kernel<T, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes<T, TB>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TC_BT - 1) / TC_BT, nH, splits);
  bwd_resident_tc_kernel<T, TB><<<grid, TC_NT, dyn_bytes<T, TB>(), stream>>>(
      rq, rk, rv, rg, (const float*)ls, (const TB*)bias, (const TB*)mask,
      rdq, (float*)dkv, (float*)dbias_part, (double*)dls_part, B_, N, nW,
      chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry. qkv (B_, N, 3C), g (B_, N, C) and dqkv (B_, N, 3C) bf16
// when qkv_bf16, else fp32 (then bias fp32 too), C = 32 * nH; bias (nH, N,
// N) and mask (nW, N, N; may be null) bf16 when bias_bf16, else fp32. Writes dq, the first C columns of dqkv, complete;
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
    int qkv_bf16, int bias_bf16, int splits, void* stream) {
  if (C != nH * TC_DH || B_ <= 0 || N <= 0 || nH <= 0 || nH > 65535)
    return -1;
  if (splits <= 0 || splits > 65535) return -1;
  if (mask != nullptr && (nW <= 0 || B_ % nW != 0)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qkv_bf16)
    return bias_bf16 ? -1
                     : launch<float, float>(qkv, logit_scale, bias, mask, g,
                                            dqkv, dkv, dbias_part, dls_part,
                                            B_, N, nH, nW, splits, s);
  if (bias_bf16)
    return launch<bf16, bf16>(qkv, logit_scale, bias, mask, g, dqkv, dkv,
                              dbias_part, dls_part, B_, N, nH, nW, splits, s);
  return launch<bf16, float>(qkv, logit_scale, bias, mask, g, dqkv, dkv,
                             dbias_part, dls_part, B_, N, nH, nW, splits, s);
}
