// Device helpers of the tensor-core window-attention kernels
// (window_attention_fwd_tc.cu, window_attention_bwd_tc.cu): bf16 tiles
// staged by cp.async, fragments read by ldmatrix, products by mma.sync
// m16n8k16 (hopper_ptx.cuh), and the hi / lo bf16 split that keeps an fp32
// operand's product exact to ~2^-17 of itself.
//
// Fragment layout (lane = 4 * g + t; mma_bf16_16816's note): an A fragment
// (16 rows x 16 k) holds (row g | g+8, k 2t, 2t+1 | 2t+8, 2t+9); a B
// fragment (16 k x 8 cols) holds (k 2t, 2t+1 | 2t+8, 2t+9, col g); an
// accumulator (16 x 8) holds (row g, cols 2t, 2t+1) in [0], [1] and
// (row g+8, the same cols) in [2], [3]. Two accumulators side by side (cols
// 0-7, 8-15) are therefore exactly the A fragment of a product whose k runs
// over those 16 cols: p and ds go from one product to the next in
// registers, never through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "window_attention_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TC_DH = 32;    // head dim of every swin variant
constexpr int TC_BT = 64;    // rows of a tile: 4 warps x 16
constexpr int TC_NT = 128;   // threads of a block
constexpr int TC_LD = 40;    // bf16 per staged row: 64 bytes + 16 of pad,
                             // so ldmatrix's 8 row reads hit 8 bank groups
constexpr float TC_LN100 = 4.605170185988091f;
constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr float TC_MAXFREE_MAX_SCALE = 30.0f;

// 16 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0+63 of one head (32 bf16 each, layout `rows`) into a
// [64][TC_LD] tile, zeros past N; the block's 128 threads issue 2 copies
// each
template <class L>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base,
                                          const L& rows, int r0, int N,
                                          int tid) {
#pragma unroll
  for (int e = tid; e < TC_BT * 4; e += TC_NT) {
    const int r = e >> 2, c = e & 3;
    const bool ok = r0 + r < N;
    cp_async16(s + r * TC_LD + c * 8,
               base + (ok ? rows.off(r0 + r) : 0) + c * 8, ok);
  }
}

// The same, with the tile's row offsets from `tab`: for Rows they are
// computed where loaded (tab unused, the code above); for MapRows a row
// address is a multiply-shift (r / ws) and two 64-bit products, and a block
// loads two tiles at the same token rows (K and V; Q and G), so the block
// computes each 64-row tile's pixels once, a thread a row, into a shared
// table (TileRows::fill) that both loads read: off(r) = tab[r] * s.
template <class L>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base,
                                          const L& rows, const int* tab,
                                          int r0, int N, int tid) {
  load_tile(s, base, rows, r0, N, tid);
}
template <typename T>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base,
                                          const MapRows<T>& rows,
                                          const int* tab, int r0, int N,
                                          int tid) {
#pragma unroll
  for (int e = tid; e < TC_BT * 4; e += TC_NT) {
    const int r = e >> 2, c = e & 3;
    const bool ok = r0 + r < N;
    cp_async16(s + r * TC_LD + c * 8,
               base + (ok ? (size_t)tab[r] * rows.s : 0) + c * 8, ok);
  }
}

// Whether layout L loads its tiles through a table, and the block's fill of
// the table for the 64-row tile at r0 (the first 64 threads, a row each;
// no barrier: the caller orders it before the loads that read it).
template <class L>
struct TileRows {
  static constexpr bool kTable = false;
  __device__ static void fill(int*, const L&, int, int) {}
};
template <typename T>
struct TileRows<MapRows<T>> {
  static constexpr bool kTable = true;
  __device__ static void fill(int* tab, const MapRows<T>& x, int r0,
                              int tid) {
    if (tid < TC_BT) tab[tid] = x.pix(r0 + tid);
  }
};

// four 8x8 bf16 matrices; lanes 8m .. 8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// B fragments of X^T for the 8 tile rows 8j .. 8j+7 of a staged tile X
// (k = the 32 channels): {k-step 0: b0, b1, k-step 1: b0, b1}
__device__ __forceinline__ void frag_rows(uint32_t (&r)[4], const bf16* s,
                                          int j, int lane) {
  ldsm4(r, s + (8 * j + (lane & 7)) * TC_LD + (lane >> 3) * 8);
}

// B fragments of X for the 16 tile rows 16kk .. 16kk+15 (k = those rows)
// and channels 16c .. 16c+15: {cols 16c..+7: b0, b1, cols 16c+8..: b0, b1}
__device__ __forceinline__ void frag_cols(uint32_t (&r)[4], const bf16* s,
                                          int kk, int c, int lane) {
  ldsm4_t(r, s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD +
                 16 * c + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma_bf16_16816(d, a, b);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (a, b) as a bf16 pair `hi` and the pair of what is left, `lo`: a = hi + lo
// up to ~2^-17 * |a|
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(a, b);
  lo = pack2(a - lo_f(hi), b - hi_f(hi));
}

// A fragments (16 rows x 16 k) from two accumulators x0 (k 0-7), x1 (k
// 8-15), each element times its column's factor f0[], f1[] ({col 2t, 2t+1});
// SPLIT: hi and lo, else one rounding (hi only)
template <bool SPLIT>
__device__ __forceinline__ void afrag(const float (&x0)[4],
                                      const float (&x1)[4],
                                      const float (&f0)[2],
                                      const float (&f1)[2], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  if constexpr (SPLIT) {
    split2(x0[0] * f0[0], x0[1] * f0[1], hi[0], lo[0]);
    split2(x0[2] * f0[0], x0[3] * f0[1], hi[1], lo[1]);
    split2(x1[0] * f1[0], x1[1] * f1[1], hi[2], lo[2]);
    split2(x1[2] * f1[0], x1[3] * f1[1], hi[3], lo[3]);
  } else {
    hi[0] = pack2(x0[0] * f0[0], x0[1] * f0[1]);
    hi[1] = pack2(x0[2] * f0[0], x0[3] * f0[1]);
    hi[2] = pack2(x1[0] * f1[0], x1[1] * f1[1]);
    hi[3] = pack2(x1[2] * f1[0], x1[3] * f1[1]);
  }
}

// A fragments of 16 rows (r, r+8 per lane) x 32 channels straight from
// device memory (rows past N are zeros): a[ks] for channels 16ks .. +15
template <class L>
__device__ __forceinline__ void load_afrag(uint32_t (&a)[2][4],
                                           const bf16* base, const L& rows,
                                           int r, int N, int t) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8;
      const int col = 16 * ks + (i >> 1) * 8 + 2 * t;
      a[ks][i] = row < N ? *reinterpret_cast<const uint32_t*>(
                               base + rows.off(row) + col)
                         : 0u;
    }
}

// Norms and rounded operands, computed alike wherever a row is used. The
// forward and both backward passes meet each q and k row twice - as a
// block's own A fragments and as a streamed tile - and the bf16 mode rounds
// x * rnorm * f to bf16: a norm that differs in its last bit between two
// places can move a rounded operand by a bf16 ulp, and the backward would
// then rebuild other logits than the forward's. So every norm is the chain
// of window_attention_common.cuh's normalise - one fused multiply-add per
// channel, channels in order - which the FMA bodies take too; operands are
// (x * rnorm) * f, two roundings, as the plain version and the FMA bodies
// compute them.
__device__ __forceinline__ uint32_t operand2(uint32_t w, float r, float f) {
  return pack2(__fmul_rn(__fmul_rn(lo_f(w), r), f),
               __fmul_rn(__fmul_rn(hi_f(w), r), f));
}

// rsqrt(sum(x^2) + 1e-12) of a row an A fragment spreads over a quad: word
// slot s of lane t holds channels 8s + 2t, +1; each lane gathers the 16
// words and runs the chain itself
__device__ __forceinline__ float quad_row_rnorm(const uint32_t (&w)[4],
                                                int lane) {
  const int base = lane & ~3;
  float ss = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t x = __shfl_sync(0xffffffffu, w[s], base + t);
      ss = __fmaf_rn(lo_f(x), lo_f(x), ss);
      ss = __fmaf_rn(hi_f(x), hi_f(x), ss);
    }
  return rsqrtf(ss + 1e-12f);
}

// the norms of the two rows (r, r+8) an A fragment holds
__device__ __forceinline__ void row_norms(const uint32_t (&a)[2][4],
                                          float& n0, float& n1, int lane) {
  const uint32_t w0[4] = {a[0][0], a[0][2], a[1][0], a[1][2]};
  const uint32_t w1[4] = {a[0][1], a[0][3], a[1][1], a[1][3]};
  n0 = quad_row_rnorm(w0, lane);
  n1 = quad_row_rnorm(w1, lane);
}

// a <- bf16((a * r_row) * f): the bf16 mode's rounded operand (r0 for row
// r, r1 for r+8)
__device__ __forceinline__ void scale_afrag(uint32_t (&a)[2][4], float r0,
                                            float r1, float f) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[ks][i] = operand2(a[ks][i], (i & 1) ? r1 : r0, f);
}

// the A-fragment pair that holds (row r | r+8, channels 8n+2t, +1): an
// accumulator of n-tile n over the 32 channels sits on the same lanes
__device__ __forceinline__ uint32_t afrag_at(const uint32_t (&a)[2][4], int n,
                                             int half) {
  return a[n >> 1][(n & 1) * 2 + half];
}

// After a staged tile arrived: rnorm[r] for its 64 rows, a thread a row
// (the first 64), as normalise sums them; ROUND: each row replaced in place
// by its bf16 operand bf16((x * rnorm) * f) (f = the scale for q^, 1 for
// k^)
template <bool ROUND>
__device__ __forceinline__ void tile_norms(bf16* s, float* rnorm, float f,
                                           int tid) {
  if (tid >= TC_BT) return;
  uint4* p = reinterpret_cast<uint4*>(s + tid * TC_LD);
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = p[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ss = __fmaf_rn(lo_f(w[i]), lo_f(w[i]), ss);
    ss = __fmaf_rn(hi_f(w[i]), hi_f(w[i]), ss);
  }
  const float inv = rsqrtf(ss + 1e-12f);
  rnorm[tid] = inv;
  if constexpr (ROUND) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = make_uint4(operand2(w[4 * i], inv, f),
                        operand2(w[4 * i + 1], inv, f),
                        operand2(w[4 * i + 2], inv, f),
                        operand2(w[4 * i + 3], inv, f));
  }
}

// The (64 rows x 64 cols) tile of a bias or mask (N, N), staged in shared
// memory as TB with each row's 16-byte units XOR-swizzled by (row & 7), so
// that the accumulators' reads - 8 rows x 4 lanes, or 4 rows x 8 lanes for
// the transposed read of the dk/dv pass - hit distinct banks.
template <typename TB>
__device__ __forceinline__ int btile_off(int r, int c) {   // in bytes
  const int b = c * (int)sizeof(TB);
  return r * 64 * (int)sizeof(TB) + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
}
template <typename TB>
__host__ __device__ constexpr int btile_bytes() {
  return 64 * 64 * (int)sizeof(TB);
}

// 8 bytes global -> shared, asynchronous; zeros when !valid
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 8 : 0)
               : "memory");
}

// Rows r0.. and cols c0.. of `src` (N, N) into the tile at `dst`: ASYNC
// by cp.async in 8-byte chunks (needs N * sizeof(TB) % 8 == 0; fp32 tiles
// with N % 4 == 0 in 16-byte ones past L1, a swizzle unit each: half the
// copies; PERF.md has the head-split kernels' times with each), else by
// plain loads; zeros past the edge.
template <typename TB>
__device__ __forceinline__ void load_btile(char* dst, const TB* src, int r0,
                                           int c0, int N, int tid,
                                           bool async) {
  constexpr int PER = 8 / (int)sizeof(TB);       // elements a chunk
  if (sizeof(TB) == 4 && async && N % 4 == 0) {
    for (int e = tid; e < 64 * 16; e += TC_NT) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool ok = r0 + r < N && c0 + c < N;
      cp_async16(dst + btile_off<TB>(r, c),
                 src + (ok ? (size_t)(r0 + r) * N + c0 + c : 0), ok);
    }
  } else if (async) {
    for (int e = tid; e < 64 * 64 / PER; e += TC_NT) {
      const int r = e / (64 / PER), c = (e % (64 / PER)) * PER;
      const bool ok = r0 + r < N && c0 + c < N;
      cp_async8(dst + btile_off<TB>(r, c),
                src + (ok ? (size_t)(r0 + r) * N + c0 + c : 0), ok);
    }
  } else {
    for (int e = tid; e < 64 * 64; e += TC_NT) {
      const int r = e >> 6, c = e & 63;
      const bool ok = r0 + r < N && c0 + c < N;
      *reinterpret_cast<TB*>(dst + btile_off<TB>(r, c)) =
          ok ? src[(size_t)(r0 + r) * N + c0 + c] : TB();
    }
  }
}

// Where a block's bias and mask tiles sit in its dynamic shared memory.
// bf16 tiles (8 KB): 2 stages x {bias, mask}, the mask added where an
// element is read. fp32 tiles (16 KB; the head-split stages stream fp32
// bias and mask): the mask tile is single-buffered and added into its
// stage's bias tile once a step, right after both arrived (`fold_mask`),
// so that a masked block holds three tiles, not four - three blocks on an
// SM where four fp32 tiles left two. Either way an element reads the same
// fp32 bias + mask; a block that folds issues the next step's copies after
// the fold (the mask tile is free again only then).
template <typename TB>
struct BiasTiles {
  char* base;
  bool masked;
  static constexpr bool kFold = sizeof(TB) == 4;
  __device__ __forceinline__ bool fold() const { return kFold && masked; }
  __device__ __forceinline__ char* bias(int st) const {
    return base + (fold() ? st : (masked ? 2 : 1) * st) * btile_bytes<TB>();
  }
  __device__ __forceinline__ char* mask(int st) const {
    return fold() ? base + 2 * btile_bytes<TB>()
                  : bias(st) + btile_bytes<TB>();
  }
  // whether a read adds the mask tile itself
  __device__ __forceinline__ bool add_mask() const {
    return masked && !fold();
  }
};

// the dynamic shared memory of a block's bias (and mask) tiles
template <typename TB>
int bias_tiles_bytes(bool masked) {
  const int tiles = !masked ? 2 : BiasTiles<TB>::kFold ? 3 : 4;
  return tiles * btile_bytes<TB>();
}

// Stage st's bias (and mask) tiles of rows r0.., cols c0..: by cp.async
// (`async`), or by plain loads - where the tiles fold, the sum itself.
template <typename TB>
__device__ __forceinline__ void stage_bias_tiles(const BiasTiles<TB>& t,
                                                 int st, const TB* bias,
                                                 const TB* mask, int r0,
                                                 int c0, int N, int tid,
                                                 bool async) {
  if constexpr (BiasTiles<TB>::kFold) {
    if (!async && t.masked) {
      for (int e = tid; e < 64 * 64; e += TC_NT) {
        const int r = e >> 6, c = e & 63;
        const bool ok = r0 + r < N && c0 + c < N;
        const size_t i = ok ? (size_t)(r0 + r) * N + c0 + c : 0;
        *reinterpret_cast<TB*>(t.bias(st) + btile_off<TB>(r, c)) =
            ok ? bias[i] + mask[i] : TB();
      }
      return;
    }
  }
  load_btile(t.bias(st), bias, r0, c0, N, tid, async);
  if (t.masked) load_btile(t.mask(st), mask, r0, c0, N, tid, async);
}

// After stage st's tiles arrived by cp.async: bias += mask, elementwise
// (both tiles share the swizzle), the block's threads sharing the work
template <typename TB>
__device__ __forceinline__ void fold_mask(const BiasTiles<TB>& t, int st,
                                          int tid) {
  float4* b = reinterpret_cast<float4*>(t.bias(st));
  const float4* m = reinterpret_cast<const float4*>(t.mask(st));
  for (int i = tid; i < btile_bytes<TB>() / 16; i += TC_NT) {
    float4 x = b[i];
    const float4 y = m[i];
    x.x += y.x;
    x.y += y.y;
    x.z += y.z;
    x.w += y.w;
    b[i] = x;
  }
}

// tile elements (r, c), (r, c+1), c even, as fp32
__device__ __forceinline__ float2 btile_pair(const char* t, int r, int c,
                                             float) {
  return *reinterpret_cast<const float2*>(t + btile_off<float>(r, c));
}
__device__ __forceinline__ float2 btile_pair(const char* t, int r, int c,
                                             bf16) {
  const uint32_t w =
      *reinterpret_cast<const uint32_t*>(t + btile_off<bf16>(r, c));
  return make_float2(lo_f(w), hi_f(w));
}
template <typename TB>
__device__ __forceinline__ float btile_at(const char* t, int r, int c) {
  return ldf(reinterpret_cast<const TB*>(t + btile_off<TB>(r, c)), 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// fp32 operands on bf16 tensor cores. An fp32 x is three bf16 pieces, x1 =
// bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), each difference
// exact: together every bit of x's 24. A product a b of two such operands
// is taken as the six piece products a_i b_j with i + j <= 2 (0-based), the
// smallest first, into the fp32 accumulator: what is left out (a2 b3, a3
// b2, a3 b3) is ~2^-24 of |a b|, the order of the accumulator's own
// rounding. A kernel's operand counts P pieces: 1 for a bf16 value (exact)
// or a rounded one (the "bf16" mode), 2 for the bf16-qkv kernels' fp32
// values formed in registers (hi + lo, ~2^-17 left over), 3 for fp32 qkv.
// The piece products a_i b_j with i + j <= max(PA, PB) - 1; for PA = 3
// the smallest first, otherwise in i order (the bf16 kernels' order).
// ---------------------------------------------------------------------------
constexpr int TC_PLANE = TC_BT * TC_LD;   // bf16 of one staged piece (plane)

// (a, b) as P bf16 pairs summing to it (P = 1: one rounding)
template <int P>
__device__ __forceinline__ void pieces(float a, float b, uint32_t (&w)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    w[i] = pack2(a, b);
    a -= lo_f(w[i]);
    b -= hi_f(w[i]);
  }
}

// the piece products of a PA x PB product: how many, and the n-th as
// 8 i + j, in the order they are added
__host__ __device__ constexpr int terms_count(int PA, int PB) {
  const int top = (PA > PB ? PA : PB) - 1;
  int n = 0;
  for (int i = 0; i < PA; ++i)
    for (int j = 0; j < PB; ++j) n += i + j <= top;
  return n;
}
__host__ __device__ constexpr int term_ij(int PA, int PB, int n) {
  const int top = (PA > PB ? PA : PB) - 1;
  int k = 0;
  for (int sum = (PA == 3 ? top : 0); PA == 3 ? sum >= 0 : sum <= 0;
       sum += (PA == 3 ? -1 : 1))
    for (int i = 0; i < PA; ++i)
      for (int j = 0; j < PB; ++j)
        if ((PA == 3 ? i + j == sum : i + j <= top) && k++ == n)
          return 8 * i + j;
  return 0;
}

// d += a b over the 32 channels of a 16-row x 8-col logit tile: A
// fragments a[piece][k-step] of the block's rows, B fragments b[piece] =
// {k-step 0: b0, b1, k-step 1: b0, b1} (frag_rows of each plane)
template <int PA, int PB, int n = 0>
__device__ __forceinline__ void mma_rows(float (&d)[4],
                                         const uint32_t (&a)[PA][2][4],
                                         const uint32_t (&b)[PB][4]) {
  if constexpr (n < terms_count(PA, PB)) {
    constexpr int i = term_ij(PA, PB, n) >> 3, j = term_ij(PA, PB, n) & 7;
    mma(d, a[i][0], b[j][0], b[j][1]);
    mma(d, a[i][1], b[j][2], b[j][3]);
    mma_rows<PA, PB, n + 1>(d, a, b);
  }
}

// d0, d1 (channels 16c.., 16c+8..) += a b for one 16-deep k step: A
// fragments a[piece] of an operand formed in registers (afrag_p), B
// fragments b[piece] = {cols 16c..: b0, b1, 16c+8..: b0, b1} (frag_cols)
template <int PA, int PB, int n = 0>
__device__ __forceinline__ void mma_cols(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[PA][4],
                                         const uint32_t (&b)[PB][4]) {
  if constexpr (n < terms_count(PA, PB)) {
    constexpr int i = term_ij(PA, PB, n) >> 3, j = term_ij(PA, PB, n) & 7;
    mma(d0, a[i], b[j][0], b[j][1]);
    mma(d1, a[i], b[j][2], b[j][3]);
    mma_cols<PA, PB, n + 1>(d0, d1, a, b);
  }
}

// afrag's A fragments in P pieces (P = 1: one rounding, 2: hi + lo)
template <int P>
__device__ __forceinline__ void afrag_p(const float (&x0)[4],
                                        const float (&x1)[4],
                                        const float (&f0)[2],
                                        const float (&f1)[2],
                                        uint32_t (&a)[P][4]) {
  uint32_t w[4][P];
  pieces<P>(x0[0] * f0[0], x0[1] * f0[1], w[0]);
  pieces<P>(x0[2] * f0[0], x0[3] * f0[1], w[1]);
  pieces<P>(x1[0] * f1[0], x1[1] * f1[1], w[2]);
  pieces<P>(x1[2] * f1[0], x1[3] * f1[1], w[3]);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[p][i] = w[i][p];
}

// fp32 A fragments of 16 rows (r, r+8 per lane) x 32 channels straight
// from device memory, as load_afrag lays them out (a float2 per bf16 pair)
template <class L>
__device__ __forceinline__ void load_afrag_f32(float2 (&x)[2][4],
                                               const float* base,
                                               const L& rows, int r, int N,
                                               int t) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8;
      const int col = 16 * ks + (i >> 1) * 8 + 2 * t;
      x[ks][i] = row < N ? *reinterpret_cast<const float2*>(
                               base + rows.off(row) + col)
                         : make_float2(0.0f, 0.0f);
    }
}

// The same for MapRows (the slab's fp32 q, g; k, v and their reloads): the
// lane's two rows' offsets once, pix(r) * s, in place of off()'s two
// 64-bit products a row. Measured against off() on an H100, 700 W (PERF.md
// §6, tools/bench_attention.py --tree): the fp32 slab forward 2-4 % faster
// at flagship stages 1-3 (181 registers and no spill, where off() left 168
// and a 4-byte spill), the backward unchanged.
template <typename T>
__device__ __forceinline__ void load_afrag_f32(float2 (&x)[2][4],
                                               const float* base,
                                               const MapRows<T>& rows, int r,
                                               int N, int t) {
  const size_t o[2] = {(size_t)rows.pix(r < N ? r : 0) * rows.s,
                       (size_t)rows.pix(r + 8 < N ? r + 8 : 0) * rows.s};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8;
      const int col = 16 * ks + (i >> 1) * 8 + 2 * t;
      x[ks][i] = row < N ? *reinterpret_cast<const float2*>(
                               base + o[i & 1] + col)
                         : make_float2(0.0f, 0.0f);
    }
}

// quad_row_rnorm of a row an fp32 fragment spreads over a quad: the same
// chain, channel by channel in order
__device__ __forceinline__ float quad_row_rnorm(const float2 (&w)[4],
                                                int lane) {
  const int base = lane & ~3;
  float ss = 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float x = __shfl_sync(0xffffffffu, w[s].x, base + t);
      const float y = __shfl_sync(0xffffffffu, w[s].y, base + t);
      ss = __fmaf_rn(x, x, ss);
      ss = __fmaf_rn(y, y, ss);
    }
  return rsqrtf(ss + 1e-12f);
}

// the norms (NORM) and pieces of fp32 A fragments x (load_afrag_f32): as
// load_operand below, for a caller that issues the loads early
template <int P, bool NORM, bool ROUND>
__device__ __forceinline__ void finish_operand(const float2 (&x)[2][4],
                                               uint32_t (&a)[P][2][4],
                                               int lane, float& n0,
                                               float& n1, float f) {
  if constexpr (NORM) {
    const float2 w0[4] = {x[0][0], x[0][2], x[1][0], x[1][2]};
    const float2 w1[4] = {x[0][1], x[0][3], x[1][1], x[1][3]};
    n0 = quad_row_rnorm(w0, lane);
    n1 = quad_row_rnorm(w1, lane);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float u = x[ks][i].x, v = x[ks][i].y;
      if constexpr (ROUND) {
        const float rn = (i & 1) ? n1 : n0;
        u = __fmul_rn(__fmul_rn(u, rn), f);
        v = __fmul_rn(__fmul_rn(v, rn), f);
      }
      uint32_t w[P];
      pieces<P>(u, v, w);
#pragma unroll
      for (int p = 0; p < P; ++p) a[p][ks][i] = w[p];
    }
}

// mma_cols for two products that share their k step, term by term
// interleaved (the bf16 dk/dv passes' order): d0, d1 += a b; e0, e1 += c d
template <int PA, int PB, int n = 0>
__device__ __forceinline__ void mma_cols2(float (&d0)[4], float (&d1)[4],
                                          const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][4],
                                          float (&e0)[4], float (&e1)[4],
                                          const uint32_t (&c)[PA][4],
                                          const uint32_t (&d)[PB][4]) {
  if constexpr (n < terms_count(PA, PB)) {
    constexpr int i = term_ij(PA, PB, n) >> 3, j = term_ij(PA, PB, n) & 7;
    mma(d0, a[i], b[j][0], b[j][1]);
    mma(d1, a[i], b[j][2], b[j][3]);
    mma(e0, c[i], d[j][0], d[j][1]);
    mma(e1, c[i], d[j][2], d[j][3]);
    mma_cols2<PA, PB, n + 1>(d0, d1, a, b, e0, e1, c, d);
  }
}

// A fragments a[piece][k-step] of 16 rows of operand T (bf16: the raw
// values, one piece; fp32: P pieces, or for ROUND one piece of the "bf16"
// mode's bf16((x * rnorm) * f)); with NORM the rows' norms n0 (row r), n1
// (r + 8) by the one chain
template <typename T, int P, bool NORM, bool ROUND, class L>
__device__ __forceinline__ void load_operand(uint32_t (&a)[P][2][4],
                                             const T* base, const L& rows,
                                             int r, int N, int lane,
                                             float& n0, float& n1, float f) {
  const int t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    static_assert(P == 1, "a bf16 operand is one piece");
    load_afrag(a[0], base, rows, r, N, t);
    if constexpr (NORM) row_norms(a[0], n0, n1, lane);
    if constexpr (ROUND) scale_afrag(a[0], n0, n1, f);
  } else {
    float2 x[2][4];
    load_afrag_f32(x, base, rows, r, N, t);
    finish_operand<P, NORM, ROUND>(x, a, lane, n0, n1, f);
  }
}

// the raw value at afrag_at's slot (element e = 0 / 1 of the pair): the
// sum of its pieces (exact: three pieces hold every bit)
template <int P>
__device__ __forceinline__ float raw_at(const uint32_t (&a)[P][2][4], int n,
                                        int half, int e) {
  const uint32_t w = afrag_at(a[P - 1], n, half);
  float x = e ? hi_f(w) : lo_f(w);
#pragma unroll
  for (int p = P - 2; p >= 0; --p) {
    const uint32_t u = afrag_at(a[p], n, half);
    x += e ? hi_f(u) : lo_f(u);
  }
  return x;
}

// fp32 tiles stream through a staging buffer (64 rows x 32 fp32, row r's
// 16-byte chunk c at chunk c ^ (r & 7): the split pass reads a row a
// thread, 8 threads a phase on 8 bank groups) by 16-byte cp.async, zeros
// past N; after arrival the split pass writes the pieces into bf16 planes
// [piece][64][TC_LD], which ldmatrix reads as it reads a bf16 tile. Either
// layout: Rows (packed, head-split) or MapRows (slab, through the table).
constexpr int TC_STAGE_F32 = TC_BT * TC_DH;   // floats of a staging buffer

template <class L>
__device__ __forceinline__ void load_tile_f32(float* s, const float* base,
                                              const L& rows, int r0, int N,
                                              int tid) {
#pragma unroll
  for (int e = tid; e < TC_BT * 8; e += TC_NT) {
    const int r = e >> 3, c = e & 7;
    const bool ok = r0 + r < N;
    cp_async16(s + r * TC_DH + ((c ^ (r & 7)) << 2),
               base + (ok ? rows.off(r0 + r) : 0) + c * 4, ok);
  }
}

// The same, with the tile's row offsets from `tab`, as load_tile takes
// them: Rows ignores the table (the code above), MapRows reads its row
// addresses off the block's shared table of the tile's pixels (TileRows),
// off(r) = tab[r] * s
template <class L>
__device__ __forceinline__ void load_tile_f32(float* s, const float* base,
                                              const L& rows, const int* tab,
                                              int r0, int N, int tid) {
  load_tile_f32(s, base, rows, r0, N, tid);
}
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* s, const float* base,
                                              const MapRows<T>& rows,
                                              const int* tab, int r0, int N,
                                              int tid) {
#pragma unroll
  for (int e = tid; e < TC_BT * 8; e += TC_NT) {
    const int r = e >> 3, c = e & 7;
    const bool ok = r0 + r < N;
    cp_async16(s + r * TC_DH + ((c ^ (r & 7)) << 2),
               base + (ok ? (size_t)tab[r] * rows.s : 0) + c * 4, ok);
  }
}

// row r of a staging buffer, channels in order
__device__ __forceinline__ void staged_row(const float* s, int r,
                                           float (&x)[TC_DH]) {
  const float4* p = reinterpret_cast<const float4*>(s + r * TC_DH);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = p[i ^ (r & 7)];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

// rsqrt(sum(x^2) + 1e-12), normalise's chain
__device__ __forceinline__ float row_rnorm(const float (&x)[TC_DH]) {
  float ss = 0.0f;
#pragma unroll
  for (int d = 0; d < TC_DH; ++d) ss = __fmaf_rn(x[d], x[d], ss);
  return rsqrtf(ss + 1e-12f);
}

// row r of planes [P][64][TC_LD]: x in P pieces, or for ROUND one piece of
// bf16((x * rn) * f)
template <int P, bool ROUND>
__device__ __forceinline__ void put_row(bf16* planes, int r,
                                        const float (&x)[TC_DH], float rn,
                                        float f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w[4][P];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float u = x[8 * i + 2 * j], v = x[8 * i + 2 * j + 1];
      if constexpr (ROUND) {
        u = __fmul_rn(__fmul_rn(u, rn), f);
        v = __fmul_rn(__fmul_rn(v, rn), f);
      }
      pieces<P>(u, v, w[j]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      reinterpret_cast<uint4*>(planes + p * TC_PLANE + r * TC_LD)[i] =
          make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
  }
}

}  // namespace
