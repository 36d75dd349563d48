// Host-side image library of the data path: bilinear remap, crop +
// normalise, depth conversion, PNG row unfiltering and a baseline JPEG
// decoder.
//
// Counterpart of native/preprocess.cpp (the JAX package's library), whose
// four functions are copied here with their semantics unchanged:
// mmde_remap_u8 / mmde_remap_f32 (cv2.remap INTER_LINEAR, BORDER_CONSTANT 0:
// out-of-range taps contribute 0), mmde_normalize_crop_u8 and
// mmde_depth_u16_to_m. The port reads PNG and JPEG files without cv2 or
// PIL, so the sequential parts of both decoders live here too:
//   * mmde_png_unfilter: PNG filter types 0-4 (Paeth depends on the row's
//     own previous output, so it runs byte by byte);
//   * mmde_rgb_to_hsv_u8 / mmde_hsv_to_rgb_u8 / mmde_hsv_jitter_u8: cv2's
//     8-bit HSV conversions, bitwise (its division tables one way, its
//     float sector formula and the vector / scalar split of a row the
//     other), which the augmentation's HSV jitter runs per frame;
//   * mmde_jpeg_info / mmde_jpeg_decode: baseline and extended sequential
//     Huffman JPEG (SOF0 / SOF1), 8-bit, 1 or 3 components, sampling
//     factors 1 or 2, restart intervals, interleaved or single-component
//     scans; libjpeg's integer ("islow") IDCT, its "fancy" triangular
//     chroma upsampling (h2v1, h1v2, h2v2) and its fixed-point YCbCr -> RGB,
//     which is what libjpeg-turbo (cv2.imread) computes by default.
//     Progressive, arithmetic-coded, lossless / hierarchical, 12-bit and
//     4-component files are refused with a code of their own.
//
// No device code: every function runs on the host, row-parallel over
// std::thread where a loader thread benefits. The ctypes calls release the
// interpreter lock, so loader threads decode side by side.
//
// Build: g++ -O3 -fPIC -shared -pthread -std=c++17 -ffp-contract=off
//        preprocess.cpp -o libmmde_preprocess.so
// (no -march=native: every machine computes the same bits).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
inline void remap_rows(const T* src, int h, int w, int ch, const float* mapx,
                       const float* mapy, T* dst, int oh, int ow, int row0,
                       int row1) {
  for (int y = row0; y < row1; ++y) {
    for (int x = 0; x < ow; ++x) {
      const float fx = mapx[y * ow + x];
      const float fy = mapy[y * ow + x];
      const int x0 = static_cast<int>(std::floor(fx));
      const int y0 = static_cast<int>(std::floor(fy));
      const float ax = fx - x0;
      const float ay = fy - y0;
      for (int c = 0; c < ch; ++c) {
        float acc = 0.f;
        // 4 taps; out-of-bounds taps contribute 0 (BORDER_CONSTANT)
        const int xs[2] = {x0, x0 + 1};
        const int ys[2] = {y0, y0 + 1};
        const float wx[2] = {1.f - ax, ax};
        const float wy[2] = {1.f - ay, ay};
        for (int j = 0; j < 2; ++j) {
          if (ys[j] < 0 || ys[j] >= h) continue;
          for (int i = 0; i < 2; ++i) {
            if (xs[i] < 0 || xs[i] >= w) continue;
            acc += wy[j] * wx[i] *
                   static_cast<float>(src[(ys[j] * w + xs[i]) * ch + c]);
          }
        }
        if (std::is_integral<T>::value) {
          acc = std::round(acc);
          acc = std::max(0.f, std::min(acc, 255.f));
        }
        dst[(y * ow + x) * ch + c] = static_cast<T>(acc);
      }
    }
  }
}

template <typename Fn>
void parallel_rows(int rows, int n_threads, Fn&& fn) {
  if (n_threads <= 1 || rows < 64) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  const int chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int r0 = t * chunk;
    const int r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back([=, &fn] { fn(r0, r1); });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------- JPEG ----

// Return codes of mmde_jpeg_info / mmde_jpeg_decode (codec.py names them).
enum JpegStatus {
  kOk = 0,
  kCorrupt = -1,
  kProgressive = -2,
  kArithmetic = -3,
  kPrecision = -4,        // 12- or 16-bit samples
  kComponents = -5,       // 2 or 4 components (CMYK / YCCK)
  kSampling = -6,         // a sampling factor other than 1 or 2
  kLossless = -7,         // lossless or hierarchical processes
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end lands here (libjpeg's jpeg_natural_order
    // pads the same way)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t lookup_len[512];     // 9-bit lookahead: code length (0 = longer)
  uint8_t lookup_sym[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
};

bool build_huffman(Huffman* t, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memset(t->lookup_len, 0, sizeof(t->lookup_len));
  std::memcpy(t->huffval, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t->valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        const int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          t->lookup_len[(code << shift) | j] = static_cast<uint8_t>(len);
          t->lookup_sym[(code << shift) | j] = vals[k];
        }
      }
    }
    t->maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) return false;    // over-subscribed code
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->defined = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks across / down of the whole plane
  int dw = 0, dh = 0;          // downsampled width / height in samples
  int pred = 0;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t size = 0, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool have_frame = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  // entropy-coded segment reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;
};

inline int read_u16(const Jpeg& j, size_t at) {
  return (j.data[at] << 8) | j.data[at + 1];
}

void fill_bits(Jpeg* j) {
  while (j->bitcnt <= 24) {
    int byte = 0;
    if (!j->hit_marker && j->pos < j->size) {
      byte = j->data[j->pos];
      if (byte == 0xFF) {
        const int next = j->pos + 1 < j->size ? j->data[j->pos + 1] : 0xD9;
        if (next == 0x00) {
          j->pos += 2;              // stuffed 0xFF
        } else {
          j->hit_marker = true;     // a marker ends the segment: feed zeros
          byte = 0;
        }
      } else {
        j->pos += 1;
      }
    }
    j->bitbuf |= static_cast<uint32_t>(byte) << (24 - j->bitcnt);
    j->bitcnt += 8;
  }
}

inline int get_bits(Jpeg* j, int n) {
  if (n == 0) return 0;
  if (j->bitcnt < n) fill_bits(j);
  const int v = static_cast<int>(j->bitbuf >> (32 - n));
  j->bitbuf <<= n;
  j->bitcnt -= n;
  return v;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// Next Huffman symbol, or -1 for a code no table entry has.
inline int decode_huffman(Jpeg* j, const Huffman& t) {
  if (j->bitcnt < 16) fill_bits(j);
  const int look = static_cast<int>(j->bitbuf >> 23);
  const int len = t.lookup_len[look];
  if (len) {
    j->bitbuf <<= len;
    j->bitcnt -= len;
    return t.lookup_sym[look];
  }
  int code = get_bits(j, 9), l = 9;
  while (code > t.maxcode[l]) {
    code = (code << 1) | get_bits(j, 1);
    if (++l > 16) return -1;
  }
  return t.huffval[code + t.valoffset[l]];
}

// libjpeg's jpeg_idct_islow (jidctint.c): 13-bit constants, 2 extra bits
// between the passes, the output range-limited with the post-IDCT table
// (index & 1023, so values far out of range wrap as libjpeg's do).
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

uint8_t g_idct_limit[1024];

struct IdctTable {
  IdctTable() {
    // libjpeg's prepare_range_limit_table, post-IDCT part (offset by 128)
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      g_idct_limit[i] = static_cast<uint8_t>(v);
    }
  }
};
const IdctTable g_idct_table_init;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = (in[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v =
          g_idct_limit[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = g_idct_limit[static_cast<int>(descale(tmp10 + tmp3, s)) & 1023];
    o[7] = g_idct_limit[static_cast<int>(descale(tmp10 - tmp3, s)) & 1023];
    o[1] = g_idct_limit[static_cast<int>(descale(tmp11 + tmp2, s)) & 1023];
    o[6] = g_idct_limit[static_cast<int>(descale(tmp11 - tmp2, s)) & 1023];
    o[2] = g_idct_limit[static_cast<int>(descale(tmp12 + tmp1, s)) & 1023];
    o[5] = g_idct_limit[static_cast<int>(descale(tmp12 - tmp1, s)) & 1023];
    o[3] = g_idct_limit[static_cast<int>(descale(tmp13 + tmp0, s)) & 1023];
    o[4] = g_idct_limit[static_cast<int>(descale(tmp13 - tmp0, s)) & 1023];
  }
}

int decode_block(Jpeg* j, Component* c, int16_t* coef) {
  std::memset(coef, 0, 64 * sizeof(int16_t));
  const int s = decode_huffman(j, j->dc[c->td]);
  if (s < 0 || s > 11) return kCorrupt;
  const int diff = s ? extend(get_bits(j, s), s) : 0;
  c->pred += diff;
  coef[0] = static_cast<int16_t>(c->pred);
  const Huffman& act = j->ac[c->ta];
  for (int k = 1; k < 64;) {
    const int rs = decode_huffman(j, act);
    if (rs < 0) return kCorrupt;
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      coef[kZigzag[std::min(k, 64 + 15)]] =
          static_cast<int16_t>(extend(get_bits(j, sz), sz));
      ++k;
    } else {
      if (r != 15) break;
      k += 16;
    }
  }
  return kOk;
}

// Parse the markers up to the frame header (SOF) or, with `decode`,
// through the whole stream, decoding every scan into the component planes.
int parse(Jpeg* j, bool decode) {
  if (j->size < 4 || j->data[0] != 0xFF || j->data[1] != 0xD8)
    return kCorrupt;
  j->pos = 2;
  int16_t coef[64];
  while (true) {
    // find the next marker (fill bytes 0xFF may repeat)
    while (j->pos < j->size && j->data[j->pos] != 0xFF) ++j->pos;
    while (j->pos < j->size && j->data[j->pos] == 0xFF) ++j->pos;
    if (j->pos >= j->size) return kCorrupt;
    const int m = j->data[j->pos++];
    if (m == 0xD9) return j->have_frame ? kOk : kCorrupt;       // EOI
    if (m == 0x00 || m == 0x01 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7))
      continue;
    if (j->pos + 2 > j->size) return kCorrupt;
    const int len = read_u16(*j, j->pos);
    if (len < 2 || j->pos + len > j->size) return kCorrupt;
    const size_t seg = j->pos + 2, end = j->pos + len;
    j->pos = end;
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) return kProgressive;
    if (m == 0xCC || (m >= 0xC9 && m <= 0xCF)) return kArithmetic;
    if (m == 0xC3 || m == 0xC5 || m == 0xC7 || m == 0xDE || m == 0xDF)
      return kLossless;
    if (m == 0xC0 || m == 0xC1) {
      if (len < 8) return kCorrupt;
      if (j->data[seg] != 8) return kPrecision;
      j->height = read_u16(*j, seg + 1);
      j->width = read_u16(*j, seg + 3);
      j->ncomp = j->data[seg + 5];
      if (j->ncomp != 1 && j->ncomp != 3) return kComponents;
      if (len < 8 + 3 * j->ncomp || j->width == 0 || j->height == 0)
        return kCorrupt;
      j->hmax = j->vmax = 1;
      for (int i = 0; i < j->ncomp; ++i) {
        Component& c = j->comp[i];
        c.id = j->data[seg + 6 + 3 * i];
        c.h = j->data[seg + 7 + 3 * i] >> 4;
        c.v = j->data[seg + 7 + 3 * i] & 15;
        c.tq = j->data[seg + 8 + 3 * i];
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) return kSampling;
        if (c.tq > 3) return kCorrupt;
        j->hmax = std::max(j->hmax, c.h);
        j->vmax = std::max(j->vmax, c.v);
      }
      if (j->ncomp == 1) j->comp[0].h = j->comp[0].v = j->hmax = j->vmax = 1;
      const int mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
      const int mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
      for (int i = 0; i < j->ncomp; ++i) {
        Component& c = j->comp[i];
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.dw = (j->width * c.h + j->hmax - 1) / j->hmax;
        c.dh = (j->height * c.v + j->vmax - 1) / j->vmax;
      }
      j->have_frame = true;
      if (!decode) return kOk;
      for (int i = 0; i < j->ncomp; ++i) {
        Component& c = j->comp[i];
        c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      }
    } else if (m == 0xDB) {
      size_t p = seg;
      while (p < end) {
        const int pq = j->data[p] >> 4, tq = j->data[p] & 15;
        if (tq > 3 || pq > 1) return kCorrupt;
        ++p;
        if (p + 64 * (pq + 1) > end) return kCorrupt;
        for (int k = 0; k < 64; ++k) {
          const int v = pq ? read_u16(*j, p + 2 * k) : j->data[p + k];
          j->qt[tq][kZigzag[k]] = static_cast<uint16_t>(v);
        }
        p += 64 * (pq + 1);
        j->qt_defined[tq] = true;
      }
    } else if (m == 0xC4) {
      size_t p = seg;
      while (p < end) {
        if (p + 17 > end) return kCorrupt;
        const int tc = j->data[p] >> 4, th = j->data[p] & 15;
        if (tc > 1 || th > 3) return kCorrupt;
        const uint8_t* counts = j->data + p + 1;
        int n = 0;
        for (int i = 0; i < 16; ++i) n += counts[i];
        if (n > 256 || p + 17 + n > end) return kCorrupt;
        Huffman* t = tc ? &j->ac[th] : &j->dc[th];
        if (!build_huffman(t, counts, j->data + p + 17, n)) return kCorrupt;
        p += 17 + n;
      }
    } else if (m == 0xDD) {
      if (len < 4) return kCorrupt;
      j->restart_interval = read_u16(*j, seg);
    } else if (m == 0xDA) {
      if (!j->have_frame) return kCorrupt;
      const int ns = j->data[seg];
      if (ns < 1 || ns > j->ncomp || len < 6 + 2 * ns) return kCorrupt;
      Component* sc[3];
      for (int i = 0; i < ns; ++i) {
        const int cid = j->data[seg + 1 + 2 * i];
        const int tt = j->data[seg + 2 + 2 * i];
        sc[i] = nullptr;
        for (int k = 0; k < j->ncomp; ++k)
          if (j->comp[k].id == cid) sc[i] = &j->comp[k];
        if (!sc[i]) return kCorrupt;
        sc[i]->td = tt >> 4;
        sc[i]->ta = tt & 15;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || !j->dc[sc[i]->td].defined ||
            !j->ac[sc[i]->ta].defined || !j->qt_defined[sc[i]->tq])
          return kCorrupt;
      }
      const int ss = j->data[seg + 1 + 2 * ns], se = j->data[seg + 2 + 2 * ns];
      const int ahal = j->data[seg + 3 + 2 * ns];
      if (ss != 0 || se != 63 || ahal != 0) return kProgressive;
      // entropy-coded data
      j->bitbuf = 0;
      j->bitcnt = 0;
      j->hit_marker = false;
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      int units_x, units_y;
      if (ns == 1) {      // non-interleaved: one block is one unit
        units_x = (sc[0]->dw + 7) / 8;
        units_y = (sc[0]->dh + 7) / 8;
      } else {
        units_x = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
        units_y = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
      }
      const int total = units_x * units_y;
      int todo = j->restart_interval;
      for (int u = 0; u < total; ++u) {
        if (j->restart_interval && todo == 0) {
          // byte-align, find the RSTn marker, reset the predictions
          j->bitbuf = 0;
          j->bitcnt = 0;
          j->hit_marker = false;
          while (j->pos + 1 < j->size &&
                 !(j->data[j->pos] == 0xFF && j->data[j->pos + 1] >= 0xD0 &&
                   j->data[j->pos + 1] <= 0xD7))
            ++j->pos;
          if (j->pos + 1 >= j->size) return kCorrupt;
          j->pos += 2;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          todo = j->restart_interval;
        }
        const int ux = u % units_x, uy = u / units_x;
        for (int i = 0; i < ns; ++i) {
          Component* c = sc[i];
          const int nh = ns == 1 ? 1 : c->h, nv = ns == 1 ? 1 : c->v;
          for (int by = 0; by < nv; ++by)
            for (int bx = 0; bx < nh; ++bx) {
              if (decode_block(j, c, coef) != kOk) return kCorrupt;
              const int row = (uy * nv + by) * 8, col = (ux * nh + bx) * 8;
              const int stride = c->bw * 8;
              idct_islow(coef, j->qt[c->tq],
                         c->plane.data() + static_cast<size_t>(row) * stride +
                             col,
                         stride);
            }
        }
        if (j->restart_interval) --todo;
      }
      // the marker search above goes on from the end of the scan's data
    }
    // APPn, COM and any other segment: skipped
  }
}

// libjpeg's fancy upsampling of one output row of component `c`
// (jdsample.c: h2v1_fancy_upsample, h1v2_fancy_upsample,
// h2v2_fancy_upsample; box replication where libjpeg-turbo falls back to
// it: a downsampled width of 2 or less). `row` is indexed by output x.
void upsample_row(const Component& c, int hmax, int vmax, int y,
                  uint8_t* out) {
  const int stride = c.bw * 8;
  const int fh = hmax / c.h, fv = vmax / c.v;
  const int dw = c.dw;
  if (fh == 1 && fv == 1) {
    std::memcpy(out, c.plane.data() + static_cast<size_t>(y) * stride, dw);
    return;
  }
  const int iy = y / fv;
  const uint8_t* in0 = c.plane.data() + static_cast<size_t>(iy) * stride;
  if (fv == 1) {                                     // h2v1
    if (dw <= 2) {
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
      return;
    }
    out[0] = in0[0];
    out[1] = static_cast<uint8_t>((in0[0] * 3 + in0[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in0[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + in0[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + in0[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] =
        static_cast<uint8_t>((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = in0[dw - 1];
    return;
  }
  // vertical neighbour: the row above for even output rows, below for odd,
  // the edge rows replicated (libjpeg's context rows)
  const int v = y % 2;
  const int ny = clampi(v == 0 ? iy - 1 : iy + 1, 0, c.dh - 1);
  const uint8_t* in1 = c.plane.data() + static_cast<size_t>(ny) * stride;
  if (fh == 1) {                                     // h1v2
    const int bias = v == 0 ? 1 : 2;
    for (int x = 0; x < dw; ++x)
      out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (dw <= 2) {                                     // h2v2, box
    for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
    return;
  }
  int last, cur, nxt;
  cur = in0[0] * 3 + in1[0];
  nxt = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((cur * 3 + nxt + 7) >> 4);
  last = cur;
  cur = nxt;
  for (int x = 1; x < dw - 1; ++x) {
    nxt = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((cur * 3 + nxt + 7) >> 4);
    last = cur;
    cur = nxt;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
}

// libjpeg's ycc_rgb_convert tables (jdcolor.c, 16-bit fixed point)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << kBits) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables g_ycc;

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ------------------------------------------------------------------ HSV ----

// cv2's 8-bit RGB -> HSV division tables (hsv_shift 12): sdiv[i] =
// round((255 << 12) / i), hdiv[i] = round((180 << 12) / (6 i)).
struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>(std::nearbyint((255 << 12) / double(i)));
      hdiv[i] = static_cast<int>(std::nearbyint((180 << 12) / (6.0 * i)));
    }
  }
};
const HsvTables g_hsv;

inline void rgb_to_hsv_px(const uint8_t* p, int* h_out, int* s_out,
                          int* v_out) {
  const int r = p[0], g = p[1], b = p[2];
  const int v = std::max(std::max(r, g), b);
  const int diff = v - std::min(std::min(r, g), b);
  const int s = (diff * g_hsv.sdiv[v] + (1 << 11)) >> 12;
  int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
  h = (h * g_hsv.hdiv[diff] + (1 << 11)) >> 12;
  if (h < 0) h += 180;
  *h_out = h;
  *s_out = s;
  *v_out = v;
}

// 1 - a*b in float64, then float32 (cv2's fused 1 - s*x, as numpy rounds
// it: the double product of two floats is exact).
inline float one_minus(float a, float b) {
  return static_cast<float>(1.0 - static_cast<double>(a) * b);
}

// cv2's 8-bit HSV -> RGB of one pixel; `vector` picks the truncation of
// cv2's vector path, else the rounding of its scalar path.
inline void hsv_to_rgb_px(int H, int S, int V, bool vector, uint8_t* out) {
  static const int kSector[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float h = static_cast<float>(H) * (6.0f / 180.0f);
  const float s = static_cast<float>(S) * (1.0f / 255.0f);
  const float v = static_cast<float>(V) * (1.0f / 255.0f);
  float bgr[3];
  if (s == 0.0f) {
    bgr[0] = bgr[1] = bgr[2] = v;
  } else {
    int sector = static_cast<int>(std::floor(h));
    float frac = h - static_cast<float>(sector);
    if (sector >= 6) {
      sector = 0;
      frac = 0.0f;
    }
    const float tab[4] = {v, v * one_minus(s, 1.0f), v * one_minus(s, frac),
                          v * one_minus(s, 1.0f - frac)};
    for (int c = 0; c < 3; ++c) bgr[c] = tab[kSector[sector][c]];
  }
  for (int c = 0; c < 3; ++c) {
    const float x = bgr[2 - c] * 255.0f;
    const float r = vector ? std::floor(x) : std::nearbyint(x);
    out[c] = static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
  }
}

}  // namespace

extern "C" {

// Bilinear remap, uint8 interleaved channels.
void mmde_remap_u8(const uint8_t* src, int h, int w, int ch,
                   const float* mapx, const float* mapy, uint8_t* dst,
                   int oh, int ow, int n_threads) {
  parallel_rows(oh, n_threads, [&](int r0, int r1) {
    remap_rows<uint8_t>(src, h, w, ch, mapx, mapy, dst, oh, ow, r0, r1);
  });
}

// Bilinear remap, float32 single channel (depth maps).
void mmde_remap_f32(const float* src, int h, int w, const float* mapx,
                    const float* mapy, float* dst, int oh, int ow,
                    int n_threads) {
  parallel_rows(oh, n_threads, [&](int r0, int r1) {
    remap_rows<float>(src, h, w, 1, mapx, mapy, dst, oh, ow, r0, r1);
  });
}

// uint8 HWC -> float32 HWC / 255, with optional crop (top/left, out dims).
void mmde_normalize_crop_u8(const uint8_t* src, int h, int w, int ch,
                            int top, int left, int oh, int ow, float* dst,
                            int n_threads) {
  (void)h;
  parallel_rows(oh, n_threads, [&](int r0, int r1) {
    constexpr float kInv = 1.0f / 255.0f;
    for (int y = r0; y < r1; ++y) {
      const uint8_t* srow = src + ((top + y) * w + left) * ch;
      float* drow = dst + y * ow * ch;
      const int n = ow * ch;
      for (int i = 0; i < n; ++i) drow[i] = srow[i] * kInv;
    }
  });
}

// 16-bit depth PNG payload -> meters: v / 256 / 1000 (VOID convention).
void mmde_depth_u16_to_m(const uint16_t* src, int n, float* dst,
                         int n_threads) {
  parallel_rows(n, n_threads, [&](int r0, int r1) {
    constexpr float kScale = 1.0f / (256.0f * 1000.0f);
    for (int i = r0; i < r1; ++i) dst[i] = src[i] * kScale;
  });
}

// PNG row unfiltering: `raw` holds `rows` rows of 1 filter-type byte and
// `rowbytes` filtered bytes; `bpp` is the bytes per complete pixel (at
// least 1). Writes rows x rowbytes bytes to `out`. Returns 0, or -1 for a
// filter type outside 0-4.
int mmde_png_unfilter(const uint8_t* raw, int rows, int rowbytes, int bpp,
                      uint8_t* out) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const int ft = in[0];
    ++in;
    uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
    const uint8_t* prev = y ? cur - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// cv2.cvtColor(RGB2HSV) of `rows` x `cols` uint8 RGB pixels (H 0-179).
void mmde_rgb_to_hsv_u8(const uint8_t* src, int rows, int cols,
                        uint8_t* dst) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  for (int64_t i = 0; i < n; ++i) {
    int h, s, v;
    rgb_to_hsv_px(src + 3 * i, &h, &s, &v);
    dst[3 * i] = static_cast<uint8_t>(h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// Pixels of a row that cv2's vector HSV -> RGB path converts per iteration
// (its AVX2 build, v_uint8 lanes); the row's remaining pixels take the
// scalar path.
constexpr int kHsvVectorPixels = 32;

// cv2.cvtColor(HSV2RGB) of `rows` x `cols` uint8 HSV pixels, row by row as
// cv2 does it: the first cols / kHsvVectorPixels * kHsvVectorPixels pixels
// of a row through its vector path, the rest through its scalar path.
void mmde_hsv_to_rgb_u8(const uint8_t* src, int rows, int cols,
                        uint8_t* dst) {
  const int split = cols / kHsvVectorPixels * kHsvVectorPixels;
  for (int y = 0; y < rows; ++y)
    for (int x = 0; x < cols; ++x) {
      const int64_t i = static_cast<int64_t>(y) * cols + x;
      hsv_to_rgb_px(src[3 * i], src[3 * i + 1], src[3 * i + 2], x < split,
                    dst + 3 * i);
    }
}

// The augmentation's HSV jitter of uint8 RGB: to HSV, hue + dh mod 180,
// saturation and value + ds / dv clipped to 0-255, back to RGB (cv2's
// conversions, as above). `src` and `dst` may be the same buffer.
void mmde_hsv_jitter_u8(const uint8_t* src, int rows, int cols, int dh,
                        int ds, int dv, uint8_t* dst) {
  const int split = cols / kHsvVectorPixels * kHsvVectorPixels;
  for (int y = 0; y < rows; ++y)
    for (int x = 0; x < cols; ++x) {
      const int64_t i = static_cast<int64_t>(y) * cols + x;
      int h, s, v;
      rgb_to_hsv_px(src + 3 * i, &h, &s, &v);
      h = ((h + dh) % 180 + 180) % 180;
      s = std::min(std::max(s + ds, 0), 255);
      v = std::min(std::max(v + dv, 0), 255);
      hsv_to_rgb_px(h, s, v, x < split, dst + 3 * i);
    }
}

// Frame header of a JPEG stream: height, width, components. Returns 0 or a
// negative JpegStatus naming what is not supported.
int mmde_jpeg_info(const uint8_t* data, int64_t size, int* height,
                   int* width, int* components) {
  Jpeg j;
  j.data = data;
  j.size = static_cast<size_t>(size);
  const int st = parse(&j, false);
  if (st != kOk) return st;
  *height = j.height;
  *width = j.width;
  *components = j.ncomp;
  return kOk;
}

// Decode a JPEG stream into `out`: (height, width) grey for 1 component,
// (height, width, 3) RGB for 3. Returns 0 or a negative JpegStatus.
int mmde_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                     int height, int width, int components) {
  Jpeg j;
  j.data = data;
  j.size = static_cast<size_t>(size);
  const int st = parse(&j, true);
  if (st != kOk) return st;
  if (j.height != height || j.width != width || j.ncomp != components)
    return kCorrupt;
  if (j.ncomp == 1) {
    const Component& c = j.comp[0];
    for (int y = 0; y < height; ++y)
      std::memcpy(out + static_cast<size_t>(y) * width,
                  c.plane.data() + static_cast<size_t>(y) * c.bw * 8, width);
    return kOk;
  }
  std::vector<uint8_t> rows[3];
  for (int i = 0; i < 3; ++i) rows[i].assign(2 * (j.comp[i].bw * 8) + 16, 0);
  for (int y = 0; y < height; ++y) {
    for (int i = 0; i < 3; ++i)
      upsample_row(j.comp[i], j.hmax, j.vmax, y, rows[i].data());
    uint8_t* o = out + static_cast<size_t>(y) * width * 3;
    const uint8_t* yy = rows[0].data();
    const uint8_t* cb = rows[1].data();
    const uint8_t* cr = rows[2].data();
    for (int x = 0; x < width; ++x) {
      const int Y = yy[x];
      o[3 * x] = clamp_u8(Y + g_ycc.cr_r[cr[x]]);
      o[3 * x + 1] = clamp_u8(
          Y + static_cast<int>((g_ycc.cb_g[cb[x]] + g_ycc.cr_g[cr[x]]) >> 16));
      o[3 * x + 2] = clamp_u8(Y + g_ycc.cb_b[cb[x]]);
    }
  }
  return kOk;
}

}  // extern "C"
