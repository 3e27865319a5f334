// Native audio kernels for the host-side data path of the PyTorch port: a
// copy of native/acestep_audio.cpp (the JAX package's), built at first use by
// acestep_tpu_torch/utils/native_audio.py with g++ and the flags of
// native/Makefile, and bound there with ctypes. Host code: not a CUDA source.
//
// Exposed C ABI:
//   as_resample_poly : Kaiser-windowed-sinc polyphase resampling (planar f32)
//   as_f32_to_i16    : peak-scan + normalize + interleave + int16 quantize
//   as_i16_to_f32    : de-interleave + float conversion
//   as_peak          : max |x|

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// Round-half-to-even int16 quantize, independent of the runtime fenv rounding
// mode (lrintf follows fesetround(); a loaded library flipping the mode would
// silently diverge from np.round while parity tests in a clean env still
// pass). |v| <= 32767 on entry (callers clip first), so the int64 floor is
// exact and the tie comparison happens on the same f32 product numpy sees.
static inline int16_t as_quantize_i16(float v) {
  float f = std::floor(v);
  int64_t n = (int64_t)f;
  float diff = v - f;
  if (diff > 0.5f || (diff == 0.5f && (n & 1))) n += 1;
  return (int16_t)n;
}

extern "C" {

// max |x| over n floats
float as_peak(const float* x, int64_t n) {
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float a = x[i] < 0 ? -x[i] : x[i];
    if (a > peak) peak = a;
  }
  return peak;
}

// planar f32 (ch, n) -> interleaved int16 (n, ch), scaling peak to target_gain
// (target_gain <= 0 means clip-guard only).
void as_f32_to_i16(const float* x, int64_t n, int ch, float target_gain,
                   int16_t* out) {
  float peak = as_peak(x, n * ch);
  float scale = 1.0f;
  if (target_gain > 0.0f && peak > 1e-9f) {
    scale = target_gain / peak;
  } else if (peak > 1.0f) {
    scale = 1.0f / peak;
  }
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < ch; ++c) {
      float v = x[c * n + i] * scale;
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      out[i * ch + c] = as_quantize_i16(v * 32767.0f);
    }
  }
}

// One decoded VAE chunk, bf16 interleaved (b, lc, ch), -> scaled int16 PCM
// written into the planar output (b, ch, total) at time offset `pos`
// (dst[bi, c, pos .. pos+take)). Fuses bf16 decode + per-sample scale + clip
// + round-to-nearest-even int16 quantize in ONE pass — the serving host's
// replacement for ~5 numpy passes (bf16->f32, transpose, mul, clip,
// round/astype) over up to ~100 MB per request. bf16 -> f32 is a 16-bit
// left shift (bf16 is the top half of an IEEE f32).
// `planar`: 0 = src is interleaved (b, lc, ch) C-order; 1 = src is planar
// (b, ch, lc) physical layout — what the TPU runtime actually exports for
// (b, lc, ch) bf16 device arrays (channel-major device layout), giving fully
// sequential reads AND writes.
void as_bf16_chunk_to_i16(const uint16_t* src, int64_t b, int64_t lc,
                          int64_t take, int ch, const float* scale,
                          int16_t* dst, int64_t total, int64_t pos,
                          int planar) {
  if (take > lc) take = lc;
  if (pos < 0 || pos + take > total) return;
  for (int64_t bi = 0; bi < b; ++bi) {
    const float s = scale[bi];
    const uint16_t* sb = src + bi * lc * ch;
    for (int c = 0; c < ch; ++c) {
      int16_t* d = dst + (bi * ch + c) * total + pos;
      const uint16_t* sp = planar ? sb + (int64_t)c * lc : sb + c;
      const int64_t stride = planar ? 1 : ch;
      for (int64_t i = 0; i < take; ++i) {
        uint32_t bits = (uint32_t)sp[(size_t)(i * stride)] << 16;
        float v;
        memcpy(&v, &bits, sizeof(v));
        // Same op order as the numpy path (scale, clip to [-1,1], *32767,
        // round-half-to-even) so both produce identical bytes.
        v *= s;
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        d[i] = as_quantize_i16(v * 32767.0f);
      }
    }
  }
}

// interleaved int16 (n, ch) -> planar f32 (ch, n)
void as_i16_to_f32(const int16_t* x, int64_t n, int ch, float* out) {
  const float inv = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < ch; ++c) {
      out[c * n + i] = (float)x[i * ch + c] * inv;
    }
  }
}

static double kaiser_i0(double x) {
  // Modified Bessel function of the first kind, order 0 (series expansion).
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 32; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-12 * sum) break;
  }
  return sum;
}

// Polyphase windowed-sinc resampler: planar f32 (ch, in_len) at sr_in ->
// planar f32 (ch, out_len) at sr_out where out_len = in_len * up / down
// after reduction. Caller provides out sized ceil(in_len * sr_out / sr_in).
// Returns actual output length.
int64_t as_resample_poly(const float* in, int64_t in_len, int ch, int sr_in,
                         int sr_out, float* out) {
  if (sr_in == sr_out) {
    memcpy(out, in, sizeof(float) * (size_t)(in_len * ch));
    return in_len;
  }
  // reduce ratio
  int a = sr_in, b = sr_out;
  while (b) { int t = a % b; a = b; b = t; }
  const int g = a;
  const int up = sr_out / g, down = sr_in / g;

  // Kaiser-windowed sinc, cutoff at min(1/up, 1/down) of Nyquist.
  const int half_taps_per_phase = 10;
  const double cutoff = 0.5 / (up > down ? up : down);
  const int half = half_taps_per_phase * (up > down ? up : down);
  const double beta = 8.6;  // ~ -80 dB stopband
  const double i0b = kaiser_i0(beta);

  std::vector<double> h(2 * half + 1);
  for (int i = -half; i <= half; ++i) {
    double t = (double)i;
    double sinc = (i == 0) ? 2.0 * cutoff
                           : sin(2.0 * M_PI * cutoff * t) / (M_PI * t);
    double w = kaiser_i0(beta * sqrt(1.0 - (t / half) * (t / half))) / i0b;
    h[i + half] = sinc * w * up;
  }

  const int64_t out_len = (in_len * (int64_t)up) / down;
  for (int c = 0; c < ch; ++c) {
    const float* src = in + (int64_t)c * in_len;
    float* dst = out + (int64_t)c * out_len;
    for (int64_t m = 0; m < out_len; ++m) {
      // output sample m corresponds to upsampled index m*down
      const int64_t pos_up = m * (int64_t)down;   // index in up-rate grid
      const int64_t n0 = pos_up / up;             // nearest input index
      const int phase = (int)(pos_up % up);
      double acc = 0.0;
      // h index: k such that tap aligns: up-grid offset = phase + j*up
      for (int64_t j = -(half / up) - 1; j <= (half / up) + 1; ++j) {
        const int64_t nin = n0 - j;
        if (nin < 0 || nin >= in_len) continue;
        const int64_t hidx = (int64_t)half + phase + j * up;
        if (hidx < 0 || hidx > 2 * half) continue;
        acc += (double)src[nin] * h[hidx];
      }
      dst[m] = (float)acc;
    }
  }
  return out_len;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC encoder (fixed predictors + Rice coding), written to the public FLAC
// format spec. Role: the reference ships FLAC as its DEFAULT output format
// through torchaudio/ffmpeg (audio_utils.py AudioSaver); this environment has
// neither, so the native module encodes it directly — lossless, zero
// dependencies. Verified in tests by an independent Python decoder
// (tests/test_audio_native.py round-trips bit-exactly).
// ---------------------------------------------------------------------------

namespace {

// --- MD5 (RFC 1321) over the unencoded interleaved samples (STREAMINFO) ---
struct Md5 {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t total = 0;
  uint8_t buf[64];
  int buffered = 0;

  static uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};
    uint32_t m[16];
    for (int i = 0; i < 16; ++i)
      m[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
             ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
    uint32_t A = a, B = b, C = c, D = d;
    for (int i = 0; i < 64; ++i) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        f = (D & B) | (~D & C);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        f = B ^ C ^ D;
        g = (3 * i + 5) & 15;
      } else {
        f = C ^ (B | ~D);
        g = (7 * i) & 15;
      }
      uint32_t tmp = D;
      D = C;
      C = B;
      B = B + rotl(A + f + K[i] + m[g], S[i]);
      A = tmp;
    }
    a += A; b += B; c += C; d += D;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    while (n) {
      size_t take = 64 - buffered;
      if (take > n) take = n;
      memcpy(buf + buffered, p, take);
      buffered += (int)take;
      p += take;
      n -= take;
      if (buffered == 64) { block(buf); buffered = 0; }
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buffered != 56) update(&z, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; ++i) len[i] = (uint8_t)(bits >> (8 * i));
    update(len, 8);
    uint32_t h[4] = {a, b, c, d};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) out[4 * i + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

// --- MSB-first bit writer with FLAC frame CRCs ---
struct BitWriter {
  uint8_t* out;
  int64_t cap, len = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  void put(uint64_t v, int bits) {
    while (bits > 0) {
      int take = bits > 32 ? 32 : bits;
      uint32_t chunk = (uint32_t)((v >> (bits - take)) & ((take == 32) ? 0xffffffffu : ((1u << take) - 1u)));
      acc = (acc << take) | chunk;
      nbits += take;
      bits -= take;
      while (nbits >= 8) {
        nbits -= 8;
        if (len >= cap) { overflow = true; return; }
        out[len++] = (uint8_t)(acc >> nbits);
      }
    }
  }

  void put_signed(int64_t v, int bits) { put((uint64_t)v & ((bits == 64) ? ~0ull : ((1ull << bits) - 1)), bits); }

  void align() {
    if (nbits) put(0, 8 - nbits);
  }

  void unary(uint32_t q) {
    while (q >= 32) { put(0, 32); q -= 32; }
    put(1, (int)q + 1);  // q zeros then a 1
  }
};

uint8_t crc8(const uint8_t* p, int64_t n) {
  uint8_t c = 0;
  for (int64_t i = 0; i < n; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* p, int64_t n) {
  uint16_t c = 0;
  for (int64_t i = 0; i < n; ++i) {
    c ^= (uint16_t)p[i] << 8;
    for (int b = 0; b < 8; ++b) c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

// UTF-8-style coded frame number (frame header, fixed-blocksize streams).
void put_coded_number(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.put(v, 8); return; }
  int bytes = 0;
  uint64_t t = v;
  while (t) { t >>= 1; ++bytes; }  // bit length
  int cont;  // continuation bytes: lead holds (6 - cont) bits, each cont 6
  for (cont = 1; cont <= 6; ++cont) {
    int capacity = (6 - cont) + 6 * cont;  // lead bits + 6 per continuation
    if (bytes <= capacity) break;
  }
  uint8_t lead = (uint8_t)(0xFF << (7 - cont)) & 0xFF;
  bw.put((uint64_t)lead | ((v >> (6 * cont)) & ((1u << (6 - cont)) - 1)), 8);
  for (int i = cont - 1; i >= 0; --i) bw.put(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

// Best Rice parameter for zigzagged residuals; returns cost in bits.
int best_rice(const uint64_t* u, int64_t n, int64_t* cost_out) {
  int best_r = 0;
  int64_t best_cost = INT64_MAX;
  for (int r = 0; r <= 14; ++r) {
    int64_t cost = 0;
    for (int64_t i = 0; i < n; ++i) cost += (int64_t)(u[i] >> r) + 1 + r;
    if (cost < best_cost) { best_cost = cost; best_r = r; }
    if (cost > best_cost * 4) break;  // diverging; larger r only grows
  }
  *cost_out = best_cost;
  return best_r;
}

// Encode one subframe (constant / best fixed order 0-4 + Rice partition 0
// with raw escape) at an arbitrary bits-per-sample (side channels use 17).
void encode_subframe(BitWriter& bw, const int32_t* x, int bs, int bps,
                     std::vector<int64_t>& resid, std::vector<uint64_t>& zig) {
  bool constant = true;
  for (int i = 1; i < bs && constant; ++i) constant = x[i] == x[0];
  bw.put(0, 1);  // subframe zero pad
  if (constant) {
    bw.put(0b000000, 6);  // constant
    bw.put(0, 1);         // no wasted bits
    bw.put_signed(x[0], bps);
    return;
  }

  int best_order = 0;
  int64_t best_sum = INT64_MAX;
  for (int order = 0; order <= 4 && order < bs; ++order) {
    int64_t s = 0;
    for (int i = order; i < bs; ++i) {
      int64_t e = x[i];
      if (order >= 1) e -= (int64_t)x[i - 1] * (order == 1 ? 1 : (order == 2 ? 2 : (order == 3 ? 3 : 4)));
      if (order >= 2) e += (int64_t)x[i - 2] * (order == 2 ? 1 : (order == 3 ? 3 : 6));
      if (order >= 3) e -= (int64_t)x[i - 3] * (order == 3 ? 1 : 4);
      if (order >= 4) e += (int64_t)x[i - 4];
      s += e < 0 ? -e : e;
    }
    if (s < best_sum) { best_sum = s; best_order = order; }
  }
  const int order = best_order;
  for (int i = order; i < bs; ++i) {
    int64_t e = x[i];
    if (order >= 1) e -= (int64_t)x[i - 1] * (order == 1 ? 1 : (order == 2 ? 2 : (order == 3 ? 3 : 4)));
    if (order >= 2) e += (int64_t)x[i - 2] * (order == 2 ? 1 : (order == 3 ? 3 : 6));
    if (order >= 3) e -= (int64_t)x[i - 3] * (order == 3 ? 1 : 4);
    if (order >= 4) e += (int64_t)x[i - 4];
    resid[i - order] = e;
  }
  const int64_t nres = bs - order;
  for (int64_t i = 0; i < nres; ++i) {
    int64_t e = resid[i];
    zig[i] = e >= 0 ? (uint64_t)e << 1 : (((uint64_t)(-e)) << 1) - 1;
  }

  bw.put(0b001000 | (uint64_t)order, 6);  // fixed subframe
  bw.put(0, 1);                           // no wasted bits
  for (int i = 0; i < order; ++i) bw.put_signed(x[i], bps);

  // Residual: Rice method with PARTITIONED parameters — one parameter per
  // 2^p slice adapts to loud/quiet passages within the block. Per candidate
  // order, each partition picks best-rice or a raw escape; the cheapest
  // total wins.
  auto part_plan = [&](int p, std::vector<int>& params, std::vector<int>& raws) -> int64_t {
    const int parts = 1 << p;
    if ((bs >> p) << p != bs) return INT64_MAX;       // must divide evenly
    if ((bs >> p) - order <= 0) return INT64_MAX;     // first partition nonempty
    params.assign(parts, 0);
    raws.assign(parts, 0);
    int64_t total = 0;
    int64_t idx = 0;
    for (int q = 0; q < parts; ++q) {
      int count = (bs >> p) - (q == 0 ? order : 0);
      int64_t rice_cost;
      int r = best_rice(zig.data() + idx, count, &rice_cost);
      int raw_bits = 1;
      for (int i = 0; i < count; ++i) {
        int64_t e = resid[idx + i];
        uint64_t mag = e < 0 ? (uint64_t)(-(e + 1)) : (uint64_t)e;
        int need = 1;
        while (mag >> (need - 1) > 0 && need < 32) ++need;  // signed bits
        if (need + 1 > raw_bits) raw_bits = need + 1;
      }
      const int64_t escape_cost = 5 + (int64_t)count * raw_bits;
      if (escape_cost < rice_cost) {
        params[q] = -1;  // escape marker
        raws[q] = raw_bits;
        total += 4 + escape_cost;
      } else {
        params[q] = r;
        total += 4 + rice_cost;
      }
      idx += count;
    }
    return total;
  };

  // Pick the partition order with the standard sum-based estimator (one
  // pass: per-slice |u| sums at the finest order, merged upward; estimated
  // rice bits = n*(r+1) + sum>>r with r = log2(mean)), then compute the
  // exact per-partition plan only for the winner.
  int best_p = 0;
  {
    const int PMAX = 6;
    int pmax = PMAX;
    while (pmax > 0 && (((bs >> pmax) << pmax) != bs || (bs >> pmax) <= order))
      --pmax;
    std::vector<uint64_t> sums((size_t)1 << pmax, 0);
    std::vector<int64_t> cnts((size_t)1 << pmax, 0);
    {
      int64_t idx = 0;
      for (int q = 0; q < (1 << pmax); ++q) {
        int count = (bs >> pmax) - (q == 0 ? order : 0);
        uint64_t s = 0;
        for (int i = 0; i < count; ++i) s += zig[idx + i];
        sums[q] = s;
        cnts[q] = count;
        idx += count;
      }
    }
    auto est_level = [](const std::vector<uint64_t>& s,
                        const std::vector<int64_t>& c) {
      int64_t total = 0;
      for (size_t q = 0; q < s.size(); ++q) {
        uint64_t mean = c[q] > 0 ? s[q] / (uint64_t)c[q] : 0;
        int r = 0;
        while ((mean >> r) > 0 && r < 14) ++r;
        total += 4 + c[q] * (int64_t)(r + 1) + (int64_t)(s[q] >> r);
      }
      return total;
    };
    int64_t best_est = INT64_MAX;
    for (int p = pmax; p >= 0; --p) {
      int64_t est = est_level(sums, cnts);
      if (est < best_est) { best_est = est; best_p = p; }
      if (p > 0) {  // merge pairs for the next (coarser) level
        for (size_t q = 0; q < sums.size() / 2; ++q) {
          sums[q] = sums[2 * q] + sums[2 * q + 1];
          cnts[q] = cnts[2 * q] + cnts[2 * q + 1];
        }
        sums.resize(sums.size() / 2);
        cnts.resize(cnts.size() / 2);
      }
    }
  }
  std::vector<int> best_params, best_raws;
  if (part_plan(best_p, best_params, best_raws) == INT64_MAX) {
    best_p = 0;
    part_plan(0, best_params, best_raws);
  }

  bw.put(0b00, 2);                // Rice method (4-bit params)
  bw.put((uint64_t)best_p, 4);    // partition order
  int64_t idx = 0;
  const int parts = 1 << best_p;
  for (int q = 0; q < parts; ++q) {
    int count = (bs >> best_p) - (q == 0 ? order : 0);
    if (best_params[q] < 0) {
      bw.put(0b1111, 4);  // escape: raw residuals
      bw.put((uint64_t)best_raws[q], 5);
      for (int i = 0; i < count; ++i) bw.put_signed(resid[idx + i], best_raws[q]);
    } else {
      const int r = best_params[q];
      bw.put((uint64_t)r, 4);
      for (int i = 0; i < count; ++i) {
        bw.unary((uint32_t)(zig[idx + i] >> r));
        if (r) bw.put(zig[idx + i] & ((1ull << r) - 1), r);
      }
    }
    idx += count;
  }
}

// Order-2 |residual| sum — the stereo-decorrelation cost proxy.
int64_t order2_cost(const int32_t* x, int bs) {
  int64_t s = 0;
  for (int i = 2; i < bs; ++i) {
    int64_t e = (int64_t)x[i] - 2 * (int64_t)x[i - 1] + (int64_t)x[i - 2];
    s += e < 0 ? -e : e;
  }
  return s;
}

// --- MSB-first bit reader with bounds checking (decoder) ---
struct BitReader {
  const uint8_t* data;
  int64_t nbits;  // total bits
  int64_t pos = 0;
  bool fail = false;

  BitReader(const uint8_t* d, int64_t nbytes) : data(d), nbits(nbytes * 8) {}

  uint32_t read(int n) {
    if (pos + n > nbits) { fail = true; return 0; }
    uint32_t v = 0;
    int64_t p = pos;
    int left = n;
    while (left > 0) {
      uint8_t byte = data[p >> 3];
      int avail = 8 - (int)(p & 7);
      int take = avail < left ? avail : left;
      int shift = avail - take;
      v = (v << take) | ((byte >> shift) & ((1u << take) - 1u));
      p += take;
      left -= take;
    }
    pos = p;
    return v;
  }

  int64_t read_signed(int n) {
    int64_t v = 0;
    if (n > 32) {
      // sequence the two mutating reads explicitly (| has no eval order)
      int64_t hi = read(n - 32);
      int64_t lo = read(32);
      v = (hi << 32) | lo;
    } else {
      v = read(n);
    }
    if (!fail && n > 0 && (v >> (n - 1)) & 1) v -= (int64_t)1 << n;
    return v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!fail) {
      if (pos >= nbits) { fail = true; return 0; }
      uint8_t byte = data[pos >> 3];
      int rem = 8 - (int)(pos & 7);
      uint8_t chunk = byte & ((1u << rem) - 1u);
      if (chunk == 0) { q += rem; pos += rem; continue; }
      int blen = 0;  // bit_length of chunk
      for (uint8_t t = chunk; t; t >>= 1) ++blen;
      int lead = rem - blen;
      q += lead;
      pos += lead + 1;
      return q;
    }
    return 0;
  }

  void align() { pos = (pos + 7) & ~(int64_t)7; }
};

uint64_t read_utf8_number(BitReader& br) {
  uint32_t b0 = br.read(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  while ((b0 << n) & 0x80) ++n;
  uint64_t v = b0 & (0x7Fu >> n);
  for (int i = 0; i < n - 1; ++i) v = (v << 6) | (br.read(8) & 0x3F);
  return v;
}

const int kFixedOrders[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_residual(BitReader& br, int n, int order, int64_t* res) {
  uint32_t method = br.read(2);
  if (method > 1 || br.fail) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1u;
  uint32_t part_order = br.read(4);
  int parts = 1 << part_order;
  if ((n >> part_order) << part_order != n) return false;
  int64_t idx = 0;
  for (int p = 0; p < parts; ++p) {
    int count = n >> part_order;
    if (p == 0) count -= order;
    if (count < 0) return false;
    uint32_t r = br.read(plen);
    if (r == escape) {
      uint32_t bits = br.read(5);
      for (int i = 0; i < count; ++i)
        res[idx++] = bits ? br.read_signed((int)bits) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br.read_unary();
        uint64_t u = r ? ((q << r) | br.read((int)r)) : q;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.fail) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int n, int bps, int64_t* x, int64_t* res) {
  if (br.read(1)) return false;  // padding bit must be 0
  uint32_t stype = br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  if (br.fail || bps <= 0 || bps > 33) return false;

  if (stype == 0) {  // constant
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < n; ++i) x[i] = v;
  } else if (stype == 1) {  // verbatim
    for (int i = 0; i < n; ++i) x[i] = br.read_signed(bps);
  } else if (stype >= 8 && stype <= 12) {  // fixed
    int order = (int)(stype & 7);
    if (order > n) return false;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(bps);
    if (!decode_residual(br, n, order, res)) return false;
    const int* cf = kFixedOrders[order];
    for (int i = order; i < n; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += (int64_t)cf[j] * x[i - 1 - j];
      x[i] = res[i - order] + pred;
    }
  } else if (stype >= 32) {  // LPC
    int order = (int)(stype & 31) + 1;
    if (order > n) return false;
    for (int i = 0; i < order; ++i) x[i] = br.read_signed(bps);
    int precision = (int)br.read(4) + 1;
    if (precision == 16) return false;  // reserved
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_residual(br, n, order, res)) return false;
    for (int i = order; i < n; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * x[i - 1 - j];
      x[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;  // reserved type
  }
  if (br.fail) return false;
  if (wasted)
    for (int i = 0; i < n; ++i) x[i] <<= wasted;
  return true;
}

const int kBlocksizeTable[16] = {0,   192,  576,  1152,  2304,  4608, -8, -16,
                                 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

}  // namespace

extern "C" {

// Encode interleaved int16 PCM (n_frames, channels) into a complete FLAC
// stream. Returns bytes written, or -1 when out_cap is too small.
// Fixed 4096-sample blocks (last block smaller), independent channels,
// fixed predictors 0-4 / constant subframes, Rice partition order 0.
int64_t as_flac_encode(const int16_t* pcm, int64_t n_frames, int channels,
                       int sample_rate, uint8_t* out, int64_t out_cap) {
  if (channels < 1 || channels > 8 || n_frames <= 0) return -1;
  const int BLOCK = 4096;
  const int BPS = 16;

  BitWriter bw(out, out_cap);
  bw.put('f', 8); bw.put('L', 8); bw.put('a', 8); bw.put('C', 8);

  // STREAMINFO (type 0, last metadata block, 34 bytes)
  bw.put(1, 1); bw.put(0, 7); bw.put(34, 24);
  // Fixed-blocksize stream: declared min == max; the final (smaller) block
  // is excluded from these fields by the format.
  int declared = n_frames < BLOCK ? (int)(n_frames < 16 ? 16 : n_frames) : BLOCK;
  bw.put((uint64_t)declared, 16);
  bw.put((uint64_t)declared, 16);
  bw.put(0, 24); bw.put(0, 24);  // min/max frame size unknown
  bw.put((uint64_t)sample_rate, 20);
  bw.put((uint64_t)(channels - 1), 3);
  bw.put((uint64_t)(BPS - 1), 5);
  bw.put((uint64_t)n_frames, 36);
  Md5 md5;
  md5.update((const uint8_t*)pcm, (size_t)n_frames * channels * 2);
  uint8_t digest[16];
  md5.final(digest);
  for (int i = 0; i < 16; ++i) bw.put(digest[i], 8);

  std::vector<int32_t> chan((size_t)BLOCK), chan2((size_t)BLOCK);
  std::vector<int32_t> mid((size_t)BLOCK), side((size_t)BLOCK);
  std::vector<int64_t> resid((size_t)BLOCK);
  std::vector<uint64_t> zig((size_t)BLOCK);

  const int64_t n_blocks = (n_frames + BLOCK - 1) / BLOCK;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const int64_t start = blk * BLOCK;
    const int bs = (int)((n_frames - start) < BLOCK ? (n_frames - start) : BLOCK);
    const int64_t frame_off = bw.len;
    if (bw.overflow) return -1;

    // Stereo decorrelation: per frame, pick independent L/R or mid/side by
    // the order-2 residual cost proxy (side = L-R is near-zero on
    // correlated material — typically 10-20% smaller frames).
    bool midside = false;
    if (channels == 2) {
      for (int i = 0; i < bs; ++i) {
        int32_t l = pcm[(start + i) * 2], r = pcm[(start + i) * 2 + 1];
        chan[i] = l;
        chan2[i] = r;
        mid[i] = (l + r) >> 1;
        side[i] = l - r;
      }
      midside = order2_cost(mid.data(), bs) + order2_cost(side.data(), bs)
                < order2_cost(chan.data(), bs) + order2_cost(chan2.data(), bs);
    }

    // Frame header: sync + fixed blocking, block size "16 bits at end",
    // sample rate "from STREAMINFO", 16 bps.
    bw.put(0x3FFE, 14);     // sync
    bw.put(0, 1);           // reserved
    bw.put(0, 1);           // fixed blocksize stream
    bw.put(0b0111, 4);      // block size: 16-bit value follows header
    bw.put(0b0000, 4);      // sample rate: STREAMINFO
    bw.put(midside ? 10 : (uint64_t)(channels - 1), 4);  // mid/side or independent
    bw.put(0b100, 3);       // 16 bps
    bw.put(0, 1);           // reserved
    put_coded_number(bw, (uint64_t)blk);
    bw.put((uint64_t)(bs - 1), 16);
    if (bw.overflow || bw.len >= out_cap) return -1;
    out[bw.len] = crc8(out + frame_off, bw.len - frame_off);
    bw.len += 1;

    if (midside) {
      encode_subframe(bw, mid.data(), bs, BPS, resid, zig);
      encode_subframe(bw, side.data(), bs, BPS + 1, resid, zig);  // side: +1 bit
    } else {
      for (int c = 0; c < channels; ++c) {
        for (int i = 0; i < bs; ++i) chan[i] = pcm[(start + i) * channels + c];
        encode_subframe(bw, chan.data(), bs, BPS, resid, zig);
      }
    }
    if (bw.overflow) return -1;

    bw.align();
    if (bw.len + 2 > out_cap) return -1;
    uint16_t fc = crc16(out + frame_off, bw.len - frame_off);
    out[bw.len++] = (uint8_t)(fc >> 8);
    out[bw.len++] = (uint8_t)fc;
  }
  return bw.overflow ? -1 : bw.len;
}

// Parse STREAMINFO: fills channels/sample_rate/bps/total_samples; returns the
// byte offset of the first frame, or -1 on malformed input.
int64_t as_flac_probe(const uint8_t* data, int64_t len, int32_t* channels,
                      int32_t* sample_rate, int32_t* bps, int64_t* total) {
  if (len < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  int64_t pos = 4;
  bool have_info = false;
  while (pos + 4 <= len) {
    uint8_t h0 = data[pos];
    int last = h0 & 0x80;
    int btype = h0 & 0x7F;
    int64_t blen = ((int64_t)data[pos + 1] << 16) | ((int64_t)data[pos + 2] << 8) |
                   data[pos + 3];
    if (pos + 4 + blen > len) return -1;
    if (btype == 0 && blen >= 34) {
      BitReader br(data + pos + 4, blen);
      br.read(16); br.read(16); br.read(24); br.read(24);
      *sample_rate = (int32_t)br.read(20);
      *channels = (int32_t)br.read(3) + 1;
      *bps = (int32_t)br.read(5) + 1;
      {
        // sequence the two mutating reads (| has no evaluation order)
        int64_t hi = br.read(4);
        int64_t lo = br.read(32);
        *total = (hi << 32) | lo;
      }
      have_info = true;
    }
    pos += 4 + blen;
    if (last) break;
  }
  return have_info ? pos : -1;
}

// Decode a full FLAC stream into interleaved int32 (total_samples, channels).
// `out` must hold total_samples*channels entries (from as_flac_probe).
// Covers the whole frame grammar: constant/verbatim/fixed/LPC subframes,
// 4/5-bit Rice partitions with raw escapes, wasted bits, and
// left/right/mid-side stereo. Returns samples decoded per channel, or -1.
int64_t as_flac_decode(const uint8_t* data, int64_t len, int32_t* out) {
  int32_t channels, sample_rate, bps;
  int64_t total;
  int64_t pos = as_flac_probe(data, len, &channels, &sample_rate, &bps, &total);
  if (pos < 0 || channels < 1 || channels > 8) return -1;

  BitReader br(data + pos, len - pos);
  std::vector<std::vector<int64_t>> sub((size_t)channels);
  std::vector<int64_t> res;
  int64_t written = 0;
  while (written < total) {
    if (br.read(14) != 0x3FFE || br.fail) return -1;
    br.read(1);            // reserved
    br.read(1);            // blocking strategy
    uint32_t bs_bits = br.read(4);
    uint32_t sr_bits = br.read(4);
    uint32_t chan_assign = br.read(4);
    uint32_t bps_bits = br.read(3);
    br.read(1);            // reserved
    read_utf8_number(br);
    int bs;
    if (bs_bits == 6) bs = (int)br.read(8) + 1;
    else if (bs_bits == 7) bs = (int)br.read(16) + 1;
    else if (kBlocksizeTable[bs_bits] > 0) bs = kBlocksizeTable[bs_bits];
    else return -1;
    if (sr_bits == 12) br.read(8);
    else if (sr_bits == 13 || sr_bits == 14) br.read(16);
    br.read(8);            // header CRC-8 (not verified)
    if (br.fail || bs <= 0) return -1;

    int frame_bps;
    switch (bps_bits) {
      case 0: frame_bps = bps; break;
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: return -1;
    }

    for (int c = 0; c < channels; ++c)
      if ((int64_t)sub[c].size() < bs) sub[c].resize(bs);
    if ((int64_t)res.size() < bs) res.resize(bs);

    if (chan_assign < 8) {
      if ((int)chan_assign + 1 != channels) return -1;
      for (int c = 0; c < channels; ++c)
        if (!decode_subframe(br, bs, frame_bps, sub[c].data(), res.data()))
          return -1;
    } else if (chan_assign <= 10 && channels == 2) {
      int extra_a = chan_assign == 9 ? 1 : 0;
      int extra_b = chan_assign == 9 ? 0 : 1;
      if (!decode_subframe(br, bs, frame_bps + extra_a, sub[0].data(), res.data()))
        return -1;
      if (!decode_subframe(br, bs, frame_bps + extra_b, sub[1].data(), res.data()))
        return -1;
      if (chan_assign == 8) {  // left/side → right = left - side
        for (int i = 0; i < bs; ++i) sub[1][i] = sub[0][i] - sub[1][i];
      } else if (chan_assign == 9) {  // right/side → left = side + right
        for (int i = 0; i < bs; ++i) sub[0][i] = sub[0][i] + sub[1][i];
      } else {  // mid/side
        for (int i = 0; i < bs; ++i) {
          int64_t m2 = (sub[0][i] << 1) | (sub[1][i] & 1);
          int64_t s = sub[1][i];
          sub[0][i] = (m2 + s) >> 1;
          sub[1][i] = (m2 - s) >> 1;
        }
      }
    } else {
      return -1;
    }
    br.align();
    br.read(16);  // frame CRC-16 (not verified)
    if (br.fail) return -1;

    int64_t take = total - written < bs ? total - written : bs;
    for (int64_t i = 0; i < take; ++i)
      for (int c = 0; c < channels; ++c)
        out[(written + i) * channels + c] = (int32_t)sub[c][i];
    written += take;
  }
  return written;
}

}  // extern "C"
