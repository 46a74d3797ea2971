// aadx — native host codec for the AAD bitstream format.
//
// aad_tpu_torch's own copy of aad_tpu/native/aadx.cc, kept byte-for-byte in
// step with it below this note (aad_tpu_torch/native/__init__.py builds it).
//
// Fresh C++17 implementation of the format (spec: SURVEY.md appendices A-C;
// behaviour pinned byte-exact to the ecosystem by the shared conformance
// suite in tests/). Compile with -fwrapv: the format's reference semantics
// are two's-complement int32 wraparound.

#include "aadx.h"

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#endif

namespace {

constexpr int kFilterOrder = 4;
constexpr int kFixedDigits = 15;
constexpr int32_t kHalf = 1 << (kFixedDigits - 1);
constexpr int kLmsShift = 3;
constexpr int kQ4 = 4;
constexpr int32_t kQ4Half = 1 << (kQ4 - 1);
constexpr int32_t kIndexMax = 255 << kQ4;
constexpr uint32_t kHeaderSize = 31;
constexpr uint32_t kFormatVersion = 4;
constexpr uint32_t kCodecVersion = 18;
constexpr uint32_t kMaxChannels = 2;

// ---- adaptation tables ----------------------------------------------------

struct Tables {
  int32_t step[256];
  int32_t delta4[8];
  int32_t delta3[4];
  int32_t delta2[2];
  Tables() {
    const double c = std::log2(32767.0 - std::pow(255.0, 1.1)) / 255.0;
    for (int x = 0; x < 256; ++x) {
      step[x] = static_cast<int32_t>(
          std::llround(std::pow(double(x), 1.1) + std::exp2(c * x)));
    }
    const double spec4[8] = {-1.17, -1.07, -0.9, 1, 2, 4, 8, 16};
    const double spec3[4] = {-1.06, -0.95, 2, 8};
    const double spec2[2] = {-0.9, 2.5};
    for (int i = 0; i < 8; ++i) delta4[i] = static_cast<int32_t>(spec4[i] * 16);
    for (int i = 0; i < 4; ++i) delta3[i] = static_cast<int32_t>(spec3[i] * 16);
    for (int i = 0; i < 2; ++i) delta2[i] = static_cast<int32_t>(spec2[i] * 16);
  }
  const int32_t* deltas(uint32_t bps) const {
    switch (bps) {
      case 4: return delta4;
      case 3: return delta3;
      default: return delta2;
    }
  }
};
const Tables& tables() {
  static const Tables t;
  return t;
}

// ---- small helpers --------------------------------------------------------

inline int32_t clip16(int32_t v) {
  return std::max<int32_t>(-32768, std::min<int32_t>(32767, v));
}

inline uint32_t rd_u16(const uint8_t* p) {
  return (uint32_t(p[0]) << 8) | p[1];
}
inline uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}
inline void wr_u16(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 8);
  p[1] = uint8_t(v);
}
inline void wr_u32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

inline uint32_t gcd_u32(uint32_t a, uint32_t b) {
  while (b) {
    uint32_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// ---- the adaptive predictor -----------------------------------------------

struct Lms {
  int32_t h[kFilterOrder] = {0, 0, 0, 0};  // h[0] = newest
  int32_t w[kFilterOrder] = {0, 0, 0, 0};
  int32_t idx = 0;

  // The slot min pins the malformed-header case (12-bit wire index in
  // (4080, 4095] -> slot 256, one past the table — UB in the reference,
  // whose asserts are DEBUG-only) to slot 255, matching the JAX engines'
  // clip-mode lookup. Valid streams never reach it; the cmov is noise
  // next to the quantiser idiv.
  int32_t stepsize() const {
    return tables().step[std::max(0, std::min((idx + kQ4Half) >> kQ4, 255))];
  }

  void adapt_index(uint32_t code, uint32_t bps) {
    const int32_t half = 1 << (bps - 1);
    const int32_t d = tables().deltas(bps)[code & (half - 1)];
    idx = std::max<int32_t>(0, std::min<int32_t>(kIndexMax, idx + d));
  }

  int32_t predict() const {
    int32_t acc = kHalf;
    for (int k = 0; k < kFilterOrder; ++k) acc += h[k] * w[k];
    return acc >> kFixedDigits;
  }

  void update(int32_t qdiff, int32_t sample) {
    for (int k = 0; k < kFilterOrder; ++k)
      w[k] += (qdiff * h[k] + kHalf) >> (kFixedDigits + kLmsShift);
    for (int k = kFilterOrder - 1; k > 0; --k) h[k] = h[k - 1];
    h[0] = sample;
  }

  int32_t decode(uint32_t code, uint32_t bps) {
    const uint32_t sign = 1u << (bps - 1);
    const int32_t s = stepsize();
    int32_t q = (s * (int32_t((code & (sign - 1)) << 1) + 1)) >> (bps - 1);
    if (code & sign) q = -q;
    const int32_t sample = clip16(q + predict());
    adapt_index(code, bps);
    update(q, sample);
    return sample;
  }

  // Returns the code; quantisation error (the reconstructed diff) through
  // *qdiff for the trial search.
  // The quantiser keeps the plain idiv: 32-bit division with these small
  // operands is variable-latency fast (~10 cycles) on modern cores, so it
  // beats both a Granlund-Montgomery magic multiply (byte-exact but ~11%
  // slower: per-stepsize magic-table loads) and the SIMD engines'
  // binary-search threshold form (byte-exact but 11.3 -> 7.5 M samples/s
  // at bps=4: the dependent compare levels are longer than the divide).
  uint32_t encode(int32_t sample, uint32_t bps, int32_t* qdiff) {
    const uint32_t sign = 1u << (bps - 1);
    const uint32_t absmask = sign - 1;
    const int32_t s = stepsize();
    const int32_t pred = predict();
    int32_t diff = sample - pred;
    const bool neg = diff < 0;
    int32_t mag = neg ? -diff : diff;
    uint32_t code =
        std::min<int32_t>((mag << (bps - 2)) / s, int32_t(absmask));
    if (neg) code |= sign;
    int32_t q = (s * (int32_t((code & absmask) << 1) + 1)) >> (bps - 1);
    if (neg) q = -q;
    adapt_index(code, bps);
    *qdiff = q;
    update(q, clip16(q + pred));
    return code;
  }

  void seed(const int32_t* samples, uint32_t n) {
    for (uint32_t k = 0; k < kFilterOrder; ++k)
      h[kFilterOrder - 1 - k] = (k < n) ? int16_t(samples[k]) : 0;
  }
};

struct Geometry {
  uint32_t block_size = 0;
  uint32_t samples_per_block = 0;
  uint32_t header_bytes = 0;
  uint32_t unit_bytes = 0;
  uint32_t samples_per_unit = 0;
};

int derive_geometry(uint32_t max_block, uint32_t nch, uint32_t bps,
                    Geometry* g) {
  if (nch == 0 || nch > kMaxChannels || bps == 0 || bps > 4)
    return AADX_INVALID_FORMAT;
  const uint32_t header = (4 * kFilterOrder + 2) * nch;
  if (max_block < header) return AADX_INVALID_FORMAT;
  const uint32_t lcm = 8 * bps / gcd_u32(8, bps);
  const uint32_t unit = nch * (lcm / 8);
  const uint32_t spu = unit * 8 / (nch * bps);
  const uint32_t units = (max_block - header) / unit;
  g->header_bytes = header;
  g->unit_bytes = unit;
  g->samples_per_unit = spu;
  g->block_size = header + units * unit;
  g->samples_per_block = units * spu + kFilterOrder;
  return AADX_OK;
}

// ---- block codecs ---------------------------------------------------------

// Decode one block into out[ch][t] (pointers per channel), returning bytes
// consumed. `limit` bounds the emitted samples (ragged final block).
size_t decode_block(const uint8_t* p, const AadxInfo& info, const Geometry& g,
                    Lms* lms, int32_t** out, uint32_t limit) {
  const uint32_t nch = info.num_channels;
  const uint32_t bps = info.bits_per_sample;
  const uint8_t* start = p;

  for (uint32_t ch = 0; ch < nch; ++ch) {
    const uint32_t tag = rd_u16(p);
    p += 2;
    // Parse-clamp: a malformed 12-bit wire index in (4080, 4095] pins to
    // the table maximum — the framework-defined semantics for the
    // reference's UB case, applied identically at every engine's header
    // parse (format/framing.py, ops/wire32.py, and here).
    lms[ch].idx = std::min(int32_t(tag >> kQ4), kIndexMax);
    const uint32_t shift = tag & 0xF;
    for (int k = 0; k < kFilterOrder; ++k) {
      lms[ch].w[k] = int32_t(int16_t(rd_u16(p))) << shift;
      p += 2;
      lms[ch].h[k] = int16_t(rd_u16(p));
      p += 2;
    }
  }

  const uint32_t emit = std::min(info.num_samples_per_block, limit);
  for (uint32_t ch = 0; ch < nch; ++ch)
    for (uint32_t t = 0; t < std::min<uint32_t>(kFilterOrder, emit); ++t)
      out[ch][t] = lms[ch].h[kFilterOrder - 1 - t];

  const uint32_t spu = g.samples_per_unit;
  for (uint32_t t = kFilterOrder; t < emit; t += spu) {
    const uint32_t take = std::min<uint32_t>(spu, emit - t);
    for (uint32_t ch = 0; ch < nch; ++ch) {
      int32_t buf[8];
      if (bps == 4) {
        const uint32_t b = *p++;
        buf[0] = lms[ch].decode((b >> 4) & 0xF, 4);
        buf[1] = lms[ch].decode(b & 0xF, 4);
      } else if (bps == 2) {
        const uint32_t b = *p++;
        for (int k = 0; k < 4; ++k)
          buf[k] = lms[ch].decode((b >> (6 - 2 * k)) & 0x3, 2);
      } else {
        const uint32_t word =
            (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
        p += 3;
        for (int k = 0; k < 8; ++k)
          buf[k] = lms[ch].decode((word >> (21 - 3 * k)) & 0x7, 3);
      }
      std::memcpy(&out[ch][t], buf, sizeof(int32_t) * take);
    }
  }

  if (info.ch_process_method == 1) {
    for (uint32_t t = 0; t < emit; ++t) {
      const int32_t mid = out[0][t], side = out[1][t];
      out[0][t] = clip16(mid + side);
      out[1][t] = clip16(mid - side);
    }
  }
  return size_t(p - start);
}

void ms_transform(std::vector<int32_t>& a, std::vector<int32_t>& b,
                  uint32_t n) {
  for (uint32_t t = 0; t < n; ++t) {
    const int32_t mid = (a[t] + b[t]) >> 1;
    const int32_t side = (a[t] - b[t]) >> 1;
    a[t] = clip16(mid);
    b[t] = clip16(side);
  }
}

// The block header's in-place weight rounding (the masking that keeps
// encoder and decoder synchronised; reference: src/aad_encoder.c:624-646)
// without serialising the header — used by the Jacobi warm walks, which
// need the state chain but emit no bytes.
inline void round_weights_inplace(Lms& s) {
  int32_t maxabs = 0;
  for (int k = 0; k < kFilterOrder; ++k)
    maxabs = std::max(maxabs, s.w[k] >= 0 ? s.w[k] : -s.w[k]);
  uint32_t shift = 0;
  while (maxabs > 32767) {
    maxabs >>= 1;
    ++shift;
  }
  const int32_t mask = ~((int32_t(1) << shift) - 1);
  for (int k = 0; k < kFilterOrder; ++k) s.w[k] &= mask;
}

// Trial-measure pass: seed from the first 4 samples, encode [4, n), return
// the summed squared quantisation error. State advances in place.
//
// The accumulated term is the WRAPPED int32 product, matching the reference
// exactly: it multiplies two int32 quantize_error fields before the double
// add (reference: src/aad_encoder.c:459-461), so qdiff^2 >= 2^31 enters the
// accumulator as a negative value and the sum itself may go negative.
// (Compiled with -fwrapv, the int32 product wraps defined.) Each wrapped
// term has magnitude < 2^31 and n < 2^22, so the reference's double adds
// are exact and the int64 sum reproduces its accumulator bit-for-bit.
int64_t measure(Lms* s, const int32_t* x, uint32_t n, uint32_t bps) {
  if (n < kFilterOrder) return 0;  // also: no state change
  s->seed(x, n);
  int64_t sse = 0;
  for (uint32_t t = kFilterOrder; t < n; ++t) {
    int32_t q;
    s->encode(x[t], bps, &q);
    sse += int64_t(int32_t(q * q));  // wrapped product, sign-extended
  }
  return sse;
}

// One Jacobi warm walk over a chunk: the trials=0 state chain of
// ops/encode.py::parallel_warm_states (per block: history seed + weight
// rounding + full walk), bytes discarded. Only non-final chunks are ever
// walked, so every block is full-length (the stream's single possibly-
// ragged block lives in the final chunk, whose exit state nobody consumes).
void warm_walk_chunk(const int32_t* pcm, uint32_t num_samples, uint32_t nch,
                     bool ms, uint32_t bps, uint32_t nspb, uint32_t block0,
                     uint32_t nblocks, Lms* state) {
  std::vector<int32_t> cur[kMaxChannels];
  for (uint32_t ch = 0; ch < nch; ++ch) cur[ch].resize(nspb);
  for (uint32_t b = 0; b < nblocks; ++b) {
    const size_t off = size_t(block0 + b) * nspb;
    for (uint32_t ch = 0; ch < nch; ++ch)
      std::memcpy(cur[ch].data(), pcm + size_t(ch) * num_samples + off,
                  sizeof(int32_t) * nspb);
    if (ms) ms_transform(cur[0], cur[1], nspb);
    for (uint32_t ch = 0; ch < nch; ++ch) {
      // rounding depends only on the weights; measure() re-seeds the
      // (identical) history itself before walking
      round_weights_inplace(state[ch]);
      measure(&state[ch], cur[ch].data(), nspb, bps);
    }
  }
}

// Two independent measure chains interleaved per sample step. Each
// channel's op sequence is identical to measure() (byte-exact); putting
// both serial dependent chains inside one loop body keeps them in the
// OoO window together, so the core fills one chain's stalls with the
// other's work — the scalar mirror of the SIMD kernels' group interleave.
void measure2(Lms* s0, const int32_t* x0, Lms* s1, const int32_t* x1,
              uint32_t n, uint32_t bps, int64_t* sse0, int64_t* sse1) {
  if (n < kFilterOrder) {
    *sse0 = *sse1 = 0;
    return;
  }
  s0->seed(x0, n);
  s1->seed(x1, n);
  int64_t a = 0, b = 0;
  for (uint32_t t = kFilterOrder; t < n; ++t) {
    int32_t q0, q1;
    s0->encode(x0[t], bps, &q0);
    s1->encode(x1[t], bps, &q1);
    a += int64_t(int32_t(q0 * q0));
    b += int64_t(int32_t(q1 * q1));
  }
  *sse0 = a;
  *sse1 = b;
}

// Mono probe + first-prev measure fused: the baseline probe (over the
// current block, length n) and the trial walker's first warm-up pass
// (over the previous block, length m) are independent chains — stepping
// them together is the mono counterpart of the stereo measure2
// interleave. Per-chain op order is identical to measure().
void measure_pair(Lms* p, const int32_t* c, uint32_t n, int64_t* psse,
                  Lms* w, const int32_t* v, uint32_t m, uint32_t bps) {
  if (n < kFilterOrder || m < kFilterOrder) {  // measure()'s early-outs
    *psse = measure(p, c, n, bps);
    measure(w, v, m, bps);
    return;
  }
  p->seed(c, n);
  w->seed(v, m);
  int64_t a = 0;
  int32_t qd;
  const uint32_t joint = std::min(n, m);
  uint32_t t = kFilterOrder;
  for (; t < joint; ++t) {
    int32_t q;
    p->encode(c[t], bps, &q);
    w->encode(v[t], bps, &qd);
    a += int64_t(int32_t(q * q));
  }
  for (; t < n; ++t) {
    int32_t q;
    p->encode(c[t], bps, &q);
    a += int64_t(int32_t(q * q));
  }
  for (; t < m; ++t) w->encode(v[t], bps, &qd);
  *psse = a;
}

// ---- AVX-512 block-parallel decode ----------------------------------------
//
// Decode is embarrassingly parallel across blocks: every block header carries
// the complete predictor state (reference: src/aad_decoder.c:301-352 re-seeds
// per block), so (block, channel) pairs are independent lanes — the same lane
// concept as the TPU kernels, mapped onto AVX-512's 16 int32 lanes. Two
// 16-lane groups run interleaved so the per-sample dependent chain of one
// group hides the other's gather/ALU latency. All arithmetic is int32
// wraparound (vpmulld/vpsrad match -fwrapv scalar semantics bit-for-bit).
//
// Per unit, a lane's code bytes are contiguous (the LCM interleave places
// each channel's cb = lcm/8 bytes consecutively within the unit), so one
// u32 gather per lane covers U units' worth of codes:
//   bps=4: cb=1, spu=2, U = nch==1 ? 4 : 2   (8 / 4 samples per gather)
//   bps=2: cb=1, spu=4, U = nch==1 ? 4 : 2   (16 / 8 samples per gather)
//   bps=3: cb=3, spu=8, U = 1                (8 samples per gather)
// The gather may read up to 3 bytes past a lane's last unit; the dispatcher
// keeps 4 bytes of tail slack inside the payload, so no out-of-bounds read.

#if defined(__x86_64__) && defined(__GNUC__)
#define AADX_HAVE_SIMD 1

#pragma GCC push_options
#pragma GCC target("avx512f")

struct LaneState {
  __m512i h[kFilterOrder];
  __m512i w[kFilterOrder];
  __m512i idx;
};

// One decode transition for 16 lanes; mirrors Lms::decode exactly.
template <int BPS>
inline __m512i step16(LaneState& s, __m512i code, const int32_t* steptab,
                      __m512i deltas) {
  const __m512i absmask = _mm512_set1_epi32((1 << (BPS - 1)) - 1);
  const __m512i signbit = _mm512_set1_epi32(1 << (BPS - 1));
  const __m512i halfv = _mm512_set1_epi32(kHalf);
  // clamp: malformed-state slots pin into [0, 255] (see Lms::stepsize).
  const __m512i slot = _mm512_max_epi32(
      _mm512_min_epi32(
          _mm512_srai_epi32(
              _mm512_add_epi32(s.idx, _mm512_set1_epi32(kQ4Half)), kQ4),
          _mm512_set1_epi32(255)),
      _mm512_setzero_si512());
  const __m512i st = _mm512_i32gather_epi32(slot, steptab, 4);
  const __m512i mag = _mm512_and_si512(code, absmask);
  __m512i q = _mm512_srai_epi32(
      _mm512_mullo_epi32(
          st, _mm512_or_si512(_mm512_slli_epi32(mag, 1),
                              _mm512_set1_epi32(1))),
      BPS - 1);
  const __mmask16 neg = _mm512_test_epi32_mask(code, signbit);
  q = _mm512_mask_sub_epi32(q, neg, _mm512_setzero_si512(), q);
  __m512i acc = halfv;
  for (int k = 0; k < kFilterOrder; ++k)
    acc = _mm512_add_epi32(acc, _mm512_mullo_epi32(s.h[k], s.w[k]));
  const __m512i pred = _mm512_srai_epi32(acc, kFixedDigits);
  __m512i samp = _mm512_add_epi32(q, pred);
  samp = _mm512_min_epi32(samp, _mm512_set1_epi32(32767));
  samp = _mm512_max_epi32(samp, _mm512_set1_epi32(-32768));
  // adapt_index (pre-update state, like the scalar order)
  __m512i nidx = _mm512_add_epi32(s.idx, _mm512_permutexvar_epi32(mag, deltas));
  nidx = _mm512_max_epi32(nidx, _mm512_setzero_si512());
  s.idx = _mm512_min_epi32(nidx, _mm512_set1_epi32(kIndexMax));
  for (int k = 0; k < kFilterOrder; ++k)
    s.w[k] = _mm512_add_epi32(
        s.w[k],
        _mm512_srai_epi32(_mm512_add_epi32(_mm512_mullo_epi32(q, s.h[k]), halfv),
                          kFixedDigits + kLmsShift));
  s.h[3] = s.h[2];
  s.h[2] = s.h[1];
  s.h[1] = s.h[0];
  s.h[0] = samp;
  return samp;
}

// 16x16 int32 in-register transpose (4-stage unpack/shuffle network).
// out[l] = column l of the row-major input tile.
inline void transpose16x16(const int32_t* in, __m512i out[16]) {
  __m512i r[16], t[16];
  for (int i = 0; i < 16; ++i) r[i] = _mm512_load_si512(in + 16 * i);
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
    t[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i] = _mm512_unpacklo_epi64(t[4 * i], t[4 * i + 2]);
    r[4 * i + 1] = _mm512_unpackhi_epi64(t[4 * i], t[4 * i + 2]);
    r[4 * i + 2] = _mm512_unpacklo_epi64(t[4 * i + 1], t[4 * i + 3]);
    r[4 * i + 3] = _mm512_unpackhi_epi64(t[4 * i + 1], t[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) {
      t[8 * i + j] = _mm512_shuffle_i32x4(r[8 * i + j], r[8 * i + 4 + j], 0x88);
      t[8 * i + 4 + j] =
          _mm512_shuffle_i32x4(r[8 * i + j], r[8 * i + 4 + j], 0xdd);
    }
  for (int j = 0; j < 8; ++j) {
    out[j] = _mm512_shuffle_i32x4(t[j], t[8 + j], 0x88);
    out[8 + j] = _mm512_shuffle_i32x4(t[j], t[8 + j], 0xdd);
  }
}

// Code extraction from a little-endian-gathered u32 covering U units.
// k is the sample index within the gather; shifts are compile-time-foldable
// once the SPG loop is unrolled (BPS/NCH constexpr).
template <int BPS, int NCH>
inline __m512i extract_code(__m512i gw, int k) {
  if (BPS == 4) {
    const int byte = (k / 2) * NCH;
    const int sh = 8 * byte + ((k & 1) ? 0 : 4);
    return _mm512_and_si512(_mm512_srli_epi32(gw, sh),
                            _mm512_set1_epi32(0xF));
  }
  if (BPS == 2) {
    const int byte = (k / 4) * NCH;
    const int sh = 8 * byte + (6 - 2 * (k & 3));
    return _mm512_and_si512(_mm512_srli_epi32(gw, sh),
                            _mm512_set1_epi32(0x3));
  }
  // BPS == 3: big-endian 24-bit word from the 3 gathered bytes
  const __m512i b0 = _mm512_and_si512(gw, _mm512_set1_epi32(0xFF));
  const __m512i b1 = _mm512_and_si512(gw, _mm512_set1_epi32(0xFF00));
  const __m512i b2 =
      _mm512_and_si512(_mm512_srli_epi32(gw, 16), _mm512_set1_epi32(0xFF));
  const __m512i w24 = _mm512_or_si512(
      _mm512_or_si512(_mm512_slli_epi32(b0, 16), b1), b2);
  return _mm512_and_si512(_mm512_srli_epi32(w24, 21 - 3 * k),
                          _mm512_set1_epi32(0x7));
}

// Decode G interleaved 16-lane groups' worth of full blocks starting at
// block index b0 (byte offset off0 into data). Writes raw per-channel rows
// (MS recombination is a caller-side pass).
template <int BPS, int NCH, int G>
void decode_chunk_simd(const uint8_t* data, size_t off0, uint32_t b0,
                       const Geometry& g, const AadxInfo& info, int32_t* pcm) {
  constexpr int kLanes = 16;
  constexpr int BPG = kLanes / NCH;  // blocks per 16-lane group
  constexpr int cb = (BPS == 3) ? 3 : 1;
  constexpr int U = (BPS == 3) ? 1 : (NCH == 1 ? 4 : 2);
  constexpr int spu = (BPS == 4) ? 2 : (BPS == 2 ? 4 : 8);
  constexpr int SPG = U * spu;
  const uint32_t spb = info.num_samples_per_block;
  const uint32_t n_units = (spb - kFilterOrder) / spu;
  const uint32_t ub = g.unit_bytes;

  alignas(64) int32_t hbuf[G][kFilterOrder][kLanes];
  alignas(64) int32_t wbuf[G][kFilterOrder][kLanes];
  alignas(64) int32_t ibuf[G][kLanes];
  alignas(64) int32_t dbuf[G][kLanes];  // data byte offsets
  uint32_t obase[G][kLanes];            // output byte offsets (scalar)

  for (int grp = 0; grp < G; ++grp) {
    for (int l = 0; l < kLanes; ++l) {
      const uint32_t bi = grp * BPG + uint32_t(l) / NCH;
      const uint32_t ch = uint32_t(l) % NCH;
      const size_t bs = off0 + size_t(bi) * g.block_size;
      const uint8_t* hp = data + bs + ch * (2 + 4 * kFilterOrder);
      const uint32_t tag = rd_u16(hp);
      // parse-clamp malformed wire indices (see decode_block)
      ibuf[grp][l] = std::min(int32_t(tag >> kQ4), kIndexMax);
      const uint32_t shift = tag & 0xF;
      for (int k = 0; k < kFilterOrder; ++k) {
        wbuf[grp][k][l] = int32_t(int16_t(rd_u16(hp + 2 + 4 * k))) << shift;
        hbuf[grp][k][l] = int16_t(rd_u16(hp + 4 + 4 * k));
      }
      const size_t ob = size_t(ch) * info.num_samples +
                        size_t(b0 + bi) * spb;
      for (int t = 0; t < kFilterOrder; ++t)
        pcm[ob + t] = hbuf[grp][kFilterOrder - 1 - t][l];
      dbuf[grp][l] = int32_t(bs + g.header_bytes + ch * cb);
      obase[grp][l] = uint32_t((ob + kFilterOrder) * 4);
    }
  }

  const int32_t* steptab = tables().step;
  alignas(64) int32_t dl[16] = {0};
  {
    const int32_t* d = tables().deltas(BPS);
    for (int i = 0; i < (1 << (BPS - 1)); ++i) dl[i] = d[i];
  }
  const __m512i deltas = _mm512_load_si512(dl);

  LaneState st[G];
  __m512i doff[G];
  for (int grp = 0; grp < G; ++grp) {
    for (int k = 0; k < kFilterOrder; ++k) {
      st[grp].h[k] = _mm512_load_si512(hbuf[grp][k]);
      st[grp].w[k] = _mm512_load_si512(wbuf[grp][k]);
    }
    st[grp].idx = _mm512_load_si512(ibuf[grp]);
    doff[grp] = _mm512_load_si512(dbuf[grp]);
  }

  // Output staging: per-sample vpscatterdd measured ~25% of the decode
  // loop on this chain, so samples buffer 16-deep time-major in L1 and
  // flush through the in-register 16x16 transpose as one contiguous
  // 64-byte store per lane (each lane's output is sequential).
  alignas(64) int32_t tbuf[G][16][kLanes];
  uint8_t* const out8 = reinterpret_cast<uint8_t*>(pcm);
  int tk = 0;
  const auto flush16 = [&](int grp) {
    __m512i cols[16];
    transpose16x16(tbuf[grp][0], cols);
    for (int l = 0; l < kLanes; ++l) {
      _mm512_storeu_si512(out8 + obase[grp][l], cols[l]);
      obase[grp][l] += 64;
    }
  };

  uint32_t u = 0;
  for (; u + U <= n_units; u += U) {
    __m512i gw[G];
    for (int grp = 0; grp < G; ++grp) {
      gw[grp] = _mm512_i32gather_epi32(doff[grp], data, 1);
      doff[grp] = _mm512_add_epi32(doff[grp], _mm512_set1_epi32(U * ub));
    }
    for (int k = 0; k < SPG; ++k) {
      for (int grp = 0; grp < G; ++grp) {
        const __m512i code = extract_code<BPS, NCH>(gw[grp], k);
        const __m512i samp = step16<BPS>(st[grp], code, steptab, deltas);
        _mm512_store_si512(tbuf[grp][tk], samp);
      }
      if (++tk == 16) {
        for (int grp = 0; grp < G; ++grp) flush16(grp);
        tk = 0;
      }
    }
  }
  // tail units one at a time (same gather; only the low unit's codes used)
  for (; u < n_units; ++u) {
    __m512i gw[G];
    for (int grp = 0; grp < G; ++grp) {
      gw[grp] = _mm512_i32gather_epi32(doff[grp], data, 1);
      doff[grp] = _mm512_add_epi32(doff[grp], _mm512_set1_epi32(ub));
    }
    for (int k = 0; k < spu; ++k) {
      for (int grp = 0; grp < G; ++grp) {
        const __m512i code = extract_code<BPS, NCH>(gw[grp], k);
        const __m512i samp = step16<BPS>(st[grp], code, steptab, deltas);
        _mm512_store_si512(tbuf[grp][tk], samp);
      }
      if (++tk == 16) {
        for (int grp = 0; grp < G; ++grp) flush16(grp);
        tk = 0;
      }
    }
  }
  // partial buffer: scalar drain (< 16 samples per lane per chunk)
  for (int grp = 0; grp < G; ++grp)
    for (int l = 0; l < kLanes; ++l) {
      int32_t* dst = reinterpret_cast<int32_t*>(out8 + obase[grp][l]);
      for (int j = 0; j < tk; ++j) dst[j] = tbuf[grp][j][l];
    }
}

// Vectorised mid/side recombination over the first n samples of both rows.
void ms_recombine_simd(int32_t* c0, int32_t* c1, uint32_t n) {
  const __m512i lo = _mm512_set1_epi32(-32768);
  const __m512i hi = _mm512_set1_epi32(32767);
  uint32_t t = 0;
  for (; t + 16 <= n; t += 16) {
    const __m512i mid = _mm512_loadu_si512(c0 + t);
    const __m512i side = _mm512_loadu_si512(c1 + t);
    __m512i l = _mm512_add_epi32(mid, side);
    __m512i r = _mm512_sub_epi32(mid, side);
    l = _mm512_max_epi32(_mm512_min_epi32(l, hi), lo);
    r = _mm512_max_epi32(_mm512_min_epi32(r, hi), lo);
    _mm512_storeu_si512(c0 + t, l);
    _mm512_storeu_si512(c1 + t, r);
  }
  for (; t < n; ++t) {
    const int32_t mid = c0[t], side = c1[t];
    c0[t] = clip16(mid + side);
    c1[t] = clip16(mid - side);
  }
}

// Decode full blocks [0, nblocks) with the widest chunks available; returns
// the number of blocks actually decoded (a multiple of 16/nch).
template <int BPS, int NCH>
uint32_t decode_blocks_simd(const uint8_t* data, uint32_t nblocks,
                            const Geometry& g, const AadxInfo& info,
                            int32_t* pcm, size_t base) {
  constexpr uint32_t BPG = 16 / NCH;
  uint32_t b = 0;
  while (b + 2 * BPG <= nblocks) {
    decode_chunk_simd<BPS, NCH, 2>(
        data, base + size_t(b) * g.block_size, b, g, info, pcm);
    b += 2 * BPG;
  }
  if (b + BPG <= nblocks) {
    decode_chunk_simd<BPS, NCH, 1>(
        data, base + size_t(b) * g.block_size, b, g, info, pcm);
    b += BPG;
  }
  if (info.ch_process_method == 1 && b)
    ms_recombine_simd(pcm, pcm + info.num_samples,
                      b * info.num_samples_per_block);
  return b;
}

#pragma GCC pop_options

// Test/diagnostic knob: AADX_FORCE_SCALAR=1 (any non-"0" value) disables
// the AVX-512 paths, so the scalar engine — the configuration that IS the
// reference's entire codec (reference: src/aad_decoder.c:269-318) — runs as
// the main path on any host. Read per entry call (not cached) so one test
// process can compare both paths; the per-call getenv is noise next to the
// codec work behind each gate.
bool force_scalar() {
  const char* e = std::getenv("AADX_FORCE_SCALAR");
  return e && *e && *e != '0';
}

// Dispatch: how many leading full blocks the SIMD path may decode.
// Requires every gathered u32 to stay inside [data, data+size): each lane's
// last gather reads at most 3 bytes past its block's data section, so the
// final vectorised block needs 4 bytes of slack after it.
uint32_t simd_decode_prefix(const AadxInfo& info, const Geometry& g,
                            size_t size, size_t base) {
  static const bool ok = __builtin_cpu_supports("avx512f");
  if (!ok || force_scalar()) return 0;
  if (size > (size_t(1) << 30)) return 0;  // int32 gather offsets
  if (size_t(info.num_channels) * info.num_samples * 4 > (size_t(1) << 30))
    return 0;  // int32 scatter offsets
  const uint32_t spb = info.num_samples_per_block;
  uint32_t nb = info.num_samples / spb;  // blocks emitting all spb samples
  const size_t avail = size > base ? size - base : 0;
  const uint32_t on_wire = uint32_t(std::min<size_t>(avail / g.block_size,
                                                     0xFFFFFFFFu));
  nb = std::min(nb, on_wire);
  while (nb && base + size_t(nb) * g.block_size + 4 > size) --nb;
  const uint32_t bpg = 16 / info.num_channels;
  return (nb / bpg) * bpg;
}

uint32_t run_simd_decode(const uint8_t* data, size_t size,
                         const AadxInfo& info, const Geometry& g,
                         int32_t* pcm, size_t base) {
  const uint32_t nb = simd_decode_prefix(info, g, size, base);
  if (!nb) return 0;
  switch (info.bits_per_sample * 10 + info.num_channels) {
    case 41: return decode_blocks_simd<4, 1>(data, nb, g, info, pcm, base);
    case 42: return decode_blocks_simd<4, 2>(data, nb, g, info, pcm, base);
    case 31: return decode_blocks_simd<3, 1>(data, nb, g, info, pcm, base);
    case 32: return decode_blocks_simd<3, 2>(data, nb, g, info, pcm, base);
    case 21: return decode_blocks_simd<2, 1>(data, nb, g, info, pcm, base);
    case 22: return decode_blocks_simd<2, 2>(data, nb, g, info, pcm, base);
    default: return 0;
  }
}

// ---- AVX-512 block-parallel encode (parallel_blocks mode) ------------------
//
// The block-independent encode mode makes every block a stream head, so
// (block, channel) lanes are independent for the WHOLE trial search + emit —
// the same lane map as the SIMD decoder. The quantiser uses the binary-search
// formulation instead of idiv (no vector integer division exists); it agrees
// with the reference division for every reachable input — the equivalence the
// Pallas engines already pin (ops/pallas_encode_fused.py, docs/DESIGN.md §3).

#pragma GCC push_options
#pragma GCC target("avx512f")

// One encode transition for 16 lanes; mirrors Lms::encode.
template <int BPS>
inline void enc_step16(LaneState& s, __m512i x, const int32_t* steptab,
                       __m512i deltas, __m512i* code_out, __m512i* qdiff_out) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i halfv = _mm512_set1_epi32(kHalf);
  // clamp: keeps user-supplied carry states (aadx_encode_chunk) in the
  // table even when forged — two-sided, since a forged idx can be
  // negative; in-contract states never reach it (the carry load also
  // clamps).
  const __m512i slot = _mm512_max_epi32(
      _mm512_min_epi32(
          _mm512_srai_epi32(
              _mm512_add_epi32(s.idx, _mm512_set1_epi32(kQ4Half)), kQ4),
          _mm512_set1_epi32(255)),
      _mm512_setzero_si512());
  const __m512i st = _mm512_i32gather_epi32(slot, steptab, 4);
  __m512i acc = halfv;
  for (int k = 0; k < kFilterOrder; ++k)
    acc = _mm512_add_epi32(acc, _mm512_mullo_epi32(s.h[k], s.w[k]));
  const __m512i pred = _mm512_srai_epi32(acc, kFixedDigits);
  const __m512i diff = _mm512_sub_epi32(x, pred);
  const __mmask16 neg = _mm512_cmp_epi32_mask(diff, zero, _MM_CMPINT_LT);
  const __m512i scaled =
      _mm512_slli_epi32(_mm512_abs_epi32(diff), BPS - 2);
  // binary-search quantiser (exactly ops/pallas_encode_fused.py's R>=2 form)
  __m512i mc = _mm512_maskz_set1_epi32(
      _mm512_cmp_epi32_mask(scaled, _mm512_slli_epi32(st, BPS - 2),
                            _MM_CMPINT_NLT),
      1);
  for (int i = BPS - 3; i >= 0; --i) {
    const __m512i th = _mm512_mullo_epi32(
        _mm512_slli_epi32(_mm512_or_si512(_mm512_slli_epi32(mc, 1), one), i),
        st);
    mc = _mm512_add_epi32(
        _mm512_slli_epi32(mc, 1),
        _mm512_maskz_set1_epi32(
            _mm512_cmp_epi32_mask(scaled, th, _MM_CMPINT_NLT), 1));
  }
  const __m512i qmag = _mm512_srai_epi32(
      _mm512_mullo_epi32(st, _mm512_or_si512(_mm512_slli_epi32(mc, 1), one)),
      BPS - 1);
  const __m512i qdiff = _mm512_mask_sub_epi32(qmag, neg, zero, qmag);
  *code_out = _mm512_mask_or_epi32(mc, neg, mc,
                                   _mm512_set1_epi32(1 << (BPS - 1)));
  *qdiff_out = qdiff;
  __m512i nidx = _mm512_add_epi32(s.idx, _mm512_permutexvar_epi32(mc, deltas));
  nidx = _mm512_max_epi32(nidx, zero);
  s.idx = _mm512_min_epi32(nidx, _mm512_set1_epi32(kIndexMax));
  __m512i samp = _mm512_add_epi32(qdiff, pred);
  samp = _mm512_min_epi32(samp, _mm512_set1_epi32(32767));
  samp = _mm512_max_epi32(samp, _mm512_set1_epi32(-32768));
  for (int k = 0; k < kFilterOrder; ++k)
    s.w[k] = _mm512_add_epi32(
        s.w[k],
        _mm512_srai_epi32(
            _mm512_add_epi32(_mm512_mullo_epi32(qdiff, s.h[k]), halfv),
            kFixedDigits + kLmsShift));
  s.h[3] = s.h[2];
  s.h[2] = s.h[1];
  s.h[1] = s.h[0];
  s.h[0] = samp;
}

// history <- int16-cast first 4 samples of the group's tm columns
inline void seed16(LaneState& s, const int32_t* tm, int lanes_total, int g) {
  for (int k = 0; k < kFilterOrder; ++k) {
    const __m512i x =
        _mm512_loadu_si512(tm + size_t(k) * lanes_total + g * 16);
    s.h[kFilterOrder - 1 - k] =
        _mm512_srai_epi32(_mm512_slli_epi32(x, 16), 16);
  }
}

struct SseAcc {
  __m512i lo, hi;  // lanes 0-7 / 8-15 as i64
};

// Measure pass over all G groups, interleaved per sample step so one
// group's gather/ALU latency hides behind the other's dependent chain —
// the decode loop's latency-hiding structure (enc_step16 is a serial
// chain per lane set; G independent chains keep the ports busy).
// ACC=false is the warm-up-only variant (chained chunk blocks discard the
// previous block's SSE): the squared-error side chain drops out entirely,
// leaving just the state walk.
template <int BPS, int G, bool ACC = true>
void measure16g(LaneState* s, const int32_t* tm, int lanes_total,
                uint32_t nspb, const int32_t* steptab, __m512i deltas,
                SseAcc* sse) {
  __m512i acc_lo[G], acc_hi[G];
  for (int g = 0; g < G; ++g) {
    seed16(s[g], tm, lanes_total, g);
    acc_lo[g] = _mm512_setzero_si512();
    acc_hi[g] = _mm512_setzero_si512();
  }
  for (uint32_t t = kFilterOrder; t < nspb; ++t) {
    for (int g = 0; g < G; ++g) {
      const __m512i x =
          _mm512_loadu_si512(tm + size_t(t) * lanes_total + g * 16);
      __m512i code, q;
      enc_step16<BPS>(s[g], x, steptab, deltas, &code, &q);
      if (ACC) {
        const __m512i sq = _mm512_mullo_epi32(q, q);  // wrapped i32 product
        acc_lo[g] = _mm512_add_epi64(
            acc_lo[g], _mm512_cvtepi32_epi64(_mm512_castsi512_si256(sq)));
        acc_hi[g] = _mm512_add_epi64(
            acc_hi[g],
            _mm512_cvtepi32_epi64(_mm512_extracti64x4_epi64(sq, 1)));
      }
    }
  }
  if (ACC)
    for (int g = 0; g < G; ++g) {
      sse[g].lo = acc_lo[g];
      sse[g].hi = acc_hi[g];
    }
}

// The reference's min_rmse > tmp_rmse adoption rule on wrapped sums (both
// non-negative AND candidate strictly smaller — see Lms-side sse_better).
inline __mmask16 sse_better16(const SseAcc& cand, const SseAcc& best) {
  const __m512i zero = _mm512_setzero_si512();
  const __mmask8 lo = _mm512_cmp_epi64_mask(cand.lo, zero, _MM_CMPINT_NLT) &
                      _mm512_cmp_epi64_mask(best.lo, zero, _MM_CMPINT_NLT) &
                      _mm512_cmp_epi64_mask(cand.lo, best.lo, _MM_CMPINT_LT);
  const __mmask8 hi = _mm512_cmp_epi64_mask(cand.hi, zero, _MM_CMPINT_NLT) &
                      _mm512_cmp_epi64_mask(best.hi, zero, _MM_CMPINT_NLT) &
                      _mm512_cmp_epi64_mask(cand.hi, best.hi, _MM_CMPINT_LT);
  return __mmask16(lo) | (__mmask16(hi) << 8);
}

inline void blend_state(LaneState& dst, __mmask16 take, const LaneState& src) {
  for (int k = 0; k < kFilterOrder; ++k) {
    dst.h[k] = _mm512_mask_blend_epi32(take, dst.h[k], src.h[k]);
    dst.w[k] = _mm512_mask_blend_epi32(take, dst.w[k], src.w[k]);
  }
  dst.idx = _mm512_mask_blend_epi32(take, dst.idx, src.idx);
}

inline LaneState zero_state() {
  LaneState s;
  for (int k = 0; k < kFilterOrder; ++k)
    s.h[k] = s.w[k] = _mm512_setzero_si512();
  s.idx = _mm512_setzero_si512();
  return s;
}

// Encode one chunk of G*16/NCH full blocks starting at block b0; writes the
// blocks' wire bytes directly into out (headers + interleaved data units).
// Encode one group of CPG = 16*G/NCH chunks, each chunk c blocks walked
// sequentially per lane (chunk heads start from the zero state; within a
// chunk the full sequential semantics apply, previous-block trial warm-up
// included — the parallel mode's chunk_blocks quality knob, byte-pinned
// to ops/encode.py::encode_blocks_parallel's chunked contract). c=1 is
// the plain block-independent mode.
template <int BPS, int NCH, int G>
void encode_chunk_simd(const int32_t* pcm, uint32_t num_samples, bool ms,
                       uint32_t num_trials, uint32_t c, uint32_t chunk0,
                       const Geometry& g, uint8_t* out,
                       std::vector<int32_t>& tm,
                       std::vector<uint8_t>& tcodes,
                       const Lms* seeds = nullptr) {
  constexpr int kLanes = 16 * G;
  constexpr int CPG = kLanes / NCH;  // chunks per group call
  constexpr int cb = (BPS == 3) ? 3 : 1;
  constexpr int spu = (BPS == 4) ? 2 : (BPS == 2 ? 4 : 8);
  const uint32_t nspb = g.samples_per_block;
  const uint32_t n_units = (nspb - kFilterOrder) / spu;

  // stage time-major [block][t][lane] with the MS transform applied
  for (int ci = 0; ci < CPG; ++ci) {
    const size_t b0 = (size_t(chunk0) + ci) * c;
    for (uint32_t b = 0; b < c; ++b) {
      int32_t* dst = tm.data() + size_t(b) * nspb * kLanes;
      const int32_t* src0 = pcm + (b0 + b) * nspb;
      if (NCH == 2) {
        const int32_t* src1 = src0 + num_samples;
        if (ms) {
          for (uint32_t t = 0; t < nspb; ++t) {
            const int32_t a = src0[t], s = src1[t];
            dst[size_t(t) * kLanes + ci * 2] = clip16((a + s) >> 1);
            dst[size_t(t) * kLanes + ci * 2 + 1] = clip16((a - s) >> 1);
          }
        } else {
          for (uint32_t t = 0; t < nspb; ++t) {
            dst[size_t(t) * kLanes + ci * 2] = src0[t];
            dst[size_t(t) * kLanes + ci * 2 + 1] = src1[t];
          }
        }
      } else {
        for (uint32_t t = 0; t < nspb; ++t)
          dst[size_t(t) * kLanes + ci] = src0[t];
      }
    }
  }

  const int32_t* steptab = tables().step;
  alignas(64) int32_t dl[16] = {0};
  {
    const int32_t* d = tables().deltas(BPS);
    for (int i = 0; i < (1 << (BPS - 1)); ++i) dl[i] = d[i];
  }
  const __m512i deltas = _mm512_load_si512(dl);

  LaneState st[G];
  for (int grp = 0; grp < G; ++grp) st[grp] = zero_state();
  if (seeds) {
    // Jacobi-warmed chunk-head states: lane l of group grp carries chunk
    // chunk0 + (grp*16+l)/NCH, channel (grp*16+l)%NCH
    for (int grp = 0; grp < G; ++grp) {
      alignas(64) int32_t hb[kFilterOrder][16], wb[kFilterOrder][16];
      alignas(64) int32_t ib[16];
      for (int lane = 0; lane < 16; ++lane) {
        const int gl = grp * 16 + lane;
        const Lms& s =
            seeds[(size_t(chunk0) + gl / NCH) * NCH + gl % NCH];
        for (int k = 0; k < kFilterOrder; ++k) {
          hb[k][lane] = s.h[k];
          wb[k][lane] = s.w[k];
        }
        ib[lane] = s.idx;
      }
      for (int k = 0; k < kFilterOrder; ++k) {
        st[grp].h[k] = _mm512_load_si512(hb[k]);
        st[grp].w[k] = _mm512_load_si512(wb[k]);
      }
      st[grp].idx = _mm512_load_si512(ib);
    }
  }

  for (uint32_t b = 0; b < c; ++b) {
    const int32_t* tmb = tm.data() + size_t(b) * nspb * kLanes;

    if (num_trials > 0 && b == 0) {
      // chunk head: the baseline measure doubles as trial 1 (identical
      // seed and input from the fresh state — the fused kernel's
      // pass-count trick; valid only without a previous-block warm-up)
      LaneState best[G], walker[G];
      SseAcc best_sse[G];
      for (int grp = 0; grp < G; ++grp) {
        best[grp] = st[grp];
        walker[grp] = st[grp];
      }
      measure16g<BPS, G>(walker, tmb, kLanes, nspb, steptab, deltas,
                         best_sse);
      for (uint32_t trial = 1; trial < num_trials; ++trial) {
        LaneState candidate[G];
        for (int grp = 0; grp < G; ++grp) candidate[grp] = walker[grp];
        SseAcc sse[G];
        measure16g<BPS, G>(walker, tmb, kLanes, nspb, steptab, deltas, sse);
        for (int grp = 0; grp < G; ++grp) {
          const __mmask16 take = sse_better16(sse[grp], best_sse[grp]);
          blend_state(best[grp], take, candidate[grp]);
          best_sse[grp].lo = _mm512_mask_blend_epi64(__mmask8(take),
                                                     best_sse[grp].lo,
                                                     sse[grp].lo);
          best_sse[grp].hi = _mm512_mask_blend_epi64(__mmask8(take >> 8),
                                                     best_sse[grp].hi,
                                                     sse[grp].hi);
        }
      }
      for (int grp = 0; grp < G; ++grp) st[grp] = best[grp];
    } else if (num_trials > 0) {
      // chained block: full sequential trial structure — baseline probe
      // from the chain state, then trials x (prev warm-up + cur measure)
      const int32_t* tmp = tmb - size_t(nspb) * kLanes;  // previous block
      LaneState best[G], walker[G], probe[G];
      SseAcc best_sse[G];
      for (int grp = 0; grp < G; ++grp) {
        best[grp] = st[grp];
        walker[grp] = st[grp];
        probe[grp] = st[grp];
      }
      measure16g<BPS, G>(probe, tmb, kLanes, nspb, steptab, deltas,
                         best_sse);
      for (uint32_t trial = 0; trial < num_trials; ++trial) {
        measure16g<BPS, G, false>(walker, tmp, kLanes, nspb, steptab,
                                  deltas, nullptr);
        LaneState candidate[G];
        for (int grp = 0; grp < G; ++grp) candidate[grp] = walker[grp];
        SseAcc sse[G];
        measure16g<BPS, G>(walker, tmb, kLanes, nspb, steptab, deltas, sse);
        for (int grp = 0; grp < G; ++grp) {
          const __mmask16 take = sse_better16(sse[grp], best_sse[grp]);
          blend_state(best[grp], take, candidate[grp]);
          best_sse[grp].lo = _mm512_mask_blend_epi64(__mmask8(take),
                                                     best_sse[grp].lo,
                                                     sse[grp].lo);
          best_sse[grp].hi = _mm512_mask_blend_epi64(__mmask8(take >> 8),
                                                     best_sse[grp].hi,
                                                     sse[grp].hi);
        }
      }
      for (int grp = 0; grp < G; ++grp) st[grp] = best[grp];
    }

    // header: seed, round weights, snapshot fields for the scalar writer
    alignas(64) int32_t hh[G][kFilterOrder][16], hw[G][kFilterOrder][16];
    alignas(64) int32_t hidx[G][16], hshift[G][16];
    for (int grp = 0; grp < G; ++grp) {
      LaneState& s = st[grp];
      seed16(s, tmb, kLanes, grp);
      __m512i maxabs = _mm512_setzero_si512();
      for (int k = 0; k < kFilterOrder; ++k)
        maxabs = _mm512_max_epi32(maxabs, _mm512_abs_epi32(s.w[k]));
      __m512i shift = _mm512_setzero_si512();
      const __m512i lim = _mm512_set1_epi32(32767);
      const __m512i one = _mm512_set1_epi32(1);
      for (int it = 0; it < 16; ++it) {
        const __mmask16 over =
            _mm512_cmp_epi32_mask(maxabs, lim, _MM_CMPINT_NLE);
        maxabs = _mm512_mask_srai_epi32(maxabs, over, maxabs, 1);
        shift = _mm512_mask_add_epi32(shift, over, shift, one);
      }
      const __m512i low =
          _mm512_sub_epi32(_mm512_sllv_epi32(one, shift), one);
      const __m512i wmask = _mm512_andnot_si512(low, _mm512_set1_epi32(-1));
      for (int k = 0; k < kFilterOrder; ++k) {
        s.w[k] = _mm512_and_si512(s.w[k], wmask);
        _mm512_store_si512(hh[grp][k], s.h[k]);
        _mm512_store_si512(hw[grp][k], s.w[k]);
      }
      _mm512_store_si512(hidx[grp], s.idx);
      _mm512_store_si512(hshift[grp], shift);
    }

    // emit pass: codes into unit-major [unit][byte-in-unit][lane] planes;
    // sample steps interleave across groups (independent chains, as in
    // the measure pass) before each group's codes pack
    for (uint32_t u = 0; u < n_units; ++u) {
      __m512i codes[G][spu];
      for (int k = 0; k < spu; ++k)
        for (int grp = 0; grp < G; ++grp) {
          const uint32_t t = kFilterOrder + u * spu + k;
          const __m512i x =
              _mm512_loadu_si512(tmb + size_t(t) * kLanes + grp * 16);
          __m512i q;
          enc_step16<BPS>(st[grp], x, steptab, deltas, &codes[grp][k], &q);
        }
      for (int grp = 0; grp < G; ++grp) {
        const __m512i* code = codes[grp];
        uint8_t* tc = tcodes.data() + (size_t(u) * cb) * kLanes + grp * 16;
        if (BPS == 4) {
          const __m512i by =
              _mm512_or_si512(_mm512_slli_epi32(code[0], 4), code[1]);
          _mm_storeu_si128(reinterpret_cast<__m128i*>(tc),
                           _mm512_cvtepi32_epi8(by));
        } else if (BPS == 2) {
          __m512i by = _mm512_slli_epi32(code[0], 6);
          by = _mm512_or_si512(by, _mm512_slli_epi32(code[1], 4));
          by = _mm512_or_si512(by, _mm512_slli_epi32(code[2], 2));
          by = _mm512_or_si512(by, code[3]);
          _mm_storeu_si128(reinterpret_cast<__m128i*>(tc),
                           _mm512_cvtepi32_epi8(by));
        } else {
          __m512i w24 = _mm512_setzero_si512();
          for (int k = 0; k < 8; ++k)
            w24 =
                _mm512_or_si512(w24, _mm512_slli_epi32(code[k], 21 - 3 * k));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(tc),
                           _mm512_cvtepi32_epi8(_mm512_srli_epi32(w24, 16)));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(tc + kLanes),
                           _mm512_cvtepi32_epi8(_mm512_srli_epi32(w24, 8)));
          _mm_storeu_si128(reinterpret_cast<__m128i*>(tc + 2 * kLanes),
                           _mm512_cvtepi32_epi8(w24));
        }
      }
    }

    // scalar assembly: per-block header + channel-interleaved units
    for (int ci = 0; ci < CPG; ++ci) {
      const size_t blk = (size_t(chunk0) + ci) * c + b;
      uint8_t* p = out + kHeaderSize + blk * g.block_size;
      for (int ch = 0; ch < NCH; ++ch) {
        const int l = ci * NCH + ch;
        const int grp = l / 16, ll = l % 16;
        wr_u16(p, uint32_t(hidx[grp][ll] << kQ4) | uint32_t(hshift[grp][ll]));
        p += 2;
        for (int k = 0; k < kFilterOrder; ++k) {
          wr_u16(p, uint16_t(hw[grp][k][ll] >> hshift[grp][ll]));
          p += 2;
          wr_u16(p, uint16_t(hh[grp][k][ll]));
          p += 2;
        }
      }
      for (uint32_t u = 0; u < n_units; ++u) {
        const uint8_t* tc = tcodes.data() + size_t(u) * cb * kLanes;
        for (int ch = 0; ch < NCH; ++ch)
          for (int j = 0; j < cb; ++j)
            *p++ = tc[size_t(j) * kLanes + ci * NCH + ch];
      }
    }
  }
}

template <int BPS, int NCH>
uint32_t encode_blocks_simd(const int32_t* pcm, uint32_t num_samples, bool ms,
                            uint32_t num_trials, uint32_t nchunks, uint32_t c,
                            const Geometry& g, uint8_t* out,
                            const Lms* seeds = nullptr) {
  constexpr int cb = (BPS == 3) ? 3 : 1;
  constexpr uint32_t CPG = 16 / NCH;  // chunks per 16-lane group
  const uint32_t nspb = g.samples_per_block;
  std::vector<int32_t> tm(size_t(nspb) * c * 32);
  std::vector<uint8_t> tcodes(
      (size_t(nspb - kFilterOrder) / ((BPS == 4) ? 2 : (BPS == 2 ? 4 : 8))) *
      cb * 32);
  uint32_t ch = 0;
  while (ch + 2 * CPG <= nchunks) {
    encode_chunk_simd<BPS, NCH, 2>(pcm, num_samples, ms, num_trials, c, ch,
                                   g, out, tm, tcodes, seeds);
    ch += 2 * CPG;
  }
  if (ch + CPG <= nchunks) {
    encode_chunk_simd<BPS, NCH, 1>(pcm, num_samples, ms, num_trials, c, ch,
                                   g, out, tm, tcodes, seeds);
    ch += CPG;
  }
  return ch * c;  // blocks encoded
}

#pragma GCC pop_options

// Dispatch for the block-independent/chunked parallel encode: vectorise the
// leading whole chunks whose samples AND wire bytes are both full.
uint32_t run_simd_encode_parallel(const int32_t* pcm, const AadxInfo& h,
                                  const Geometry& g, uint32_t num_trials,
                                  uint32_t chunk_blocks, uint8_t* out,
                                  size_t capacity,
                                  const Lms* seeds = nullptr) {
  static const bool ok = __builtin_cpu_supports("avx512f");
  if (!ok || force_scalar()) return 0;
  const uint32_t nspb = g.samples_per_block;
  const uint32_t c = chunk_blocks;
  uint32_t nb = h.num_samples / nspb;  // blocks with every sample present
  const uint32_t cpg = 16 / h.num_channels;
  uint32_t nchunks = ((nb / c) / cpg) * cpg;  // whole chunks, group-aligned
  while (nchunks &&
         kHeaderSize + size_t(nchunks) * c * g.block_size > capacity)
    nchunks -= cpg;
  if (!nchunks) return 0;
  const bool ms = h.ch_process_method == 1;
  switch (h.bits_per_sample * 10 + h.num_channels) {
    case 41:
      return encode_blocks_simd<4, 1>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    case 42:
      return encode_blocks_simd<4, 2>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    case 31:
      return encode_blocks_simd<3, 1>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    case 32:
      return encode_blocks_simd<3, 2>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    case 21:
      return encode_blocks_simd<2, 1>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    case 22:
      return encode_blocks_simd<2, 2>(pcm, h.num_samples, ms, num_trials,
                                      nchunks, c, g, out, seeds);
    default:
      return 0;
  }
}

#else
#define AADX_HAVE_SIMD 0
#endif  // x86_64

}  // namespace

// ---- public API -----------------------------------------------------------

extern "C" {

uint32_t aadx_abi_version(void) { return 2; }

int aadx_block_geometry(uint32_t max_block_size, uint32_t num_channels,
                        uint32_t bits_per_sample, uint32_t* block_size,
                        uint32_t* num_samples_per_block) {
  Geometry g;
  const int rc = derive_geometry(max_block_size, num_channels, bits_per_sample, &g);
  if (rc != AADX_OK) return rc;
  if (block_size) *block_size = g.block_size;
  if (num_samples_per_block) *num_samples_per_block = g.samples_per_block;
  return AADX_OK;
}

int aadx_parse_header(const uint8_t* data, size_t size, AadxInfo* info) {
  if (!data || !info) return AADX_INVALID_ARGUMENT;
  if (size < kHeaderSize) return AADX_INSUFFICIENT_DATA;
  if (data[0] != 'A' || data[1] != 'A' || data[2] != 'D' || data[3] != 0)
    return AADX_INVALID_FORMAT;
  info->format_version = rd_u32(data + 4);
  info->codec_version = rd_u32(data + 8);
  info->num_channels = rd_u16(data + 12);
  info->num_samples = rd_u32(data + 14);
  info->sampling_rate = rd_u32(data + 18);
  info->bits_per_sample = rd_u16(data + 22);
  info->block_size = rd_u16(data + 24);
  info->num_samples_per_block = rd_u32(data + 26);
  info->ch_process_method = data[30];
  return AADX_OK;
}

static int check_info(const AadxInfo& h) {
  if (h.format_version != kFormatVersion || h.codec_version != kCodecVersion)
    return AADX_INVALID_FORMAT;
  if (h.num_channels == 0 || h.num_channels > kMaxChannels)
    return AADX_INVALID_FORMAT;
  if (h.num_samples == 0 || h.sampling_rate == 0) return AADX_INVALID_FORMAT;
  if (h.bits_per_sample < 2 || h.bits_per_sample > 4)
    return AADX_INVALID_FORMAT;
  if (h.block_size <= (4 * kFilterOrder + 2) * h.num_channels)
    return AADX_INVALID_FORMAT;
  if (h.num_samples_per_block == 0) return AADX_INVALID_FORMAT;
  if (h.ch_process_method >= 2) return AADX_INVALID_FORMAT;
  if (h.ch_process_method == 1 && h.num_channels == 1)
    return AADX_INVALID_FORMAT;
  return AADX_OK;
}

// Decode info.num_samples per channel from the blocks starting at byte
// `base` of data. Shared by the whole-stream and streaming-chunk entries.
static int decode_stream(const uint8_t* data, size_t size, size_t base,
                         const AadxInfo& info, const Geometry& g,
                         int32_t* pcm) {
  Lms lms[kMaxChannels];
  int32_t* chans[kMaxChannels];
  size_t off = base;
  uint32_t done = 0;
#if AADX_HAVE_SIMD
  // Block-parallel AVX-512 fast path for the leading full blocks; every
  // block re-seeds its state from its header, so the scalar loop resumes
  // cleanly on whatever remainder the vector path leaves.
  {
    const uint32_t nb = run_simd_decode(data, size, info, g, pcm, base);
    off += size_t(nb) * g.block_size;
    done += nb * info.num_samples_per_block;
  }
#endif
  while (done < info.num_samples && off < size) {
    const uint32_t limit = info.num_samples - done;
    const uint32_t emit = std::min(info.num_samples_per_block, limit);
    // Bound the read: a block must carry whole units covering its samples.
    // (The reference reads past truncated buffers — reference:
    // src/aad_decoder.c:394-455 has DEBUG-only bounds asserts; we reject.)
    const uint32_t coded = emit > kFilterOrder ? emit - kFilterOrder : 0;
    const uint32_t need =
        g.header_bytes +
        ((coded + g.samples_per_unit - 1) / g.samples_per_unit) * g.unit_bytes;
    if (size - off < need) return AADX_INSUFFICIENT_DATA;
    for (uint32_t ch = 0; ch < info.num_channels; ++ch)
      chans[ch] = pcm + size_t(ch) * info.num_samples + done;
    decode_block(data + off, info, g, lms, chans, limit);
    // Advance by the on-the-wire block size (the final block is truncated).
    off += std::min<size_t>(info.block_size, size - off);
    done += emit;
  }
  if (done < info.num_samples) return AADX_INSUFFICIENT_DATA;
  return AADX_OK;
}

int aadx_decode(const uint8_t* data, size_t size, int32_t* pcm,
                size_t capacity, AadxInfo* info) {
  if (!data || !pcm || !info) return AADX_INVALID_ARGUMENT;
  int rc = aadx_parse_header(data, size, info);
  if (rc != AADX_OK) return rc;
  rc = check_info(*info);
  if (rc != AADX_OK) return rc;

  Geometry g;
  rc = derive_geometry(info->block_size, info->num_channels,
                       info->bits_per_sample, &g);
  if (rc != AADX_OK || g.block_size != info->block_size)
    return AADX_INVALID_FORMAT;
  if (capacity < size_t(info->num_channels) * info->num_samples)
    return AADX_INSUFFICIENT_BUFFER;
  return decode_stream(data, size, kHeaderSize, *info, g, pcm);
}

int aadx_decode_blocks(const uint8_t* data, size_t size, uint32_t num_samples,
                       int32_t* pcm, size_t capacity, const AadxInfo* cfg) {
  // Streaming-chunk decode: `data` holds whole blocks back to back (no file
  // header; the final block may be padded to block_size), `cfg` carries the
  // stream's header fields, and num_samples per channel are emitted. Block
  // self-containedness makes this exact regardless of chunk boundaries
  // (reference: src/aad_decoder.c:301-352 re-seeds per block).
  if (!data || !pcm || !cfg) return AADX_INVALID_ARGUMENT;
  AadxInfo info = *cfg;
  info.num_samples = num_samples;
  int rc = check_info(info);
  if (rc != AADX_OK) return rc;
  Geometry g;
  rc = derive_geometry(info.block_size, info.num_channels,
                       info.bits_per_sample, &g);
  if (rc != AADX_OK || g.block_size != info.block_size)
    return AADX_INVALID_FORMAT;
  if (capacity < size_t(info.num_channels) * num_samples)
    return AADX_INSUFFICIENT_BUFFER;
  return decode_stream(data, size, 0, info, g, pcm);
}

size_t aadx_encode_bound(uint32_t num_channels, uint32_t num_samples,
                         uint32_t bits_per_sample, uint32_t max_block_size) {
  Geometry g;
  if (derive_geometry(max_block_size, num_channels, bits_per_sample, &g) !=
      AADX_OK)
    return 0;
  const uint32_t data_samples = g.samples_per_block - kFilterOrder;
  const size_t blocks = (num_samples + data_samples - 1) /
                        std::max<uint32_t>(1, g.samples_per_block);
  return kHeaderSize + (blocks + 2) * size_t(g.block_size);
}

// Shared whole-stream encode. `independent_blocks` selects the
// block-parallel mode: every block restarts from the default predictor
// state (a stream head), making the output equal to the concatenation of
// single-block encodes — the byte contract of the JAX engines'
// parallel_blocks=True mode (ops/encode.py::encode_blocks_parallel).
static int encode_impl(const int32_t* pcm, uint32_t num_channels,
                       uint32_t num_samples, uint32_t sampling_rate,
                       uint32_t bits_per_sample, uint32_t max_block_size,
                       uint32_t ch_process_method, uint32_t num_encode_trials,
                       uint8_t* out, size_t capacity, size_t* out_size,
                       bool independent_blocks, uint32_t chunk_blocks = 1,
                       int32_t* state_io = nullptr, int32_t* prev_io = nullptr,
                       uint32_t blocks_before = 0,
                       uint32_t warm_passes = 0) {
  // Chunk (streaming) mode when state_io != nullptr: no file header is
  // written, the predictor chain starts from state_io ((C, 9): h[4], w[4],
  // idx per channel) with prev_io ((C, nspb), channel-transformed domain)
  // as the previous block when blocks_before > 0, and both carries are
  // written back for the next chunk — the native mirror of
  // ops/encode.py::encode_stream_blocks_carry's (CodecState, prev) carry.
  const bool chunk_mode = state_io != nullptr;
  if (!pcm || !out || !out_size) return AADX_INVALID_ARGUMENT;
  if (chunk_mode && (independent_blocks || !prev_io))
    return AADX_INVALID_ARGUMENT;
  if (chunk_blocks == 0 || (!independent_blocks && chunk_blocks != 1))
    return AADX_INVALID_ARGUMENT;
  if (warm_passes > 0 && !independent_blocks) return AADX_INVALID_ARGUMENT;

  Geometry g;
  int rc = derive_geometry(max_block_size, num_channels, bits_per_sample, &g);
  if (rc != AADX_OK) return rc;

  AadxInfo h{};
  h.format_version = kFormatVersion;
  h.codec_version = kCodecVersion;
  h.num_channels = num_channels;
  h.num_samples = num_samples;
  h.sampling_rate = sampling_rate;
  h.bits_per_sample = bits_per_sample;
  h.block_size = g.block_size;
  h.num_samples_per_block = g.samples_per_block;
  h.ch_process_method = ch_process_method;
  rc = check_info(h);
  if (rc != AADX_OK) return rc;

  uint8_t* p = out;
  if (!chunk_mode) {
    if (capacity < kHeaderSize) return AADX_INSUFFICIENT_BUFFER;
    // file header
    p[0] = 'A'; p[1] = 'A'; p[2] = 'D'; p[3] = 0;
    wr_u32(p + 4, kFormatVersion);
    wr_u32(p + 8, kCodecVersion);
    wr_u16(p + 12, num_channels);
    wr_u32(p + 14, num_samples);
    wr_u32(p + 18, sampling_rate);
    wr_u16(p + 22, bits_per_sample);
    wr_u16(p + 24, g.block_size);
    wr_u32(p + 26, g.samples_per_block);
    p[30] = uint8_t(ch_process_method);
    p += kHeaderSize;
  }

  const uint32_t nspb = g.samples_per_block;
  const bool ms = ch_process_method == 1 && num_channels == 2;
  Lms state[kMaxChannels];

  std::vector<int32_t> cur[kMaxChannels], prev[kMaxChannels];
  for (uint32_t ch = 0; ch < num_channels; ++ch) {
    cur[ch].resize(nspb);
    prev[ch].resize(nspb);
  }
  if (chunk_mode) {
    for (uint32_t ch = 0; ch < num_channels; ++ch) {
      const int32_t* s = state_io + size_t(ch) * 9;
      for (int k = 0; k < kFilterOrder; ++k) state[ch].h[k] = s[k];
      for (int k = 0; k < kFilterOrder; ++k)
        state[ch].w[k] = s[kFilterOrder + k];
      // Clamp like the decode header parse: a forged carry state with a
      // negative or >kIndexMax idx must stay inside the step table (the
      // per-step slot mins below are one-sided backstops only).
      state[ch].idx =
          std::max(0, std::min(s[2 * kFilterOrder], kIndexMax));
      if (blocks_before > 0)
        std::memcpy(prev[ch].data(), prev_io + size_t(ch) * nspb,
                    sizeof(int32_t) * nspb);
    }
  }

  // Jacobi warm passes (the native mirror of ops/encode.py::
  // encode_blocks_parallel's warm_passes knob): each pass walks every
  // non-final chunk trials=0 from its seed, then hands chunk g's exit
  // state to chunk g+1 as its next-pass seed (chunk 0 re-seeds from
  // zeros). The final encode consumes the last pass's seeds at every
  // chunk head — SIMD lanes and the scalar tail alike.
  std::vector<Lms> warm_seeds;
  if (independent_blocks && warm_passes > 0 && num_samples > 0) {
    const uint32_t B = (num_samples + nspb - 1) / nspb;
    const uint32_t G = (B + chunk_blocks - 1) / chunk_blocks;
    if (G > 1) {
      warm_seeds.assign(size_t(G) * num_channels, Lms{});
      std::vector<Lms> finals(size_t(G - 1) * num_channels);
      for (uint32_t pass = 0; pass < warm_passes; ++pass) {
        for (uint32_t gc = 0; gc + 1 < G; ++gc) {
          Lms st[kMaxChannels];
          for (uint32_t ch = 0; ch < num_channels; ++ch)
            st[ch] = warm_seeds[size_t(gc) * num_channels + ch];
          warm_walk_chunk(pcm, num_samples, num_channels, ms,
                          bits_per_sample, nspb, gc * chunk_blocks,
                          chunk_blocks, st);
          for (uint32_t ch = 0; ch < num_channels; ++ch)
            finals[size_t(gc) * num_channels + ch] = st[ch];
        }
        for (uint32_t ch = 0; ch < num_channels; ++ch)
          warm_seeds[ch] = Lms{};
        for (uint32_t gc = 1; gc < G; ++gc)
          for (uint32_t ch = 0; ch < num_channels; ++ch)
            warm_seeds[size_t(gc) * num_channels + ch] =
                finals[size_t(gc - 1) * num_channels + ch];
      }
    }
  }
  const Lms* seeds = warm_seeds.empty() ? nullptr : warm_seeds.data();

  uint32_t done0 = 0;
#if AADX_HAVE_SIMD
  if (independent_blocks) {
    const uint32_t nbv = run_simd_encode_parallel(
        pcm, h, g, num_encode_trials, chunk_blocks, out, capacity, seeds);
    done0 = nbv * nspb;  // nbv is chunk-aligned, so the scalar loop
    p += size_t(nbv) * g.block_size;  // resumes at a chunk head
  }
#endif
  for (uint32_t done = done0; done < num_samples; done += nspb) {
    const uint32_t n = std::min(nspb, num_samples - done);
    const bool chunk_head =
        independent_blocks && ((done / nspb) % chunk_blocks == 0);
    if (chunk_head)
      for (uint32_t ch = 0; ch < num_channels; ++ch)
        state[ch] =
            seeds ? seeds[size_t(done / nspb / chunk_blocks) * num_channels +
                          ch]
                  : Lms{};

    // current block, zero-padded, channel-transformed
    for (uint32_t ch = 0; ch < num_channels; ++ch) {
      std::fill(cur[ch].begin(), cur[ch].end(), 0);
      std::memcpy(cur[ch].data(), pcm + size_t(ch) * num_samples + done,
                  sizeof(int32_t) * n);
    }
    if (ms) ms_transform(cur[0], cur[1], n);

    if (num_encode_trials > 0) {
      // prev holds the previous block in the transformed domain: carried
      // in (streaming chunk mode) for the first block, swapped from cur
      // thereafter. In chunked-parallel mode every non-head block of a
      // chunk warms on its predecessor, exactly as the sequential encoder
      // would within that chunk.
      const bool has_prev =
          independent_blocks
              ? !chunk_head && done > done0
              : (done > done0 || (chunk_mode && blocks_before > 0));
      if (num_channels == 2) {
        // stereo: both channels' chains step together (see measure2)
        Lms best[2] = {state[0], state[1]};
        Lms probe[2] = {state[0], state[1]};
        int64_t best_sse[2];
        measure2(&probe[0], cur[0].data(), &probe[1], cur[1].data(), n,
                 bits_per_sample, &best_sse[0], &best_sse[1]);
        Lms walker[2] = {state[0], state[1]};
        for (uint32_t trial = 0; trial < num_encode_trials; ++trial) {
          if (has_prev) {
            int64_t d0, d1;
            measure2(&walker[0], prev[0].data(), &walker[1], prev[1].data(),
                     nspb, bits_per_sample, &d0, &d1);
          }
          const Lms cand0 = walker[0], cand1 = walker[1];
          int64_t sse[2];
          measure2(&walker[0], cur[0].data(), &walker[1], cur[1].data(), n,
                   bits_per_sample, &sse[0], &sse[1]);
          // The reference compares sqrt(sse/n) doubles: a negative sum is
          // sqrt(NaN) and every NaN comparison is false, so adoption needs
          // both sums non-negative and the candidate strictly smaller.
          if (sse[0] >= 0 && best_sse[0] >= 0 && sse[0] < best_sse[0]) {
            best_sse[0] = sse[0];
            best[0] = cand0;
          }
          if (sse[1] >= 0 && best_sse[1] >= 0 && sse[1] < best_sse[1]) {
            best_sse[1] = sse[1];
            best[1] = cand1;
          }
        }
        state[0] = best[0];
        state[1] = best[1];
      } else {
        Lms best = state[0];
        Lms probe = state[0];
        Lms walker = state[0];
        int64_t best_sse;
        if (has_prev) {
          // fuse the probe with the walker's first prev pass (measure_pair)
          measure_pair(&probe, cur[0].data(), n, &best_sse, &walker,
                       prev[0].data(), nspb, bits_per_sample);
        } else {
          best_sse = measure(&probe, cur[0].data(), n, bits_per_sample);
        }
        for (uint32_t trial = 0; trial < num_encode_trials; ++trial) {
          if (has_prev && trial > 0)
            measure(&walker, prev[0].data(), nspb, bits_per_sample);
          const Lms candidate = walker;
          const int64_t sse =
              measure(&walker, cur[0].data(), n, bits_per_sample);
          if (sse >= 0 && best_sse >= 0 && sse < best_sse) {
            best_sse = sse;
            best = candidate;
          }
        }
        state[0] = best;
      }
    }

    // block header: seed history, round weights, serialise state
    for (uint32_t ch = 0; ch < num_channels; ++ch) {
      state[ch].seed(cur[ch].data(), n);
      int32_t maxabs = 0;
      for (int k = 0; k < kFilterOrder; ++k) {
        const int32_t a =
            state[ch].w[k] >= 0 ? state[ch].w[k] : -state[ch].w[k];
        maxabs = std::max(maxabs, a);
      }
      uint32_t shift = 0;
      while (maxabs > 32767) {
        maxabs >>= 1;
        ++shift;
      }
      const int32_t mask = ~((1 << shift) - 1);
      for (int k = 0; k < kFilterOrder; ++k) state[ch].w[k] &= mask;

      if (size_t(p - out) + g.header_bytes > capacity)
        return AADX_INSUFFICIENT_BUFFER;
      wr_u16(p, uint32_t(state[ch].idx << kQ4) | shift);
      p += 2;
      for (int k = 0; k < kFilterOrder; ++k) {
        wr_u16(p, uint16_t(state[ch].w[k] >> shift));
        p += 2;
        wr_u16(p, uint16_t(state[ch].h[k]));
        p += 2;
      }
    }

    // data section: whole interleave units covering [4, n)
    int32_t q;
    for (uint32_t t = kFilterOrder; t < n; t += g.samples_per_unit) {
      if (size_t(p - out) + g.unit_bytes > capacity)
        return AADX_INSUFFICIENT_BUFFER;
      for (uint32_t ch = 0; ch < num_channels; ++ch) {
        if (bits_per_sample == 4) {
          const uint32_t c0 = state[ch].encode(cur[ch][t], 4, &q);
          const uint32_t c1 = state[ch].encode(cur[ch][t + 1], 4, &q);
          *p++ = uint8_t((c0 << 4) | c1);
        } else if (bits_per_sample == 2) {
          uint32_t b = 0;
          for (int k = 0; k < 4; ++k)
            b |= state[ch].encode(cur[ch][t + k], 2, &q) << (6 - 2 * k);
          *p++ = uint8_t(b);
        } else {
          uint32_t word = 0;
          for (int k = 0; k < 8; ++k)
            word |= state[ch].encode(cur[ch][t + k], 3, &q) << (21 - 3 * k);
          p[0] = uint8_t(word >> 16);
          p[1] = uint8_t(word >> 8);
          p[2] = uint8_t(word);
          p += 3;
        }
      }
    }

    // this block becomes the next one's warm-up context (content identical
    // to the re-copy + re-transform it replaces, one transform cheaper);
    // chunked-parallel non-head blocks consume it too
    for (uint32_t ch = 0; ch < num_channels; ++ch)
      std::swap(cur[ch], prev[ch]);
  }

  if (chunk_mode) {
    for (uint32_t ch = 0; ch < num_channels; ++ch) {
      int32_t* s = state_io + size_t(ch) * 9;
      for (int k = 0; k < kFilterOrder; ++k) s[k] = state[ch].h[k];
      for (int k = 0; k < kFilterOrder; ++k)
        s[kFilterOrder + k] = state[ch].w[k];
      s[2 * kFilterOrder] = state[ch].idx;
      std::memcpy(prev_io + size_t(ch) * nspb, prev[ch].data(),
                  sizeof(int32_t) * nspb);
    }
  }

  *out_size = size_t(p - out);
  return AADX_OK;
}

int aadx_encode(const int32_t* pcm, uint32_t num_channels,
                uint32_t num_samples, uint32_t sampling_rate,
                uint32_t bits_per_sample, uint32_t max_block_size,
                uint32_t ch_process_method, uint32_t num_encode_trials,
                uint8_t* out, size_t capacity, size_t* out_size) {
  return encode_impl(pcm, num_channels, num_samples, sampling_rate,
                     bits_per_sample, max_block_size, ch_process_method,
                     num_encode_trials, out, capacity, out_size, false);
}

int aadx_encode_parallel(const int32_t* pcm, uint32_t num_channels,
                         uint32_t num_samples, uint32_t sampling_rate,
                         uint32_t bits_per_sample, uint32_t max_block_size,
                         uint32_t ch_process_method,
                         uint32_t num_encode_trials, uint32_t chunk_blocks,
                         uint32_t warm_passes, uint8_t* out, size_t capacity,
                         size_t* out_size) {
  return encode_impl(pcm, num_channels, num_samples, sampling_rate,
                     bits_per_sample, max_block_size, ch_process_method,
                     num_encode_trials, out, capacity, out_size, true,
                     chunk_blocks, nullptr, nullptr, 0, warm_passes);
}

int aadx_encode_chunk(const int32_t* pcm, uint32_t num_channels,
                      uint32_t num_samples, uint32_t sampling_rate,
                      uint32_t bits_per_sample, uint32_t max_block_size,
                      uint32_t ch_process_method, uint32_t num_encode_trials,
                      uint32_t blocks_before, int32_t* state_io,
                      int32_t* prev_io, uint8_t* out, size_t capacity,
                      size_t* out_size) {
  if (!state_io || !prev_io) return AADX_INVALID_ARGUMENT;
  return encode_impl(pcm, num_channels, num_samples, sampling_rate,
                     bits_per_sample, max_block_size, ch_process_method,
                     num_encode_trials, out, capacity, out_size, false, 1,
                     state_io, prev_io, blocks_before);
}

}  // extern "C"
