// Hand-written Hopper (sm_90a) encode kernels for aad_tpu_torch.
//
// aad_encode_stream replaces the fused Pallas TPU encode kernel
// aad_tpu/ops/pallas_encode_fused.py::_make_kernel (launched by _fused_impl).
// Per lane, for every block of the stream in order: the trial search
// (baseline measure; per trial a warm-up on the previous block from the
// stream's second block on, then a measure on the current block; the last
// strict improvement of the wrapped-square error sum wins), the history seed,
// the weight rounding, the 10 header fields and the codes of the whole
// padded block (reference encoder: src/aad_encoder.c:343-467, 470-562,
// 588-655). Like the TPU kernel, which packs 8 codes into a word in its body
// (pallas_encode_fused.py:760-770), it writes the codes packed as the wire
// holds them (codec.cuh::CodeUnit): each block's data region, the channels of
// a row (the last lane axis) interleaved unit by unit, so nothing packs them
// after the launch; or one code a byte, time-major, for the codes-level API
// (ops/encode.py's functions and the sharded encodes). With warm_on_prev == 0 (the block-parallel mode, every block a
// stream head) trial 1's measure is the baseline's, so its end state is
// reused and trials=N costs N measure passes plus the emit. Optionally it
// writes every block's final state (the warm passes' source).
//
// aad_encode_pass replaces the per-pass Pallas TPU kernel
// aad_tpu/ops/pallas_encode.py::_make_kernel (launched by
// _encode_scan_tiles_impl): one measure or emit pass over one block per
// lane, the state and error frozen past each lane's valid count. It returns
// the final state, the int64 error sum and, in the emit variant, the codes.
//
// What bounds them on an H100. A lane is one dependent chain: each sample's
// step needs the state the step before left (history, weights, step index),
// and lanes are independent. A lane reads 2 bytes and writes at most 1 per
// sample and pass (half a byte packed, at 4 bits), so bytes never bound. At the block-parallel shape (58,066
// lanes, 14 warps an SM) the lanes fill the schedulers and integer issue
// bounds. At the sequential shape (a lane a channel: 2 lanes, one warp on
// one SM) nothing runs beside a lane's chain, and its latency bounds: the
// loop-carried path of one step times the steps that depend on each other.
//
// Both kernels take one step, encode_step, with a short loop-carried path:
// the multiples of the step that the quotient search compares with are
// formed by adds as soon as the step is known, so a bit of the quotient
// costs a compare and a select; the index delta is selected from registers
// by those bits (the index table's top half mirrors its bottom half,
// tables.py, so the sign of a code does not change its delta); the next
// step's size is read from the table in shared memory as soon as the next
// index is known; the prediction is a balanced sum. Each launch of
// aad_encode_stream takes one of two schedules (chosen in its entry point):
//
// * The serial schedule, where the trial search does not warm on the
//   previous block (the block-parallel mode, and trials 0) or a block is
//   too long for a paired CTA: one thread per lane with the
//   whole state in registers, the block sequence and the trial search's
//   passes a loop inside the thread, samples read int16 and time-major (a
//   warp's 32 lanes read 64 consecutive bytes per step), the step-size table
//   staged per CTA in shared memory, 64 threads per CTA. Codes one a byte
//   are written time-major (a warp's 32 lanes store 32 consecutive bytes a
//   step). Packed, a lane's codes go to its own row (at the parallel shape,
//   rows of 32 lanes lie 988 bytes apart, or a block apart), and a store of
//   each unit straight to its row would send every warp store to 16-32
//   rows; so the emit stages them: each lane packs its codes into its row
//   of the warp's tile in shared memory, and after every kTileCodes steps
//   the warp writes the tile's rows out, 32 consecutive bytes a store
//   (StagedRows).
//
// * The paired schedule, for launches whose trial search warms on the
//   previous block (the sequential path, StreamingEncoder, the chunked
//   parallel mode): the semantics of aad_tpu's
//   pass_stack (pallas_encode_fused.py:421-439). Only warm_1 -> measure_1 ->
//   ... -> warm_N -> measure_N depend on each other; the baseline measure
//   and the emits from the baseline and from every candidate can run beside
//   them. Two threads of a warp take each lane: the chain thread runs those
//   2N passes, the side thread the others, slot by slot:
//
//     slot      chain thread       side thread
//     0         warm_1             baseline measure
//     2i - 1    measure_i          emit[baseline] (i = 1), emit[cand_N] (i = N > 1)
//     2i        warm_(i+1)         emit[cand_i], only if adopted (better_i known)
//
//   so a block takes 2N passes of latency in place of 2N + 2 (trials 1: 3
//   slots, emit[cand_1] alone in the last). Both threads issue one
//   instruction stream, so the pair costs one chain's issue slots; the step
//   has no data-dependent branch, so the two never diverge. An emit writes
//   its codes, its header fields and its end state only if its candidate
//   was adopted, in order, so the last strict improvement wins;
//   emit[cand_N] runs before better_N is known, into shared memory, and is
//   copied out once it is. Codes one a byte go time-major, the adopted
//   emits' straight to device memory (a warp's lanes store consecutive
//   bytes), the speculative one's through shared memory. Packed, both the
//   adopted emits' and the speculative one's copy of a CTA's rows of the
//   block's data regions lie in shared memory (a unit stored straight to
//   each lane's row sent every warp store to 8-16 rows and took the chunked
//   parallel mode's 14,518 lanes from 2.9 to 4.2 ms a launch), the second
//   copied over the first if adopted, and after the block the CTA writes
//   its rows out, consecutive bytes. The partners exchange candidate
//   states, error sums and the next block's state by warp shuffles. CTAs of
//   kPairLanes lanes (one warp) or fewer, whole rows of C lanes, so that the
//   codes in shared memory fit 48 KB; a block longer than that takes the
//   serial schedule. The pair
//   wins at every lane count measured, 2 to 58,066 (PERF.md), so no lane
//   count gates it.
//
//   A narrow launch (at most kStageMaxLanes lanes) stages its samples: at
//   the start of each block the lane's two threads copy its column of the
//   block into a tile of the CTA in shared memory, beside the previous
//   block's, and every pass reads the tiles (11% faster at 2 lanes; the
//   step loop issues 248 instructions for 4 samples, not 260). The tiles
//   take 4 nspb bytes a lane, so such CTAs hold fewer lanes (8 at
//   992-sample blocks) and fewer of them fit an SM: past a few thousand
//   lanes they no longer fit one wave, and a wider launch reads its
//   samples from device memory (the lane sweep sets kStageMaxLanes).
//
// The step is exact: scaled is at most 98,303 << 2 (an int16 sample minus
// a prediction in [-65536, 65535]) and never negative, and the step is at
// least 1, so the search equals C's truncating division for every input the
// kernels can be given. A forged carry's index reads the clamped slot (0 or
// 255) at its first step; from then on the index is in [0, 4080] and its
// slot needs no clamp.
//
// Not carried over from the TPU kernels: the u32 sample-pair and code words
// (the codes are packed in bytes, as on the wire), the (8, 128) lane tiles and the R-fold lane interleave, pass_stack's
// sublane stacking (its schedule is the paired one above), the VMEM
// chunked-DMA variant, the f32 step-size formula with its correction set,
// and the two-limb error sum (int64 here).
//
// The wire mode (aad_encode_stream_wire, StreamingEncoder's one launch a
// push; struct Wire): kernel 3 takes a stream's samples as uploaded, (C, n)
// channel-major int16, pads each lane's blocks with zeros past n, takes each
// block's valid count from n, combines mid/side, and writes each block as
// the wire holds it: the header bytes, then the packed data region. It also
// leaves the last block's samples and header state where kernel 4 and the
// next launch read them, so nothing is relaid between launches. It is a
// template parameter of both schedules; the other instances compile as
// before.
//
// The bank mode (aad_encode_stream_bank, StreamingEncoderBank's one launch a
// tick; struct Bank): the wire mode over the feeds of one tick of a bank of
// S slots. A feed is a row of C lanes with its own samples (a count and an
// offset in the tick's upload), its own carry or none (its slot's state and
// last block in the bank's buffers, read by slot index), its own block count
// and its own output rows; a CTA runs to the most blocks of the launch, and
// a lane past its feed's blocks passes empty and writes nothing. Each CTA
// first stages its feeds' samples, a carried feed's previous block from the
// bank and then its blocks, and writes each feed's last block back to its
// slot. The tick's output is its feeds' payloads end to end: each feed's
// blocks from its first byte on, its last block cut to the units that hold
// its valid samples, as the wire holds a stream's end. Kernel 4's bank
// instance (bank_encode_pass_kernel) then rebuilds every feed's end state
// into its slot. Only the paired schedule has a bank instance; the other
// instances compile as before.
//
// The entry points have a plain C interface (bound with ctypes), launch on
// the stream they are given, allocate nothing and return the cudaError_t of
// the launch.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "codec.cuh"
#include "cseman.cuh"

namespace aad {

constexpr int kEncodeThreads = 64;
constexpr int kHeaderFields = 10;  // history[4], rounded weight[4], step index, shift
constexpr int kStateFields = 9;    // history[4], weight[4], step index
constexpr int kPairLanes = 16;       // lanes (2 threads each) a CTA of the paired schedule: one warp
constexpr int kPairedBytes = 46 * 1024;  // dynamic shared memory a paired CTA: with the step sizes, under 48 KB
constexpr int kStageMaxLanes = 4096;     // the widest launch whose paired CTAs stage their samples (lane sweep)
constexpr int kTileCodes = 64;           // codes of a lane the serial schedule stages before a warp writes them out

struct State {
  int32_t h0, h1, h2, h3;  // history, newest first
  int32_t w0, w1, w2, w3;  // Q15 weights
  int32_t idx;             // Q4 step index
};

// The tables a step reads: the step sizes staged in shared memory, and the
// index deltas by magnitude in registers.
template <int BPS>
struct Tables {
  static constexpr int kMags = 1 << (BPS - 1);
  const int32_t* step;
  int32_t mag_delta[kMags];
};

// Stage the step sizes in shared memory, all threads of the CTA taking part.
template <int BPS>
__device__ __forceinline__ Tables<BPS> stage_tables(int32_t* s_step, const int32_t* __restrict__ step_table,
                                                    const int32_t* __restrict__ index_table) {
  stage_table(s_step, step_table, kStepTableSize);
  __syncthreads();
  Tables<BPS> tb;
  tb.step = s_step;
#pragma unroll
  for (int m = 0; m < Tables<BPS>::kMags; ++m) tb.mag_delta[m] = index_table[m];
  return tb;
}

__device__ __forceinline__ State load_state(const int32_t* __restrict__ step_index,
                                            const int32_t* __restrict__ history,
                                            const int32_t* __restrict__ weight, int64_t lane) {
  State s;
  s.h0 = history[4 * lane + 0];
  s.h1 = history[4 * lane + 1];
  s.h2 = history[4 * lane + 2];
  s.h3 = history[4 * lane + 3];
  s.w0 = weight[4 * lane + 0];
  s.w1 = weight[4 * lane + 1];
  s.w2 = weight[4 * lane + 2];
  s.w3 = weight[4 * lane + 3];
  s.idx = step_index[lane];
  return s;
}

// Write the 9 state fields (history, weight, step index) at stride `stride`.
__device__ __forceinline__ void store_fields(int32_t* out, int64_t stride, const State& s) {
  out[0 * stride] = s.h0;
  out[1 * stride] = s.h1;
  out[2 * stride] = s.h2;
  out[3 * stride] = s.h3;
  out[4 * stride] = s.w0;
  out[5 * stride] = s.w1;
  out[6 * stride] = s.w2;
  out[7 * stride] = s.w3;
  out[8 * stride] = s.idx;
}

// history <- the block's first four samples, newest first: history[k] is
// sample 3 - k (reference: src/aad_encoder.c:606-616).
__device__ __forceinline__ State seed(State s, const int16_t* __restrict__ x, int64_t stride) {
  s.h3 = x[0];
  s.h2 = x[stride];
  s.h1 = x[2 * stride];
  s.h0 = x[3 * stride];
  return s;
}

// One encode step (reference: src/aad_encoder.c:343-410): returns the code,
// leaves the quantised difference in qdiff, and advances `step`, the size of
// s.idx's slot, with the index. The quotient's bits are found highest first,
// each by one comparison with a multiple of the step chosen by the bits
// above it; the multiples are formed by adds as soon as the step is known
// (adds: the compiler then selects them, where products led it to branch);
// the last bit chooses the quantised difference between two signed
// candidates; the index delta is selected from registers by the same bits;
// the next step size is read as soon as the next index is known; the
// prediction is a sum of two halves.
template <int BPS>
__device__ __forceinline__ int32_t encode_step(State& s, int32_t& step, int32_t sample, const Tables<BPS>& tb,
                                               int32_t& qdiff) {
  const int32_t* d = tb.mag_delta;
  const int32_t low = wadd(wmul(s.h0, s.w0), wmul(s.h1, s.w1));
  const int32_t high = wadd(wmul(s.h2, s.w2), wadd(wmul(s.h3, s.w3), kFixedHalf));
  const int32_t pred = asr(wadd(low, high), kFixedDigits);

  const int32_t diff = wsub(sample, pred);
  const bool neg = diff < 0;
  const int32_t scaled = wshl(neg ? wneg(diff) : diff, BPS - 2);
  // mag = min(scaled / step, 2**(BPS-1) - 1), bit by bit; last = (mag | 1) *
  // step, the last multiple compared, so that step * (2 mag + 1) is
  // 2 last + step if bit 0 is set and 2 last - step if not (multiples are at
  // most 7 * 32767: no overflow)
  int32_t last, mag, delta;
  bool b0;
  if constexpr (BPS == 2) {
    last = step;
    b0 = scaled >= last;
    mag = b0;
    delta = b0 ? d[1] : d[0];
  } else if constexpr (BPS == 3) {
    const int32_t s2 = step + step;
    const int32_t s3 = s2 + step;
    const bool b1 = scaled >= s2;
    last = b1 ? s3 : step;
    b0 = scaled >= last;
    mag = (b1 ? 2 : 0) | (b0 ? 1 : 0);
    delta = b0 ? (b1 ? d[3] : d[1]) : (b1 ? d[2] : d[0]);
  } else {
    const int32_t s2 = step + step, s4 = s2 + s2;
    const int32_t s3 = s2 + step, s5 = s4 + step, s6 = s4 + s2, s7 = s6 + step;
    const bool b2 = scaled >= s4;
    const bool b1 = scaled >= (b2 ? s6 : s2);
    last = b1 ? (b2 ? s7 : s3) : (b2 ? s5 : step);
    b0 = scaled >= last;
    mag = (b2 ? 4 : 0) | (b1 ? 2 : 0) | (b0 ? 1 : 0);
    const int32_t even = b2 ? (b1 ? d[6] : d[4]) : (b1 ? d[2] : d[0]);
    const int32_t odd = b2 ? (b1 ? d[7] : d[5]) : (b1 ? d[3] : d[1]);
    delta = b0 ? odd : even;
  }
  int32_t q_odd = asr(2 * last + step, BPS - 1), q_even = asr(2 * last - step, BPS - 1);
  q_odd = neg ? -q_odd : q_odd;
  q_even = neg ? -q_even : q_even;
  qdiff = b0 ? q_odd : q_even;
  const int32_t code = neg ? (mag | (1 << (BPS - 1))) : mag;

  s.idx = clip(wadd(s.idx, delta), 0, kStepIndexMax);
  step = tb.step[(s.idx + kTablesHalf) >> kTablesDigits];  // s.idx is in [0, 4080] now: no clamp
  const int32_t out = clip16(wadd(qdiff, pred));
  s.w0 = wadd(s.w0, asr(wadd(wmul(qdiff, s.h0), kFixedHalf), kWeightShift));
  s.w1 = wadd(s.w1, asr(wadd(wmul(qdiff, s.h1), kFixedHalf), kWeightShift));
  s.w2 = wadd(s.w2, asr(wadd(wmul(qdiff, s.h2), kFixedHalf), kWeightShift));
  s.w3 = wadd(s.w3, asr(wadd(wmul(qdiff, s.h3), kFixedHalf), kWeightShift));
  s.h3 = s.h2;
  s.h2 = s.h1;
  s.h1 = s.h0;
  s.h0 = out;
  return code;
}

// The step size of a state's first step. The slot is clamped to the table,
// as in every aad_tpu engine, so a forged carry index outside [0, 4080] reads
// slot 0 or 255; the adaptation brings the index back into [0, 4080].
__device__ __forceinline__ int32_t first_step(const int32_t* s_step, int32_t idx) {
  return s_step[clip(asr(wadd(idx, kTablesHalf), kTablesDigits), 0, kStepTableSize - 1)];
}

// Where a pass's codes go: put(t, code) takes the code of slot t.

// A measure keeps none.
struct NoCodes {
  static constexpr bool kKeeps = false;
  __device__ __forceinline__ void put(int, int32_t) {}
};

// One code a byte at codes[t * stride] (aad_encode_pass).
struct ByteCodes {
  static constexpr bool kKeeps = true;
  uint8_t* codes;
  int64_t stride;
  __device__ __forceinline__ void put(int t, int32_t code) { codes[t * stride] = static_cast<uint8_t>(code); }
};

// Codes in units (codec.cuh::CodeUnit) from slot 0 on: unit u's byte i at
// p[u * unit_stride + i * byte_stride]. A unit is written when its last
// code is put; a pass over a block's whole data region puts every code of
// every unit. Packed units advance a pointer, codes one a byte take their
// address from the slot: each the faster of the two for it in the paired
// schedule at 14,518 lanes (H100, in turns: packed 3.42-3.45 ms a launch
// against 3.89; one a byte 2.80-2.82 against 3.19-3.20).
template <class Unit>
struct UnitCodes {
  static constexpr bool kKeeps = true;
  uint8_t* p;  // packed: the next unit's first byte; one a byte: slot 0's
  int64_t unit_stride;
  int64_t byte_stride;
  uint32_t word;  // the codes put so far, the latest lowest

  __device__ __forceinline__ void put(int t, int32_t code) {
    word = (word << Unit::kBits) | static_cast<uint32_t>(code);
    if constexpr (Unit::kCodes == 1) {
      Unit::write(p + t * unit_stride, byte_stride, word);
    } else if ((t & (Unit::kCodes - 1)) == Unit::kCodes - 1) {
      Unit::write(p, byte_stride, word);
      p += unit_stride;
    }
  }
};

// One pass over a block's code slots, samples x[t * xs]: the first n_live
// slots advance the state and the int64 sum `sse` of their wrapped squared
// errors (reference: src/aad_encoder.c:431-467). Every slot up to n_codes
// puts its code to `codes`, past n_live from the frozen state.
template <int BPS, class Sink>
__device__ __forceinline__ State run(State s, const int16_t* __restrict__ x, int64_t xs, int n_live,
                                     int n_codes, Sink& codes, long long& sse, const Tables<BPS>& tb) {
  int32_t step = first_step(tb.step, s.idx);
  long long acc = 0;
  int t = 0;
#pragma unroll 4
  for (; t < n_live; ++t) {
    int32_t qdiff;
    const int32_t code = encode_step<BPS>(s, step, x[t * xs], tb, qdiff);
    acc += wrapped_square(qdiff);
    codes.put(t, code);
  }
  if constexpr (Sink::kKeeps) {
    for (; t < n_codes; ++t) {  // past the valid samples: each code from the frozen state
      State frozen = s;
      int32_t frozen_step = step;
      int32_t qdiff;
      codes.put(t, encode_step<BPS>(frozen, frozen_step, x[t * xs], tb, qdiff));
    }
  }
  sse = acc;
  return s;
}

// Measure pass: the first n_live code slots of x advance the state.
template <int BPS>
__device__ __forceinline__ State measure(State s, const int16_t* __restrict__ x, int64_t stride,
                                         int n_live, long long& sse, const Tables<BPS>& tb) {
  NoCodes none;
  return run<BPS>(s, x, stride, n_live, n_live, none, sse, tb);
}

// The serial schedule's emit, staged per warp (see the top). Row r of a
// block, lanes r * C .. r * C + C - 1 (its channels), is the block's data
// region, units of C * kBytes bytes. A lane puts its codes into its bytes of
// its row of the warp's tile, kTileCodes codes at a time; then the warp
// writes the tile's rows out, its active lanes (a prefix of the warp) taking
// consecutive bytes. The tile holds 32 / C rows of `pitch` bytes.
template <class Unit>
struct StagedRows {
  uint8_t* tile;      // the warp's tile in shared memory
  uint8_t* out;       // the block's row of the warp's first lane
  int64_t row_bytes;  // a row in `out`
  int pitch;          // a row in the tile: an odd number of words
  int unit_bytes;     // C * kBytes
  int rows;           // the warp's rows that exist
  int mine;           // this lane's first byte in the tile: its row, its channel
  unsigned mask;      // the warp's active lanes

  // Every code of a block, from entry state s; returns the state after it.
  template <int BPS>
  __device__ __forceinline__ State emit(State s, const int16_t* __restrict__ x, int64_t xs, int num_codes,
                                        const Tables<BPS>& tb) {
    const int rank = threadIdx.x & 31;
    const int active = __popc(mask);
    for (int t0 = 0; t0 < num_codes; t0 += kTileCodes) {
      const int n = min(kTileCodes, num_codes - t0);
      UnitCodes<Unit> codes{tile + mine, unit_bytes, 1, 0};
      long long unused;
      s = run<BPS>(s, x + t0 * xs, xs, n, n, codes, unused, tb);
      __syncwarp(mask);
      const int seg = (n >> Unit::kShift) * unit_bytes;  // bytes of a row in this tile
      uint8_t* dst = out + static_cast<int64_t>(t0 >> Unit::kShift) * unit_bytes;
      for (int r = 0; r < rows; ++r) {
        for (int k = rank; k < seg; k += active) dst[r * row_bytes + k] = tile[r * pitch + k];
      }
      __syncwarp(mask);  // the tile is free again
    }
    return s;
  }
};

// The tile bytes a warp of the serial schedule takes: 32 rows of an odd
// number of words, enough for kTileCodes codes of a lane one a byte.
constexpr int kStageRowWords = (kTileCodes / 4) | 1;
constexpr int kStageWarpBytes = 32 * 4 * kStageRowWords;

// The tile pitch in bytes for units of unit_bytes (C * kBytes).
template <class Unit>
__device__ __forceinline__ int stage_pitch(int unit_bytes) {
  return 4 * (((kTileCodes / Unit::kCodes) * unit_bytes / 4) | 1);
}

__device__ __forceinline__ int32_t abs_wrapped(int32_t w) { return w >= 0 ? w : wneg(w); }

// Weight rounding (reference: src/aad_encoder.c:620-646): the smallest right
// shift that puts max|w| into int16 range is max(bitlen - 15, 0) with
// bitlen = 32 - clz(max|w|), as aad_tpu's scan engine computes it (so
// |INT32_MIN|, which wraps to itself, has shift 17). Clears the shifted-out
// bits in place and returns the shift.
__device__ __forceinline__ int32_t round_weights(State& s) {
  const int32_t maxabs = max(max(abs_wrapped(s.w0), abs_wrapped(s.w1)),
                             max(abs_wrapped(s.w2), abs_wrapped(s.w3)));
  const int32_t shift = max(32 - __clz(maxabs) - 15, 0);
  const int32_t mask = static_cast<int32_t>(~((1u << shift) - 1u));
  s.w0 &= mask;
  s.w1 &= mask;
  s.w2 &= mask;
  s.w3 &= mask;
  return shift;
}

// The block header's state (src/aad_encoder.c:618-655): history seeded from
// the block, weights rounded; the entry state of an emit pass.
__device__ __forceinline__ State header_state(State s, const int16_t* __restrict__ cur, int64_t stride,
                                              int32_t& shift) {
  s = seed(s, cur, stride);
  shift = round_weights(s);
  return s;
}

__device__ __forceinline__ void store_header(int32_t* hdr, int64_t stride, const State& s, int32_t shift) {
  store_fields(hdr, stride, s);
  hdr[9 * stride] = shift;
}

// The wire mode's inputs and outputs (see the top). Before anything else
// each CTA pads, and for mid/side combines, its lanes' samples into `ms`,
// the layout every pass reads; each header goes to its row as bytes, the
// data region after it.
struct Wire {
  const int16_t* pcm;   // (L / C, C, n): each row's channels, channel-major
  int16_t* ms;          // (B, nspb, L) out: the samples the passes read, time-major, zero past n
  uint8_t* rows;        // (B, L / C, block_bytes) out: whole blocks, the header then the data region
  int32_t* seed_index;  // (L,) out: the last block's header state, kernel 4's entry state
  int32_t* seed_history;  // (L, 4) out
  int32_t* seed_weight;   // (L, 4) out
  long long n;            // samples a channel
  long long block_stride;  // bytes a block of rows: L / C * block_bytes
  int block_bytes;
  int mid_side;  // two channels: lane 2r takes mid = (L + R) >> 1, lane 2r + 1 side = (L - R) >> 1

  // Block b's row of `lane`, lane / C (C is 1 or 2).
  __device__ __forceinline__ uint8_t* row(int b, int64_t lane, int C) const {
    return rows + b * block_stride + (C == 2 ? lane >> 1 : lane) * block_bytes;
  }

  // block b's valid samples
  __device__ __forceinline__ int32_t valid(int b, int nspb) const {
    return static_cast<int32_t>(min(max(n - static_cast<long long>(b) * nspb, 0LL), static_cast<long long>(nspb)));
  }

  // The samples of lanes [lane0, lane0 + lanes) (whole rows) of every block
  // into ms, all threads of the CTA taking part: a thread a sample position
  // of a row at a time, its C samples read once. Mid/side as
  // ops/encode.py::lr_to_ms computes it, in int32 (src/aad_encoder.c:413-428).
  // A barrier must follow.
  __device__ __forceinline__ void stage(int64_t lane0, int lanes, int num_blocks, int nspb, int64_t L,
                                        int C) const {
    constexpr int kBatch = 8;  // positions a thread loads before it stores any
    const int64_t positions = static_cast<int64_t>(num_blocks) * nspb;
    for (int64_t lane = lane0; lane < lane0 + lanes; lane += C) {
      const int16_t* src = pcm + lane * n;
      for (int64_t first = threadIdx.x; first < positions; first += kBatch * blockDim.x) {
        int32_t x0[kBatch], x1[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t pos = first + u * blockDim.x;
          x0[u] = pos < n ? src[pos] : 0;
          x1[u] = C == 2 && pos < n ? src[n + pos] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t pos = first + u * blockDim.x;
          if (pos >= positions) break;
          int32_t a = x0[u], b = x1[u];
          if (mid_side) {
            a = clip16(asr(x0[u] + x1[u], 1));
            b = clip16(asr(x0[u] - x1[u], 1));
          }
          int16_t* dst = ms + pos * L + lane;
          dst[0] = static_cast<int16_t>(a);
          if (C == 2) dst[1] = static_cast<int16_t>(b);
        }
      }
    }
  }

  // Block b's header of `lane` (channel lane % C of row lane / C) as the
  // wire holds it (src/aad_encoder.c:618-655): the big-endian u16 (step
  // index << 4) | (shift & 0xF), then (w_k >> shift) & 0xFFFF and h_k &
  // 0xFFFF for each tap, as format/framing.py::build_block_headers lays it
  // out; and, the last block's, its state as kernel 4 reads it.
  __device__ __forceinline__ void put_header(int b, int64_t lane, int C, bool last, const State& s,
                                             int32_t shift) const {
    uint8_t* p = row(b, lane, C) + (C == 2 ? static_cast<int>(lane & 1) : 0) * kChannelHeaderBytes;
    const int32_t u16[9] = {(s.idx << kTablesDigits) | (shift & 0xF), asr(s.w0, shift), s.h0, asr(s.w1, shift), s.h1,
                            asr(s.w2, shift), s.h2, asr(s.w3, shift), s.h3};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      p[2 * k] = static_cast<uint8_t>((u16[k] >> 8) & 0xFF);
      p[2 * k + 1] = static_cast<uint8_t>(u16[k] & 0xFF);
    }
    if (last) {
      seed_index[lane] = s.idx;
      int32_t* h = seed_history + 4 * lane;
      int32_t* w = seed_weight + 4 * lane;
      h[0] = s.h0;
      h[1] = s.h1;
      h[2] = s.h2;
      h[3] = s.h3;
      w[0] = s.w0;
      w[1] = s.w1;
      w[2] = s.w2;
      w[3] = s.w3;
    }
  }
};

// The bank mode's tick (see the top). A feed is a row of C lanes of the
// launch, lane l of feed l / C; its row of the tick's table holds its slot,
// its samples a channel n, where its first sample lies in pcm (channel c at
// pcm[first + c * channel_stride + t] for t < n), its first byte in the
// output and whether it has a carry. Its blocks' samples lie in
// Wire::ms from block 1 on; block 0 there is a carried feed's previous
// block. The slot's carry is lane slot * C + l % C of `prev` and of the end
// state, which kernel 4 writes and the next tick's kernel 3 reads.
constexpr int kBankFields = 5;  // slot, n, first, first byte, carried

struct Feed {
  int32_t n;
  int32_t byte0;
  int32_t blocks;
  bool carried;
  int64_t slot_lane;  // the feed's lane in the bank's buffers

  // block b's valid samples; 0 past the feed's blocks
  __device__ __forceinline__ int32_t valid(int b, int nspb) const {
    return b < blocks ? min(n - b * nspb, nspb) : 0;
  }

  // whether block b has a block before it in the feed
  __device__ __forceinline__ bool has_prev(int b) const { return b < blocks && (b > 0 || carried); }
};

struct Bank {
  const int32_t* feeds;     // (F, kBankFields)
  const int16_t* pcm;       // the tick's samples
  int16_t* prev;            // (nspb, slot_lanes): each slot's last block, time-major
  int32_t* end_index;       // (slot_lanes,): each slot's state after its last block
  int32_t* end_history;     // (slot_lanes, 4)
  int32_t* end_weight;      // (slot_lanes, 4)
  long long channel_stride;
  long long slot_lanes;     // S * C

  __device__ __forceinline__ Feed feed(int64_t lane, int C, int nspb) const {
    const int32_t* f = feeds + (C == 2 ? lane >> 1 : lane) * kBankFields;
    const int32_t n = f[1];
    return Feed{n, f[3], (n + nspb - 1) / nspb, f[4] != 0, static_cast<int64_t>(f[0]) * C + (C == 2 ? lane & 1 : 0)};
  }

  // The samples of lanes [lane0, lane0 + lanes) (whole rows) into w.ms, all
  // threads of the CTA taking part: a carried feed's previous block from
  // prev into block 0, a barrier, then each feed's blocks from pcm into
  // blocks 1 on, zero past n and mid/side combined as Wire::stage does, its
  // last block also into its slot of prev. A barrier must follow.
  __device__ __forceinline__ void stage(const Wire& w, int64_t lane0, int lanes, int nspb, int64_t L,
                                        int C) const {
    for (int k = threadIdx.x; k < lanes * nspb; k += blockDim.x) {
      const int64_t lane = lane0 + k % lanes;
      const int pos = k / lanes;
      const Feed f = feed(lane, C, nspb);
      if (f.carried) w.ms[pos * L + lane] = prev[pos * slot_lanes + f.slot_lane];
    }
    __syncthreads();
    constexpr int kBatch = 8;  // positions a thread loads before it stores any
    for (int64_t lane = lane0; lane < lane0 + lanes; lane += C) {
      const Feed f = feed(lane, C, nspb);
      const int16_t* src = pcm + feeds[(C == 2 ? lane >> 1 : lane) * kBankFields + 2];
      const int positions = f.blocks * nspb;
      const int last = positions - nspb;
      for (int first = threadIdx.x; first < positions; first += kBatch * blockDim.x) {
        int32_t x0[kBatch], x1[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int pos = first + u * blockDim.x;
          x0[u] = pos < f.n ? src[pos] : 0;
          x1[u] = C == 2 && pos < f.n ? src[channel_stride + pos] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int pos = first + u * blockDim.x;
          if (pos >= positions) break;
          int32_t a = x0[u], b = x1[u];
          if (w.mid_side) {
            a = clip16(asr(x0[u] + x1[u], 1));
            b = clip16(asr(x0[u] - x1[u], 1));
          }
          int16_t* dst = w.ms + static_cast<int64_t>(nspb + pos) * L + lane;
          dst[0] = static_cast<int16_t>(a);
          if (C == 2) dst[1] = static_cast<int16_t>(b);
          if (pos >= last) {
            int16_t* keep = prev + static_cast<int64_t>(pos - last) * slot_lanes + f.slot_lane;
            keep[0] = static_cast<int16_t>(a);
            if (C == 2) keep[1] = static_cast<int16_t>(b);
          }
        }
      }
    }
  }

  // Block b's header of `lane` and, its feed's last block's, its state, as
  // Wire::put_header writes them, in the feed's block b. (A shared writer
  // changed the wire mode's compiled code: kept apart.)
  __device__ __forceinline__ void put_header(const Wire& w, const Feed& f, int b, int64_t lane, int C,
                                             const State& s, int32_t shift) const {
    uint8_t* p = w.rows + f.byte0 + static_cast<int64_t>(b) * w.block_bytes +
                 (C == 2 ? static_cast<int>(lane & 1) : 0) * kChannelHeaderBytes;
    const int32_t u16[9] = {(s.idx << kTablesDigits) | (shift & 0xF), asr(s.w0, shift), s.h0, asr(s.w1, shift), s.h1,
                            asr(s.w2, shift), s.h2, asr(s.w3, shift), s.h3};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      p[2 * k] = static_cast<uint8_t>((u16[k] >> 8) & 0xFF);
      p[2 * k + 1] = static_cast<uint8_t>(u16[k] & 0xFF);
    }
    if (b == f.blocks - 1) {
      w.seed_index[lane] = s.idx;
      int32_t* h = w.seed_history + 4 * lane;
      int32_t* wt = w.seed_weight + 4 * lane;
      h[0] = s.h0;
      h[1] = s.h1;
      h[2] = s.h2;
      h[3] = s.h3;
      wt[0] = s.w0;
      wt[1] = s.w1;
      wt[2] = s.w2;
      wt[3] = s.w3;
    }
  }

  // The data regions of the CTA's rows of block b (lanes [lane0, lane0 +
  // lanes), row_bytes a row in `codes`, units of unit_bytes holding
  // unit_codes codes a channel) after their headers, by the `active` threads
  // of the CTA: a feed's short last block up to the unit of its last valid
  // sample (format/geometry.py::encoded_block_bytes); a row whose feed has
  // no block b is skipped.
  __device__ __forceinline__ void put_rows(const Wire& w, int b, int64_t lane0, int lanes, int C, int nspb,
                                           const uint8_t* codes, int64_t row_bytes, int unit_bytes, int unit_codes,
                                           int active) const {
    for (int r = 0; r < lanes / C; ++r) {
      const Feed f = feed(lane0 + r * C, C, nspb);
      if (b >= f.blocks) continue;
      uint8_t* const dst = w.rows + f.byte0 + static_cast<int64_t>(b) * w.block_bytes + C * kChannelHeaderBytes;
      const int units = (max(f.valid(b, nspb) - kFilterOrder, 0) + unit_codes - 1) / unit_codes;
      const int64_t bytes = min(row_bytes, static_cast<int64_t>(units) * unit_bytes);
      for (int k = threadIdx.x; k < bytes; k += active) dst[k] = codes[r * row_bytes + k];
    }
  }
};

// The serial schedule (see the top); kWire, the wire mode (struct Wire).
template <int BPS, bool kPacked, bool kWire>
__global__ void __launch_bounds__(kEncodeThreads)
    encode_stream_kernel(const int16_t* __restrict__ samples,    // (B, nspb, L) time-major
                         const int16_t* __restrict__ prev0,      // (nspb, L), or null if unread
                         const int32_t* __restrict__ valid,      // (B, L)
                         const int32_t* __restrict__ step_index, // (L,) initial state
                         const int32_t* __restrict__ history,    // (L, 4)
                         const int32_t* __restrict__ weight,     // (L, 4)
                         const int32_t* __restrict__ step_table, // (256,)
                         const int32_t* __restrict__ index_table,// (2**BPS,)
                         uint8_t* __restrict__ codes,            // (B, L / C, row_bytes); unpacked (B, T, L)
                         int32_t* __restrict__ headers,          // (B, 10, L)
                         int32_t* __restrict__ states,           // (B, 9, L), or null
                         int num_blocks, int num_lanes, int nspb, int num_channels, int num_trials,
                         int warm_on_prev, int blocks_before, const Wire wire) {
  static_assert(!kWire || kPacked, "the wire mode writes the data regions packed");
  using Unit = CodeUnit<BPS, kPacked>;
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ uint8_t s_stage[kEncodeThreads / 32][kStageWarpBytes];
  if constexpr (kWire) {  // stage_tables' barrier orders it before every pass
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
    wire.stage(first, static_cast<int>(min(int64_t{blockDim.x}, num_lanes - first)), num_blocks, nspb, num_lanes,
               num_channels);
  }
  const Tables<BPS> tb = stage_tables<BPS>(s_step, step_table, index_table);

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned mask = __ballot_sync(0xffffffffu, lane < num_lanes);
  if (lane >= num_lanes) return;
  const int64_t L = num_lanes;
  const int T = nspb - kFilterOrder;
  const int C = num_channels;
  const int unit_bytes = C * Unit::kBytes;
  const int64_t row_bytes = static_cast<int64_t>(T >> Unit::kShift) * unit_bytes;
  const int64_t warp_lane0 = lane & ~int64_t{31};
  const int in_warp = static_cast<int>(lane - warp_lane0);
  const int pitch = stage_pitch<Unit>(unit_bytes);
  StagedRows<Unit> staged{s_stage[threadIdx.x / 32], nullptr, row_bytes, pitch, unit_bytes,
                          static_cast<int>(min(int64_t{32}, L - warp_lane0) / C),
                          (in_warp / C) * pitch + (in_warp % C) * Unit::kBytes, mask};
  if constexpr (kWire) staged.row_bytes = wire.block_bytes;
  // the wire mode's first push has no carry: a zero state
  State st = kWire && step_index == nullptr ? State{} : load_state(step_index, history, weight, lane);

  for (int b = 0; b < num_blocks; ++b) {
    const int16_t* cur = samples + static_cast<int64_t>(b) * nspb * L + lane;
    if constexpr (kWire) cur = wire.ms + static_cast<int64_t>(b) * nspb * L + lane;
    const int32_t v = kWire ? wire.valid(b, nspb) : valid[static_cast<int64_t>(b) * L + lane];
    // fewer than 4 valid samples: the reference's early return, state
    // untouched and zero error (src/aad_encoder.c:443-455)
    const bool head_ok = v >= kFilterOrder;
    const int n_live = clip(v - kFilterOrder, 0, T);

    if (num_trials > 0) {
      long long min_sse = 0;
      State measured = st;
      if (head_ok) {
        measured = measure<BPS>(seed(st, cur, L), cur + kFilterOrder * L, L, n_live, min_sse, tb);
      }
      State best = st;
      if (warm_on_prev) {
        const bool has_prev = b + blocks_before >= 1;
        // block 0's previous block is the carry's (prev0), read only then
        const int16_t* prev = b == 0 ? prev0 : samples + static_cast<int64_t>(b - 1) * nspb * L;
        if constexpr (kWire) prev = b == 0 ? prev0 : wire.ms + static_cast<int64_t>(b - 1) * nspb * L;
        State walker = st;
        for (int i = 0; i < num_trials; ++i) {
          if (has_prev) {  // always the full previous block
            long long unused;
            walker = measure<BPS>(seed(walker, prev + lane, L), prev + lane + kFilterOrder * L, L,
                                                  T, unused, tb);
          }
          const State cand = walker;
          long long sse = 0;
          if (head_ok) {
            walker = measure<BPS>(seed(walker, cur, L), cur + kFilterOrder * L, L, n_live, sse, tb);
          }
          if (sse_better(sse, min_sse)) {
            best = cand;
            min_sse = sse;
          }
        }
      } else {
        // every block a stream head: trial 1 measures what the baseline
        // measured and can never be strictly better, so start at trial 2
        State walker = measured;
        for (int i = 1; i < num_trials; ++i) {
          const State cand = walker;
          long long sse = 0;
          if (head_ok) {
            walker = measure<BPS>(seed(walker, cur, L), cur + kFilterOrder * L, L, n_live, sse, tb);
          }
          if (sse_better(sse, min_sse)) {
            best = cand;
            min_sse = sse;
          }
        }
      }
      st = best;
    }

    // block header: seed, round weights, snapshot (src/aad_encoder.c:618-655)
    int32_t shift;
    st = header_state(st, cur, L, shift);
    if constexpr (kWire) {
      wire.put_header(b, lane, C, b == num_blocks - 1, st, shift);
    } else {
      store_header(headers + static_cast<int64_t>(b) * kHeaderFields * L + lane, L, st, shift);
    }

    // data section: every slot of the padded block (src/aad_encoder.c:661-722)
    if constexpr (kPacked) {
      if constexpr (kWire) {  // the data region after the row's header
        staged.out = wire.row(b, warp_lane0, C) + C * kChannelHeaderBytes;
      } else {
        staged.out = codes + (static_cast<int64_t>(b) * (L / C) + warp_lane0 / C) * row_bytes;
      }
      st = staged.emit(st, cur + kFilterOrder * L, L, T, tb);
    } else {
      ByteCodes to{codes + static_cast<int64_t>(b) * T * L + lane, L};
      long long unused;
      st = run<BPS>(st, cur + kFilterOrder * L, L, T, T, to, unused, tb);
    }
    if (states != nullptr) {
      store_fields(states + static_cast<int64_t>(b) * kStateFields * L + lane, L, st);
    }
  }
}

__device__ __forceinline__ State shfl_state(unsigned mask, const State& s, int src) {
  return State{__shfl_sync(mask, s.h0, src), __shfl_sync(mask, s.h1, src), __shfl_sync(mask, s.h2, src),
               __shfl_sync(mask, s.h3, src), __shfl_sync(mask, s.w0, src), __shfl_sync(mask, s.w1, src),
               __shfl_sync(mask, s.w2, src), __shfl_sync(mask, s.w3, src), __shfl_sync(mask, s.idx, src)};
}

// Lane l's column of a (nspb, L) time-major block into its column of the
// CTA's (nspb, lanes a CTA) tile; the lane's two threads take alternate rows.
__device__ __forceinline__ void stage_column(int16_t* tile, const int16_t* __restrict__ column, int64_t L,
                                             int nspb, int per_cta, bool side) {
  for (int r = side; r < nspb; r += 2) tile[r * per_cta] = column[r * L];
}

// The paired schedule (see the top) for num_trials > 0 and warm_on_prev:
// lane l of the CTA is threads 2l (the chain) and 2l + 1 (the side). The
// dynamic shared memory holds, with kStaged, two tiles (nspb, lanes a CTA)
// int16 of the samples, the current block's and the previous one's, which
// the passes read in place of device memory; then, packed, two copies of
// the CTA's rows of the block's data regions, (lanes a CTA / C, row_bytes)
// each: the adopted emits' and the speculative one's; unpacked, the
// speculative codes, (T, lanes a CTA). kWire: the wire mode (struct Wire);
// kBank, with kWire, the bank mode (struct Bank).
template <int BPS, bool kStaged, bool kPacked, bool kWire, bool kBank>
__global__ void __launch_bounds__(2 * kPairLanes)
    encode_stream_paired_kernel(const int16_t* __restrict__ samples,    // (B, nspb, L) time-major
                                const int16_t* __restrict__ prev0,      // (nspb, L)
                                const int32_t* __restrict__ valid,      // (B, L)
                                const int32_t* __restrict__ step_index, // (L,) initial state
                                const int32_t* __restrict__ history,    // (L, 4)
                                const int32_t* __restrict__ weight,     // (L, 4)
                                const int32_t* __restrict__ step_table, // (256,)
                                const int32_t* __restrict__ index_table,// (2**BPS,)
                                uint8_t* __restrict__ codes,            // (B, L / C, row_bytes); unpacked (B, T, L)
                                int32_t* __restrict__ headers,          // (B, 10, L)
                                int32_t* __restrict__ states,           // (B, 9, L), or null
                                int num_blocks, int num_lanes, int nspb, int num_channels, int num_trials,
                                int blocks_before, const Wire wire, const Bank bank) {
  static_assert(!kWire || kPacked, "the wire mode writes the data regions packed");
  static_assert(!kBank || kWire, "the bank mode is a wire mode");
  using Unit = CodeUnit<BPS, kPacked>;
  extern __shared__ uint8_t s_dyn[];
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ uint8_t s_sink[2 * kPairLanes];  // the codes of a pass that keeps none
  if constexpr (kBank) {  // stage_tables' barrier orders it before every pass
    const int64_t first = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 2);
    bank.stage(wire, first, static_cast<int>(min(int64_t{blockDim.x / 2}, num_lanes - first)), nspb, num_lanes,
               num_channels);
  } else if constexpr (kWire) {  // stage_tables' barrier orders it before every pass
    const int64_t first = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 2);
    wire.stage(first, static_cast<int>(min(int64_t{blockDim.x / 2}, num_lanes - first)), num_blocks, nspb,
               num_lanes, num_channels);
  }
  const Tables<BPS> tb = stage_tables<BPS>(s_step, step_table, index_table);

  const int per_cta = blockDim.x / 2;
  const int local = threadIdx.x / 2;
  const bool side = threadIdx.x & 1;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * per_cta + local;
  const int warp_threads = min(32, static_cast<int>(blockDim.x) - static_cast<int>(threadIdx.x & ~31u));
  const unsigned warp_all = warp_threads == 32 ? 0xffffffffu : (1u << warp_threads) - 1u;
  const unsigned mask = __ballot_sync(warp_all, lane < num_lanes);  // the pairs that have a lane
  if (lane >= num_lanes) return;
  const int chain_src = static_cast<int>(threadIdx.x & 31u) & ~1;  // the partners' ids in the warp
  const int side_src = chain_src | 1;

  const int64_t L = num_lanes;
  const int T = nspb - kFilterOrder;
  const int unit_bytes = num_channels * Unit::kBytes;
  const int units = T >> Unit::kShift;
  const int64_t row_bytes = static_cast<int64_t>(units) * unit_bytes;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * per_cta;  // a multiple of C
  const int64_t cta_bytes = min(int64_t{per_cta}, L - lane0) / num_channels * row_bytes;  // its rows
  const int N = num_trials;
  const int slots = N == 1 ? 3 : 2 * N;
  const int last_measure = 2 * N - 1;
  const int64_t tile = static_cast<int64_t>(nspb) * per_cta;
  int16_t* const s_tiles = reinterpret_cast<int16_t*>(s_dyn) + local;
  uint8_t* const sink = s_sink + threadIdx.x;
  uint8_t* const s_codes = s_dyn + (kStaged ? 4 * tile : 0);
  // packed: this lane's bytes of its row (local / C, channel local % C) in
  // each copy; unpacked: its column of the speculative codes
  uint8_t* const kept_codes = s_codes + (local / num_channels) * row_bytes + (local % num_channels) * Unit::kBytes;
  uint8_t* const spec_codes = kPacked ? kept_codes + per_cta / num_channels * row_bytes : s_codes + local;
  const int64_t spec_stride = kPacked ? unit_bytes : per_cta;
  const int64_t xs = kStaged ? per_cta : L;  // the samples' stride
  // the wire mode's first push has no carry: a zero state, and no block before block 0
  State st = kWire && step_index == nullptr ? State{} : load_state(step_index, history, weight, lane);
  Feed feed{};
  if constexpr (kBank) {  // the lane's feed, and its slot's end state where it has a carry
    feed = bank.feed(lane, num_channels, nspb);
    if (feed.carried) st = load_state(bank.end_index, bank.end_history, bank.end_weight, feed.slot_lane);
  }

  for (int b = 0; b < num_blocks; ++b) {
    const int16_t* cur = samples + static_cast<int64_t>(b) * nspb * L + lane;
    const int16_t* prev = (b == 0 ? prev0 : samples + static_cast<int64_t>(b - 1) * nspb * L) + lane;
    if constexpr (kBank) {  // block b at ms block b + 1, after the carry's
      cur = wire.ms + static_cast<int64_t>(b + 1) * nspb * L + lane;
      prev = wire.ms + static_cast<int64_t>(b) * nspb * L + lane;
    } else if constexpr (kWire) {
      cur = wire.ms + static_cast<int64_t>(b) * nspb * L + lane;
      prev = (b == 0 ? prev0 : wire.ms + static_cast<int64_t>(b - 1) * nspb * L) + lane;
    }
    if constexpr (kStaged) {  // block b in tile b % 2; block b - 1 already in the other
      int16_t* const cur_tile = s_tiles + (b & 1) * tile;
      int16_t* const prev_tile = s_tiles + ((b + 1) & 1) * tile;
      __syncwarp(mask);  // every pass over block b - 1 (and so over tile b % 2) is done
      if (b == 0 && (kBank ? feed.carried : !kWire || prev0 != nullptr)) {
        stage_column(prev_tile, prev, L, nspb, per_cta, side);
      }
      stage_column(cur_tile, cur, L, nspb, per_cta, side);
      __syncwarp(mask);
      cur = cur_tile;
      prev = prev_tile;
    }
    const int32_t v =
        kBank ? feed.valid(b, nspb) : kWire ? wire.valid(b, nspb) : valid[static_cast<int64_t>(b) * L + lane];
    // fewer than 4 valid samples: no measure runs, the error is 0 and no
    // candidate is adopted (src/aad_encoder.c:443-455)
    const int n_measure = v >= kFilterOrder ? clip(v - kFilterOrder, 0, T) : -1;
    // warm-ups from the stream's second block on
    const bool has_prev = kBank ? feed.has_prev(b) : b + blocks_before >= 1;
    const bool live = !kBank || b < feed.blocks;  // the bank mode: past its feed's blocks a lane writes nothing
    uint8_t* const out = kPacked ? kept_codes : codes + static_cast<int64_t>(b) * T * L + lane;
    const int64_t out_stride = kPacked ? unit_bytes : L;
    int32_t* const hdr = headers + static_cast<int64_t>(b) * kHeaderFields * L + lane;

    State walker = st;   // chain: the trial state
    State cand = st;     // both: the candidate of the latest measure
    State kept = st;     // side: the end state of the adopted emit
    State spec_end = st, spec_entry = st;
    int32_t spec_shift = 0;
    long long min_sse = 0;
    bool better = false;  // the latest measure's candidate was adopted
    for (int s = 0; s < slots; ++s) {
      const bool chain_warms = s % 2 == 0;
      if (!chain_warms) cand = shfl_state(mask, walker, chain_src);
      // this slot's pass of each thread: entry state, samples, length, codes
      State entry;
      const int16_t* x = cur;
      int n = 0;
      UnitCodes<Unit> to{sink, 0, 0, 0};
      if (!side) {
        if (chain_warms) {  // warm_(s/2 + 1) on the full previous block
          entry = has_prev ? seed(walker, prev, xs) : walker;
          x = prev;
          n = has_prev && s < 2 * N ? T : 0;
        } else {  // measure_((s+1)/2)
          entry = n_measure >= 0 ? seed(walker, cur, xs) : walker;
          n = max(n_measure, 0);
        }
      } else if (s == 0) {  // the baseline measure
        entry = n_measure >= 0 ? seed(st, cur, xs) : st;
        n = max(n_measure, 0);
      } else {  // an emit: from the baseline (s = 1) or from the latest candidate
        int32_t shift;
        entry = header_state(s == 1 ? st : cand, cur, xs, shift);
        if ((s == 1 && live) || (chain_warms && better)) {  // adopted: codes and header in place
          n = T;
          to = UnitCodes<Unit>{out, out_stride, 1, 0};
          if constexpr (kBank) {
            bank.put_header(wire, feed, b, lane, num_channels, entry, shift);
          } else if constexpr (kWire) {
            wire.put_header(b, lane, num_channels, b == num_blocks - 1, entry, shift);
          } else {
            store_header(hdr, L, entry, shift);
          }
        } else if (s == last_measure) {  // candidate N, before better_N is known
          n = T;
          to = UnitCodes<Unit>{spec_codes, spec_stride, 1, 0};
          spec_entry = entry;
          spec_shift = shift;
        }
      }
      long long sse;
      const State end = run<BPS>(entry, x + kFilterOrder * xs, xs, n, n, to, sse, tb);
      if (s == 0) {
        if (!side && has_prev) walker = end;
        min_sse = __shfl_sync(mask, sse, side_src);
      } else if (!chain_warms) {
        if (!side && n_measure >= 0) walker = end;
        if (side && s == 1) kept = end;
        if (side && s == last_measure) spec_end = end;
        const long long cand_sse = __shfl_sync(mask, sse, chain_src);
        better = sse_better(cand_sse, min_sse);
        if (better) min_sse = cand_sse;
      } else {
        if (!side && has_prev) walker = end;
        if (side && better) kept = end;
      }
    }
    if (side && N > 1 && better) {  // candidate N adopted: its codes, header and end state
      for (int u = 0; u < units; ++u) {
#pragma unroll
        for (int i = 0; i < Unit::kBytes; ++i) out[u * out_stride + i] = spec_codes[u * spec_stride + i];
      }
      if constexpr (kBank) {
        bank.put_header(wire, feed, b, lane, num_channels, spec_entry, spec_shift);
      } else if constexpr (kWire) {
        wire.put_header(b, lane, num_channels, b == num_blocks - 1, spec_entry, spec_shift);
      } else {
        store_header(hdr, L, spec_entry, spec_shift);
      }
      kept = spec_end;
    }
    if constexpr (kBank) {  // each live row's data region after its header
      __syncwarp(mask);
      bank.put_rows(wire, b, lane0, static_cast<int>(min(int64_t{per_cta}, L - lane0)), num_channels, nspb, s_codes,
                    row_bytes, unit_bytes, Unit::kCodes, __popc(mask));
      __syncwarp(mask);  // the copies are free again
    } else if constexpr (kWire) {
      // the data regions of the CTA's rows of block b, each after its
      // row's header, by its active threads (a prefix of the warp)
      __syncwarp(mask);
      uint8_t* const dst = wire.row(b, lane0, num_channels) + num_channels * kChannelHeaderBytes;
      const int active = __popc(mask);
      const int rows = static_cast<int>(cta_bytes / row_bytes);
      for (int r = 0; r < rows; ++r) {
        for (int k = threadIdx.x; k < row_bytes; k += active) {
          dst[r * wire.block_bytes + k] = s_codes[r * row_bytes + k];
        }
      }
      __syncwarp(mask);  // the copies are free again
    } else if constexpr (kPacked) {
      // the CTA's rows of block b, consecutive bytes, by its active threads
      // (a prefix of the warp)
      __syncwarp(mask);
      uint8_t* const dst = codes + (static_cast<int64_t>(b) * (L / num_channels) + lane0 / num_channels) * row_bytes;
      const int active = __popc(mask);
      for (int64_t k = threadIdx.x; k < cta_bytes; k += active) dst[k] = s_codes[k];
      __syncwarp(mask);  // the copies are free again
    }
    st = shfl_state(mask, kept, side_src);
    if (side && states != nullptr) {
      store_fields(states + static_cast<int64_t>(b) * kStateFields * L + lane, L, st);
    }
  }
}

template <int BPS>
__global__ void __launch_bounds__(kEncodeThreads)
    encode_pass_kernel(const int16_t* __restrict__ samples,    // (T, L) time-major
                       const int32_t* __restrict__ step_index, // (L,) seeded state
                       const int32_t* __restrict__ history,    // (L, 4)
                       const int32_t* __restrict__ weight,     // (L, 4)
                       const int32_t* __restrict__ valid,      // (L,) incl. the 4 head samples
                       const int32_t* __restrict__ step_table, // (256,)
                       const int32_t* __restrict__ index_table,// (2**BPS,)
                       uint8_t* __restrict__ codes,            // (T, L), or null: measure
                       int32_t* __restrict__ step_index_out,   // (L,)
                       int32_t* __restrict__ history_out,      // (L, 4)
                       int32_t* __restrict__ weight_out,       // (L, 4)
                       long long* __restrict__ sse_out,        // (L,)
                       int num_lanes, int num_codes) {
  __shared__ int32_t s_step[kStepTableSize];
  const Tables<BPS> tb = stage_tables<BPS>(s_step, step_table, index_table);

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;
  const int64_t L = num_lanes;
  State st = load_state(step_index, history, weight, lane);
  const int n_live = clip(valid[lane] - kFilterOrder, 0, num_codes);
  long long sse;
  if (codes != nullptr) {
    ByteCodes to{codes + lane, L};
    st = run<BPS>(st, samples + lane, L, n_live, num_codes, to, sse, tb);
  } else {
    st = measure<BPS>(st, samples + lane, L, n_live, sse, tb);
  }
  history_out[4 * lane + 0] = st.h0;
  history_out[4 * lane + 1] = st.h1;
  history_out[4 * lane + 2] = st.h2;
  history_out[4 * lane + 3] = st.h3;
  weight_out[4 * lane + 0] = st.w0;
  weight_out[4 * lane + 1] = st.w1;
  weight_out[4 * lane + 2] = st.w2;
  weight_out[4 * lane + 3] = st.w3;
  step_index_out[lane] = st.idx;
  sse_out[lane] = sse;
}

// Kernel 4's bank instance (see the top): lane l of the tick's feeds, from
// the header state kernel 3 left for its feed's last block (seed_*, (L, ...)),
// one measure pass over that block (ms, time-major, as kernel 3 staged it)
// to the state after it, written to the lane's slot of the bank's end state.
template <int BPS>
__global__ void __launch_bounds__(kEncodeThreads)
    bank_encode_pass_kernel(const int16_t* __restrict__ ms,          // (blocks + 1, nspb, L)
                            const int32_t* __restrict__ seed_index,  // (L,)
                            const int32_t* __restrict__ seed_history,// (L, 4)
                            const int32_t* __restrict__ seed_weight, // (L, 4)
                            const int32_t* __restrict__ step_table,  // (256,)
                            const int32_t* __restrict__ index_table, // (2**BPS,)
                            const Bank bank, int num_lanes, int nspb, int num_channels) {
  __shared__ int32_t s_step[kStepTableSize];
  const Tables<BPS> tb = stage_tables<BPS>(s_step, step_table, index_table);

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;
  const int64_t L = num_lanes;
  const Feed f = bank.feed(lane, num_channels, nspb);
  long long sse;
  const State st = measure<BPS>(load_state(seed_index, seed_history, seed_weight, lane),
                                ms + (static_cast<int64_t>(f.blocks) * nspb + kFilterOrder) * L + lane, L,
                                nspb - kFilterOrder, sse, tb);
  int32_t* h = bank.end_history + 4 * f.slot_lane;
  int32_t* w = bank.end_weight + 4 * f.slot_lane;
  h[0] = st.h0;
  h[1] = st.h1;
  h[2] = st.h2;
  h[3] = st.h3;
  w[0] = st.w0;
  w[1] = st.w1;
  w[2] = st.w2;
  w[3] = st.w3;
  bank.end_index[f.slot_lane] = st.idx;
}

// The dynamic shared memory a lane of the paired schedule takes: packed,
// two copies of its share of a block's data regions; unpacked, its
// speculative codes (T bytes); and, staged, its two sample tiles (4 nspb
// bytes).
inline int64_t paired_lane_bytes(int nspb, int bits_per_sample, bool packed, bool staged) {
  const int64_t codes = nspb - kFilterOrder;
  return (packed ? 2 * (codes * bits_per_sample / 8) : codes) + (staged ? 4 * int64_t{nspb} : 0);
}

// Lanes a CTA of the paired schedule holds, up to kPairLanes and whole rows
// of C lanes, whose bytes fit kPairedBytes. 0 if a row does not fit.
inline int paired_lanes_per_cta(int64_t lane_bytes, int num_channels) {
  int per_cta = kPairLanes;
  while (per_cta > 0 && per_cta * lane_bytes > kPairedBytes) per_cta /= 2;
  return per_cta >= num_channels ? per_cta : 0;
}

// A launch of aad_encode_stream's schedule: paired where the trial search
// warms on the previous block (and a lane fits a CTA), staged where the
// launch is narrow; serial where per_cta is 0.
struct Schedule {
  int per_cta;
  bool staged;
  size_t smem;  // dynamic shared memory a paired CTA
};

inline Schedule schedule(int nspb, int bits_per_sample, bool packed, int num_trials, bool warm_on_prev,
                         int num_lanes, int num_channels) {
  const auto lane_bytes = [&](bool stage) { return paired_lane_bytes(nspb, bits_per_sample, packed, stage); };
  const bool paired = num_trials > 0 && warm_on_prev;
  const bool staged = paired && num_lanes <= kStageMaxLanes && paired_lanes_per_cta(lane_bytes(true), num_channels) > 0;
  const int per_cta = paired ? paired_lanes_per_cta(lane_bytes(staged), num_channels) : 0;
  return Schedule{per_cta, staged, static_cast<size_t>(per_cta * lane_bytes(staged))};
}

// One launch of kernel 3 on stream s in schedule sc; the bank mode has the
// paired schedule only.
template <int BPS, bool kPacked, bool kWire, bool kBank = false>
cudaError_t launch_stream(const Schedule& sc, cudaStream_t s, const void* samples, const void* prev0,
                          const void* valid, const void* step_index, const void* history, const void* weight,
                          const void* step_table, const void* index_table, void* codes, void* headers, void* states,
                          int num_blocks, int num_lanes, int nspb, int num_channels, int num_trials,
                          int warm_on_prev, int blocks_before, const Wire& wire, const Bank& bank = Bank{}) {
  const auto* x = static_cast<const int16_t*>(samples);
  const auto* p0 = static_cast<const int16_t*>(prev0);
  const auto* va = static_cast<const int32_t*>(valid);
  const auto* si = static_cast<const int32_t*>(step_index);
  const auto* hi = static_cast<const int32_t*>(history);
  const auto* we = static_cast<const int32_t*>(weight);
  const auto* st = static_cast<const int32_t*>(step_table);
  const auto* it = static_cast<const int32_t*>(index_table);
  auto* co = static_cast<uint8_t*>(codes);
  auto* hd = static_cast<int32_t*>(headers);
  auto* bs = static_cast<int32_t*>(states);
  if (sc.per_cta > 0) {
    const dim3 grid((num_lanes + sc.per_cta - 1) / sc.per_cta), block(2 * sc.per_cta);
    if (sc.staged) {
      encode_stream_paired_kernel<BPS, true, kPacked, kWire, kBank><<<grid, block, sc.smem, s>>>(
          x, p0, va, si, hi, we, st, it, co, hd, bs, num_blocks, num_lanes, nspb, num_channels, num_trials,
          blocks_before, wire, bank);
    } else {
      encode_stream_paired_kernel<BPS, false, kPacked, kWire, kBank><<<grid, block, sc.smem, s>>>(
          x, p0, va, si, hi, we, st, it, co, hd, bs, num_blocks, num_lanes, nspb, num_channels, num_trials,
          blocks_before, wire, bank);
    }
  } else if constexpr (kBank) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((num_lanes + kEncodeThreads - 1) / kEncodeThreads);
    encode_stream_kernel<BPS, kPacked, kWire><<<grid, dim3(kEncodeThreads), 0, s>>>(
        x, p0, va, si, hi, we, st, it, co, hd, bs, num_blocks, num_lanes, nspb, num_channels, num_trials,
        warm_on_prev, blocks_before, wire);
  }
  return cudaGetLastError();
}

}  // namespace aad

extern "C" {

// codes: (B, L / C, row_bytes), the data region of each block's row of C
// lanes, packed (C 1 or 2); or (B, T, L), one code a byte, time-major (C 1).
int aad_encode_stream(const void* samples, const void* prev0, const void* valid,
                      const void* step_index, const void* history, const void* weight,
                      const void* step_table, const void* index_table, void* codes, void* headers,
                      void* states, int num_blocks, int num_lanes, int nspb, int num_channels,
                      int bits_per_sample, int packed, int num_trials, int warm_on_prev,
                      int blocks_before, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_channels < 1 || num_channels > 2 || num_lanes % num_channels != 0 || (!packed && num_channels != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const aad::Schedule sc =
      aad::schedule(nspb, bits_per_sample, packed, num_trials, warm_on_prev, num_lanes, num_channels);
  const auto launch = [&](auto bps, auto pack) {
    return aad::launch_stream<decltype(bps)::value, decltype(pack)::value, false>(
        sc, static_cast<cudaStream_t>(stream), samples, prev0, valid, step_index, history, weight, step_table,
        index_table, codes, headers, states, num_blocks, num_lanes, nspb, num_channels, num_trials, warm_on_prev,
        blocks_before, aad::Wire{});
  };
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    return packed ? launch(bps, std::true_type{}) : launch(bps, std::false_type{});
  }));
}

// Kernel 3's wire mode (aad::Wire), the trial search warming on the
// previous block: pcm (L / C, C, n) int16 in; ms (B, nspb, L) int16, rows
// (B, L / C, block_bytes) uint8 and the last block's header state
// (seed_index (L,), seed_history and seed_weight (L, 4) int32) out. The
// initial state and prev0 (nspb, L) are the carry's; all four null for a
// stream's first blocks (blocks_before 0): a zero state.
int aad_encode_stream_wire(const void* pcm, long long n, const void* prev0, const void* step_index,
                           const void* history, const void* weight, const void* step_table,
                           const void* index_table, void* ms, void* rows, void* seed_index, void* seed_history,
                           void* seed_weight, int num_blocks, int num_lanes, int nspb, int num_channels,
                           int bits_per_sample, int block_bytes, int mid_side, int num_trials, int blocks_before,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_channels < 1 || num_channels > 2 || num_lanes % num_channels != 0 || (mid_side && num_channels != 2) ||
      (step_index == nullptr && blocks_before != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const aad::Schedule sc = aad::schedule(nspb, bits_per_sample, true, num_trials, true, num_lanes, num_channels);
  const aad::Wire wire{static_cast<const int16_t*>(pcm), static_cast<int16_t*>(ms), static_cast<uint8_t*>(rows),
                       static_cast<int32_t*>(seed_index), static_cast<int32_t*>(seed_history),
                       static_cast<int32_t*>(seed_weight), n,
                       static_cast<long long>(num_lanes / num_channels) * block_bytes, block_bytes, mid_side};
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    return aad::launch_stream<decltype(bps)::value, true, true>(
        sc, static_cast<cudaStream_t>(stream), nullptr, prev0, nullptr, step_index, history, weight, step_table,
        index_table, nullptr, nullptr, nullptr, num_blocks, num_lanes, nspb, num_channels, num_trials, 1,
        blocks_before, wire);
  }));
}

// Kernel 3's bank mode (aad::Bank): feeds (F, kBankFields) int32 and the
// tick's pcm in; the bank's prev (nspb, slot_lanes) int16 and end state
// (end_index (slot_lanes,), end_history and end_weight (slot_lanes, 4) int32)
// read for carried feeds, prev rewritten for every feed; ms (num_blocks + 1,
// nspb, L) int16, rows (the feeds' payloads end to end) uint8 and the feeds'
// last blocks' header states (seed_*, (L, ...)) out. num_blocks is the most
// blocks of a feed; L = F * C. Needs the paired schedule (num_trials > 0
// and a lane that fits a paired CTA): else cudaErrorInvalidValue.
int aad_encode_stream_bank(const void* feeds, const void* pcm, long long channel_stride, void* prev,
                           void* end_index, void* end_history, void* end_weight, long long slot_lanes,
                           const void* step_table, const void* index_table, void* ms, void* rows, void* seed_index,
                           void* seed_history, void* seed_weight, int num_blocks, int num_lanes, int nspb,
                           int num_channels, int bits_per_sample, int block_bytes, int mid_side, int num_trials,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_channels < 1 || num_channels > 2 || num_lanes % num_channels != 0 || (mid_side && num_channels != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const aad::Schedule sc = aad::schedule(nspb, bits_per_sample, true, num_trials, true, num_lanes, num_channels);
  const aad::Wire wire{nullptr, static_cast<int16_t*>(ms), static_cast<uint8_t*>(rows),
                       static_cast<int32_t*>(seed_index), static_cast<int32_t*>(seed_history),
                       static_cast<int32_t*>(seed_weight), 0, 0, block_bytes, mid_side};
  const aad::Bank bank{static_cast<const int32_t*>(feeds), static_cast<const int16_t*>(pcm),
                       static_cast<int16_t*>(prev), static_cast<int32_t*>(end_index),
                       static_cast<int32_t*>(end_history), static_cast<int32_t*>(end_weight), channel_stride,
                       slot_lanes};
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    return aad::launch_stream<decltype(bps)::value, true, true, true>(
        sc, static_cast<cudaStream_t>(stream), nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, step_table,
        index_table, nullptr, nullptr, nullptr, num_blocks, num_lanes, nspb, num_channels, num_trials, 1, 0, wire,
        bank);
  }));
}

// Kernel 4's bank instance: the feeds' end states from seed_* and ms, as
// aad_encode_stream_bank left them, into the bank's end state by slot.
int aad_encode_pass_bank(const void* feeds, const void* ms, const void* seed_index, const void* seed_history,
                         const void* seed_weight, const void* step_table, const void* index_table, void* end_index,
                         void* end_history, void* end_weight, int num_lanes, int nspb, int num_channels,
                         int bits_per_sample, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_channels < 1 || num_channels > 2 || num_lanes % num_channels != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const aad::Bank bank{static_cast<const int32_t*>(feeds), nullptr, nullptr, static_cast<int32_t*>(end_index),
                       static_cast<int32_t*>(end_history), static_cast<int32_t*>(end_weight), 0, 0};
  const dim3 grid((num_lanes + aad::kEncodeThreads - 1) / aad::kEncodeThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    aad::bank_encode_pass_kernel<decltype(bps)::value><<<grid, dim3(aad::kEncodeThreads), 0, s>>>(
        static_cast<const int16_t*>(ms), static_cast<const int32_t*>(seed_index),
        static_cast<const int32_t*>(seed_history), static_cast<const int32_t*>(seed_weight),
        static_cast<const int32_t*>(step_table), static_cast<const int32_t*>(index_table), bank, num_lanes, nspb,
        num_channels);
    return cudaGetLastError();
  }));
}

int aad_encode_pass(const void* samples, const void* step_index, const void* history,
                    const void* weight, const void* valid, const void* step_table,
                    const void* index_table, void* codes, void* step_index_out,
                    void* history_out, void* weight_out, void* sse_out, int num_lanes,
                    int num_codes, int bits_per_sample, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((num_lanes + aad::kEncodeThreads - 1) / aad::kEncodeThreads);
  const dim3 block(aad::kEncodeThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    aad::encode_pass_kernel<decltype(bps)::value><<<grid, block, 0, s>>>(
        static_cast<const int16_t*>(samples), static_cast<const int32_t*>(step_index),
        static_cast<const int32_t*>(history), static_cast<const int32_t*>(weight),
        static_cast<const int32_t*>(valid), static_cast<const int32_t*>(step_table),
        static_cast<const int32_t*>(index_table), static_cast<uint8_t*>(codes),
        static_cast<int32_t*>(step_index_out), static_cast<int32_t*>(history_out),
        static_cast<int32_t*>(weight_out), static_cast<long long*>(sse_out), num_lanes,
        num_codes);
    return cudaGetLastError();
  }));
}

}  // extern "C"
