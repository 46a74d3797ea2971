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
// 588-655). With warm_on_prev == 0 (the block-parallel mode, every block a
// stream head) trial 1's measure is the baseline's, so its end state is
// reused and trials=N costs N measure passes plus the emit. Optionally it
// writes every block's final state (the warm passes' source).
//
// aad_encode_pass replaces the per-pass Pallas TPU kernel
// aad_tpu/ops/pallas_encode.py::_make_kernel (launched by
// _encode_scan_tiles_impl): one measure or emit pass over one block per
// lane, the state and error frozen past each lane's valid count. It returns
// the final state, the int64 error sum and, in the emit variant, the codes.
// Both kernels run the same per-sample step, encode_step below.
//
// What bounds them on an H100: each lane is one dependent chain of about 60
// integer operations per sample and pass, and lanes are independent; a lane
// reads 2 bytes and writes at most 1 per sample and pass. So the work is
// bound by integer issue and by the latency of the chain, not by bytes. The
// design follows: one thread per lane with the whole state in registers, the
// block sequence a loop inside the thread, samples read int16 and
// time-major so that a warp's 32 lanes read 64 consecutive bytes per step,
// codes written time-major (32 consecutive bytes per step), the previous
// block re-read in place (never copied), and both tables staged per CTA in
// shared memory. 64 threads per CTA spread the main path's 58,066 lanes over
// all 132 SMs. The quantiser min(scaled / step, absmask) is a binary search
// on the quotient's bps-1 bits instead of a division: scaled is at most
// 98,303 << 2 (an int16 sample minus a prediction in [-65536, 65535]) and
// never negative, and the step is at least 1, so the search equals C's
// truncating division for every input the kernel can be given.
//
// Not carried over from the TPU kernels: the u32 sample-pair and code words,
// the (8, 128) lane tiles and the R-fold lane interleave, pass_stack (its
// semantics are the ordinary trial search computed here), the VMEM
// chunked-DMA variant, the f32 step-size formula with its correction set,
// and the two-limb error sum (int64 here).
//
// Both entry points have a plain C interface (bound with ctypes), launch on
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

struct State {
  int32_t h0, h1, h2, h3;  // history, newest first
  int32_t w0, w1, w2, w3;  // Q15 weights
  int32_t idx;             // Q4 step index
};

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

// One encode step (reference: src/aad_encoder.c:343-410); returns the code
// and leaves the quantised difference in qdiff. The step-size slot is
// clamped to the table, as in every aad_tpu engine, so a forged carry index
// outside [0, 4080] reads slot 0 or 255; the adaptation brings the index back
// into [0, 4080].
template <int BPS>
__device__ __forceinline__ int32_t encode_step(State& s, int32_t sample, const int32_t* s_step,
                                               const int32_t* s_delta, int32_t& qdiff) {
  constexpr int32_t kSignBit = 1 << (BPS - 1);
  const int32_t slot = clip(asr(wadd(s.idx, kTablesHalf), kTablesDigits), 0, kStepTableSize - 1);
  const int32_t step = s_step[slot];

  int32_t acc = wadd(kFixedHalf, wmul(s.h0, s.w0));
  acc = wadd(acc, wmul(s.h1, s.w1));
  acc = wadd(acc, wmul(s.h2, s.w2));
  acc = wadd(acc, wmul(s.h3, s.w3));
  const int32_t pred = asr(acc, kFixedDigits);

  const int32_t diff = wsub(sample, pred);
  const bool neg = diff < 0;
  const int32_t scaled = wshl(neg ? wneg(diff) : diff, BPS - 2);
  // min(scaled / step, kSignBit - 1) by binary search on the quotient bits
  // (exact here: scaled >= 0 and step >= 1, see the note at the top)
  int32_t mag = 0;
#pragma unroll
  for (int bit = BPS - 2; bit >= 0; --bit) {
    const int32_t m = mag | (1 << bit);
    if (scaled >= m * step) mag = m;  // m * step <= 7 * 32767: no overflow
  }
  const int32_t qmag = asr(wmul(step, (mag << 1) + 1), BPS - 1);
  qdiff = neg ? -qmag : qmag;
  const int32_t code = neg ? (mag | kSignBit) : mag;

  // index adaptation (reference: src/aad_tables.h:31-43)
  s.idx = clip(wadd(s.idx, s_delta[code]), 0, kStepIndexMax);
  // reconstruction and sign-LMS update, as the decoder does it
  // (reference: src/aad_encoder.c:391-406)
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

// Measure pass: the first n_live code slots of x (stride `stride`) advance
// the state; sse receives the int64 sum of their wrapped squared errors
// (reference: src/aad_encoder.c:431-467).
template <int BPS>
__device__ __forceinline__ State measure(State s, const int16_t* __restrict__ x, int64_t stride,
                                         int n_live, long long& sse, const int32_t* s_step,
                                         const int32_t* s_delta) {
  long long acc = 0;
#pragma unroll 4
  for (int t = 0; t < n_live; ++t) {
    int32_t qdiff;
    encode_step<BPS>(s, x[t * stride], s_step, s_delta, qdiff);
    acc += wrapped_square(qdiff);
  }
  sse = acc;
  return s;
}

// Emit pass: codes for all n_codes slots; the state and sse advance over the
// first n_live slots, and past them each code comes from the frozen state.
template <int BPS>
__device__ __forceinline__ State emit(State s, const int16_t* __restrict__ x, int64_t stride,
                                      int n_live, int n_codes, uint8_t* __restrict__ codes,
                                      long long& sse, const int32_t* s_step,
                                      const int32_t* s_delta) {
  long long acc = 0;
  int t = 0;
#pragma unroll 4
  for (; t < n_live; ++t) {
    int32_t qdiff;
    codes[t * stride] = static_cast<uint8_t>(encode_step<BPS>(s, x[t * stride], s_step, s_delta, qdiff));
    acc += wrapped_square(qdiff);
  }
  for (; t < n_codes; ++t) {
    State frozen = s;
    int32_t qdiff;
    codes[t * stride] = static_cast<uint8_t>(encode_step<BPS>(frozen, x[t * stride], s_step, s_delta, qdiff));
  }
  sse = acc;
  return s;
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

template <int BPS>
__global__ void __launch_bounds__(kEncodeThreads)
    encode_stream_kernel(const int16_t* __restrict__ samples,    // (B, nspb, L) time-major
                         const int16_t* __restrict__ prev0,      // (nspb, L), or null if unread
                         const int32_t* __restrict__ valid,      // (B, L)
                         const int32_t* __restrict__ step_index, // (L,) initial state
                         const int32_t* __restrict__ history,    // (L, 4)
                         const int32_t* __restrict__ weight,     // (L, 4)
                         const int32_t* __restrict__ step_table, // (256,)
                         const int32_t* __restrict__ index_table,// (2**BPS,)
                         uint8_t* __restrict__ codes,            // (B, nspb - 4, L)
                         int32_t* __restrict__ headers,          // (B, 10, L)
                         int32_t* __restrict__ states,           // (B, 9, L), or null
                         int num_blocks, int num_lanes, int nspb, int num_trials,
                         int warm_on_prev, int blocks_before) {
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[1 << BPS];
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, 1 << BPS);
  __syncthreads();

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;
  const int64_t L = num_lanes;
  const int T = nspb - kFilterOrder;
  State st = load_state(step_index, history, weight, lane);

  for (int b = 0; b < num_blocks; ++b) {
    const int16_t* cur = samples + static_cast<int64_t>(b) * nspb * L + lane;
    const int32_t v = valid[static_cast<int64_t>(b) * L + lane];
    // fewer than 4 valid samples: the reference's early return, state
    // untouched and zero error (src/aad_encoder.c:443-455)
    const bool head_ok = v >= kFilterOrder;
    const int n_live = clip(v - kFilterOrder, 0, T);

    if (num_trials > 0) {
      long long min_sse = 0;
      State measured = st;
      if (head_ok) {
        measured = measure<BPS>(seed(st, cur, L), cur + kFilterOrder * L, L, n_live, min_sse, s_step, s_delta);
      }
      State best = st;
      if (warm_on_prev) {
        const bool has_prev = b + blocks_before >= 1;
        // block 0's previous block is the carry's (prev0), read only then
        const int16_t* prev = b == 0 ? prev0 : samples + static_cast<int64_t>(b - 1) * nspb * L;
        State walker = st;
        for (int i = 0; i < num_trials; ++i) {
          if (has_prev) {  // always the full previous block
            long long unused;
            walker = measure<BPS>(seed(walker, prev + lane, L), prev + lane + kFilterOrder * L, L, T,
                                  unused, s_step, s_delta);
          }
          const State cand = walker;
          long long sse = 0;
          if (head_ok) {
            walker = measure<BPS>(seed(walker, cur, L), cur + kFilterOrder * L, L, n_live, sse, s_step, s_delta);
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
            walker = measure<BPS>(seed(walker, cur, L), cur + kFilterOrder * L, L, n_live, sse, s_step, s_delta);
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
    st = seed(st, cur, L);
    const int32_t shift = round_weights(st);
    int32_t* hdr = headers + static_cast<int64_t>(b) * kHeaderFields * L + lane;
    store_fields(hdr, L, st);
    hdr[9 * L] = shift;

    // data section: every slot of the padded block (src/aad_encoder.c:661-722)
    long long unused;
    st = emit<BPS>(st, cur + kFilterOrder * L, L, T, T, codes + static_cast<int64_t>(b) * T * L + lane,
                   unused, s_step, s_delta);
    if (states != nullptr) {
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
  __shared__ int32_t s_delta[1 << BPS];
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, 1 << BPS);
  __syncthreads();

  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;
  const int64_t L = num_lanes;
  State st = load_state(step_index, history, weight, lane);
  const int n_live = clip(valid[lane] - kFilterOrder, 0, num_codes);
  long long sse;
  if (codes != nullptr) {
    st = emit<BPS>(st, samples + lane, L, n_live, num_codes, codes + lane, sse, s_step, s_delta);
  } else {
    st = measure<BPS>(st, samples + lane, L, n_live, sse, s_step, s_delta);
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

// Calls fn(std::integral_constant<int, BPS>) for bits_per_sample in {2, 3, 4}.
template <typename Fn>
cudaError_t dispatch_bps(int bits_per_sample, Fn fn) {
  switch (bits_per_sample) {
    case 2: fn(std::integral_constant<int, 2>{}); break;
    case 3: fn(std::integral_constant<int, 3>{}); break;
    case 4: fn(std::integral_constant<int, 4>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace aad

extern "C" {

int aad_encode_stream(const void* samples, const void* prev0, const void* valid,
                      const void* step_index, const void* history, const void* weight,
                      const void* step_table, const void* index_table, void* codes, void* headers,
                      void* states, int num_blocks, int num_lanes, int nspb, int bits_per_sample,
                      int num_trials, int warm_on_prev, int blocks_before, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((num_lanes + aad::kEncodeThreads - 1) / aad::kEncodeThreads);
  const dim3 block(aad::kEncodeThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    aad::encode_stream_kernel<decltype(bps)::value><<<grid, block, 0, s>>>(
        static_cast<const int16_t*>(samples), static_cast<const int16_t*>(prev0),
        static_cast<const int32_t*>(valid), static_cast<const int32_t*>(step_index),
        static_cast<const int32_t*>(history), static_cast<const int32_t*>(weight),
        static_cast<const int32_t*>(step_table), static_cast<const int32_t*>(index_table),
        static_cast<uint8_t*>(codes), static_cast<int32_t*>(headers),
        static_cast<int32_t*>(states), num_blocks, num_lanes, nspb, num_trials, warm_on_prev,
        blocks_before);
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
  }));
}

}  // extern "C"
