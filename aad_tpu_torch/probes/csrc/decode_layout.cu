// Hand-written Hopper (sm_90a) kernels of the decode-layout probe: kernel 8
// of the port's kernel table, aad_probe_decode_layout.
//
// They replace the Pallas TPU kernels of benchmarks/probe_decode_layout.py:
// the fused decode from a given state (aad_tpu/ops/pallas_decode.py::
// _make_kernel) in three output layouts, A (natural, pallas_call at :88),
// C (lane-major, kernel_transposed, :134) and B2 (tile-major,
// kernel_tilemajor, :224); with R lanes a working set (the R-interleave,
// :345); and with one stage of the step replaced (probe_kernel, :317, the K
// modes; not bit-exact with the decode, by design):
//   full         the decode step;
//   no_stepsize  step size 1024 + idx in place of the table;
//   no_delta     idx = min(4080, idx + mag) in place of the index table;
//   no_weights   no weight update.
// Each mode's time saved against full is that stage's share of the step.
//
// Input: time-major (W, L) 32-bit words, code k of a word at bits 4k; the
// step index (L,), history (4, L) newest first and weights (4, L). Layouts:
//   natural     (8W, L): a warp's 32 lanes store 64 consecutive bytes a step;
//   lane_major  (L, 8W), each lane's row: staged through shared memory as
//               kernel 1 stages its rows (csrc/codec.cuh: a 64-step tile of
//               the CTA's rows, double-buffered, written out as whole row
//               segments, 128 bytes a warp store);
//   tile_major  (ceil(L / 64), 8W, 64): the CTA's 64 lanes are the tile, so
//               a step's output for a tile is one 128-byte line; the lanes
//               past L of the last tile are written as 0.
// R in {1, 2, 4, 8} is R lanes a thread, 64 R lanes a CTA (thread t takes
// lanes t, t + 64, ...): R independent chains in one thread's instruction
// stream, against the R times more warps that R = 1 gives the scheduler.
//
// What bounds it on an H100: at the probe's 65,536 lanes x 128 words the
// bytes (33.6 MB in, 134.2 MB out) take 0.0501 ms at 3.35 TB/s; chip_smoke.py
// counts each instance's compiled loop by pipe (cuobjdump -sass) for its
// issue bound. Every product and sum wraps as in C (cseman.cuh): h * w and
// qdiff * h overflow on the probe's random states.
//
// The entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns the cudaError_t of
// the launch.

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "probes.cuh"

namespace aad {
namespace probe {

enum Layout : int { kNatural = 0, kLaneMajor = 1, kTileMajor = 2 };
enum Mode : int { kFull = 0, kNoStepsize = 1, kNoDelta = 2, kNoWeights = 3 };

constexpr int kCta = kLanesPerBlock;  // threads a CTA (64), and the tile of tile_major

// One lane's chain under mode M (probe_decode_layout.py:273-308).
template <int M>
struct Chain {
  Lms lms;
  int32_t idx;

  __device__ __forceinline__ int32_t step(int32_t code, const int32_t* s_step, const int32_t* s_delta) {
    const int32_t mag = code & kAbsMask;
    const int32_t stepsize = M == kNoStepsize ? 1024 + idx : stepsize_from_index(s_step, idx);
    const int32_t qmag = (stepsize * ((mag << 1) + 1)) >> (kBps - 1);
    const int32_t qd = (code & kSignBit) ? -qmag : qmag;
    idx = M == kNoDelta ? min(kStepIndexMax, idx + mag) : clip(idx + s_delta[code], 0, kStepIndexMax);
    if constexpr (M == kNoWeights) {
      int32_t acc = wadd(kFixedHalf, wmul(lms.h0, lms.w0));
      acc = wadd(acc, wmul(lms.h1, lms.w1));
      acc = wadd(acc, wmul(lms.h2, lms.w2));
      acc = wadd(acc, wmul(lms.h3, lms.w3));
      const int32_t s = clip16(wadd(qd, asr(acc, kFixedDigits)));
      lms.h3 = lms.h2;
      lms.h2 = lms.h1;
      lms.h1 = lms.h0;
      lms.h0 = s;
      return s;
    } else {
      return lms.step(qd);
    }
  }
};

template <int LAYOUT, int R, int M>
__global__ void __launch_bounds__(kCta)
    layout_kernel(const uint32_t* __restrict__ words,       // (W, L)
                  const int32_t* __restrict__ step_index,   // (L,)
                  const int32_t* __restrict__ history,      // (4, L), newest first
                  const int32_t* __restrict__ weight,       // (4, L)
                  const int32_t* __restrict__ step_table,   // (256,)
                  const int32_t* __restrict__ index_table,  // (16,)
                  int16_t* __restrict__ out, int num_words, int num_lanes) {
  static_assert(LAYOUT == kNatural || R == 1, "only the natural layout takes R lanes a thread");
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[kIndexTableSize];
  __shared__ std::conditional_t<LAYOUT == kLaneMajor, OutTile[2], int32_t[1]> s_out;
  stage_tables(s_step, s_delta, step_table, index_table);

  const int64_t L = num_lanes;
  const int lane0 = blockIdx.x * kCta * R;
  Chain<M> c[R];
  int lane[R];
  bool active[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lane[i] = lane0 + i * kCta + static_cast<int>(threadIdx.x);
    active[i] = lane[i] < num_lanes;
    c[i] = Chain<M>{active[i] ? Lms{history[lane[i]], history[L + lane[i]], history[2 * L + lane[i]],
                                    history[3 * L + lane[i]], weight[lane[i]], weight[L + lane[i]],
                                    weight[2 * L + lane[i]], weight[3 * L + lane[i]]}
                              : Lms{},
                    active[i] ? clip(step_index[lane[i]], 0, kStepIndexMax) : 0};
  }

  if constexpr (LAYOUT == kLaneMajor) {
    // every kTileSteps / 8 words the CTA writes its staged rows out
    constexpr int kTileWordsIn = kTileSteps / kCodesPerWord;
    const int row_len = kCodesPerWord * num_words;
    const int num_tiles = (num_words + kTileWordsIn - 1) / kTileWordsIn;
    const RowMap rows{lane0, 0, kCta, min(kCta, num_lanes - lane0)};
    for (int j = 0; j < num_tiles; ++j) {
      const int w0 = j * kTileWordsIn;
      const int w1 = min(w0 + kTileWordsIn, num_words);
      if (active[0]) {
        uint32_t* row = s_out[j & 1][threadIdx.x];
        for (int i = w0; i < w1; ++i) {
          const uint32_t word = __ldg(words + i * L + lane[0]);
#pragma unroll
          for (int k = 0; k < kCodesPerWord; k += 2) {
            const int32_t a = c[0].step(code_of(word, k), s_step, s_delta);
            const int32_t b = c[0].step(code_of(word, k + 1), s_step, s_delta);
            row[(i - w0) * (kCodesPerWord / 2) + k / 2] = pack_pair(a, b);
          }
        }
      }
      // tile j is complete; every thread has written out tile j - 1, so its buffer is free
      __syncthreads();
      write_tile(s_out[j & 1], out, rows, row_len, w0 * kCodesPerWord, w1 * kCodesPerWord);
    }
  } else {
    // natural: a thread with no lane leaves (no barrier follows), so at R = 1
    // the stores need no predicate; left to the compiler, it made branches
    // of them in one mode and not in the others
    if (LAYOUT == kNatural && !active[0]) return;
    for (int i = 0; i < num_words; ++i) {
      uint32_t word[R];
#pragma unroll
      for (int r = 0; r < R; ++r) word[r] = active[r] ? __ldg(words + i * L + lane[r]) : 0u;
#pragma unroll
      for (int k = 0; k < kCodesPerWord; ++k) {
        const int64_t t = kCodesPerWord * i + k;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int32_t s = c[r].step(code_of(word[r], k), s_step, s_delta);
          if constexpr (LAYOUT == kNatural) {
            if (R == 1 || active[r]) out[t * L + lane[r]] = static_cast<int16_t>(s);
          } else {  // tile_major: tile blockIdx.x, row t, column threadIdx.x
            out[(blockIdx.x * (kCodesPerWord * static_cast<int64_t>(num_words)) + t) * kCta + threadIdx.x] =
                active[r] ? static_cast<int16_t>(s) : int16_t{0};
          }
        }
      }
    }
  }
}

template <int LAYOUT, int R, int M>
cudaError_t launch_layout(const void* words, const void* step_index, const void* history, const void* weight,
                          const void* step_table, const void* index_table, void* out, int num_words,
                          int num_lanes, int device, cudaStream_t stream) {
  const auto kernel = layout_kernel<LAYOUT, R, M>;
  static std::atomic<uint64_t> carveout_set{0};  // one set for each instance
  const cudaError_t err = prefer_shared_once(kernel, device, carveout_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_lanes + kCta * R - 1) / (kCta * R));
  kernel<<<grid, kCta, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(step_index),
      static_cast<const int32_t*>(history), static_cast<const int32_t*>(weight),
      static_cast<const int32_t*>(step_table), static_cast<const int32_t*>(index_table),
      static_cast<int16_t*>(out), num_words, num_lanes);
  return cudaGetLastError();
}

}  // namespace probe
}  // namespace aad

extern "C" {

// words: (W, L) 32-bit code words; step_index (L,), history and weight
// (4, L) int32; out as `layout` (0 natural, 1 lane_major, 2 tile_major);
// mode: 0 full, 1 no_stepsize, 2 no_delta, 3 no_weights. Only the probe's
// combinations are built: the three layouts at R = 1 and full, R = 2, 4, 8
// natural and full, the three ablations natural at R = 1.
int aad_probe_decode_layout(const void* words, const void* step_index, const void* history, const void* weight,
                            const void* step_table, const void* index_table, void* out, int num_words,
                            int num_lanes, int layout, int r, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace aad::probe;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return static_cast<int>(launch(words, step_index, history, weight, step_table, index_table, out, num_words,
                                   num_lanes, device, s));
  };
  if (r == 1 && mode == kFull) {
    if (layout == kNatural) return args(launch_layout<kNatural, 1, kFull>);
    if (layout == kLaneMajor) return args(launch_layout<kLaneMajor, 1, kFull>);
    if (layout == kTileMajor) return args(launch_layout<kTileMajor, 1, kFull>);
  }
  if (layout == kNatural && mode == kFull) {
    if (r == 2) return args(launch_layout<kNatural, 2, kFull>);
    if (r == 4) return args(launch_layout<kNatural, 4, kFull>);
    if (r == 8) return args(launch_layout<kNatural, 8, kFull>);
  }
  if (layout == kNatural && r == 1) {
    if (mode == kNoStepsize) return args(launch_layout<kNatural, 1, kNoStepsize>);
    if (mode == kNoDelta) return args(launch_layout<kNatural, 1, kNoDelta>);
    if (mode == kNoWeights) return args(launch_layout<kNatural, 1, kNoWeights>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
