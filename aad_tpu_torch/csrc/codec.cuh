// Codec constants, table access, the LMS recurrence and the staged row
// output shared by the decode and encode kernels.
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cseman.cuh"

namespace aad {

// Codec constants (aad_tpu_torch/constants.py).
constexpr int kFilterOrder = 4;
constexpr int32_t kFixedHalf = 1 << 14;  // FIXEDPOINT_0_5
constexpr int kFixedDigits = 15;         // FIXEDPOINT_DIGITS
constexpr int kWeightShift = 15 + 3;     // FIXEDPOINT_DIGITS + LMSFILTER_SHIFT
constexpr int32_t kTablesHalf = 1 << 3;  // TABLES_FLOAT_0_5
constexpr int kTablesDigits = 4;         // TABLES_FLOAT_DIGITS
constexpr int32_t kStepIndexMax = 4080;  // STEP_INDEX_MAX
constexpr int kStepTableSize = 256;      // STEPSIZE_TABLE_SIZE

// Copy a table into shared memory, all threads of the block taking part.
__device__ __forceinline__ void stage_table(int32_t* dst, const int32_t* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// fn(std::integral_constant<int, BPS>{}) for bits_per_sample in {2, 3, 4};
// returns what fn returns.
template <typename Fn>
cudaError_t dispatch_bps(int bits_per_sample, Fn fn) {
  switch (bits_per_sample) {
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Ask for all of the SM's shared memory for `kernel` (L1 takes the rest),
// once per kernel and device: with a smaller carveout fewer of the staged
// CTAs (codec.cuh::run_rows) fit an SM. `done` is the kernel's own set, one
// bit a device.
template <class Kernel>
cudaError_t prefer_shared_once(Kernel* kernel, int device, std::atomic<uint64_t>& done) {
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Step size for a Q4 step index in [0, 4080] (reference: src/aad_tables.h:15,28).
__device__ __forceinline__ int32_t stepsize_from_index(const int32_t* s_step, int32_t idx) {
  return s_step[(idx + kTablesHalf) >> kTablesDigits];
}

// The 4-tap sign-LMS predictor of one lane, history newest first
// (reference decoder: src/aad_decoder.c:291-315). Every product and sum
// wraps as in the C build.
struct Lms {
  int32_t h0, h1, h2, h3, w0, w1, w2, w3;

  // One sample from its quantised difference; shifts it into the history.
  __device__ __forceinline__ int32_t step(int32_t qd) {
    int32_t acc = wadd(kFixedHalf, wmul(h0, w0));
    acc = wadd(acc, wmul(h1, w1));
    acc = wadd(acc, wmul(h2, w2));
    acc = wadd(acc, wmul(h3, w3));
    const int32_t s = clip16(wadd(qd, asr(acc, kFixedDigits)));
    w0 = wadd(w0, asr(wadd(wmul(qd, h0), kFixedHalf), kWeightShift));
    w1 = wadd(w1, asr(wadd(wmul(qd, h1), kFixedHalf), kWeightShift));
    w2 = wadd(w2, asr(wadd(wmul(qd, h2), kFixedHalf), kWeightShift));
    w3 = wadd(w3, asr(wadd(wmul(qd, h3), kFixedHalf), kWeightShift));
    h3 = h2;
    h2 = h1;
    h1 = h0;
    h0 = s;
    return s;
  }
};

// Lane state from (L,) / (L, 4) int32 arrays; zeros for a lane past the end.
__device__ __forceinline__ Lms load_lms(const int32_t* __restrict__ history,
                                        const int32_t* __restrict__ weight, int lane, bool active) {
  if (!active) return Lms{};
  const int32_t* h = history + 4 * static_cast<int64_t>(lane);
  const int32_t* w = weight + 4 * static_cast<int64_t>(lane);
  return Lms{h[0], h[1], h[2], h[3], w[0], w[1], w[2], w[3]};
}

// ---------------------------------------------------------------------------
// Staged row output of the decode kernels (aad_decode_lanes, aad_lms_lanes).
//
// Both write (L, T + 4) int16 rows, one thread a lane: the four head samples
// (history reversed), then one sample a step. A thread storing its own
// samples straight to device memory sends every warp store to 32 rows
// (T + 4) * 2 bytes apart, 32 partial sectors for 64 bytes. Instead each
// thread writes its samples, two a 32-bit word, into a tile of kTileSteps
// row positions in shared memory, and every kTileSteps positions the block
// writes the tile out as whole row segments: a warp takes one row at a time,
// its threads consecutive 4-byte words of it (128 bytes a warp store), or
// consecutive 2-byte samples where an odd row length leaves the rows only
// 2-byte aligned. The tile is double-buffered, so one barrier a tile orders
// it: a thread computes tile j + 1 while other warps still write out tile j.

constexpr int kLanesPerBlock = 64;  // lanes (threads) a CTA: 58,066 lanes -> 908 CTAs, 6.9 an SM
constexpr int kTileSteps = 64;      // row positions a tile: 128 bytes of a row
// Row pitch in 32-bit words. Odd, so the 32 threads of a warp, each writing
// the same position of its own row, hit 32 different banks.
constexpr int kTileWords = kTileSteps / 2 + 1;
static_assert(kTileSteps % 4 == 0 && kTileSteps > kFilterOrder, "tile positions");
static_assert(kLanesPerBlock % 32 == 0, "whole warps");

using OutTile = uint32_t[kLanesPerBlock][kTileWords];

__device__ __forceinline__ uint32_t pack_pair(int32_t lo, int32_t hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

// Write positions [p0, p1) of the block's rows (lanes lane0...) from a tile.
__device__ __forceinline__ void write_tile(const OutTile& tile, int16_t* __restrict__ out, int lane0,
                                           int num_lanes, int row_len, int p0, int p1) {
  constexpr int kWarps = kLanesPerBlock / 32;
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int rows = min(kLanesPerBlock, num_lanes - lane0);
  if (row_len % 2 == 0) {  // p0 is even too: rows of 4-byte words
    const int n = (p1 - p0) / 2;
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    for (int i = warp; i < rows; i += kWarps) {
      uint32_t* dst = o + (static_cast<int64_t>(lane0 + i) * row_len + p0) / 2;
      for (int w = t; w < n; w += 32) dst[w] = tile[i][w];
    }
  } else {
    const int n = p1 - p0;
    for (int i = warp; i < rows; i += kWarps) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(tile[i]);
      int16_t* dst = out + static_cast<int64_t>(lane0 + i) * row_len + p0;
      for (int k = t; k < n; k += 32) dst[k] = static_cast<int16_t>(src[k]);
    }
  }
}

// Run every lane of the block over its row of num_steps + 4 positions,
// staging the output through `tiles`. All threads of the block must call
// it, those past num_lanes too: they take part in the barriers and the
// cooperative copies and compute nothing. The lane type provides
//   head(row)      the four head samples, as two words at row[0..1];
//   step(j, t, k)  the sample of step t, the k-th step of tile j;
//   fetch(j)       start the block's copies of tile j's inputs (all threads);
//   wait()         wait for this thread's copies.
template <class Lane>
__device__ __forceinline__ void run_rows(Lane& lane, OutTile* tiles, int16_t* __restrict__ out,
                                         int lane0, int num_lanes, int num_steps) {
  const int row_len = num_steps + kFilterOrder;
  const int num_tiles = (row_len + kTileSteps - 1) / kTileSteps;
  const bool active = lane0 + static_cast<int>(threadIdx.x) < num_lanes;
  lane.fetch(0);
  lane.wait();
  __syncthreads();
  for (int j = 0; j < num_tiles; ++j) {
    // the inputs of tile j + 1 fly while tile j computes; their buffer was
    // last read before the previous barrier
    if (j + 1 < num_tiles) lane.fetch(j + 1);
    const int p0 = j * kTileSteps;
    const int p1 = min(p0 + kTileSteps, row_len);
    const int ps = j == 0 ? kFilterOrder : p0;  // first computed position
    if (active) {
      uint32_t* row = tiles[j & 1][threadIdx.x];
      if (j == 0) lane.head(row);
      uint32_t* w = row + (ps - p0) / 2;
      const int t0 = ps - kFilterOrder;
      const int n = p1 - ps;
      int k = 0;
#pragma unroll 4
      for (; k + 1 < n; k += 2) {
        const int32_t a = lane.step(j, t0 + k, k);
        const int32_t b = lane.step(j, t0 + k + 1, k + 1);
        w[k / 2] = pack_pair(a, b);
      }
      if (k < n) w[k / 2] = pack_pair(lane.step(j, t0 + k, k), 0);
    }
    lane.wait();
    // tile j is complete and tile j + 1's inputs have landed; every thread
    // has also finished writing out tile j - 1, so its buffer is free
    __syncthreads();
    write_tile(tiles[j & 1], out, lane0, num_lanes, row_len, p0, p1);
  }
}

// The head words of a row: history reversed, oldest first.
__device__ __forceinline__ void write_head(uint32_t* row, const Lms& s) {
  row[0] = pack_pair(s.h3, s.h2);
  row[1] = pack_pair(s.h1, s.h0);
}

// Asynchronous 4-byte copy from device to shared memory (cp.async, sm_80+);
// only `src_bytes` bytes are read, the rest of the word is zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace aad
