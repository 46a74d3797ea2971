// Hand-written Hopper (sm_90a) decode kernels for aad_tpu_torch.
//
// aad_decode_lanes replaces the fused Pallas TPU decode kernel
// aad_tpu/ops/pallas_decode.py::_make_kernel (launched by _decode_tiled).
// It computes what that kernel computes, per block x channel lane: step-size
// lookup, quantised difference, index adaptation, the 4-tap sign-LMS
// predictor and the int16 clip, emitting the block's four header samples
// first (reference decoder: src/aad_decoder.c:269-318, 386-391).
//
// What bounds it on an H100: instruction issue. Its compiled step loop
// (4-bit) issues 37 instructions a sample, 16.75 of them on the integer ALU
// and 13.6 IMADs on the FMA pipe (chip_smoke.py counts them from the SASS),
// so at one warp instruction a clock per scheduler the benchmark stream's
// 58,066 lanes x 988 codes take at least 0.063 ms; the bytes (1 in, 2 out a
// sample) take 0.052 ms. Measured there (H100 80GB HBM3, 700 W; PERF.md
// section 6), the first design, one thread a lane storing each sample
// straight into its own row from 256-thread CTAs, took 1.13 ms: bound by
// those stores, each warp store hitting 32 rows 1,984 bytes apart, 32
// partial 32-byte sectors for 64 bytes. 64-lane CTAs alone gave 1.04 ms;
// staging the rows through shared memory 0.34 ms; staging the codes too,
// 0.22 ms, 29% of the issue bound. The design:
// - one thread a lane, the whole state in registers, both tables in shared
//   memory (the int table is exact by construction, so the f32 step-size
//   formula of the TPU kernel and its correction set are not carried over);
// - the output staged through shared memory and written as whole row
//   segments (codec.cuh::run_rows) by 64-lane CTAs, so the lanes spread
//   evenly over 132 SMs (908 CTAs at the benchmark stream, all resident);
// - the codes read in the (B, C, T) order that framing.block_codes gives:
//   every 64 steps the CTA copies each lane's next 64 code bytes into shared
//   memory with cp.async, coalesced along the rows and one tile ahead of the
//   compute, and a thread walks its own row from there. A thread loading its
//   code byte from device memory at every step cost 0.12 ms more, and the
//   time-major (T, L) code layout that such loads need was a 57 MB
//   transpose before every launch, a quarter of the resident decode's
//   device time.
//
// aad_stepsize_probe replaces the TPU correction probe
// aad_tpu/ops/pallas_decode.py::stepsize_corrections (probe_kernel). It
// reads all 256 slots through the same accessor the decode kernel uses, so
// the host can check the staged table against tables.STEPSIZE_TABLE.
//
// The entry points have a plain C interface (bound with ctypes), launch on
// the stream they are given, allocate nothing and return the cudaError_t of
// the launch.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "codec.cuh"
#include "cseman.cuh"

namespace aad {

// A lane's codes of one tile, from the 4-byte boundary at or before them.
constexpr int kCodeTileWords = kTileSteps / 4 + 1;  // odd: conflict-free reads
using CodeTile = uint32_t[kLanesPerBlock][kCodeTileWords];

template <int BPS>
struct DecodeLane {
  static constexpr int32_t kCodeMask = (1 << BPS) - 1;
  static constexpr int32_t kSignBit = 1 << (BPS - 1);
  static constexpr int32_t kAbsMask = kSignBit - 1;

  Lms lms;
  int32_t idx;
  const int32_t* s_step;
  const int32_t* s_delta;
  CodeTile* s_codes;     // two tiles
  const int64_t* s_row;  // first byte of each lane's code row, -1 past the last lane
  const uint8_t* codes;
  int64_t num_bytes;
  int num_codes;
  int skew;  // this lane's row start past its 4-byte boundary

  __device__ __forceinline__ void head(uint32_t* row) const { write_head(row, lms); }

  // Tile j holds steps [t0, t1): 60 in tile 0 (after the head), 64 after.
  // Since t0 is a multiple of 4, a row's words start at its skew.
  __device__ __forceinline__ void fetch(int j) const {
    const int t0 = j == 0 ? 0 : j * kTileSteps - kFilterOrder;
    const int t1 = min((j + 1) * kTileSteps - kFilterOrder, num_codes);
    CodeTile& tile = s_codes[j & 1];
    for (int i = threadIdx.x; i < kLanesPerBlock * kCodeTileWords; i += kLanesPerBlock) {
      const int r = i / kCodeTileWords;
      const int w = i - r * kCodeTileWords;
      const int64_t row = s_row[r];
      const int64_t src = ((row + t0) & ~int64_t{3}) + 4 * w;
      if (row >= 0 && src < row + t1) {
        cp_async4(&tile[r][w], codes + src, static_cast<int>(min(int64_t{4}, num_bytes - src)));
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void wait() const { cp_async_wait_all(); }

  __device__ __forceinline__ int32_t step(int j, int, int k) {
    const uint8_t* c = reinterpret_cast<const uint8_t*>(s_codes[j & 1][threadIdx.x]) + skew;
    const int32_t code = c[k] & kCodeMask;
    // quantised difference (reference: src/aad_decoder.c:284-288)
    const int32_t step = stepsize_from_index(s_step, idx);
    const int32_t qmag = (step * (((code & kAbsMask) << 1) + 1)) >> (BPS - 1);
    const int32_t qdiff = (code & kSignBit) ? -qmag : qmag;
    // index adaptation (reference: src/aad_tables.h:31-43)
    idx = clip(idx + s_delta[code], 0, kStepIndexMax);
    return lms.step(qdiff);
  }
};

template <int BPS>
__global__ void __launch_bounds__(kLanesPerBlock)
    decode_lanes_kernel(const uint8_t* __restrict__ codes,       // (B, C, T)
                        const int32_t* __restrict__ step_index,  // (L,), lane c * B + b
                        const int32_t* __restrict__ history,     // (L, 4), newest first
                        const int32_t* __restrict__ weight,      // (L, 4)
                        const int32_t* __restrict__ step_table,  // (256,)
                        const int32_t* __restrict__ index_table, // (2**BPS,)
                        int16_t* __restrict__ out,               // (L, T + 4)
                        int num_blocks, int num_channels, int num_codes) {
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[1 << BPS];
  __shared__ int64_t s_row[kLanesPerBlock];
  __shared__ CodeTile s_codes[2];
  __shared__ OutTile s_out[2];
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, 1 << BPS);

  const int num_lanes = num_blocks * num_channels;
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int lane = lane0 + static_cast<int>(threadIdx.x);
  const bool active = lane < num_lanes;
  // lane c * B + b is channel c of block b: code row b * C + c
  const int64_t row =
      active ? (static_cast<int64_t>(lane % num_blocks) * num_channels + lane / num_blocks) * num_codes : -1;
  s_row[threadIdx.x] = row;
  __syncthreads();

  // Parse clamp: wire indices in (4080, 4095] pin to the table maximum, as
  // at every header parse; the adaptation keeps idx in [0, 4080].
  DecodeLane<BPS> d{load_lms(history, weight, lane, active),
                    active ? clip(step_index[lane], 0, kStepIndexMax) : 0,
                    s_step, s_delta, s_codes, s_row, codes,
                    static_cast<int64_t>(num_lanes) * num_codes, num_codes, static_cast<int>(row & 3)};
  run_rows(d, s_out, out, lane0, num_lanes, num_codes);
}

__global__ void __launch_bounds__(kStepTableSize)
    stepsize_probe_kernel(const int32_t* __restrict__ step_table, int32_t* __restrict__ out) {
  __shared__ int32_t s_step[kStepTableSize];
  stage_table(s_step, step_table, kStepTableSize);
  __syncthreads();
  const int slot = threadIdx.x;
  out[slot] = stepsize_from_index(s_step, slot << kTablesDigits);
}

}  // namespace aad

extern "C" {

int aad_decode_lanes(const void* codes, const void* step_index, const void* history,
                     const void* weight, const void* step_table, const void* index_table,
                     void* out, int num_blocks, int num_channels, int num_codes,
                     int bits_per_sample, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_lanes = num_blocks * num_channels;
  const dim3 grid((num_lanes + aad::kLanesPerBlock - 1) / aad::kLanesPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    const auto kernel = aad::decode_lanes_kernel<decltype(bps)::value>;
    static std::atomic<uint64_t> carveout_set{0};  // one set for each bps
    const cudaError_t e = aad::prefer_shared_once(kernel, device, carveout_set);
    if (e != cudaSuccess) return e;
    kernel<<<grid, aad::kLanesPerBlock, 0, s>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(step_index),
        static_cast<const int32_t*>(history), static_cast<const int32_t*>(weight),
        static_cast<const int32_t*>(step_table), static_cast<const int32_t*>(index_table),
        static_cast<int16_t*>(out), num_blocks, num_channels, num_codes);
    return cudaGetLastError();
  }));
}

int aad_stepsize_probe(const void* step_table, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  aad::stepsize_probe_kernel<<<1, aad::kStepTableSize, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(step_table), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* aad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
