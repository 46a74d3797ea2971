// Hand-written Hopper (sm_90a) decode kernels for aad_tpu_torch.
//
// aad_decode_lanes replaces the fused Pallas TPU decode kernel
// aad_tpu/ops/pallas_decode.py::_make_kernel (launched by _decode_tiled).
// It computes what that kernel computes, per block x channel lane: step-size
// lookup, quantised difference, index adaptation, the 4-tap sign-LMS
// predictor and the int16 clip, emitting the block's four header samples
// first (reference decoder: src/aad_decoder.c:269-318, 386-391).
//
// Like the TPU kernel, it reads the codes packed, as they lie in each block's
// data region on the wire (_decode_word_step takes each code out of its
// word), so nothing unpacks them before the launch: its input is the (B,
// block_size) block rows of framing.split_blocks, and it takes each lane's
// codes from its block's data region, channels interleaved unit by unit
// (codec.cuh::CodeUnit: 4-bit 1 byte and 2 codes a channel, 2-bit 1 and 4,
// 3-bit 3 and 8). On block rows it also reads each lane's state from its
// block header (framing.parse_block_headers' parse, the step-index clamp
// included), and for a mid/side stream writes left and right in place of
// mid and side (the torch combine of codec/decoder.py on the CPU): a CTA
// holds both channels of its blocks, so the flush pairs them. A decode of
// block rows is then one launch between the upload and the copy down, where
// about 23 torch kernels (the header parse, three lane reorders, the
// combine) took 81% of a live push's host time. The same kernel reads codes
// one a byte, (L, T) rows with no header, their states from the caller: the
// codes-level API (ops/decode.py::decode_blocks).
//
// What bounds it on an H100: instruction issue. Its compiled step loop
// (4-bit, packed) issues 39.1 instructions a sample, 17.5 of them on the
// integer ALU and 15.25 IMADs on the FMA pipe (chip_smoke.py counts them
// from the SASS), so at one warp instruction a clock per scheduler the
// benchmark stream's 58,066 lanes x 988 codes take at least 0.067 ms; the
// bytes (the 29.7 MB of block rows in, 2 bytes a sample out) take 0.043 ms.
// Measured there (H100 80GB HBM3, 700 W; PERF.md section 6), the first
// design, one thread a lane storing each sample straight into its own row
// from 256-thread CTAs, took 1.13 ms: bound by those stores, each
// warp store hitting 32 rows 1,984 bytes apart, 32 partial 32-byte sectors
// for 64 bytes. 64-lane CTAs alone gave 1.04 ms; staging the rows through
// shared memory 0.34 ms; staging the codes too, 0.22 ms; reading them
// packed, 0.21 ms, 32% of the issue bound. The design:
// - one thread a lane, the whole state in registers, both tables in shared
//   memory (the int table is exact by construction, so the f32 step-size
//   formula of the TPU kernel and its correction set are not carried over);
// - the output staged through shared memory and written as whole row
//   segments (codec.cuh::run_rows) by 64-lane CTAs, so the lanes spread
//   evenly over 132 SMs (908 CTAs at the benchmark stream, all resident);
// - a CTA takes every channel of 64 / C consecutive blocks (lane c * B + b
//   is channel c of block b; thread c * 64 / C + i takes block b0 + i), so
//   the bytes of a block's units, both channels interleaved, are read once,
//   by one CTA;
// - every 64 steps the CTA copies the bytes of the next tile's units of each
//   of its blocks into shared memory with cp.async, 4-byte words from the
//   boundary at or before them (a mono data region starts 18 bytes into its
//   block, a 3-bit block may be 1,023 bytes long), one tile ahead of the
//   compute; a thread takes its code out of its unit there (a 3-bit tile
//   starts mid-unit: a tile is 64 steps, the first 60). A thread loading
//   its code from device memory at every step cost 0.12 ms more, and the
//   one-byte-a-code (B, C, T) tensor that an earlier design took cost an
//   unpack of torch ops (0.42 ms, 59% of the resident decode's device time)
//   before every launch.
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

// One thread's lane: channel `channel` of block `slot` of the CTA.
template <int BPS, bool kPacked, int C>
struct DecodeLane {
  using Unit = CodeUnit<BPS, kPacked>;
  static constexpr int32_t kSignBit = 1 << (BPS - 1);
  static constexpr int32_t kAbsMask = kSignBit - 1;
  static constexpr int kBlocks = kLanesPerBlock / C;  // blocks a CTA
  static constexpr int kUnitBytes = C * Unit::kBytes;  // a unit of all channels
  // Units a tile's steps touch, at most (a tile may start mid-unit), and
  // the words a block's share of a tile takes in shared memory, from the
  // 4-byte boundary at or before its first byte; odd, so that the threads
  // of a warp, each reading the same unit of its own block, hit different
  // banks.
  static constexpr int kTileUnits = (kTileSteps + 2 * (Unit::kCodes - 1)) / Unit::kCodes;
  static constexpr int kPitch = ((kTileUnits * kUnitBytes + 3) / 4 + 1) | 1;
  using CodeTile = uint32_t[kBlocks * kPitch];

  Lms lms;
  int32_t idx;
  const int32_t* s_step;
  const int32_t* s_delta;
  CodeTile* s_codes;       // two tiles
  const int64_t* s_row;    // each block's data region in `bytes`, -1 past the last block
  const uint8_t* bytes;    // the rows, from the 4-byte boundary at or before them
  int64_t num_bytes;
  int64_t row;             // this thread's block's data region in `bytes`
  int num_codes;
  int slot;                // this thread's block in the CTA
  int channel_byte;        // its channel's first byte in a unit
  const uint8_t* unit0;    // begin(j): this thread's bytes of tile j's first unit
  int first;               // begin(j): tile j's first step in its unit

  __device__ __forceinline__ void head(uint32_t* row_out) const { write_head(row_out, lms); }

  // Tile j holds steps [t0, t1): 60 in tile 0 (after the head), 64 after.
  static __device__ __forceinline__ int tile_step(int j) { return j == 0 ? 0 : j * kTileSteps - kFilterOrder; }

  // The bytes of the units of steps [t0, t1) of every block of the CTA.
  __device__ __forceinline__ void fetch(int j) const {
    const int t0 = tile_step(j);
    const int t1 = min((j + 1) * kTileSteps - kFilterOrder, num_codes);
    const int64_t lo = static_cast<int64_t>(t0 >> Unit::kShift) * kUnitBytes;
    const int64_t hi = static_cast<int64_t>((t1 + Unit::kCodes - 1) >> Unit::kShift) * kUnitBytes;
    uint32_t* tile = s_codes[j & 1];
    for (int i = threadIdx.x; i < kBlocks * kPitch; i += kLanesPerBlock) {
      const int r = i / kPitch;
      const int w = i - r * kPitch;
      const int64_t start = s_row[r];
      const int64_t src = ((start + lo) & ~int64_t{3}) + 4 * w;
      if (start >= 0 && src < start + hi) {
        cp_async4(&tile[i], bytes + src, static_cast<int>(min(int64_t{4}, num_bytes - src)));
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void wait() const { cp_async_wait_all(); }

  __device__ __forceinline__ void begin(int j) {
    const int t0 = tile_step(j);
    const int64_t lo = static_cast<int64_t>(t0 >> Unit::kShift) * kUnitBytes;
    unit0 = reinterpret_cast<const uint8_t*>(s_codes[j & 1] + slot * kPitch) + ((row + lo) & 3) + channel_byte;
    first = Unit::kCodes > 4 ? t0 & (Unit::kCodes - 1) : 0;  // tiles start at multiples of 4 steps
  }

  __device__ __forceinline__ int32_t step(int, int, int k) {
    const int q = first + k;
    const int32_t code = Unit::read(unit0 + (q >> Unit::kShift) * kUnitBytes, q & (Unit::kCodes - 1));
    // quantised difference (reference: src/aad_decoder.c:284-288)
    const int32_t step = stepsize_from_index(s_step, idx);
    const int32_t qmag = (step * (((code & kAbsMask) << 1) + 1)) >> (BPS - 1);
    const int32_t qdiff = (code & kSignBit) ? -qmag : qmag;
    // index adaptation (reference: src/aad_tables.h:31-43)
    idx = clip(idx + s_delta[code], 0, kStepIndexMax);
    return lms.step(qdiff);
  }
};

// One channel's block header, as framing.parse_block_headers reads it
// (reference: src/aad_decoder.c:363-380): nine big-endian u16 fields at p,
// the tag (step index << 4 | weight shift), then weight and history of each
// tap. The weights are stored shifted right; the shift is applied again.
struct LaneHeader {
  Lms lms;
  int32_t idx;
};

__device__ __forceinline__ int32_t header_u16(const uint8_t* p, int k) {
  return (static_cast<int32_t>(p[2 * k]) << 8) | p[2 * k + 1];
}

__device__ __forceinline__ LaneHeader parse_header(const uint8_t* p) {
  const int32_t tag = header_u16(p, 0);
  const int shift = tag & 0xF;
  const auto tap = [&](int k) { return static_cast<int32_t>(static_cast<int16_t>(header_u16(p, k))); };
  const auto weight = [&](int k) { return static_cast<int32_t>(static_cast<uint32_t>(tap(k)) << shift); };
  // Parse clamp: wire indices in (4080, 4095] pin to the table maximum, as
  // at every header parse; the adaptation keeps idx in [0, 4080].
  return {Lms{tap(2), tap(4), tap(6), tap(8), weight(1), weight(3), weight(5), weight(7)},
          min(tag >> kTablesDigits, kStepIndexMax)};
}

// kPacked: the lanes' states come from the block headers at the head of
// each row (C * kChannelHeaderBytes bytes, channel c's at c * 18), and
// kMidSide writes left/right from the two channels' rows (codec.cuh::
// write_tile). Unpacked: from step_index, history and weight.
template <int BPS, bool kPacked, int C, bool kMidSide>
__global__ void __launch_bounds__(kLanesPerBlock)
    decode_lanes_kernel(const uint8_t* __restrict__ bytes,      // (B, block_bytes) rows, `skew` bytes in
                        const int32_t* __restrict__ step_index, // (L,), lane c * B + b; unpacked only
                        const int32_t* __restrict__ history,    // (L, 4), newest first; unpacked only
                        const int32_t* __restrict__ weight,     // (L, 4); unpacked only
                        const int32_t* __restrict__ step_table, // (256,)
                        const int32_t* __restrict__ index_table,// (2**BPS,)
                        int16_t* __restrict__ out,              // (L, T + 4)
                        int skew, int num_blocks, int num_codes, int block_bytes, int data_offset) {
  static_assert(!kMidSide || (kPacked && C == 2), "mid/side: packed stereo rows");
  using Lane = DecodeLane<BPS, kPacked, C>;
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[1 << BPS];
  __shared__ int64_t s_row[Lane::kBlocks];
  __shared__ typename Lane::CodeTile s_codes[2];
  __shared__ OutTile s_out[2];
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, 1 << BPS);

  const int b0 = blockIdx.x * Lane::kBlocks;
  const int slot = threadIdx.x % Lane::kBlocks;
  const int channel = threadIdx.x / Lane::kBlocks;
  const int b = b0 + slot;
  const bool active = b < num_blocks;
  const int64_t num_bytes = skew + static_cast<int64_t>(num_blocks) * block_bytes;
  const int64_t start = skew + static_cast<int64_t>(b) * block_bytes;  // the block's row in `bytes`
  const int64_t row = active ? start + data_offset : -1;
  if (channel == 0) s_row[slot] = row;

  // kPacked: the CTA's block headers, each from the 4-byte boundary at or
  // before it, copied to shared memory in words, a warp taking consecutive
  // words of a row. On an H100 a thread loading its own 18 bytes (a warp
  // load touching 32 rows) made the bench stream's launch 2.6% slower than
  // with the states given (0.2177 against 0.2122 ms); staged, 1.3% (0.2142
  // against 0.2115 ms).
  constexpr int kHeadWords = kPacked ? (C * kChannelHeaderBytes + 3) / 4 + 1 : 1;
  __shared__ uint32_t s_head[Lane::kBlocks * kHeadWords];
  if constexpr (kPacked) {
    for (int i = threadIdx.x; i < Lane::kBlocks * kHeadWords; i += kLanesPerBlock) {
      const int r = i / kHeadWords;
      const int64_t src =
          ((skew + static_cast<int64_t>(b0 + r) * block_bytes) & ~int64_t{3}) + 4 * (i - r * kHeadWords);
      if (b0 + r < num_blocks && src < num_bytes) {
        cp_async4(&s_head[i], bytes + src, static_cast<int>(min(int64_t{4}, num_bytes - src)));
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  LaneHeader state{};
  if (active) {
    if constexpr (kPacked) {
      const auto* head = reinterpret_cast<const uint8_t*>(s_head + slot * kHeadWords) + (start & 3);
      state = parse_header(head + channel * kChannelHeaderBytes);
    } else {
      const int lane = channel * num_blocks + b;
      state = {load_lms(history, weight, lane, true), clip(step_index[lane], 0, kStepIndexMax)};
    }
  }

  Lane d{state.lms, state.idx, s_step, s_delta, s_codes, s_row, bytes, num_bytes, row, num_codes, slot,
         channel * Lane::Unit::kBytes, nullptr, 0};
  // thread c * kBlocks + i writes row c * B + b0 + i
  run_rows<kMidSide>(d, s_out, out, RowMap{b0, num_blocks, Lane::kBlocks, min(Lane::kBlocks, num_blocks - b0)},
                     num_codes);
}

template <int BPS, bool kPacked, int C, bool kMidSide>
cudaError_t launch_decode(const void* bytes, int skew, const void* step_index, const void* history,
                          const void* weight, const void* step_table, const void* index_table, void* out,
                          int num_blocks, int num_codes, int block_bytes, int data_offset, int device,
                          cudaStream_t stream) {
  const auto kernel = decode_lanes_kernel<BPS, kPacked, C, kMidSide>;
  static std::atomic<uint64_t> carveout_set{0};  // one set for each instance
  const cudaError_t err = prefer_shared_once(kernel, device, carveout_set);
  if (err != cudaSuccess) return err;
  constexpr int kBlocks = DecodeLane<BPS, kPacked, C>::kBlocks;
  const dim3 grid((num_blocks + kBlocks - 1) / kBlocks);
  kernel<<<grid, kLanesPerBlock, 0, stream>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(step_index),
      static_cast<const int32_t*>(history), static_cast<const int32_t*>(weight),
      static_cast<const int32_t*>(step_table), static_cast<const int32_t*>(index_table),
      static_cast<int16_t*>(out), skew, num_blocks, num_codes, block_bytes, data_offset);
  return cudaGetLastError();
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

// bytes: the (B, block_bytes) rows from the 4-byte boundary at or before
// them, `skew` bytes before the first row; each row's codes start at
// data_offset. packed: whole blocks of 1 or 2 channels, the lanes' states
// parsed from their headers (step_index, history and weight unused), the
// codes packed, mid_side turning a stereo block's rows into left/right;
// else codes one a byte (channels 1), the states from the three arrays.
int aad_decode_lanes(const void* bytes, int skew, const void* step_index, const void* history,
                     const void* weight, const void* step_table, const void* index_table, void* out,
                     int num_blocks, int num_channels, int num_codes, int block_bytes, int data_offset,
                     int bits_per_sample, int packed, int mid_side, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(aad::dispatch_bps(bits_per_sample, [&](auto bps) {
    constexpr int kBps = decltype(bps)::value;
    const auto args = [&](auto launch) {
      return launch(bytes, skew, step_index, history, weight, step_table, index_table, out, num_blocks,
                    num_codes, block_bytes, data_offset, device, s);
    };
    if (packed && num_channels == 1 && !mid_side) return args(aad::launch_decode<kBps, true, 1, false>);
    if (packed && num_channels == 2 && !mid_side) return args(aad::launch_decode<kBps, true, 2, false>);
    if (packed && num_channels == 2 && mid_side) return args(aad::launch_decode<kBps, true, 2, true>);
    if (!packed && num_channels == 1 && !mid_side) return args(aad::launch_decode<kBps, false, 1, false>);
    return cudaErrorInvalidValue;
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
