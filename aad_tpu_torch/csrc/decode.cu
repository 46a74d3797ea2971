// Hand-written Hopper (sm_90a) decode kernels for aad_tpu_torch.
//
// aad_decode_lanes replaces the fused Pallas TPU decode kernel
// aad_tpu/ops/pallas_decode.py::_make_kernel (launched by _decode_tiled).
// It computes what that kernel computes, per block x channel lane: step-size
// lookup, quantised difference, index adaptation, the 4-tap sign-LMS
// predictor and the int16 clip, emitting the block's four header samples
// first (reference decoder: src/aad_decoder.c:269-318, 386-391).
//
// What bounds it on an H100: the recurrence is one dependent chain of about
// 20 integer ops per sample, and the lanes are independent. The main-path
// stream has 58,066 lanes, which is about 14 resident warps per SM on 132
// SMs, so the kernel is bound by the latency of that chain, not by bytes
// (about 1 byte in and 2 bytes out per sample). The design follows: one
// thread per lane, the whole state in registers, codes read time-major so a
// warp's 32 lanes read 32 consecutive bytes at every step, and both tables
// staged once per CTA in shared memory. The step-size table is not in
// __constant__ memory: neighbouring lanes read different slots, and constant
// memory serialises divergent reads. The int table is exact by construction,
// so the f32 step-size formula of the TPU kernel and its correction set are
// not carried over.
//
// aad_stepsize_probe replaces the TPU correction probe
// aad_tpu/ops/pallas_decode.py::stepsize_corrections (probe_kernel). It
// reads all 256 slots through the same accessor the decode kernel uses, so
// the host can check the staged table against tables.STEPSIZE_TABLE.
//
// Both entry points have a plain C interface (bound with ctypes), launch on
// the stream they are given, allocate nothing and return the cudaError_t of
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "codec.cuh"
#include "cseman.cuh"

namespace aad {

constexpr int kThreads = 256;

template <int BPS>
__global__ void __launch_bounds__(kThreads)
    decode_lanes_kernel(const uint8_t* __restrict__ codes,       // (T, L) time-major
                        const int32_t* __restrict__ step_index,  // (L,)
                        const int32_t* __restrict__ history,     // (L, 4), newest first
                        const int32_t* __restrict__ weight,      // (L, 4)
                        const int32_t* __restrict__ step_table,  // (256,)
                        const int32_t* __restrict__ index_table, // (2**BPS,)
                        int16_t* __restrict__ out,               // (L, T + 4)
                        int num_lanes, int num_codes) {
  constexpr int32_t kCodeMask = (1 << BPS) - 1;
  constexpr int32_t kSignBit = 1 << (BPS - 1);
  constexpr int32_t kAbsMask = kSignBit - 1;

  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[1 << BPS];
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, 1 << BPS);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;

  // Parse clamp: wire indices in (4080, 4095] pin to the table maximum, as
  // at every header parse; the adaptation below keeps idx in [0, 4080].
  int32_t idx = clip(step_index[lane], 0, kStepIndexMax);
  int32_t h0 = history[4 * lane + 0], h1 = history[4 * lane + 1];
  int32_t h2 = history[4 * lane + 2], h3 = history[4 * lane + 3];
  int32_t w0 = weight[4 * lane + 0], w1 = weight[4 * lane + 1];
  int32_t w2 = weight[4 * lane + 2], w3 = weight[4 * lane + 3];

  int16_t* o = out + static_cast<int64_t>(lane) * (num_codes + kFilterOrder);
  o[0] = static_cast<int16_t>(h3);
  o[1] = static_cast<int16_t>(h2);
  o[2] = static_cast<int16_t>(h1);
  o[3] = static_cast<int16_t>(h0);

  const uint8_t* c = codes + lane;
  for (int t = 0; t < num_codes; ++t) {
    const int32_t code = c[static_cast<int64_t>(t) * num_lanes] & kCodeMask;

    // quantised difference (reference: src/aad_decoder.c:284-288)
    const int32_t step = stepsize_from_index(s_step, idx);
    const int32_t qmag = (step * (((code & kAbsMask) << 1) + 1)) >> (BPS - 1);
    const int32_t qdiff = (code & kSignBit) ? -qmag : qmag;

    // index adaptation (reference: src/aad_tables.h:31-43)
    idx = clip(idx + s_delta[code], 0, kStepIndexMax);

    // LMS reconstruction (reference: src/aad_decoder.c:291-315)
    int32_t acc = wadd(kFixedHalf, wmul(h0, w0));
    acc = wadd(acc, wmul(h1, w1));
    acc = wadd(acc, wmul(h2, w2));
    acc = wadd(acc, wmul(h3, w3));
    const int32_t s = clip16(wadd(qdiff, asr(acc, kFixedDigits)));
    w0 = wadd(w0, asr(wadd(wmul(qdiff, h0), kFixedHalf), kWeightShift));
    w1 = wadd(w1, asr(wadd(wmul(qdiff, h1), kFixedHalf), kWeightShift));
    w2 = wadd(w2, asr(wadd(wmul(qdiff, h2), kFixedHalf), kWeightShift));
    w3 = wadd(w3, asr(wadd(wmul(qdiff, h3), kFixedHalf), kWeightShift));
    h3 = h2;
    h2 = h1;
    h1 = h0;
    h0 = s;
    o[kFilterOrder + t] = static_cast<int16_t>(s);
  }
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
                     void* out, int num_lanes, int num_codes, int bits_per_sample,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((num_lanes + aad::kThreads - 1) / aad::kThreads);
  const dim3 block(aad::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* si = static_cast<const int32_t*>(step_index);
  const auto* h = static_cast<const int32_t*>(history);
  const auto* w = static_cast<const int32_t*>(weight);
  const auto* st = static_cast<const int32_t*>(step_table);
  const auto* it = static_cast<const int32_t*>(index_table);
  auto* o = static_cast<int16_t*>(out);
  switch (bits_per_sample) {
    case 2:
      aad::decode_lanes_kernel<2><<<grid, block, 0, s>>>(c, si, h, w, st, it, o, num_lanes, num_codes);
      break;
    case 3:
      aad::decode_lanes_kernel<3><<<grid, block, 0, s>>>(c, si, h, w, st, it, o, num_lanes, num_codes);
      break;
    case 4:
      aad::decode_lanes_kernel<4><<<grid, block, 0, s>>>(c, si, h, w, st, it, o, num_lanes, num_codes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
