// Hand-written Hopper (sm_90a) LMS kernel for aad_tpu_torch's two-phase
// ("pallas") decode engine.
//
// aad_lms_lanes replaces the Pallas TPU kernel
// aad_tpu/ops/pallas_lms.py::_lms_kernel (launched by lms_pallas): decode
// phase B, the 4-tap sign-LMS recurrence over quantised differences that
// phase A (ops/decode.py::compute_qdiffs_prefix) computed beforehand
// (reference decoder: src/aad_decoder.c:291-315):
//
//     pred = (2^14 + sum h_i * w_i) >> 15
//     s    = clip16(qd + pred)
//     w_i += (qd * h_i + 2^14) >> 18
//     h    = shift_in(s)
//
// Every product and sum wraps as in the C build (cseman.cuh): qd * h_i
// reaches about 2^31 at the top step, and the 4-tap sum wraps once the
// weights have grown.
//
// What bounds it on an H100: the bytes, 4 in (int32 qdiff) and 2 out
// (int16 sample) per sample, against about 28 integer ops per sample
// (LMS_OPS_PER_SAMPLE in chip_smoke.py); both bounds are near 0.1 ms at the
// benchmark stream's 58,066 lanes x 988 steps. Each lane is one dependent
// chain, so with about 14 resident warps per SM the chain's latency may keep
// it above either. The design: one thread per lane, the whole state (4
// history, 4 weights) in registers, qdiffs read time-major so that a warp
// reads 128 contiguous bytes at every step, and the output written as the
// int16 rows of aad_decode_lanes, (L, T + 4) with the block's four header
// samples (history reversed) first, so the decoder's row handling serves
// both engines.
//
// Not carried over from the TPU kernel:
// - the (8, 128) lane tiles and the padding of lanes to 1024 and of T to
//   256: a thread is a lane, and the grid masks the ragged last block;
// - the T_CHUNK grid axis with the state in VMEM scratch across chunks: a
//   thread walks all of T in one loop, the state in its registers;
// - the int32 output: samples are int16-valued by format and the rows are
//   written as int16 with their head, which the TPU path concatenated and
//   cast in XLA afterwards.
//
// The entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns the cudaError_t of
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "codec.cuh"
#include "cseman.cuh"

namespace aad {

constexpr int kLmsThreads = 256;

__global__ void __launch_bounds__(kLmsThreads)
    lms_lanes_kernel(const int32_t* __restrict__ qdiffs,   // (T, L) time-major
                     const int32_t* __restrict__ history,  // (L, 4), newest first
                     const int32_t* __restrict__ weight,   // (L, 4)
                     int16_t* __restrict__ out,            // (L, T + 4)
                     int num_lanes, int num_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= num_lanes) return;

  int32_t h0 = history[4 * lane + 0], h1 = history[4 * lane + 1];
  int32_t h2 = history[4 * lane + 2], h3 = history[4 * lane + 3];
  int32_t w0 = weight[4 * lane + 0], w1 = weight[4 * lane + 1];
  int32_t w2 = weight[4 * lane + 2], w3 = weight[4 * lane + 3];

  int16_t* o = out + static_cast<int64_t>(lane) * (num_steps + kFilterOrder);
  o[0] = static_cast<int16_t>(h3);
  o[1] = static_cast<int16_t>(h2);
  o[2] = static_cast<int16_t>(h1);
  o[3] = static_cast<int16_t>(h0);

  const int32_t* q = qdiffs + lane;
  for (int t = 0; t < num_steps; ++t) {
    const int32_t qd = q[static_cast<int64_t>(t) * num_lanes];
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
    o[kFilterOrder + t] = static_cast<int16_t>(s);
  }
}

}  // namespace aad

extern "C" {

int aad_lms_lanes(const void* qdiffs, const void* history, const void* weight, void* out,
                  int num_lanes, int num_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((num_lanes + aad::kLmsThreads - 1) / aad::kLmsThreads);
  aad::lms_lanes_kernel<<<grid, aad::kLmsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qdiffs), static_cast<const int32_t*>(history),
      static_cast<const int32_t*>(weight), static_cast<int16_t*>(out), num_lanes, num_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
