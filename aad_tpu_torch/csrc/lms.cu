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
// What bounds it on an H100: the bytes, 4 in (int32 qdiff) and 2 out (int16
// sample) a sample, 0.103 ms at the benchmark stream's 58,066 lanes x 988
// steps; its compiled step loop issues 24.1 instructions a sample
// (chip_smoke.py counts them from the SASS), 0.041 ms of issue. Measured
// there (H100 80GB HBM3, 700 W; PERF.md section 6), the first
// design, each thread storing its samples straight into its own row from
// 256-thread CTAs, took 1.21 ms, bound by the output pattern it shares with
// aad_decode_lanes: warp stores to 32 rows 1,984 bytes apart, 32 partial
// sectors for 64 bytes. 64-lane CTAs alone gave 1.14 ms, the staged rows
// 0.35 ms (30% of the bound). The design: one thread a lane with the whole
// state (4 history, 4 weights) in registers; qdiffs read time-major, 128
// contiguous bytes a warp a step, as phase A writes them; the output rows
// staged through shared memory and written as whole row segments by 64-lane
// CTAs (codec.cuh::run_rows), the rows of aad_decode_lanes, (L, T + 4) with
// the block's four header samples (history reversed) first, so the
// decoder's row handling serves both engines.
//
// Not carried over from the TPU kernel:
// - the (8, 128) lane tiles and the padding of lanes to 1024 and of T to
//   256: a thread is a lane, and the ragged last CTA masks its lanes;
// - the T_CHUNK grid axis with the state in VMEM scratch across chunks: a
//   thread walks all of T in one loop, the state in its registers;
// - the int32 output: samples are int16-valued by format and the rows are
//   written as int16 with their head, which the TPU path concatenated and
//   cast in XLA afterwards.
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

struct LmsLane {
  Lms lms;
  const int32_t* q;  // this lane's column of the (T, L) qdiffs
  int num_lanes;

  __device__ __forceinline__ void head(uint32_t* row) const { write_head(row, lms); }
  __device__ __forceinline__ void begin(int) const {}
  __device__ __forceinline__ void fetch(int) const {}
  __device__ __forceinline__ void wait() const {}
  __device__ __forceinline__ int32_t step(int, int t, int) {
    return lms.step(__ldg(q + static_cast<int64_t>(t) * num_lanes));
  }
};

__global__ void __launch_bounds__(kLanesPerBlock)
    lms_lanes_kernel(const int32_t* __restrict__ qdiffs,   // (T, L) time-major
                     const int32_t* __restrict__ history,  // (L, 4), newest first
                     const int32_t* __restrict__ weight,   // (L, 4)
                     int16_t* __restrict__ out,            // (L, T + 4)
                     int num_lanes, int num_steps) {
  __shared__ OutTile s_out[2];
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int lane = lane0 + static_cast<int>(threadIdx.x);
  const bool active = lane < num_lanes;
  LmsLane l{load_lms(history, weight, lane, active), qdiffs + lane, num_lanes};
  run_rows(l, s_out, out, RowMap{lane0, 0, kLanesPerBlock, min(kLanesPerBlock, num_lanes - lane0)}, num_steps);
}

}  // namespace aad

extern "C" {

int aad_lms_lanes(const void* qdiffs, const void* history, const void* weight, void* out,
                  int num_lanes, int num_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::atomic<uint64_t> carveout_set{0};
  err = aad::prefer_shared_once(aad::lms_lanes_kernel, device, carveout_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((num_lanes + aad::kLanesPerBlock - 1) / aad::kLanesPerBlock);
  aad::lms_lanes_kernel<<<grid, aad::kLanesPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qdiffs), static_cast<const int32_t*>(history),
      static_cast<const int32_t*>(weight), static_cast<int16_t*>(out), num_lanes, num_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
