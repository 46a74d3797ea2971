// Hand-written Hopper (sm_90a) kernels of the phase-A decode probe: kernel 7
// of the port's kernel table, aad_probe_phase_a.
//
// They replace the Pallas TPU kernel of benchmarks/probe_phase_a_decode.py
// (make_kernel, pallas_call at :246): the 4-bit decode chain of every lane
// from the zero state, split five ways to see what each half of the step
// costs. Each form computes exactly what the probe's kernel computes
// (:108-237):
//   full        the decode step: step size, qdiff, index adaptation, LMS;
//   lms_only    the LMS on a fake qdiff taken straight off the word,
//               ((word >> 2k) & 0x3FF) - 512, with no index chain;
//   qdiff_only  the index chain and the qdiffs, no LMS: the running sum
//               h0 + q of the qdiffs, cut to int16 (phase A as a kernel);
//   two_loop    a chunk's qdiffs into shared memory, then the LMS over them;
//   pipelined   one loop: word i + 1's qdiffs beside word i's LMS, two
//               independent chains in one body.
// two_loop and pipelined compute what full computes.
//
// Input: time-major (W, L) 32-bit words, code k of a word at bits 4k. Output:
// time-major (8W, L) int16, one thread a lane, the whole state in registers,
// both tables in shared memory, 64 bytes a warp store. The TPU kernel's
// chunk of w_chunk words in VMEM scratch becomes two_loop's chunk in shared
// memory: chunk_words x 8 qdiffs x 4 bytes a lane, laid out [step][thread]
// (a warp's 32 accesses in 32 banks; no thread reads another's qdiffs, so
// no barrier). The TPU's sublane fold r has no meaning here; the CTA's lane
// count takes its place as the knob (and with it the chunk that fits).
//
// What bounds it on an H100: at the probe's 28,672 lanes x 256 words the
// bytes (29.4 MB in, 117.4 MB out) take 0.0438 ms at 3.35 TB/s; chip_smoke.py
// counts each form's compiled loop by pipe (cuobjdump -sass) for its issue
// bound. The chain from one sample to the next is what the forms take apart.
//
// The entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns the cudaError_t of
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "probes.cuh"

namespace aad {
namespace probe {

enum PhaseA : int { kFull = 0, kLmsOnly = 1, kQdiffOnly = 2, kTwoLoop = 3, kPipelined = 4 };

template <int V>
__global__ void phase_a_kernel(const uint32_t* __restrict__ words,        // (W, L)
                               const int32_t* __restrict__ step_table,    // (256,)
                               const int32_t* __restrict__ index_table,   // (16,)
                               int16_t* __restrict__ out,                 // (8W, L)
                               int num_words, int num_lanes, int chunk_words) {
  __shared__ int32_t s_step[kStepTableSize];
  __shared__ int32_t s_delta[kIndexTableSize];
  extern __shared__ int32_t s_qd[];  // two_loop: chunk_words * 8 qdiffs a thread, [step][thread]
  stage_tables(s_step, s_delta, step_table, index_table);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= num_lanes || num_words == 0) return;  // no barrier follows
  const int64_t L = num_lanes;
  const uint32_t* w = words + lane;
  int16_t* o = out + lane;
  Adapt a{s_step, s_delta, 0};
  Lms lms{};
  if constexpr (V == kTwoLoop) {
    int32_t* q = s_qd + threadIdx.x;
    const int stride = blockDim.x;
    for (int c0 = 0; c0 < num_words; c0 += chunk_words) {
      const int n = min(chunk_words, num_words - c0);
      for (int i = 0; i < n; ++i) {
        const uint32_t word = __ldg(w + (c0 + i) * L);
#pragma unroll
        for (int k = 0; k < kCodesPerWord; ++k) q[(kCodesPerWord * i + k) * stride] = a.qdiff(code_of(word, k));
      }
      for (int i = 0; i < n; ++i) {
        int16_t* oi = o + (kCodesPerWord * (c0 + i)) * L;
#pragma unroll
        for (int k = 0; k < kCodesPerWord; ++k) {
          oi[k * L] = static_cast<int16_t>(lms.step(q[(kCodesPerWord * i + k) * stride]));
        }
      }
    }
  } else if constexpr (V == kPipelined) {
    int32_t qs[kCodesPerWord];
    const uint32_t first = __ldg(w);
#pragma unroll
    for (int k = 0; k < kCodesPerWord; ++k) qs[k] = a.qdiff(code_of(first, k));
    for (int i = 0; i + 1 < num_words; ++i) {
      int32_t next[kCodesPerWord];
      const uint32_t word = __ldg(w + (i + 1) * L);
#pragma unroll
      for (int k = 0; k < kCodesPerWord; ++k) next[k] = a.qdiff(code_of(word, k));
      int16_t* oi = o + (kCodesPerWord * i) * L;
#pragma unroll
      for (int k = 0; k < kCodesPerWord; ++k) {
        oi[k * L] = static_cast<int16_t>(lms.step(qs[k]));
        qs[k] = next[k];
      }
    }
    int16_t* last = o + (kCodesPerWord * (num_words - 1)) * L;
#pragma unroll
    for (int k = 0; k < kCodesPerWord; ++k) last[k * L] = static_cast<int16_t>(lms.step(qs[k]));
  } else {
    for (int i = 0; i < num_words; ++i) {
      const uint32_t word = __ldg(w + i * L);
      int16_t* oi = o + (kCodesPerWord * i) * L;
#pragma unroll
      for (int k = 0; k < kCodesPerWord; ++k) {
        int32_t s;
        if constexpr (V == kFull) {
          s = lms.step(a.qdiff(code_of(word, k)));
        } else if constexpr (V == kLmsOnly) {
          s = lms.step(static_cast<int32_t>((word >> (2 * k)) & 0x3FF) - 512);
        } else {  // qdiff_only: h0 carries the running sum
          lms.h0 = wadd(lms.h0, a.qdiff(code_of(word, k)));
          s = lms.h0;
        }
        oi[k * L] = static_cast<int16_t>(s);
      }
    }
  }
}

template <int V>
cudaError_t launch_phase_a(const void* words, const void* step_table, const void* index_table, void* out,
                           int num_words, int num_lanes, int cta_lanes, int chunk_words, cudaStream_t stream) {
  const auto kernel = phase_a_kernel<V>;
  const size_t scratch = V == kTwoLoop ? sizeof(int32_t) * kCodesPerWord * chunk_words * cta_lanes : 0;
  if (scratch > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(scratch));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((num_lanes + cta_lanes - 1) / cta_lanes);
  kernel<<<grid, cta_lanes, scratch, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(step_table),
      static_cast<const int32_t*>(index_table), static_cast<int16_t*>(out), num_words, num_lanes, chunk_words);
  return cudaGetLastError();
}

}  // namespace probe
}  // namespace aad

extern "C" {

// words: (W, L) 32-bit code words; out: (8W, L) int16; variant: 0 full,
// 1 lms_only, 2 qdiff_only, 3 two_loop, 4 pipelined; cta_lanes threads a
// CTA (a multiple of 32, at most 1024); chunk_words: two_loop's chunk.
int aad_probe_phase_a(const void* words, const void* step_table, const void* index_table, void* out,
                      int num_words, int num_lanes, int variant, int cta_lanes, int chunk_words, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace aad::probe;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(words, step_table, index_table, out, num_words, num_lanes, cta_lanes, chunk_words, s);
  };
  switch (variant) {
    case kFull: return static_cast<int>(args(launch_phase_a<kFull>));
    case kLmsOnly: return static_cast<int>(args(launch_phase_a<kLmsOnly>));
    case kQdiffOnly: return static_cast<int>(args(launch_phase_a<kQdiffOnly>));
    case kTwoLoop: return static_cast<int>(args(launch_phase_a<kTwoLoop>));
    case kPipelined: return static_cast<int>(args(launch_phase_a<kPipelined>));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
