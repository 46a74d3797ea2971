// What the decode probes share: their code words and the first half of the
// decode step, built from the codec's own pieces (../../csrc/codec.cuh:
// the tables in shared memory, the wrapping LMS step).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "../../csrc/codec.cuh"
#include "../../csrc/cseman.cuh"

namespace aad {
namespace probe {

// The probes decode 4-bit codes, eight a 32-bit word, code k at bits 4k
// (aad_tpu/ops/pallas_decode.py::pack_code_words).
constexpr int kBps = 4;
constexpr int kCodesPerWord = 8;
constexpr int32_t kSignBit = 1 << (kBps - 1);
constexpr int32_t kAbsMask = kSignBit - 1;
constexpr int kIndexTableSize = 1 << kBps;

__device__ __forceinline__ int32_t code_of(uint32_t word, int k) {
  return static_cast<int32_t>((word >> (kBps * k)) & ((1u << kBps) - 1));
}

// The step size, quantised difference and index adaptation of one code
// (reference: src/aad_decoder.c:280-288, src/aad_tables.h:31-43): the half of
// kernel 1's step (csrc/decode.cu::DecodeLane::step) ahead of the LMS.
struct Adapt {
  const int32_t* s_step;
  const int32_t* s_delta;
  int32_t idx;

  __device__ __forceinline__ int32_t qdiff(int32_t code) {
    const int32_t step = stepsize_from_index(s_step, idx);
    const int32_t qmag = (step * (((code & kAbsMask) << 1) + 1)) >> (kBps - 1);
    idx = clip(idx + s_delta[code], 0, kStepIndexMax);
    return (code & kSignBit) ? -qmag : qmag;
  }
};

// The step-size and index-delta tables into shared memory, then a barrier.
__device__ __forceinline__ void stage_tables(int32_t* s_step, int32_t* s_delta, const int32_t* __restrict__ step_table,
                                             const int32_t* __restrict__ index_table) {
  stage_table(s_step, step_table, kStepTableSize);
  stage_table(s_delta, index_table, kIndexTableSize);
  __syncthreads();
}

}  // namespace probe
}  // namespace aad
