// C-integer semantics for the device code; mirrors aad_tpu_torch/ops/cseman.py.
//
// The wire format is defined by a C89 codec running on a two's-complement
// machine (reference hot loop: src/aad_decoder.c:269-318), so the kernels
// must wrap exactly where that build wraps. Signed overflow is undefined in
// C++ and nvcc -O3 may assume it cannot happen, so every add and multiply
// that can overflow goes through uint32_t and is cast back. The streams the
// benchmark draws (weights in +-20000, history in +-32768) make the 4-tap
// prediction sum exceed 2^31, so this is not a corner case.
#pragma once

#include <cstdint>

namespace aad {

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// C `>>` on int32: arithmetic (nvcc shifts signed operands arithmetically).
__device__ __forceinline__ int32_t asr(int32_t x, int n) { return x >> n; }

// AAD_INNER_VAL: max(lo, min(hi, x)) (reference: src/aad_internal.h:28).
__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return max(lo, min(hi, x));
}

__device__ __forceinline__ int32_t clip16(int32_t x) { return clip(x, -32768, 32767); }

}  // namespace aad
