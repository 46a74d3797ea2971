// Codec constants and table access shared by the decode and encode kernels.
#pragma once

#include <cstdint>

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

// Step size for a Q4 step index in [0, 4080] (reference: src/aad_tables.h:15,28).
__device__ __forceinline__ int32_t stepsize_from_index(const int32_t* s_step, int32_t idx) {
  return s_step[(idx + kTablesHalf) >> kTablesDigits];
}

}  // namespace aad
