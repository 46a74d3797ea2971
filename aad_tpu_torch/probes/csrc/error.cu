// The error string of the probes library's entry points, which return a
// cudaError_t as int (bound with ctypes, as the codec kernels are).

#include <cuda_runtime.h>

extern "C" const char* aad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
