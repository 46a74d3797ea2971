// Hand-written Hopper (sm_90a) transpose: kernel 6 of the port's kernel
// table, aad_probe_transpose.
//
// It replaces the two Pallas TPU kernels of benchmarks/probe_transpose.py
// (t1_kernel, one block transpose, pallas_call at :84; t2_kernel, eight
// row-wise 2-D transposes, :100): the decode output's detile transpose
// (W4, nt, 8, 128) int32 -> (nt, 8, 128, W4), which is the 2-D transpose of
// the (W4, nt * 8 * 128) view into (nt * 8 * 128, W4). T1 and T2 are two
// ways to lay that work onto the TPU's (8, 128) vector registers; they have
// no counterpart here.
//
// What bounds it on an H100: the bytes, each element read once and written
// once (268.4 MB at the probe's (512, 64, 8, 128): 0.0801 ms at 3.35 TB/s).
// The design: a CTA of 256 threads moves a 64 x 64 tile through shared
// memory, rows 65 words apart, so that both the row-wise writes into the
// tile and the column-wise reads out of it hit 32 different banks a warp.
// Where both extents are multiples of 4 and both pointers 16-byte aligned,
// each thread reads and writes 16 bytes at a time (four 16-byte accesses
// each way; a warp takes 4 rows x 32 columns of the tile, so 128
// consecutive bytes a row); otherwise 4 bytes (a warp takes 32 consecutive
// words of one row). Tiles past either edge are masked.
//
// The entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns the cudaError_t of
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace aad {
namespace probe {

constexpr int kTile = 64;          // rows and columns of a CTA's tile
constexpr int kPitch = kTile + 1;  // odd: a warp's 32 accesses to the tile fall in 32 banks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// out (cols, rows) = in (rows, cols) transposed.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int rows, int cols, int tiles_c) {
  __shared__ int32_t s[kTile * kPitch];
  const int r0 = (blockIdx.x / tiles_c) * kTile;  // the tile's first row of `in`
  const int c0 = (blockIdx.x % tiles_c) * kTile;  // and first column
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  if constexpr (kVec) {
    // a warp takes 4 rows x 32 columns (8 x 16 bytes a row) at a time, 32 such blocks a tile
    constexpr int kPasses = kTile * kTile / (4 * 32 * kWarps);
    int4 v[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int b = p * kWarps + warp;
      const int r = r0 + 4 * (b / 2) + t / 8;
      const int c = c0 + 32 * (b % 2) + 4 * (t % 8);
      v[p] = make_int4(0, 0, 0, 0);
      if (r < rows && c < cols) v[p] = __ldg(reinterpret_cast<const int4*>(in + static_cast<int64_t>(r) * cols + c));
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int b = p * kWarps + warp;
      int32_t* dst = s + (4 * (b / 2) + t / 8) * kPitch + 32 * (b % 2) + 4 * (t % 8);
      dst[0] = v[p].x;
      dst[1] = v[p].y;
      dst[2] = v[p].z;
      dst[3] = v[p].w;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int b = p * kWarps + warp;
      const int n = 4 * (b / 2) + t / 8;       // the tile's column: a row of `out`
      const int r = 32 * (b % 2) + 4 * (t % 8);  // the tile's row: a column of `out`
      if (c0 + n < cols && r0 + r < rows) {
        const int32_t* src = s + r * kPitch + n;
        const int4 w = make_int4(src[0], src[kPitch], src[2 * kPitch], src[3 * kPitch]);
        *reinterpret_cast<int4*>(out + static_cast<int64_t>(c0 + n) * rows + r0 + r) = w;
      }
    }
  } else {
    // a warp takes 32 consecutive words of one row at a time
    for (int b = warp; b < 2 * kTile; b += kWarps) {
      const int r = b / 2;
      const int c = 32 * (b % 2) + t;
      if (r0 + r < rows && c0 + c < cols) s[r * kPitch + c] = __ldg(in + static_cast<int64_t>(r0 + r) * cols + c0 + c);
    }
    __syncthreads();
    for (int b = warp; b < 2 * kTile; b += kWarps) {
      const int n = b / 2;
      const int r = 32 * (b % 2) + t;
      if (c0 + n < cols && r0 + r < rows) out[static_cast<int64_t>(c0 + n) * rows + r0 + r] = s[r * kPitch + n];
    }
  }
}

}  // namespace probe
}  // namespace aad

extern "C" {

// in: (rows, cols) int32, out: (cols, rows) int32, both contiguous.
int aad_probe_transpose(const void* in, void* out, int rows, int cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace aad::probe;
  const int tiles_r = (rows + kTile - 1) / kTile;
  const int tiles_c = (cols + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles_r) * static_cast<unsigned>(tiles_c));
  const bool vec = rows % 4 == 0 && cols % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel = vec ? transpose_kernel<true> : transpose_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), rows, cols, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
