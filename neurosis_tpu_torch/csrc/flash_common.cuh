// Helpers shared by the flash attention sources: strided row views, tile
// loads into shared memory, warp reductions, the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

template <typename T>
struct Rows {
  const T* ptr;      // row 0 of this (batch, head)
  int64_t stride;    // elements between rows
};
using StridedRows = Rows<bf16>;

// Copy rows [row0, row0+R) x [0, d) of a strided bf16 or fp32 matrix into a
// shared tile of R x DP (row stride LD) in 16-byte chunks, with NT threads;
// rows past n_rows and columns past d are zero.
template <int R, int DP, int LD, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, Rows<T> src, int row0, int n_rows, int d) {
  constexpr int PER = 16 / sizeof(T);  // elements per chunk
  constexpr int CHUNKS = DP / PER;
  for (int i = threadIdx.x; i < R * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * PER;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int row = row0 + r;
    if (row < n_rows && c < d) {
      v = *reinterpret_cast<const uint4*>(src.ptr + (int64_t)row * src.stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
