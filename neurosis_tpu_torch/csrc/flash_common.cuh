// What the flash attention sources share: the warp-specialised block (two
// consumer warpgroups, one producer warpgroup) and its ring helpers on top of
// hopper.cuh, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NCW = 8;                 // consumer warps: two warpgroups
constexpr int NT_WS = NCW * 32 + 128;  // and a producer warpgroup, of which one or two warps work
// registers a thread: ptxas budgets 168 for three warpgroups; the producer
// warpgroup gives 128 from each of its threads to the consumers (setmaxnreg)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROW = 128;              // bytes of one row of a 64-column box

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the k16 step kk over the head dim of a K-major tile of 64-column boxes
// (box_bytes apart): 32 bytes along the row, then the next box
__device__ __forceinline__ int kstep_offset(int kk, int box_bytes) { return (kk / 4) * box_bytes + (kk % 4) * 32; }

// a warp's arrival on a ring slot's empty barrier, once all its lanes are done with it
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
