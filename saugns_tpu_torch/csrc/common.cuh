// Shared block-level helpers of the port's kernels. Plain CUDA C++:
// no PyTorch header, so a build is one short nvcc call.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace saugns {

// Inclusive scan of one u32 per thread over a block of NT threads,
// wrapping mod 2^32. `sh` holds at least NT / 32 words. Every thread
// of the block must call it.
template <int NT>
__device__ uint32_t block_scan_add(uint32_t v, uint32_t* sh) {
  static_assert(NT % 32 == 0 && NT <= 1024, "block of whole warps");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 1; k < 32; k <<= 1) {
    uint32_t t = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v += t;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < NT / 32 ? sh[lane] : 0u;
    for (int k = 1; k < 32; k <<= 1) {
      uint32_t t = __shfl_up_sync(0xffffffffu, w, k);
      if (lane >= k) w += t;
    }
    if (lane < NT / 32) sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += sh[warp - 1];
  __syncthreads();
  return v;
}

// Inclusive running max of one int per thread over a block of NT
// threads. `sh` holds at least NT / 32 ints.
template <int NT>
__device__ int block_scan_max(int v, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 1; k < 32; k <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v = max(v, t);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? sh[lane] : -1;
    for (int k = 1; k < 32; k <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, w, k);
      if (lane >= k) w = max(w, t);
    }
    if (lane < NT / 32) sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, sh[warp - 1]);
  __syncthreads();
  return v;
}

// Max of one int per thread, returned to every thread of the block.
template <int NT>
__device__ int block_max(int v, int* sh) {
  int s = block_scan_max<NT>(v, sh);
  __shared__ int total;
  if (threadIdx.x == NT - 1) total = s;
  __syncthreads();
  int r = total;
  __syncthreads();
  return r;
}

}  // namespace saugns
