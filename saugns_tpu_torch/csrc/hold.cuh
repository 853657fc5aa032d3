// The forward-fill hold of kernel 10 (the forward fill): out[i] = the
// value at the last valid position j <= i of the row, else the row's
// seed. (Kernel 1 holds in its own single pass, csrc/wosc_fill.cu.)
//
// The TPU kernel ran its grid in order and carried the hold value from
// tile to tile in SMEM; blocks here run in no order, so the hold is a
// second pass. Pass 1 writes the values and, per block of HOLD_THREADS
// positions, the row index of its last valid position and whether it
// holds any invalid one (hold_aggregates). Pass 2 returns at once for
// blocks without an invalid position; the others find their carry by a
// block-wide look-back over earlier blocks' last valid indices and fill
// by a block running max of valid indices (hold_fill).
#pragma once

#include "common.cuh"

namespace saugns {

constexpr int HOLD_THREADS = 256;

// Pass 1, every thread of the block: record block `b`'s last valid
// row index (-1 if none) and whether an in-range position is invalid.
__device__ __forceinline__ void hold_aggregates(bool in, bool valid,
                                                long long pos,
                                                int* last_valid,
                                                int* has_hold, long long b,
                                                int* sh) {
  const int lv = block_max<HOLD_THREADS>(valid ? (int)pos : -1, sh);
  const int hold = __syncthreads_or(in && !valid);
  if (threadIdx.x == 0) {
    last_valid[b] = lv;
    has_hold[b] = hold;
  }
}

// Pass 2, every thread of a block that holds an invalid position:
// dst[pos] = src at the row's last valid index <= pos, else `seed`,
// written only where `valid` is false. `last_valid_row` holds the
// row's pass-1 indices; `blk` is this block's index in the row. src
// and dst may be the same row: valid positions are never written.
__device__ __forceinline__ void hold_fill(const float* src, float* dst,
                                          long long pos, bool in,
                                          bool valid,
                                          const int* last_valid_row,
                                          long long blk, float seed,
                                          int* sh) {
  // carry: the row's last valid value before this block
  int cpos = -1;
  for (long long w = blk - 1; w >= 0; w -= HOLD_THREADS) {
    const long long bb = w - threadIdx.x;
    const int m = block_max<HOLD_THREADS>(
        bb >= 0 ? last_valid_row[bb] : -1, sh);
    if (m >= 0) {
      cpos = m;
      break;
    }
  }
  const float carry = cpos >= 0 ? src[cpos] : seed;
  const int j = block_scan_max<HOLD_THREADS>(valid ? (int)pos : -1, sh);
  if (in && !valid) dst[pos] = j >= 0 ? src[j] : carry;
}

}  // namespace saugns
