// Kernel 10: the forward fill of the last valid value.
//
// Replaces the Pallas kernel _forward_fill_flat
// (saugns_tpu/render/jdsp.py:2025, body _ffill_kernel_factory :1993;
// API forward_fill_last_valid :2055). For n rows of L float32 values,
// a valid mask and one seed per row it computes, at every position,
//
//   out[i] = s[j] at the last valid j <= i of the row, else the seed
//
// -- the scan branch of forward_fill_valid (jdsp.py:816), wosc's
// pd == 0 hold. The sequential engine fills a same-level group of
// oscillator stages, one row each, in one launch.
//
// Bound: bytes -- 4 B of value and 1 B of mask in, 4 B out per
// position (9 B). The TPU kernel scanned each tile by log-doubling in
// VMEM and carried the hold across its in-order grid in SMEM; here the
// hold is the two-pass design of hold.cuh, shared with kernel 1: pass
// 1 copies the values and records each block's last valid index, and
// pass 2 returns at once for a block with no invalid position (the
// common case) and otherwise looks back over earlier blocks of its
// row.

#include "hold.cuh"

namespace {

constexpr int FF_THREADS = saugns::HOLD_THREADS;

// Pass 1: out = s, and the per-block aggregates.
__global__ void ffill_copy(const float* __restrict__ s,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ out,
                           int* __restrict__ last_valid,
                           int* __restrict__ has_hold, long long L) {
  __shared__ int sh[FF_THREADS / 32];
  const int r = blockIdx.y;
  const long long pos = (long long)blockIdx.x * FF_THREADS + threadIdx.x;
  const bool in = pos < L;
  bool v = false;
  if (in) {
    const long long i = (long long)r * L + pos;
    v = valid[i] != 0;
    out[i] = s[i];
  }
  saugns::hold_aggregates(in, v, pos, last_valid, has_hold,
                          (long long)r * gridDim.x + blockIdx.x, sh);
}

// Pass 2: the hold, in blocks that hold an invalid position.
__global__ void ffill_hold(const float* __restrict__ s,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ seeds,
                           float* __restrict__ out,
                           const int* __restrict__ last_valid,
                           const int* __restrict__ has_hold,
                           long long L) {
  __shared__ int sh[FF_THREADS / 32];
  const int r = blockIdx.y;
  const long long rb = (long long)r * gridDim.x;
  if (!has_hold[rb + blockIdx.x]) return;
  const long long pos = (long long)blockIdx.x * FF_THREADS + threadIdx.x;
  const bool in = pos < L;
  const long long row = (long long)r * L;
  const bool v = in && valid[row + pos] != 0;
  saugns::hold_fill(s + row, out + row, pos, in, v, last_valid + rb,
                    blockIdx.x, seeds[r], sh);
}

}  // namespace

extern "C" {

// Number of blocks per row; scratch is 2 * n_rows * blocks ints.
long long saugns_ffill_blocks(long long row_len) {
  return (row_len + FF_THREADS - 1) / FF_THREADS;
}

// out (n, L) f32 from s (n, L) f32, valid (n, L) u8 and seeds (n,) f32,
// on `stream`. Returns the cudaError_t of the launches.
int saugns_ffill(const void* s, const void* valid, const void* seeds,
                 void* out, void* scratch, long long row_len, int n_rows,
                 void* stream) {
  if (row_len < 1 || n_rows < 1 || n_rows > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nb = saugns_ffill_blocks(row_len);
  if (nb > 0x7fffffffLL || row_len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int* last_valid = (int*)scratch;
  int* has_hold = last_valid + nb * n_rows;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)nb, (unsigned)n_rows);
  ffill_copy<<<grid, FF_THREADS, 0, st>>>(
      (const float*)s, (const uint8_t*)valid, (float*)out, last_valid,
      has_hold, row_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ffill_hold<<<grid, FF_THREADS, 0, st>>>(
      (const float*)s, (const uint8_t*)valid, (const float*)seeds,
      (float*)out, last_valid, has_hold, row_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
