// Kernel 4: inclusive running max of int32 with identity 0.
//
// Replaces the Pallas kernel _pallas_scan_max_i32
// (saugns_tpu/render/jdsp.py:2680), whose lane and row scans combine
// with 0 where a shift runs off the array (:2696, :2705), so every
// output is max(0, running max): on inputs >= 0, its domain, that is
// the running max itself. The JAX package has no caller of it
// (cummax_i32, :2738, is unused); the port's flat renderer runs its
// per-row carry fill (flat._row_last) through it, over a chunk's few
// rows, and over a slab's voices as (V, rows) in one launch (the TPU
// kernel vmapped over the voice axis).
//
// Bound: bytes -- 4 B in and 4 B out per element (8 B). The design:
// the single-pass look-back scan of scan_lookback.cuh with max in place
// of add, exact; the main path's few rows are one block a voice in one
// launch, with no scratch and no memset.

#include "scan_lookback.cuh"

extern "C" {

// y[r, i] = max(0, x[r, 0], ..., x[r, i]) for each of `rows` >= 1
// rows of n >= 1 elements, on `stream`. `scratch` is null for
// n <= LB_TILE, else 1 + rows x ceil(n / LB_TILE) 64-bit words.
// Returns the cudaError_t of the calls.
int saugns_scan_max_i32(const void* x, void* y, void* scratch,
                        long long n, long long rows, void* stream) {
  return lookback_scan_launch<int, saugns::MaxOp, LbPacked<int>>(
      (const int*)x, (int*)y, scratch, n, rows, 0, (cudaStream_t)stream);
}

}  // extern "C"
