// Kernel 2: inclusive prefix sum of u32 that wraps mod 2^32, read from
// and written to int64.
//
// Replaces the Pallas kernel _pallas_scan_add_u32
// (saugns_tpu/render/jdsp.py:2615), the VMEM Hillis-Steele form of
// the oscillator phase scan under audio-rate FM (prefix_sum,
// flat.py:529 of the JAX renderer) and of red noise (flat.py:908).
// The TPU kernel held the whole array in VMEM and scanned it in one
// grid step; vmapped over a slab of voices (the voice banks) it scans
// each row of the leading axis, which here is one launch over (V, n).
//
// Bound: bytes. The function needs 8 B per element (u32 in, u32 out);
// its int64 contract moves 16 B (8 in, 8 out). The design: the
// single-pass look-back scan of scan_lookback.cuh, which reads each
// int64 once, takes its low 32 bits (x & 0xffffffff for every int64,
// negative and >= 2^32 too), scans in uint32_t and writes the sum
// zero-extended: one launch (and one memset of the look-back's status
// words above one tile), and no conversion pass around it.

#include "scan_lookback.cuh"

extern "C" {

// Elements per tile of the look-back scans (kernels 2, 3 and 4).
int saugns_lookback_tile() { return LB_TILE; }

// y[r, i] = (x[r, 0] + ... + x[r, i]) mod 2^32 of the low 32 bits of
// int64 x, as int64 in [0, 2^32), for each of `rows` >= 1 rows of
// n >= 1 elements, on `stream`. `scratch` is null for n <= LB_TILE,
// else 1 + rows x ceil(n / LB_TILE) 64-bit words. Returns the
// cudaError_t of the calls.
int saugns_scan_add_u32(const void* x, void* y, void* scratch,
                        long long n, long long rows, void* stream) {
  return lookback_scan_launch<uint32_t, saugns::AddOp, LbPacked<uint32_t>>(
      (const long long*)x, (long long*)y, scratch, n, rows, 0u,
      (cudaStream_t)stream);
}

}  // extern "C"
