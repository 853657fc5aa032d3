// Kernel 3: inclusive prefix sum of u64 that wraps mod 2^64.
//
// Replaces the Pallas kernel _pallas_scan_add_u64
// (saugns_tpu/render/jdsp.py:2636), which scanned lo/hi u32 planes
// with explicit carries because Mosaic has no 64-bit integers. It
// serves the RasG cycle-phase scan at a non-constant frequency
// (K_RCYCLE, flat.py:571 of the JAX renderer). The port keeps a u64 as
// the bits of an int64 tensor, so the scan runs on unsigned long long
// with no planes. As kernel 2, a (V, n) call scans each row on its own
// in one launch (the TPU kernel vmapped over the voices of a slab).
//
// Bound: bytes -- 8 B in and 8 B out per element (16 B). The design:
// the single-pass look-back scan of scan_lookback.cuh, which reads each
// element once and writes it once, in one launch (and one memset of
// the status words above one tile), with the status policy LbPair: a
// 64-bit payload leaves no room for a flag in one status word, so each
// tile's payload is split over two words, each with the flag beside
// its half.

#include "scan_lookback.cuh"

extern "C" {

// y[r, i] = x[r, 0] + ... + x[r, i] mod 2^64 of int64 bits, for each
// of `rows` >= 1 rows of n >= 1 elements, on `stream`. `scratch` is
// null for n <= LB_TILE, else 1 + 2 m 64-bit words for m = rows x
// ceil(n / LB_TILE) tiles. Returns the cudaError_t of the calls.
int saugns_scan_add_u64(const void* x, void* y, void* scratch,
                        long long n, long long rows, void* stream) {
  return lookback_scan_launch<unsigned long long, saugns::AddOp,
                              LbPair<unsigned long long>>(
      (const long long*)x, (long long*)y, scratch, n, rows, 0ull,
      (cudaStream_t)stream);
}

}  // extern "C"
