// Kernel 2: inclusive prefix sum of u32 that wraps mod 2^32.
//
// Replaces the Pallas kernel _pallas_scan_add_u32
// (saugns_tpu/render/jdsp.py:2615), the VMEM Hillis-Steele form of
// the oscillator phase scan under audio-rate FM (prefix_sum,
// flat.py:529 of the JAX renderer) and of red noise (flat.py:908).
// The TPU kernel held the whole array in VMEM and scanned it in one
// grid step; here it is the three-phase block scan of scan_add.cuh on
// uint32_t (8 B per element moved, 12 B read and written in all).

#include "scan_add.cuh"

extern "C" {

// Number of scratch values the scans need for n elements.
long long saugns_scan_scratch_len(long long n) { return scan_tiles(n); }

// y[i] = x[0] + ... + x[i] mod 2^32, for n >= 1, on `stream`.
// Returns the cudaError_t of the launches.
int saugns_scan_add_u32(const void* x, void* y, void* scratch,
                        long long n, void* stream) {
  return scan_add<uint32_t>((const uint32_t*)x, (uint32_t*)y,
                            (uint32_t*)scratch, n, (cudaStream_t)stream);
}

}  // extern "C"
