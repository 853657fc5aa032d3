// Kernel 3: inclusive prefix sum of u64 that wraps mod 2^64.
//
// Replaces the Pallas kernel _pallas_scan_add_u64
// (saugns_tpu/render/jdsp.py:2636), which scanned lo/hi u32 planes
// with explicit carries because Mosaic has no 64-bit integers. It
// serves the RasG cycle-phase scan at a non-constant frequency
// (K_RCYCLE, flat.py:571 of the JAX renderer). The port keeps a u64 as
// the bits of an int64 tensor, so this is the three-phase block scan
// of scan_add.cuh on unsigned long long, with no planes: 16 B per
// element moved (24 B read and written in all).

#include "scan_add.cuh"

extern "C" {

// Number of scratch values the scan needs for n elements.
long long saugns_scan_scratch_len(long long n) { return scan_tiles(n); }

// y[i] = x[0] + ... + x[i] mod 2^64, for n >= 1, on `stream`; scratch
// holds saugns_scan_scratch_len(n) u64 values. Returns the
// cudaError_t of the launches.
int saugns_scan_add_u64(const void* x, void* y, void* scratch,
                        long long n, void* stream) {
  return scan_add_u64((const u64*)x, (u64*)y, (u64*)scratch, n,
                      (cudaStream_t)stream);
}

}  // extern "C"
