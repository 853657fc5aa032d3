// Kernel 9: Is(phase) of a phase buffer in float64.
//
// Replaces the Pallas kernel _gather_is_window
// (saugns_tpu/render/jdsp.py:1909; reached through _gather_is_fused
// :2391 and _Is_df64 :662), which returned Is as a double-float32
// (hi, lo) pair because the TPU has no float64. The H100 has IEEE
// float64, so this kernel returns Is itself, evaluated as the CPU
// reference does (_herp64_taps, jdsp.py:546-563): per phase, cell =
// ph >> SLENBITS, x = (ph & SLENMASK) * X_SCALE in float32, the four
// taps from the PILUT, then herp64 of common.cuh (tap differences in
// float32, everything else in float64 one op at a time, built with
// -fmad=false) -- bit for bit the plain version, not the TPU's df64,
// which is +-1 LSB off.
//
// Bound, on the H100: 8 B of int64 phase in and 8 B of Is out a sample
// (16 B), against 8 float32<->float64 conversions a sample (counted in
// the SASS) on a unit that does 16 a clock and SM: at 2^22 the bytes
// take ~20 us, the conversions ~8 us; measured, ~28 us (PERF.md). The
// design reads and writes each sample once, in one launch with no
// conversion pass and no memset:
//  - the callers' int64 phases are read as they are (only the low 32
//    bits count), 2 a 16-byte load, and Is is stored 2 doubles a
//    16-byte store, IS_PAIRS pairs a thread in flight at once, where
//    both pointers are 16-byte aligned (scalar code for odd views and
//    the last odd sample);
//  - a persistent grid of a few blocks an SM (the SM count asked once
//    a device, not written into the source) walks grid-stride ranges,
//    staging the 8 KB PILUT once a block. (Kernel 5's table of every
//    cell's float64 coefficients, common.cuh's CoefIs, leaves one
//    conversion a sample but costs a 2,048-cell prologue a block: it
//    measured slower here at 2^22 and level at the main path's n.)

#include "common.cuh"

namespace {

constexpr int IS_THREADS = 256;
constexpr int IS_PAIRS = 2;   // 16-byte loads a thread in flight
constexpr int IS_PER_SM = 4;  // blocks an SM, at most

__global__ void __launch_bounds__(IS_THREADS)
is64_k(const long long* __restrict__ ph, const float* __restrict__ pilut,
       double* __restrict__ out, long long n, bool vec) {
  __shared__ float tab[saugns::LEN];
  for (int k = threadIdx.x; k < saugns::LEN; k += IS_THREADS)
    tab[k] = pilut[k];
  __syncthreads();
  const auto is = [&](uint32_t p) { return saugns::herp64(tab, p); };
  const long long step = (long long)gridDim.x * IS_THREADS;
  long long g = (long long)blockIdx.x * IS_THREADS + threadIdx.x;
  if (!vec) {
    for (; g < n; g += step) out[g] = is((uint32_t)ph[g]);
    return;
  }
  const longlong2* pv = reinterpret_cast<const longlong2*>(ph);
  double2* ov = reinterpret_cast<double2*>(out);
  const long long pairs = n / 2;
  for (; g < pairs; g += IS_PAIRS * step) {
    longlong2 v[IS_PAIRS];
#pragma unroll
    for (int u = 0; u < IS_PAIRS; ++u)
      if (g + u * step < pairs) v[u] = pv[g + u * step];
#pragma unroll
    for (int u = 0; u < IS_PAIRS; ++u)
      if (g + u * step < pairs)
        ov[g + u * step] = make_double2(is((uint32_t)v[u].x),
                                        is((uint32_t)v[u].y));
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
    out[n - 1] = is((uint32_t)ph[n - 1]);
}

}  // namespace

extern "C" {

// out (n,) f64 from ph (n,) int64 (only the low 32 bits count) and one
// PILUT (2048,) f32, on `stream`. Returns the cudaError_t of the launch.
int saugns_is64(const void* ph, const void* pilut, void* out, long long n,
                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = saugns::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const bool vec = (((uintptr_t)ph | (uintptr_t)out) & 15) == 0;
  // a sample (pair) a thread, at most IS_PER_SM blocks an SM
  const long long per_block = (long long)IS_THREADS * (vec ? 2 : 1);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > (long long)sms * IS_PER_SM)
    blocks = (long long)sms * IS_PER_SM;
  is64_k<<<(unsigned)blocks, IS_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)ph, (const float*)pilut, (double*)out, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
