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
// Bound: bytes -- 4 B of phase in and 8 B of Is out per sample (12 B);
// the ~15 float64 operations per sample stay below the card's float64
// rate at that traffic. The PILUT (8 KB) is staged in shared memory
// once per block over a grid-stride range of phases.

#include "common.cuh"

namespace {

constexpr int IS_THREADS = 256;
constexpr long long IS_MAX_BLOCKS = 132 * 8;

__global__ void is64_k(const uint32_t* __restrict__ ph,
                       const float* __restrict__ pilut,
                       double* __restrict__ out, long long n) {
  __shared__ float tab[saugns::LEN];
  for (int k = threadIdx.x; k < saugns::LEN; k += IS_THREADS)
    tab[k] = pilut[k];
  __syncthreads();
  const long long step = (long long)gridDim.x * IS_THREADS;
  for (long long i = (long long)blockIdx.x * IS_THREADS + threadIdx.x;
       i < n; i += step)
    out[i] = saugns::herp64(tab, ph[i]);
}

}  // namespace

extern "C" {

// out (n,) f64 from ph (n,) u32 and one PILUT (2048,) f32, on
// `stream`. Returns the cudaError_t of the launch.
int saugns_is64(const void* ph, const void* pilut, void* out, long long n,
                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (n + IS_THREADS - 1) / IS_THREADS;
  if (blocks > IS_MAX_BLOCKS) blocks = IS_MAX_BLOCKS;
  is64_k<<<(unsigned)blocks, IS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ph, (const float*)pilut, (double*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
