// Kernels 7 and 8: the Hermite taps of PILUT cells.
//
// Replaces both Pallas tap gathers of saugns_tpu/render/jdsp.py:
// _gather_taps_window (:1873, window lane gathers) and
// _gather_taps_pallas (:1631, the MXU one-hot variant selected with
// SAUGNS_TPU_TAPKERNEL=onehot); API gather_taps (:2420). For N cell
// indices it writes the (4, N) float32 rows
//
//   out[t][i] = pilut[(cell[i] - 1 + t) & 2047],  t = 0 .. 3
//
// exact table values, so it equals the plain gather bit for bit. The
// MXU one-hot and the bf16 limb split of the TPU kernels exist only
// because the TPU has no fast vector gather; here one kernel serves
// both.
//
// Bound: bytes -- 4 B of cell in and 16 B of taps out per cell (20 B).
// The wave's PILUT (8 KB) is staged in shared memory once per block,
// and each block walks a grid-stride range of cells, so the table load
// is paid once per block and the taps are written coalesced per row.

#include "common.cuh"

namespace {

constexpr int GT_THREADS = 256;
constexpr long long GT_MAX_BLOCKS = 132 * 8;

__global__ void gather_taps_k(const int* __restrict__ cells,
                              const float* __restrict__ pilut,
                              float* __restrict__ out, long long n) {
  __shared__ float tab[saugns::LEN];
  for (int k = threadIdx.x; k < saugns::LEN; k += GT_THREADS)
    tab[k] = pilut[k];
  __syncthreads();
  const long long step = (long long)gridDim.x * GT_THREADS;
  for (long long i = (long long)blockIdx.x * GT_THREADS + threadIdx.x;
       i < n; i += step) {
    const int c = cells[i];
    out[i] = tab[(c - 1) & saugns::LENMASK];
    out[n + i] = tab[c & saugns::LENMASK];
    out[2 * n + i] = tab[(c + 1) & saugns::LENMASK];
    out[3 * n + i] = tab[(c + 2) & saugns::LENMASK];
  }
}

}  // namespace

extern "C" {

// out (4, n) f32 from cells (n,) i32 and one PILUT (2048,) f32, on
// `stream`. Returns the cudaError_t of the launch.
int saugns_gather_taps(const void* cells, const void* pilut, void* out,
                       long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (n + GT_THREADS - 1) / GT_THREADS;
  if (blocks > GT_MAX_BLOCKS) blocks = GT_MAX_BLOCKS;
  gather_taps_k<<<(unsigned)blocks, GT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)cells, (const float*)pilut, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
