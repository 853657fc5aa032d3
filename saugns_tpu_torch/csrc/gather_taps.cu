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
// exact table values, so it equals the plain gather bit for bit, for
// any integer cell, negative ones and ones above 2047 included (only
// the low 11 bits count, so the kernel adds in uint32_t).
// The MXU one-hot and the bf16 limb split of the TPU kernels exist
// only because the TPU has no fast vector gather; here one kernel
// serves both.
//
// Bound: bytes -- 8 B of int64 cell in and 16 B of taps out per cell
// (24 B; 20 B for int32 cells); the 8 KB table stays on chip. The
// design:
//  - the cells are read as they come, int64 on the main path (the
//    phase >> SLENBITS of the sequential engine) or int32, with no
//    conversion pass in front;
//  - each thread takes 4 consecutive cells: one (int32) or two (int64)
//    16-byte loads where the pointer is 16-byte aligned, and one
//    float4 store per tap row where that row's address is 16-byte
//    aligned (rows 1-3 need n % 4 == 0); scalar code for the ragged
//    tail and for unaligned views;
//  - a persistent grid of GT_BLOCKS_PER_SM blocks per SM, each staging
//    the PILUT in shared memory once and walking a grid-stride range
//    of 4-cell groups; a thread loads its first group's cells before
//    it stages the table, so both latencies overlap.

#include "common.cuh"

namespace {

constexpr int GT_THREADS = 256;
constexpr int GT_BLOCKS_PER_SM = 2;

// the 4 cells from i (their low 32 bits), zero past n; `vec`: 4 whole
// cells at a 16-byte aligned address
__device__ __forceinline__ void gt_load(const long long* __restrict__ x,
                                        long long i, long long n, bool vec,
                                        unsigned c[4]) {
  if (vec) {
    const longlong2* v = reinterpret_cast<const longlong2*>(x + i);
    const longlong2 a = v[0], b = v[1];
    c[0] = (unsigned)a.x; c[1] = (unsigned)a.y;
    c[2] = (unsigned)b.x; c[3] = (unsigned)b.y;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[k] = i + k < n ? (unsigned)x[i + k] : 0u;
  }
}

__device__ __forceinline__ void gt_load(const int* __restrict__ x,
                                        long long i, long long n, bool vec,
                                        unsigned c[4]) {
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(x + i);
    c[0] = (unsigned)a.x; c[1] = (unsigned)a.y;
    c[2] = (unsigned)a.z; c[3] = (unsigned)a.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[k] = i + k < n ? (unsigned)x[i + k] : 0u;
  }
}

// `vin`: the cells are 16-byte aligned; bit t of `vout`: tap row t is.
template <typename C>
__global__ void __launch_bounds__(GT_THREADS)
gather_taps_k(const C* __restrict__ cells, const float* __restrict__ pilut,
              float* __restrict__ out, long long n, bool vin,
              unsigned vout) {
  __shared__ float tab[saugns::LEN];
  const long long groups = (n + 3) / 4;
  const long long step = (long long)gridDim.x * GT_THREADS;
  long long g = (long long)blockIdx.x * GT_THREADS + threadIdx.x;
  unsigned c[4];
  if (g < groups) gt_load(cells, 4 * g, n, vin && 4 * g + 4 <= n, c);
  for (int k = threadIdx.x; k < saugns::LEN; k += GT_THREADS)
    tab[k] = pilut[k];
  __syncthreads();
  while (g < groups) {
    const long long i = 4 * g;
    const bool whole = i + 4 <= n;
    float r[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[t][k] = tab[(c[k] + (unsigned)(t - 1)) & saugns::LENMASK];
    g += step;
    if (g < groups) gt_load(cells, 4 * g, n, vin && 4 * g + 4 <= n, c);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float* row = out + t * n + i;
      if (whole && (vout >> t & 1u)) {
        *reinterpret_cast<float4*>(row) =
            make_float4(r[t][0], r[t][1], r[t][2], r[t][3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i + k < n) row[k] = r[t][k];
      }
    }
  }
}

template <typename C>
int gather_taps_launch(const C* cells, const float* pilut, float* out,
                       long long n, cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = saugns::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + GT_THREADS - 1) / GT_THREADS;
  if (blocks > (long long)sms * GT_BLOCKS_PER_SM)
    blocks = (long long)sms * GT_BLOCKS_PER_SM;
  unsigned vout = 0;
  for (int t = 0; t < 4; ++t)
    if (((uintptr_t)(out + t * n) & 15) == 0) vout |= 1u << t;
  gather_taps_k<C><<<(unsigned)blocks, GT_THREADS, 0, s>>>(
      cells, pilut, out, n, ((uintptr_t)cells & 15) == 0, vout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (4, n) f32 from cells (n,) of `cell_bytes` 8 (int64) or 4
// (int32) and one PILUT (2048,) f32, on `stream`. Returns the
// cudaError_t of the launch.
int saugns_gather_taps(const void* cells, int cell_bytes, const void* pilut,
                       void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cell_bytes == 8)
    return gather_taps_launch((const long long*)cells, (const float*)pilut,
                              (float*)out, n, s);
  if (cell_bytes == 4)
    return gather_taps_launch((const int*)cells, (const float*)pilut,
                              (float*)out, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
