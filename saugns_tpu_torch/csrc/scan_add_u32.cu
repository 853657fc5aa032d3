// Kernel 2: inclusive prefix sum of u32 that wraps mod 2^32.
//
// Replaces the Pallas kernel _pallas_scan_add_u32
// (saugns_tpu/render/jdsp.py:2615), the VMEM Hillis-Steele form of
// the oscillator phase scan under audio-rate FM (prefix_sum,
// flat.py:529 of the JAX renderer).
//
// Bound: bytes. Each element is read once and written once (8 B per
// element); the adds are free next to that. The TPU kernel held the
// whole array in VMEM and scanned it in one grid step; here blocks run
// in parallel in no order, so the scan has three phases: (1) each
// tile of 2048 elements reduces to one sum, (2) one block scans the
// tile sums into exclusive offsets, (3) each tile scans itself from
// shared memory and adds its offset. Phases 1 and 3 read the input
// twice (12 B per element in all); a decoupled look-back would cut
// that to 8 B and is left for later. Unsigned 32-bit adds wrap by
// definition, so the result is bit-equal to int64 cumsum & 0xffffffff.

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

__global__ void tile_sums(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ sums, long long n) {
  __shared__ uint32_t sh[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  uint32_t acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    long long i = base + (long long)j * SCAN_THREADS + threadIdx.x;
    if (i < n) acc += x[i];
  }
  uint32_t tot = saugns::block_scan_add<SCAN_THREADS>(acc, sh);
  if (threadIdx.x == SCAN_THREADS - 1) sums[blockIdx.x] = tot;
}

// One block: exclusive scan of the m tile sums, in place.
__global__ void scan_sums(uint32_t* __restrict__ sums, long long m) {
  __shared__ uint32_t sh[SCAN_THREADS / 32];
  __shared__ uint32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < m; base += SCAN_THREADS) {
    long long i = base + threadIdx.x;
    uint32_t v = i < m ? sums[i] : 0u;
    uint32_t inc = saugns::block_scan_add<SCAN_THREADS>(v, sh);
    uint32_t c = carry;
    if (i < m) sums[i] = c + inc - v;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = c + inc;
    __syncthreads();
  }
}

__global__ void tile_scan(const uint32_t* __restrict__ x,
                          uint32_t* __restrict__ y,
                          const uint32_t* __restrict__ offs,
                          long long n) {
  __shared__ uint32_t tile[SCAN_TILE];
  __shared__ uint32_t sh[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    tile[t] = i < n ? x[i] : 0u;
  }
  __syncthreads();
  // each thread scans SCAN_ITEMS consecutive elements of the tile
  uint32_t v[SCAN_ITEMS];
  uint32_t acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    acc += tile[threadIdx.x * SCAN_ITEMS + j];
    v[j] = acc;
  }
  uint32_t inc = saugns::block_scan_add<SCAN_THREADS>(acc, sh);
  uint32_t pre = offs[blockIdx.x] + (inc - acc);
  for (int j = 0; j < SCAN_ITEMS; ++j)
    tile[threadIdx.x * SCAN_ITEMS + j] = pre + v[j];
  __syncthreads();
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    if (i < n) y[i] = tile[t];
  }
}

}  // namespace

extern "C" {

// Number of u32 scratch words saugns_scan_add_u32 needs for n elements.
long long saugns_scan_scratch_len(long long n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

// y[i] = x[0] + ... + x[i] mod 2^32, for n >= 1, on `stream`.
// Returns the cudaError_t of the launches.
int saugns_scan_add_u32(const void* x, void* y, void* scratch,
                        long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long m = saugns_scan_scratch_len(n);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* sums = (uint32_t*)scratch;
  tile_sums<<<(unsigned)m, SCAN_THREADS, 0, s>>>((const uint32_t*)x,
                                                 sums, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_sums<<<1, SCAN_THREADS, 0, s>>>(sums, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<<<(unsigned)m, SCAN_THREADS, 0, s>>>((const uint32_t*)x,
                                                 (uint32_t*)y, sums, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
