// The three-phase block scan shared by kernels 2, 3 and 4: an inclusive
// scan under an associative operator -- the prefix sum of unsigned
// values (uint32_t or unsigned long long) that wraps mod 2^32 or 2^64
// by the definition of unsigned arithmetic, or the running max of int
// with identity 0.
//
// Bound: bytes. Each element is read once and written once; the adds
// are free next to that. Blocks run in parallel in no order, so the
// scan has three phases: (1) each tile of 2048 elements reduces to one
// total, (2) one block scans the tile totals into exclusive offsets,
// (3) each tile scans itself from shared memory and combines its
// offset. Phases 1 and 3 read the input twice; a decoupled look-back
// would read it once and is left for later.
#pragma once

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

inline long long scan_tiles(long long n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

// The exclusive scan value of this thread: the inclusive value of the
// thread before it (`ex` holds SCAN_THREADS values).
template <typename T>
__device__ T exclusive_of(T inc, T* ex, T identity) {
  ex[threadIdx.x] = inc;
  __syncthreads();
  T r = threadIdx.x > 0 ? ex[threadIdx.x - 1] : identity;
  __syncthreads();
  return r;
}

template <typename T, typename Op>
__global__ void tile_sums(const T* __restrict__ x, T* __restrict__ sums,
                          long long n, T identity) {
  __shared__ T sh[SCAN_THREADS / 32];
  const Op op{};
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  T acc = identity;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    long long i = base + (long long)j * SCAN_THREADS + threadIdx.x;
    if (i < n) acc = op(acc, x[i]);
  }
  T tot = saugns::block_scan<SCAN_THREADS>(acc, sh, identity, op);
  if (threadIdx.x == SCAN_THREADS - 1) sums[blockIdx.x] = tot;
}

// One block: exclusive scan of the m tile totals, in place.
template <typename T, typename Op>
__global__ void scan_sums(T* __restrict__ sums, long long m, T identity) {
  __shared__ T sh[SCAN_THREADS / 32];
  __shared__ T ex[SCAN_THREADS];
  __shared__ T carry;
  const Op op{};
  if (threadIdx.x == 0) carry = identity;
  __syncthreads();
  for (long long base = 0; base < m; base += SCAN_THREADS) {
    long long i = base + threadIdx.x;
    T v = i < m ? sums[i] : identity;
    T inc = saugns::block_scan<SCAN_THREADS>(v, sh, identity, op);
    T pre = exclusive_of(inc, ex, identity);
    T c = carry;
    if (i < m) sums[i] = op(c, pre);
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = op(c, inc);
    __syncthreads();
  }
}

template <typename T, typename Op>
__global__ void tile_scan(const T* __restrict__ x, T* __restrict__ y,
                          const T* __restrict__ offs, long long n,
                          T identity) {
  __shared__ T tile[SCAN_TILE];
  __shared__ T sh[SCAN_THREADS / 32];
  __shared__ T ex[SCAN_THREADS];
  const Op op{};
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    tile[t] = i < n ? x[i] : identity;
  }
  __syncthreads();
  // each thread scans SCAN_ITEMS consecutive elements of the tile
  T v[SCAN_ITEMS];
  T acc = identity;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    acc = op(acc, tile[threadIdx.x * SCAN_ITEMS + j]);
    v[j] = acc;
  }
  T inc = saugns::block_scan<SCAN_THREADS>(acc, sh, identity, op);
  T pre = op(offs[blockIdx.x], exclusive_of(inc, ex, identity));
  for (int j = 0; j < SCAN_ITEMS; ++j)
    tile[threadIdx.x * SCAN_ITEMS + j] = op(pre, v[j]);
  __syncthreads();
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    if (i < n) y[i] = tile[t];
  }
}

// y[i] = x[0] op ... op x[i], for n >= 1, on `stream`; scratch holds
// scan_tiles(n) values of T. Every output is combined with `identity`
// once (for max with identity 0: max(0, running max)). Returns the
// cudaError_t of the launches.
template <typename T, typename Op>
int block_scan_launch(const T* x, T* y, T* sums, long long n, T identity,
                      cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long m = scan_tiles(n);
  tile_sums<T, Op><<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, sums, n,
                                                        identity);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_sums<T, Op><<<1, SCAN_THREADS, 0, s>>>(sums, m, identity);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<T, Op><<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, y, sums, n,
                                                        identity);
  return (int)cudaGetLastError();
}

// The wrapping prefix sum of kernels 2 and 3.
template <typename T>
int scan_add(const T* x, T* y, T* sums, long long n, cudaStream_t s) {
  return block_scan_launch<T, saugns::AddOp>(x, y, sums, n, T(0), s);
}

}  // namespace
