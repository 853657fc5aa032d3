// The three-phase block scan shared by kernels 2 and 3: an inclusive
// prefix sum of unsigned values (uint32_t or unsigned long long) that
// wraps mod 2^32 or 2^64 by the definition of unsigned arithmetic.
//
// Bound: bytes. Each element is read once and written once; the adds
// are free next to that. Blocks run in parallel in no order, so the
// scan has three phases: (1) each tile of 2048 elements reduces to one
// sum, (2) one block scans the tile sums into exclusive offsets, (3)
// each tile scans itself from shared memory and adds its offset.
// Phases 1 and 3 read the input twice; a decoupled look-back would
// read it once and is left for later.
#pragma once

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

inline long long scan_tiles(long long n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

template <typename T>
__global__ void tile_sums(const T* __restrict__ x, T* __restrict__ sums,
                          long long n) {
  __shared__ T sh[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  T acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    long long i = base + (long long)j * SCAN_THREADS + threadIdx.x;
    if (i < n) acc += x[i];
  }
  T tot = saugns::block_scan_add<SCAN_THREADS>(acc, sh);
  if (threadIdx.x == SCAN_THREADS - 1) sums[blockIdx.x] = tot;
}

// One block: exclusive scan of the m tile sums, in place.
template <typename T>
__global__ void scan_sums(T* __restrict__ sums, long long m) {
  __shared__ T sh[SCAN_THREADS / 32];
  __shared__ T carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < m; base += SCAN_THREADS) {
    long long i = base + threadIdx.x;
    T v = i < m ? sums[i] : T(0);
    T inc = saugns::block_scan_add<SCAN_THREADS>(v, sh);
    T c = carry;
    if (i < m) sums[i] = c + inc - v;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = c + inc;
    __syncthreads();
  }
}

template <typename T>
__global__ void tile_scan(const T* __restrict__ x, T* __restrict__ y,
                          const T* __restrict__ offs, long long n) {
  __shared__ T tile[SCAN_TILE];
  __shared__ T sh[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    tile[t] = i < n ? x[i] : T(0);
  }
  __syncthreads();
  // each thread scans SCAN_ITEMS consecutive elements of the tile
  T v[SCAN_ITEMS];
  T acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    acc += tile[threadIdx.x * SCAN_ITEMS + j];
    v[j] = acc;
  }
  T inc = saugns::block_scan_add<SCAN_THREADS>(acc, sh);
  T pre = offs[blockIdx.x] + (inc - acc);
  for (int j = 0; j < SCAN_ITEMS; ++j)
    tile[threadIdx.x * SCAN_ITEMS + j] = pre + v[j];
  __syncthreads();
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    if (i < n) y[i] = tile[t];
  }
}

// y[i] = x[0] + ... + x[i], wrapping, for n >= 1, on `stream`; scratch
// holds scan_tiles(n) values of T. Returns the cudaError_t of the
// launches.
template <typename T>
int scan_add(const T* x, T* y, T* sums, long long n, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long m = scan_tiles(n);
  tile_sums<T><<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, sums, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_sums<T><<<1, SCAN_THREADS, 0, s>>>(sums, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<T><<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, y, sums, n);
  return (int)cudaGetLastError();
}

}  // namespace
