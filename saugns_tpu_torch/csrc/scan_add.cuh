// The three-phase block scan of kernel 3: the inclusive prefix sum of
// unsigned long long that wraps mod 2^64.
//
// Bound: bytes. Each element is read once and written once; the adds
// are free next to that. Phases: (1) each tile of 2048 elements reduces
// to one total, (2) one block scans the tile totals into exclusive
// offsets, (3) each tile scans itself from shared memory and adds its
// offset. Phases 1 and 3 read the input twice. Kernels 2 and 4 use the
// single-pass look-back of scan_lookback.cuh, whose status word packs a
// flag and a 32-bit payload into 64 bits; a 64-bit payload needs a
// status design of its own, so kernel 3 keeps this scan.
#pragma once

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

inline long long scan_tiles(long long n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

// The exclusive scan value of this thread: the inclusive value of the
// thread before it (`ex` holds SCAN_THREADS values).
__device__ u64 exclusive_of(u64 inc, u64* ex) {
  ex[threadIdx.x] = inc;
  __syncthreads();
  u64 r = threadIdx.x > 0 ? ex[threadIdx.x - 1] : 0ull;
  __syncthreads();
  return r;
}

__global__ void tile_sums(const u64* __restrict__ x, u64* __restrict__ sums,
                          long long n) {
  __shared__ u64 sh[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  u64 acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    long long i = base + (long long)j * SCAN_THREADS + threadIdx.x;
    if (i < n) acc += x[i];
  }
  u64 tot = saugns::block_scan<SCAN_THREADS>(acc, sh, 0ull,
                                             saugns::AddOp{});
  if (threadIdx.x == SCAN_THREADS - 1) sums[blockIdx.x] = tot;
}

// One block: exclusive scan of the m tile totals, in place.
__global__ void scan_sums(u64* __restrict__ sums, long long m) {
  __shared__ u64 sh[SCAN_THREADS / 32];
  __shared__ u64 ex[SCAN_THREADS];
  __shared__ u64 carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < m; base += SCAN_THREADS) {
    long long i = base + threadIdx.x;
    u64 v = i < m ? sums[i] : 0ull;
    u64 inc = saugns::block_scan<SCAN_THREADS>(v, sh, 0ull,
                                               saugns::AddOp{});
    u64 pre = exclusive_of(inc, ex);
    u64 c = carry;
    if (i < m) sums[i] = c + pre;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = c + inc;
    __syncthreads();
  }
}

__global__ void tile_scan(const u64* __restrict__ x, u64* __restrict__ y,
                          const u64* __restrict__ offs, long long n) {
  __shared__ u64 tile[SCAN_TILE];
  __shared__ u64 sh[SCAN_THREADS / 32];
  __shared__ u64 ex[SCAN_THREADS];
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    tile[t] = i < n ? x[i] : 0ull;
  }
  __syncthreads();
  // each thread scans SCAN_ITEMS consecutive elements of the tile
  u64 v[SCAN_ITEMS];
  u64 acc = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    acc += tile[threadIdx.x * SCAN_ITEMS + j];
    v[j] = acc;
  }
  u64 inc = saugns::block_scan<SCAN_THREADS>(acc, sh, 0ull,
                                             saugns::AddOp{});
  u64 pre = offs[blockIdx.x] + exclusive_of(inc, ex);
  for (int j = 0; j < SCAN_ITEMS; ++j)
    tile[threadIdx.x * SCAN_ITEMS + j] = pre + v[j];
  __syncthreads();
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int t = j * SCAN_THREADS + threadIdx.x;
    long long i = base + t;
    if (i < n) y[i] = tile[t];
  }
}

// y[i] = x[0] + ... + x[i] mod 2^64, for n >= 1, on `s`; `sums` holds
// scan_tiles(n) values. Returns the cudaError_t of the launches.
int scan_add_u64(const u64* x, u64* y, u64* sums, long long n,
                 cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long m = scan_tiles(n);
  tile_sums<<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, sums, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_sums<<<1, SCAN_THREADS, 0, s>>>(sums, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_scan<<<(unsigned)m, SCAN_THREADS, 0, s>>>(x, y, sums, n);
  return (int)cudaGetLastError();
}

}  // namespace
