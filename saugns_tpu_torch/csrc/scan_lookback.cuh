// The single-pass scan of kernels 2 and 4: an inclusive scan of 32-bit
// payloads under a commutative, associative operator with an identity
// -- the prefix sum of uint32_t that wraps mod 2^32, or the running max
// of int with identity 0 -- by decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).
//
// Bound: bytes. Each element is read once and written once; the
// operator is one integer instruction next to that. So the design reads
// and writes each element once, in one launch, and converts on the way
// (the load type and the store type are parameters: kernel 2 reads
// int64, scans the low 32 bits and writes them zero-extended):
//  - a tile is LB_TILE elements, 256 threads x 16. It is loaded with
//    16-byte vector loads where the pointer is 16-byte aligned (with
//    scalar loads where it is not, and in the ragged last tile),
//    staged through shared memory (padded: no bank conflicts) and held
//    in registers, 16 consecutive elements a thread;
//  - n <= LB_TILE is one block: no scratch, no look-back, no memset;
//  - more tiles: each block takes its tile index from an atomic counter,
//    not from blockIdx, so a tile waits only on tiles that have already
//    started, and a grid larger than the card holds at once cannot
//    deadlock. It reduces its tile, publishes the aggregate in its
//    status word, and one warp walks back over 32 predecessors at a
//    time, combining their aggregates by a warp reduction until it
//    meets an inclusive prefix. It then publishes its own inclusive
//    prefix and writes its outputs.
// A status word is 64 bits: the flag (0 not ready, 1 aggregate, 2
// inclusive prefix) in the high half and the payload bits in the low
// half, written with one st.release.gpu and read with ld.acquire.gpu
// (a plain load in the spin loop could be hoisted into a register).
// The words and the counter are one scratch buffer of the caller's;
// the launcher clears it with one cudaMemsetAsync on the launch's
// stream, so a call never sees an earlier call's flags.
//
// Every output is combined with the identity once (for max with
// identity 0: max(0, running max), as the TPU kernel computes it).
#pragma once

#include "common.cuh"

namespace {

constexpr int LB_THREADS = 256;
constexpr int LB_ITEMS = 16;
constexpr int LB_TILE = LB_THREADS * LB_ITEMS;
constexpr int LB_WARPS = LB_THREADS / 32;
// one padding word per 32, so that both the striped (load, store) and
// the blocked (scan) accesses of a warp hit 32 different banks
constexpr int LB_SMEM = LB_TILE + LB_TILE / 32;

typedef unsigned long long lb_word;
constexpr lb_word LB_AGGREGATE = 1ull << 32;
constexpr lb_word LB_INCLUSIVE = 2ull << 32;

__device__ __forceinline__ int lb_pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ lb_word ld_acquire(const lb_word* p) {
  lb_word v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(lb_word* p, lb_word v) {
  asm volatile("st.release.gpu.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename T>
__device__ __forceinline__ lb_word lb_pack(lb_word flag, T v) {
  return flag | (lb_word)(uint32_t)v;
}

template <typename T>
__device__ __forceinline__ T lb_payload(lb_word w) {
  return (T)(uint32_t)w;
}

// 16-byte vectors of the load and store types, element by element
__device__ __forceinline__ long long lb_get(const longlong2& v, int k) {
  return k == 0 ? v.x : v.y;
}
__device__ __forceinline__ int lb_get(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
template <typename E> struct LbVec;
template <> struct LbVec<long long> {
  typedef longlong2 V;
  template <typename T>
  static __device__ __forceinline__ V make(const T* tile, int e) {
    return make_longlong2((long long)tile[lb_pad(e)],
                          (long long)tile[lb_pad(e + 1)]);
  }
};
template <> struct LbVec<int> {
  typedef int4 V;
  template <typename T>
  static __device__ __forceinline__ V make(const T* tile, int e) {
    return make_int4((int)tile[lb_pad(e)], (int)tile[lb_pad(e + 1)],
                     (int)tile[lb_pad(e + 2)], (int)tile[lb_pad(e + 3)]);
  }
};

// tile[t] = (T)x[base + t], striped over the block; identity past n.
// `vec`: the tile is whole and x is 16-byte aligned.
template <typename T, typename In>
__device__ void lb_load(const In* __restrict__ x, long long base,
                        long long n, T identity, T* tile, bool vec) {
  constexpr int VN = 16 / sizeof(In);
  if (vec) {
    typedef typename LbVec<In>::V V;
    const V* xv = reinterpret_cast<const V*>(x + base);
#pragma unroll
    for (int j = 0; j < LB_ITEMS / VN; ++j) {
      const int q = j * LB_THREADS + threadIdx.x;
      const V v = xv[q];
#pragma unroll
      for (int k = 0; k < VN; ++k) tile[lb_pad(q * VN + k)] = (T)lb_get(v, k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < LB_ITEMS; ++j) {
      const int t = j * LB_THREADS + threadIdx.x;
      const long long i = base + t;
      tile[lb_pad(t)] = i < n ? (T)x[i] : identity;
    }
  }
}

// y[base + t] = (Out)tile[t] for base + t < n, striped over the block.
template <typename T, typename Out>
__device__ void lb_store(Out* __restrict__ y, long long base, long long n,
                         const T* tile, bool vec) {
  constexpr int VN = 16 / sizeof(Out);
  if (vec) {
    typedef typename LbVec<Out>::V V;
    V* yv = reinterpret_cast<V*>(y + base);
#pragma unroll
    for (int j = 0; j < LB_ITEMS / VN; ++j) {
      const int q = j * LB_THREADS + threadIdx.x;
      yv[q] = LbVec<Out>::make(tile, q * VN);
    }
  } else {
#pragma unroll
    for (int j = 0; j < LB_ITEMS; ++j) {
      const int t = j * LB_THREADS + threadIdx.x;
      const long long i = base + t;
      if (i < n) y[i] = (Out)tile[lb_pad(t)];
    }
  }
}

// Exclusive scan of one value per thread over the block; `total` gets
// the block's aggregate. `sh` holds LB_WARPS values.
template <typename T, typename Op>
__device__ T lb_block_exclusive(T v, T identity, Op op, T* sh, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, inc, k);
    if (lane >= k) inc = op(t, inc);
  }
  T ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = identity;
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < LB_WARPS ? sh[lane] : identity;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const T t = __shfl_up_sync(0xffffffffu, w, k);
      if (lane >= k) w = op(t, w);
    }
    if (lane < LB_WARPS) sh[lane] = w;
  }
  __syncthreads();
  total = sh[LB_WARPS - 1];
  return warp > 0 ? op(sh[warp - 1], ex) : ex;
}

// One warp (all 32 lanes) finds the exclusive prefix of tile b >= 1
// from the status words of the tiles before it.
template <typename T, typename Op>
__device__ T lb_look_back(const lb_word* words, long long b, T identity,
                          Op op) {
  const int lane = threadIdx.x & 31;
  T prefix = identity;
  for (long long end = b - 1;; end -= 32) {
    // lane 0 reads the nearest predecessor of the window
    const long long i = end - lane;
    lb_word w;
    do {
      w = i >= 0 ? ld_acquire(&words[i]) : lb_pack(LB_INCLUSIVE, identity);
    } while (__any_sync(0xffffffffu, (w >> 32) == 0));
    const unsigned incl =
        __ballot_sync(0xffffffffu, (w & ~0xffffffffull) == LB_INCLUSIVE);
    // the window counts up to the nearest inclusive prefix
    const int stop = incl ? __ffs(incl) - 1 : 31;
    T p = lane <= stop ? lb_payload<T>(w) : identity;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      p = op(p, __shfl_xor_sync(0xffffffffu, p, k));
    prefix = op(p, prefix);
    if (incl) return prefix;
  }
}

// y[i] = (Out)(identity op (T)x[0] op ... op (T)x[i]). `scratch` is
// null for one tile, else it holds a tile counter and one status word
// per tile (LB_TILE tiles, cleared by the launcher).
template <typename T, typename Op, typename In, typename Out>
__global__ void __launch_bounds__(LB_THREADS)
lookback_scan(const In* __restrict__ x, Out* __restrict__ y,
              lb_word* __restrict__ scratch, long long n, T identity,
              bool vin, bool vout) {
  __shared__ T tile[LB_SMEM];
  __shared__ T sh[LB_WARPS];
  __shared__ long long s_tile;
  __shared__ T s_prefix;
  const Op op{};
  const int tid = threadIdx.x;
  long long b = 0;
  if (scratch != nullptr) {
    if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    b = s_tile;
  }
  const long long base = b * LB_TILE;
  const bool whole = base + LB_TILE <= n;
  lb_load<T>(x, base, n, identity, tile, whole && vin);
  __syncthreads();
  T v[LB_ITEMS];
  T acc = identity;
#pragma unroll
  for (int j = 0; j < LB_ITEMS; ++j) {
    acc = op(acc, tile[lb_pad(tid * LB_ITEMS + j)]);
    v[j] = acc;
  }
  T total;
  T ex = lb_block_exclusive(acc, identity, op, sh, total);
  if (scratch != nullptr) {
    lb_word* words = scratch + 1;
    if (b == 0) {
      if (tid == 0) st_release(&words[0], lb_pack(LB_INCLUSIVE, total));
    } else {
      if (tid < 32) {
        if (tid == 0) st_release(&words[b], lb_pack(LB_AGGREGATE, total));
        const T prefix = lb_look_back(words, b, identity, op);
        if (tid == 0) {
          st_release(&words[b], lb_pack(LB_INCLUSIVE, op(prefix, total)));
          s_prefix = prefix;
        }
      }
      __syncthreads();
      ex = op(s_prefix, ex);
    }
  }
#pragma unroll
  for (int j = 0; j < LB_ITEMS; ++j)
    tile[lb_pad(tid * LB_ITEMS + j)] = op(ex, v[j]);
  __syncthreads();
  lb_store<T>(y, base, n, tile, whole && vout);
}

// Launch the scan of n >= 1 elements on `s`: one block and no scratch
// for n <= LB_TILE, else one cudaMemsetAsync of `scratch` (1 + tiles
// 64-bit words) and one launch of a block per tile. Returns the
// cudaError_t of the calls.
template <typename T, typename Op, typename In, typename Out>
int lookback_scan_launch(const In* x, Out* y, void* scratch, long long n,
                         T identity, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long m = (n + LB_TILE - 1) / LB_TILE;
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lb_word* sc = nullptr;
  if (m > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    sc = (lb_word*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, (size_t)(m + 1) * sizeof(lb_word), s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vin = ((uintptr_t)x & 15) == 0;
  const bool vout = ((uintptr_t)y & 15) == 0;
  lookback_scan<T, Op, In, Out><<<(unsigned)m, LB_THREADS, 0, s>>>(
      x, y, sc, n, identity, vin, vout);
  return (int)cudaGetLastError();
}

}  // namespace
