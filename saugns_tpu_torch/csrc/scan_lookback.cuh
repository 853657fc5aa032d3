// The single-pass scan of kernels 2, 3 and 4: an inclusive scan under a
// commutative, associative operator with an identity -- the prefix sum
// of uint32_t that wraps mod 2^32 (kernel 2), of unsigned long long
// that wraps mod 2^64 (kernel 3), or the running max of int with
// identity 0 (kernel 4) -- by decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).
//
// Bound: bytes. Each element is read once and written once; the
// operator is one or two integer instructions next to that. So the
// design reads and writes each element once, in one launch, and
// converts on the way (the load type and the store type are
// parameters: kernel 2 reads int64, scans the low 32 bits and writes
// them zero-extended):
//  - a tile is LB_TILE elements, 256 threads x 16. It is loaded with
//    16-byte vector loads where the pointer is 16-byte aligned (with
//    scalar loads where it is not, and in the ragged last tile) and
//    staged through shared memory (padded by one element per 128
//    bytes: no bank conflicts for 4- or 8-byte payloads); a thread
//    scans 16 consecutive elements there, reading them once for its
//    sum and once more for its outputs, so that the 8-byte payload
//    keeps few registers and 5 blocks fit on an SM;
//  - rows: the scan runs on each of V rows of n elements on its own,
//    in one launch (the leading axis of a vmapped TPU scan). A row is
//    ceil(n / LB_TILE) tiles, numbered row-major; a tile's look-back
//    stops at its row's first tile, whose prefix is the identity;
//  - n <= LB_TILE is one block a row: no scratch, no look-back, no
//    memset;
//  - more tiles: each block takes its tile index from an atomic counter,
//    not from blockIdx, so a tile waits only on tiles that have already
//    started, and a grid larger than the card holds at once cannot
//    deadlock. It reduces its tile, publishes the aggregate in its
//    status, and one warp walks back over 32 predecessors at a time,
//    combining their aggregates by a warp reduction until it meets an
//    inclusive prefix. It then publishes its own inclusive prefix and
//    writes its outputs.
// The status of a tile is a flag (0 not ready, 1 aggregate, 2
// inclusive prefix) and a payload, held in 64-bit words that are each
// stored and loaded as one aligned access (single-copy atomic), with
// the flag in the high half of every word, so that a reader never
// needs a second, dependent load. Status words are read with strong
// loads in the spin loop (a plain load could be hoisted into a
// register). Two status policies:
//  - LbPacked (kernels 2 and 4, 32-bit payload): one word per tile,
//    the payload in the low half; written with st.release.gpu, read
//    with ld.acquire.gpu;
//  - LbPair (kernel 3, 64-bit payload): the payload leaves no room for
//    a flag in one word, and PTX's memory model makes a .v2 vector
//    access no single atomic access (its elements are accessed
//    separately), so the payload is split over two words, each with
//    the flag beside its 32-bit half. A reader takes a value only when
//    both words carry the same flag: each flag value is written once
//    a call (0 -> 1 -> 2), so equal flags mean both halves come from
//    the same publication. The two words need no order between them,
//    so both are relaxed accesses (st/ld.relaxed.gpu) and their loads
//    are in flight together: one L2 round trip per look-back window,
//    where a flag array beside a payload array needs two (the payload
//    load waits for the flag's acquire).
// The statuses and the counter are one scratch buffer of the caller's;
// the launcher clears them with one cudaMemsetAsync on the launch's
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
// blocks an SM holds: registers <= 51 a thread, and 5 x 34 KB of
// shared memory for the 8-byte payload
constexpr int LB_MIN_BLOCKS = 5;
constexpr unsigned LB_AGGREGATE = 1;
constexpr unsigned LB_INCLUSIVE = 2;

typedef unsigned long long lb_word;

// one padding element per 128 bytes, so that both the striped (load,
// store) and the blocked (scan) accesses of a warp are free of bank
// conflicts (a warp's 8-byte accesses are served as two half-warps)
template <typename T>
__device__ __forceinline__ int lb_pad(int i) {
  return i + i / (128 / (int)sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int lb_smem() {
  return LB_TILE + LB_TILE / (128 / (int)sizeof(T));
}

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

__device__ __forceinline__ lb_word ld_relaxed(const lb_word* p) {
  lb_word v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(lb_word* p, lb_word v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Status of 32-bit payloads: scratch[0] is the tile counter, then one
// word per tile.
template <typename T>
struct LbPacked {
  static_assert(sizeof(T) == 4, "a 32-bit payload");
  typedef lb_word Word;
  lb_word* words;

  __device__ explicit LbPacked(lb_word* scratch) : words(scratch + 1) {}
  // bytes of the scratch the launcher clears: counter and words
  static size_t clear_bytes(long long m) {
    return (size_t)(m + 1) * sizeof(lb_word);
  }
  __device__ Word poll(long long i) const { return ld_acquire(&words[i]); }
  static __device__ unsigned flag(Word w) { return (unsigned)(w >> 32); }
  static __device__ T payload(Word w) { return (T)(uint32_t)w; }
  __device__ void publish(long long b, unsigned f, T v) const {
    st_release(&words[b], ((lb_word)f << 32) | (lb_word)(uint32_t)v);
  }
};

// Status of 64-bit payloads: scratch[0] is the tile counter, then two
// words per tile, (flag, low half) and (flag, high half).
template <typename T>
struct LbPair {
  static_assert(sizeof(T) == 8, "a 64-bit payload");
  struct Word { lb_word lo, hi; };
  lb_word* words;

  __device__ explicit LbPair(lb_word* scratch) : words(scratch + 1) {}
  // bytes of the scratch the launcher clears: counter and words
  static size_t clear_bytes(long long m) {
    return (size_t)(1 + 2 * m) * sizeof(lb_word);
  }
  __device__ Word poll(long long i) const {
    Word w;
    w.lo = ld_relaxed(&words[2 * i]);
    w.hi = ld_relaxed(&words[2 * i + 1]);
    return w;
  }
  // the flag where both words carry the same one, else 0 (not ready)
  static __device__ unsigned flag(Word w) {
    const unsigned a = (unsigned)(w.lo >> 32);
    return a == (unsigned)(w.hi >> 32) ? a : 0u;
  }
  static __device__ T payload(Word w) {
    return (T)((w.hi << 32) | (lb_word)(uint32_t)w.lo);
  }
  __device__ void publish(long long b, unsigned f, T v) const {
    const lb_word hi = (lb_word)f << 32;
    st_relaxed(&words[2 * b], hi | (lb_word)(uint32_t)v);
    st_relaxed(&words[2 * b + 1], hi | ((lb_word)v >> 32));
  }
};

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
    return make_longlong2((long long)tile[lb_pad<T>(e)],
                          (long long)tile[lb_pad<T>(e + 1)]);
  }
};
template <> struct LbVec<int> {
  typedef int4 V;
  template <typename T>
  static __device__ __forceinline__ V make(const T* tile, int e) {
    return make_int4((int)tile[lb_pad<T>(e)], (int)tile[lb_pad<T>(e + 1)],
                     (int)tile[lb_pad<T>(e + 2)],
                     (int)tile[lb_pad<T>(e + 3)]);
  }
};
template <> struct LbVec<float> {
  typedef float4 V;
  template <typename T>
  static __device__ __forceinline__ V make(const T* tile, int e) {
    return make_float4((float)tile[lb_pad<T>(e)],
                       (float)tile[lb_pad<T>(e + 1)],
                       (float)tile[lb_pad<T>(e + 2)],
                       (float)tile[lb_pad<T>(e + 3)]);
  }
};

// tile[t] = (T)x[base + t] for a tile of LB_THREADS x NI elements,
// striped over the block; identity past n. `vec`: the tile is whole and
// x + base is 16-byte aligned.
template <typename T, typename In, int NI = LB_ITEMS>
__device__ void lb_load(const In* __restrict__ x, long long base,
                        long long n, T identity, T* tile, bool vec) {
  constexpr int VN = 16 / sizeof(In);
  if (vec) {
    typedef typename LbVec<In>::V V;
    const V* xv = reinterpret_cast<const V*>(x + base);
#pragma unroll
    for (int j = 0; j < NI / VN; ++j) {
      const int q = j * LB_THREADS + threadIdx.x;
      const V v = xv[q];
#pragma unroll
      for (int k = 0; k < VN; ++k)
        tile[lb_pad<T>(q * VN + k)] = (T)lb_get(v, k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int t = j * LB_THREADS + threadIdx.x;
      const long long i = base + t;
      tile[lb_pad<T>(t)] = i < n ? (T)x[i] : identity;
    }
  }
}

// y[base + t] = (Out)tile[t] for base + t < n, striped over the block
// (a tile of LB_THREADS x NI elements).
template <typename T, typename Out, int NI = LB_ITEMS>
__device__ void lb_store(Out* __restrict__ y, long long base, long long n,
                         const T* tile, bool vec) {
  constexpr int VN = 16 / sizeof(Out);
  if (vec) {
    typedef typename LbVec<Out>::V V;
    V* yv = reinterpret_cast<V*>(y + base);
#pragma unroll
    for (int j = 0; j < NI / VN; ++j) {
      const int q = j * LB_THREADS + threadIdx.x;
      yv[q] = LbVec<Out>::make(tile, q * VN);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int t = j * LB_THREADS + threadIdx.x;
      const long long i = base + t;
      if (i < n) y[i] = (Out)tile[lb_pad<T>(t)];
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

// One warp (all 32 lanes) finds the exclusive prefix of tile
// b > first from the statuses of the tiles first .. b - 1 (the tiles of
// one scan; `first` publishes an inclusive prefix).
template <typename T, typename Op, typename Status>
__device__ T lb_look_back(const Status& st, long long b, T identity,
                          Op op, long long first = 0) {
  const int lane = threadIdx.x & 31;
  T prefix = identity;
  for (long long end = b - 1;; end -= 32) {
    // lane 0 reads the nearest predecessor of the window; lanes before
    // tile `first` count as an inclusive identity
    const long long i = end - lane;
    typename Status::Word w{};
    unsigned f = LB_INCLUSIVE;
    do {
      if (i >= first) {
        w = st.poll(i);
        f = Status::flag(w);
      }
    } while (__any_sync(0xffffffffu, f == 0));
    const unsigned incl = __ballot_sync(0xffffffffu, f == LB_INCLUSIVE);
    // the window counts up to the nearest inclusive prefix
    const int stop = incl ? __ffs(incl) - 1 : 31;
    T p = lane <= stop && i >= first ? Status::payload(w) : identity;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      p = op(p, __shfl_xor_sync(0xffffffffu, p, k));
    prefix = op(p, prefix);
    if (incl) return prefix;
  }
}

// Each of `rows` rows of n elements, y[r, i] = (Out)(identity op
// (T)x[r, 0] op ... op (T)x[r, i]). A row is tpr = ceil(n / LB_TILE)
// tiles, numbered row-major, so no tile straddles two rows. `scratch`
// is null for one tile a row (a block a row, blockIdx.x its tile),
// else it holds the tile counter and the statuses of the gridDim.x
// tiles (laid out by Status, cleared by the launcher); a tile's
// look-back stops at the first tile of its row, which publishes its
// inclusive prefix at once.
template <typename T, typename Op, typename Status, typename In,
          typename Out>
__global__ void __launch_bounds__(LB_THREADS, LB_MIN_BLOCKS)
lookback_scan(const In* __restrict__ x, Out* __restrict__ y,
              lb_word* __restrict__ scratch, long long n, long long tpr,
              T identity) {
  __shared__ T tile[lb_smem<T>()];
  __shared__ T sh[LB_WARPS];
  __shared__ long long s_tile;
  __shared__ T s_prefix;
  const Op op{};
  const int tid = threadIdx.x;
  long long b = blockIdx.x;
  if (scratch != nullptr) {
    if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    b = s_tile;
  }
  const long long row = b / tpr;
  const long long t = b - row * tpr;     // the tile's index in its row
  const long long end = (row + 1) * n;   // one past the row's last
  const long long base = row * n + t * LB_TILE;
  const bool whole = base + LB_TILE <= end;
  lb_load<T>(x, base, end, identity, tile,
             whole && ((uintptr_t)(x + base) & 15) == 0);
  __syncthreads();
  T acc = identity;
#pragma unroll
  for (int j = 0; j < LB_ITEMS; ++j)
    acc = op(acc, tile[lb_pad<T>(tid * LB_ITEMS + j)]);
  T total;
  T ex = lb_block_exclusive(acc, identity, op, sh, total);
  if (scratch != nullptr) {
    const Status st(scratch);
    if (t == 0) {
      if (tid == 0) st.publish(b, LB_INCLUSIVE, total);
    } else {
      if (tid < 32) {
        if (tid == 0) st.publish(b, LB_AGGREGATE, total);
        const T prefix = lb_look_back(st, b, identity, op, b - t);
        if (tid == 0) {
          st.publish(b, LB_INCLUSIVE, op(prefix, total));
          s_prefix = prefix;
        }
      }
      __syncthreads();
      ex = op(s_prefix, ex);
    }
  }
#pragma unroll
  for (int j = 0; j < LB_ITEMS; ++j) {
    T& e = tile[lb_pad<T>(tid * LB_ITEMS + j)];
    ex = op(ex, e);
    e = ex;
  }
  __syncthreads();
  lb_store<T>(y, base, end, tile,
              whole && ((uintptr_t)(y + base) & 15) == 0);
}

// Launch the scan of `rows` >= 1 rows of n >= 1 elements each on `s`:
// one block a row and no scratch for n <= LB_TILE, else one
// cudaMemsetAsync of `scratch` (the counter and the statuses of rows x
// ceil(n / LB_TILE) tiles, laid out by Status) and one launch of a
// block per tile. Returns the cudaError_t of the calls.
template <typename T, typename Op, typename Status, typename In,
          typename Out>
int lookback_scan_launch(const In* x, Out* y, void* scratch, long long n,
                         long long rows, T identity, cudaStream_t s) {
  if (n < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const long long tpr = (n + LB_TILE - 1) / LB_TILE;
  if (tpr > 0x7fffffffLL / rows) return (int)cudaErrorInvalidValue;
  const long long m = rows * tpr;
  lb_word* sc = nullptr;
  if (tpr > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    sc = (lb_word*)scratch;
    const cudaError_t e = cudaMemsetAsync(sc, 0, Status::clear_bytes(m), s);
    if (e != cudaSuccess) return (int)e;
  }
  lookback_scan<T, Op, Status, In, Out><<<(unsigned)m, LB_THREADS, 0, s>>>(
      x, y, sc, n, tpr, identity);
  return (int)cudaGetLastError();
}

}  // namespace
