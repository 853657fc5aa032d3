// Kernel 10: the forward fill of the last valid value, and with a
// per-row length the sequential engine's whole pd == 0 hold, in one
// launch.
//
// Replaces the Pallas kernel _forward_fill_flat
// (saugns_tpu/render/jdsp.py:2025, body _ffill_kernel_factory :1993;
// API forward_fill_last_valid :2055). For n rows of L float32 values,
// a valid mask and one seed per row it computes the last-valid fill
//
//   fill[i] = s[j] at the last valid j <= i of the row, else the seed.
//
// With a per-row `length` it is forward_fill_valid (jdsp.py:816) bit
// for bit. That function picks one of three branches per row, and the
// branches agree at every i < length (an isolated invalid position's
// predecessor is valid, and the shift at position 0 takes the seed);
// past length a row gets, by what lies in range (i < length):
//  - s[i] when no position in range is invalid ("bad");
//  - else valid[i] ? s[i] : s[i - 1] when no two adjacent positions in
//    range are bad (no "pair");
//  - else fill[i].
// length <= 0 gives s as it is, length >= L the fill. Values are moved
// as 32-bit words, never by float arithmetic: NaN payloads and -0.0
// come out as they went in.
//
// Bound: bytes -- 4 B of value and 1 B of mask in and 4 B out a
// position (9 B), plus the row's seed (4 B) and length (8 B). The TPU
// kernel scanned each tile by log-doubling in VMEM and carried the
// hold across its in-order grid in SMEM; here blocks run in no order,
// so the carry and the row-wide branch flags are one single-pass
// decoupled look-back (scan_lookback.cuh), over a row's own tiles:
//  - a tile is FF_TILE = 2,048 positions of one row (256 threads x 8
//    consecutive ones, read with two 16-byte loads of values and one
//    8-byte load of mask a thread where aligned, scalar loads in a
//    ragged last tile and in odd views); rows never share a tile;
//  - a tile's status (LbPacked, one 64-bit word) is a 32-bit payload:
//    its row's last valid index + 1 so far in the low 30 bits (so
//    L < 2^30), "bad" and "pair" in the top two, combined by FillOp
//    (max of the low field, OR of the flags; identity 0). The pair at
//    a tile's first position reads the mask of the position before it
//    directly: its status is not needed for that;
//  - every tile publishes its aggregate at once, as inclusive when it
//    knows its prefix: at its row's head, or with a valid position (the
//    max field is then its own) where the flags are final -- a row
//    without a split at length carries none, and a tile that holds a
//    pair has both set;
//  - only a tile that starts on an invalid position, or holds positions
//    at or past length while its row's flags are open, looks back, one
//    warp over its row's tiles (lb_look_back with `first` = the row's
//    head), then publishes its inclusive prefix;
//  - the carry is an index: a held value is the input s at the last
//    valid index, read from s itself (an input: no release or acquire
//    orders it), or the seed;
//  - a persistent grid of FF_PER_SM blocks an SM (the SM count asked
//    once a device) takes tiles in the order of an atomic counter, so
//    a tile waits only on tiles already taken and no grid can
//    deadlock. Rows of one tile need no status: then the grid walks
//    the tiles by block index, with no scratch and no memset.
// Measured (PERF.md): at 4 x 2^20 about 2x the byte bound, as
// fast with the look-back taken out (the per-tile sequence of counter,
// load, barriers and store holds it, as in kernel 1), and 8 blocks an
// SM (30 registers) beat 4 by 10-15%.

#include "scan_lookback.cuh"

namespace {

constexpr int FF_ITEMS = 8;                   // positions a thread
constexpr int FF_TILE = LB_THREADS * FF_ITEMS;
constexpr int FF_PER_SM = 8;                  // blocks an SM, at most
constexpr unsigned FF_LV = (1u << 30) - 1;    // last valid index + 1
constexpr unsigned FF_BAD = 1u << 30;         // invalid in range
constexpr unsigned FF_PAIR = 1u << 31;        // two adjacent ones

struct FillOp {
  __device__ unsigned operator()(unsigned a, unsigned b) const {
    const unsigned la = a & FF_LV, lb = b & FF_LV;
    return (la > lb ? la : lb) | ((a | b) & ~FF_LV);
  }
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// `s` and `seeds` are the float32 values as 32-bit words; `length` is
// null for the plain fill. `scratch`: null when every row is one tile
// (tpr == 1); else the tile counter and one LbPacked status word a
// tile, cleared by the launcher.
__global__ void __launch_bounds__(LB_THREADS, FF_PER_SM)
ffill_k(const unsigned* __restrict__ s, const uint8_t* __restrict__ valid,
        const unsigned* __restrict__ seeds,
        const long long* __restrict__ length, unsigned* __restrict__ out,
        lb_word* __restrict__ scratch, long long L, long long tpr,
        long long m) {
  __shared__ unsigned sh[LB_WARPS];
  __shared__ long long s_tile;
  __shared__ unsigned s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const LbPacked<unsigned> st(scratch);
  const FillOp op{};
  for (long long k = blockIdx.x;; k += gridDim.x) {
    long long b = k;
    if (scratch != nullptr) {
      if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
      __syncthreads();
      b = s_tile;
    }
    if (b >= m) break;
    const long long r = b / tpr;
    const long long t = b - r * tpr;
    const long long start = t * FF_TILE;
    const long long end = start + FF_TILE < L ? start + FF_TILE : L;
    const unsigned* srow = s + r * L;
    const uint8_t* vrow = valid + r * L;
    unsigned* orow = out + r * L;
    const long long len = length != nullptr ? length[r] : L;
    const bool copy = len <= 0;           // s as it is
    const bool split = !copy && len < L;  // the branches past length
    const long long lim = split ? len : 0;  // bad positions lie below
    const long long p0 = start + tid * FF_ITEMS;

    // the thread's values and mask bits (none past L)
    unsigned v[FF_ITEMS];
    unsigned vm = 0;
    const bool whole = start + FF_TILE <= L;
    if (whole && aligned(srow + start, 16)) {
      const uint4* q = reinterpret_cast<const uint4*>(srow + p0);
      const uint4 a = q[0], c = q[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < FF_ITEMS; ++j)
        v[j] = p0 + j < L ? srow[p0 + j] : 0u;
    }
    if (whole && aligned(vrow + start, 8)) {
      const uint2 w = *reinterpret_cast<const uint2*>(vrow + p0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vm |= ((w.x >> 8 * j) & 0xffu) != 0 ? 1u << j : 0u;
        vm |= ((w.y >> 8 * j) & 0xffu) != 0 ? 1u << (j + 4) : 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < FF_ITEMS; ++j)
        if (p0 + j < L && vrow[p0 + j]) vm |= 1u << j;
    }

    // the thread's aggregate: last valid index + 1, bad, pair (the
    // position before the thread's first from the lane before, or for
    // lane 0 from the mask)
    unsigned bad = 0;
#pragma unroll
    for (int j = 0; j < FF_ITEMS; ++j)
      if (p0 + j < lim && !(vm >> j & 1u)) bad |= 1u << j;
    unsigned prev = __shfl_up_sync(0xffffffffu, bad, 1) >> (FF_ITEMS - 1);
    if (lane == 0) prev = p0 > 0 && p0 - 1 < lim && !vrow[p0 - 1];
    unsigned agg = vm ? (unsigned)(p0 + 32 - __clz((int)vm)) : 0u;
    if (bad) agg |= FF_BAD;
    if (bad & ((bad << 1) | (prev & 1u))) agg |= FF_PAIR;
    unsigned total;
    unsigned ex = lb_block_exclusive(agg, 0u, op, sh, total);

    if (scratch != nullptr) {
      const bool incl = t == 0 || ((total & FF_LV) != 0
                                   && (!split || (total & FF_PAIR)));
      const bool open = split && end > len && !(total & FF_PAIR);
      const bool look = t > 0 && ((!copy && !vrow[start]) || open);
      if (tid == 0) st.publish(b, incl ? LB_INCLUSIVE : LB_AGGREGATE,
                               total);
      if (look) {
        if (tid < 32) {
          const unsigned p = lb_look_back(st, b, 0u, op, b - t);
          if (tid == 0) {
            if (!incl) st.publish(b, LB_INCLUSIVE, op(p, total));
            s_prefix = p;
          }
        }
        __syncthreads();
        ex = op(s_prefix, ex);
        total = op(s_prefix, total);
      }
    } else {
      __syncthreads();   // sh is read above and written by the next tile
    }

    // the row's flags (final where a position lies at or past length)
    const bool fbad = total & FF_BAD;
    const bool fpair = total & FF_PAIR;
    // the value held before the thread's first position
    unsigned hv = 0u;
    if (!copy && !(vm & 1u) && p0 < L) {
      const unsigned h = ex & FF_LV;
      hv = h ? srow[h - 1] : seeds[r];
    }
    unsigned o[FF_ITEMS];
#pragma unroll
    for (int j = 0; j < FF_ITEMS; ++j) {
      const long long pos = p0 + j;
      const bool vj = vm >> j & 1u;
      if (vj) hv = v[j];
      unsigned y = hv;
      if (copy || (split && pos >= len && !fpair && (!fbad || vj)))
        y = v[j];
      else if (split && pos >= len && !fpair && pos < L)
        y = j ? v[j - 1] : srow[pos - 1];   // pos >= len >= 1
      o[j] = y;
    }
    if (whole && aligned(orow + start, 16)) {
      uint4* q = reinterpret_cast<uint4*>(orow + p0);
      q[0] = make_uint4(o[0], o[1], o[2], o[3]);
      q[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < FF_ITEMS; ++j)
        if (p0 + j < L) orow[p0 + j] = o[j];
    }
  }
}

}  // namespace

extern "C" {

// Positions a tile (a row of more than one tile takes 1 + n * tiles a
// row 64-bit scratch words).
int saugns_ffill_tile() { return FF_TILE; }

// out (n, L) f32 from s (n, L) f32, valid (n, L) bool, seeds (n,) f32
// and `length` (n,) int64 or null, on `stream`. `scratch` is null for
// L <= FF_TILE, else 1 + n * ceil(L / FF_TILE) 64-bit words, cleared
// here by one cudaMemsetAsync. Returns the cudaError_t of the calls.
int saugns_ffill(const void* s, const void* valid, const void* seeds,
                 const void* length, void* out, void* scratch,
                 long long row_len, int n_rows, void* stream) {
  if (row_len < 1 || n_rows < 1 || row_len > (long long)FF_LV)
    return (int)cudaErrorInvalidValue;
  const long long tpr = (row_len + FF_TILE - 1) / FF_TILE;
  const long long m = tpr * n_rows;
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  lb_word* sc = nullptr;
  if (tpr > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    sc = (lb_word*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, LbPacked<unsigned>::clear_bytes(m), st);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  const cudaError_t e = saugns::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = m < (long long)sms * FF_PER_SM
                               ? m : (long long)sms * FF_PER_SM;
  ffill_k<<<(unsigned)blocks, LB_THREADS, 0, st>>>(
      (const unsigned*)s, (const uint8_t*)valid, (const unsigned*)seeds,
      (const long long*)length, (unsigned*)out, sc, row_len, tpr, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
