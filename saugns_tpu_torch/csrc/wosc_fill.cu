// Kernel 1: the fused wave-oscillator fill, one launch a call.
//
// Replaces the Pallas kernel _wosc_fill_flat / _wosc_fill_factory
// (saugns_tpu/render/jdsp.py:2247 and :2144; API wosc_s_filled, :2344).
// For V rows of u32 phases (int64 as the callers hold them; only the
// low 32 bits count) it computes, per sample, the PILUT differentiation
// of wosc.h:238-266:
//
//   s = DVSCALE * (Is(ph[i]) - Is(prev)) / pd + DVOFFSET, pd = ph[i] - prev
//
// where prev is the previous sample's phase, the row's seed phase pp at
// the row head, or rst_prev at an unconsumed reset (row index fi), and
// holds the last valid s where pd == 0 (seeded with the row's ps).
//
// Arithmetic: Is is the Hermite interpolation of sauWave_get_herp in
// float64, one op at a time (common.cuh's herp64; the build uses
// -fmad=false), DVSCALE / pd is a correctly rounded float32 divide
// (__fdiv_rn), and the sum rounds once to float32 -- the f64 chain of
// _herp64_taps / _wosc_s64 (jdsp.py:546-581), bit for bit.
//
// Bound, on the H100: 8 B of int64 phase in and 4 B of sample out a
// sample (12 B), against the conversion unit's 16 float32<->float64
// conversions a clock and SM (10 a sample, counted in the SASS) and the
// float64 unit's 64 unfused operations a clock and SM (18 a sample): at
// 2^22 samples the bytes take ~15 us and the conversions ~10 us, so the
// bytes bind, with the conversions close. Measured, the kernel takes
// ~2.7x that at 2^22, and as long with the Hermite taken out: what
// holds it is the per-tile sequence (tile counter, load, barriers, the
// release fence of the status, store) that it shares with the
// look-back scans, not the float64 work (PERF.md). At the main path's
// 131,072 samples a call is host-bound. The design reads and writes
// each sample once, in one launch:
//  - the callers' int64 phases are read as they are (no conversion
//    pass): a tile of 256 threads x WF_ITEMS consecutive samples of one
//    row is loaded with 16-byte vector loads where the row's address is
//    16-byte aligned (scalar loads in a row's ragged last tile and in
//    odd views), staged as u32 in shared memory, and written back as
//    float4 through shared memory the same way;
//  - one Hermite a sample: a thread computes Is of its WF_ITEMS phases
//    and pairs each with the one before it (the shifted-Is identity of
//    jdsp.py:2163-2168); its first sample takes the previous lane's
//    last Is by a shuffle, a warp's lane 0 the previous warp's through
//    shared memory, and only the block's first thread computes one
//    extra Is, of the phase before the tile (ph[start - 1], or pp at
//    the row head); the sample at an
//    unconsumed reset pairs with Is(rst_prev) instead, and the next one
//    with Is(ph[fi]) as usual -- the same herp64 of the same phases;
//  - the pd == 0 hold in the same pass, as a look-back: a tile's status
//    (LbPacked / MaxOp of scan_lookback.cuh, as kernel 4) is the row
//    index + 1 of its row's last valid sample so far, 0 for none. A
//    tile with a valid sample knows that at once: the thread that holds
//    the sample stores it and publishes the index (st.release). A tile
//    with none publishes an aggregate 0, and only a tile that starts in
//    a pd == 0 run looks back, over its row's tiles only; it reads the
//    carry out[j - 1] after an acquire of the status of the tile that
//    holds j - 1, or takes ps for j == 0. Tiles never cross rows; a
//    row's first tile needs no look-back;
//  - the 8 KB PILUT is staged once a block. (Kernel 5's table of every
//    cell's float64 coefficients, common.cuh's CoefIs, leaves one
//    conversion in Is but costs a 2,048-cell prologue a block: it
//    measured slower here at 2^22 and level at the main path's n.)
//  - a persistent grid of a few blocks an SM (the SM count asked once a
//    device) walks the tiles in the order of an atomic counter, so a
//    tile waits only on tiles already taken and no grid can deadlock.
//    A row of one tile needs no status: then the grid walks the tiles by
//    block index, with no scratch and no memset.

#include "scan_lookback.cuh"

namespace {

constexpr int WF_ITEMS = 8;                   // samples a thread
constexpr int WF_TILE = LB_THREADS * WF_ITEMS;
constexpr int WF_WORDS = WF_TILE + WF_TILE / 32;  // padded (lb_pad)
constexpr int WF_PER_SM = 4;                  // blocks an SM, at most

struct Seeds {
  const long long* pp;    // (V,) row head's previous phase
  const float* ps;        // (V,) hold seed
  const long long* fi;    // (V,) row index of an unconsumed reset
  const uint8_t* drst;    // (V,) reset pending
  const long long* rph;   // (V,) phase the reset sample pairs with
};

__device__ __forceinline__ float ld_relaxed_f32(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.f32 %0, [%1];"
               : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// `scratch`: null when every row is one tile (tpr == 1); else the tile
// counter and one LbPacked status word a tile, cleared by the launcher.
// At most 64 registers a thread, so that WF_PER_SM blocks fit on an SM.
__global__ void __launch_bounds__(LB_THREADS, WF_PER_SM)
wosc_fill_k(const long long* __restrict__ ph, Seeds sd,
            const float* __restrict__ pilut, float dvs, float dvo,
            float* __restrict__ out, lb_word* __restrict__ scratch,
            long long L, long long tpr, long long m) {
  __shared__ float tab[saugns::LEN];
  __shared__ uint32_t sph[WF_WORDS];
  __shared__ float sout[WF_WORDS];
  __shared__ int sh[LB_WARPS];
  __shared__ long long s_tile;
  __shared__ uint32_t s_pred;
  __shared__ float s_carry;
  __shared__ double s_last[LB_WARPS];   // each warp's last Is
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = tid * WF_ITEMS;            // the thread's first item
  for (int k = tid; k < saugns::LEN; k += LB_THREADS) tab[k] = pilut[k];
  const auto is = [&](uint32_t p) { return saugns::herp64(tab, p); };
  const LbPacked<int> st(scratch);
  const saugns::MaxOp op{};
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
    const long long start = t * WF_TILE;
    const long long* row = ph + r * L;
    float* orow = out + r * L;
    const bool whole = start + WF_TILE <= L;
    if (tid == 0) s_pred = (uint32_t)(t == 0 ? sd.pp[r] : row[start - 1]);
    lb_load<uint32_t, long long, WF_ITEMS>(
        row, start, L, 0u, sph, whole && aligned16(row + start));
    __syncthreads();   // also orders the table's staging

    // Is of the thread's phases
    const long long p0 = start + i0;
    uint32_t cur[WF_ITEMS];
    double isc[WF_ITEMS];
#pragma unroll
    for (int j = 0; j < WF_ITEMS; ++j) {
      cur[j] = sph[lb_pad<uint32_t>(i0 + j)];
      isc[j] = is(cur[j]);
    }
    if (lane == 31) s_last[warp] = isc[WF_ITEMS - 1];
    // an unconsumed reset in this thread's run
    const long long fi = sd.drst[r] ? sd.fi[r] : -1;
    uint32_t rp = 0;
    double isr = 0.0;
    if (fi >= p0 && fi < p0 + WF_ITEMS) {
      rp = (uint32_t)sd.rph[r];
      isr = is(rp);
    }

    // raw samples past the thread's first (the first waits for the Is
    // before it); lv = row index + 1 of the thread's last valid one
    const uint32_t pred = tid == 0 ? s_pred : sph[lb_pad<uint32_t>(i0 - 1)];
    float s[WF_ITEMS];
    unsigned vmask = 0;
    int lv = 0;
    int pd0 = 0;
#pragma unroll
    for (int j = 0; j < WF_ITEMS; ++j) {
      const long long pos = p0 + j;
      uint32_t prev = j ? cur[j - 1] : pred;
      double isv = j ? isc[j - 1] : 0.0;
      if (pos == fi) {
        prev = rp;
        isv = isr;
      }
      const int pd = (int)(cur[j] - prev);
      s[j] = 0.0f;
      if (pd != 0 && pos < L) {
        if (j) s[j] = saugns::wosc_sample(isv, isc[j], pd, dvs, dvo);
        vmask |= 1u << j;
        lv = (int)(pos + 1);
      }
      if (!j) pd0 = pd;
    }
    int total;
    const int ex = lb_block_exclusive(lv, 0, op, sh, total);
    // the first sample: Is of the phase before it from the lane before,
    // the warp before (s_last, ordered by the scan's barriers) or, in
    // the block's first thread, a Hermite of its own
    double isp = __shfl_up_sync(0xffffffffu, isc[WF_ITEMS - 1], 1);
    if (lane == 0) isp = warp ? s_last[warp - 1] : is(pred);
    if (vmask & 1u)
      s[0] = saugns::wosc_sample(p0 == fi ? isr : isp, isc[0], pd0, dvs,
                                 dvo);
#pragma unroll
    for (int j = 0; j < WF_ITEMS; ++j) sout[lb_pad<float>(i0 + j)] = s[j];
    // the tile starts in a pd == 0 run: its first samples need the carry
    const int needc = __syncthreads_or(ex == 0 && !(vmask & 1u) && p0 < L);

    // the hold inside the tile (sources are valid samples, never
    // written here); samples before the tile's first valid one wait
    int jv = ex;
#pragma unroll
    for (int j = 0; j < WF_ITEMS; ++j) {
      if (vmask >> j & 1u)
        jv = (int)(p0 + j + 1);
      else if (jv > 0)
        sout[lb_pad<float>(i0 + j)] = sout[lb_pad<float>(
            (int)(jv - 1 - start))];
    }

    float carry = sd.ps[r];
    if (scratch != nullptr) {
      if (total > 0) {
        // the thread that holds the tile's last valid sample stores it
        // before it publishes, so that followers may read it
        const long long q = total - 1 - p0;
        if (q >= 0 && q < WF_ITEMS) {
          orow[total - 1] = sout[lb_pad<float>(i0 + (int)q)];
          st.publish(b, LB_INCLUSIVE, total);
        }
      } else if (tid == 0) {
        st.publish(b, t == 0 ? LB_INCLUSIVE : LB_AGGREGATE, 0);
      }
      if (needc && t > 0) {
        if (tid < 32) {
          const int jj = lb_look_back(st, b, 0, op, b - t);
          if (tid == 0) {
            if (total == 0) st.publish(b, LB_INCLUSIVE, jj);
            if (jj > 0) {
              // acquire the holder's status, then read its sample
              (void)st.poll(b - t + (jj - 1) / WF_TILE);
              s_carry = ld_relaxed_f32(orow + jj - 1);
            } else {
              s_carry = carry;
            }
          }
        }
        __syncthreads();
        carry = s_carry;
      }
    }
    if (needc) {
#pragma unroll
      for (int j = 0; j < WF_ITEMS; ++j)
        if (ex == 0 && !(vmask & ((2u << j) - 1u)) && p0 + j < L)
          sout[lb_pad<float>(i0 + j)] = carry;
    }
    __syncthreads();
    lb_store<float, float, WF_ITEMS>(orow, start, L, sout,
                                     whole && aligned16(orow + start));
  }
}

}  // namespace

extern "C" {

// Samples a tile (a row of more than one tile takes 1 + V * tiles a
// row 64-bit scratch words).
int saugns_wosc_fill_tile() { return WF_TILE; }

// out (V, L) f32 from ph (V, L) int64 (only the low 32 bits count) and
// the (V,) seeds pp (int64), ps (f32), fi (int64), drst (bool), rph
// (int64), on `stream`. `scratch` is null for L <= WF_TILE, else
// 1 + V * ceil(L / WF_TILE) 64-bit words, cleared here by one
// cudaMemsetAsync. Returns the cudaError_t of the calls.
int saugns_wosc_fill(const void* ph, const void* pp, const void* ps,
                     const void* fi, const void* drst, const void* rph,
                     const void* pilut, float dvs, float dvo, void* out,
                     void* scratch, long long row_len, int n_rows,
                     void* stream) {
  if (row_len < 1 || n_rows < 1 || row_len >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long tpr = (row_len + WF_TILE - 1) / WF_TILE;
  const long long m = tpr * n_rows;
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  lb_word* sc = nullptr;
  if (tpr > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    sc = (lb_word*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, LbPacked<int>::clear_bytes(m), s);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  const cudaError_t e = saugns::sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  // a tile a block, at most WF_PER_SM blocks an SM
  const long long blocks = m < (long long)sms * WF_PER_SM
                               ? m : (long long)sms * WF_PER_SM;
  const Seeds sd{(const long long*)pp, (const float*)ps,
                 (const long long*)fi, (const uint8_t*)drst,
                 (const long long*)rph};
  wosc_fill_k<<<(unsigned)blocks, LB_THREADS, 0, s>>>(
      (const long long*)ph, sd, (const float*)pilut, dvs, dvo,
      (float*)out, sc, row_len, tpr, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
