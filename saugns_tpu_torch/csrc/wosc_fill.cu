// Kernel 1: the fused wave-oscillator fill.
//
// Replaces the Pallas kernel _wosc_fill_flat / _wosc_fill_factory
// (saugns_tpu/render/jdsp.py:2247 and :2144; API wosc_s_filled, :2344).
// For V rows of u32 phases it computes, per sample, the PILUT
// differentiation of wosc.h:238-266:
//
//   s = DVSCALE * (Is(ph[i]) - Is(prev)) / pd + DVOFFSET, pd = ph[i] - prev
//
// where prev is the previous sample's phase, the row's seed phase pp at
// the row head, or rst_prev at an unconsumed reset (row index fi), and
// holds the last valid s where pd == 0 (seeded with the row's ps).
//
// Arithmetic: Is is the Hermite interpolation of sauWave_get_herp in
// float64, one op at a time (__dmul_rn / __dadd_rn, and the build uses
// -fmad=false), DVSCALE / pd is a correctly rounded float32 divide
// (__fdiv_rn), and the sum rounds once to float32 -- the f64 chain of
// _herp64_taps / _wosc_s64 (jdsp.py:546-581), bit for bit.
//
// Bound: bytes -- 4 B of phase in and 4 B of sample out per element
// (plus the per-row seeds); about 60 float64 operations per element
// stay far below the card's float64 rate at that traffic. The PILUT
// (8 KB) sits in shared memory, so the tap gathers never touch device
// memory. The TPU kernel ran its grid in order and carried the
// previous Is and the hold value from tile to tile in SMEM; blocks here
// run in no order, so the hold is the second pass of hold.cuh (shared
// with kernel 10): pass 1 writes the raw samples and each block's
// aggregates; pass 2 returns at once for blocks without a pd == 0
// sample (any audible frequency advances the phase every sample). The
// previous sample's Is is computed again from its phase instead of
// carried: that costs a second Hermite per sample but no extra memory
// traffic.

#include "hold.cuh"

namespace {

constexpr int WF_THREADS = saugns::HOLD_THREADS;
using saugns::herp64;
using saugns::LEN;

struct Seeds {
  const uint32_t* pp;    // (V,) row head's previous phase
  const float* ps;       // (V,) hold seed
  const long long* fi;   // (V,) row index of an unconsumed reset
  const uint8_t* drst;   // (V,) reset pending
  const uint32_t* rph;   // (V,) phase the reset sample pairs with
};

__device__ __forceinline__ uint32_t prev_phase(const uint32_t* row,
                                               long long pos, int r,
                                               const Seeds& sd) {
  uint32_t prev = pos == 0 ? sd.pp[r] : row[pos - 1];
  if (sd.drst[r] && pos == sd.fi[r]) prev = sd.rph[r];
  return prev;
}

// Pass 1: raw samples (0 where pd == 0) and per-block aggregates.
__global__ void wosc_raw(const uint32_t* __restrict__ ph, Seeds sd,
                         const float* __restrict__ pilut, float dvs,
                         float dvo, float* __restrict__ out,
                         int* __restrict__ last_valid,
                         int* __restrict__ has_hold, long long L) {
  __shared__ float tab[LEN];
  __shared__ int sh[WF_THREADS / 32];
  for (int k = threadIdx.x; k < LEN; k += WF_THREADS) tab[k] = pilut[k];
  __syncthreads();
  const int r = blockIdx.y;
  const long long pos = (long long)blockIdx.x * WF_THREADS + threadIdx.x;
  const bool in = pos < L;
  const uint32_t* row = ph + (long long)r * L;
  bool valid = false;
  if (in) {
    const uint32_t cur = row[pos];
    const uint32_t prev = prev_phase(row, pos, r, sd);
    const int pd = (int)(cur - prev);
    valid = pd != 0;
    float s = 0.0f;
    if (valid)
      s = saugns::wosc_sample(herp64(tab, prev), herp64(tab, cur), pd,
                              dvs, dvo);
    out[(long long)r * L + pos] = s;
  }
  saugns::hold_aggregates(in, valid, pos, last_valid, has_hold,
                          (long long)r * gridDim.x + blockIdx.x, sh);
}

// Pass 2: forward fill of the last valid sample where pd == 0.
__global__ void wosc_hold(const uint32_t* __restrict__ ph, Seeds sd,
                          float* __restrict__ out,
                          const int* __restrict__ last_valid,
                          const int* __restrict__ has_hold,
                          long long L) {
  __shared__ int sh[WF_THREADS / 32];
  const int r = blockIdx.y;
  const long long rb = (long long)r * gridDim.x;
  if (!has_hold[rb + blockIdx.x]) return;
  const long long pos = (long long)blockIdx.x * WF_THREADS + threadIdx.x;
  const bool in = pos < L;
  const uint32_t* row = ph + (long long)r * L;
  float* orow = out + (long long)r * L;
  bool valid = false;
  if (in) valid = row[pos] != prev_phase(row, pos, r, sd);
  // only pd == 0 samples are written; the valid ones read here stay
  saugns::hold_fill(orow, orow, pos, in, valid, last_valid + rb,
                    blockIdx.x, sd.ps[r], sh);
}

}  // namespace

extern "C" {

// Number of blocks per row; scratch is 2 * n_rows * blocks ints.
long long saugns_wosc_fill_blocks(long long row_len) {
  return (row_len + WF_THREADS - 1) / WF_THREADS;
}

// out (V, L) f32 from ph (V, L) u32 and the (V,) seeds, on `stream`.
// Returns the cudaError_t of the launches.
int saugns_wosc_fill(const void* ph, const void* pp, const void* ps,
                     const void* fi, const void* drst, const void* rph,
                     const void* pilut, float dvs, float dvo, void* out,
                     void* scratch, long long row_len, int n_rows,
                     void* stream) {
  if (row_len < 1 || n_rows < 1 || n_rows > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nb = saugns_wosc_fill_blocks(row_len);
  if (nb > 0x7fffffffLL || row_len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Seeds sd{(const uint32_t*)pp, (const float*)ps, (const long long*)fi,
           (const uint8_t*)drst, (const uint32_t*)rph};
  int* last_valid = (int*)scratch;
  int* has_hold = last_valid + nb * n_rows;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)nb, (unsigned)n_rows);
  wosc_raw<<<grid, WF_THREADS, 0, s>>>(
      (const uint32_t*)ph, sd, (const float*)pilut, dvs, dvo, (float*)out,
      last_valid, has_hold, row_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wosc_hold<<<grid, WF_THREADS, 0, s>>>((const uint32_t*)ph, sd,
                                        (float*)out, last_valid, has_hold,
                                        row_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
