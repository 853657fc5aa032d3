// Kernel 5: the wave oscillator's self-PM recurrence.
//
// Replaces the Pallas kernel _wosc_selfmod_pallas
// (saugns_tpu/render/jdsp.py:1054, body _selfmod_kernel_factory :986;
// API wosc_selfmod_masked :1282). For V rows of L samples it steps
// through each row in order (wosc.h:273-310):
//
//   phase = ph[i] + llrintf(fb * am[i] * 2^31)          (mod 2^32)
//   s     = DVSCALE * (Is(phase) - Is(pp)) / pd + DVOFFSET, pd = phase - pp
//           (the previous s where pd == 0)
//   pp    = phase where pd != 0;  ps = s;  fb = (fb + s) / 2
//
// gated by act[i]: an inactive sample writes 0 and leaves the state as
// it was. pp0 is the row's previous phase with an unconsumed reset
// already resolved by the caller. Arithmetic is the float64 chain of
// the CPU step of wosc_selfmod_masked (jdsp.py:1326-1340, via
// wosc_diff :738), op for op, built with -fmad=false: not the TPU's
// double-float32 chain.
//
// Bound: the dependent chain. fb feeds the next sample's phase, so a
// row is one serial chain of about 40 float32/float64 operations and a
// shared-memory gather per sample; bytes (13 B per sample) and the
// card's operation rate are far from binding. One thread runs one row;
// the wave's PILUT (8 KB) sits in shared memory, and Is(pp) is carried
// from the step that set pp instead of being recomputed, so each
// sample evaluates one Hermite. Rows run in parallel, one per thread.

#include "common.cuh"

namespace {

constexpr int SM_THREADS = 64;

__global__ void wosc_selfmod_rows(
    const uint32_t* __restrict__ ph, const float* __restrict__ am,
    const uint8_t* __restrict__ act, const uint32_t* __restrict__ pp0,
    const float* __restrict__ ps0, const float* __restrict__ fb0,
    const float* __restrict__ pilut, float dvs, float dvo,
    float* __restrict__ out, uint32_t* __restrict__ pp_out,
    float* __restrict__ ps_out, float* __restrict__ fb_out, long long L,
    int V) {
  __shared__ float tab[saugns::LEN];
  for (int k = threadIdx.x; k < saugns::LEN; k += blockDim.x)
    tab[k] = pilut[k];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= V) return;
  const long long base = (long long)r * L;
  uint32_t pp = pp0[r];
  float ps = ps0[r];
  float fb = fb0[r];
  double is_pp = saugns::herp64(tab, pp);
  for (long long j = 0; j < L; ++j) {
    const long long i = base + j;
    if (!act[i]) {
      out[i] = 0.0f;
      continue;
    }
    const float adj = __fmul_rn(__fmul_rn(fb, am[i]), 2147483648.0f);
    const uint32_t phase = ph[i] + (uint32_t)__float2ll_rn(adj);
    const int pd = (int)(phase - pp);
    float s = ps;
    if (pd != 0) {
      const double is2 = saugns::herp64(tab, phase);
      s = saugns::wosc_sample(is_pp, is2, pd, dvs, dvo);
      pp = phase;
      is_pp = is2;
    }
    ps = s;
    fb = __fmul_rn(__fadd_rn(fb, s), 0.5f);
    out[i] = s;
  }
  pp_out[r] = pp;
  ps_out[r] = ps;
  fb_out[r] = fb;
}

}  // namespace

extern "C" {

// out (V, L) f32 and the (V,) end states pp, ps, fb from ph (V, L) u32,
// am (V, L) f32, act (V, L) u8 and the (V,) seeds, on `stream`.
// Returns the cudaError_t of the launch.
int saugns_wosc_selfmod(const void* ph, const void* am, const void* act,
                        const void* pp0, const void* ps0, const void* fb0,
                        const void* pilut, float dvs, float dvo, void* out,
                        void* pp_out, void* ps_out, void* fb_out,
                        long long row_len, int n_rows, void* stream) {
  if (row_len < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const int threads = n_rows < SM_THREADS ? 32 : SM_THREADS;
  const unsigned blocks = (unsigned)((n_rows + threads - 1) / threads);
  wosc_selfmod_rows<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ph, (const float*)am, (const uint8_t*)act,
      (const uint32_t*)pp0, (const float*)ps0, (const float*)fb0,
      (const float*)pilut, dvs, dvo, (float*)out, (uint32_t*)pp_out,
      (float*)ps_out, (float*)fb_out, row_len, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
