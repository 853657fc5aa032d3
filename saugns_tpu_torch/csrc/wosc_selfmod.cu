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
// Bound: the latency of the loop-carried chain from fb to the next
// sample's fb; bytes (13 B a sample) and the card's operation rate are
// far from binding. The design shortens that chain without changing a
// bit:
// - Inputs and outputs go through shared memory (selfmod_stage.cuh):
//   producer warps stage tiles of ph (the int64 phases as the callers
//   hold them, low 32 bits), am and the gate; the chain lane reads the
//   next sample's words while it computes the current one, and the gate
//   and the pd == 0 hold are selects, so no global load, store or
//   branch sits on the chain.
// - Is(phase) is one cell's four float64 Hermite coefficients (one
//   32-byte record in shared memory, built in the prologue with
//   herp64's exact operations) and the 6-operation Horner: the
//   coefficients depend on the cell only, never on fb. When pd == 0,
//   phase == pp, so Is(phase) == Is(pp) and carrying it is exact.
// - The correctly rounded dvs / pd is evaluated beside the Hermite (it
//   depends on pd only); pd == 0 divides by 1 and is selected away,
//   which keeps __fdiv_rn on its fast path.
// Rows run side by side, 32 to a block (one lane each).

#include "common.cuh"
#include "selfmod_stage.cuh"

namespace {

using saugns::ST_G;
using saugns::ST_GROUPS;
using saugns::ST_PITCH;
using saugns::StageSmem;

using Smem = StageSmem<2>;   // words: phase (low 32 bits), amount
// the coefficient table: 2,048 cells x (c3, c2, c1, c0) float64
constexpr size_t COEF_BYTES = saugns::CoefIs::BYTES;
constexpr size_t SMEM_BYTES = COEF_BYTES + Smem::bytes;

__global__ void __launch_bounds__(saugns::ST_THREADS)
wosc_selfmod_rows(const long long* __restrict__ ph,
                  const float* __restrict__ am,
                  const uint8_t* __restrict__ act,
                  const long long* __restrict__ pp0,
                  const float* __restrict__ ps0,
                  const float* __restrict__ fb0,
                  const float* __restrict__ pilut, float dvs, float dvo,
                  float* __restrict__ out, long long* __restrict__ pp_out,
                  float* __restrict__ ps_out, float* __restrict__ fb_out,
                  long long L, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem + COEF_BYTES);
  const int r0 = blockIdx.x * saugns::ST_R;
  const int nr = min(saugns::ST_R, V - r0);
  const int lane = threadIdx.x;   // chain warp: lane = row

  // the coefficients of every cell, op for op as saugns::herp64
  saugns::CoefIs::stage(smem, pilut);
  const saugns::CoefIs horner(smem);
  __syncthreads();

  // chain state of lane `lane` (rows past nr run on zeros, unused)
  const bool own = lane < nr;
  uint32_t pp = own ? (uint32_t)pp0[r0 + lane] : 0u;
  float ps = own ? ps0[r0 + lane] : 0.0f;
  float fb = own ? fb0[r0 + lane] : 0.0f;
  double is_pp = horner(pp);

  const long long* phr = ph + (long long)r0 * L;
  const float* amr = am + (long long)r0 * L;
  const uint8_t* actr = act + (long long)r0 * L;
  auto load = [&](int row, long long j, uint32_t* w) {
    const long long i = (long long)row * L + j;
    w[0] = (uint32_t)__ldg(phr + i);
    w[1] = __float_as_uint(__ldg(amr + i));
    w[2] = __ldg(actr + i) != 0;
  };
  auto step_tile = [&](int b) {
    const uint32_t* wph = sm.plane(b, 0) + lane;
    const uint32_t* wam = sm.plane(b, 1) + lane;
    const uint32_t* wact = sm.plane(b, 2) + lane;
    float* so = sm.outp(b) + lane;
    const uint8_t* fl = sm.flags(b) + lane;
    for (int g = 0; g < ST_GROUPS; ++g) {
      const int jg = g * ST_G;
      if (!__any_sync(saugns::FULL_MASK, fl[g * saugns::ST_R] != 0)) {
#pragma unroll 8
        for (int jj = 0; jj < ST_G; ++jj) so[(jg + jj) * ST_PITCH] = 0.0f;
        continue;
      }
      uint32_t n_ph = wph[jg * ST_PITCH];
      float n_am = __uint_as_float(wam[jg * ST_PITCH]);
      uint32_t n_act = wact[jg * ST_PITCH];
#pragma unroll 8
      for (int jj = 0; jj < ST_G; ++jj) {
        const int j = jg + jj;
        const uint32_t phv = n_ph;
        const float amv = n_am;
        const bool a = n_act != 0u;
        // the next sample's words, read while this one computes (one
        // past the tile's end reads the pad row)
        n_ph = wph[(j + 1) * ST_PITCH];
        n_am = __uint_as_float(wam[(j + 1) * ST_PITCH]);
        n_act = wact[(j + 1) * ST_PITCH];

        const float adj = __fmul_rn(__fmul_rn(fb, amv), 2147483648.0f);
        const uint32_t phase = phv + (uint32_t)__float2ll_rn(adj);
        const int pd = (int)(phase - pp);
        const double is2 = horner(phase);
        const float pdf = pd != 0 ? __int2float_rn(pd) : 1.0f;
        const float xf = __fdiv_rn(dvs, pdf);
        double d = __dsub_rn(is2, is_pp);
        d = __dmul_rn(d, (double)xf);
        d = __dadd_rn(d, (double)dvo);
        const float s_new = __double2float_rn(d);
        const float s = pd != 0 ? s_new : ps;
        so[j * ST_PITCH] = a ? s : 0.0f;
        if (a) {
          pp = phase;        // == pp where pd == 0
          is_pp = is2;
          ps = s;
          fb = __fmul_rn(__fadd_rn(fb, s), 0.5f);
        }
      }
    }
  };
  saugns::run_rows(sm, nr, L, out + (long long)r0 * L, load, step_tile);
  if (threadIdx.x < 32 && own) {
    pp_out[r0 + lane] = (long long)pp;
    ps_out[r0 + lane] = ps;
    fb_out[r0 + lane] = fb;
  }
}

}  // namespace

extern "C" {

// out (V, L) f32 and the (V,) end states pp (int64, u32 values), ps, fb
// from ph (V, L) int64 (only the low 32 bits count), am (V, L) f32, act
// (V, L) u8 and the (V,) seeds pp0 (int64), ps0, fb0, on `stream`.
// Returns the cudaError_t of the launch.
int saugns_wosc_selfmod(const void* ph, const void* am, const void* act,
                        const void* pp0, const void* ps0, const void* fb0,
                        const void* pilut, float dvs, float dvo, void* out,
                        void* pp_out, void* ps_out, void* fb_out,
                        long long row_len, int n_rows, void* stream) {
  if (row_len < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      saugns::allow_smem<&wosc_selfmod_rows>((int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks =
      (unsigned)((n_rows + saugns::ST_R - 1) / saugns::ST_R);
  wosc_selfmod_rows<<<blocks, saugns::ST_THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(
      (const long long*)ph, (const float*)am, (const uint8_t*)act,
      (const long long*)pp0, (const float*)ps0, (const float*)fb0,
      (const float*)pilut, dvs, dvo, (float*)out, (long long*)pp_out,
      (float*)ps_out, (float*)fb_out, row_len, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
