// Shared block-level helpers of the port's kernels. Plain CUDA C++:
// no PyTorch header, so a build is one short nvcc call.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace saugns {

// Wrapping add of unsigned values (uint32_t, unsigned long long), and
// max, as scan operators.
struct AddOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// SMs of the current device into `sms`, asked once per device, not on
// every call (a launch's host time counts at the main path's sizes).
inline cudaError_t sm_count(int& sms) {
  static int known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && known[dev] > 0) {
    sms = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) known[dev] = sms;
  return e;
}

// Let Kernel take `bytes` of dynamic shared memory (above 48 KB) on the
// current device; set once per device.
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static unsigned long long done = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

// -- the PILUT wave oscillator ------------------------------------------

constexpr int LEN = 2048;
constexpr int LENMASK = LEN - 1;
constexpr int SLENBITS = 21;
constexpr uint32_t SLENMASK = (1u << SLENBITS) - 1u;
constexpr float X_SCALE = 1.0f / (float)(1u << SLENBITS);

// The float64 coefficients of cell `cell`'s Hermite in sauWave_get_herp
// (sau/wave.h:127-141) over the PILUT `tab`, as _herp64_taps
// (saugns_tpu/render/jdsp.py:546) evaluates them: tap differences round
// in float32, everything else in float64, one op at a time. They depend
// on the cell alone.
__device__ __forceinline__ void herp64_coeffs(const float* tab, int cell,
                                              double& c3, double& c2,
                                              double& c1, double& c0) {
  const float s0 = tab[(cell - 1) & LENMASK];
  const float s1 = tab[cell & LENMASK];
  const float s2 = tab[(cell + 1) & LENMASK];
  const float s3 = tab[(cell + 2) & LENMASK];
  c0 = (double)s1;
  c1 = __dmul_rn(0.5, (double)__fsub_rn(s2, s0));
  c2 = __dsub_rn((double)s0, __dmul_rn(2.5, (double)s1));
  c2 = __dadd_rn(c2, (double)__fmul_rn(2.0f, s2));
  c2 = __dsub_rn(c2, __dmul_rn(0.5, (double)s3));
  c3 = __dadd_rn(__dmul_rn(0.5, (double)__fsub_rn(s3, s0)),
                 __dmul_rn(1.5, (double)__fsub_rn(s1, s2)));
}

// ((c3 x + c2) x + c1) x + c0 at the phase's position x in its cell
// (float32, widened), one float64 op at a time.
__device__ __forceinline__ double herp64_horner(double c3, double c2,
                                                double c1, double c0,
                                                uint32_t phase) {
  const double x = (double)__fmul_rn(__uint2float_rn(phase & SLENMASK),
                                     X_SCALE);
  double r = __dadd_rn(__dmul_rn(c3, x), c2);
  r = __dadd_rn(__dmul_rn(r, x), c1);
  return __dadd_rn(__dmul_rn(r, x), c0);
}

// Is(phase): the Hermite interpolation of sauWave_get_herp over the
// PILUT `tab`, its cell's coefficients and their Horner.
__device__ __forceinline__ double herp64(const float* tab,
                                         uint32_t phase) {
  double c3, c2, c1, c0;
  herp64_coeffs(tab, (int)(phase >> SLENBITS), c3, c2, c1, c0);
  return herp64_horner(c3, c2, c1, c0, phase);
}

// The Hermite of every cell in a block's dynamic shared memory (BYTES,
// staged by every thread of the block from the PILUT): (c3, c2) and
// (c1, c0) as two double2 a cell, built once a block, so that Is(phase)
// is two 16-byte loads and the Horner -- herp64's bits. Kernel 5 uses
// it; kernels 1 and 9 gather from the 8 KB PILUT itself (herp64), which
// measured faster there (PERF.md).
struct CoefIs {
  static constexpr int BYTES = LEN * 4 * (int)sizeof(double);
  const double2* coef;
  __device__ explicit CoefIs(const unsigned char* smem)
      : coef(reinterpret_cast<const double2*>(smem)) {}
  static __device__ void stage(unsigned char* smem, const float* pilut) {
    double2* c = reinterpret_cast<double2*>(smem);
    for (int k = threadIdx.x; k < LEN; k += blockDim.x) {
      double c3, c2, c1, c0;
      herp64_coeffs(pilut, k, c3, c2, c1, c0);
      c[2 * k] = make_double2(c3, c2);
      c[2 * k + 1] = make_double2(c1, c0);
    }
  }
  __device__ double operator()(uint32_t phase) const {
    const int cell = (int)(phase >> SLENBITS);
    const double2 hi = coef[2 * cell];
    const double2 lo = coef[2 * cell + 1];
    return herp64_horner(hi.x, hi.y, lo.x, lo.y, phase);
  }
};

// s = DVSCALE * (Is2 - Is1) / pd + DVOFFSET for pd != 0 (wosc.h:247-261):
// a correctly rounded float32 factor dvs / pd widened to float64, one
// final float32 rounding -- _wosc_s64 (jdsp.py:566).
__device__ __forceinline__ float wosc_sample(double is1, double is2,
                                             int pd, float dvs,
                                             float dvo) {
  const float xf = __fdiv_rn(dvs, __int2float_rn(pd));
  double d = __dsub_rn(is2, is1);
  d = __dmul_rn(d, (double)xf);
  d = __dadd_rn(d, (double)dvo);
  return __double2float_rn(d);
}

}  // namespace saugns
