// Kernel 11: the RasG oscillator's cyclor, map and line over rows.
//
// Replaces no TPU kernel: the JAX package leaves these stages (its
// flat renderer's K_RCYCLE and K_RRUN, flat.py there) to XLA, which
// fuses their elementwise chain. In PyTorch the same chain is some
// forty elementwise passes over int64 and float32 (*lead, nc, B)
// values (tdsp.rasg_fill_plain): on a bank slab of 256 rows of 96,000
// samples they took ~90 ms a request of four slabs, ~380x the bytes'
// bound. This kernel does the work of one K_RCYCLE stage and the
// K_RRUN stage that reads it, so the u64 count, the cycle, the phase
// and the endpoint pair never reach device memory. For each sample i
// of a row r (tdsp.rasg_fill_plain, op for op):
//
//   count = inc[r] * min(i, ln[r])       (a per-row frequency: the ramp)
//         | csum[r, i] - incs[r, i]      (a per-sample one: kernel 3's
//                                         exclusive sum)
//   cph   = ftoi(pofs[r, i] * pscale) + base[r] + count     (u64 wraps)
//   cycle = cph >> 32;  phase = float((cph & M32) >> 1) * 2^-31
//   out   = rasg_shape(rasg_map(cycle), phase)
//
// ftoi is llrintf with tdsp.ftoi's saturation: NaN gives 0, at or
// above 2^63 INT64_MAX, below -2^63 INT64_MIN. rasg_map, rasg_shape
// and the line follow render/tdsp.py op for op in float32 (__fmul_rn /
// __fadd_rn, built with -fmad=false), on kernel 6's device helpers
// (rasg_selfmod.cuh). Unlike kernel 6 (tdsp.rasg_selfmod_sample) the
// Perlin amplitude is applied as rasg_shape does, a * (pa * phase):
// the two round differently where pa is not a power of two. Only the
// hashes the function and flags read are computed (r_m1 only for
// violet); the output bits do not depend on it.
//
// Bound: memory. 4 B of PM offset in and 4 B of sample out a sample
// (the scanned form also reads kernel 3's sums and the increments, 16
// B more); ~40 integer and float32 operations a sample are far below
// the card's rate. The design:
// - a thread takes 8 consecutive samples of a row, with 16-byte loads
//   and stores where the row length and the pointers allow (scalar
//   code otherwise), all its loads in flight at once, and reads its
//   row's scalars once;
// - a block of RF_THREADS covers RF_SPAN samples of a row; the grid is
//   (row span, rows), so a slab's 256 x nc rows of B samples launch
//   tens of thousands of blocks, enough for all 132 SMs;
// - the kernel is a template on the map function and the line type (7
//   x 13, spread over rasg_fill_f<func>.cu so that the build runs them
//   in parallel), as kernel 6 is; level, alpha and the flags are
//   launch arguments. A thread keeps the last cycle's endpoints and
//   rebuilds them only when the cycle changes (same operations, same
//   bits).
#pragma once

#include "rasg_selfmod.cuh"

namespace saugns {
namespace rasg_fill {

using namespace saugns::rasg;

constexpr int RF_THREADS = 256;
constexpr int RF_PER = 8;                        // samples a thread
constexpr int RF_SPAN = RF_THREADS * RF_PER;     // samples a block
constexpr int RF_MAX_Y = 65535;                  // rows a grid column

struct FillArgs {
  const float* pofs;           // (rows, B) PM offset, or null
  const long long* csum;       // (rows, B) kernel 3's sums, or null
  const long long* incs;       // (rows, B) its increments
  const long long* inc;        // (rows,) a per-row increment
  const long long* ln;         // (rows,) its row length
  const long long* base;       // (rows,) the row's start count
  float* out;                  // (rows, B)
  long long B;
  long long rows;
  float pscale;
  int level;
  uint32_t alpha;
  int oflags;
  bool vec;                    // B % 4 == 0, 16-byte aligned rows
};

// llrintf, saturating as tdsp.ftoi: NaN gives 0, at or above 2^63
// INT64_MAX, below -2^63 INT64_MIN
__device__ __forceinline__ unsigned long long ftoi(float x) {
  const float r = rintf(x);
  if (r != r) return 0ull;
  if (r >= 9223372036854775808.0f) return 0x7fffffffffffffffull;
  if (r < -9223372036854775808.0f) return 0x8000000000000000ull;
  return (unsigned long long)(long long)r;
}

template <int FUNC, int LINE>
__global__ void __launch_bounds__(RF_THREADS) rasg_fill_k(FillArgs A) {
  const long long B = A.B;
  const long long j0 =
      ((long long)blockIdx.x * RF_THREADS + threadIdx.x) * RF_PER;
  if (j0 >= B) return;
  const int n = (int)min((long long)RF_PER, B - j0);

  // the mode, decided once
  const int level = A.level;
  const uint32_t alpha = A.alpha;
  const int oflags = A.oflags;
  const bool violet = (oflags & O_VIOLET) != 0;
  const bool perlin = (oflags & O_PERLIN) != 0;
  const float c = terms_scale<FUNC>(level, violet);
  const float pa = perlin_amp<LINE>(oflags);
  const float pscale = A.pscale;

  // the endpoints as rasg_shape first sees them (scaled by c), and
  // with no Perlin flag after the flag pass: they depend on the cycle
  // alone
  auto ends = [&](uint32_t cycle, float& a, float& b) {
    terms<FUNC>(level, alpha, violet, cycle, a, b);
    if (c != 0.0f) {
      a = fm(a, c);
      b = fm(b, c);
    }
    if (!perlin) shape_flags(oflags, a, b);
  };

  for (long long r = blockIdx.y; r < A.rows; r += gridDim.y) {
    const long long o = r * B + j0;
    const unsigned long long base = (unsigned long long)A.base[r];
    // every index below is a constant after unrolling, so the arrays
    // live in registers
    unsigned long long cnt[RF_PER];
    float po[RF_PER];
    const bool vec = A.vec && n == RF_PER;
    if (A.csum != nullptr) {
      if (vec) {
        const longlong2* cs = (const longlong2*)(A.csum + o);
        const longlong2* is = (const longlong2*)(A.incs + o);
#pragma unroll
        for (int q = 0; q < RF_PER / 2; ++q) {
          const longlong2 c2 = __ldg(cs + q);
          const longlong2 i2 = __ldg(is + q);
          cnt[2 * q] = (unsigned long long)c2.x - (unsigned long long)i2.x;
          cnt[2 * q + 1] =
              (unsigned long long)c2.y - (unsigned long long)i2.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < RF_PER; ++k)
          cnt[k] = k < n ? (unsigned long long)__ldg(A.csum + o + k) -
                               (unsigned long long)__ldg(A.incs + o + k)
                         : 0ull;
      }
    } else {
      const unsigned long long inc = (unsigned long long)A.inc[r];
      const long long ln = A.ln[r];
#pragma unroll
      for (int k = 0; k < RF_PER; ++k)
        cnt[k] = inc * (unsigned long long)min(j0 + k, ln);
    }
    if (A.pofs != nullptr) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < RF_PER / 4; ++q) {
          const float4 p = __ldg((const float4*)(A.pofs + o) + q);
          po[4 * q] = p.x;
          po[4 * q + 1] = p.y;
          po[4 * q + 2] = p.z;
          po[4 * q + 3] = p.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < RF_PER; ++k)
          po[k] = k < n ? __ldg(A.pofs + o + k) : 0.0f;
      }
    }

    float s[RF_PER];
    uint32_t last = 0u;
    float ca = 0.0f, cb = 0.0f;
#pragma unroll
    for (int k = 0; k < RF_PER; ++k) {
      unsigned long long cph = base + cnt[k];
      if (A.pofs != nullptr) cph += ftoi(fm(po[k], pscale));
      const uint32_t cycle = (uint32_t)(cph >> 32);
      const float phase =
          fm(__uint2float_rn((uint32_t)cph >> 1), SCALE31);
      if (k == 0 || cycle != last) {
        last = cycle;
        ends(cycle, ca, cb);
      }
      float a = ca, b = cb;
      if (perlin) {
        a = fm(a, fm(pa, phase));
        b = fm(b, fm(pa, fs(phase, 1.0f)));
        shape_flags(oflags & ~O_PERLIN, a, b);
      }
      s[k] = line_val<LINE>(phase, a, b);
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < RF_PER / 4; ++q)
        ((float4*)(A.out + o))[q] = make_float4(
            s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < RF_PER; ++k)
        if (k < n) A.out[o + k] = s[k];
    }
  }
}

template <int FUNC, int LINE>
cudaError_t fill_launch(const FillArgs& A, cudaStream_t stream) {
  const dim3 grid((unsigned)((A.B + RF_SPAN - 1) / RF_SPAN),
                  (unsigned)(A.rows < RF_MAX_Y ? A.rows : RF_MAX_Y));
  rasg_fill_k<FUNC, LINE><<<grid, RF_THREADS, 0, stream>>>(A);
  return cudaGetLastError();
}

// one of these per rasg_fill_f<FUNC>.cu: the launch of line type
// `line` (0-12) of function FUNC
template <int FUNC>
cudaError_t fill_lines(int line, const FillArgs& A, cudaStream_t s) {
  switch (line) {
    case 0: return fill_launch<FUNC, 0>(A, s);
    case 1: return fill_launch<FUNC, 1>(A, s);
    case 2: return fill_launch<FUNC, 2>(A, s);
    case 3: return fill_launch<FUNC, 3>(A, s);
    case 4: return fill_launch<FUNC, 4>(A, s);
    case 5: return fill_launch<FUNC, 5>(A, s);
    case 6: return fill_launch<FUNC, 6>(A, s);
    case 7: return fill_launch<FUNC, 7>(A, s);
    case 8: return fill_launch<FUNC, 8>(A, s);
    case 9: return fill_launch<FUNC, 9>(A, s);
    case 10: return fill_launch<FUNC, 10>(A, s);
    case 11: return fill_launch<FUNC, 11>(A, s);
    case 12: return fill_launch<FUNC, 12>(A, s);
    default: return cudaErrorInvalidValue;
  }
}

// defined in rasg_fill_f<FUNC>.cu (explicit instantiations)
extern template cudaError_t fill_lines<F_URAND>(int, const FillArgs&,
                                                  cudaStream_t);
extern template cudaError_t fill_lines<F_GAUSS>(int, const FillArgs&,
                                                  cudaStream_t);
extern template cudaError_t fill_lines<F_BIN>(int, const FillArgs&,
                                                cudaStream_t);
extern template cudaError_t fill_lines<F_TERN>(int, const FillArgs&,
                                                 cudaStream_t);
extern template cudaError_t fill_lines<F_FIXED>(int, const FillArgs&,
                                                  cudaStream_t);
extern template cudaError_t fill_lines<F_ADDREC>(int, const FillArgs&,
                                                   cudaStream_t);
extern template cudaError_t fill_lines<F_SIGN>(int, const FillArgs&,
                                                 cudaStream_t);

}  // namespace rasg_fill
}  // namespace saugns
