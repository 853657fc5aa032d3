// Kernel 6: the random-segments (RasG) oscillator's self-PM recurrence.
//
// Replaces the Pallas kernel _rasg_selfmod_pallas
// (saugns_tpu/render/jdsp.py:1432, body _rasg_selfmod_kernel_factory
// :1381; API rasg_selfmod_masked :1343). For V rows of L samples it
// steps through each row in order (rasg.h:242-294, 764-772):
//
//   phase = ph[i] + fb * am[i] / 2
//   cycle = cyc[i] + floor(phase);  phase -= floor(phase)
//   s     = rasg_shape(rasg_map(cycle), phase)
//   fb    = ((fb + s) + ps) / 2;  ps = s
//
// gated by act[i] (an inactive sample writes 0 and keeps the state).
// rasg_map, rasg_shape and line_val follow render/tdsp.py op for op in
// float32 (__fmul_rn / __fadd_rn, built with -fmad=false), including
// the Perlin folding of rasg_selfmod_sample that matches the
// reference's compiled scan body; _divi2 truncates toward zero, as the
// compiled reference does (INT32_MIN / 2 is -2^30); u32
// arithmetic wraps natively, the integer shift of `level` is an
// arithmetic int32 shift, and floor then int32 is __float2int_rd,
// which saturates and maps NaN to 0 as XLA's conversion does. All 13
// line types are covered, the noise lines (ncl, nhl, uwh) reading the
// float bits of the phase as a PRNG seed; the Pallas kernel left those
// to lax.scan because Mosaic has no scalar f32 <-> i32 bitcast.
//
// Bound: the latency of the loop-carried chain from fb to the next
// sample's fb; bytes (25 B a sample as the callers hold the inputs)
// and the card's operation rate are far from binding. The design:
// - The row loop is a template on the function and the line type
//   (7 x 13 instantiations, spread over rasg_selfmod_f<func>.cu so that
//   the build runs them in parallel), as the TPU kernel was pruned per
//   mode at trace time; the fixed function at level >= 27 (the +-1
//   pair) is a function of its own (F_SIGN). Level, alpha and the flags
//   are launch arguments, read once; the flag pass is uniform per
//   launch.
// - The segment's endpoints depend on the cycle alone. Where they cost
//   more than a compare (every function but F_SIGN and F_ADDREC), the
//   last cycle's endpoints stay in registers and are rebuilt only when
//   the cycle changes; F_SIGN's depend on the cycle's parity alone, so
//   both pairs are built once and each sample selects one. With no
//   Perlin flag they are kept after the flag pass (half-shape, zigzag,
//   square depend on the endpoints only). Same operations in the same
//   order, so bit for bit.
// - Inputs and outputs go through shared memory (selfmod_stage.cuh):
//   producer warps stage the phases, the int64 cycles (low 32 bits),
//   the amounts and the gate; the gate is a select, so no global load,
//   store or branch on the gate sits on the chain.
#pragma once

#include "common.cuh"
#include "selfmod_stage.cuh"

namespace saugns {
namespace rasg {

constexpr float SCALE31 = 4.656612873077393e-10f;   // 2^-31
constexpr float SCALE32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float HALF_SCALE31 = 2.3283064365386963e-10f;  // 0.5 * 2^-31
constexpr uint32_t FIBH32 = 0x9e3779b9u;

// the functions of program.h, and F_SIGN: the fixed function at
// level >= 27 (ras_level(9)), whose endpoints are the pair +-1
enum { F_URAND, F_GAUSS, F_BIN, F_TERN, F_FIXED, F_ADDREC, F_SIGN };
constexpr int N_LINES = 13;
constexpr int SIGN_LEVEL = 27;
enum { O_PERLIN = 1, O_HALFSHAPE = 2, O_ZIGZAG = 4, O_SQUARE = 8,
       O_VIOLET = 16 };

__device__ __forceinline__ float fm(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fa(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fs(float a, float b) {
  return __fsub_rn(a, b);
}

// sau_ranfast32 (sau/math.h:297-303)
__device__ __forceinline__ uint32_t ranfast32(uint32_t n) {
  uint32_t s = n * FIBH32;
  s ^= s >> 14;
  s = (s | 1u) * s;
  return s ^ (s >> 13);
}

__device__ __forceinline__ uint32_t sar(uint32_t x, int level) {
  return (uint32_t)((int)x >> level);
}

// x / 2 truncated toward zero in int32 (INT32_MIN gives -2^30)
__device__ __forceinline__ uint32_t divi2(uint32_t x) {
  return (uint32_t)((int)x / 2);
}

__device__ __forceinline__ float i2f(uint32_t x) {
  return __int2float_rn((int)x);
}

__device__ __forceinline__ float sinpi_d5(float x) {
  const float x2 = fm(x, x);
  return fm(x, fa(3.140427350997925f,
                  fm(x2, fa(-5.136557579040527f,
                            fm(x2, 2.299391746520996f)))));
}

// soft-saturated Gaussian hash noise (noise.h:61-98)
__device__ __forceinline__ float franssgauss32(uint32_t n) {
  const uint32_t s0 = ranfast32(n);
  const uint32_t s1 = s0 * 0xe47135u;
  const float a = fm(__int2float_rn((int)s0), SCALE32);
  const float b = fm(__int2float_rn((int)s1), SCALE32);
  const float x2 = fm(a, a);
  const float x4 = fm(x2, x2);
  float c = fa(0.5f, fm(a, fa(-0.8027056455612183f,
                              fm(x4, fa(5.522744178771973f,
                                        fm(x4,
                                           -138.8712615966797f))))));
  const float cx2 = fm(c, c);
  const float gx = fm(fa(c, cx2), 0.5f);
  c = fm(c, fs(1.0f, fm(gx, fs(1.0f, cx2))));
  return fm(c, sinpi_d5(b));
}

// The constant scale c of the endpoint pair of FUNC (rasg.h:296-683)
// as tdsp._rasg_terms gives it; 0 where the pair is not scaled
// (Gaussian values, the +-1 pair).
template <int FUNC>
__device__ __forceinline__ float terms_scale(int level, bool violet) {
  if constexpr (FUNC == F_GAUSS || FUNC == F_SIGN) {
    return 0.0f;
  } else if constexpr (FUNC == F_BIN) {
    if (!violet) return SCALE31;
    const float sd =
        fs(1.0f, fm(__int2float_rn(0x7fffffff >> level), SCALE31));
    return fm(fa(1.0f, fm(sd, sd)), SCALE31);
  } else {
    return SCALE31;
  }
}

// The unscaled endpoint pair (xa, xb) of the segment at `cycle`
// (rasg.h:296-683) as tdsp._rasg_terms gives it.
template <int FUNC>
__device__ __forceinline__ void terms(int level, uint32_t alpha,
                                      bool violet, uint32_t cycle,
                                      float& xa, float& xb) {
  const uint32_t c1 = cycle + 1u;
  const uint32_t odd = cycle & 1u;
  if constexpr (FUNC == F_GAUSS) {
    xa = franssgauss32(cycle);
    xb = franssgauss32(c1);
  } else if constexpr (FUNC == F_ADDREC) {
    xa = i2f(cycle * alpha);
    xb = i2f(c1 * alpha);
  } else if constexpr (FUNC == F_SIGN) {
    xa = i2f(1u - odd * 2u);
    xb = -xa;
  } else if constexpr (FUNC == F_URAND) {
    const uint32_t r_0 = ranfast32(cycle);
    const uint32_t r_p1 = ranfast32(c1);
    if (!violet) {
      xa = i2f(r_0);
      xb = i2f(r_p1);
    } else {
      const uint32_t r_m1 = ranfast32(cycle - 1u);
      xa = i2f((r_0 >> 1) - (r_m1 >> 1));
      xb = i2f((r_p1 >> 1) - (r_0 >> 1));
    }
  } else {
    const uint32_t r_0 = ranfast32(cycle);
    const uint32_t r_p1 = ranfast32(c1);
    const uint32_t sb = odd << 31;
    const uint32_t sb_flip = 0x80000000u - sb;
    if constexpr (FUNC == F_BIN) {
      if (!violet) {
        const uint32_t offs = 0x7fffffffu + odd * 2u;
        xa = i2f(sar(r_0, level) + offs);
        xb = i2f(sar(r_p1, level) - offs);
      } else {
        const uint32_t r_m1 = ranfast32(cycle - 1u);
        const uint32_t vb0 = divi2(sar(r_m1, level) + sb);
        const uint32_t vb1 = divi2(sar(r_0, level) + sb_flip);
        const uint32_t vb2 = divi2(sar(r_p1, level) + sb);
        xa = i2f(vb1 - vb0);
        xb = i2f(vb2 - vb1);
      }
    } else if constexpr (FUNC == F_TERN) {
      xa = i2f(sar(r_0, level) + sb_flip);
      xb = i2f(sar(r_p1, level) + sb);
    } else {  // F_FIXED below level 27
      const uint32_t sign = 1u - odd * 2u;  // +1 or -1 as u32
      const uint32_t r0 = (uint32_t)((int)r_0 >> level) - 0x7fffffffu;
      const uint32_t r1 = (uint32_t)((int)r_p1 >> level) - 0x7fffffffu;
      if (!violet) {
        xa = i2f((0u - sign) * r0);
        xb = i2f(sign * r1);
      } else {
        const uint32_t r_m1 = ranfast32(cycle - 1u);
        const uint32_t rm =
            (uint32_t)((int)r_m1 >> level) - 0x7fffffffu;
        const uint32_t s0 = divi2(sign * rm);
        const uint32_t s1 = divi2((0u - sign) * r0);
        const uint32_t s2 = divi2(sign * r1);
        xa = i2f(s1 - s0);
        xb = i2f(s2 - s1);
      }
    }
  }
}

__device__ __forceinline__ float expramp6(float x) {
  const float x2 = fm(x, x);
  const float xA = fm(x, 0.3510044515132904f);   // 629 / 1792
  const float x3 = fm(x2, x);
  const float p = fa(fm(x2, 0.6489955186843872f), xA);  // 1163 / 1792
  return fa(x3, fm(x2, fm(fa(x3, -1.0f), p)));
}

// sauLine_val_* (sau/line.h:152-266), as tdsp.line_val evaluates it
template <int LINE>
__device__ __forceinline__ float line_val(float x, float a, float b) {
  if constexpr (LINE == 0) {  // cos
    const float y = fs(x, 0.5f);
    const float y2 = fm(y, y);
    const float sr = fm(y, fa(1.5702136754989624f,
                              fm(y2, fa(-2.5682787895202637f,
                                        fm(y2, 1.149695873260498f)))));
    return fa(a, fm(fs(b, a), fa(sr, 0.5f)));
  } else if constexpr (LINE == 1) {
    return fa(a, fm(fs(b, a), x));
  } else if constexpr (LINE == 2) {
    return a;
  } else if constexpr (LINE == 3 || LINE == 4) {
    const bool lo = LINE == 3 ? a > b : a < b;
    return lo ? fa(b, fm(fs(a, b), expramp6(fs(1.0f, x))))
              : fa(a, fm(fs(b, a), expramp6(x)));
  } else if constexpr (LINE == 5) {
    return fa(b, fm(fs(a, b), expramp6(fs(1.0f, x))));
  } else if constexpr (LINE == 6) {
    return fa(a, fm(fs(b, a), expramp6(x)));
  } else if constexpr (LINE == 7) {
    const float x1 = fs(1.0f, x);
    return fa(b, fm(fs(a, b), fm(x1, x1)));
  } else if constexpr (LINE == 8) {
    float x1 = fs(0.5f, x);
    x1 = fa(x1, x1);
    const float k = fm(fs(a, b), 0.5f);
    return fa(b, fm(fa(fm(fm(x1, x1), x1), 1.0f), k));
  } else if constexpr (LINE == 9) {
    const float x3d = fm(fm(fs(b, a), x), fm(x, x));
    return fa(a, fm(x3d, fa(fm(fa(fm(x, 6.0f), -15.0f), x), 10.0f)));
  } else {
    const float s = __int2float_rn((int)ranfast32(__float_as_uint(x)));
    if constexpr (LINE == 10) {  // ncl
      const float q = fa(fm(fa(fa(x, x), -3.0f), x), 1.0f);
      return fa(a, fm(fa(x, fm(fm(s, q), fm(x, HALF_SCALE31))),
                      fs(b, a)));
    } else if constexpr (LINE == 11) {  // nhl
      const float q = fs(1.0f, x);
      return fa(a, fm(fa(x, fm(fm(q, s), fm(x, SCALE31))), fs(b, a)));
    } else {  // uwh
      return fa(a, fm(fs(b, a), fa(0.5f, fm(HALF_SCALE31, s))));
    }
  }
}

// the Perlin amplitude of line type LINE under the flags (PERLIN_AMP of
// dsp/lines.py)
template <int LINE>
__device__ __forceinline__ float perlin_amp(int oflags) {
  constexpr float amp =
      LINE == 2 || LINE == 12 ? 1.0f
      : LINE <= 1 || (LINE >= 8 && LINE <= 10) ? 2.0f
      : LINE == 7 || LINE == 11 ? 1.8933908939361572f
                                : 1.5584580898284912f;
  return oflags & (O_HALFSHAPE | O_ZIGZAG) ? 1.0f : amp;
}

// IEEE 754-2019 maximum / minimum, as XLA's max / min and tdsp.fmax /
// fmin: NaN propagates and -0 < +0
__device__ __forceinline__ float fmax_x(float a, float b) {
  if (a != a) return a;
  return (a > b || (a == b && !signbit(a))) ? a : b;
}
__device__ __forceinline__ float fmin_x(float a, float b) {
  if (a != a) return a;
  return (a < b || (a == b && signbit(a))) ? a : b;
}

// the half-shape, zigzag and square passes of rasg_shape (rasg.h:692-743)
__device__ __forceinline__ void shape_flags(int oflags, float& a,
                                            float& b) {
  if (oflags & O_HALFSHAPE) {
    const float hi = fmax_x(a, b);
    const float lo = fmin_x(a, b);
    a = hi;
    b = lo;
  }
  if (oflags & O_ZIGZAG) {
    const float t = a;
    a = b;
    b = t;
  }
  if (oflags & O_SQUARE) {
    a = fm(a, fabsf(a));
    b = fm(b, fabsf(b));
  }
}

struct Args {
  const float* ph;
  const long long* cyc;
  const float* am;
  const uint8_t* act;
  const float* ps0;
  const float* fb0;
  float* out;
  float* ps_out;
  float* fb_out;
  long long L;
  int V;
  int level;
  uint32_t alpha;
  int oflags;
};

using Smem = StageSmem<3>;  // words: phase, cycle (low 32 bits), amount

// rasg_shape(rasg_map(cycle), phase) as tdsp.rasg_selfmod_sample gives
// it, split at what depends on the cycle alone:
//   ends(cycle):   the endpoints as rasg_shape first sees them -- the
//                  pair scaled by c, or unscaled where c is 0 or the
//                  Perlin amplitude folds into c (below) -- and, with
//                  no Perlin flag, after the flag pass;
//   finish(phase): with a Perlin flag, its scaling and the flag pass;
//                  a Perlin amplitude pa other than 1 folds into the
//                  map's constant scale c, (xa * phase) * (c * pa), as
//                  XLA's simplifier rewrites the reference's scan body;
//                  then the line.
template <int FUNC, int LINE>
__global__ void __launch_bounds__(ST_THREADS) rasg_rows(Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem);
  const int r0 = blockIdx.x * ST_R;
  const int nr = min(ST_R, A.V - r0);
  const int lane = threadIdx.x;
  const long long L = A.L;

  // the mode, decided once
  const int level = A.level;
  const uint32_t alpha = A.alpha;
  const bool violet = (A.oflags & O_VIOLET) != 0;
  const bool perlin = (A.oflags & O_PERLIN) != 0;
  const float c = terms_scale<FUNC>(level, violet);
  const float pa = perlin_amp<LINE>(A.oflags);
  const bool fold = c != 0.0f && perlin && pa != 1.0f;
  const float k = fm(c, pa);
  const int sflags = fold ? A.oflags & ~O_PERLIN : A.oflags;
  constexpr bool CACHE = FUNC != F_SIGN && FUNC != F_ADDREC;
  constexpr bool PARITY = FUNC == F_SIGN;

  auto ends = [&](uint32_t cycle, float& a, float& b) {
    terms<FUNC>(level, alpha, violet, cycle, a, b);
    if (c != 0.0f && !fold) {
      a = fm(a, c);
      b = fm(b, c);
    }
    if (!perlin) shape_flags(sflags, a, b);
  };

  const bool own = lane < nr;
  float ps = own ? A.ps0[r0 + lane] : 0.0f;
  float fb = own ? A.fb0[r0 + lane] : 0.0f;
  uint32_t last = 0u;
  float ca = 0.0f, cb = 0.0f;
  if (CACHE) ends(last, ca, cb);
  // F_SIGN: the endpoints of even (0) and odd (1) cycles
  float ea = 0.0f, eb = 0.0f, oa = 0.0f, ob = 0.0f;
  if (PARITY) {
    ends(0u, ea, eb);
    ends(1u, oa, ob);
  }

  const float* phr = A.ph + (long long)r0 * L;
  const long long* cyr = A.cyc + (long long)r0 * L;
  const float* amr = A.am + (long long)r0 * L;
  const uint8_t* actr = A.act + (long long)r0 * L;
  auto load = [&](int row, long long j, uint32_t* w) {
    const long long i = (long long)row * L + j;
    w[0] = __float_as_uint(__ldg(phr + i));
    w[1] = (uint32_t)__ldg(cyr + i);
    w[2] = __float_as_uint(__ldg(amr + i));
    w[3] = __ldg(actr + i) != 0;
  };
  auto step_tile = [&](int bf) {
    const uint32_t* wph = sm.plane(bf, 0) + lane;
    const uint32_t* wcy = sm.plane(bf, 1) + lane;
    const uint32_t* wam = sm.plane(bf, 2) + lane;
    const uint32_t* wact = sm.plane(bf, 3) + lane;
    float* so = sm.outp(bf) + lane;
    const uint8_t* fl = sm.flags(bf) + lane;
    for (int g = 0; g < ST_GROUPS; ++g) {
      const int jg = g * ST_G;
      if (!__any_sync(FULL_MASK, fl[g * ST_R] != 0)) {
#pragma unroll 8
        for (int jj = 0; jj < ST_G; ++jj) so[(jg + jj) * ST_PITCH] = 0.0f;
        continue;
      }
      float n_ph = __uint_as_float(wph[jg * ST_PITCH]);
      uint32_t n_cy = wcy[jg * ST_PITCH];
      float n_am = __uint_as_float(wam[jg * ST_PITCH]);
      uint32_t n_act = wact[jg * ST_PITCH];
#pragma unroll 4
      for (int jj = 0; jj < ST_G; ++jj) {
        const int j = jg + jj;
        const float phv = n_ph;
        const uint32_t cyv = n_cy;
        const float amv = n_am;
        const bool on = n_act != 0u;
        // the next sample's words, read while this one computes (one
        // past the tile's end reads the pad row)
        n_ph = __uint_as_float(wph[(j + 1) * ST_PITCH]);
        n_cy = wcy[(j + 1) * ST_PITCH];
        n_am = __uint_as_float(wam[(j + 1) * ST_PITCH]);
        n_act = wact[(j + 1) * ST_PITCH];

        float phase = fa(phv, fm(fm(fb, amv), 0.5f));
        const int adj = __float2int_rd(phase);
        const uint32_t cycle = cyv + (uint32_t)adj;
        phase = fs(phase, __int2float_rn(adj));
        float a, b;
        if constexpr (CACHE) {
          if (cycle != last) {
            last = cycle;
            ends(cycle, ca, cb);
          }
          a = ca;
          b = cb;
        } else if constexpr (PARITY) {
          const bool odd = (cycle & 1u) != 0u;
          a = odd ? oa : ea;
          b = odd ? ob : eb;
        } else {
          ends(cycle, a, b);
        }
        if (perlin) {
          if (fold) {
            a = fm(fm(a, phase), k);
            b = fm(fm(b, fs(phase, 1.0f)), k);
          } else {
            a = fm(a, fm(pa, phase));
            b = fm(b, fm(pa, fs(phase, 1.0f)));
          }
          shape_flags(sflags & ~O_PERLIN, a, b);
        }
        const float s = line_val<LINE>(phase, a, b);
        so[j * ST_PITCH] = on ? s : 0.0f;
        if (on) {
          fb = fm(fa(fa(fb, s), ps), 0.5f);
          ps = s;
        }
      }
    }
  };
  run_rows(sm, nr, L, A.out + (long long)r0 * L, load, step_tile);
  if (threadIdx.x < 32 && own) {
    A.ps_out[r0 + lane] = ps;
    A.fb_out[r0 + lane] = fb;
  }
}

template <int FUNC, int LINE>
cudaError_t launch(const Args& A, cudaStream_t stream) {
  const cudaError_t e =
      allow_smem<&rasg_rows<FUNC, LINE>>((int)Smem::bytes);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((A.V + ST_R - 1) / ST_R);
  rasg_rows<FUNC, LINE><<<blocks, ST_THREADS, Smem::bytes, stream>>>(A);
  return cudaGetLastError();
}

// one of these per rasg_selfmod_f<FUNC>.cu: the launch of line type
// `line` (0-12) of function FUNC
template <int FUNC>
cudaError_t launch_lines(int line, const Args& A, cudaStream_t s) {
  switch (line) {
    case 0: return launch<FUNC, 0>(A, s);
    case 1: return launch<FUNC, 1>(A, s);
    case 2: return launch<FUNC, 2>(A, s);
    case 3: return launch<FUNC, 3>(A, s);
    case 4: return launch<FUNC, 4>(A, s);
    case 5: return launch<FUNC, 5>(A, s);
    case 6: return launch<FUNC, 6>(A, s);
    case 7: return launch<FUNC, 7>(A, s);
    case 8: return launch<FUNC, 8>(A, s);
    case 9: return launch<FUNC, 9>(A, s);
    case 10: return launch<FUNC, 10>(A, s);
    case 11: return launch<FUNC, 11>(A, s);
    case 12: return launch<FUNC, 12>(A, s);
    default: return cudaErrorInvalidValue;
  }
}

// defined in rasg_selfmod_f<FUNC>.cu (explicit instantiations)
extern template cudaError_t launch_lines<F_URAND>(int, const Args&,
                                                  cudaStream_t);
extern template cudaError_t launch_lines<F_GAUSS>(int, const Args&,
                                                  cudaStream_t);
extern template cudaError_t launch_lines<F_BIN>(int, const Args&,
                                                cudaStream_t);
extern template cudaError_t launch_lines<F_TERN>(int, const Args&,
                                                 cudaStream_t);
extern template cudaError_t launch_lines<F_FIXED>(int, const Args&,
                                                  cudaStream_t);
extern template cudaError_t launch_lines<F_ADDREC>(int, const Args&,
                                                   cudaStream_t);
extern template cudaError_t launch_lines<F_SIGN>(int, const Args&,
                                                 cudaStream_t);

}  // namespace rasg
}  // namespace saugns
