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
// Bound: the dependent chain. fb feeds the next sample's cycle and
// phase, so a row is one serial chain of a few integer hashes and
// about 30 float32 operations per sample; bytes (17 B per sample) and
// the card's operation rate are far from binding. One thread runs one
// row; function, line type, level, alpha and flags are launch
// arguments (uniform branches), not template parameters, so one build
// serves every combination.

#include "common.cuh"

namespace {

constexpr int RS_THREADS = 64;
constexpr float SCALE31 = 4.656612873077393e-10f;   // 2^-31
constexpr float SCALE32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float HALF_SCALE31 = 2.3283064365386963e-10f;  // 0.5 * 2^-31
constexpr uint32_t FIBH32 = 0x9e3779b9u;

enum { F_URAND, F_GAUSS, F_BIN, F_TERN, F_FIXED, F_ADDREC };
enum { O_PERLIN = 1, O_HALFSHAPE = 2, O_ZIGZAG = 4, O_SQUARE = 8,
       O_VIOLET = 16 };

__constant__ float PERLIN_AMP[13] = {
    2.0f, 2.0f, 1.0f,
    1.5584580898284912f, 1.5584580898284912f, 1.5584580898284912f,
    1.5584580898284912f, 1.8933908939361572f, 2.0f, 2.0f, 2.0f,
    1.8933908939361572f, 1.0f};

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

__device__ __forceinline__ float sinpi_d5(float x) {
  const float x2 = fm(x, x);
  return fm(x, fa(3.140427350997925f,
                  fm(x2, fa(-5.136557579040527f,
                            fm(x2, 2.299391746520996f)))));
}

// soft-saturated Gaussian hash noise (noise.h:61-98)
__device__ float franssgauss32(uint32_t n) {
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

__device__ __forceinline__ float i2f(uint32_t x) {
  return __int2float_rn((int)x);
}

// The endpoint pair of the segment at `cycle` (rasg.h:296-683) as
// tdsp._rasg_terms gives it: the pair is (xa * c, xb * c) for the
// returned constant c, or (xa, xb) where c is 0 (Gaussian values, the
// fixed +-1 pair).
__device__ float rasg_terms(int func, int level, uint32_t alpha,
                            int oflags, uint32_t cycle, float& xa,
                            float& xb) {
  const bool violet = (oflags & O_VIOLET) != 0;
  const uint32_t c1 = cycle + 1u;
  if (func == F_GAUSS) {
    xa = franssgauss32(cycle);
    xb = franssgauss32(c1);
    return 0.0f;
  }
  if (func == F_ADDREC) {
    xa = i2f(cycle * alpha);
    xb = i2f(c1 * alpha);
    return SCALE31;
  }
  const uint32_t r_m1 = ranfast32(cycle - 1u);
  const uint32_t r_0 = ranfast32(cycle);
  const uint32_t r_p1 = ranfast32(c1);
  const uint32_t odd = cycle & 1u;
  if (func == F_URAND) {
    if (!violet) {
      xa = i2f(r_0);
      xb = i2f(r_p1);
    } else {
      xa = i2f((r_0 >> 1) - (r_m1 >> 1));
      xb = i2f((r_p1 >> 1) - (r_0 >> 1));
    }
    return SCALE31;
  }
  const uint32_t sb = odd << 31;
  const uint32_t sb_flip = 0x80000000u - sb;
  if (func == F_BIN) {
    if (!violet) {
      const uint32_t offs = 0x7fffffffu + odd * 2u;
      xa = i2f(sar(r_0, level) + offs);
      xb = i2f(sar(r_p1, level) - offs);
      return SCALE31;
    }
    const float sd =
        fs(1.0f, fm(__int2float_rn(0x7fffffff >> level), SCALE31));
    const uint32_t vb0 = divi2(sar(r_m1, level) + sb);
    const uint32_t vb1 = divi2(sar(r_0, level) + sb_flip);
    const uint32_t vb2 = divi2(sar(r_p1, level) + sb);
    xa = i2f(vb1 - vb0);
    xb = i2f(vb2 - vb1);
    return fm(fa(1.0f, fm(sd, sd)), SCALE31);
  }
  if (func == F_TERN) {
    xa = i2f(sar(r_0, level) + sb_flip);
    xb = i2f(sar(r_p1, level) + sb);
    return SCALE31;
  }
  // F_FIXED
  const uint32_t sign = 1u - odd * 2u;  // +1 or -1 as u32
  if (level >= 27) {                    // ras_level(9)
    xa = i2f(sign);
    xb = -xa;
    return 0.0f;
  }
  const uint32_t r0 = (uint32_t)((int)r_0 >> level) - 0x7fffffffu;
  const uint32_t r1 = (uint32_t)((int)r_p1 >> level) - 0x7fffffffu;
  if (!violet) {
    xa = i2f((0u - sign) * r0);
    xb = i2f(sign * r1);
    return SCALE31;
  }
  const uint32_t rm = (uint32_t)((int)r_m1 >> level) - 0x7fffffffu;
  const uint32_t s0 = divi2(sign * rm);
  const uint32_t s1 = divi2((0u - sign) * r0);
  const uint32_t s2 = divi2(sign * r1);
  xa = i2f(s1 - s0);
  xb = i2f(s2 - s1);
  return SCALE31;
}

__device__ __forceinline__ float expramp6(float x) {
  const float x2 = fm(x, x);
  const float xA = fm(x, 0.3510044515132904f);   // 629 / 1792
  const float x3 = fm(x2, x);
  const float p = fa(fm(x2, 0.6489955186843872f), xA);  // 1163 / 1792
  return fa(x3, fm(x2, fm(fa(x3, -1.0f), p)));
}

// sauLine_val_* (sau/line.h:152-266), as tdsp.line_val evaluates it
__device__ float line_val(int line, float x, float a, float b) {
  switch (line) {
    case 0: {  // cos
      const float y = fs(x, 0.5f);
      const float y2 = fm(y, y);
      const float sr = fm(y, fa(1.5702136754989624f,
                                fm(y2, fa(-2.5682787895202637f,
                                          fm(y2,
                                             1.149695873260498f)))));
      return fa(a, fm(fs(b, a), fa(sr, 0.5f)));
    }
    case 1:
      return fa(a, fm(fs(b, a), x));
    case 2:
      return a;
    case 3:
    case 4: {
      const bool lo = line == 3 ? a > b : a < b;
      return lo ? fa(b, fm(fs(a, b), expramp6(fs(1.0f, x))))
                : fa(a, fm(fs(b, a), expramp6(x)));
    }
    case 5:
      return fa(b, fm(fs(a, b), expramp6(fs(1.0f, x))));
    case 6:
      return fa(a, fm(fs(b, a), expramp6(x)));
    case 7: {
      const float x1 = fs(1.0f, x);
      return fa(b, fm(fs(a, b), fm(x1, x1)));
    }
    case 8: {
      float x1 = fs(0.5f, x);
      x1 = fa(x1, x1);
      const float k = fm(fs(a, b), 0.5f);
      return fa(b, fm(fa(fm(fm(x1, x1), x1), 1.0f), k));
    }
    case 9: {
      const float x3d = fm(fm(fs(b, a), x), fm(x, x));
      return fa(a, fm(x3d, fa(fm(fa(fm(x, 6.0f), -15.0f), x), 10.0f)));
    }
    default:
      break;
  }
  const float s =
      __int2float_rn((int)ranfast32(__float_as_uint(x)));
  if (line == 10) {  // ncl
    const float q = fa(fm(fa(fa(x, x), -3.0f), x), 1.0f);
    return fa(a, fm(fa(x, fm(fm(s, q), fm(x, HALF_SCALE31))), fs(b, a)));
  }
  if (line == 11) {  // nhl
    const float q = fs(1.0f, x);
    return fa(a, fm(fa(x, fm(fm(q, s), fm(x, SCALE31))), fs(b, a)));
  }
  return fa(a, fm(fs(b, a), fa(0.5f, fm(HALF_SCALE31, s))));  // uwh
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

__device__ __forceinline__ float perlin_amp(int line, int oflags) {
  return oflags & (O_HALFSHAPE | O_ZIGZAG) ? 1.0f : PERLIN_AMP[line];
}

// mode-flag post-pass and line map (rasg.h:692-743)
__device__ float rasg_shape(int line, int oflags, float phase, float a,
                            float b) {
  if (oflags & O_PERLIN) {
    const float pa = perlin_amp(line, oflags);
    a = fm(a, fm(pa, phase));
    b = fm(b, fm(pa, fs(phase, 1.0f)));
  }
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
  return line_val(line, phase, a, b);
}

// rasg_shape(rasg_map(cycle), phase) as tdsp.rasg_selfmod_sample
// gives it: a Perlin amplitude pa other than 1 folds into the map's
// constant scale c, (xa * phase) * (c * pa), as XLA's simplifier
// rewrites the reference's self-PM scan body
__device__ float selfmod_sample(int func, int line, int level,
                                uint32_t alpha, int oflags,
                                uint32_t cycle, float phase) {
  float xa, xb;
  const float c = rasg_terms(func, level, alpha, oflags, cycle, xa, xb);
  if (c == 0.0f) return rasg_shape(line, oflags, phase, xa, xb);
  const float pa = perlin_amp(line, oflags);
  if (!(oflags & O_PERLIN) || pa == 1.0f)
    return rasg_shape(line, oflags, phase, fm(xa, c), fm(xb, c));
  const float k = fm(c, pa);
  const float a = fm(fm(xa, phase), k);
  const float b = fm(fm(xb, fs(phase, 1.0f)), k);
  return rasg_shape(line, oflags & ~O_PERLIN, phase, a, b);
}

struct Mode {
  int func, line, level, oflags;
  uint32_t alpha;
};

__global__ void rasg_selfmod_rows(
    const float* __restrict__ ph, const uint32_t* __restrict__ cyc,
    const float* __restrict__ am, const uint8_t* __restrict__ act,
    const float* __restrict__ ps0, const float* __restrict__ fb0,
    Mode md, float* __restrict__ out, float* __restrict__ ps_out,
    float* __restrict__ fb_out, long long L, int V) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= V) return;
  const long long base = (long long)r * L;
  float ps = ps0[r];
  float fb = fb0[r];
  for (long long j = 0; j < L; ++j) {
    const long long i = base + j;
    if (!act[i]) {
      out[i] = 0.0f;
      continue;
    }
    float phase = fa(ph[i], fm(fm(fb, am[i]), 0.5f));
    const int adj = __float2int_rd(phase);
    const uint32_t cycle = cyc[i] + (uint32_t)adj;
    phase = fs(phase, __int2float_rn(adj));
    const float s = selfmod_sample(md.func, md.line, md.level, md.alpha,
                                   md.oflags, cycle, phase);
    fb = fm(fa(fa(fb, s), ps), 0.5f);
    ps = s;
    out[i] = s;
  }
  ps_out[r] = ps;
  fb_out[r] = fb;
}

}  // namespace

extern "C" {

// out (V, L) f32 and the (V,) end states ps, fb from ph (V, L) f32,
// cyc (V, L) u32, am (V, L) f32, act (V, L) u8 and the (V,) seeds, on
// `stream`. Returns the cudaError_t of the launch.
int saugns_rasg_selfmod(const void* ph, const void* cyc, const void* am,
                        const void* act, const void* ps0, const void* fb0,
                        int func, int line, int level,
                        unsigned int alpha, int oflags, void* out,
                        void* ps_out, void* fb_out, long long row_len,
                        int n_rows, void* stream) {
  if (row_len < 1 || n_rows < 1 || func < 0 || func > F_ADDREC ||
      line < 0 || line > 12 || level < 0 || level > 31)
    return (int)cudaErrorInvalidValue;
  const int threads = n_rows < RS_THREADS ? 32 : RS_THREADS;
  const unsigned blocks = (unsigned)((n_rows + threads - 1) / threads);
  Mode md{func, line, level, oflags, alpha};
  rasg_selfmod_rows<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ph, (const uint32_t*)cyc, (const float*)am,
      (const uint8_t*)act, (const float*)ps0, (const float*)fb0, md,
      (float*)out, (float*)ps_out, (float*)fb_out, row_len, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
