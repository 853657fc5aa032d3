// Latency probe: one thread runs a long dependent chain of one
// instruction class and times it with clock64(); cycles per operation
// = cycles / (CHAIN x reps). Each chain is inline PTX, so the front
// end cannot fold it, and each op's output is its next op's input
// (conversions feed their result's bits back as the next input, a
// register rename). Built by tools/torch_chain_latency.py with nvcc;
// plain C interface, loaded with ctypes.
#include <cstdint>
#include <cuda_runtime.h>

#define R4(x) x x x x
#define R16(x) R4(R4(x))
#define R64(x) R16(R4(x))
#define CHAIN 64

namespace {

// float operand chains: x = op(x, y)
#define F32_KERNEL(NAME, ASM)                                             \
  __global__ void NAME(float* io, long long* cyc, int reps) {             \
    float x = io[0];                                                      \
    const float y = io[1];                                                \
    const long long t0 = clock64();                                       \
    for (int r = 0; r < reps; ++r) {                                      \
      R64(asm volatile(ASM : "+f"(x) : "f"(y));)                          \
    }                                                                     \
    const long long t1 = clock64();                                       \
    io[0] = x;                                                            \
    cyc[0] = t1 - t0;                                                     \
  }

#define F64_KERNEL(NAME, ASM)                                             \
  __global__ void NAME(double* io, long long* cyc, int reps) {            \
    double x = io[0];                                                     \
    const double y = io[1];                                               \
    const long long t0 = clock64();                                       \
    for (int r = 0; r < reps; ++r) {                                      \
      R64(asm volatile(ASM : "+d"(x) : "d"(y));)                          \
    }                                                                     \
    const long long t1 = clock64();                                       \
    io[0] = x;                                                            \
    cyc[0] = t1 - t0;                                                     \
  }

#define U32_KERNEL(NAME, ASM)                                             \
  __global__ void NAME(uint32_t* io, long long* cyc, int reps) {          \
    uint32_t x = io[0];                                                   \
    const uint32_t y = io[1];                                             \
    const long long t0 = clock64();                                       \
    for (int r = 0; r < reps; ++r) {                                      \
      R64(asm volatile(ASM : "+r"(x) : "r"(y));)                          \
    }                                                                     \
    const long long t1 = clock64();                                       \
    io[0] = x;                                                            \
    cyc[0] = t1 - t0;                                                     \
  }

F32_KERNEL(k_fmul, "mul.rn.f32 %0, %0, %1;")
F32_KERNEL(k_fadd, "add.rn.f32 %0, %0, %1;")
F64_KERNEL(k_dmul, "mul.rn.f64 %0, %0, %1;")
F64_KERNEL(k_dadd, "add.rn.f64 %0, %0, %1;")
// float -> s64, round to nearest even (__float2ll_rn); the low word's
// bits are the next input
F32_KERNEL(k_f2i_s64,
           "{ .reg .s64 t; .reg .b32 lo, hi; cvt.rni.s64.f32 t, %0; "
           "mov.b64 {lo, hi}, t; mov.b32 %0, lo; }")
// float -> s32, round down (__float2int_rd)
F32_KERNEL(k_f2i_s32_rd,
           "{ .reg .s32 t; cvt.rmi.s32.f32 t, %0; mov.b32 %0, t;  }")
// s32 -> float, u32 -> float (__int2float_rn, __uint2float_rn)
U32_KERNEL(k_i2f_s32,
           "{ .reg .f32 t; cvt.rn.f32.s32 t, %0; mov.b32 %0, t;  }")
U32_KERNEL(k_i2f_u32,
           "{ .reg .f32 t; cvt.rn.f32.u32 t, %0; mov.b32 %0, t;  }")
// float -> double: the high word's bits are the next input
F32_KERNEL(k_f2d,
           "{ .reg .f64 t; .reg .b32 lo, hi; cvt.f64.f32 t, %0; "
           "mov.b64 {lo, hi}, t; mov.b32 %0, hi; }")
// float -> double -> float (the double -> float latency is this pair's
// less the float -> double one)
F32_KERNEL(k_f2d_d2f,
           "{ .reg .f64 t; cvt.f64.f32 t, %0; cvt.rn.f32.f64 %0, t; }")
// two adds, which ptxas merges into one three-input IADD3
U32_KERNEL(k_iadd3, "add.u32 %0, %0, %1; add.u32 %0, %0, %1;")
// a logic op and an add (LOP3 then IADD3: no merge, no folding)
U32_KERNEL(k_xor_add, "xor.b32 %0, %0, %1; add.u32 %0, %0, %1;")
U32_KERNEL(k_shf, "shr.b32 %0, %0, %1;")
U32_KERNEL(k_imad, "mul.lo.u32 %0, %0, %1;")
// integer compare and select: x = x < y ? y : 3 (ISETP then SEL)
U32_KERNEL(k_isetp_sel,
           "{ .reg .pred p; setp.lt.u32 p, %0, %1; "
           "selp.b32 %0, %1, 3, p; }")
// float select on a predicate fixed before the chain
F32_KERNEL(k_fsel,
           "{ .reg .pred p; setp.ne.f32 p, %1, 0f7F800000; "
           "selp.f32 %0, %0, %1, p; }")
// the correctly rounded float division (__fdiv_rn): x = y / x
F32_KERNEL(k_fdiv, "div.rn.f32 %0, %1, %0;")

// shared-memory pointer chases of 4, 8 and 16 bytes: each word at the
// chased address holds its own shared address
#define LDS_KERNEL(NAME, ASM)                                             \
  __global__ void NAME(uint32_t* io, long long* cyc, int reps) {          \
    __shared__ __align__(16) uint32_t sh[256];                            \
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(sh);         \
    for (int k = 0; k < 256; ++k) sh[k] = base + 4u * (k & ~3);           \
    __syncthreads();                                                      \
    uint32_t x = base + 16u * (io[0] & 7u);                               \
    uint32_t d0 = 0, d1 = 0, d2 = 0;                                      \
    const long long t0 = clock64();                                       \
    for (int r = 0; r < reps; ++r) {                                      \
      R64(asm volatile(ASM : "+r"(x), "+r"(d0), "+r"(d1), "+r"(d2));)     \
    }                                                                     \
    const long long t1 = clock64();                                       \
    io[0] = x + d0 + d1 + d2;                                             \
    cyc[0] = t1 - t0;                                                     \
  }

LDS_KERNEL(k_lds32, "ld.shared.u32 %0, [%0];")
LDS_KERNEL(k_lds64, "ld.shared.v2.u32 {%0, %1}, [%0];")
LDS_KERNEL(k_lds128, "ld.shared.v4.u32 {%0, %1, %2, %3}, [%0];")

// the SM clock: a float multiply chain timed by clock64() and by the
// global nanosecond timer
__global__ void k_clock(float* io, long long* cyc, int reps) {
  float x = io[0];
  const float y = io[1];
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    R64(asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));)
  }
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  io[0] = x;
  cyc[0] = t1 - t0;
  cyc[1] = g1 - g0;
}

// Throughput probes: every thread of a full grid runs TP_ACC
// independent chains of one instruction class, so the unit, not the
// latency, sets the rate; ops = blocks x TP_THREADS x reps x 16 x
// TP_ACC x the operations of one step.
#define TP_ACC 8
#define TP_THREADS 256
#define TP_BLOCKS_PER_SM 8

#define TP_KERNEL(NAME, T, CONS, ASM)                                     \
  __global__ void NAME(T* io, int reps) {                                 \
    T x[TP_ACC];                                                          \
    for (int k = 0; k < TP_ACC; ++k) x[k] = io[0];                        \
    const T y = io[1];                                                    \
    for (int r = 0; r < reps; ++r) {                                      \
      _Pragma("unroll") for (int j = 0; j < 16; ++j)                      \
        _Pragma("unroll") for (int k = 0; k < TP_ACC; ++k)                \
          asm volatile(ASM : "+" CONS(x[k]) : CONS(y));                   \
    }                                                                     \
    T s = x[0];                                                           \
    for (int k = 1; k < TP_ACC; ++k) s = s + x[k];                        \
    if (s == io[2]) io[3] = s;                                            \
  }

TP_KERNEL(t_dmul, double, "d", "mul.rn.f64 %0, %0, %1;")
TP_KERNEL(t_f2d_d2f, float, "f",
          "{ .reg .f64 t; cvt.f64.f32 t, %0; cvt.rn.f32.f64 %0, t; "
          "add.f32 %0, %0, %1; }")
TP_KERNEL(t_i2f_f2i, uint32_t, "r",
          "{ .reg .f32 t; cvt.rn.f32.u32 t, %0; cvt.rzi.u32.f32 %0, t; "
          "add.u32 %0, %0, %1; }")
TP_KERNEL(t_rcp, float, "f", "rcp.approx.ftz.f32 %0, %0; add.f32 %0, %0, %1;")

template <class T>
cudaError_t tput(void (*k)(T*, int), T a, T b, int reps, int blocks,
                 float* ms) {
  T* io = nullptr;
  cudaEvent_t e0 = nullptr, e1 = nullptr;
  cudaError_t e = cudaMalloc(&io, 4 * sizeof(T));
  const T init[4] = {a, b, (T)(-12345), (T)0};
  if (e == cudaSuccess)
    e = cudaMemcpy(io, init, sizeof(init), cudaMemcpyHostToDevice);
  if (e == cudaSuccess) e = cudaEventCreate(&e0);
  if (e == cudaSuccess) e = cudaEventCreate(&e1);
  if (e == cudaSuccess) {
    k<<<blocks, TP_THREADS>>>(io, reps);   // warm-up
    e = cudaDeviceSynchronize();
  }
  if (e == cudaSuccess) {
    cudaEventRecord(e0);
    k<<<blocks, TP_THREADS>>>(io, reps);
    cudaEventRecord(e1);
    e = cudaEventSynchronize(e1);
  }
  if (e == cudaSuccess) e = cudaEventElapsedTime(ms, e0, e1);
  if (e0) cudaEventDestroy(e0);
  if (e1) cudaEventDestroy(e1);
  cudaFree(io);
  return e;
}

template <class T>
cudaError_t run(void (*k)(T*, long long*, int), T a, T b, int reps,
                long long* host) {
  T* io = nullptr;
  long long* cyc = nullptr;
  cudaError_t e = cudaMalloc(&io, 2 * sizeof(T));
  if (e == cudaSuccess) e = cudaMalloc(&cyc, 2 * sizeof(long long));
  const T init[2] = {a, b};
  if (e == cudaSuccess)
    e = cudaMemcpy(io, init, sizeof(init), cudaMemcpyHostToDevice);
  for (int w = 0; w < 2 && e == cudaSuccess; ++w) {  // warm-up, then time
    k<<<1, 1>>>(io, cyc, reps);
    e = cudaDeviceSynchronize();
  }
  if (e == cudaSuccess)
    e = cudaMemcpy(host, cyc, 2 * sizeof(long long),
                   cudaMemcpyDeviceToHost);
  cudaFree(io);
  cudaFree(cyc);
  return e;
}

}  // namespace

extern "C" {

// Names of the probes, in the order of saugns_chain_probe's output.
const char* saugns_chain_probe_names() {
  return "fmul,fadd,dmul,dadd,f2i_s64,f2i_s32_rd,i2f_s32,i2f_u32,f2d,"
         "f2d_d2f,iadd3,xor_add,shf,imad,isetp_sel,fsel,fdiv,lds32,lds64,"
         "lds128";
}

// Cycles of each probe's whole chain (n_ops = CHAIN x reps dependent
// steps each) into cycles[0 .. 19]; clock[0] = cycles and
// clock[1] = nanoseconds of one float multiply chain of the same
// length. Returns a cudaError_t.
int saugns_chain_probe(int reps, long long* cycles, long long* clock,
                       long long* n_ops) {
  long long h[2];
  cudaError_t e = cudaSuccess;
  int i = 0;
#define PROBE(K, T, A, B)                                   \
  if (e == cudaSuccess) {                                   \
    e = run<T>(K, (T)(A), (T)(B), reps, h);                 \
    cycles[i++] = h[0];                                     \
  }
  PROBE(k_fmul, float, 1.5, 1.0)
  PROBE(k_fadd, float, 1.5, 0.0)
  PROBE(k_dmul, double, 1.5, 1.0)
  PROBE(k_dadd, double, 1.5, 0.0)
  PROBE(k_f2i_s64, float, 1.5, 0.0)
  PROBE(k_f2i_s32_rd, float, 1.5, 0.0)
  PROBE(k_i2f_s32, uint32_t, 3, 0)
  PROBE(k_i2f_u32, uint32_t, 3, 0)
  PROBE(k_f2d, float, 1.5, 0.0)
  PROBE(k_f2d_d2f, float, 1.5, 0.0)
  PROBE(k_iadd3, uint32_t, 3, 1)
  PROBE(k_xor_add, uint32_t, 3, 5)
  PROBE(k_shf, uint32_t, 3, 0)
  PROBE(k_imad, uint32_t, 3, 1)
  PROBE(k_isetp_sel, uint32_t, 3, 5)
  PROBE(k_fsel, float, 1.5, 1.0)
  PROBE(k_fdiv, float, 1.5, 3.0)
  PROBE(k_lds32, uint32_t, 0, 0)
  PROBE(k_lds64, uint32_t, 0, 0)
  PROBE(k_lds128, uint32_t, 0, 0)
#undef PROBE
  if (e == cudaSuccess) e = run<float>(k_clock, 1.5f, 1.0f, reps, clock);
  *n_ops = (long long)CHAIN * reps;
  return (int)e;
}

// Names of the throughput probes, in the order of saugns_tput_probe's
// results.
const char* saugns_tput_probe_names() { return "dmul,f2d_d2f,i2f_f2i,rcp"; }

// Operations of each throughput probe's class per nanosecond of the
// whole card into ops_per_ns[0 .. 3], and the SM count into *sms.
// Returns a cudaError_t.
int saugns_tput_probe(int reps, double* ops_per_ns, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = *sms * TP_BLOCKS_PER_SM;
  const double steps = (double)blocks * TP_THREADS * reps * 16 * TP_ACC;
  // instructions of the class in one step of each probe (the add that
  // keeps a step from folding is not counted: it runs on another unit)
  const int ops[4] = {1, 2, 2, 1};
  float ms = 0.0f;
  int i = 0;
#define TPUT(K, T, A, B)                                          \
  if (e == cudaSuccess) {                                         \
    e = tput<T>(K, (T)(A), (T)(B), reps, blocks, &ms);            \
    ops_per_ns[i] = steps * ops[i] / (1e6 * ms);                  \
    ++i;                                                          \
  }
  TPUT(t_dmul, double, 1.5, 1.0)
  TPUT(t_f2d_d2f, float, 1.5, 0.0)
  TPUT(t_i2f_f2i, uint32_t, 3, 0)
  TPUT(t_rcp, float, 1.5, 0.0)
#undef TPUT
  return (int)e;
}

}  // extern "C"
