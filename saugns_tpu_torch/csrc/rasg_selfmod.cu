// Kernel 6's C interface: picks the row loop of the function and line
// type (see rasg_selfmod.cuh); the loops themselves are built in
// rasg_selfmod_f<func>.cu.
#include "rasg_selfmod.cuh"

using namespace saugns::rasg;

extern "C" {

// out (V, L) f32 and the (V,) end states ps, fb from ph (V, L) f32,
// cyc (V, L) int64 (only the low 32 bits count), am (V, L) f32, act
// (V, L) u8 and the (V,) seeds, on `stream`. Returns the cudaError_t
// of the launch.
int saugns_rasg_selfmod(const void* ph, const void* cyc, const void* am,
                        const void* act, const void* ps0, const void* fb0,
                        int func, int line, int level,
                        unsigned int alpha, int oflags, void* out,
                        void* ps_out, void* fb_out, long long row_len,
                        int n_rows, void* stream) {
  if (row_len < 1 || n_rows < 1 || func < 0 || func > F_ADDREC ||
      line < 0 || line >= N_LINES || level < 0 || level > 31)
    return (int)cudaErrorInvalidValue;
  const Args A{(const float*)ph, (const long long*)cyc,
               (const float*)am, (const uint8_t*)act,
               (const float*)ps0, (const float*)fb0, (float*)out,
               (float*)ps_out, (float*)fb_out, row_len, n_rows, level,
               alpha, oflags};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (func) {
    case F_URAND: return (int)launch_lines<F_URAND>(line, A, s);
    case F_GAUSS: return (int)launch_lines<F_GAUSS>(line, A, s);
    case F_BIN: return (int)launch_lines<F_BIN>(line, A, s);
    case F_TERN: return (int)launch_lines<F_TERN>(line, A, s);
    case F_FIXED:
      return (int)(level >= SIGN_LEVEL ? launch_lines<F_SIGN>(line, A, s)
                                       : launch_lines<F_FIXED>(line, A, s));
    default: return (int)launch_lines<F_ADDREC>(line, A, s);
  }
}

}  // extern "C"
