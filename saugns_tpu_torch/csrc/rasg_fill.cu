// Kernel 11's C interface: picks the row fill of the function and line
// type (see rasg_fill.cuh); the fills themselves are built in
// rasg_fill_f<func>.cu.
#include "rasg_fill.cuh"

using namespace saugns::rasg_fill;

extern "C" {

// out (rows, B) f32, the RasG samples of `rows` rows of B samples, on
// `stream`: from base (rows,) int64, and either inc, ln (rows,) int64
// (a per-row frequency; csum null) or csum, incs (rows, B) int64 (a
// per-sample one); pofs (rows, B) f32 or null (no PM input). `vec`
// says that B is a multiple of 4 and every (rows, B) pointer 16-byte
// aligned. Returns the cudaError_t of the launch.
int saugns_rasg_fill(const void* pofs, float pscale, const void* csum,
                     const void* incs, const void* inc, const void* ln,
                     const void* base, int func, int line, int level,
                     unsigned int alpha, int oflags, void* out,
                     long long row_len, long long n_rows, int vec,
                     void* stream) {
  if (row_len < 1 || n_rows < 1 || func < 0 || func > F_ADDREC ||
      line < 0 || line >= N_LINES || level < 0 || level > 31 ||
      base == nullptr ||
      (csum == nullptr ? inc == nullptr || ln == nullptr
                       : incs == nullptr))
    return (int)cudaErrorInvalidValue;
  const FillArgs A{(const float*)pofs, (const long long*)csum,
                   (const long long*)incs, (const long long*)inc,
                   (const long long*)ln, (const long long*)base,
                   (float*)out, row_len, n_rows, pscale, level, alpha,
                   oflags, vec != 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (func) {
    case F_URAND: return (int)fill_lines<F_URAND>(line, A, s);
    case F_GAUSS: return (int)fill_lines<F_GAUSS>(line, A, s);
    case F_BIN: return (int)fill_lines<F_BIN>(line, A, s);
    case F_TERN: return (int)fill_lines<F_TERN>(line, A, s);
    case F_FIXED:
      return (int)(level >= SIGN_LEVEL ? fill_lines<F_SIGN>(line, A, s)
                                       : fill_lines<F_FIXED>(line, A, s));
    default: return (int)fill_lines<F_ADDREC>(line, A, s);
  }
}

}  // extern "C"
