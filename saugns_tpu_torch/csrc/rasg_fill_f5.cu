// Kernel 11's row fills of one RasG function (F_ADDREC), for each of the 13
// line types: one of the seven sources that nvcc builds side by side
// (see rasg_fill.cuh).
#include "rasg_fill.cuh"

namespace saugns {
namespace rasg_fill {
template cudaError_t fill_lines<F_ADDREC>(int, const FillArgs&, cudaStream_t);
}  // namespace rasg_fill
}  // namespace saugns
