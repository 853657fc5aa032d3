// Kernel 6's row loops of one RasG function (F_BIN), for each of the
// 13 line types: one of the seven sources that nvcc builds side by side
// (see rasg_selfmod.cuh).
#include "rasg_selfmod.cuh"

namespace saugns {
namespace rasg {
template cudaError_t launch_lines<F_BIN>(int, const Args&, cudaStream_t);
}  // namespace rasg
}  // namespace saugns
