// Staging of the self-PM kernels (5 and 6): one chain warp runs 32 rows,
// one lane each, fed from shared memory by producer warps.
//
// A self-PM row is one serial chain (fb feeds the next sample's phase),
// so what bounds a row is the latency of that chain, and everything
// that is not on it has to be taken off it: the inputs' global loads,
// the branch on the gate and the output stores. A block holds one chain
// warp (warp 0, rows r0 .. r0 + 31, one lane a row) and SP_WARPS
// producer warps. The producers stage tile t + 1 of every row into
// shared memory (coalesced loads, NW 32-bit words and the gate per
// sample; each warp loads 32 neighbouring samples of one row, unrolled
// so that many loads are in flight) and write tile t - 1's outputs back
// (coalesced stores), while the chain warp steps through tile t from
// shared memory and writes its outputs there. One __syncthreads a tile
// of ST_T samples hands the buffers over (two of each).
//
// Shared words are laid out [sample][row] with a row pitch of 33
// words: the chain warp reads one sample of 32 rows (consecutive words)
// and a producer warp writes 32 samples of one row (a stride of 33
// words), both free of bank conflicts. Beside each tile the producers
// note, per group of 32 samples and row, whether any sample is active;
// the chain warp skips a group that no lane of it needs (the flat
// path's block masks make whole blocks inactive) and stays converged
// otherwise: the gate is a select inside the step, not a branch.
#pragma once

#include "common.cuh"

namespace saugns {

constexpr int ST_T = 128;        // samples a tile
constexpr int ST_R = 32;         // rows a block (lanes of the chain warp)
constexpr int ST_PITCH = 33;     // words a sample row in shared memory
constexpr int ST_G = 32;         // samples a skip group
constexpr int ST_GROUPS = ST_T / ST_G;
constexpr int SP_WARPS = 3;      // producer warps
constexpr int SP_THREADS = 32 * SP_WARPS;
constexpr int ST_THREADS = 32 + SP_THREADS;
constexpr int SP_UNROLL = 8;     // loads in flight per producer thread
constexpr unsigned FULL_MASK = 0xffffffffu;

// Words of one buffer of NW staged words and the gate: ST_T + 1 sample
// rows (the chain warp prefetches one past the tile's end), ST_PITCH
// words each.
constexpr int ST_PLANE = (ST_T + 1) * ST_PITCH;

template <int NW>
struct StageSmem {
  // [2 buffers][NW words + gate][ST_T + 1][ST_PITCH] u32
  static constexpr size_t in_words = 2u * (NW + 1) * ST_PLANE;
  // [2 buffers][ST_T][ST_PITCH] f32
  static constexpr size_t out_words = 2u * ST_T * ST_PITCH;
  // [2 buffers][ST_GROUPS][ST_R] u8
  static constexpr size_t flag_bytes = 2u * ST_GROUPS * ST_R;
  static constexpr size_t bytes =
      4u * (in_words + out_words) + flag_bytes;

  uint32_t* in;
  float* out;
  uint8_t* flag;

  __device__ explicit StageSmem(unsigned char* base)
      : in(reinterpret_cast<uint32_t*>(base)),
        out(reinterpret_cast<float*>(base + 4u * in_words)),
        flag(base + 4u * (in_words + out_words)) {}

  // word k (k == NW: the gate) of buffer b
  __device__ uint32_t* plane(int b, int k) const {
    return in + ((size_t)b * (NW + 1) + k) * ST_PLANE;
  }
  __device__ float* outp(int b) const {
    return out + (size_t)b * ST_T * ST_PITCH;
  }
  __device__ uint8_t* flags(int b) const {
    return flag + b * ST_GROUPS * ST_R;
  }
};

// Producer side: stage samples [j0, j0 + ST_T) of rows [0, nr) of the
// block into buffer b. load(row, j, w) fills w[0 .. NW - 1] and the gate
// w[NW] (0 or 1) of sample j (< L) of the block's row `row`; samples at
// or past L stage zeros and an inactive gate. ptid in [0, SP_THREADS).
template <int NW, class Load>
__device__ __forceinline__ void stage_tile(const StageSmem<NW>& sm, int b,
                                           int ptid, int nr, long long L,
                                           long long j0, Load load) {
  const int n = nr * ST_T;
  uint8_t* fl = sm.flags(b);
  for (int e0 = 0; e0 < n; e0 += SP_THREADS * SP_UNROLL) {
    uint32_t w[SP_UNROLL][NW + 1];
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u) {
      const int e = e0 + u * SP_THREADS + ptid;
      const int row = e / ST_T;
      const long long j = j0 + (e % ST_T);
      if (e < n && j < L) {
        load(row, j, w[u]);
      } else {
#pragma unroll
        for (int k = 0; k <= NW; ++k) w[u][k] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u) {
      const int e = e0 + u * SP_THREADS + ptid;
      // e < n is the same for the 32 lanes of a warp (n and the
      // producer count are multiples of 32)
      if (e < n) {
        const int row = e / ST_T;
        const int jj = e % ST_T;
#pragma unroll
        for (int k = 0; k <= NW; ++k)
          sm.plane(b, k)[jj * ST_PITCH + row] = w[u][k];
        const bool any = __any_sync(FULL_MASK, w[u][NW] != 0u);
        if ((ptid & 31) == 0) fl[(jj / ST_G) * ST_R + row] = any;
      }
    }
  }
}

// Producer side: write buffer b's outputs of samples [j0, j0 + ST_T)
// (those < L) of rows [0, nr) to out (row-major, rows of L samples,
// from the block's first row).
__device__ __forceinline__ void write_tile(const float* so, int ptid,
                                           int nr, long long L,
                                           long long j0, float* out) {
  const int n = nr * ST_T;
  for (int e = ptid; e < n; e += SP_THREADS) {
    const int row = e / ST_T;
    const int jj = e % ST_T;
    const long long j = j0 + jj;
    if (j < L) out[(long long)row * L + j] = so[jj * ST_PITCH + row];
  }
}

// The block's schedule. Producers stage tile 0, then per tile t the
// chain warp runs step_tile(b = t & 1) while the producers stage tile
// t + 1 and write tile t - 1 back; one barrier a tile. The chain warp
// first clears the skip flags of the lanes past nr (no producer writes
// them). step_tile(b) is called by the 32 lanes of warp 0.
template <int NW, class Load, class StepTile>
__device__ __forceinline__ void run_rows(const StageSmem<NW>& sm, int nr,
                                         long long L, float* out_rows,
                                         Load load, StepTile step_tile) {
  const int tid = threadIdx.x;
  const long long nt = (L + ST_T - 1) / ST_T;
  if (tid < 32) {
    if (tid >= nr)
      for (int k = 0; k < 2 * ST_GROUPS; ++k) sm.flag[k * ST_R + tid] = 0;
  } else {
    stage_tile(sm, 0, tid - 32, nr, L, 0, load);
  }
  __syncthreads();
  for (long long t = 0; t < nt; ++t) {
    const int b = (int)(t & 1);
    if (tid < 32) {
      step_tile(b);
    } else {
      const int ptid = tid - 32;
      if (t + 1 < nt) stage_tile(sm, b ^ 1, ptid, nr, L, (t + 1) * ST_T,
                                 load);
      if (t > 0) write_tile(sm.outp(b ^ 1), ptid, nr, L, (t - 1) * ST_T,
                            out_rows);
    }
    __syncthreads();
  }
  if (tid >= 32)
    write_tile(sm.outp((int)((nt - 1) & 1)), tid - 32, nr, L,
               (nt - 1) * ST_T, out_rows);
}

}  // namespace saugns
