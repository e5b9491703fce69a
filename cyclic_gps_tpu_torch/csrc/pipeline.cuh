// Shared device functions of the split walks at ranks 1-8: kernel 7
// (backward_sweep.cu), kernel 9 (solve_sweep.cu) and kernel 11
// (inverse_sweep.cu).  Each takes a few chunk lanes a thread block and
// splits a lane's descending walk between warps: one warp runs the serial
// chain, the others stage the rows' inputs or form the outputs from what
// the chain parks in shared memory.  What they share:
//
//   park_get / park_put  a lane's R x R block in a shared-memory area laid
//                        out [n][L] (lane innermost: conflict-free)
//   bar<THREADS>         the named barrier between the chain warp and the
//                        other warps, which reach it from their own loops
//   stage, stage_commit, one element copied from device to shared memory
//   stage_wait<N>        with cp.async, committed as a group per row or
//                        tile and waited for by the thread that issued it
//   lanes_for            the chunk lanes a thread block takes
#pragma once

#include "blockmath.cuh"

namespace cgt {
namespace pipe {

// a lane's R x R block at element offset o of a [n][L] area
template <typename T, int R, int L>
__device__ __forceinline__ void park_get(const T* p, int o, T (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = p[(o + i * R + k) * L];
}

template <typename T, int R, int L>
__device__ __forceinline__ void park_put(T* p, int o, const T (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) p[(o + i * R + k) * L] = m[i][k];
}

// Named barrier 1 over THREADS threads (all of the block's): the chain
// warp and the other warps each reach it from their own loops.
template <int THREADS>
__device__ __forceinline__ void bar() {
  asm volatile("bar.sync 1, %0;" ::"r"(THREADS) : "memory");
}

// One element copied from device to shared memory without passing
// through registers (cp.async); a group of them is committed, and waited
// for by the thread that issued it.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   unsigned(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N groups of this thread are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The lanes a thread block takes when each lane needs `per_lane` bytes of
// shared memory: 32, or 16, 8, 4 where 32 would pass the 227 KB a block
// may take.
constexpr int lanes_for(size_t per_lane) {
  return per_lane * 32 <= 232448   ? 32
         : per_lane * 16 <= 232448 ? 16
         : per_lane * 8 <= 232448  ? 8
                                   : 4;
}

}  // namespace pipe
}  // namespace cgt
