// Runtime-d blocks: d x d blocks with d a RUNTIME value in 9..15, for the
// one kernel of these sizes that keeps one thread per chunk lane, the
// solve's back-substitution on the chunk-major layout (rt_solve.cu's
// rt_backsub_kernel), and the block-size range every runtime-d kernel
// checks (`rt_size`, WMAX).  The warp-per-lane kernels use rtcoop.cuh.
//
// One thread holds its lane's blocks as dense arrays sized for the largest
// d, WMAX = 15, and every loop is rolled and bounded by d, so one instance
// per dtype serves every block size 9..15 (the build stays cheap) and the
// loops do d^2 work, not 15^2.  The arrays live in local memory.
//
// Chunk-major addressing as everywhere in this package: matrices
// [s, d, d, L] and vectors [s, d, L] with the lane axis L innermost, so
// neighbouring threads touch neighbouring addresses.
#pragma once

#include "blockmath.cuh"

namespace cgt {
namespace rt {

constexpr int WMAX = 15;  // the largest runtime block size

template <typename T>
using Mat = T[WMAX][WMAX];
template <typename T>
using Vec = T[WMAX];

// element (a, b) of step j of a chunk-major matrix stack [s, d, d, L], lane c
__device__ __forceinline__ size_t m_at(int j, int a, int b, int d, int L,
                                       int c) {
  return ((size_t(j) * d + a) * d + b) * size_t(L) + c;
}

// element a of step j of a vector stack [s, d, L], lane c
__device__ __forceinline__ size_t v_at(int j, int a, int d, int L, int c) {
  return (size_t(j) * d + a) * size_t(L) + c;
}

template <typename T>
__device__ __forceinline__ void load_m(const T* p, int j, int d, int L,
                                       int c, Mat<T>& m) {
  for (int a = 0; a < d; ++a)
    for (int b = 0; b < d; ++b) m[a][b] = p[m_at(j, a, b, d, L, c)];
}

template <typename T>
__device__ __forceinline__ void load_v(const T* p, int j, int d, int L,
                                       int c, Vec<T>& v) {
  for (int a = 0; a < d; ++a) v[a] = p[v_at(j, a, d, L, c)];
}

template <typename T>
__device__ __forceinline__ void store_v(T* p, int j, int d, int L, int c,
                                        const Vec<T>& v) {
  for (int a = 0; a < d; ++a) p[v_at(j, a, d, L, c)] = v[a];
}

// out = a x  (or a^T x where TA), sums in ascending p
template <typename T, bool TA>
__device__ __forceinline__ void mv_op(const Mat<T>& a, const Vec<T>& x,
                                      Vec<T>& out, int d) {
  for (int i = 0; i < d; ++i) {
    T acc = (TA ? a[0][i] : a[i][0]) * x[0];
    for (int p = 1; p < d; ++p) acc += (TA ? a[p][i] : a[i][p]) * x[p];
    out[i] = acc;
  }
}

// the runtime block sizes the chunk-major kernels take
__host__ __device__ __forceinline__ bool rt_size(int d) {
  return d > 8 && d <= WMAX;
}

}  // namespace rt
}  // namespace cgt
