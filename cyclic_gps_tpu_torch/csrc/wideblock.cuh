// Shared device functions of the wide-layout kernels (wide_sweep.cu,
// wide_backward.cu): the wide (a11, strips) layout at the kernels' boundary.
// The d x d algebra between load and store, with d = 8 + e a RUNTIME value,
// is rtblock.cuh's.
//
// The layout (cyclic_gps_tpu/ops/wideblock.py:11-20): a d = 8 + e block of
// a chunk-major stack is held as
//   a11 [s, 8, 8, L]     the top-left 8 x 8 block
//   st  [s, 3e, 8, L]    rows 0..e-1 = A21, e..2e-1 = A12^T, 2e..3e-1 = A22
//                        (columns >= e of the A22 strip are zero)
// with the lane axis L innermost, as every kernel of this package.  A thread
// unpacks its lane's block to a dense d x d array on load and packs it on
// store; everything in between is plain d x d algebra.  The TPU kernels'
// blocked-panel Cholesky (wideblock.wchol) is the same right-looking
// elimination column by column, so the two agree to rounding.
#pragma once

#include "rtblock.cuh"

namespace cgt {
namespace wide {

using namespace cgt::rt;  // Mat, Vec, load_v, ... (d = 8 + e <= WMAX)

// element (a, b) of step j of an a11 stack [s, 8, 8, L], lane c
__device__ __forceinline__ size_t a11_at(int j, int a, int b, int L, int c) {
  return ((size_t(j) * 8 + a) * 8 + b) * size_t(L) + c;
}

// element (row, col) of step j of a strip stack [s, 3e, 8, L], lane c
__device__ __forceinline__ size_t st_at(int j, int row, int col, int e, int L,
                                        int c) {
  return ((size_t(j) * 3 * e + row) * 8 + col) * size_t(L) + c;
}

// unpack step j of the wide pair (p11, pst) into the dense d x d block m
template <typename T>
__device__ __forceinline__ void load_w(const T* p11, const T* pst, int j,
                                       int e, int L, int c, Mat<T>& m) {
  for (int a = 0; a < 8; ++a)
    for (int b = 0; b < 8; ++b) m[a][b] = p11[a11_at(j, a, b, L, c)];
  for (int i = 0; i < e; ++i)
    for (int b = 0; b < 8; ++b) {
      m[8 + i][b] = pst[st_at(j, i, b, e, L, c)];      // A21
      m[b][8 + i] = pst[st_at(j, e + i, b, e, L, c)];  // A12 (stored ^T)
    }
  for (int i = 0; i < e; ++i)
    for (int k = 0; k < e; ++k)
      m[8 + i][8 + k] = pst[st_at(j, 2 * e + i, k, e, L, c)];  // A22
}

// pack the dense d x d block m into step j of the wide pair (p11, pst),
// zeroing the A22 strip's columns >= e
template <typename T>
__device__ __forceinline__ void store_w(T* p11, T* pst, int j, int e, int L,
                                        int c, const Mat<T>& m) {
  for (int a = 0; a < 8; ++a)
    for (int b = 0; b < 8; ++b) p11[a11_at(j, a, b, L, c)] = m[a][b];
  for (int i = 0; i < e; ++i)
    for (int b = 0; b < 8; ++b) {
      pst[st_at(j, i, b, e, L, c)] = m[8 + i][b];
      pst[st_at(j, e + i, b, e, L, c)] = m[b][8 + i];
      pst[st_at(j, 2 * e + i, b, e, L, c)] = (b < e) ? m[8 + i][8 + b]
                                                      : T(0);
    }
}

}  // namespace wide
}  // namespace cgt
