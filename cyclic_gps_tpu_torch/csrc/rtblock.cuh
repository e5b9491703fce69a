// Runtime-d block algebra: d x d blocks with d a RUNTIME value in 9..15,
// of the kernels that keep one thread per chunk lane: the wide-layout sweep
// (wide_sweep.cu's wide_sweep_kernel, through wideblock.cuh) and the
// solve's back-substitution on the chunk-major layout (rt_solve.cu).  The
// warp-per-lane kernels use rtcoop.cuh, which keeps these sums' order.
//
// One thread holds its lane's blocks as dense arrays sized for the largest
// d, WMAX = 15, and every loop is rolled and bounded by d, so one instance
// per dtype serves every block size 9..15 (the build stays cheap) and the
// loops do d^3 work, not 15^3.  The arrays live in local memory.
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
__device__ __forceinline__ void store_m(T* p, int j, int d, int L, int c,
                                        const Mat<T>& m) {
  for (int a = 0; a < d; ++a)
    for (int b = 0; b < d; ++b) p[m_at(j, a, b, d, L, c)] = m[a][b];
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

// ---------------------------------------------------------------------------
// d x d algebra (sums in ascending k, as the Pallas helpers).
// ---------------------------------------------------------------------------

// out = op(a) op(b), op transposing where TA / TB
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void mm_op(const Mat<T>& a, const Mat<T>& b,
                                      Mat<T>& out, int d) {
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) {
      T acc = (TA ? a[0][i] : a[i][0]) * (TB ? b[k][0] : b[0][k]);
      for (int p = 1; p < d; ++p)
        acc += (TA ? a[p][i] : a[i][p]) * (TB ? b[k][p] : b[p][k]);
      out[i][k] = acc;
    }
}

template <typename T>
__device__ __forceinline__ void mm(const Mat<T>& a, const Mat<T>& b,
                                   Mat<T>& out, int d) {
  mm_op<T, false, false>(a, b, out, d);
}

template <typename T>
__device__ __forceinline__ void mm_tb(const Mat<T>& a, const Mat<T>& b,
                                      Mat<T>& out, int d) {
  mm_op<T, false, true>(a, b, out, d);
}

template <typename T>
__device__ __forceinline__ void mm_ta(const Mat<T>& a, const Mat<T>& b,
                                      Mat<T>& out, int d) {
  mm_op<T, true, false>(a, b, out, d);
}

// out = a x  (or a^T x where TA)
template <typename T, bool TA>
__device__ __forceinline__ void mv_op(const Mat<T>& a, const Vec<T>& x,
                                      Vec<T>& out, int d) {
  for (int i = 0; i < d; ++i) {
    T acc = (TA ? a[0][i] : a[i][0]) * x[0];
    for (int p = 1; p < d; ++p) acc += (TA ? a[p][i] : a[i][p]) * x[p];
    out[i] = acc;
  }
}

template <typename T>
__device__ __forceinline__ void transpose(const Mat<T>& a, Mat<T>& out,
                                          int d) {
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) out[i][k] = a[k][i];
}

template <typename T>
__device__ __forceinline__ void copy_(const Mat<T>& a, Mat<T>& out, int d) {
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) out[i][k] = a[i][k];
}

// out += a b
template <typename T>
__device__ __forceinline__ void mm_add(const Mat<T>& a, const Mat<T>& b,
                                       Mat<T>& out, Mat<T>& t, int d) {
  mm<T>(a, b, t, d);
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) out[i][k] += t[i][k];
}

// a0 = p00 u0^T + p01 u1^T,  a1 = p10 u0^T + p11 u1^T  (Sigma_BB U^T)
template <typename T>
__device__ __forceinline__ void sig_ut(const Mat<T>& p00, const Mat<T>& p01,
                                       const Mat<T>& p10, const Mat<T>& p11,
                                       const Mat<T>& u0, const Mat<T>& u1,
                                       Mat<T>& a0, Mat<T>& a1, Mat<T>& t,
                                       int d) {
  mm_tb<T>(p00, u0, a0, d);
  mm_tb<T>(p01, u1, t, d);
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) a0[i][k] += t[i][k];
  mm_tb<T>(p10, u0, a1, d);
  mm_tb<T>(p11, u1, t, d);
  for (int i = 0; i < d; ++i)
    for (int k = 0; k < d; ++k) a1[i][k] += t[i][k];
}

// Lower Cholesky of the SPD block a (lower triangle read): L, 1/L_jj and the
// half log-determinant.  rsqrt pivots, no floor, as the TPU kernels.
template <typename T>
__device__ __forceinline__ T chol(const Mat<T>& a, Mat<T>& L, Vec<T>& invd,
                                  int d) {
  Mat<T> x;
  for (int i = 0; i < d; ++i)
    for (int k = 0; k <= i; ++k) x[i][k] = a[i][k];
  T ld = T(0);
  for (int j = 0; j < d; ++j) {
    const T piv = x[j][j];
    const T pinv = rsqrt_(piv);
    invd[j] = pinv;
    ld += T(0.5) * log_(piv);
    for (int i = 0; i < d; ++i) L[i][j] = (i >= j) ? x[i][j] * pinv : T(0);
    for (int i = j + 1; i < d; ++i)
      for (int k = j + 1; k <= i; ++k) x[i][k] -= L[i][j] * L[k][j];
  }
  return ld;
}

// L X = Y (forward substitution), matrix right-hand side; x may alias y
template <typename T>
__device__ __forceinline__ void solve_lower(const Mat<T>& L,
                                            const Vec<T>& invd,
                                            const Mat<T>& y, Mat<T>& x,
                                            int d) {
  for (int e = 0; e < d; ++e)
    for (int i = 0; i < d; ++i) {
      T acc = y[i][e];
      for (int k = 0; k < i; ++k) acc -= L[i][k] * x[k][e];
      x[i][e] = acc * invd[i];
    }
}

// L x = y, vector right-hand side; x may alias y
template <typename T>
__device__ __forceinline__ void solve_lower_vec(const Mat<T>& L,
                                                const Vec<T>& invd,
                                                const Vec<T>& y, Vec<T>& x,
                                                int d) {
  for (int i = 0; i < d; ++i) {
    T acc = y[i];
    for (int k = 0; k < i; ++k) acc -= L[i][k] * x[k];
    x[i] = acc * invd[i];
  }
}

// ---------------------------------------------------------------------------
// One step of the chunk-interior elimination (pallas_sweep._sweep_kernel and
// its wide twin pallas_wide._wide_sweep_kernel).
// ---------------------------------------------------------------------------

template <typename T>
struct Carry {
  Mat<T> cprev;  // C_j = O_j D_j^{-T}
  Mat<T> w0;     // W0_j
  Mat<T> D;      // D_j
  Mat<T> acc;    // sum W0^T W0
  Vec<T> w;      // w_j
  Vec<T> invd;
  Vec<T> accy0;  // sum W0^T w
  T mh;          // sum ||w||^2 (this lane)
  T ld;          // sum log diag D (this lane)
};

// Eliminate one row given its pivot block P (jitter added), its right
// coupling o_j and right-hand side y_j; ``first`` seeds W0 from o_left.
// P and o_j are used as scratch.  Returns the row's half log-determinant.
template <typename T>
__device__ __forceinline__ T elim_step(bool first, Mat<T>& P, Mat<T>& o_j,
                                       const Vec<T>& y_j,
                                       const Mat<T>& o_left, Carry<T>& st,
                                       Mat<T>& t, int d) {
  Vec<T> rv;
  if (!first) {
    mm_tb<T>(st.cprev, st.cprev, t, d);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k <= i; ++k) P[i][k] -= t[i][k];
  }
  const T ldl = chol<T>(P, st.D, st.invd, d);
  if (first) {
    solve_lower<T>(st.D, st.invd, o_left, st.w0, d);
    solve_lower_vec<T>(st.D, st.invd, y_j, st.w, d);
  } else {
    mm<T>(st.cprev, st.w0, t, d);
    solve_lower<T>(st.D, st.invd, t, st.w0, d);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k < d; ++k) st.w0[i][k] = -st.w0[i][k];
    mv_op<T, false>(st.cprev, st.w, rv, d);
    for (int i = 0; i < d; ++i) rv[i] = y_j[i] - rv[i];
    solve_lower_vec<T>(st.D, st.invd, rv, st.w, d);
  }
  // C_j = (D^{-1} O_j^T)^T
  transpose<T>(o_j, P, d);
  solve_lower<T>(st.D, st.invd, P, t, d);
  transpose<T>(t, st.cprev, d);

  mm_ta<T>(st.w0, st.w0, t, d);
  mv_op<T, true>(st.w0, st.w, rv, d);
  T ww = T(0);
  for (int i = 0; i < d; ++i) ww += st.w[i] * st.w[i];
  for (int i = 0; i < d; ++i) {
    for (int k = 0; k < d; ++k)
      st.acc[i][k] = first ? t[i][k] : st.acc[i][k] + t[i][k];
    st.accy0[i] = first ? rv[i] : st.accy0[i] + rv[i];
  }
  st.mh = first ? ww : st.mh + ww;
  st.ld = first ? ldl : st.ld + ldl;
  return ldl;
}

// the runtime block sizes the chunk-major kernels take
__host__ __device__ __forceinline__ bool rt_size(int d) {
  return d > 8 && d <= WMAX;
}

}  // namespace rt
}  // namespace cgt
