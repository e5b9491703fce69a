// Shared device functions of the package's kernels (forward_sweep.cu,
// gap_emission.cu, gap_adjoint.cu, backward_sweep.cu, solve_sweep.cu,
// inverse_sweep.cu): tiny-block algebra on R x R matrices held per thread.
//
// Every kernel of this package runs ONE THREAD PER LANE (a chunk c of the
// chunk-major layout, or one gap): the lane's blocks live in per-thread
// arrays, and R is a template constant so every block loop unrolls.  The
// math mirrors the JAX package's Pallas helpers one for one:
//
//   chol           pallas_sweep._chol (rsqrt pivots, NO pivot floor)
//   solve_lower    pallas_sweep._solve_lower
//   solve_lower_t  pallas_sweep._solve_lower_t
//   lu_solve       expm_pallas._lu_solve_k (unpivoted)
//   elim_step      pallas_sweep._sweep_kernel / expm_pallas._fused_elim_cell
//
// Layouts: chunk-major matrices [s, R, R, L] and vectors [s, R, L] with the
// lane axis L innermost, so neighbouring threads touch neighbouring
// addresses and every load and store coalesces.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cgt {

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// ---------------------------------------------------------------------------
// Global-memory addressing (lane axis innermost).
// ---------------------------------------------------------------------------

// element (a, b) of step j in a chunk-major [s, R, R, L] tensor, lane c
template <int R>
__device__ __forceinline__ size_t mat_at(int j, int a, int b, int L, int c) {
  return ((size_t(j) * R + a) * R + b) * size_t(L) + c;
}

// element a of step j in a chunk-major [s, R, L] tensor, lane c
template <int R>
__device__ __forceinline__ size_t vec_at(int j, int a, int L, int c) {
  return (size_t(j) * R + a) * size_t(L) + c;
}

template <typename T, int R>
__device__ __forceinline__ void load_mat(const T* p, int j, int L, int c,
                                         T (&m)[R][R]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) m[a][b] = p[mat_at<R>(j, a, b, L, c)];
}

template <typename T, int R>
__device__ __forceinline__ void store_mat(T* p, int j, int L, int c,
                                          const T (&m)[R][R]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) p[mat_at<R>(j, a, b, L, c)] = m[a][b];
}

template <typename T, int R>
__device__ __forceinline__ void load_vec(const T* p, int j, int L, int c,
                                         T (&v)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) v[a] = p[vec_at<R>(j, a, L, c)];
}

template <typename T, int R>
__device__ __forceinline__ void store_vec(T* p, int j, int L, int c,
                                          const T (&v)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) p[vec_at<R>(j, a, L, c)] = v[a];
}

// a dense row-major [R, R] matrix shared by all lanes (g, boost)
template <typename T, int R>
__device__ __forceinline__ void load_dense(const T* p, T (&m)[R][R]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) m[a][b] = p[a * R + b];
}

// ---------------------------------------------------------------------------
// Block products.  Each sums its k terms in ascending order, as the Pallas
// _mm helper does.  Every kernel that takes them is of rank 8 or less (the
// engine's rank-16 sweeps run one warp per chunk lane on rtcoop.cuh), so
// the loops unroll fully and the blocks stay in registers.
// ---------------------------------------------------------------------------

// out = op(a) op(b), op transposing where TA / TB
template <typename T, int R, bool TA, bool TB>
__device__ __forceinline__ void mm_op(const T (&a)[R][R], const T (&b)[R][R],
                                      T (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      T acc = (TA ? a[0][i] : a[i][0]) * (TB ? b[k][0] : b[0][k]);
#pragma unroll
      for (int p = 1; p < R; ++p)
        acc += (TA ? a[p][i] : a[i][p]) * (TB ? b[k][p] : b[p][k]);
      out[i][k] = acc;
    }
}

// out = a b
template <typename T, int R>
__device__ __forceinline__ void mm(const T (&a)[R][R], const T (&b)[R][R],
                                   T (&out)[R][R]) {
  mm_op<T, R, false, false>(a, b, out);
}

// out = a b^T
template <typename T, int R>
__device__ __forceinline__ void mm_tb(const T (&a)[R][R], const T (&b)[R][R],
                                      T (&out)[R][R]) {
  mm_op<T, R, false, true>(a, b, out);
}

// out = a^T b
template <typename T, int R>
__device__ __forceinline__ void mm_ta(const T (&a)[R][R], const T (&b)[R][R],
                                      T (&out)[R][R]) {
  mm_op<T, R, true, false>(a, b, out);
}

// out = a x
template <typename T, int R>
__device__ __forceinline__ void mv(const T (&a)[R][R], const T (&x)[R],
                                   T (&out)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T acc = a[i][0] * x[0];
#pragma unroll
    for (int p = 1; p < R; ++p) acc += a[i][p] * x[p];
    out[i] = acc;
  }
}

// out = a^T x
template <typename T, int R>
__device__ __forceinline__ void mv_ta(const T (&a)[R][R], const T (&x)[R],
                                      T (&out)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T acc = a[0][i] * x[0];
#pragma unroll
    for (int p = 1; p < R; ++p) acc += a[p][i] * x[p];
    out[i] = acc;
  }
}

template <typename T, int R>
__device__ __forceinline__ void transpose(const T (&a)[R][R], T (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] = a[k][i];
}

// ---------------------------------------------------------------------------
// Cholesky and triangular solves (pallas_sweep._chol and friends).
// ---------------------------------------------------------------------------

// Lower Cholesky of the SPD block a (only its lower triangle is read):
// L, inv_diag = 1/L_jj, and the half log-determinant sum_j log L_jj.
// Pivots are taken as they come (rsqrt, no floor), as in the TPU kernels.
template <typename T, int R>
__device__ __forceinline__ T chol(const T (&a)[R][R], T (&L)[R][R],
                                  T (&invd)[R]) {
  T x[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) x[i][k] = a[i][k];
  T ld = T(0);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const T piv = x[j][j];
    const T pinv = rsqrt_(piv);
    invd[j] = pinv;
    ld += T(0.5) * log_(piv);
#pragma unroll
    for (int i = 0; i < R; ++i) L[i][j] = (i >= j) ? x[i][j] * pinv : T(0);
    // rank-1 downdate of the trailing lower triangle
#pragma unroll
    for (int i = j + 1; i < R; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) x[i][k] -= L[i][j] * L[k][j];
  }
  return ld;
}

// L X = Y, matrix right-hand side
template <typename T, int R, int E>
__device__ __forceinline__ void solve_lower(const T (&L)[R][R],
                                            const T (&invd)[R],
                                            const T (&y)[R][E],
                                            T (&x)[R][E]) {
  T res[R][E];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) res[i][e] = y[i][e];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x[i][e] = res[i][e] * invd[i];
#pragma unroll
      for (int k = i + 1; k < R; ++k) res[k][e] -= L[k][i] * x[i][e];
    }
}

// L x = y, vector right-hand side
template <typename T, int R>
__device__ __forceinline__ void solve_lower_vec(const T (&L)[R][R],
                                                const T (&invd)[R],
                                                const T (&y)[R], T (&x)[R]) {
  T res[R];
#pragma unroll
  for (int i = 0; i < R; ++i) res[i] = y[i];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    x[i] = res[i] * invd[i];
#pragma unroll
    for (int k = i + 1; k < R; ++k) res[k] -= L[k][i] * x[i];
  }
}

// L^T X = Y (back substitution), matrix right-hand side
template <typename T, int R, int E>
__device__ __forceinline__ void solve_lower_t(const T (&L)[R][R],
                                              const T (&invd)[R],
                                              const T (&y)[R][E],
                                              T (&x)[R][E]) {
  T res[R][E];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) res[i][e] = y[i][e];
#pragma unroll
  for (int i = R - 1; i >= 0; --i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x[i][e] = res[i][e] * invd[i];
#pragma unroll
      for (int k = 0; k < i; ++k) res[k][e] -= L[i][k] * x[i][e];
    }
}

// L^T x = y (back substitution), vector right-hand side
template <typename T, int R>
__device__ __forceinline__ void solve_lower_t_vec(const T (&L)[R][R],
                                                  const T (&invd)[R],
                                                  const T (&y)[R], T (&x)[R]) {
  T res[R];
#pragma unroll
  for (int i = 0; i < R; ++i) res[i] = y[i];
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    x[i] = res[i] * invd[i];
#pragma unroll
    for (int k = 0; k < i; ++k) res[k] -= L[i][k] * x[i];
  }
}

// A X = B by unpivoted Gaussian elimination (expm_pallas._lu_solve_k): for
// the Pade denominator, well conditioned by construction.
template <typename T, int R, int E>
__device__ __forceinline__ void lu_solve(const T (&a)[R][R], const T (&b)[R][E],
                                         T (&x)[R][E]) {
  T m[R][R];
  T rhs[R][E];
  T pinv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = a[i][k];
#pragma unroll
    for (int e = 0; e < E; ++e) rhs[i][e] = b[i][e];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    pinv[j] = T(1) / m[j][j];
#pragma unroll
    for (int i = j + 1; i < R; ++i) {
      const T f = m[i][j] * pinv[j];
#pragma unroll
      for (int k = j + 1; k < R; ++k) m[i][k] -= f * m[j][k];
#pragma unroll
      for (int e = 0; e < E; ++e) rhs[i][e] -= f * rhs[j][e];
    }
  }
#pragma unroll
  for (int i = R - 1; i >= 0; --i)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      T acc = rhs[i][e];
#pragma unroll
      for (int k = i + 1; k < R; ++k) acc -= m[i][k] * x[k][e];
      x[i][e] = acc * pinv[i];
    }
}

// ---------------------------------------------------------------------------
// Gap emission constants (the emission itself is gapsmem.cuh's).
// ---------------------------------------------------------------------------

// degree-7 diagonal Pade coefficients of exp
#define CGT_PADE7_B0 17297280.0f
#define CGT_PADE7_B1 8648640.0f
#define CGT_PADE7_B2 1995840.0f
#define CGT_PADE7_B3 277200.0f
#define CGT_PADE7_B4 25200.0f
#define CGT_PADE7_B5 1512.0f
#define CGT_PADE7_B6 56.0f
#define CGT_PADE7_B7 1.0f
// single-precision Pade-7 accuracy radius and the squaring cap
#define CGT_THETA7 3.92f
#define CGT_MAXSQ 40

// ---------------------------------------------------------------------------
// One step of the chunk-interior elimination (pallas_sweep._sweep_kernel).
// ---------------------------------------------------------------------------

template <typename T, int R>
struct SweepCarry {
  T cprev[R][R];  // C_j = O_j D_j^{-T}
  T w0[R][R];     // W0_j
  T w[R];         // w_j
  T D[R][R];      // D_j
  T invd[R];
  T acc00[R][R];  // sum W0^T W0
  T accy0[R];     // sum W0^T w
  T mh;           // sum ||w||^2 (this lane)
  T ld;           // sum log diag D (this lane)
};

// Eliminate one row given its pivot block P (jitter already added), its
// right coupling o_j and right-hand side y_j.  ``first`` marks the first
// interior row: W0 is seeded from the left-boundary coupling o_left.
// Returns the row's half log-determinant.
template <typename T, int R>
__device__ __forceinline__ T elim_step(bool first, const T (&p_in)[R][R],
                                       const T (&o_j)[R][R], const T (&y_j)[R],
                                       const T (&o_left)[R][R],
                                       SweepCarry<T, R>& st) {
  T P[R][R];
  T t[R][R];
  if (first) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) P[i][k] = p_in[i][k];
  } else {
    mm_tb<T, R>(st.cprev, st.cprev, t);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) P[i][k] = p_in[i][k] - t[i][k];
  }
  const T ldl = chol<T, R>(P, st.D, st.invd);
  T rv[R];
  if (first) {
    solve_lower<T, R, R>(st.D, st.invd, o_left, st.w0);
    solve_lower_vec<T, R>(st.D, st.invd, y_j, st.w);
  } else {
    mm<T, R>(st.cprev, st.w0, t);
    T w0n[R][R];
    solve_lower<T, R, R>(st.D, st.invd, t, w0n);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) st.w0[i][k] = -w0n[i][k];
    mv<T, R>(st.cprev, st.w, rv);
#pragma unroll
    for (int i = 0; i < R; ++i) rv[i] = y_j[i] - rv[i];
    solve_lower_vec<T, R>(st.D, st.invd, rv, st.w);
  }
  // C_j = (D^{-1} O_j^T)^T
  T ot[R][R];
  transpose<T, R>(o_j, ot);
  solve_lower<T, R, R>(st.D, st.invd, ot, t);
  transpose<T, R>(t, st.cprev);

  mm_ta<T, R>(st.w0, st.w0, t);
  mv_ta<T, R>(st.w0, st.w, rv);
  T ww = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) ww += st.w[i] * st.w[i];
  if (first) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < R; ++k) st.acc00[i][k] = t[i][k];
      st.accy0[i] = rv[i];
    }
    st.mh = ww;
    st.ld = ldl;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < R; ++k) st.acc00[i][k] += t[i][k];
      st.accy0[i] += rv[i];
    }
    st.mh += ww;
    st.ld += ldl;
  }
  return ldl;
}

// Write the lane's final sweep state (shared by the two sweep kernels).
template <typename T, int R>
__device__ __forceinline__ void store_sweep_state(
    const SweepCarry<T, R>& st, int C, int c, T* acc00, T* accy0, T* w0l,
    T* wl, T* dl, T* invdl, T* mh, T* ld) {
  store_mat<T, R>(acc00, 0, C, c, st.acc00);
  store_vec<T, R>(accy0, 0, C, c, st.accy0);
  store_mat<T, R>(w0l, 0, C, c, st.w0);
  store_vec<T, R>(wl, 0, C, c, st.w);
  store_mat<T, R>(dl, 0, C, c, st.D);
  store_vec<T, R>(invdl, 0, C, c, st.invd);
  mh[c] = st.mh;
  ld[c] = st.ld;
}

}  // namespace cgt

// Launch helper: instantiate a kernel launcher for ranks 1..8 and return
// the launch error (cudaErrorInvalidValue for any other rank; the Python
// wrappers refuse such ranks before they get here).
#define CGT_RANK_SWITCH(r, CALL) \
  switch (r) {                   \
    case 1: CALL(1); break;      \
    case 2: CALL(2); break;      \
    case 3: CALL(3); break;      \
    case 4: CALL(4); break;      \
    case 5: CALL(5); break;      \
    case 6: CALL(6); break;      \
    case 7: CALL(7); break;      \
    case 8: CALL(8); break;      \
    default: return int(cudaErrorInvalidValue); \
  }

#define CGT_THREADS 128
