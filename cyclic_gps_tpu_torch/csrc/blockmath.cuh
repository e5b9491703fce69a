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
//   pade7_vanloan  expm_pallas._pade7_vanloan
//   tn_math        expm_pallas._tn_math (per-lane squaring count)
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
// Gap emission: e = expm(-dG/2), Q1 = I - e e^T (expm_pallas._tn_math).
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

// The generator and the two scalars every gap needs: the half-generator
// inf-norm (branch threshold) and the augmented Van Loan inf-norm
// (scaling), computed per thread from g -- no host round trip.
template <int R>
struct Generator {
  float g[R][R];
  float sym[R][R];  // (G + G^T) / 2
  float half;       // ||-G/2||_inf
  float augn;       // ||[[A, S], [0, -A^T]]||_inf
};

template <int R>
__device__ __forceinline__ void load_generator(const float* gp,
                                               Generator<R>& gen) {
  load_dense<float, R>(gp, gen.g);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k)
      gen.sym[i][k] = 0.5f * (gen.g[i][k] + gen.g[k][i]);
  float half = 0.f, top = 0.f, col = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float row_a = 0.f, row_as = 0.f, col_a = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      row_a += fabsf(-0.5f * gen.g[i][k]);
      row_as += fabsf(-0.5f * gen.g[i][k]) + fabsf(gen.sym[i][k]);
      col_a += fabsf(-0.5f * gen.g[k][i]);
    }
    half = fmaxf(half, row_a);
    top = fmaxf(top, row_as);
    col = fmaxf(col, col_a);
  }
  gen.half = half;
  gen.augn = fmaxf(top, col);
}

// Structured blockwise Pade-7 of the scaled Van Loan matrix
// M = [[a, sm], [0, -a^T]]: X = (V - U)^{-1} (V + U) = [[f1, g1], [0, f3]].
template <int R>
__device__ __forceinline__ void pade7_vanloan(const float (&a)[R][R],
                                              const float (&sm)[R][R],
                                              float (&f1)[R][R],
                                              float (&g1)[R][R],
                                              float (&f3)[R][R]) {
  float a2[R][R], s2[R][R], a4[R][R], s4[R][R], a6[R][R], s6[R][R];
  float t1[R][R], t2[R][R];
  mm<float, R>(a, a, a2);
  mm<float, R>(a, sm, t1);
  mm_tb<float, R>(sm, a, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s2[i][k] = t1[i][k] - t2[i][k];
  mm<float, R>(a2, a2, a4);
  mm<float, R>(a2, s2, t1);
  mm_tb<float, R>(s2, a2, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s4[i][k] = t1[i][k] + t2[i][k];
  mm<float, R>(a2, a4, a6);
  mm<float, R>(a2, s4, t1);
  mm_tb<float, R>(s2, a4, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s6[i][k] = t1[i][k] + t2[i][k];

  float p_a[R][R], p_s[R][R], v_tl[R][R], v_tr[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float id = (i == k) ? 1.f : 0.f;
      p_a[i][k] = CGT_PADE7_B7 * a6[i][k] + CGT_PADE7_B5 * a4[i][k] +
                  CGT_PADE7_B3 * a2[i][k] + CGT_PADE7_B1 * id;
      p_s[i][k] = CGT_PADE7_B7 * s6[i][k] + CGT_PADE7_B5 * s4[i][k] +
                  CGT_PADE7_B3 * s2[i][k];
      v_tl[i][k] = CGT_PADE7_B6 * a6[i][k] + CGT_PADE7_B4 * a4[i][k] +
                   CGT_PADE7_B2 * a2[i][k] + CGT_PADE7_B0 * id;
      v_tr[i][k] = CGT_PADE7_B6 * s6[i][k] + CGT_PADE7_B4 * s4[i][k] +
                   CGT_PADE7_B2 * s2[i][k];
    }
  // u_tl = a p_a ;  u_tr = a p_s + sm p_a^T
  float u_tl[R][R], u_tr[R][R];
  mm<float, R>(a, p_a, u_tl);
  mm<float, R>(a, p_s, t1);
  mm_tb<float, R>(sm, p_a, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) u_tr[i][k] = t1[i][k] + t2[i][k];

  float nu[R][R], de[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      nu[i][k] = v_tl[i][k] + u_tl[i][k];
      de[i][k] = v_tl[i][k] - u_tl[i][k];
    }
  // bottom-right blocks of V -/+ U are Nu^T / De^T: f3 = Nu^{-T} De^T
  transpose<float, R>(nu, t1);
  transpose<float, R>(de, t2);
  lu_solve<float, R, R>(t1, t2, f3);
  // rhs_g = (v_tr + u_tr) - (v_tr - u_tr) f3
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) t1[i][k] = v_tr[i][k] - u_tr[i][k];
  mm<float, R>(t1, f3, t2);
  float rhs[R][2 * R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      rhs[i][k] = nu[i][k];
      rhs[i][R + k] = (v_tr[i][k] + u_tr[i][k]) - t2[i][k];
    }
  float x[R][2 * R];
  lu_solve<float, R, 2 * R>(de, rhs, x);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      f1[i][k] = x[i][k];
      g1[i][k] = x[i][R + k];
    }
}

// dt -> (e, q) for one gap.  Van Loan branch (cancellation-free Q) where
// dt*||G/2|| < 1, direct I - e e^T elsewhere; scaling from the augmented
// norm; each lane squares back exactly its own number of times (the TPU
// kernel masks every lane to a batch-wide count: the values are the same).
// Not inlined: the three emission kernels share one compiled copy per R.
template <int R>
__device__ __noinline__ void tn_math(const Generator<R>& gen, float dt,
                                     float (&e)[R][R], float (&q)[R][R]) {
  const bool small = dt * gen.half < 1.f;
  float sc = ceilf(log2f(fmaxf(dt * gen.augn / CGT_THETA7, 1.f)));
  sc = fminf(fmaxf(sc, 0.f), float(CGT_MAXSQ));
  const int nsq = int(sc);
  const float scale = ldexpf(dt, -nsq);
  float a[R][R], sm[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      a[i][k] = gen.g[i][k] * (-0.5f) * scale;
      sm[i][k] = gen.sym[i][k] * scale;
    }
  float f1[R][R], g1[R][R], f3[R][R];
  pade7_vanloan<R>(a, sm, f1, g1, f3);

  // squaring back to the true gap: f1 on every lane, the Van Loan blocks
  // only in the cancellation regime (the growing f3 stays bounded)
  for (int k = 0; k < nsq; ++k) {
    float f1n[R][R];
    mm<float, R>(f1, f1, f1n);
    if (small) {
      float t1[R][R], t2[R][R];
      mm<float, R>(f1, g1, t1);
      mm<float, R>(g1, f3, t2);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) g1[i][c] = t1[i][c] + t2[i][c];
      mm<float, R>(f3, f3, t1);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) f3[i][c] = t1[i][c];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) f1[i][c] = f1n[i][c];
  }

  float qq[R][R];
  if (small) {
    mm_tb<float, R>(g1, f1, qq);
  } else {
    mm_tb<float, R>(f1, f1, qq);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) qq[i][c] = ((i == c) ? 1.f : 0.f) - qq[i][c];
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      q[i][c] = 0.5f * (qq[i][c] + qq[c][i]);
      e[i][c] = f1[i][c];
    }
}

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
