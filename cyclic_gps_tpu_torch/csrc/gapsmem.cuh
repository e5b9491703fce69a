// The LEG gap emission with the generator in shared memory
// (expm_pallas._tn_math and _pade7_vanloan): the helpers of the (e, Q)
// emission (kernel 2), the K-system emission (kernel 3) and the fused
// emission sweep (kernel 4), all in gap_emission.cu, and of the emission
// adjoint (kernel 5, gap_adjoint.cu).
//
// The generator's scaled blocks a = -G/2 * scale and sm = sym * scale are
// read from the thread block's shared copy of -G/2 and (G + G^T)/2 when a
// product needs them (all threads read the same address: a broadcast), so
// no thread holds the generator in its registers, and everything is
// inlined, so no kernel keeps a stack frame for it.  Van Loan's structured
// Pade-7 where dt ||G/2|| < 1 (Q without cancellation), the direct
// I - e e^T elsewhere; the scaling from the augmented norm, each gap
// squaring back exactly its own number of times (the TPU kernel masks
// every lane to a batch-wide count: the values are the same).
#pragma once

#include "blockmath.cuh"

namespace gsm {

// The generator as the block shares it: gh = -G/2 (exact: a power of two),
// sy = (G + G^T)/2, and the two norms every gap needs: ||-G/2||_inf (the
// branch) and the augmented Van Loan norm (the scaling).
template <int R>
struct GenS {
  float gh[R * R];
  float sy[R * R];
  float half;  // ||-G/2||_inf
  float augn;  // ||[[A, S], [0, -A^T]]||_inf
};

// Fill gs from the row-major [R, R] generator g: thread 0 does the whole of
// it (R^2 <= 64 numbers); the caller synchronises the block afterwards.
template <int R>
__device__ __forceinline__ void load_gen(const float* __restrict__ g,
                                         GenS<R>& gs) {
  if (threadIdx.x != 0) return;
  float half = 0.f, top = 0.f, col = 0.f;
  for (int i = 0; i < R; ++i) {
    float row_a = 0.f, row_as = 0.f, col_a = 0.f;
    for (int k = 0; k < R; ++k) {
      const float gik = g[i * R + k];
      const float sym = 0.5f * (gik + g[k * R + i]);
      gs.gh[i * R + k] = gik * (-0.5f);
      gs.sy[i * R + k] = sym;
      row_a += fabsf(-0.5f * gik);
      row_as += fabsf(-0.5f * gik) + fabsf(sym);
      col_a += fabsf(-0.5f * g[k * R + i]);
    }
    half = fmaxf(half, row_a);
    top = fmaxf(top, row_as);
    col = fmaxf(col, col_a);
  }
  gs.half = half;
  gs.augn = fmaxf(top, col);
}

// A gap's branch and scaling: the Van Loan branch
// where dt ||G/2|| < 1, and the squaring count from the augmented norm.
template <int R>
__device__ __forceinline__ bool van_loan(const GenS<R>& gs, float dt) {
  return dt * gs.half < 1.f;
}

template <int R>
__device__ __forceinline__ int rounds(const GenS<R>& gs, float dt) {
  float sc = ceilf(log2f(fmaxf(dt * gs.augn / CGT_THETA7, 1.f)));
  sc = fminf(fmaxf(sc, 0.f), float(CGT_MAXSQ));
  return int(sc);
}

// out = p * sc, a block of the shared generator scaled for one gap.  Read
// through a volatile pointer at every use, so the compiler does not keep
// the block in registers across the whole gap.
template <int R>
__device__ __forceinline__ void scaled(const volatile float* p, float sc,
                                       float (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] = p[i * R + k] * sc;
}

// out += sign * op(a) op(b), op transposing where TA / TB (each sum over p
// ascending, then added once)
template <int R, bool TA, bool TB>
__device__ __forceinline__ void mm_acc(const float (&a)[R][R],
                                       const float (&b)[R][R], float sign,
                                       float (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < R; ++p)
        acc += (TA ? a[p][i] : a[i][p]) * (TB ? b[k][p] : b[p][k]);
      out[i][k] += sign * acc;
    }
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) a[i][k] = 0.f;
}

// The polynomial half of the structured Pade-7 of the scaled Van Loan
// matrix up to its solves: p_a, p_s, v_tl, v_tr.
// keep(a2, s2, a4, s4) sees the even powers before they die.
struct NoKeep {
  template <typename M>
  __device__ __forceinline__ void operator()(const M&, const M&, const M&,
                                             const M&) const {}
};

template <int R, typename Keep>
__device__ __forceinline__ void pade_parts(const GenS<R>& gs, float scale,
                                           float (&p_a)[R][R],
                                           float (&p_s)[R][R],
                                           float (&v_tl)[R][R],
                                           float (&v_tr)[R][R], Keep keep) {
  float a2[R][R], s2[R][R], a4[R][R], s4[R][R];
  float t1[R][R], t2[R][R];
  {
    float a[R][R], sm[R][R];
    scaled<R>(gs.gh, scale, a);
    scaled<R>(gs.sy, scale, sm);
    cgt::mm<float, R>(a, a, a2);
    cgt::mm<float, R>(a, sm, t1);
    cgt::mm_tb<float, R>(sm, a, t2);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s2[i][k] = t1[i][k] - t2[i][k];
  cgt::mm<float, R>(a2, a2, a4);
  cgt::mm<float, R>(a2, s2, t1);
  cgt::mm_tb<float, R>(s2, a2, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s4[i][k] = t1[i][k] + t2[i][k];
  keep(a2, s2, a4, s4);
  float a6[R][R], s6[R][R];
  cgt::mm<float, R>(a2, a4, a6);
  cgt::mm<float, R>(a2, s4, t1);
  cgt::mm_tb<float, R>(s2, a4, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) s6[i][k] = t1[i][k] + t2[i][k];
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
}

// u_tl = a p_a, u_tr = a p_s + sm p_a^T; then, in place, v_tl <- nu =
// v_tl + u_tl, u_tl <- de = v_tl - u_tl, v_tr <- v_tr + u_tr and
// u_tr <- v_tr - u_tr
template <int R>
__device__ __forceinline__ void pade_sums(const GenS<R>& gs, float scale,
                                          const float (&p_a)[R][R],
                                          const float (&p_s)[R][R],
                                          float (&v_tl)[R][R],
                                          float (&v_tr)[R][R],
                                          float (&u_tl)[R][R],
                                          float (&u_tr)[R][R]) {
  float t1[R][R], t2[R][R];
  {
    float a[R][R];
    scaled<R>(gs.gh, scale, a);
    cgt::mm<float, R>(a, p_a, u_tl);
    cgt::mm<float, R>(a, p_s, t1);
  }
  {
    float sm[R][R];
    scaled<R>(gs.sy, scale, sm);
    cgt::mm_tb<float, R>(sm, p_a, t2);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      u_tr[i][k] = t1[i][k] + t2[i][k];
      const float nu = v_tl[i][k] + u_tl[i][k];
      const float de = v_tl[i][k] - u_tl[i][k];
      const float vpu = v_tr[i][k] + u_tr[i][k];
      const float vmu = v_tr[i][k] - u_tr[i][k];
      v_tl[i][k] = nu;
      u_tl[i][k] = de;
      v_tr[i][k] = vpu;
      u_tr[i][k] = vmu;
    }
}

// X = (V - U)^{-1} (V + U) = [[f1, g1], [0, f3]]: the bottom-right
// blocks of V -/+ U are nu^T / de^T, so f3 = nu^{-T} de^T
template <int R>
__device__ __forceinline__ void pade7(const GenS<R>& gs, float scale,
                                      float (&f1)[R][R], float (&g1)[R][R],
                                      float (&f3)[R][R]) {
  float nu[R][R], de[R][R], vpu[R][R], vmu[R][R];
  {
    float p_a[R][R], p_s[R][R];
    pade_parts<R>(gs, scale, p_a, p_s, nu, vpu, NoKeep{});
    pade_sums<R>(gs, scale, p_a, p_s, nu, vpu, de, vmu);
  }
  {
    float t1[R][R], t2[R][R];
    cgt::transpose<float, R>(nu, t1);
    cgt::transpose<float, R>(de, t2);
    cgt::lu_solve<float, R, R>(t1, t2, f3);
    cgt::mm<float, R>(vmu, f3, t2);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) vpu[i][k] -= t2[i][k];
  }
  float rhs[R][2 * R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      rhs[i][k] = nu[i][k];
      rhs[i][R + k] = vpu[i][k];
    }
  float x[R][2 * R];
  cgt::lu_solve<float, R, 2 * R>(de, rhs, x);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      f1[i][k] = x[i][k];
      g1[i][k] = x[i][R + k];
    }
}

// One squaring round back towards the true gap: f1
// always, the Van Loan blocks g1, f3 only in that branch.
template <int R>
__device__ __forceinline__ void square(bool vl, float (&f1)[R][R],
                                       float (&g1)[R][R], float (&f3)[R][R]) {
  float f1n[R][R];
  cgt::mm<float, R>(f1, f1, f1n);
  if (vl) {
    float t1[R][R], t2[R][R];
    cgt::mm<float, R>(f1, g1, t1);
    cgt::mm<float, R>(g1, f3, t2);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) g1[i][c] = t1[i][c] + t2[i][c];
    cgt::mm<float, R>(f3, f3, t1);
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

// Q1 from the squared blocks: sym(g1 f1^T) (Van Loan) or sym(I - f1 f1^T)
template <int R>
__device__ __forceinline__ void q_of(bool vl, const float (&f1)[R][R],
                                     const float (&g1)[R][R],
                                     float (&q)[R][R]) {
  float qq[R][R];
  if (vl) {
    cgt::mm_tb<float, R>(g1, f1, qq);
  } else {
    cgt::mm_tb<float, R>(f1, f1, qq);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) qq[i][c] = ((i == c) ? 1.f : 0.f) - qq[i][c];
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) q[i][c] = 0.5f * (qq[i][c] + qq[c][i]);
}

// One gap's precision ingredients (expm_pallas._gap_row_terms):
// off = -Q1^{-1} e, d_left = Q1^{-1} - I, d_right = e^T Q1^{-1} e, valid-
// masked by gv; returns log|Q1| (times gv).
template <int R>
__device__ __forceinline__ float row_terms(const GenS<R>& gs, float dt,
                                           float gv, float (&d_left)[R][R],
                                           float (&d_right)[R][R],
                                           float (&off)[R][R]) {
  const bool vl = van_loan<R>(gs, dt);
  const int nsq = rounds<R>(gs, dt);
  float e[R][R], q[R][R];
  {
    float g1[R][R], f3[R][R];
    pade7<R>(gs, ldexpf(dt, -nsq), e, g1, f3);
    for (int k = 0; k < nsq; ++k) square<R>(vl, e, g1, f3);
    q_of<R>(vl, e, g1, q);
  }
  float L[R][R], invd[R];
  const float ldl = cgt::chol<float, R>(q, L, invd);
  float t[R][R], qie[R][R];
  cgt::solve_lower<float, R, R>(L, invd, e, t);
  cgt::solve_lower_t<float, R, R>(L, invd, t, qie);  // Q1^{-1} e
  float eye[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) eye[i][k] = (i == k) ? 1.f : 0.f;
  cgt::solve_lower<float, R, R>(L, invd, eye, t);  // L^{-1}
  float li2[R][R];
  cgt::mm_ta<float, R>(t, t, li2);
  cgt::mm_ta<float, R>(e, qie, d_right);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      d_left[i][k] = (li2[i][k] - eye[i][k]) * gv;
      d_right[i][k] = d_right[i][k] * gv;
      off[i][k] = -qie[i][k] * gv;
    }
  return 2.f * ldl * gv;
}

}  // namespace gsm
