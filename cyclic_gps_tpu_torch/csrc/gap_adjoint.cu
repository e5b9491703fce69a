// Analytic adjoint of the LEG gap emission: per-gap cotangents of the
// K-system ingredients -> the generator gradient and the per-gap dt
// cotangent, the backward of k_system_kernel (gap_emission.cu).
//
// Replaces: cyclic_gps_tpu/ops/expm_pallas.py:1046 k_system_adjoint_pallas
// (kernel body _ksys_adj_kernel, :1007, and its cell _tn_adj_cell, :891).
//
// Per gap (dt, gv) with cotangents (c_off, c_dl, c_dr, c_lq):
//   1. recompute the forward of tn_math -- the structured Pade-7 of the
//      scaled Van Loan matrix, then the squaring rounds -- keeping every
//      Pade intermediate and every round's input state;
//   2. q1-terms adjoint: solves against chol(Q1) map the cotangents of
//      off = -Q1^{-1} e, d_left = Q1^{-1} - I, d_right = e^T Q1^{-1} e and
//      log|Q1| to (c_e, c_Q);
//   3. reverse the squaring rounds, then the Pade-7 adjoint, giving the
//      cotangents of the scaled blocks (c_a, c_sm) and so c_G, c_sym, c_dt.
// ceil/clip of the scaling count have zero derivative almost everywhere, as
// in the JAX package, whose custom VJP this is.
//
// What bounds it on the H100: arithmetic and local memory, not device
// memory.  A rank-5 gap reads 3 R^2 + 3 floats and writes one, but costs
// ~60 R x R products, three LU solves and a Cholesky, with ~15 R x R saved
// Pade blocks and up to 40 + 2 * 8 stored squaring rounds live per thread:
// far more than 255 registers hold, so the saved state sits in local memory
// (L1/L2) and the kernel is latency-bound on it.
//
// What the simple design does about it: one thread per gap (s * C threads,
// ~1e6 at N = 1e6, so the card is full); each thread stores only the rounds
// its own gap runs (no batch-wide masked maximum), and only Van Loan-regime
// gaps store and reverse the G1/F3 rounds.  The round stacks are sized from
// the proofs the TPU kernel relies on: the forward clips the count at
// CGT_MAXSQ = 40, and a Van Loan-regime gap needs at most
// ceil(log2((2 + R) / theta_7)) <= 8 rounds (expm_pallas.py:360-392,
// :886-888).  The generator gradient is reduced per thread block in shared
// memory (warp shuffles in a fixed order, no float atomics) into one partial
// per block, which the wrapper sums: the result is deterministic.
#include "blockmath.cuh"

namespace {

using cgt::Generator;

#define CGT_NSQ_VL 8

// out += sign * op(a) op(b), op transposing where TA / TB
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

template <int R>
__device__ __forceinline__ void copy(const float (&a)[R][R],
                                     float (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] = a[i][k];
}

// Everything the Pade-7 adjoint reads (expm_pallas._pade7_vanloan_fwd).
template <int R>
struct Pade7Saved {
  float a[R][R], sm[R][R], a2[R][R], s2[R][R], a4[R][R], s4[R][R];
  float p_a[R][R], p_s[R][R], v_tr[R][R], u_tr[R][R], nu[R][R], de[R][R];
  float f3[R][R];
  float x[R][2 * R];  // de^{-1} [nu | rhs_g] = [f1 | g1]
};

// cgt::pade7_vanloan keeping its intermediates.
template <int R>
__device__ __forceinline__ void pade7_fwd(Pade7Saved<R>& sv,
                                          float (&f1)[R][R],
                                          float (&g1)[R][R],
                                          float (&f3)[R][R]) {
  float a6[R][R], s6[R][R];
  zero<R>(sv.a2);
  mm_acc<R, false, false>(sv.a, sv.a, 1.f, sv.a2);
  zero<R>(sv.s2);
  mm_acc<R, false, false>(sv.a, sv.sm, 1.f, sv.s2);
  mm_acc<R, false, true>(sv.sm, sv.a, -1.f, sv.s2);
  zero<R>(sv.a4);
  mm_acc<R, false, false>(sv.a2, sv.a2, 1.f, sv.a4);
  zero<R>(sv.s4);
  mm_acc<R, false, false>(sv.a2, sv.s2, 1.f, sv.s4);
  mm_acc<R, false, true>(sv.s2, sv.a2, 1.f, sv.s4);
  zero<R>(a6);
  mm_acc<R, false, false>(sv.a2, sv.a4, 1.f, a6);
  zero<R>(s6);
  mm_acc<R, false, false>(sv.a2, sv.s4, 1.f, s6);
  mm_acc<R, false, true>(sv.s2, sv.a4, 1.f, s6);

  float v_tl[R][R], u_tl[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float id = (i == k) ? 1.f : 0.f;
      sv.p_a[i][k] = CGT_PADE7_B7 * a6[i][k] + CGT_PADE7_B5 * sv.a4[i][k] +
                     CGT_PADE7_B3 * sv.a2[i][k] + CGT_PADE7_B1 * id;
      sv.p_s[i][k] = CGT_PADE7_B7 * s6[i][k] + CGT_PADE7_B5 * sv.s4[i][k] +
                     CGT_PADE7_B3 * sv.s2[i][k];
      v_tl[i][k] = CGT_PADE7_B6 * a6[i][k] + CGT_PADE7_B4 * sv.a4[i][k] +
                   CGT_PADE7_B2 * sv.a2[i][k] + CGT_PADE7_B0 * id;
      sv.v_tr[i][k] = CGT_PADE7_B6 * s6[i][k] + CGT_PADE7_B4 * sv.s4[i][k] +
                      CGT_PADE7_B2 * sv.s2[i][k];
    }
  zero<R>(u_tl);
  mm_acc<R, false, false>(sv.a, sv.p_a, 1.f, u_tl);
  zero<R>(sv.u_tr);
  mm_acc<R, false, false>(sv.a, sv.p_s, 1.f, sv.u_tr);
  mm_acc<R, false, true>(sv.sm, sv.p_a, 1.f, sv.u_tr);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      sv.nu[i][k] = v_tl[i][k] + u_tl[i][k];
      sv.de[i][k] = v_tl[i][k] - u_tl[i][k];
    }
  // f3 = Nu^{-T} De^T
  float nut[R][R], det[R][R];
  cgt::transpose<float, R>(sv.nu, nut);
  cgt::transpose<float, R>(sv.de, det);
  cgt::lu_solve<float, R, R>(nut, det, sv.f3);
  // rhs_g = (v_tr + u_tr) - (v_tr - u_tr) f3
  float vmu[R][R], t[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) vmu[i][k] = sv.v_tr[i][k] - sv.u_tr[i][k];
  zero<R>(t);
  mm_acc<R, false, false>(vmu, sv.f3, 1.f, t);
  float rhs[R][2 * R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      rhs[i][k] = sv.nu[i][k];
      rhs[i][R + k] = (sv.v_tr[i][k] + sv.u_tr[i][k]) - t[i][k];
    }
  cgt::lu_solve<float, R, 2 * R>(sv.de, rhs, sv.x);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      f1[i][k] = sv.x[i][k];
      g1[i][k] = sv.x[i][R + k];
      f3[i][k] = sv.f3[i][k];
    }
}

// Hand-written adjoint of the Pade-7 (expm_pallas._pade7_vanloan_bwd):
// (c_f1, c_g1, c_f3) -> (c_a, c_sm).  Solve adjoints follow X = A^{-1} B:
// c_B = A^{-T} c_X, c_A = -c_B X^T; the product chain reverses term by term.
template <int R>
__device__ __forceinline__ void pade7_bwd(const Pade7Saved<R>& sv,
                                          const float (&c_f1)[R][R],
                                          const float (&c_g1)[R][R],
                                          const float (&c_f3_in)[R][R],
                                          float (&c_a)[R][R],
                                          float (&c_sm)[R][R]) {
  // x = de^{-1} [nu | rhs_g]
  float det[R][R], cx[R][2 * R], cb2[R][2 * R];
  cgt::transpose<float, R>(sv.de, det);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      cx[i][k] = c_f1[i][k];
      cx[i][R + k] = c_g1[i][k];
    }
  cgt::lu_solve<float, R, 2 * R>(det, cx, cb2);
  float c_de[R][R], c_nu[R][R], c_rhsg[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < 2 * R; ++p) acc += cb2[i][p] * sv.x[k][p];
      c_de[i][k] = -acc;
      c_nu[i][k] = cb2[i][k];
      c_rhsg[i][k] = cb2[i][R + k];
    }

  // rhs_g = (v_tr + u_tr) - (v_tr - u_tr) f3
  float c_m[R][R], c_vtr[R][R], c_utr[R][R], c_f3[R][R], vmu[R][R];
  zero<R>(c_m);
  mm_acc<R, false, true>(c_rhsg, sv.f3, -1.f, c_m);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_vtr[i][k] = c_rhsg[i][k] + c_m[i][k];
      c_utr[i][k] = c_rhsg[i][k] - c_m[i][k];
      vmu[i][k] = sv.v_tr[i][k] - sv.u_tr[i][k];
    }
  copy<R>(c_f3_in, c_f3);
  mm_acc<R, true, false>(vmu, c_rhsg, -1.f, c_f3);

  // f3 = nu^{-T} de^T
  float c_bw[R][R], t[R][R];
  cgt::lu_solve<float, R, R>(sv.nu, c_f3, c_bw);
  zero<R>(t);
  mm_acc<R, false, true>(c_bw, sv.f3, 1.f, t);
  float c_vtl[R][R], c_utl[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_de[i][k] += c_bw[k][i];
      c_nu[i][k] -= t[k][i];
    }
  // nu = v_tl + u_tl, de = v_tl - u_tl
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_vtl[i][k] = c_nu[i][k] + c_de[i][k];
      c_utl[i][k] = c_nu[i][k] - c_de[i][k];
    }

  // u_tl = a p_a;  u_tr = a p_s + sm p_a^T
  float c_pa[R][R], c_ps[R][R];
  zero<R>(c_a);
  mm_acc<R, false, true>(c_utl, sv.p_a, 1.f, c_a);
  mm_acc<R, false, true>(c_utr, sv.p_s, 1.f, c_a);
  zero<R>(c_pa);
  mm_acc<R, true, false>(sv.a, c_utl, 1.f, c_pa);
  mm_acc<R, true, false>(c_utr, sv.sm, 1.f, c_pa);
  zero<R>(c_ps);
  mm_acc<R, true, false>(sv.a, c_utr, 1.f, c_ps);
  zero<R>(c_sm);
  mm_acc<R, false, false>(c_utr, sv.p_a, 1.f, c_sm);

  // polynomial coefficients
  float c_a6[R][R], c_a4[R][R], c_a2[R][R], c_s6[R][R], c_s4[R][R],
      c_s2[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_a6[i][k] = CGT_PADE7_B7 * c_pa[i][k] + CGT_PADE7_B6 * c_vtl[i][k];
      c_a4[i][k] = CGT_PADE7_B5 * c_pa[i][k] + CGT_PADE7_B4 * c_vtl[i][k];
      c_a2[i][k] = CGT_PADE7_B3 * c_pa[i][k] + CGT_PADE7_B2 * c_vtl[i][k];
      c_s6[i][k] = CGT_PADE7_B7 * c_ps[i][k] + CGT_PADE7_B6 * c_vtr[i][k];
      c_s4[i][k] = CGT_PADE7_B5 * c_ps[i][k] + CGT_PADE7_B4 * c_vtr[i][k];
      c_s2[i][k] = CGT_PADE7_B3 * c_ps[i][k] + CGT_PADE7_B2 * c_vtr[i][k];
    }
  // s6 = a2 s4 + s2 a4^T
  mm_acc<R, false, true>(c_s6, sv.s4, 1.f, c_a2);
  mm_acc<R, true, false>(sv.a2, c_s6, 1.f, c_s4);
  mm_acc<R, false, false>(c_s6, sv.a4, 1.f, c_s2);
  mm_acc<R, true, false>(c_s6, sv.s2, 1.f, c_a4);
  // a6 = a2 a4
  mm_acc<R, false, true>(c_a6, sv.a4, 1.f, c_a2);
  mm_acc<R, true, false>(sv.a2, c_a6, 1.f, c_a4);
  // s4 = a2 s2 + s2 a2^T
  mm_acc<R, false, true>(c_s4, sv.s2, 1.f, c_a2);
  mm_acc<R, true, false>(c_s4, sv.s2, 1.f, c_a2);
  mm_acc<R, true, false>(sv.a2, c_s4, 1.f, c_s2);
  mm_acc<R, false, false>(c_s4, sv.a2, 1.f, c_s2);
  // a4 = a2 a2
  mm_acc<R, false, true>(c_a4, sv.a2, 1.f, c_a2);
  mm_acc<R, true, false>(sv.a2, c_a4, 1.f, c_a2);
  // s2 = a sm - sm a^T
  mm_acc<R, false, true>(c_s2, sv.sm, 1.f, c_a);
  mm_acc<R, true, false>(c_s2, sv.sm, -1.f, c_a);
  mm_acc<R, true, false>(sv.a, c_s2, 1.f, c_sm);
  mm_acc<R, false, false>(c_s2, sv.a, -1.f, c_sm);
  // a2 = a a
  mm_acc<R, false, true>(c_a2, sv.a, 1.f, c_a);
  mm_acc<R, true, false>(sv.a, c_a2, 1.f, c_a);
}

// Q1^{-1} x through the Cholesky L of Q1
template <int R>
__device__ __forceinline__ void msolve(const float (&L)[R][R],
                                       const float (&invd)[R],
                                       const float (&x)[R][R],
                                       float (&out)[R][R]) {
  float t[R][R];
  cgt::solve_lower<float, R, R>(L, invd, x, t);
  cgt::solve_lower_t<float, R, R>(L, invd, t, out);
}

// One gap's adjoint (expm_pallas._tn_adj_cell for one lane).  The
// cotangents arrive unmasked and are masked by gv here; returns c_dt and
// the gap's contributions c_g = dL/dG (through a = -G/2 * scale) and
// c_sym = dL/dsym (through sm = sym * scale).  Not inlined: one compiled
// copy per rank.
template <int R>
__device__ __noinline__ float tn_adjoint(const Generator<R>& gen, float dt,
                                         float gv, float (&co)[R][R],
                                         float (&cdl)[R][R],
                                         float (&cdr)[R][R], float clq,
                                         float (&c_g)[R][R],
                                         float (&c_sym)[R][R]) {
  // ---- forward recompute, storing the squaring rounds' inputs ----
  const bool small = dt * gen.half < 1.f;
  float sc = ceilf(log2f(fmaxf(dt * gen.augn / CGT_THETA7, 1.f)));
  sc = fminf(fmaxf(sc, 0.f), float(CGT_MAXSQ));
  const int nsq = int(sc);
  const float scale = ldexpf(dt, -nsq);
  Pade7Saved<R> sv;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      sv.a[i][k] = gen.g[i][k] * (-0.5f) * scale;
      sv.sm[i][k] = gen.sym[i][k] * scale;
    }
  float f1[R][R], g1[R][R], f3[R][R];
  pade7_fwd<R>(sv, f1, g1, f3);

  float f1s[CGT_MAXSQ][R][R];
  float g1s[CGT_NSQ_VL][R][R], f3s[CGT_NSQ_VL][R][R];
  for (int k = 0; k < nsq; ++k) {
    copy<R>(f1, f1s[k]);
    float t[R][R];
    if (small) {
      if (k < CGT_NSQ_VL) {
        copy<R>(g1, g1s[k]);
        copy<R>(f3, f3s[k]);
      }
      zero<R>(t);
      mm_acc<R, false, false>(f1, g1, 1.f, t);
      mm_acc<R, false, false>(g1, f3, 1.f, t);
      copy<R>(t, g1);
      zero<R>(t);
      mm_acc<R, false, false>(f3, f3, 1.f, t);
      copy<R>(t, f3);
    }
    zero<R>(t);
    mm_acc<R, false, false>(f1, f1, 1.f, t);
    copy<R>(t, f1);
  }
  float q[R][R], qq[R][R];
  zero<R>(qq);
  if (small) {
    mm_acc<R, false, true>(g1, f1, 1.f, qq);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) qq[i][i] = 1.f;
    mm_acc<R, false, true>(f1, f1, -1.f, qq);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) q[i][k] = 0.5f * (qq[i][k] + qq[k][i]);

  // ---- q1-terms adjoint: (c_off, c_dl, c_dr, c_lq) -> (c_e, c_q) ----
  float L[R][R], invd[R];
  cgt::chol<float, R>(q, L, invd);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      co[i][k] *= gv;
      cdl[i][k] *= gv;
      cdr[i][k] *= gv;
    }
  clq *= gv;
  float q1ie[R][R], c_m[R][R], t[R][R], t2[R][R];
  msolve<R>(L, invd, f1, q1ie);  // e = f1
  // off = -M e, d_left = M - I, d_right = e^T M e, lq = log|Q1|
  zero<R>(t);
  mm_acc<R, false, false>(f1, cdr, 1.f, t);
  copy<R>(cdl, c_m);
  mm_acc<R, false, true>(t, f1, 1.f, c_m);
  mm_acc<R, false, true>(co, f1, -1.f, c_m);
  float c_q[R][R], c_e[R][R], eye[R][R];
  msolve<R>(L, invd, c_m, t);
  cgt::transpose<float, R>(t, t2);
  msolve<R>(L, invd, t2, t);  // c_q = -M c_m M
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_q[i][k] = -t[k][i];
      eye[i][k] = (i == k) ? 1.f : 0.f;
    }
  msolve<R>(L, invd, eye, t);  // d log|Q1| = tr(Q1^{-1} dQ1)
  msolve<R>(L, invd, co, t2);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_q[i][k] += clq * t[i][k];
      c_e[i][k] = -t2[i][k];
      t[i][k] = cdr[i][k] + cdr[k][i];
    }
  mm_acc<R, false, false>(q1ie, t, 1.f, c_e);

  // ---- q-branch adjoint ----
  float c_qs[R][R], cf1[R][R], cg1[R][R], cf3[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) c_qs[i][k] = 0.5f * (c_q[i][k] + c_q[k][i]);
  copy<R>(c_e, cf1);
  zero<R>(cg1);
  zero<R>(cf3);
  if (small) {
    mm_acc<R, false, false>(c_qs, f1, 1.f, cg1);
    mm_acc<R, true, false>(c_qs, g1, 1.f, cf1);
  } else {
    mm_acc<R, false, false>(c_qs, f1, -1.f, cf1);
    mm_acc<R, true, false>(c_qs, f1, -1.f, cf1);
  }

  // ---- reverse squaring: f1' = f1^2 ; g1' = f1 g1 + g1 f3 ; f3' = f3^2 ----
  for (int k = nsq - 1; k >= 0; --k) {
    float n1[R][R];
    zero<R>(n1);
    mm_acc<R, false, true>(cf1, f1s[k], 1.f, n1);
    mm_acc<R, true, false>(f1s[k], cf1, 1.f, n1);
    if (small) {
      const int kc = k < CGT_NSQ_VL ? k : CGT_NSQ_VL - 1;
      float n3[R][R];
      mm_acc<R, false, true>(cg1, g1s[kc], 1.f, n1);
      zero<R>(n3);
      mm_acc<R, true, false>(g1s[kc], cg1, 1.f, n3);
      mm_acc<R, false, true>(cf3, f3s[kc], 1.f, n3);
      mm_acc<R, true, false>(f3s[kc], cf3, 1.f, n3);
      zero<R>(t);
      mm_acc<R, true, false>(f1s[k], cg1, 1.f, t);
      mm_acc<R, false, true>(cg1, f3s[kc], 1.f, t);
      copy<R>(t, cg1);
      copy<R>(n3, cf3);
    }
    copy<R>(n1, cf1);
  }

  // ---- Pade-7 adjoint -> scaled-block cotangents ----
  float c_a[R][R], c_sm[R][R];
  pade7_bwd<R>(sv, cf1, cg1, cf3, c_a, c_sm);
  float c_scale = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      c_scale +=
          c_a[i][k] * (gen.g[i][k] * -0.5f) + c_sm[i][k] * gen.sym[i][k];
      c_g[i][k] = c_a[i][k] * (-0.5f) * scale;
      c_sym[i][k] = c_sm[i][k] * scale;
    }
  return ldexpf(c_scale, -nsq) * gv;
}

// Sum of v over the warp, in lane 0 (every lane must call).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One thread per gap m = j * C + c of the chunk-major [s, C] grid.
template <int R>
__global__ void __launch_bounds__(CGT_THREADS)
k_system_adjoint_kernel(const float* __restrict__ g,
                        const float* __restrict__ dt,
                        const float* __restrict__ gv,
                        const float* __restrict__ coff,
                        const float* __restrict__ cdl,
                        const float* __restrict__ cdr,
                        const float* __restrict__ clq, int s, int C,
                        float* cdt_out, float* cg_part, float* csym_part) {
  __shared__ float red[CGT_THREADS / 32][2 * R * R];
  const int M = s * C;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  float c_g[R][R], c_sym[R][R];
  if (m < M) {
    Generator<R> gen;
    cgt::load_generator<R>(g, gen);
    const int j = m / C;
    const int c = m - j * C;
    float co[R][R], cl[R][R], cr[R][R];
    cgt::load_mat<float, R>(coff, j, C, c, co);
    cgt::load_mat<float, R>(cdl, j, C, c, cl);
    cgt::load_mat<float, R>(cdr, j, C, c, cr);
    cdt_out[m] = tn_adjoint<R>(gen, dt[m], gv[m], co, cl, cr, clq[m], c_g,
                               c_sym);
  } else {
    zero<R>(c_g);
    zero<R>(c_sym);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float a = warp_sum(c_g[i][k]);
      const float b = warp_sum(c_sym[i][k]);
      if (lane == 0) {
        red[warp][i * R + k] = a;
        red[warp][R * R + i * R + k] = b;
      }
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * R * R; e += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < CGT_THREADS / 32; ++w) acc += red[w][e];
    float* out = e < R * R ? cg_part : csym_part;
    out[size_t(blockIdx.x) * R * R + (e % (R * R))] = acc;
  }
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

}  // namespace

extern "C" {

int cgt_k_system_adjoint_f32(const float* g, const float* dt,
                             const float* gv, const float* coff,
                             const float* cdl, const float* cdr,
                             const float* clq, int r, int s, int C,
                             float* cdt, float* cg_part, float* csym_part,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                      \
  k_system_adjoint_kernel<RR><<<blocks_for(s * C), CGT_THREADS, 0, st>>>(   \
      g, dt, gv, coff, cdl, cdr, clq, s, C, cdt, cg_part, csym_part)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // extern "C"
