// Analytic adjoint of the LEG gap emission: per-gap cotangents of the
// K-system ingredients -> the generator gradient and the per-gap dt
// cotangent, the backward of k_system_tiled_kernel (gap_emission.cu).
//
// Replaces: cyclic_gps_tpu/ops/expm_pallas.py:1046 k_system_adjoint_pallas
// (kernel body _ksys_adj_kernel, :1007, and its cell _tn_adj_cell, :891).
//
// Per gap (dt, gv) with cotangents (c_off, c_dl, c_dr, c_lq):
//   1. recompute the forward -- the structured Pade-7 of the scaled Van
//      Loan matrix, then the squaring rounds -- keeping the Pade output and
//      the first squaring rounds' inputs;
//   2. q1-terms adjoint: solves against chol(Q1) map the cotangents of
//      off = -Q1^{-1} e, d_left = Q1^{-1} - I, d_right = e^T Q1^{-1} e and
//      log|Q1| to (c_e, c_Q);
//   3. reverse the squaring rounds, then the Pade-7 adjoint, giving the
//      cotangents of the scaled blocks (c_a, c_sm) and so c_G, c_sym, c_dt.
// ceil/clip of the scaling count have zero derivative almost everywhere, as
// in the JAX package, whose custom VJP this is.
//
// What bounds it on the H100: arithmetic, and how well the compiler can
// schedule it.  A rank-5 gap reads 3 R^2 + 3 floats and writes one, but
// costs ~80 R x R products, four LU solves and a Cholesky.  The first design
// (one thread per gap, every Pade intermediate and up to 56 squaring rounds
// in per-thread arrays, all in one function) ran from local memory (a
// 7,888 B stack at rank 5) and let a warp's 32 gaps take both branches and
// up to ~9x the mean number of squaring rounds.
//
// What this design does about it (one thread per gap, 128 gaps a block):
//   * divergence: the block sorts its gaps by (branch, rounds), both known
//     from dt, before the adjoint (a rank sort in shared memory, ties in
//     gap order, so the order -- and every sum -- is the same on every
//     run); a warp then runs one branch and nearly one round count.  Each
//     output goes back to its gap's own slot.
//   * local memory: the generator lives once per block in shared memory
//     (gapsmem.cuh), and every R x R block that must outlive the registers
//     sits in 8 per-thread slots of dynamic shared memory (thread index
//     innermost: conflict-free); the Pade polynomial (a^2, a^4, the s-terms,
//     p_a, p_s, nu, de) is recomputed in the backward from dt and the
//     shared generator instead of being saved.
//   * scheduling: the gap's work is three functions that the compiler
//     allocates and schedules apart (adj_front: the forward, the q1-terms
//     adjoint and the reversed rounds; adj_back_a and adj_back_b: the two
//     halves of the Pade adjoint), handing their blocks over in the slots;
//     none takes an array by reference, so none needs a stack frame.  The
//     same arithmetic in one inlined function ran over twice as long on the
//     card (PERF.md, section 6).
//   * the round stack: only the Pade output and the inputs of rounds 1-3
//     (one block each in the direct branch; the three blocks of round 1 in
//     the Van Loan branch, which needs at most ceil(log2((2 + R) / theta_7))
//     <= 2 rounds at R <= 8) are stored; deeper round inputs are recomputed
//     from the last stored one by the forward's own squaring code, so they
//     are the same numbers, and gaps up to CGT_MAXSQ = 40 rounds stay right.
//   * determinism: the generator gradient is reduced per thread block in a
//     fixed order (warp shuffles, then the warps in turn; no float atomics)
//     into one partial per block, which the wrapper sums.
// Ranks 6-8 run 64 threads a block, each taking two of the block's gaps in
// turn, so the slots fit in shared memory.
#include "gapsmem.cuh"

namespace {

using gsm::GenS;
using gsm::mm_acc;
using gsm::zero;

#define K5_GAPS 128  // gaps per thread block (the wrapper's partial count)
#define K5_SLOTS 8   // per-thread R x R slots of dynamic shared memory
// the slots: the Pade output (round 0's input), three of the other rounds'
// stored inputs (or, in the backward, the polynomial's pieces), two scratch
enum { F1 = 0, G1 = 1, F3 = 2, U0 = 3, U1 = 4, U2 = 5, W0 = 6, W1 = 7 };
#define K5_STORED 4  // squaring rounds whose inputs are stored (0-3)

template <int R>
struct K5 {
  static constexpr int NT = R <= 5 ? 128 : 64;  // threads per block
  static constexpr int GPT = K5_GAPS / NT;       // gaps per thread
  static constexpr size_t SMEM = size_t(K5_SLOTS) * R * R * NT * 4;
};

// A thread's slots: element (i, k) of slot s at ((s R + i) R + k) NT + tid.
// Volatile: every get is a load and every put a store, so a block parked in
// a slot leaves the registers (the compiler would otherwise forward it).
template <int R, int NT>
struct Slots {
  volatile float* p;  // the block's slot area + threadIdx.x
  __device__ __forceinline__ volatile float& at(int s, int i, int k) const {
    return p[((s * R + i) * R + k) * NT];
  }
  __device__ __forceinline__ void put(int s, const float (&m)[R][R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) at(s, i, k) = m[i][k];
  }
  __device__ __forceinline__ void get(int s, float (&m)[R][R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) m[i][k] = at(s, i, k);
  }
};

template <int R>
__device__ __forceinline__ void copy(const float (&a)[R][R],
                                     float (&out)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] = a[i][k];
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

// a cotangent block of gap (j, c) from the chunk-major [s, R, R, C] input,
// valid-masked by gv
template <int R>
__device__ __forceinline__ void load_ct(const float* __restrict__ p, int j,
                                        int C, int c, float gv,
                                        float (&m)[R][R]) {
  cgt::load_mat<float, R>(p, j, C, c, m);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] *= gv;
}

// Round k's input (f1, g1, f3): stored for k < K5_STORED (the Van Loan
// branch stores rounds 0 and 1), else recomputed from the last stored
// round by the forward's squaring.
template <int R, int NT>
__device__ __forceinline__ void round_input(const Slots<R, NT>& sl, bool vl,
                                            int k, float (&f1)[R][R],
                                            float (&g1)[R][R],
                                            float (&f3)[R][R]) {
  int from;
  if (k == 0) {
    sl.get(F1, f1);
    if (vl) {
      sl.get(G1, g1);
      sl.get(F3, f3);
    }
    from = 0;
  } else if (vl) {
    sl.get(U0, f1);
    sl.get(U1, g1);
    sl.get(U2, f3);
    from = 1;
  } else {
    from = k < K5_STORED ? k : K5_STORED - 1;
    sl.get(U0 + from - 1, f1);
  }
  for (int q = from; q < k; ++q) gsm::square<R>(vl, f1, g1, f3);
}

// The first part of one gap's adjoint (expm_pallas._tn_adj_cell for one
// lane): the forward, the q1-terms adjoint and the reversed squaring rounds,
// leaving the cotangents of the Pade output (f1, g1, f3) in W0, W1, U2.
template <int R, int NT>
__device__ __noinline__ void adj_front(
    const GenS<R>* gsp, Slots<R, NT> sl, float dt, float gv,
    const float* __restrict__ coff, const float* __restrict__ cdl,
    const float* __restrict__ cdr, float clq, int j, int C, int c) {
  const GenS<R>& gs = *gsp;
  const bool vl = gsm::van_loan<R>(gs, dt);
  const int nsq = gsm::rounds<R>(gs, dt);
  const float scale = ldexpf(dt, -nsq);

  // ---- forward recompute, storing round 0 and rounds 1-3's inputs ----
  float cf1[R][R], cg1[R][R], cf3[R][R];
  {
    float f1[R][R], g1[R][R], f3[R][R];
    gsm::pade7<R>(gs, scale, f1, g1, f3);
    sl.put(F1, f1);
    sl.put(G1, g1);
    sl.put(F3, f3);
    for (int k = 0; k < nsq; ++k) {
      if (k > 0 && vl && k == 1) {
        sl.put(U0, f1);
        sl.put(U1, g1);
        sl.put(U2, f3);
      } else if (k > 0 && !vl && k < K5_STORED) {
        sl.put(U0 + k - 1, f1);
      }
      gsm::square<R>(vl, f1, g1, f3);
    }

    // ---- q1-terms adjoint: (c_off, c_dl, c_dr, c_lq) -> (c_e, c_q) ----
    float L[R][R], invd[R];
    {
      float q[R][R];
      gsm::q_of<R>(vl, f1, g1, q);
      cgt::chol<float, R>(q, L, invd);
    }
    sl.put(W1, g1);
    clq *= gv;
    // off = -M e, d_left = M - I, d_right = e^T M e, lq = log|Q1|; each
    // cotangent block is read once
    float c_m[R][R];
    {
      float xr[R][R], xo[R][R], t[R][R];
      load_ct<R>(cdr, j, C, c, gv, xr);
      zero<R>(t);
      mm_acc<R, false, false>(f1, xr, 1.f, t);
      load_ct<R>(cdl, j, C, c, gv, c_m);
      mm_acc<R, false, true>(t, f1, 1.f, c_m);
      load_ct<R>(coff, j, C, c, gv, xo);
      mm_acc<R, false, true>(xo, f1, -1.f, c_m);
      msolve<R>(L, invd, xo, t);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          cf1[i][k] = -t[i][k];  // c_e
          xo[i][k] = xr[i][k] + xr[k][i];
        }
      msolve<R>(L, invd, f1, t);  // Q1^{-1} e, e = f1
      mm_acc<R, false, false>(t, xo, 1.f, cf1);
    }
    {
      float c_q[R][R], t[R][R], t2[R][R];
      msolve<R>(L, invd, c_m, t);
      cgt::transpose<float, R>(t, t2);
      msolve<R>(L, invd, t2, t);  // c_q = -M c_m M
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          c_q[i][k] = -t[k][i];
          t2[i][k] = (i == k) ? 1.f : 0.f;
        }
      msolve<R>(L, invd, t2, t);  // d log|Q1| = tr(Q1^{-1} dQ1)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) c_q[i][k] += clq * t[i][k];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k)
          t2[i][k] = 0.5f * (c_q[i][k] + c_q[k][i]);
      sl.put(W0, t2);  // c_qs
    }

    // ---- q-branch adjoint ----
    float c_qs[R][R];
    sl.get(W0, c_qs);
    zero<R>(cg1);
    zero<R>(cf3);
    if (vl) {
      sl.get(W1, g1);
      mm_acc<R, false, false>(c_qs, f1, 1.f, cg1);
      mm_acc<R, true, false>(c_qs, g1, 1.f, cf1);
    } else {
      mm_acc<R, false, false>(c_qs, f1, -1.f, cf1);
      mm_acc<R, true, false>(c_qs, f1, -1.f, cf1);
    }
  }

  // ---- reverse squaring: f1' = f1^2 ; g1' = f1 g1 + g1 f3 ; f3' = f3^2 ----
  for (int k = nsq - 1; k >= 0; --k) {
    float f1k[R][R], g1k[R][R], f3k[R][R];
    if (vl && k >= 2) {  // never at R <= 8: keep the cotangents aside
      sl.put(W0, cf1);
      sl.put(W1, cg1);
      round_input<R, NT>(sl, vl, k, f1k, g1k, f3k);
      sl.get(W0, cf1);
      sl.get(W1, cg1);
    } else {
      round_input<R, NT>(sl, vl, k, f1k, g1k, f3k);
    }
    float n1[R][R];
    zero<R>(n1);
    mm_acc<R, false, true>(cf1, f1k, 1.f, n1);
    mm_acc<R, true, false>(f1k, cf1, 1.f, n1);
    if (vl) {
      mm_acc<R, false, true>(cg1, g1k, 1.f, n1);
      float n3[R][R], t[R][R];
      zero<R>(n3);
      mm_acc<R, true, false>(g1k, cg1, 1.f, n3);
      mm_acc<R, false, true>(cf3, f3k, 1.f, n3);
      mm_acc<R, true, false>(f3k, cf3, 1.f, n3);
      zero<R>(t);
      mm_acc<R, true, false>(f1k, cg1, 1.f, t);
      mm_acc<R, false, true>(cg1, f3k, 1.f, t);
      copy<R>(t, cg1);
      copy<R>(n3, cf3);
    }
    copy<R>(n1, cf1);
  }

  sl.put(W0, cf1);
  sl.put(W1, cg1);
  sl.put(U2, cf3);
}

// The Pade adjoint's first half: (c_f1, c_g1, c_f3) in (W0, W1, U2) ->
// the cotangents of v_tl, u_tl, v_tr, u_tr in (W0, W1, U0, U1).
template <int R, int NT>
__device__ __noinline__ void adj_back_a(const GenS<R>* gsp, Slots<R, NT> sl,
                                        float scale) {
  const GenS<R>& gs = *gsp;
  // ---- Pade-7 adjoint (expm_pallas._pade7_vanloan_bwd) ----
  // Solve adjoints follow X = A^{-1} B: c_B = A^{-T} c_X, c_A = -c_B X^T.
  // First the polynomial again, for nu, de and v_tr - u_tr.
  float cf3[R][R];
  sl.get(U2, cf3);
  float c_nu[R][R], c_rhsg[R][R], c_de[R][R];
  {
    float det[R][R];
    {
      float nu[R][R], de[R][R], vpu[R][R], vmu[R][R];
      {
        float p_a[R][R], p_s[R][R];
        gsm::pade_parts<R>(gs, scale, p_a, p_s, nu, vpu, gsm::NoKeep{});
        gsm::pade_sums<R>(gs, scale, p_a, p_s, nu, vpu, de, vmu);
      }
      sl.put(U0, vmu);
      sl.put(U1, nu);
      cgt::transpose<float, R>(de, det);
    }
    // x = de^{-1} [nu | rhs_g] = [f1 | g1] at round 0
    float cx[R][2 * R], cb2[R][2 * R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        cx[i][k] = sl.at(W0, i, k);
        cx[i][R + k] = sl.at(W1, i, k);
      }
    cgt::lu_solve<float, R, 2 * R>(det, cx, cb2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float xk[2 * R];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        xk[p] = sl.at(F1, k, p);
        xk[R + p] = sl.at(G1, k, p);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < 2 * R; ++p) acc += cb2[i][p] * xk[p];
        c_de[i][k] = -acc;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        c_nu[i][k] = cb2[i][k];
        c_rhsg[i][k] = cb2[i][R + k];
      }
  }
  // rhs_g = (v_tr + u_tr) - (v_tr - u_tr) f3
  float c_vtr[R][R], c_utr[R][R];
  {
    float f3[R][R], c_m[R][R];
    sl.get(F3, f3);
    zero<R>(c_m);
    mm_acc<R, false, true>(c_rhsg, f3, -1.f, c_m);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        c_vtr[i][k] = c_rhsg[i][k] + c_m[i][k];
        c_utr[i][k] = c_rhsg[i][k] - c_m[i][k];
      }
    float vmu[R][R];
    sl.get(U0, vmu);
    mm_acc<R, true, false>(vmu, c_rhsg, -1.f, cf3);  // cf3 is c_f3 now
    // f3 = nu^{-T} de^T
    float nu[R][R], c_bw[R][R], t[R][R];
    sl.get(U1, nu);
    cgt::lu_solve<float, R, R>(nu, cf3, c_bw);
    zero<R>(t);
    mm_acc<R, false, true>(c_bw, f3, 1.f, t);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        c_de[i][k] += c_bw[k][i];
        c_nu[i][k] -= t[k][i];
      }
  }
  // nu = v_tl + u_tl, de = v_tl - u_tl: c_vtl, c_utl
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      sl.at(W0, i, k) = c_nu[i][k] + c_de[i][k];
      sl.at(W1, i, k) = c_nu[i][k] - c_de[i][k];
    }
  sl.put(U0, c_vtr);
  sl.put(U1, c_utr);

}

// The Pade adjoint's second half: -> the scaled blocks' cotangents c_a
// (dL/da) in W0 and c_sm (dL/dsm) in U0.
template <int R, int NT>
__device__ __noinline__ void adj_back_b(const GenS<R>* gsp, Slots<R, NT> sl,
                                        float scale) {
  const GenS<R>& gs = *gsp;
  float c_a[R][R], c_sm[R][R];
  // the polynomial once more, keeping a2, s2, a4, s4 and p_a, p_s
  float p_a[R][R], p_s[R][R];
  {
    float v_tl[R][R], v_tr[R][R];
    gsm::pade_parts<R>(
        gs, scale, p_a, p_s, v_tl, v_tr,
        [&](const float (&a2)[R][R], const float (&s2)[R][R],
            const float (&a4)[R][R], const float (&s4)[R][R]) {
          sl.put(F1, a2);
          sl.put(G1, s2);
          sl.put(F3, a4);
          sl.put(U2, s4);
        });
  }
  // u_tl = a p_a;  u_tr = a p_s + sm p_a^T
  float c_pa[R][R], c_ps[R][R];
  {
    float a[R][R], sm[R][R], cu[R][R];
    gsm::scaled<R>(gs.gh, scale, a);
    gsm::scaled<R>(gs.sy, scale, sm);
    sl.get(U1, cu);  // c_utr
    zero<R>(c_sm);
    mm_acc<R, false, false>(cu, p_a, 1.f, c_sm);
    zero<R>(c_a);
    mm_acc<R, false, true>(cu, p_s, 1.f, c_a);
    zero<R>(c_pa);
    mm_acc<R, true, false>(cu, sm, 1.f, c_pa);
    zero<R>(c_ps);
    mm_acc<R, true, false>(a, cu, 1.f, c_ps);
    sl.get(W1, cu);  // c_utl
    mm_acc<R, false, true>(cu, p_a, 1.f, c_a);
    mm_acc<R, true, false>(a, cu, 1.f, c_pa);
  }
  sl.put(W1, c_a);
  sl.put(U1, c_sm);
  // polynomial coefficients
  float c_a6[R][R], c_a4[R][R], c_a2[R][R], c_s6[R][R], c_s4[R][R],
      c_s2[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float c_vtl = sl.at(W0, i, k);
      const float c_vtr = sl.at(U0, i, k);
      c_a6[i][k] = CGT_PADE7_B7 * c_pa[i][k] + CGT_PADE7_B6 * c_vtl;
      c_a4[i][k] = CGT_PADE7_B5 * c_pa[i][k] + CGT_PADE7_B4 * c_vtl;
      c_a2[i][k] = CGT_PADE7_B3 * c_pa[i][k] + CGT_PADE7_B2 * c_vtl;
      c_s6[i][k] = CGT_PADE7_B7 * c_ps[i][k] + CGT_PADE7_B6 * c_vtr;
      c_s4[i][k] = CGT_PADE7_B5 * c_ps[i][k] + CGT_PADE7_B4 * c_vtr;
      c_s2[i][k] = CGT_PADE7_B3 * c_ps[i][k] + CGT_PADE7_B2 * c_vtr;
    }
  {
    float a2[R][R], s2[R][R], a4[R][R], s4[R][R];
    sl.get(F1, a2);
    sl.get(G1, s2);
    sl.get(F3, a4);
    sl.get(U2, s4);
    // s6 = a2 s4 + s2 a4^T
    mm_acc<R, false, true>(c_s6, s4, 1.f, c_a2);
    mm_acc<R, true, false>(a2, c_s6, 1.f, c_s4);
    mm_acc<R, false, false>(c_s6, a4, 1.f, c_s2);
    mm_acc<R, true, false>(c_s6, s2, 1.f, c_a4);
    // a6 = a2 a4
    mm_acc<R, false, true>(c_a6, a4, 1.f, c_a2);
    mm_acc<R, true, false>(a2, c_a6, 1.f, c_a4);
    // s4 = a2 s2 + s2 a2^T
    mm_acc<R, false, true>(c_s4, s2, 1.f, c_a2);
    mm_acc<R, true, false>(c_s4, s2, 1.f, c_a2);
    mm_acc<R, true, false>(a2, c_s4, 1.f, c_s2);
    mm_acc<R, false, false>(c_s4, a2, 1.f, c_s2);
    // a4 = a2 a2
    mm_acc<R, false, true>(c_a4, a2, 1.f, c_a2);
    mm_acc<R, true, false>(a2, c_a4, 1.f, c_a2);
  }
  {
    float a[R][R], sm[R][R];
    gsm::scaled<R>(gs.gh, scale, a);
    gsm::scaled<R>(gs.sy, scale, sm);
    sl.get(W1, c_a);
    sl.get(U1, c_sm);
    // s2 = a sm - sm a^T
    mm_acc<R, false, true>(c_s2, sm, 1.f, c_a);
    mm_acc<R, true, false>(c_s2, sm, -1.f, c_a);
    mm_acc<R, true, false>(a, c_s2, 1.f, c_sm);
    mm_acc<R, false, false>(c_s2, a, -1.f, c_sm);
    // a2 = a a
    mm_acc<R, false, true>(c_a2, a, 1.f, c_a);
    mm_acc<R, true, false>(a, c_a2, 1.f, c_a);
  }
  sl.put(W0, c_a);
  sl.put(U0, c_sm);
}

// One gap's adjoint: returns c_dt and leaves dL/da, dL/dsm (the scaled
// blocks' cotangents) in c_a, c_sm.
template <int R, int NT>
__device__ __forceinline__ float gap_adjoint(
    const GenS<R>& gs, const Slots<R, NT>& sl, float dt, float gv,
    const float* __restrict__ coff, const float* __restrict__ cdl,
    const float* __restrict__ cdr, float clq, int j, int C, int c,
    float& scale, float (&c_a)[R][R], float (&c_sm)[R][R]) {
  const int nsq = gsm::rounds<R>(gs, dt);
  scale = ldexpf(dt, -nsq);
  adj_front<R, NT>(&gs, sl, dt, gv, coff, cdl, cdr, clq, j, C, c);
  adj_back_a<R, NT>(&gs, sl, scale);
  adj_back_b<R, NT>(&gs, sl, scale);
  sl.get(W0, c_a);
  sl.get(U0, c_sm);
  // dL/dscale through a = -G/2 scale and sm = sym scale
  float c_scale = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k)
      c_scale += c_a[i][k] * gs.gh[i * R + k] + c_sm[i][k] * gs.sy[i * R + k];
  return ldexpf(c_scale, -nsq) * gv;
}

// Sum of v over the warp, in lane 0 (every lane must call).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// A sort key per gap: the Van Loan branch first, then by rounds; past the
// end last.
template <int R>
__device__ __forceinline__ int sort_key(const GenS<R>& gs, float dt) {
  return (gsm::van_loan<R>(gs, dt) ? 0 : 64) + gsm::rounds<R>(gs, dt);
}

// K5_GAPS gaps m = blockIdx.x K5_GAPS + u of the chunk-major [s, C] grid
// (m = j C + c) per block, each thread taking K5<R>::GPT of them in the
// sorted order.
template <int R>
__global__ void __launch_bounds__(K5<R>::NT)
k_system_adjoint_kernel(const float* __restrict__ g,
                        const float* __restrict__ dt,
                        const float* __restrict__ gv,
                        const float* __restrict__ coff,
                        const float* __restrict__ cdl,
                        const float* __restrict__ cdr,
                        const float* __restrict__ clq, int s, int C,
                        float* cdt_out, float* cg_part, float* csym_part) {
  constexpr int NT = K5<R>::NT;
  extern __shared__ __align__(16) float cgt_smem[];
  __shared__ GenS<R> gs;
  __shared__ int key[K5_GAPS];
  __shared__ int order[K5_GAPS];
  __shared__ float red[NT / 32][2 * R * R];
  const int M = s * C;
  const int m0 = blockIdx.x * K5_GAPS;
  gsm::load_gen<R>(g, gs);
  __syncthreads();
  for (int u = threadIdx.x; u < K5_GAPS; u += NT)
    key[u] = m0 + u < M ? sort_key<R>(gs, dt[m0 + u]) : 1 << 20;
  __syncthreads();
  // rank sort: earlier keys first, ties in gap order
  for (int u = threadIdx.x; u < K5_GAPS; u += NT) {
    const int ku = key[u];
    int rank = 0;
    for (int v = 0; v < K5_GAPS; ++v) {
      const int kv = key[v];
      rank += (kv < ku) || (kv == ku && v < u);
    }
    order[rank] = u;
  }
  __syncthreads();

  const Slots<R, NT> sl{cgt_smem + threadIdx.x};
  float acc_g[R][R], acc_sym[R][R];
  zero<R>(acc_g);
  zero<R>(acc_sym);
#pragma unroll 1
  for (int t = 0; t < K5<R>::GPT; ++t) {
    const int m = m0 + order[threadIdx.x + t * NT];
    if (m < M) {
      const int j = m / C;
      const int c = m - j * C;
      float scale, c_a[R][R], c_sm[R][R];
      cdt_out[m] = gap_adjoint<R, NT>(gs, sl, dt[m], gv[m], coff, cdl, cdr,
                                      clq[m], j, C, c, scale, c_a, c_sm);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          acc_g[i][k] += c_a[i][k] * (-0.5f) * scale;
          acc_sym[i][k] += c_sm[i][k] * scale;
        }
    }
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float a = warp_sum(acc_g[i][k]);
      const float b = warp_sum(acc_sym[i][k]);
      if (lane == 0) {
        red[warp][i * R + k] = a;
        red[warp][R * R + i * R + k] = b;
      }
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * R * R; e += NT) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) acc += red[w][e];
    float* out = e < R * R ? cg_part : csym_part;
    out[size_t(blockIdx.x) * R * R + (e % (R * R))] = acc;
  }
}

template <int R>
inline int launch_adjoint(const float* g, const float* dt, const float* gv,
                          const float* coff, const float* cdl,
                          const float* cdr, const float* clq, int s, int C,
                          float* cdt, float* cg_part, float* csym_part,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      k_system_adjoint_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(K5<R>::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_system_adjoint_kernel<R>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const int blocks = (s * C + K5_GAPS - 1) / K5_GAPS;
  k_system_adjoint_kernel<R><<<blocks, K5<R>::NT, K5<R>::SMEM, st>>>(
      g, dt, gv, coff, cdl, cdr, clq, s, C, cdt, cg_part, csym_part);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_k_system_adjoint_f32(const float* g, const float* dt,
                             const float* gv, const float* coff,
                             const float* cdl, const float* cdr,
                             const float* clq, int r, int s, int C,
                             float* cdt, float* cg_part, float* csym_part,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                     \
  return launch_adjoint<RR>(g, dt, gv, coff, cdl, cdr, clq, s, C, cdt,     \
                            cg_part, csym_part, st)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of the rank-r instance
int cgt_k_system_adjoint_smem_bytes(int r) {
#define CGT_LAUNCH(RR) return int(K5<RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
