// Closed-form gap terms of the celerite family, shared by its four kernels
// (celerite_sweep.cu, celerite_filter.cu, celerite_adjoint.cu).
//
// The celerite generator G is block-diagonal with 2 x 2 damped-oscillator
// blocks g_k, so per gap d each oscillator's transition e_k = expm(-d g_k/2)
// and noise Q1_k = I - e_k e_k^T have closed forms.  With A = -d g_k / 2 =
// mu I + Delta, tr Delta = 0, Delta = [[alpha, beta], [gamma, -alpha]] and
// q2 = alpha^2 + beta gamma:
//
//   E = e - I = ecm1 I + esnc Delta,
//   Q1 = -(E + E^T + E E^T)            (no cancellation against I),
//
// with (ecm1, esnc) from the hyperbolic branch (q2 >= cut^2), the
// trigonometric branch (q2 <= -cut^2) or the signed-q2 series between.
// This mirrors models/celerite._block_e_terms / _block_eq_terms of the JAX
// package (and ops/celerite_pallas._osc_core), with the card's expm1f
// where the TPU kernels carry a polynomial stand-in.
#pragma once

#include "blockmath.cuh"

namespace cgt {

#define CGT_SERIES_CUT 0.29f

// E = e - I entries (e00 - 1, e01, e10, e11 - 1) and Q1 entries (q00, q01,
// q11) of one oscillator g = (g00, g01, g10, g11) at gap dt.
__device__ __forceinline__ void osc_core(const float (&g)[4], float dt,
                                         float (&em)[4], float (&q)[3]) {
  const float mu = -dt * (g[0] + g[3]) / 4.f;
  const float al = -dt * (g[0] - g[3]) / 4.f;
  const float be = -dt * g[1] / 2.f;
  const float ga = -dt * g[2] / 2.f;
  const float q2 = al * al + be * ga;
  const float cut2 = CGT_SERIES_CUT * CGT_SERIES_CUT;
  const float em1_mu = expm1f(mu);
  float ecm1, esnc;
  if (q2 >= cut2) {  // hyperbolic: (expm1(mu + w) +/- expm1(mu - w)) / 2
    const float w = sqrtf(q2);
    const float ep = expm1f(mu + w);
    const float en = expm1f(mu - w);
    ecm1 = 0.5f * (ep + en);
    esnc = (ep - en) / (2.f * fmaxf(w, CGT_SERIES_CUT));
  } else if (q2 <= -cut2) {  // trigonometric: a damped oscillation
    // sin and cos of w as sincospif(w / pi): its exact reduction needs no
    // local buffer, where sinf / cosf keep one for |w| > 105615; the
    // rounding of w / pi (6e-8 w) is below the error w carries from q2
    const float w = sqrtf(-q2);
    float sw, cw;
    sincospif(w * 0.318309886f, &sw, &cw);
    ecm1 = em1_mu * cw + (cw - 1.f);
    esnc = (1.f + em1_mu) * sw / fmaxf(w, CGT_SERIES_CUT);
  } else {  // cosh(w) - 1 and sinh(w)/w as series in the signed q2
    const float cm1 =
        q2 * (1.f / 2.f +
              q2 * (1.f / 24.f +
                    q2 * (1.f / 720.f +
                          q2 * (1.f / 40320.f +
                                q2 * (1.f / 3628800.f + q2 / 479001600.f)))));
    const float snc =
        1.f + q2 * (1.f / 6.f +
                    q2 * (1.f / 120.f +
                          q2 * (1.f / 5040.f +
                                q2 * (1.f / 362880.f + q2 / 39916800.f))));
    ecm1 = em1_mu * (1.f + cm1) + cm1;
    esnc = (1.f + em1_mu) * snc;
  }
  em[0] = ecm1 + esnc * al;
  em[1] = esnc * be;
  em[2] = esnc * ga;
  em[3] = ecm1 - esnc * al;
  q[0] = -(2.f * em[0] + em[0] * em[0] + em[1] * em[1]);
  q[2] = -(2.f * em[3] + em[3] * em[3] + em[2] * em[2]);
  q[1] = -(em[1] + em[2] + em[0] * em[2] + em[1] * em[3]);
}

// oscillator k's block of G from gb [NB, 2, 2] (row-major entries)
template <int NB>
__device__ __forceinline__ void load_osc(const float* gb, float (&g)[NB][4]) {
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[k][i] = gb[4 * k + i];
}

// The validity-masked covariance-form gap terms of the conditional filter:
// e = I + gv E and Q = gv Q1 per oscillator (a masked gap is the exact no-op
// step e = I, Q = 0).  e as (e00, e01, e10, e11), Q as (q00, q01, q11).
template <int NB>
__device__ __forceinline__ void osc_eq(const float (&g)[NB][4], float dt,
                                       float gv, float (&e)[NB][4],
                                       float (&q)[NB][3]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float em[4], qq[3];
    osc_core(g[k], dt, em, qq);
    e[k][0] = 1.f + gv * em[0];
    e[k][1] = gv * em[1];
    e[k][2] = gv * em[2];
    e[k][3] = 1.f + gv * em[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) q[k][i] = gv * qq[i];
  }
}

}  // namespace cgt

// Launch helper: instantiate a celerite launcher for nblocks 1..8.
#define CGT_NB_SWITCH(nb, CALL)  \
  switch (nb) {                  \
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
