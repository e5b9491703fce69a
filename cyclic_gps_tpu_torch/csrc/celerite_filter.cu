// Chunk-parallel conditional Kalman filter of the celerite family, and its
// collect variant that also streams the per-step pre-update state for the
// analytic adjoint (celerite_adjoint.cu).
//
// Replaces (cyclic_gps_tpu/ops/celerite_pallas.py):
//   celerite_filter_kernel<.., false> <- :479 celerite_filter_sweep_pallas
//                                        (kernel body _cel_filter_kernel,
//                                        :387)
//   celerite_filter_kernel<.., true>  <- :592
//                                        celerite_filter_collect_sweep_pallas
//                                        (_cel_filter_collect_kernel, :563)
//
// Per chunk lane c and step j (ops/chunked_filter.conditional_filter_xla's
// recursion): the masked innovation update at row j -- S = B P B^T + Lambda,
// its q x q Cholesky (the only factorization), the gains -- accumulating the
// chunk's quadratic (H, h, c0) and sum log|S|, then the predict through the
// following gap with the closed-form block-diagonal (e, Q): every e X is a
// 2 x 2 mix of rows 2k and 2k+1, so no R x R product appears.
//
// What bounds it on the H100: O(R^2 q) flops per step (~25 R^2 at q = 1)
// against 3 + q floats of input; the plain sweep writes only the chunk's
// statistics, so it is bound by operations (~6 GFLOP at R = 16, N = 1e6).
// The collect variant writes 2 R^2 + R floats of history per step (2.1 GB
// at R = 16, N = 1e6) and is bound by those bytes.  With one thread per
// chunk lane (7,813 threads at N = 1e6, s = 128, under half the SMs) both
// are latency- and occupancy-bound instead; at R = 16 the carried a, F, P,
// H, h (~800 floats) live in local memory.
//
// What the simple design does about it: one thread walks its chunk's s
// steps with the whole filter state carried between them, so device memory
// sees each input once and the statistics (or the history) once; the lane
// axis is innermost so every load and store coalesces.  A warp per chunk
// (lane i holding row i of F and P, the 2 x 2 mixes as shuffles) is the
// design that would fill the card; it is later work.
#include "celerite.cuh"

namespace {

template <int NB, int Q, bool COLLECT>
__global__ void __launch_bounds__(CGT_THREADS)
celerite_filter_kernel(const float* __restrict__ gb,
                       const float* __restrict__ b_p,
                       const float* __restrict__ lam_p,
                       const float* __restrict__ dt,
                       const float* __restrict__ gv,
                       const float* __restrict__ real,
                       const float* __restrict__ y, int s, int C,
                       float* H_out, float* h_out, float* c0_out,
                       float* ld_out, float* F_out, float* a_out, float* P_out,
                       float* a_h, float* F_h, float* P_h) {
  constexpr int R = 2 * NB;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g[NB][4];
  cgt::load_osc<NB>(gb, g);
  float B[Q][R], lam[Q][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int i = 0; i < R; ++i) B[q][i] = b_p[q * R + i];
#pragma unroll
    for (int p = 0; p < Q; ++p) lam[q][p] = lam_p[q * Q + p];
  }
  float a[R], h[R], F[R][R], P[R][R], H[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    a[i] = 0.f;
    h[i] = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      F[i][k] = (i == k) ? 1.f : 0.f;
      P[i][k] = 0.f;
      H[i][k] = 0.f;
    }
  }
  float c0 = 0.f, ld = 0.f;

  for (int j = 0; j < s; ++j) {
    const size_t ij = size_t(j) * C + c;
    const float v = real[ij];
    if (COLLECT) {  // the pre-update state of step j
      cgt::store_vec<float, R>(a_h, j, C, c, a);
      cgt::store_mat<float, R>(F_h, j, C, c, F);
      cgt::store_mat<float, R>(P_h, j, C, c, P);
    }
    // ---- innovation update (masked by v; S >= Lambda always SPD) ----
    float BP[Q][R], G[Q][R], resid[Q], S[Q][Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float ba = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float bp = 0.f, bf = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          bp += B[q][i] * P[i][k];
          bf += B[q][i] * F[i][k];
        }
        BP[q][k] = bp;
        G[q][k] = bf;
        ba += B[q][k] * a[k];
      }
      resid[q] = y[cgt::vec_at<Q>(j, q, C, c)] - ba;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        float acc = lam[q][p];
#pragma unroll
        for (int k = 0; k < R; ++k) acc += BP[q][k] * B[p][k];
        S[q][p] = acc;
      }
    float L[Q][Q], invd[Q], t[Q][R], tv[Q];
    const float ldh = cgt::chol<float, Q>(S, L, invd);
    float sr[Q], X[Q][R], X2[Q][R];
    cgt::solve_lower_vec<float, Q>(L, invd, resid, tv);
    cgt::solve_lower_t_vec<float, Q>(L, invd, tv, sr);
    cgt::solve_lower<float, Q, R>(L, invd, G, t);
    cgt::solve_lower_t<float, Q, R>(L, invd, t, X);
    cgt::solve_lower<float, Q, R>(L, invd, BP, t);
    cgt::solve_lower_t<float, Q, R>(L, invd, t, X2);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float hi = 0.f, ai = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        hi += G[q][i] * sr[q];
        ai += BP[q][i] * sr[q];  // (P B^T)_iq, P symmetric
      }
      h[i] += v * hi;
      a[i] += v * ai;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float hq = 0.f, fq = 0.f, pq = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          hq += G[q][i] * X[q][k];
          fq += BP[q][i] * X[q][k];
          pq += BP[q][i] * X2[q][k];
        }
        H[i][k] += v * hq;
        F[i][k] -= v * fq;
        P[i][k] -= v * pq;
      }
    }
    float rs = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) rs += resid[q] * sr[q];
    c0 += v * rs;
    ld += v * 2.f * ldh;

    // ---- predict through the following gap (masked: exact no-op) ----
    float e[NB][4], qn[NB][3];
    cgt::osc_eq<NB>(g, dt[ij], gv[ij], e, qn);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int r0 = 2 * k, r1 = 2 * k + 1;
      const float e00 = e[k][0], e01 = e[k][1], e10 = e[k][2], e11 = e[k][3];
      const float a0 = a[r0], a1 = a[r1];
      a[r0] = e00 * a0 + e01 * a1;
      a[r1] = e10 * a0 + e11 * a1;
#pragma unroll
      for (int m = 0; m < R; ++m) {  // rows of F and P: e X
        const float f0 = F[r0][m], f1 = F[r1][m];
        F[r0][m] = e00 * f0 + e01 * f1;
        F[r1][m] = e10 * f0 + e11 * f1;
        const float p0 = P[r0][m], p1 = P[r1][m];
        P[r0][m] = e00 * p0 + e01 * p1;
        P[r1][m] = e10 * p0 + e11 * p1;
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {  // columns of e P: (e P) e^T, then + Q
      const int r0 = 2 * k, r1 = 2 * k + 1;
      const float e00 = e[k][0], e01 = e[k][1], e10 = e[k][2], e11 = e[k][3];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float p0 = P[m][r0], p1 = P[m][r1];
        P[m][r0] = p0 * e00 + p1 * e01;
        P[m][r1] = p0 * e10 + p1 * e11;
      }
      P[r0][r0] += qn[k][0];
      P[r0][r1] += qn[k][1];
      P[r1][r0] += qn[k][1];
      P[r1][r1] += qn[k][2];
    }
  }
  cgt::store_mat<float, R>(H_out, 0, C, c, H);
  cgt::store_vec<float, R>(h_out, 0, C, c, h);
  c0_out[c] = c0;
  ld_out[c] = ld;
  cgt::store_mat<float, R>(F_out, 0, C, c, F);
  cgt::store_vec<float, R>(a_out, 0, C, c, a);
  cgt::store_mat<float, R>(P_out, 0, C, c, P);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <int Q, bool COLLECT>
int launch_filter(const float* gb, const float* b, const float* lam,
                  const float* dt, const float* gv, const float* real,
                  const float* y, int nb, int s, int C, float* H, float* h,
                  float* c0, float* ld, float* F, float* a, float* P,
                  float* a_h, float* F_h, float* P_h, cudaStream_t st) {
#define CGT_LAUNCH(NB)                                                       \
  celerite_filter_kernel<NB, Q, COLLECT>                                     \
      <<<blocks_for(C), CGT_THREADS, 0, st>>>(gb, b, lam, dt, gv, real, y, s, \
                                              C, H, h, c0, ld, F, a, P, a_h,  \
                                              F_h, P_h)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The collect variant runs when a_h is not null (then F_h and P_h are
// written too).
int cgt_celerite_filter_f32(const float* gb, const float* b, const float* lam,
                            const float* dt, const float* gv,
                            const float* real, const float* y, int nb, int q,
                            int s, int C, float* H, float* h, float* c0,
                            float* ld, float* F, float* a, float* P,
                            float* a_h, float* F_h, float* P_h,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool collect = a_h != nullptr;
  if (q == 1)
    return collect ? launch_filter<1, true>(gb, b, lam, dt, gv, real, y, nb,
                                            s, C, H, h, c0, ld, F, a, P, a_h,
                                            F_h, P_h, st)
                   : launch_filter<1, false>(gb, b, lam, dt, gv, real, y, nb,
                                             s, C, H, h, c0, ld, F, a, P, a_h,
                                             F_h, P_h, st);
  if (q == 2)
    return collect ? launch_filter<2, true>(gb, b, lam, dt, gv, real, y, nb,
                                            s, C, H, h, c0, ld, F, a, P, a_h,
                                            F_h, P_h, st)
                   : launch_filter<2, false>(gb, b, lam, dt, gv, real, y, nb,
                                             s, C, H, h, c0, ld, F, a, P, a_h,
                                             F_h, P_h, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
