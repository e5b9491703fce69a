// Analytic adjoint of the celerite conditional filter (celerite_filter.cu):
// the descending pass of the celerite training backward.
//
// Replaces: cyclic_gps_tpu/ops/celerite_pallas.py:813
// celerite_filter_adjoint_pallas (kernel body _cel_filter_adjoint_kernel,
// :680); the recursion is ops/chunked_filter.conditional_filter_adjoint_xla.
//
// Per chunk lane c, steps s-1 .. 0: recompute the step's O(R^2 q) forward
// intermediates (S, its Cholesky, the gains, the post-update a1, P1) from
// the stored pre-update (a_j, F_j, P_j), transpose the predict and the
// update exactly, carry (abar, Fbar, Pbar) to the previous step, and emit
// the cotangents of the step's gap terms for the 2 x 2 diagonal blocks of
// (e, Q) only -- e and Q are block-diagonal, so the dense R x R cotangent is
// never formed.  The cotangents of B and Lambda are per-lane partial sums,
// written out and summed by the wrapper in a fixed order (no atomics, so
// runs repeat bit for bit).
//
// What bounds it on the H100: it reads the 2 R^2 + R floats of history per
// step (2.1 GB at R = 16, N = 1e6) and writes 8 nblocks + q floats, with
// O(R^2 q) flops per step, so its bound is the bytes.  One thread per chunk
// lane (7,813 threads at N = 1e6, s = 128) leaves it latency- and
// occupancy-bound, and at R = 16 its carried cotangents and the reloaded
// F_j, P_j (~1,500 floats) live in local memory.
//
// What the simple design does about it: each history row is read once,
// descending with plain strides (no reversed copy); the cotangents are
// transformed in place (abar, Fbar, Pbar become e^T abar, e^T Fbar,
// e^T Pbar e and then the next carry), so the thread holds one copy of each;
// the lane axis is innermost so every access coalesces.
#include "celerite.cuh"

namespace {

template <int NB, int Q>
__global__ void __launch_bounds__(CGT_THREADS)
celerite_filter_adjoint_kernel(
    const float* __restrict__ gb, const float* __restrict__ b_p,
    const float* __restrict__ lam_p, const float* __restrict__ dt,
    const float* __restrict__ gv, const float* __restrict__ real,
    const float* __restrict__ y, const float* __restrict__ a_h,
    const float* __restrict__ F_h, const float* __restrict__ P_h,
    const float* __restrict__ Hb_p, const float* __restrict__ hb_p,
    const float* __restrict__ c0b_p, const float* __restrict__ ldb_p,
    const float* __restrict__ Fsb_p, const float* __restrict__ asb_p,
    const float* __restrict__ Psb_p, int s, int C, float* ebar, float* qbar,
    float* ybar, float* b_part, float* l_part) {
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
  // output cotangents: constant along the chunk (the accumulators pass
  // through every step) or the seed of the carried state (the maps)
  float Hb[R][R], hb[R], abar[R], Fbar[R][R], Pbar[R][R];
  cgt::load_mat<float, R>(Hb_p, 0, C, c, Hb);
  cgt::load_vec<float, R>(hb_p, 0, C, c, hb);
  cgt::load_vec<float, R>(asb_p, 0, C, c, abar);
  cgt::load_mat<float, R>(Fsb_p, 0, C, c, Fbar);
  cgt::load_mat<float, R>(Psb_p, 0, C, c, Pbar);
  const float c0b = c0b_p[c], ldb = ldb_p[c];
  float bacc[Q][R], lacc[Q][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int i = 0; i < R; ++i) bacc[q][i] = 0.f;
#pragma unroll
    for (int p = 0; p < Q; ++p) lacc[q][p] = 0.f;
  }

  for (int j = s - 1; j >= 0; --j) {
    const size_t ij = size_t(j) * C + c;
    const float v = real[ij];
    float a0[R], F0[R][R], W[R][R];
    cgt::load_vec<float, R>(a_h, j, C, c, a0);
    cgt::load_mat<float, R>(F_h, j, C, c, F0);
    cgt::load_mat<float, R>(P_h, j, C, c, W);  // P0, then P1, then e P1

    // ---- recompute the forward intermediates ----
    float BP[Q][R], G[Q][R], resid[Q], S[Q][Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float ba = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float bp = 0.f, bf = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          bp += B[q][i] * W[i][k];
          bf += B[q][i] * F0[i][k];
        }
        BP[q][k] = bp;
        G[q][k] = bf;
        ba += B[q][k] * a0[k];
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
    float L[Q][Q], invd[Q], t[Q][R], tv[Q], eye[Q][Q], tq[Q][Q];
    cgt::chol<float, Q>(S, L, invd);
    float sr[Q], X[Q][R], X2[Q][R], Si[Q][Q];
    cgt::solve_lower_vec<float, Q>(L, invd, resid, tv);
    cgt::solve_lower_t_vec<float, Q>(L, invd, tv, sr);
    cgt::solve_lower<float, Q, R>(L, invd, G, t);
    cgt::solve_lower_t<float, Q, R>(L, invd, t, X);
    cgt::solve_lower<float, Q, R>(L, invd, BP, t);
    cgt::solve_lower_t<float, Q, R>(L, invd, t, X2);  // K = X2^T
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < Q; ++p) eye[q][p] = (q == p) ? 1.f : 0.f;
    cgt::solve_lower<float, Q, Q>(L, invd, eye, tq);
    cgt::solve_lower_t<float, Q, Q>(L, invd, tq, Si);
    // P1 = P0 - v (P B^T) X2 in place, keeping B P0 for the B cotangent
    float a1[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float ai = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) ai += BP[q][i] * sr[q];
      a1[i] = a0[i] + v * ai;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float pq = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) pq += BP[q][i] * X2[q][k];
        W[i][k] -= v * pq;
      }
    }

    // ---- predict adjoint: a' = e a1, F' = e F1, P' = e P1 e^T + Q ----
    float e[NB][4], qn[NB][3];
    cgt::osc_eq<NB>(g, dt[ij], gv[ij], e, qn);
#pragma unroll
    for (int k = 0; k < NB; ++k) {  // W = e P1 (row mixes)
      const int r0 = 2 * k, r1 = 2 * k + 1;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float p0 = W[r0][m], p1 = W[r1][m];
        W[r0][m] = e[k][0] * p0 + e[k][1] * p1;
        W[r1][m] = e[k][2] * p0 + e[k][3] * p1;
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int r0 = 2 * k;
      float eb[2][2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const int ri = r0 + x, cj = r0 + z;
          // F1[cj][m] recomputed: F0[cj][m] - v (P B^T X)[cj][m]
          float acc = abar[ri] * a1[cj];
#pragma unroll
          for (int m = 0; m < R; ++m) {
            float fq = 0.f;
#pragma unroll
            for (int q = 0; q < Q; ++q) fq += BP[q][cj] * X[q][m];
            acc += Fbar[ri][m] * (F0[cj][m] - v * fq) +
                   (Pbar[ri][m] + Pbar[m][ri]) * W[m][cj];
          }
          eb[x][z] = acc;
        }
      const size_t o = (size_t(j) * NB + k) * 4;
      ebar[(o + 0) * C + c] = eb[0][0];
      ebar[(o + 1) * C + c] = eb[0][1];
      ebar[(o + 2) * C + c] = eb[1][0];
      ebar[(o + 3) * C + c] = eb[1][1];
      qbar[(o + 0) * C + c] = Pbar[r0][r0];
      qbar[(o + 1) * C + c] = Pbar[r0][r0 + 1];
      qbar[(o + 2) * C + c] = Pbar[r0 + 1][r0];
      qbar[(o + 3) * C + c] = Pbar[r0 + 1][r0 + 1];
    }
    // abar1 = e^T abar, Fbar1 = e^T Fbar, Pbar1 = e^T Pbar e, in place
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int r0 = 2 * k, r1 = 2 * k + 1;
      const float e00 = e[k][0], e01 = e[k][1], e10 = e[k][2], e11 = e[k][3];
      const float b0 = abar[r0], b1 = abar[r1];
      abar[r0] = e00 * b0 + e10 * b1;
      abar[r1] = e01 * b0 + e11 * b1;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float f0 = Fbar[r0][m], f1 = Fbar[r1][m];
        Fbar[r0][m] = e00 * f0 + e10 * f1;
        Fbar[r1][m] = e01 * f0 + e11 * f1;
        const float p0 = Pbar[r0][m], p1 = Pbar[r1][m];
        Pbar[r0][m] = e00 * p0 + e10 * p1;
        Pbar[r1][m] = e01 * p0 + e11 * p1;
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int r0 = 2 * k, r1 = 2 * k + 1;
      const float e00 = e[k][0], e01 = e[k][1], e10 = e[k][2], e11 = e[k][3];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float p0 = Pbar[m][r0], p1 = Pbar[m][r1];
        Pbar[m][r0] = p0 * e00 + p1 * e10;
        Pbar[m][r1] = p0 * e01 + p1 * e11;
      }
    }

    // ---- update adjoint ----
    // Kbar = v (abar1 resid^T - Fbar1 G^T - Pbar1 (P B^T))      [R][Q]
    // PBtbar = -v Pbar1^T K + Kbar Si                            [R][Q]
    float Kbar[R][Q], PBtbar[R][Q];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float fg = 0.f, pp = 0.f, pk = 0.f;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          fg += Fbar[i][m] * G[q][m];
          pp += Pbar[i][m] * BP[q][m];
          pk += Pbar[m][i] * X2[q][m];
        }
        Kbar[i][q] = v * (abar[i] * resid[q] - fg - pp);
        PBtbar[i][q] = -v * pk;
      }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < Q; ++p) acc += Kbar[i][p] * Si[q][p];
        PBtbar[i][q] += acc;
      }
    // rbar = v (K^T abar1 + X hb + 2 c0b sr)                    [Q]
    // Gbar = v (-K^T Fbar1 + X (Hb + Hb^T) + sr hb^T)           [Q][R]
    float rbar[Q], Gbar[Q][R], ghb[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float ka = 0.f, xh = 0.f, gh = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ka += X2[q][i] * abar[i];
        xh += X[q][i] * hb[i];
        gh += G[q][i] * hb[i];
      }
      rbar[q] = v * (ka + xh + 2.f * c0b * sr[q]);
      ghb[q] = gh;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float kf = 0.f, xh2 = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kf += X2[q][i] * Fbar[i][m];
          xh2 += X[q][i] * (Hb[i][m] + Hb[m][i]);
        }
        Gbar[q][m] = v * (-kf + xh2 + sr[q] * hb[m]);
      }
    }
    // Sibar = (P B^T)^T Kbar + v (G Hb G^T + (G hb) resid^T + c0b r r^T)
    float Sibar[Q][Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        float pk = 0.f, ghg = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pk += BP[q][i] * Kbar[i][p];
          float hg = 0.f;
#pragma unroll
          for (int m = 0; m < R; ++m) hg += Hb[i][m] * G[p][m];
          ghg += G[q][i] * hg;
        }
        Sibar[q][p] = pk + v * (ghg + ghb[q] * resid[p] +
                                c0b * resid[q] * resid[p]);
      }
    // Sbar = v ldb Si - Si Sibar Si
    float Sbar[Q][Q], ts[Q][Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < Q; ++x) acc += Si[q][x] * Sibar[x][p];
        ts[q][p] = acc;
      }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int p = 0; p < Q; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < Q; ++x) acc += ts[q][x] * Si[x][p];
        Sbar[q][p] = v * ldb * Si[q][p] - acc;
      }
    // the B and Lambda cotangents of this step (B P0 is BP), and ybar
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float acc = -rbar[q] * a0[m];
#pragma unroll
        for (int i = 0; i < R; ++i) acc += Gbar[q][i] * F0[m][i];
#pragma unroll
        for (int p = 0; p < Q; ++p)
          acc += (Sbar[q][p] + Sbar[p][q]) * BP[p][m];
        bacc[q][m] += acc;
      }
#pragma unroll
      for (int p = 0; p < Q; ++p) lacc[q][p] += Sbar[q][p];
      ybar[cgt::vec_at<Q>(j, q, C, c)] = rbar[q];
    }
    // PBtbar^T P0: P0 is the history row (W now holds e P1)
#pragma unroll
    for (int m = 0; m < R; ++m) {
      float p0col[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        p0col[i] = P_h[cgt::mat_at<R>(j, i, m, C, c)];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc += PBtbar[i][q] * p0col[i];
        bacc[q][m] += acc;
      }
    }
    // the carry: abar = abar1 - B^T rbar, Fbar = Fbar1 + B^T Gbar,
    // Pbar = Pbar1 + PBtbar B + B^T Sbar B
    float SB[Q][R];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < Q; ++p) acc += Sbar[q][p] * B[p][m];
        SB[q][m] = acc;
      }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float br = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) br += B[q][i] * rbar[q];
      abar[i] -= br;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float fg = 0.f, pb = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          fg += B[q][i] * Gbar[q][m];
          pb += PBtbar[i][q] * B[q][m] + B[q][i] * SB[q][m];
        }
        Fbar[i][m] += fg;
        Pbar[i][m] += pb;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int m = 0; m < R; ++m) b_part[size_t(q * R + m) * C + c] = bacc[q][m];
#pragma unroll
    for (int p = 0; p < Q; ++p) l_part[size_t(q * Q + p) * C + c] = lacc[q][p];
  }
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <int Q>
int launch_adjoint(const float* gb, const float* b, const float* lam,
                   const float* dt, const float* gv, const float* real,
                   const float* y, const float* a_h, const float* F_h,
                   const float* P_h, const float* Hb, const float* hb,
                   const float* c0b, const float* ldb, const float* Fsb,
                   const float* asb, const float* Psb, int nb, int s, int C,
                   float* ebar, float* qbar, float* ybar, float* b_part,
                   float* l_part, cudaStream_t st) {
#define CGT_LAUNCH(NB)                                                      \
  celerite_filter_adjoint_kernel<NB, Q>                                     \
      <<<blocks_for(C), CGT_THREADS, 0, st>>>(                              \
          gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb, hb, c0b, ldb, Fsb, \
          asb, Psb, s, C, ebar, qbar, ybar, b_part, l_part)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_celerite_filter_adjoint_f32(
    const float* gb, const float* b, const float* lam, const float* dt,
    const float* gv, const float* real, const float* y, const float* a_h,
    const float* F_h, const float* P_h, const float* Hb, const float* hb,
    const float* c0b, const float* ldb, const float* Fsb, const float* asb,
    const float* Psb, int nb, int q, int s, int C, float* ebar, float* qbar,
    float* ybar, float* b_part, float* l_part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q == 1)
    return launch_adjoint<1>(gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb,
                             hb, c0b, ldb, Fsb, asb, Psb, nb, s, C, ebar,
                             qbar, ybar, b_part, l_part, st);
  if (q == 2)
    return launch_adjoint<2>(gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb,
                             hb, c0b, ldb, Fsb, asb, Psb, nb, s, C, ebar,
                             qbar, ybar, b_part, l_part, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
