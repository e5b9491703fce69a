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
// What bounds it on the H100 (SXM peaks at its 700 W limit: 3.35 TB/s,
// 67 TFLOP/s float32): it reads the 2 R^2 + R floats of history per step
// (2.1 GB at R = 16, N = 1e6: ~0.72 ms) and writes 8 nblocks + q floats,
// with O(R^2 q) flops per step, so its bound is the bytes.  A step is a
// dependent chain of some twenty R^2 passes, and C = N/s lanes (7,813 at
// N = 1e6, s = 128) walk s steps each.
//
// Two designs, routed by nblocks in the launcher:
// * nblocks 5..8 (R = 10..16): ONE WARP PER CHUNK LANE (rtcoop.cuh's
//   tiles), the lane's R x R state in shared memory -- F_j, P_j, W (P1,
//   then e P1), the carried Fbar and Pbar, Hb, at the odd row stride
//   R | 1 -- with the Q x R and R x Q blocks (B P, G, the gains X and X2,
//   Gbar, Sbar B, Kbar, PBtbar, Hb G^T) and the vectors (a_j, a1, abar,
//   hb, the oscillators' e) beside them: ~8 KB per lane at R = 16, q = 2.
//   The 32 threads share each step: one output element of every R x R
//   pass (the P1 update with e's row mix, e^T's row and column mixes of
//   the cotangents, the carry) per thread and per 32 elements; one Q x R
//   or R x Q element (B P and G, a column of the gains, Kbar and PBtbar,
//   Gbar, the B cotangent) per thread; one of the 4 nblocks e cotangents
//   per thread; S, its Cholesky and every Q x Q solve replicated in every
//   thread's registers (Q <= 2).  The history rows are read once,
//   descending, the 8 lanes of a thread block loading whole 32-byte
//   spans; the B and Lambda partials stay per lane.  On an H100 SXM
//   (700 W; chip_smoke.py, PERF.md) at N = 1e6 it takes 4.7 ms at
//   nblocks 8 (6.5 x its byte bound) and 3.5 ms at nblocks 6, where the
//   thread-per-lane kernel took 74.5 and 12.1 ms (~1,500 floats of
//   carried state in local memory at R = 16).
// * nblocks 1..4 (R <= 8): ONE THREAD PER CHUNK LANE, the state in
//   registers (fully unrolled at these widths).  There a warp per lane
//   leaves most of its threads idle: at nblocks 2 it takes 1.65-1.78 ms
//   where this kernel takes 0.30-0.39 ms.
// Both keep one summation order for every output, so they agree bit for
// bit where the compiler contracts alike.
#include "celerite.cuh"
#include "rtcoop.cuh"

namespace {

namespace co = cgt::coop;
using Tile = co::Tile<float>;

// nblocks 1..4: one thread per chunk lane, its state in registers.
template <int NB, int Q>
__global__ void __launch_bounds__(CGT_THREADS)
celerite_filter_adjoint_thread_kernel(
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

// a[i] (a[i][p], a[p][i]) for a runtime i < Q, without indexing the
// register array at run time (which would move it to local memory)
template <int Q>
__device__ __forceinline__ float pick(const float (&a)[Q], int i) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < Q; ++k)
    if (i == k) r = a[k];
  return r;
}

template <int Q>
__device__ __forceinline__ float pick_row(const float (&a)[Q][Q], int i,
                                          int p) {
  float r = a[0][p];
#pragma unroll
  for (int k = 1; k < Q; ++k)
    if (i == k) r = a[k][p];
  return r;
}

template <int Q>
__device__ __forceinline__ float pick_col(const float (&a)[Q][Q], int p,
                                          int i) {
  float r = a[p][0];
#pragma unroll
  for (int k = 1; k < Q; ++k)
    if (i == k) r = a[p][k];
  return r;
}

// One lane's region in shared memory (offsets in floats) at nblocks NB,
// obs_dim Q: six R x ld blocks, nine Q x R / R x Q blocks, four vectors of
// R, the oscillators' e (4 per oscillator) and rbar, G hb (Q each).
template <int NB, int Q>
struct Lay {
  static constexpr int R = 2 * NB;
  static constexpr int LD = R | 1;
  static constexpr int BS = R * LD;
  static constexpr int QR = Q * R;
  static constexpr int F0 = 0, P0 = BS, W = 2 * BS, FB = 3 * BS,
                       PB = 4 * BS, HB = 5 * BS;
  static constexpr int BP = 6 * BS, G = BP + QR, X = G + QR, X2 = X + QR,
                       GB = X2 + QR, SB = GB + QR, KB = SB + QR,
                       PBT = KB + QR, HG = PBT + QR;
  static constexpr int A0 = HG + QR, A1 = A0 + R, AB = A1 + R, HBV = AB + R;
  static constexpr int E = HBV + R, RB = E + 4 * NB, GHB = RB + Q;
  static constexpr int STRIDE = GHB + Q;
  // the block's constants after its LANES regions: B [Q][R], Lambda
  // [Q][Q], the oscillators' blocks of G [NB][4]
  static constexpr int CB = 0, CL = QR, CG = QR + Q * Q;
  static constexpr int CONSTS = CG + 4 * NB;
  static constexpr size_t bytes() {
    return (size_t(Tile::LANES) * STRIDE + CONSTS) * sizeof(float);
  }
};

template <int NB, int Q>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
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
  using Ly = Lay<NB, Q>;
  constexpr int R = Ly::R, LD = Ly::LD;
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  float* sm = reinterpret_cast<float*>(cgt_smem);
  float* const cst = sm + Tile::LANES * Ly::STRIDE;
  const co::Tiles<float> tile(sm, Ly::STRIDE, R, C);
  const co::Warp w(R);
  const int t = w.lane;
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const int c = int(blockIdx.x) * Tile::LANES + tl;
  const bool live = c < C;
  float* const me = sm + tl * Ly::STRIDE;
  const float* const B = cst + Ly::CB;  // B[q][i] at q * R + i

  for (int q = int(threadIdx.x); q < Ly::CONSTS; q += Tile::THREADS)
    cst[q] = q < Ly::CL ? b_p[q]
             : q < Ly::CG ? lam_p[q - Ly::CL] : gb[q - Ly::CG];
  // output cotangents: constant along the chunk (the accumulators pass
  // through every step) or the seed of the carried state (the maps)
  tile.load_m(Hb_p, 0, Ly::HB);
  tile.load_v(hb_p, 0, Ly::HBV);
  tile.load_v(asb_p, 0, Ly::AB);
  tile.load_m(Fsb_p, 0, Ly::FB);
  tile.load_m(Psb_p, 0, Ly::PB);
  const float c0b = live ? c0b_p[c] : 0.f;
  const float ldb = live ? ldb_p[c] : 0.f;
  // thread t owns element (q, m) = (t / R, t % R) of the Q x R blocks and
  // (i, q) = (t / Q, t % Q) of the R x Q ones, while t < Q R
  const bool own = t < Ly::QR;
  const int oq = t / R, om = t % R, oi = t / Q, oqq = t % Q;
  float bacc = 0.f, lacc[Q][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int p = 0; p < Q; ++p) lacc[q][p] = 0.f;

  float* const F0 = me + Ly::F0;
  float* const P0 = me + Ly::P0;
  float* const W = me + Ly::W;
  float* const Fb = me + Ly::FB;
  float* const Pb = me + Ly::PB;
  const float* const Hb = me + Ly::HB;
  float* const BP = me + Ly::BP;
  float* const G = me + Ly::G;
  float* const X = me + Ly::X;
  float* const X2 = me + Ly::X2;
  float* const Gb = me + Ly::GB;
  float* const SB = me + Ly::SB;
  float* const Kb = me + Ly::KB;
  float* const PBt = me + Ly::PBT;
  float* const HG = me + Ly::HG;
  float* const a0 = me + Ly::A0;
  float* const a1 = me + Ly::A1;
  float* const ab = me + Ly::AB;
  const float* const hb = me + Ly::HBV;
  float* const E = me + Ly::E;
  float* const rb = me + Ly::RB;
  float* const ghb = me + Ly::GHB;

  for (int j = s - 1; j >= 0; --j) {
    tile.load_v(a_h, j, Ly::A0);
    tile.load_m(F_h, j, Ly::F0);
    tile.load_m(P_h, j, Ly::P0);
    __syncthreads();
    if (live) {
      const size_t ij = size_t(j) * C + c;
      const float v = real[ij];
      float yq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) yq[q] = y[cgt::vec_at<Q>(j, q, C, c)];

      // ---- recompute the forward intermediates ----
      // the oscillators' e (thread k for oscillator k)
      if (t < NB) {
        float gk[4], em[4], qq[3];
#pragma unroll
        for (int i = 0; i < 4; ++i) gk[i] = cst[Ly::CG + 4 * t + i];
        cgt::osc_core(gk, dt[ij], em, qq);
        const float g_v = gv[ij];
        E[4 * t + 0] = 1.f + g_v * em[0];
        E[4 * t + 1] = g_v * em[1];
        E[4 * t + 2] = g_v * em[2];
        E[4 * t + 3] = 1.f + g_v * em[3];
      }
      // BP = B P0 and G = B F0, element (oq, om)
      if (own) {
        float bp = 0.f, bf = 0.f;
        for (int i = 0; i < R; ++i) {
          bp += B[oq * R + i] * P0[i * LD + om];
          bf += B[oq * R + i] * F0[i * LD + om];
        }
        BP[oq * R + om] = bp;
        G[oq * R + om] = bf;
      }
      float resid[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float ba = 0.f;
        for (int k = 0; k < R; ++k) ba += B[q * R + k] * a0[k];
        resid[q] = yq[q] - ba;
      }
      __syncwarp();
      // S = Lambda + BP B^T, its factor, sr = S^{-1} resid, Si = S^{-1}:
      // in every thread
      float S[Q][Q], L[Q][Q], invd[Q], tv[Q], sr[Q], eye[Q][Q], tq[Q][Q],
          Si[Q][Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int p = 0; p < Q; ++p) {
          float acc = cst[Ly::CL + q * Q + p];
          for (int k = 0; k < R; ++k) acc += BP[q * R + k] * B[p * R + k];
          S[q][p] = acc;
        }
      cgt::chol<float, Q>(S, L, invd);
      cgt::solve_lower_vec<float, Q>(L, invd, resid, tv);
      cgt::solve_lower_t_vec<float, Q>(L, invd, tv, sr);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int p = 0; p < Q; ++p) eye[q][p] = (q == p) ? 1.f : 0.f;
      cgt::solve_lower<float, Q, Q>(L, invd, eye, tq);
      cgt::solve_lower_t<float, Q, Q>(L, invd, tq, Si);
      // the gains X = S^{-1} G (threads 0..R-1) and X2 = S^{-1} BP
      // (threads 16..16+R-1), one column each (K = X2^T)
      {
        const int m = t & 15;
        if (m < R) {
          const float* src = t < 16 ? G : BP;
          float* dst = t < 16 ? X : X2;
          float col[Q][1], tc[Q][1], xc[Q][1];
#pragma unroll
          for (int q = 0; q < Q; ++q) col[q][0] = src[q * R + m];
          cgt::solve_lower<float, Q, 1>(L, invd, col, tc);
          cgt::solve_lower_t<float, Q, 1>(L, invd, tc, xc);
#pragma unroll
          for (int q = 0; q < Q; ++q) dst[q * R + m] = xc[q][0];
        }
      }
      // a1 = a0 + v BP^T sr
      if (t < R) {
        float ai = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) ai += BP[q * R + t] * sr[q];
        a1[t] = a0[t] + v * ai;
      }
      __syncwarp();
      // W = e P1, P1 = P0 - v (P B^T) X2: per pair of rows (2k, 2k+1)
      // and column m
      for (int p = t; p < NB * R; p += 32) {
        const int k = p / R, m = p % R;
        const int r0 = 2 * k, r1 = 2 * k + 1;
        float pq0 = 0.f, pq1 = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) pq0 += BP[q * R + r0] * X2[q * R + m];
#pragma unroll
        for (int q = 0; q < Q; ++q) pq1 += BP[q * R + r1] * X2[q * R + m];
        const float w0 = P0[r0 * LD + m] - v * pq0;
        const float w1 = P0[r1 * LD + m] - v * pq1;
        W[r0 * LD + m] = E[4 * k + 0] * w0 + E[4 * k + 1] * w1;
        W[r1 * LD + m] = E[4 * k + 2] * w0 + E[4 * k + 3] * w1;
      }
      __syncwarp();

      // ---- predict adjoint: a' = e a1, F' = e F1, P' = e P1 e^T + Q ----
      // the e and Q cotangents of oscillator k = t / 4, entry t % 4
      if (t < 4 * NB) {
        const int k = t >> 2, x = (t >> 1) & 1, z = t & 1;
        const int ri = 2 * k + x, cj = 2 * k + z;
        // F1[cj][m] recomputed: F0[cj][m] - v (P B^T X)[cj][m]
        float acc = ab[ri] * a1[cj];
        for (int m = 0; m < R; ++m) {
          float fq = 0.f;
#pragma unroll
          for (int q = 0; q < Q; ++q) fq += BP[q * R + cj] * X[q * R + m];
          acc += Fb[ri * LD + m] * (F0[cj * LD + m] - v * fq) +
                 (Pb[ri * LD + m] + Pb[m * LD + ri]) * W[m * LD + cj];
        }
        const size_t o = (size_t(j) * NB + k) * 4 + (t & 3);
        ebar[o * C + c] = acc;
        qbar[o * C + c] = Pb[ri * LD + cj];
      }
      __syncwarp();
      // abar1 = e^T abar, Fbar1 = e^T Fbar, Pbar <- e^T Pbar (row mixes)
      for (int p = t; p < NB * R; p += 32) {
        const int k = p / R, m = p % R;
        const int r0 = 2 * k, r1 = 2 * k + 1;
        const float e00 = E[4 * k], e01 = E[4 * k + 1], e10 = E[4 * k + 2],
                    e11 = E[4 * k + 3];
        if (m == 0) {
          const float b0 = ab[r0], b1 = ab[r1];
          ab[r0] = e00 * b0 + e10 * b1;
          ab[r1] = e01 * b0 + e11 * b1;
        }
        const float f0 = Fb[r0 * LD + m], f1 = Fb[r1 * LD + m];
        Fb[r0 * LD + m] = e00 * f0 + e10 * f1;
        Fb[r1 * LD + m] = e01 * f0 + e11 * f1;
        const float p0 = Pb[r0 * LD + m], p1 = Pb[r1 * LD + m];
        Pb[r0 * LD + m] = e00 * p0 + e10 * p1;
        Pb[r1 * LD + m] = e01 * p0 + e11 * p1;
      }
      __syncwarp();
      // Pbar1 = (e^T Pbar) e (column mixes)
      for (int p = t; p < NB * R; p += 32) {
        const int k = p % NB, m = p / NB;
        const int r0 = 2 * k, r1 = 2 * k + 1;
        const float p0 = Pb[m * LD + r0], p1 = Pb[m * LD + r1];
        Pb[m * LD + r0] = p0 * E[4 * k] + p1 * E[4 * k + 2];
        Pb[m * LD + r1] = p0 * E[4 * k + 1] + p1 * E[4 * k + 3];
      }
      __syncwarp();

      // ---- update adjoint ----
      if (own) {
        // Kbar = v (abar1 resid^T - Fbar1 G^T - Pbar1 (P B^T))     [R][Q]
        // PBtbar = -v Pbar1^T K (+ Kbar Si below)                   [R][Q]
        // HG = Hb G^T                                              [R][Q]
        float fg = 0.f, pp = 0.f, pk = 0.f, hg = 0.f;
        for (int m = 0; m < R; ++m) {
          fg += Fb[oi * LD + m] * G[oqq * R + m];
          pp += Pb[oi * LD + m] * BP[oqq * R + m];
          pk += Pb[m * LD + oi] * X2[oqq * R + m];
        }
        for (int m = 0; m < R; ++m) hg += Hb[oi * LD + m] * G[oqq * R + m];
        Kb[oi * Q + oqq] = v * (ab[oi] * pick<Q>(resid, oqq) - fg - pp);
        PBt[oi * Q + oqq] = -v * pk;
        HG[oi * Q + oqq] = hg;
        // Gbar = v (-K^T Fbar1 + X (Hb + Hb^T) + sr hb^T)          [Q][R]
        float kf = 0.f, xh2 = 0.f;
        for (int i = 0; i < R; ++i) {
          kf += X2[oq * R + i] * Fb[i * LD + om];
          xh2 += X[oq * R + i] * (Hb[i * LD + om] + Hb[om * LD + i]);
        }
        Gb[oq * R + om] = v * (-kf + xh2 + pick<Q>(sr, oq) * hb[om]);
      }
      // rbar = v (K^T abar1 + X hb + 2 c0b sr), and G hb             [Q]
      if (t < Q) {
        float ka = 0.f, xh = 0.f, gh = 0.f;
        for (int i = 0; i < R; ++i) {
          ka += X2[t * R + i] * ab[i];
          xh += X[t * R + i] * hb[i];
          gh += G[t * R + i] * hb[i];
        }
        rb[t] = v * (ka + xh + 2.f * c0b * pick<Q>(sr, t));
        ghb[t] = gh;
      }
      __syncwarp();
      // Sibar = (P B^T)^T Kbar + v (G Hb G^T + (G hb) resid^T + c0b r r^T)
      // and Sbar = v ldb Si - Si Sibar Si: in every thread
      float Sibar[Q][Q], Sbar[Q][Q], ts[Q][Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int p = 0; p < Q; ++p) {
          float pk = 0.f, ghg = 0.f;
          for (int i = 0; i < R; ++i) {
            pk += BP[q * R + i] * Kb[i * Q + p];
            ghg += G[q * R + i] * HG[i * Q + p];
          }
          Sibar[q][p] = pk + v * (ghg + ghb[q] * resid[p] +
                                  c0b * resid[q] * resid[p]);
        }
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
          lacc[q][p] += Sbar[q][p];
        }
      if (own) {
        // PBtbar += Kbar Si
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < Q; ++p)
          acc += Kb[oi * Q + p] * pick_row<Q>(Si, oqq, p);
        PBt[oi * Q + oqq] += acc;
        // the B cotangent of this step (B P0 is BP), and Sbar B
        float bc = -rb[oq] * a0[om];
        for (int i = 0; i < R; ++i) bc += Gb[oq * R + i] * F0[om * LD + i];
#pragma unroll
        for (int p = 0; p < Q; ++p)
          bc += (pick_row<Q>(Sbar, oq, p) + pick_col<Q>(Sbar, p, oq)) *
                BP[p * R + om];
        bacc += bc;
        float sb = 0.f;
#pragma unroll
        for (int p = 0; p < Q; ++p)
          sb += pick_row<Q>(Sbar, oq, p) * B[p * R + om];
        SB[oq * R + om] = sb;
      }
      if (t < Q) ybar[cgt::vec_at<Q>(j, t, C, c)] = rb[t];
      __syncwarp();
      // PBtbar^T P0
      if (own) {
        float acc = 0.f;
        for (int i = 0; i < R; ++i)
          acc += PBt[i * Q + oq] * P0[i * LD + om];
        bacc += acc;
      }
      // the carry: abar = abar1 - B^T rbar, Fbar = Fbar1 + B^T Gbar,
      // Pbar = Pbar1 + PBtbar B + B^T Sbar B
      for (co::Cursor cu(w.w); cu.q < w.dd; cu.next(w.w)) {
        const int i = cu.i, m = cu.k;
        float fg = 0.f, pb = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          fg += B[q * R + i] * Gb[q * R + m];
          pb += PBt[i * Q + q] * B[q * R + m] + B[q * R + i] * SB[q * R + m];
        }
        Fb[i * LD + m] += fg;
        Pb[i * LD + m] += pb;
      }
      if (t < R) {
        float br = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) br += B[q * R + t] * rb[q];
        ab[t] -= br;
      }
    }
    __syncthreads();  // the next step's tile loads overwrite a0, F0, P0
  }
  if (live) {
    if (own) b_part[size_t(oq * R + om) * C + c] = bacc;
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int p = 0; p < Q; ++p)
          l_part[size_t(q * Q + p) * C + c] = lacc[q][p];
    }
  }
}

// nblocks 1..4 launch the thread-per-lane kernel, 5..8 the warp-per-lane
// one; `warp` forces the warp-per-lane kernel at every nblocks (the check
// that times the two designs against each other)
constexpr int WARP_NB = 5;

template <int NB, int Q>
int launch_nb(const float* gb, const float* b, const float* lam,
              const float* dt, const float* gv, const float* real,
              const float* y, const float* a_h, const float* F_h,
              const float* P_h, const float* Hb, const float* hb,
              const float* c0b, const float* ldb, const float* Fsb,
              const float* asb, const float* Psb, int s, int C, float* ebar,
              float* qbar, float* ybar, float* b_part, float* l_part,
              bool warp, cudaStream_t st) {
  if constexpr (NB < WARP_NB) {
    if (!warp) {
      celerite_filter_adjoint_thread_kernel<NB, Q>
          <<<(C + CGT_THREADS - 1) / CGT_THREADS, CGT_THREADS, 0, st>>>(
              gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb, hb, c0b, ldb,
              Fsb, asb, Psb, s, C, ebar, qbar, ybar, b_part, l_part);
      return int(cudaGetLastError());
    }
  }
  const size_t smem = Lay<NB, Q>::bytes();
  const cudaError_t err =
      co::prepare(celerite_filter_adjoint_kernel<NB, Q>, smem);
  if (err != cudaSuccess) return int(err);
  celerite_filter_adjoint_kernel<NB, Q>
      <<<co::grid_for<float>(C), Tile::THREADS, smem, st>>>(
          gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb, hb, c0b, ldb, Fsb,
          asb, Psb, s, C, ebar, qbar, ybar, b_part, l_part);
  return int(cudaGetLastError());
}

template <int Q>
int launch_adjoint(const float* gb, const float* b, const float* lam,
                   const float* dt, const float* gv, const float* real,
                   const float* y, const float* a_h, const float* F_h,
                   const float* P_h, const float* Hb, const float* hb,
                   const float* c0b, const float* ldb, const float* Fsb,
                   const float* asb, const float* Psb, int nb, int s, int C,
                   float* ebar, float* qbar, float* ybar, float* b_part,
                   float* l_part, bool warp, cudaStream_t st) {
#define CGT_LAUNCH(NB)                                                      \
  return launch_nb<NB, Q>(gb, b, lam, dt, gv, real, y, a_h, F_h, P_h, Hb,  \
                          hb, c0b, ldb, Fsb, asb, Psb, s, C, ebar, qbar,    \
                          ybar, b_part, l_part, warp, st)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaErrorInvalidValue);
}

template <int Q>
int smem_of(int nb) {
#define CGT_SIZE(NB) return int(Lay<NB, Q>::bytes())
  switch (nb) {
    case 1: CGT_SIZE(1);
    case 2: CGT_SIZE(2);
    case 3: CGT_SIZE(3);
    case 4: CGT_SIZE(4);
    case 5: CGT_SIZE(5);
    case 6: CGT_SIZE(6);
    case 7: CGT_SIZE(7);
    case 8: CGT_SIZE(8);
    default: return -1;
  }
#undef CGT_SIZE
}

}  // namespace

extern "C" {

#define CGT_ADJOINT_ENTRY(NAME, WARP)                                         \
  int NAME(const float* gb, const float* b, const float* lam,                \
           const float* dt, const float* gv, const float* real,              \
           const float* y, const float* a_h, const float* F_h,               \
           const float* P_h, const float* Hb, const float* hb,               \
           const float* c0b, const float* ldb, const float* Fsb,             \
           const float* asb, const float* Psb, int nb, int q, int s, int C,  \
           float* ebar, float* qbar, float* ybar, float* b_part,             \
           float* l_part, void* stream) {                                    \
    cudaStream_t st = (cudaStream_t)stream;                                  \
    if (q == 1)                                                               \
      return launch_adjoint<1>(gb, b, lam, dt, gv, real, y, a_h, F_h, P_h,   \
                               Hb, hb, c0b, ldb, Fsb, asb, Psb, nb, s, C,    \
                               ebar, qbar, ybar, b_part, l_part, WARP, st);  \
    if (q == 2)                                                               \
      return launch_adjoint<2>(gb, b, lam, dt, gv, real, y, a_h, F_h, P_h,   \
                               Hb, hb, c0b, ldb, Fsb, asb, Psb, nb, s, C,    \
                               ebar, qbar, ybar, b_part, l_part, WARP, st);  \
    return int(cudaErrorInvalidValue);                                        \
  }

// the routed design (by nblocks), and the warp-per-lane one at every
// nblocks
CGT_ADJOINT_ENTRY(cgt_celerite_filter_adjoint_f32, false)
CGT_ADJOINT_ENTRY(cgt_celerite_filter_adjoint_warp_f32, true)
#undef CGT_ADJOINT_ENTRY

// dynamic shared bytes per thread block (8 chunk lanes) of the warp-per-lane
// kernel at nblocks nb and obs_dim q, or -1 for a size that has no instance
int cgt_celerite_adjoint_smem_bytes(int nb, int q) {
  if (q == 1) return smem_of<1>(nb);
  if (q == 2) return smem_of<2>(nb);
  return -1;
}

}  // extern "C"
