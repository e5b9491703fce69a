// Chunk-parallel conditional Kalman filter of the celerite family, and its
// collect variant that also streams the per-step pre-update state for the
// analytic adjoint (celerite_adjoint.cu).
//
// Replaces (cyclic_gps_tpu/ops/celerite_pallas.py):
//   celerite_filter_kernel<.., false>, <- :479 celerite_filter_sweep_pallas
//   celerite_filter_warp_kernel           (kernel body _cel_filter_kernel,
//                                         :387)
//   celerite_filter_kernel<.., true>,  <- :592
//   celerite_filter_collect_warp_kernel   celerite_filter_collect_sweep_pallas
//                                         (_cel_filter_collect_kernel, :563)
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
// at R = 16, N = 1e6) and is bound by those bytes.
//
// Two designs:
// * ONE THREAD PER CHUNK LANE (celerite_filter_kernel): one thread walks
//   its chunk's s steps with the whole filter state carried between them,
//   so device memory sees each input once and the statistics (or the
//   history) once; the lane axis is innermost so every load and store
//   coalesces.  Both variants at nblocks 1..4, where the state fits in
//   registers and the warp designs lose to it (chip_smoke.py times the two
//   at nblocks 2 and 4).  At R = 16 the carried a, F, P, H, h (~800
//   floats) would live in local memory, and 7,813 threads (N = 1e6,
//   s = 128) fill under half the SMs.
// * ONE WARP PER CHUNK LANE at nblocks 5..8 (rtcoop.cuh's tiles; one body,
//   filter_warp, for celerite_filter_collect_warp_kernel and
//   celerite_filter_warp_kernel).  The lane's state sits in shared memory
//   as celerite_adjoint.cu's warp instance keeps it -- F and P twice (this
//   step's and the next one's), H, at the odd row stride R | 1; the Q x R
//   blocks B P, G and the gains X, X2; a twice and h; the oscillators' e
//   and Q -- ~6.4 KB per lane at R = 16, with B, Lambda and the
//   oscillators' blocks as constants of the thread block.  Per step one
//   barrier: after it the 8 lanes of the block load the next step's real,
//   dt, gv and y as whole 32-byte spans (and the collect variant stores
//   the step's pre-update a, F, P the same way, the bytes that bound it),
//   while each warp updates its lane, one output element per thread, into
//   the other copy of F, P and a: the rank-q update and e's row mix per
//   pair of rows (2k, 2k+1) and column, then e's column mix and + Q per
//   pair of columns and row.  S, its Cholesky and every q x q solve run in
//   every thread's registers (q <= 2).  Every sum keeps the thread kernel's
//   order, so the designs agree to rounding and the two warp kernels'
//   statistics agree bit for bit.  In the collect variant the barrier
//   spans a cluster of four thread blocks, the 32 lanes whose spans make
//   up each 128-byte line of the history, so that they write each line
//   within one step of each other, and more of the spans meet in L2
//   before a line is written back (on an H100 at nblocks 8, N = 1e6 the
//   kernel's time fell by about a fifth; chip_smoke.py times it).  Spans
//   stay the limit: a history laid out in whole lines per thread block,
//   read back by the adjoint, would take less.  The plain sweep (kernel
//   13) stores nothing per step, so its barrier is the block's, and it
//   keeps one copy of F, P and a, updated in place (~3.9 KB per lane at
//   R = 16): on an H100 the second copy made it slightly slower, not
//   faster.
#include <cooperative_groups.h>

#include "celerite.cuh"
#include "rtcoop.cuh"

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

namespace co = cgt::coop;
namespace cg = cooperative_groups;
using Tile = co::Tile<float>;

// The collect variant (kernel 14) and the plain sweep (kernel 13) run one
// warp per chunk lane from these nblocks up, one thread per lane below
// (celerite_cuda.COLLECT_WARP_NBLOCKS and FILTER_WARP_NBLOCKS).
constexpr int COLLECT_WARP_NB = 5;
constexpr int FILTER_WARP_NB = 5;

// thread blocks per cluster of the warp-per-lane collect kernel: their
// CLUSTER * 8 lanes make each 128-byte line of the history
constexpr int CLUSTER = 4;

// One lane's region in shared memory (offsets in floats) at nblocks NB,
// obs_dim Q: five R x ld blocks (F and P, each twice, and H), four Q x R
// blocks, three vectors of R (a twice, h), the oscillators' e (4 per
// oscillator) and Q (3), c0 and ld for the final store, and two slots of
// the step's inputs (real, dt, gv, y), one per step parity.  TWO = false
// (kernel 13) keeps one copy of F, P and a (F1 = F0, P1 = P0, A1 = A0):
// the step updates them in place.
template <int NB, int Q, bool TWO = true>
struct FLay {
  static constexpr int R = 2 * NB;
  static constexpr int LD = R | 1;
  static constexpr int BS = R * LD;
  static constexpr int QR = Q * R;
  static constexpr int NIN = 3 + Q;
  static constexpr int NC = TWO ? 2 : 1;  // copies of F, P and a
  static constexpr int F0 = 0, F1 = TWO ? BS : F0, P0 = NC * BS,
                       P1 = TWO ? 3 * BS : P0, H = 2 * NC * BS;
  static constexpr int BP = H + BS, G = BP + QR, X = G + QR, X2 = X + QR;
  static constexpr int A0 = X2 + QR, A1 = TWO ? A0 + R : A0,
                       HV = A0 + NC * R;
  static constexpr int E = HV + R, QN = E + 4 * NB, SC = QN + 3 * NB;
  static constexpr int IN = SC + 2;
  static constexpr int STRIDE = IN + 2 * NIN;
  // the block's constants after its LANES regions: B [Q][R], Lambda
  // [Q][Q], the oscillators' blocks of G [NB][4]
  static constexpr int CB = 0, CL = QR, CG = QR + Q * Q;
  static constexpr int CONSTS = CG + 4 * NB;
  static constexpr size_t bytes() {
    return (size_t(Tile::LANES) * STRIDE + CONSTS) * sizeof(float);
  }
};

// celerite_filter_kernel<NB, Q, COLLECT> as one warp per chunk lane: the
// body of both warp kernels below.  COLLECT stores each step's pre-update
// state after the step's barrier, a barrier over the thread block's
// cluster, while the step writes the next state into the second copy;
// without it the barrier is the block's and the state is updated in place
// (every element of F, P and a is read and written by one thread, after
// the __syncwarp that ends the step's reads of the whole blocks).
template <int NB, int Q, bool COLLECT>
__device__ __forceinline__ void filter_warp(
    const float* __restrict__ gb, const float* __restrict__ b_p,
    const float* __restrict__ lam_p, const float* __restrict__ dt,
    const float* __restrict__ gv, const float* __restrict__ real,
    const float* __restrict__ y, int s, int C, float* H_out, float* h_out,
    float* c0_out, float* ld_out, float* F_out, float* a_out, float* P_out,
    float* a_h, float* F_h, float* P_h) {
  using Ly = FLay<NB, Q, COLLECT>;
  constexpr int R = Ly::R, LD = Ly::LD, NIN = Ly::NIN;
  constexpr int L = Tile::LANES;
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  float* sm = reinterpret_cast<float*>(cgt_smem);
  float* const cst = sm + L * Ly::STRIDE;
  const co::Tiles<float> tile(sm, Ly::STRIDE, R, C);
  const co::Warp w(R);
  const int t = w.lane;
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * L + tl < C;
  float* const me = sm + tl * Ly::STRIDE;
  const float* const B = cst + Ly::CB;  // B[q][i] at q * R + i
  float* const H = me + Ly::H;
  float* const BP = me + Ly::BP;
  float* const G = me + Ly::G;
  float* const X = me + Ly::X;
  float* const X2 = me + Ly::X2;
  float* const h = me + Ly::HV;
  float* const E = me + Ly::E;
  float* const QN = me + Ly::QN;

  for (int q = int(threadIdx.x); q < Ly::CONSTS; q += Tile::THREADS)
    cst[q] = q < Ly::CL ? b_p[q]
             : q < Ly::CG ? lam_p[q - Ly::CL] : gb[q - Ly::CG];
  // the step inputs of the block's lanes, as 32-byte spans: the L threads
  // of group `in_f` fetch field in_f (real, dt, gv, then y's Q entries) of
  // lane in_l into the slot of the step's parity
  const int in_f = int(threadIdx.x) / L, in_l = int(threadIdx.x) % L;
  const int in_c = int(blockIdx.x) * L + in_l;
  const bool loader = in_f < NIN && in_c < C;
  const float* const in_src = in_f == 0 ? real : in_f == 1 ? dt
                              : in_f == 2 ? gv : y;
  auto load_in = [&](int j) {
    if (!loader) return;
    const size_t at = in_f < 3 ? size_t(j) * C + in_c
                               : cgt::vec_at<Q>(j, in_f - 3, C, in_c);
    sm[in_l * Ly::STRIDE + Ly::IN + (j & 1) * NIN + in_f] = in_src[at];
  };
  load_in(0);
  // a = 0, h = 0, F = I, P = 0, H = 0
  if (live) {
    for (co::Cursor cu(w.w); cu.q < w.dd; cu.next(w.w)) {
      const int o = cu.i * LD + cu.k;
      me[Ly::F0 + o] = cu.i == cu.k ? 1.f : 0.f;
      me[Ly::P0 + o] = 0.f;
      H[o] = 0.f;
    }
    if (t < R) {
      me[Ly::A0 + t] = 0.f;
      h[t] = 0.f;
    }
  }
  // thread t owns element (q, m) = (t / R, t % R) of the Q x R blocks
  const bool own = t < Ly::QR;
  const int oq = t / R, om = t % R;
  float c0 = 0.f, ld = 0.f;
  // this step's F, P, a and the next step's (swapped after each step)
  int of = Ly::F0, onf = Ly::F1, op = Ly::P0, onp = Ly::P1, oa = Ly::A0,
      ona = Ly::A1;

  for (int j = 0; j < s; ++j) {
    // step j-1's state and step j's inputs are in place; every read of
    // the blocks this step writes (step j-1's stores) is done; and (where
    // COLLECT) the cluster's blocks store step j's history together
    if constexpr (COLLECT) {
      cg::this_cluster().sync();
      tile.store_v(a_h, j, oa);  // the pre-update state of step j
      tile.store_m(F_h, j, of);
      tile.store_m(P_h, j, op);
    } else {
      __syncthreads();
    }
    if (j + 1 < s) load_in(j + 1);
    if (live) {
      const float* const in = me + Ly::IN + (j & 1) * NIN;
      const float v = in[0];
      const float* const F = me + of;
      const float* const P = me + op;
      const float* const a = me + oa;
      float* const Fn = me + onf;
      float* const Pn = me + onp;
      float* const an = me + ona;
      // the oscillators' e and Q through the following gap (thread k for
      // oscillator k)
      if (t < NB) {
        float gk[4], em[4], qq[3];
#pragma unroll
        for (int i = 0; i < 4; ++i) gk[i] = cst[Ly::CG + 4 * t + i];
        cgt::osc_core(gk, in[1], em, qq);
        const float g_v = in[2];
        E[4 * t + 0] = 1.f + g_v * em[0];
        E[4 * t + 1] = g_v * em[1];
        E[4 * t + 2] = g_v * em[2];
        E[4 * t + 3] = 1.f + g_v * em[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) QN[3 * t + i] = g_v * qq[i];
      }
      // ---- innovation update (masked by v; S >= Lambda always SPD) ----
      // BP = B P and G = B F, element (oq, om)
      if (own) {
        float bp = 0.f, bf = 0.f;
        for (int i = 0; i < R; ++i) {
          bp += B[oq * R + i] * P[i * LD + om];
          bf += B[oq * R + i] * F[i * LD + om];
        }
        BP[oq * R + om] = bp;
        G[oq * R + om] = bf;
      }
      float resid[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float ba = 0.f;
        for (int k = 0; k < R; ++k) ba += B[q * R + k] * a[k];
        resid[q] = in[3 + q] - ba;
      }
      __syncwarp();
      // S = Lambda + BP B^T, its factor and sr = S^{-1} resid: in every
      // thread
      float S[Q][Q], Lc[Q][Q], invd[Q], tv[Q], sr[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int p = 0; p < Q; ++p) {
          float acc = cst[Ly::CL + q * Q + p];
          for (int k = 0; k < R; ++k) acc += BP[q * R + k] * B[p * R + k];
          S[q][p] = acc;
        }
      const float ldh = cgt::chol<float, Q>(S, Lc, invd);
      cgt::solve_lower_vec<float, Q>(Lc, invd, resid, tv);
      cgt::solve_lower_t_vec<float, Q>(Lc, invd, tv, sr);
      // the gains X = S^{-1} G (threads 0..R-1) and X2 = S^{-1} BP
      // (threads 16..16+R-1), one column each
      {
        const int m = t & 15;
        if (m < R) {
          const float* src = t < 16 ? G : BP;
          float* dst = t < 16 ? X : X2;
          float col[Q][1], tc[Q][1], xc[Q][1];
#pragma unroll
          for (int q = 0; q < Q; ++q) col[q][0] = src[q * R + m];
          cgt::solve_lower<float, Q, 1>(Lc, invd, col, tc);
          cgt::solve_lower_t<float, Q, 1>(Lc, invd, tc, xc);
#pragma unroll
          for (int q = 0; q < Q; ++q) dst[q * R + m] = xc[q][0];
        }
      }
      // h += v G^T sr (thread i for row i)
      if (t < R) {
        float hi = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) hi += G[q * R + t] * sr[q];
        h[t] += v * hi;
      }
      float rs = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) rs += resid[q] * sr[q];
      c0 += v * rs;
      ld += v * 2.f * ldh;
      __syncwarp();
      // H += v G^T X, element (i, k)
      for (co::Cursor cu(w.w); cu.q < w.dd; cu.next(w.w)) {
        const int i = cu.i, k = cu.k;
        float hq = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) hq += G[q * R + i] * X[q * R + k];
        H[i * LD + k] += v * hq;
      }
      // F1 = F - v BP^T X and P1 = P - v BP^T X2 (BP^T = P B^T, P
      // symmetric), then the predict's row mixes e F1 and e P1 into the
      // next copies: per pair of rows (2k, 2k+1) and column m
      for (int p = t; p < NB * R; p += 32) {
        const int k = p / R, m = p % R;
        const int r0 = 2 * k, r1 = 2 * k + 1;
        const float e00 = E[4 * k], e01 = E[4 * k + 1], e10 = E[4 * k + 2],
                    e11 = E[4 * k + 3];
        float fq0 = 0.f, fq1 = 0.f, pq0 = 0.f, pq1 = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          fq0 += BP[q * R + r0] * X[q * R + m];
          pq0 += BP[q * R + r0] * X2[q * R + m];
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          fq1 += BP[q * R + r1] * X[q * R + m];
          pq1 += BP[q * R + r1] * X2[q * R + m];
        }
        const float f0 = F[r0 * LD + m] - v * fq0;
        const float f1 = F[r1 * LD + m] - v * fq1;
        Fn[r0 * LD + m] = e00 * f0 + e01 * f1;
        Fn[r1 * LD + m] = e10 * f0 + e11 * f1;
        const float p0 = P[r0 * LD + m] - v * pq0;
        const float p1 = P[r1 * LD + m] - v * pq1;
        Pn[r0 * LD + m] = e00 * p0 + e01 * p1;
        Pn[r1 * LD + m] = e10 * p0 + e11 * p1;
      }
      // a1 = a + v BP^T sr, then e a1 (thread k for pair k)
      if (t < NB) {
        const int r0 = 2 * t, r1 = 2 * t + 1;
        float ai0 = 0.f, ai1 = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          ai0 += BP[q * R + r0] * sr[q];
          ai1 += BP[q * R + r1] * sr[q];
        }
        const float a0 = a[r0] + v * ai0, a1 = a[r1] + v * ai1;
        an[r0] = E[4 * t] * a0 + E[4 * t + 1] * a1;
        an[r1] = E[4 * t + 2] * a0 + E[4 * t + 3] * a1;
      }
      __syncwarp();
      // (e P1) e^T, then + Q on the diagonal blocks: per pair of columns
      // (2k, 2k+1) and row m
      for (int p = t; p < NB * R; p += 32) {
        const int k = p % NB, m = p / NB;
        const int r0 = 2 * k, r1 = 2 * k + 1;
        const float p0 = Pn[m * LD + r0], p1 = Pn[m * LD + r1];
        float n0 = p0 * E[4 * k] + p1 * E[4 * k + 1];
        float n1 = p0 * E[4 * k + 2] + p1 * E[4 * k + 3];
        if (m == r0) {
          n0 += QN[3 * k];
          n1 += QN[3 * k + 1];
        } else if (m == r1) {
          n0 += QN[3 * k + 1];
          n1 += QN[3 * k + 2];
        }
        Pn[m * LD + r0] = n0;
        Pn[m * LD + r1] = n1;
      }
    }
    // the next copies become this step's (one copy where !COLLECT: no-op)
    const int tf = of, tp = op, ta = oa;
    of = onf;
    onf = tf;
    op = onp;
    onp = tp;
    oa = ona;
    ona = ta;
  }
  if (live && t == 0) {
    me[Ly::SC] = c0;
    me[Ly::SC + 1] = ld;
  }
  __syncthreads();
  tile.store_m(H_out, 0, Ly::H);
  tile.store_v(h_out, 0, Ly::HV);
  tile.store_s(c0_out, 0, Ly::SC);
  tile.store_s(ld_out, 0, Ly::SC + 1);
  tile.store_m(F_out, 0, of);
  tile.store_v(a_out, 0, oa);
  tile.store_m(P_out, 0, op);
}

// kernel 14 at nblocks COLLECT_WARP_NB..8, its thread blocks in step by
// clusters of CLUSTER
template <int NB, int Q>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
celerite_filter_collect_warp_kernel(
    const float* __restrict__ gb, const float* __restrict__ b_p,
    const float* __restrict__ lam_p, const float* __restrict__ dt,
    const float* __restrict__ gv, const float* __restrict__ real,
    const float* __restrict__ y, int s, int C, float* H_out, float* h_out,
    float* c0_out, float* ld_out, float* F_out, float* a_out, float* P_out,
    float* a_h, float* F_h, float* P_h) {
  filter_warp<NB, Q, true>(gb, b_p, lam_p, dt, gv, real, y, s, C, H_out,
                           h_out, c0_out, ld_out, F_out, a_out, P_out, a_h,
                           F_h, P_h);
}

// kernel 13 at nblocks FILTER_WARP_NB..8: kernel 14's warp kernel without
// the history, so without the cluster
template <int NB, int Q>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
celerite_filter_warp_kernel(
    const float* __restrict__ gb, const float* __restrict__ b_p,
    const float* __restrict__ lam_p, const float* __restrict__ dt,
    const float* __restrict__ gv, const float* __restrict__ real,
    const float* __restrict__ y, int s, int C, float* H_out, float* h_out,
    float* c0_out, float* ld_out, float* F_out, float* a_out,
    float* P_out) {
  filter_warp<NB, Q, false>(gb, b_p, lam_p, dt, gv, real, y, s, C, H_out,
                            h_out, c0_out, ld_out, F_out, a_out, P_out,
                            nullptr, nullptr, nullptr);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

// kernel 13 at nblocks NB: the warp-per-lane kernel where `warp`, else the
// thread-per-lane one, which has no instance from FILTER_WARP_NB up
template <int NB, int Q>
int launch_filter_nb(const float* gb, const float* b, const float* lam,
                     const float* dt, const float* gv, const float* real,
                     const float* y, int s, int C, float* H, float* h,
                     float* c0, float* ld, float* F, float* a, float* P,
                     bool warp, cudaStream_t st) {
  if (!warp) {
    if constexpr (NB < FILTER_WARP_NB) {
      celerite_filter_kernel<NB, Q, false>
          <<<blocks_for(C), CGT_THREADS, 0, st>>>(gb, b, lam, dt, gv, real, y,
                                                  s, C, H, h, c0, ld, F, a, P,
                                                  nullptr, nullptr, nullptr);
      return int(cudaGetLastError());
    }
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = FLay<NB, Q, false>::bytes();
  const cudaError_t err =
      co::prepare(celerite_filter_warp_kernel<NB, Q>, smem);
  if (err != cudaSuccess) return int(err);
  celerite_filter_warp_kernel<NB, Q>
      <<<co::grid_for<float>(C), Tile::THREADS, smem, st>>>(
          gb, b, lam, dt, gv, real, y, s, C, H, h, c0, ld, F, a, P);
  return int(cudaGetLastError());
}

template <int Q>
int launch_filter(const float* gb, const float* b, const float* lam,
                  const float* dt, const float* gv, const float* real,
                  const float* y, int nb, int s, int C, float* H, float* h,
                  float* c0, float* ld, float* F, float* a, float* P,
                  bool warp, cudaStream_t st) {
#define CGT_LAUNCH(NB)                                                      \
  return launch_filter_nb<NB, Q>(gb, b, lam, dt, gv, real, y, s, C, H, h, \
                                 c0, ld, F, a, P, warp, st)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaErrorInvalidValue);
}

// kernel 14 at nblocks NB: the warp-per-lane kernel where `warp`, else the
// thread-per-lane one, which has no instance from COLLECT_WARP_NB up
template <int NB, int Q>
int launch_collect_nb(const float* gb, const float* b, const float* lam,
                      const float* dt, const float* gv, const float* real,
                      const float* y, int s, int C, float* H, float* h,
                      float* c0, float* ld, float* F, float* a, float* P,
                      float* a_h, float* F_h, float* P_h, bool warp,
                      cudaStream_t st) {
  if (!warp) {
    if constexpr (NB < COLLECT_WARP_NB) {
      celerite_filter_kernel<NB, Q, true>
          <<<blocks_for(C), CGT_THREADS, 0, st>>>(gb, b, lam, dt, gv, real, y,
                                                  s, C, H, h, c0, ld, F, a, P,
                                                  a_h, F_h, P_h);
      return int(cudaGetLastError());
    }
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = FLay<NB, Q>::bytes();
  const cudaError_t err =
      co::prepare(celerite_filter_collect_warp_kernel<NB, Q>, smem);
  if (err != cudaSuccess) return int(err);
  const int grid = (co::grid_for<float>(C) + CLUSTER - 1) / CLUSTER * CLUSTER;
  celerite_filter_collect_warp_kernel<NB, Q>
      <<<grid, Tile::THREADS, smem, st>>>(
          gb, b, lam, dt, gv, real, y, s, C, H, h, c0, ld, F, a, P, a_h, F_h,
          P_h);
  return int(cudaGetLastError());
}

template <int Q>
int launch_collect(const float* gb, const float* b, const float* lam,
                   const float* dt, const float* gv, const float* real,
                   const float* y, int nb, int s, int C, float* H, float* h,
                   float* c0, float* ld, float* F, float* a, float* P,
                   float* a_h, float* F_h, float* P_h, bool warp,
                   cudaStream_t st) {
#define CGT_LAUNCH(NB)                                                       \
  return launch_collect_nb<NB, Q>(gb, b, lam, dt, gv, real, y, s, C, H, h,  \
                                  c0, ld, F, a, P, a_h, F_h, P_h, warp, st)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaErrorInvalidValue);
}

template <int Q, bool TWO>
int smem_of(int nb) {
#define CGT_SIZE(NB) return int(FLay<NB, Q, TWO>::bytes())
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

// kernel 13: the chunk statistics, one warp per chunk lane where warp is 1
// (any nblocks), one thread per lane where it is 0 (nblocks 1..4 only: the
// caller routes)
int cgt_celerite_filter_f32(const float* gb, const float* b, const float* lam,
                            const float* dt, const float* gv,
                            const float* real, const float* y, int nb, int q,
                            int s, int C, float* H, float* h, float* c0,
                            float* ld, float* F, float* a, float* P, int warp,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q == 1)
    return launch_filter<1>(gb, b, lam, dt, gv, real, y, nb, s, C, H, h, c0,
                            ld, F, a, P, warp != 0, st);
  if (q == 2)
    return launch_filter<2>(gb, b, lam, dt, gv, real, y, nb, s, C, H, h, c0,
                            ld, F, a, P, warp != 0, st);
  return int(cudaErrorInvalidValue);
}

// kernel 14: the statistics and the per-step history (a_h, F_h, P_h), one
// warp per chunk lane where warp is 1 (any nblocks), one thread per lane
// where it is 0 (nblocks 1..4 only: the caller routes)
int cgt_celerite_filter_collect_f32(const float* gb, const float* b,
                                    const float* lam, const float* dt,
                                    const float* gv, const float* real,
                                    const float* y, int nb, int q, int s,
                                    int C, float* H, float* h, float* c0,
                                    float* ld, float* F, float* a, float* P,
                                    float* a_h, float* F_h, float* P_h,
                                    int warp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q == 1)
    return launch_collect<1>(gb, b, lam, dt, gv, real, y, nb, s, C, H, h, c0,
                             ld, F, a, P, a_h, F_h, P_h, warp != 0, st);
  if (q == 2)
    return launch_collect<2>(gb, b, lam, dt, gv, real, y, nb, s, C, H, h, c0,
                             ld, F, a, P, a_h, F_h, P_h, warp != 0, st);
  return int(cudaErrorInvalidValue);
}

// dynamic shared bytes per thread block (8 chunk lanes) of kernel 14's
// warp-per-lane instance at nblocks nb and obs_dim q, or -1 for a size
// that has no instance
int cgt_celerite_collect_smem_bytes(int nb, int q) {
  if (q == 1) return smem_of<1, true>(nb);
  if (q == 2) return smem_of<2, true>(nb);
  return -1;
}

// the same for kernel 13's warp-per-lane instance (one copy of F, P, a)
int cgt_celerite_filter_smem_bytes(int nb, int q) {
  if (q == 1) return smem_of<1, false>(nb);
  if (q == 2) return smem_of<2, false>(nb);
  return -1;
}

}  // extern "C"
