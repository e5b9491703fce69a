// Mega-fused celerite likelihood sweep: each chunk interior row's precision
// blocks are built from its gap width in closed form (2 x 2 oscillator
// algebra, celerite.cuh) and eliminated in place -- the posterior-precision
// system K never reaches device memory.
//
// Replaces: cyclic_gps_tpu/ops/celerite_pallas.py:285
// celerite_gap_mahal_sweep_pallas (kernel body _cel_sweep_kernel, :232, row
// terms _cel_row_terms, :183).  It is the celerite twin of
// gap_mahal_sweep_kernel (gap_emission.cu): the same walk, with the Pade
// gap emission replaced by the closed forms.
//
// What bounds it on the H100: per row the closed forms cost ~60 flops per
// oscillator, but the elimination works on dense R x R blocks (R = 2
// nblocks): a Cholesky, three triangular solves and four products, ~8 R^3
// flops, against 3 floats of gap input and R of right-hand side.  So it is
// bound by operations; with one thread per chunk lane (C = N/s = 7,813
// threads at N = 1e6, s = 128: ~61 blocks of 128 for 132 SMs) it is latency-
// and occupancy-bound well before that.  At R = 16 the carried state (C_j,
// W0_j, the accumulators, the next row's d_left) is ~1,500 floats per
// thread, far past 255 registers: it lives in local memory.
//
// What the simple design does about it: every row is built where it is
// used, so device memory sees only dt, the validity masks and v in and the
// chunk's final state out; the lane axis is innermost so loads and stores
// coalesce.  Exploiting the block-diagonal structure of the gap terms inside
// the elimination, or spreading a chunk over a warp, is later work.
#include "celerite.cuh"

namespace {

// Gap terms of one row from its gap width, valid-masked by gv (the
// closed-form twin of cgt::gap_row_terms):
//   off     = -Q1^{-1} e
//   d_left  = Q1^{-1} - I
//   d_right = e^T Q1^{-1} e = -e^T off   (symmetrised)
// Q1^{-1} by the 2 x 2 adjugate; returns the gap's log|Q1| (times gv).
template <int NB>
__device__ __forceinline__ float cel_row_terms(
    const float (&g)[NB][4], float dt, float gv,
    float (&d_left)[2 * NB][2 * NB], float (&d_right)[2 * NB][2 * NB],
    float (&off)[2 * NB][2 * NB]) {
  constexpr int R = 2 * NB;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      d_left[i][k] = 0.f;
      d_right[i][k] = 0.f;
      off[i][k] = 0.f;
    }
  float lq = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float em[4], q[3];
    cgt::osc_core(g[k], dt, em, q);
    const float e00 = 1.f + em[0], e01 = em[1], e10 = em[2];
    const float e11 = 1.f + em[3];
    const float det = q[0] * q[2] - q[1] * q[1];
    const float inv_det = 1.f / det;
    const float i00 = q[2] * inv_det, i01 = -q[1] * inv_det;
    const float i11 = q[0] * inv_det;
    const float o00 = -(i00 * e00 + i01 * e10) * gv;
    const float o01 = -(i00 * e01 + i01 * e11) * gv;
    const float o10 = -(i01 * e00 + i11 * e10) * gv;
    const float o11 = -(i01 * e01 + i11 * e11) * gv;
    const float dr00 = -(e00 * o00 + e10 * o10);
    const float dr01 = -(e00 * o01 + e10 * o11);
    const float dr10 = -(e01 * o00 + e11 * o10);
    const float dr11 = -(e01 * o01 + e11 * o11);
    const int a = 2 * k, b = 2 * k + 1;
    off[a][a] = o00;
    off[a][b] = o01;
    off[b][a] = o10;
    off[b][b] = o11;
    d_left[a][a] = (i00 - 1.f) * gv;
    d_left[a][b] = i01 * gv;
    d_left[b][a] = i01 * gv;
    d_left[b][b] = (i11 - 1.f) * gv;
    d_right[a][a] = dr00 * gv;
    d_right[a][b] = 0.5f * (dr01 + dr10) * gv;
    d_right[b][a] = d_right[a][b];
    d_right[b][b] = dr11 * gv;
    lq += logf(det);
  }
  return lq * gv;
}

// K row j = I + d_left(gap j-1) + d_right(gap j) + boost * is_real(j)
template <int R>
__device__ __forceinline__ void k_row(const float (&d_left_prev)[R][R],
                                      const float (&d_right)[R][R],
                                      const float (&boost)[R][R], float real,
                                      float (&k)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c)
      k[i][c] = ((i == c) ? 1.f : 0.f) + d_left_prev[i][c] + d_right[i][c] +
                boost[i][c] * real;
}

// Iteration j = -1 builds gap 0 (the chunk-boundary row 0, streamed OUT as
// k0, and the left coupling); iteration j >= 0 builds gap j+1 and
// eliminates row j+1 in place.
template <int NB>
__global__ void __launch_bounds__(CGT_THREADS)
celerite_gap_mahal_sweep_kernel(const float* __restrict__ gb,
                                const float* __restrict__ boost_p,
                                const float* __restrict__ dt,
                                const float* __restrict__ gv,
                                const float* __restrict__ real,
                                const float* __restrict__ wrap,
                                const float* __restrict__ ym, int s, int C,
                                float* acc00, float* accy0, float* w0l,
                                float* wl, float* dl, float* invdl, float* mh,
                                float* ld, float* lq_out, float* k0_out,
                                float* olast_out) {
  constexpr int R = 2 * NB;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g[NB][4];
  cgt::load_osc<NB>(gb, g);
  float boost[R][R], d_left[R][R], o_left[R][R];
  cgt::load_dense<float, R>(boost_p, boost);
  cgt::SweepCarry<float, R> st;
  float lq_sum = 0.f;
  for (int j = -1; j < s - 1; ++j) {
    const size_t ij = size_t(j + 1) * C + c;  // gap j+1
    float dl_n[R][R], dr[R][R], off[R][R], k[R][R];
    lq_sum += cel_row_terms<NB>(g, dt[ij], gv[ij], dl_n, dr, off);
    if (j < 0) {
      float wr[R][R];
      cgt::load_mat<float, R>(wrap, 0, C, c, wr);
      k_row<R>(wr, dr, boost, real[ij], k);
      cgt::store_mat<float, R>(k0_out, 0, C, c, k);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int b = 0; b < R; ++b) o_left[i][b] = off[i][b];
    } else {
      float y_j[R];
      k_row<R>(d_left, dr, boost, real[ij], k);
      cgt::load_vec<float, R>(ym, j + 1, C, c, y_j);
      cgt::elim_step<float, R>(j == 0, k, off, y_j, o_left, st);
      if (j == s - 2) cgt::store_mat<float, R>(olast_out, 0, C, c, off);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b) d_left[i][b] = dl_n[i][b];
  }
  cgt::store_sweep_state<float, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                                   mh, ld);
  lq_out[c] = lq_sum;
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

}  // namespace

extern "C" {

int cgt_celerite_gap_mahal_sweep_f32(
    const float* gb, const float* boost, const float* dt, const float* gv,
    const float* real, const float* wrap, const float* y, int nb, int s,
    int C, float* acc00, float* accy0, float* w0l, float* wl, float* dl,
    float* invdl, float* mh, float* ld, float* lq, float* k0, float* olast,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(NB)                                                      \
  celerite_gap_mahal_sweep_kernel<NB><<<blocks_for(C), CGT_THREADS, 0, st>>>( \
      gb, boost, dt, gv, real, wrap, y, s, C, acc00, accy0, w0l, wl, dl,     \
      invdl, mh, ld, lq, k0, olast)
  CGT_NB_SWITCH(nb, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // extern "C"
