// LEG gap emission kernels: gap widths -> the PEG transition and noise
// blocks, the chunk-major posterior-precision (K) system, and the K system
// fused into its forward elimination.  All three share one body of math
// (blockmath.cuh): structured Pade-7 (e, Q1), the Cholesky of Q1 with the
// push-through precision terms, and (kernel 4) one elimination step.
//
// Replaces (cyclic_gps_tpu/ops/expm_pallas.py):
//   transition_and_noise_kernel  <- :297 transition_and_noise_pallas
//                                   (kernel body _tn_kernel, :279)
//   k_system_kernel              <- :530 k_system_pallas (_ksys_kernel, :482)
//   gap_mahal_sweep_kernel       <- :769 gap_mahal_sweep_pallas
//                                   (_gap_sweep_kernel, :708)
//
// What bounds them on the H100: arithmetic per byte is high (a rank-5 gap
// costs ~25 small matrix products, two LU solves and a Cholesky, against 4
// bytes of input), so none is bandwidth-bound.  transition_and_noise runs
// one thread per gap and is bound by per-thread instruction latency and the
// registers the Pade temporaries take (spills to local memory grow with R).
// k_system and gap_mahal_sweep run one thread per chunk lane c, walking the
// chunk's s gaps in order with the d_left neighbour carry (and, fused, the
// elimination carry) in registers: with C = N/s lanes (7,813 at N = 1e6,
// s = 128) they fill under half of the 132 SMs, so they are latency- and
// occupancy-bound.
//
// What the simple design does about it: every gap is built where it is
// used, so device memory sees only dt (and v) in and the outputs out --
// the fused kernel never writes K at all; the lane axis is innermost so
// loads and stores coalesce; the squaring loop runs each lane's own count
// instead of a batch-wide masked maximum; and tn_math is compiled once per
// rank and shared by the three kernels.  Splitting a chunk across threads
// to fill the card is later work.
#include "blockmath.cuh"

namespace {

using cgt::Generator;

template <int R>
__global__ void __launch_bounds__(CGT_THREADS)
transition_and_noise_kernel(const float* __restrict__ g,
                            const float* __restrict__ diffs, int M,
                            float* e_out, float* q_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  Generator<R> gen;
  cgt::load_generator<R>(g, gen);
  float e[R][R], q[R][R];
  cgt::tn_math<R>(gen, diffs[m], e, q);
  cgt::store_mat<float, R>(e_out, 0, M, m, e);
  cgt::store_mat<float, R>(q_out, 0, M, m, q);
}

// K row j = I + d_left(gap j-1) + d_right(gap j) + boost * is_real(j);
// row 0's d_left comes from the previous chunk's last gap (``wrap``).
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

template <int R>
__global__ void __launch_bounds__(CGT_THREADS)
k_system_kernel(const float* __restrict__ g, const float* __restrict__ boost_p,
                const float* __restrict__ dt, const float* __restrict__ gv,
                const float* __restrict__ real, const float* __restrict__ wrap,
                int s, int C, float* k_out, float* off_out, float* lq_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Generator<R> gen;
  cgt::load_generator<R>(g, gen);
  float boost[R][R], d_left[R][R];
  cgt::load_dense<float, R>(boost_p, boost);
  cgt::load_mat<float, R>(wrap, 0, C, c, d_left);
  for (int j = 0; j < s; ++j) {
    const size_t ij = size_t(j) * C + c;
    float dl_n[R][R], dr[R][R], off[R][R], k[R][R];
    const float lq = cgt::gap_row_terms<R>(gen, dt[ij], gv[ij], dl_n, dr, off);
    k_row<R>(d_left, dr, boost, real[ij], k);
    cgt::store_mat<float, R>(k_out, j, C, c, k);
    cgt::store_mat<float, R>(off_out, j, C, c, off);
    lq_out[ij] = lq;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b) d_left[i][b] = dl_n[i][b];
  }
}

// Kernel 3 fused into the forward sweep: iteration j = -1 builds gap 0
// (the chunk-boundary row 0, streamed OUT as k0, and the left coupling);
// iteration j >= 0 builds gap j+1 and eliminates row j+1 in place.  K never
// reaches device memory.
template <int R>
__global__ void __launch_bounds__(CGT_THREADS)
gap_mahal_sweep_kernel(const float* __restrict__ g,
                       const float* __restrict__ boost_p,
                       const float* __restrict__ dt,
                       const float* __restrict__ gv,
                       const float* __restrict__ real,
                       const float* __restrict__ wrap,
                       const float* __restrict__ ym, int s, int C,
                       float* acc00, float* accy0, float* w0l, float* wl,
                       float* dl, float* invdl, float* mh, float* ld,
                       float* lq_out, float* k0_out, float* olast_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Generator<R> gen;
  cgt::load_generator<R>(g, gen);
  float boost[R][R], d_left[R][R], o_left[R][R];
  cgt::load_dense<float, R>(boost_p, boost);
  cgt::SweepCarry<float, R> st;
  float lq_sum = 0.f;
  for (int j = -1; j < s - 1; ++j) {
    const size_t ij = size_t(j + 1) * C + c;  // gap j+1
    float dl_n[R][R], dr[R][R], off[R][R], k[R][R];
    lq_sum += cgt::gap_row_terms<R>(gen, dt[ij], gv[ij], dl_n, dr, off);
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

int cgt_transition_and_noise_f32(const float* g, const float* diffs, int r,
                                 int M, float* e, float* q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                    \
  transition_and_noise_kernel<RR><<<blocks_for(M), CGT_THREADS, 0, st>>>( \
      g, diffs, M, e, q)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

int cgt_k_system_f32(const float* g, const float* boost, const float* dt,
                     const float* gv, const float* real, const float* wrap,
                     int r, int s, int C, float* k, float* off, float* lq,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                   \
  k_system_kernel<RR><<<blocks_for(C), CGT_THREADS, 0, st>>>(            \
      g, boost, dt, gv, real, wrap, s, C, k, off, lq)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

int cgt_gap_mahal_sweep_f32(const float* g, const float* boost,
                            const float* dt, const float* gv,
                            const float* real, const float* wrap,
                            const float* y, int r, int s, int C, float* acc00,
                            float* accy0, float* w0l, float* wl, float* dl,
                            float* invdl, float* mh, float* ld, float* lq,
                            float* k0, float* olast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                      \
  gap_mahal_sweep_kernel<RR><<<blocks_for(C), CGT_THREADS, 0, st>>>(        \
      g, boost, dt, gv, real, wrap, y, s, C, acc00, accy0, w0l, wl, dl,     \
      invdl, mh, ld, lq, k0, olast)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // extern "C"
