// Forward sweep of the partitioned block-Thomas engine: eliminates every
// chunk interior of a chunk-major SPD block-tridiagonal system and keeps
// nothing but each chunk's final state.
//
// Replaces: cyclic_gps_tpu/ops/pallas_sweep.py:248 forward_sweep_pallas
// (kernel body _sweep_kernel, pallas_sweep.py:163).
//
// What bounds it on the H100: one thread owns one chunk lane c and walks
// its s-1 interior rows in order, so the launch has only C = N/s threads
// (7,813 at N = 1e6, s = 128: ~61 blocks of 128 for 132 SMs).  At that size
// the kernel is latency- and occupancy-bound -- each step is a dependent
// chain of an R x R Cholesky, triangular solves and products -- not
// bandwidth-bound: it reads R_cm, O_cm, y_cm once (2 R^2 + R floats per
// row) and writes O(R^2) floats per lane.
//
// What the simple design does about it: the carried state (C_j, W0_j, w_j
// and the two accumulators) stays in registers for the whole walk, so
// device memory sees each input row exactly once, and the chunk-major
// layout puts the lane axis innermost so every thread's loads coalesce
// with its neighbours' without a transpose.  Spreading one chunk over
// several threads, or more chunks per SM, is later work.
//
// Instantiated for block sizes 1..8 and 16 (the celerite family's boundary
// chain at nblocks = 8); at 16 the carried state lives in local memory and
// the block products run as rolled loops (blockmath.cuh, CGT_UNROLL_MAX).
#include "blockmath.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
forward_sweep_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                     const T* __restrict__ ym, T jitter, int s, int C,
                     T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                     T* mh, T* ld, T* ld_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  cgt::SweepCarry<T, R> st;
  T o_left[R][R];
  cgt::load_mat<T, R>(Om, 0, C, c, o_left);
  for (int j = 1; j < s; ++j) {
    T P[R][R], o_j[R][R], y_j[R];
    cgt::load_mat<T, R>(Rm, j, C, c, P);
#pragma unroll
    for (int i = 0; i < R; ++i) P[i][i] += jitter;
    cgt::load_mat<T, R>(Om, j, C, c, o_j);
    cgt::load_vec<T, R>(ym, j, C, c, y_j);
    const T ldl = cgt::elim_step<T, R>(j == 1, P, o_j, y_j, o_left, st);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;
  }
  cgt::store_sweep_state<T, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                               mh, ld);
}

template <typename T>
int launch_forward_sweep(const T* R_cm, const T* O_cm, const T* y_cm,
                         T jitter, int s, int d, int C, T* acc00, T* accy0,
                         T* w0l, T* wl, T* dl, T* invdl, T* mh, T* ld,
                         T* ld_rows, cudaStream_t stream) {
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
#define CGT_LAUNCH(RR)                                                      \
  forward_sweep_kernel<T, RR><<<blocks, CGT_THREADS, 0, stream>>>(          \
      R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, mh, \
      ld, ld_rows)
  CGT_RANK_SWITCH_16(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_forward_sweep_f32(const float* R_cm, const float* O_cm,
                          const float* y_cm, float jitter, int s, int d,
                          int C, float* acc00, float* accy0, float* w0l,
                          float* wl, float* dl, float* invdl, float* mh,
                          float* ld, float* ld_rows, void* stream) {
  return launch_forward_sweep<float>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                     accy0, w0l, wl, dl, invdl, mh, ld,
                                     ld_rows, (cudaStream_t)stream);
}

int cgt_forward_sweep_f64(const double* R_cm, const double* O_cm,
                          const double* y_cm, double jitter, int s, int d,
                          int C, double* acc00, double* accy0, double* w0l,
                          double* wl, double* dl, double* invdl, double* mh,
                          double* ld, double* ld_rows, void* stream) {
  return launch_forward_sweep<double>(R_cm, O_cm, y_cm, jitter, s, d, C,
                                      acc00, accy0, w0l, wl, dl, invdl, mh,
                                      ld, ld_rows, (cudaStream_t)stream);
}

}  // extern "C"
