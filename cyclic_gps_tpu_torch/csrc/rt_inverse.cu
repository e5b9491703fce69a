// The two kernels of the selected inversion (the diagonal and lag-1 blocks
// of J^{-1}) at block sizes d = 9..15, with d a runtime argument, on the
// chunk-major layout.
//
// Replaces (cyclic_gps_tpu/ops/pallas_wide.py):
//   rt_inverse_sweep_kernel <- :641 forward_sweep_inverse_wide_pallas
//                              (kernel body _wide_inverse_collect_kernel,
//                              :558)
//   rt_takahashi_kernel     <- :812 takahashi_backward_wide_pallas
//                              (_wide_takahashi_kernel, :717)
// and stands for the plain Pallas kernels they are the wide twins of,
// pallas_sweep.py:534 forward_sweep_inverse_pallas and :648
// takahashi_backward_pallas (kernels 10 and 11, inverse_sweep.cu at
// d <= 8), at d = 9..15: the same boundary, the same raw factors and
// recursion, the same pivot rule.
//
// The TPU kernels take the wide layout (an 8 x 8 block plus row-packed
// strips), which exists for the TPU's 8-sublane tiles.  It is not carried
// over: on the H100 it would only add relayout passes on the host and an
// unpack / pack per block in the thread.  These kernels read and write the
// chunk-major [s, d, d, C] stacks of kernels 10 and 11, so the engine's
// glue (partitioned._inverse_from_cm) is the same at every d.
//
// The sweep writes, for every interior step j = 1..s-1 (stack row j-1),
// D_j, 1/diag(D_j), C_j = O_j D_j^{-T} and W0_j, and the final acc00, W0,
// D, 1/diag D.  The recursion walks rows s-3 .. 0 (steps s-2 .. 1) from
// the step s-1 seeds (phi, u0, u1):
//   di = D^{-1},  cd = C di,  phi_off = -phi_{j+1} cd
//   phi_j = di^T di + cd^T phi_{j+1} cd
//   u0_j = D^{-T} (W0_j - C^T u0_{j+1}),  u1_j = -D^{-T} C^T u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
// with (a0, a1) = Sigma_BB U^T.
//
// What bounds them on the H100: per row the sweep reads 2 d^2 values and
// writes 3 d^2 + d, the recursion reads 3 d^2 + d and writes 2 d^2 (~2.9
// GB and ~2.9 GB at d = 12, N = 1e6, float32: byte bounds of ~0.87 ms
// each).  One thread per chunk lane walks the lane's rows in order, each a
// dependent chain of ~8 d^3 (sweep) or ~33 d^3 (recursion) operations on
// blocks in local memory (rtblock.cuh: one instance per dtype serves
// d = 9..15), with C = N/s lanes: latency- and occupancy-bound, far from
// both bounds.  The sweep is rtblock.cuh's elimination step on a zero
// right-hand side (its vector terms are O(d^2) of the row's O(d^3)).  A
// warp per chunk, or blocks in shared memory, is later work.
#include "rtblock.cuh"

namespace {

using namespace cgt::rt;

template <typename T>
__global__ void __launch_bounds__(CGT_THREADS)
rt_inverse_sweep_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                        T jitter, int s, int d, int C, T* acc00, T* w0l,
                        T* dl, T* invdl, T* ds, T* invds, T* cs, T* w0s) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Carry<T> st;
  Mat<T> o_left, P, o_j, t;
  Vec<T> zero;
  for (int i = 0; i < d; ++i) zero[i] = T(0);
  load_m<T>(Om, 0, d, C, c, o_left);
  for (int j = 1; j < s; ++j) {
    load_m<T>(Rm, j, d, C, c, P);
    for (int i = 0; i < d; ++i) P[i][i] += jitter;
    load_m<T>(Om, j, d, C, c, o_j);
    elim_step<T>(j == 1, P, o_j, zero, o_left, st, t, d);
    store_m<T>(ds, j - 1, d, C, c, st.D);
    store_v<T>(invds, j - 1, d, C, c, st.invd);
    store_m<T>(cs, j - 1, d, C, c, st.cprev);
    store_m<T>(w0s, j - 1, d, C, c, st.w0);
  }
  store_m<T>(acc00, 0, d, C, c, st.acc);
  store_m<T>(w0l, 0, d, C, c, st.w0);
  store_m<T>(dl, 0, d, C, c, st.D);
  store_v<T>(invdl, 0, d, C, c, st.invd);
}

template <typename T>
__global__ void __launch_bounds__(CGT_THREADS)
rt_takahashi_kernel(const T* __restrict__ ds, const T* __restrict__ invds,
                    const T* __restrict__ cs, const T* __restrict__ w0s,
                    const T* __restrict__ p00_p, const T* __restrict__ p01_p,
                    const T* __restrict__ p10_p, const T* __restrict__ p11_p,
                    const T* __restrict__ phi_p, const T* __restrict__ u0_p,
                    const T* __restrict__ u1_p, int s, int d, int C,
                    T* diag_out, T* off_out, T* u0f, T* u1f) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Mat<T> p00, p01, p10, p11, phi, u0, u1;
  load_m<T>(p00_p, 0, d, C, c, p00);
  load_m<T>(p01_p, 0, d, C, c, p01);
  load_m<T>(p10_p, 0, d, C, c, p10);
  load_m<T>(p11_p, 0, d, C, c, p11);
  load_m<T>(phi_p, 0, d, C, c, phi);
  load_m<T>(u0_p, 0, d, C, c, u0);
  load_m<T>(u1_p, 0, d, C, c, u1);
  // per step: the factors D and C, and five blocks of scratch whose roles
  // change as the step goes (named where each is set)
  Mat<T> D, cm, x1, x2, x3, x4, x5;
  Vec<T> invd;
  for (int r = s - 3; r >= 0; --r) {
    load_m<T>(ds, r, d, C, c, D);
    load_v<T>(invds, r, d, C, c, invd);
    load_m<T>(cs, r, d, C, c, cm);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k < d; ++k) x1[i][k] = (i == k) ? T(1) : T(0);
    solve_lower<T>(D, invd, x1, x1, d);  // x1 = di = D^{-1}
    mm<T>(cm, x1, x2, d);                // x2 = cd = C di
    mm_ta<T>(x1, x1, x3, d);             // x3 = di^T di
    mm_ta<T>(x2, phi, x1, d);            // x1 = cd^T phi
    mm_add<T>(x1, x2, x3, x4, d);        // x3 = phi_j
    mm<T>(phi, x2, x4, d);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k < d; ++k) x4[i][k] = -x4[i][k];  // x4 = phi_off
    load_m<T>(w0s, r, d, C, c, x1);
    mm_ta<T>(cm, u0, x2, d);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k < d; ++k) x1[i][k] -= x2[i][k];
    solve_lower_t<T>(D, invd, x1, x1, d);  // x1 = u0_j
    mm_ta<T>(cm, u1, x2, d);
    solve_lower_t<T>(D, invd, x2, x2, d);
    for (int i = 0; i < d; ++i)
      for (int k = 0; k < d; ++k) x2[i][k] = -x2[i][k];  // x2 = u1_j
    // a0 into D, a1 into cm (the factors are spent)
    sig_ut<T>(p00, p01, p10, p11, x1, x2, D, cm, x5, d);
    copy_<T>(x3, phi, d);  // phi_j carries to the next step
    mm_add<T>(x1, D, x3, x5, d);
    mm_add<T>(x2, cm, x3, x5, d);  // x3 = Sigma_jj
    store_m<T>(diag_out, r, d, C, c, x3);
    mm_add<T>(u0, D, x4, x5, d);
    mm_add<T>(u1, cm, x4, x5, d);  // x4 = Sigma_{j+1,j}
    store_m<T>(off_out, r, d, C, c, x4);
    copy_<T>(x1, u0, d);
    copy_<T>(x2, u1, d);
  }
  store_m<T>(u0f, 0, d, C, c, u0);
  store_m<T>(u1f, 0, d, C, c, u1);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_inverse_sweep(const T* R_cm, const T* O_cm, T jitter, int s, int d,
                         int C, T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                         T* invds, T* cs, T* w0s, cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  rt_inverse_sweep_kernel<T><<<blocks_for(C), CGT_THREADS, 0, stream>>>(
      R_cm, O_cm, jitter, s, d, C, acc00, w0l, dl, invdl, ds, invds, cs,
      w0s);
  return int(cudaGetLastError());
}

template <typename T>
int launch_takahashi(const T* ds, const T* invds, const T* cs, const T* w0s,
                     const T* p00, const T* p01, const T* p10, const T* p11,
                     const T* phi, const T* u0, const T* u1, int s, int d,
                     int C, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  rt_takahashi_kernel<T><<<blocks_for(C), CGT_THREADS, 0, stream>>>(
      ds, invds, cs, w0s, p00, p01, p10, p11, phi, u0, u1, s, d, C, diag,
      off, u0f, u1f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_RT_INVERSE(T, SUF)                                                \
  int cgt_rt_forward_sweep_inverse_##SUF(                                    \
      const T* R_cm, const T* O_cm, T jitter, int s, int d, int C,           \
      T* acc00, T* w0l, T* dl, T* invdl, T* ds, T* invds, T* cs, T* w0s,     \
      void* stream) {                                                         \
    return launch_inverse_sweep<T>(R_cm, O_cm, jitter, s, d, C, acc00, w0l,  \
                                   dl, invdl, ds, invds, cs, w0s,            \
                                   (cudaStream_t)stream);                    \
  }                                                                           \
  int cgt_rt_takahashi_backward_##SUF(                                       \
      const T* ds, const T* invds, const T* cs, const T* w0s, const T* p00,  \
      const T* p01, const T* p10, const T* p11, const T* phi, const T* u0,   \
      const T* u1, int s, int d, int C, T* diag, T* off, T* u0f, T* u1f,     \
      void* stream) {                                                         \
    return launch_takahashi<T>(ds, invds, cs, w0s, p00, p01, p10, p11, phi,  \
                               u0, u1, s, d, C, diag, off, u0f, u1f,         \
                               (cudaStream_t)stream);                        \
  }

CGT_RT_INVERSE(float, f32)
CGT_RT_INVERSE(double, f64)
#undef CGT_RT_INVERSE

}  // extern "C"
