// The two kernels of the analytic backward of (mahal, logdet): the forward
// sweep that streams the shared hat stacks, and the descending pass that
// runs the back-substitution and the hat-form Takahashi recursion on them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   forward_sweep_solveinv_kernel   <- :772 forward_sweep_solveinv_pallas
//                                      (kernel body _sweep_solveinv_kernel,
//                                      :699)
//   backward_solve_takahashi_kernel <- :918 backward_solve_takahashi_pallas
//                                      (_backsolve_takahashi_kernel, :845)
//
// What bounds them on the H100: both are streaming passes over stacks of
// R x R blocks, one thread per chunk lane c walking that chunk's s-1 rows
// in order (ascending for the sweep, descending for the walk).  Per row the
// sweep reads 2 R^2 + R floats and writes 3 R^2 + R; the walk reads the
// same 3 R^2 + R and writes 2 R^2 + R -- so in bytes they sit at about the
// card's memory rate for ~540 MB each at rank 5, N = 1e6 (~0.16 ms).  But
// with C = N/s lanes (7,813 at s = 128: ~61 blocks of 128 for 132 SMs)
// each thread runs a dependent chain of ~15 R x R products per row, so
// like the forward sweep they are latency- and occupancy-bound, not
// bandwidth-bound.
//
// What the simple design does about it: everything carried between rows
// (the elimination state; phi, u0, u1 and x_{j+1} of the walk) stays in
// registers, each stack row is read or written exactly once, and the lane
// axis is innermost so every access coalesces.  The descending walk indexes
// its rows backwards with plain strides -- no reversed copy.  Spreading a
// chunk over a warp is later work.
//
// Instantiated for block sizes 1..8 and 16 (the celerite family's boundary
// chain at nblocks = 8), as forward_sweep.cu.
#include "blockmath.cuh"

namespace {

// Forward sweep that also writes, for every interior step j = 1..s-1
// (stack row j-1): hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0, hat_w = D^{-T} w
// and pinv = P^{-1} = D^{-T} D^{-1}, all from the triangular inverse
// di = D^{-1} (one inversion and four products, as the TPU kernel's emit).
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
forward_sweep_solveinv_kernel(const T* __restrict__ Rm,
                              const T* __restrict__ Om,
                              const T* __restrict__ ym, T jitter, int s,
                              int C, T* acc00, T* accy0, T* w0l, T* wl, T* dl,
                              T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                              T* pinv, T* ld_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  cgt::SweepCarry<T, R> st;
  T o_left[R][R];
  cgt::load_mat<T, R>(Om, 0, C, c, o_left);
  T eye[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) eye[i][k] = (i == k) ? T(1) : T(0);
  for (int j = 1; j < s; ++j) {
    T P[R][R], o_j[R][R], y_j[R];
    cgt::load_mat<T, R>(Rm, j, C, c, P);
#pragma unroll
    for (int i = 0; i < R; ++i) P[i][i] += jitter;
    cgt::load_mat<T, R>(Om, j, C, c, o_j);
    cgt::load_vec<T, R>(ym, j, C, c, y_j);
    const T ldl = cgt::elim_step<T, R>(j == 1, P, o_j, y_j, o_left, st);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;

    T di[R][R], t[R][R], ct[R][R], v[R];
    cgt::solve_lower<T, R, R>(st.D, st.invd, eye, di);
    cgt::transpose<T, R>(st.cprev, ct);
    cgt::mm_ta<T, R>(di, ct, t);  // di^T C^T
    cgt::store_mat<T, R>(hc, j - 1, C, c, t);
    cgt::mm_ta<T, R>(di, st.w0, t);
    cgt::store_mat<T, R>(hw0, j - 1, C, c, t);
    cgt::mv_ta<T, R>(di, st.w, v);
    cgt::store_vec<T, R>(hw, j - 1, C, c, v);
    cgt::mm_ta<T, R>(di, di, t);
    cgt::store_mat<T, R>(pinv, j - 1, C, c, t);
  }
  cgt::store_sweep_state<T, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                               mh, ld);
}

template <typename T, int R>
__device__ __forceinline__ void add_(T (&a)[R][R], const T (&b)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) a[i][k] += b[i][k];
}

// a0 = p00 u0^T + p01 u1^T,  a1 = p10 u0^T + p11 u1^T  (Sigma_bb U^T)
template <typename T, int R>
__device__ __forceinline__ void sig_ut(const T (&p00)[R][R],
                                       const T (&p01)[R][R],
                                       const T (&p10)[R][R],
                                       const T (&p11)[R][R],
                                       const T (&u0)[R][R],
                                       const T (&u1)[R][R], T (&a0)[R][R],
                                       T (&a1)[R][R]) {
  T t[R][R];
  cgt::mm_tb<T, R>(p00, u0, a0);
  cgt::mm_tb<T, R>(p01, u1, t);
  add_<T, R>(a0, t);
  cgt::mm_tb<T, R>(p10, u0, a1);
  cgt::mm_tb<T, R>(p11, u1, t);
  add_<T, R>(a1, t);
}

// One descending pass per chunk lane over stack rows s-2 .. 0 (steps s-1 ..
// 1).  Row s-2 is the Takahashi seed (phi = pinv, u0 = hat_w0, u1 = hat_w1)
// and the last interior row of the solve (it carries the W1 term); every
// later row is
//   x_j     = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}
//   phi_off = -phi_{j+1} hat_C_j^T
//   phi_j   = pinv_j + hat_C_j phi_{j+1} hat_C_j^T
//   u0_j    = hat_W0_j - hat_C_j u0_{j+1},   u1_j = -hat_C_j u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
backward_solve_takahashi_kernel(
    const T* __restrict__ hc, const T* __restrict__ hw0,
    const T* __restrict__ hw, const T* __restrict__ pinv,
    const T* __restrict__ hw1_p, const T* __restrict__ xb_p,
    const T* __restrict__ xbn_p, const T* __restrict__ p00_p,
    const T* __restrict__ p01_p, const T* __restrict__ p10_p,
    const T* __restrict__ p11_p, int s, int C, T* x_out, T* diag_out,
    T* off_out, T* u0f, T* u1f) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T p00[R][R], p01[R][R], p10[R][R], p11[R][R];
  cgt::load_mat<T, R>(p00_p, 0, C, c, p00);
  cgt::load_mat<T, R>(p01_p, 0, C, c, p01);
  cgt::load_mat<T, R>(p10_p, 0, C, c, p10);
  cgt::load_mat<T, R>(p11_p, 0, C, c, p11);
  T xb[R];
  cgt::load_vec<T, R>(xb_p, 0, C, c, xb);
  T phi[R][R], u0[R][R], u1[R][R], x[R];
  for (int t = s - 2; t >= 0; --t) {
    T hc_j[R][R], hw0_j[R][R], pinv_j[R][R], common[R], tv[R];
    cgt::load_mat<T, R>(hc, t, C, c, hc_j);
    cgt::load_mat<T, R>(hw0, t, C, c, hw0_j);
    cgt::load_mat<T, R>(pinv, t, C, c, pinv_j);
    cgt::load_vec<T, R>(hw, t, C, c, common);
    cgt::mv<T, R>(hw0_j, xb, tv);
#pragma unroll
    for (int i = 0; i < R; ++i) common[i] -= tv[i];
    T a0[R][R], a1[R][R], dg[R][R], of[R][R], tm[R][R];
    if (t == s - 2) {
      T hw1[R][R], xbn[R];
      cgt::load_mat<T, R>(hw1_p, 0, C, c, hw1);
      cgt::load_vec<T, R>(xbn_p, 0, C, c, xbn);
      cgt::mv<T, R>(hw1, xbn, tv);
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = common[i] - tv[i];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          phi[i][k] = pinv_j[i][k];
          u0[i][k] = hw0_j[i][k];
          u1[i][k] = hw1[i][k];
        }
      sig_ut<T, R>(p00, p01, p10, p11, u0, u1, a0, a1);
      cgt::mm<T, R>(u0, a0, dg);
      cgt::mm<T, R>(u1, a1, tm);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          dg[i][k] = phi[i][k] + dg[i][k] + tm[i][k];
          of[i][k] = -a1[i][k];
        }
    } else {
      cgt::mv<T, R>(hc_j, x, tv);
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = common[i] - tv[i];
      T phi_off[R][R], phi_j[R][R], u0_j[R][R], u1_j[R][R];
      cgt::mm_tb<T, R>(phi, hc_j, phi_off);
      cgt::mm<T, R>(hc_j, phi, tm);
      cgt::mm_tb<T, R>(tm, hc_j, phi_j);
      cgt::mm<T, R>(hc_j, u0, tm);
      cgt::mm<T, R>(hc_j, u1, u1_j);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          phi_off[i][k] = -phi_off[i][k];
          phi_j[i][k] += pinv_j[i][k];
          u0_j[i][k] = hw0_j[i][k] - tm[i][k];
          u1_j[i][k] = -u1_j[i][k];
        }
      sig_ut<T, R>(p00, p01, p10, p11, u0_j, u1_j, a0, a1);
      cgt::mm<T, R>(u0_j, a0, dg);
      cgt::mm<T, R>(u1_j, a1, tm);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k)
          dg[i][k] = phi_j[i][k] + dg[i][k] + tm[i][k];
      cgt::mm<T, R>(u0, a0, of);
      cgt::mm<T, R>(u1, a1, tm);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          of[i][k] = phi_off[i][k] + of[i][k] + tm[i][k];
          phi[i][k] = phi_j[i][k];
          u0[i][k] = u0_j[i][k];
          u1[i][k] = u1_j[i][k];
        }
    }
    cgt::store_vec<T, R>(x_out, t, C, c, x);
    cgt::store_mat<T, R>(diag_out, t, C, c, dg);
    cgt::store_mat<T, R>(off_out, t, C, c, of);
  }
  cgt::store_mat<T, R>(u0f, 0, C, c, u0);
  cgt::store_mat<T, R>(u1f, 0, C, c, u1);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_solveinv(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                    int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                    T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                    T* pinv, T* ld_rows, cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                     \
  forward_sweep_solveinv_kernel<T, RR>                                     \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                         \
          R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, \
          mh, ld, hc, hw0, hw, pinv, ld_rows)
  CGT_RANK_SWITCH_16(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsolve(const T* hc, const T* hw0, const T* hw, const T* pinv,
                     const T* hw1, const T* xb, const T* xbn, const T* p00,
                     const T* p01, const T* p10, const T* p11, int s, int d,
                     int C, T* x, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                      \
  backward_solve_takahashi_kernel<T, RR>                                    \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                          \
          hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01, p10, p11, s, C, x,     \
          diag, off, u0f, u1f)
  CGT_RANK_SWITCH_16(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_forward_sweep_solveinv_f32(const float* R_cm, const float* O_cm,
                                   const float* y_cm, float jitter, int s,
                                   int d, int C, float* acc00, float* accy0,
                                   float* w0l, float* wl, float* dl,
                                   float* invdl, float* mh, float* ld,
                                   float* hc, float* hw0, float* hw,
                                   float* pinv, float* ld_rows,
                                   void* stream) {
  return launch_solveinv<float>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0,
                                hw, pinv, ld_rows, (cudaStream_t)stream);
}

int cgt_forward_sweep_solveinv_f64(const double* R_cm, const double* O_cm,
                                   const double* y_cm, double jitter, int s,
                                   int d, int C, double* acc00,
                                   double* accy0, double* w0l, double* wl,
                                   double* dl, double* invdl, double* mh,
                                   double* ld, double* hc, double* hw0,
                                   double* hw, double* pinv, double* ld_rows,
                                   void* stream) {
  return launch_solveinv<double>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                 accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0,
                                 hw, pinv, ld_rows, (cudaStream_t)stream);
}

int cgt_backward_solve_takahashi_f32(
    const float* hc, const float* hw0, const float* hw, const float* pinv,
    const float* hw1, const float* xb, const float* xbn, const float* p00,
    const float* p01, const float* p10, const float* p11, int s, int d,
    int C, float* x, float* diag, float* off, float* u0f, float* u1f,
    void* stream) {
  return launch_backsolve<float>(hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01,
                                 p10, p11, s, d, C, x, diag, off, u0f, u1f,
                                 (cudaStream_t)stream);
}

int cgt_backward_solve_takahashi_f64(
    const double* hc, const double* hw0, const double* hw,
    const double* pinv, const double* hw1, const double* xb,
    const double* xbn, const double* p00, const double* p01,
    const double* p10, const double* p11, int s, int d, int C, double* x,
    double* diag, double* off, double* u0f, double* u1f, void* stream) {
  return launch_backsolve<double>(hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01,
                                  p10, p11, s, d, C, x, diag, off, u0f, u1f,
                                  (cudaStream_t)stream);
}

}  // extern "C"
