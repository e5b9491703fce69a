// The two kernels of the selected inversion (the diagonal and lag-1 blocks
// of J^{-1}): the forward sweep that streams the raw factors of every
// interior step, and the descending Takahashi recursion over them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   forward_sweep_inverse_kernel <- :534 forward_sweep_inverse_pallas
//                                   (_sweep_inverse_collect_kernel, :483)
//   takahashi_backward_kernel    <- :648 takahashi_backward_pallas
//                                   (_takahashi_kernel, :585)
//
// What bounds them on the H100: both stream stacks of R x R blocks, one
// thread per chunk lane c.  Per row the sweep reads 2 R^2 values and writes
// 3 R^2 + R (D, invd, C, W0); the recursion reads those 3 R^2 + R and
// writes 2 R^2 (Sigma_jj, Sigma_{j+1,j}).  In bytes that is ~520 MB and
// ~510 MB at rank 5, N = 1e6, float32 (bounds of ~0.15 ms each).  The
// recursion does ~25 dependent R x R products per row, so with C = N/s
// lanes (~61 blocks of 128 for 132 SMs at s = 128) it is latency- and
// register-bound rather than bandwidth-bound.
//
// What the simple design does about it: the carried state stays in
// registers, each stack row is read or written once, and the lane axis is
// innermost so every access coalesces.  The TPU kernel also carries a0 and
// a1 from step to step (its scratch), but no step reads the carried values:
// the off-diagonal block uses this step's a0/a1 and the previous step's
// u0/u1.  So the recursion carries only phi, u0 and u1, besides the four
// Sigma_BB blocks of the chunk's boundaries.
#include "blockmath.cuh"

namespace {

// Forward elimination without a right-hand side (forward_sweep.cu's step
// with no w, accy0 or mh), writing the raw factors of every interior step
// j = 1..s-1 (stack row j-1): D_j, 1/diag(D_j), C_j = O_j D_j^{-T}, W0_j.
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
forward_sweep_inverse_kernel(const T* __restrict__ Rm,
                             const T* __restrict__ Om, T jitter, int s, int C,
                             T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                             T* invds, T* cs, T* w0s) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T cprev[R][R], w0[R][R], acc[R][R], D[R][R], invd[R];
  for (int j = 1; j < s; ++j) {
    T P[R][R], o_j[R][R], t[R][R];
    cgt::load_mat<T, R>(Rm, j, C, c, P);
#pragma unroll
    for (int i = 0; i < R; ++i) P[i][i] += jitter;
    cgt::load_mat<T, R>(Om, j, C, c, o_j);
    if (j > 1) {
      cgt::mm_tb<T, R>(cprev, cprev, t);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) P[i][k] -= t[i][k];
    }
    cgt::chol<T, R>(P, D, invd);
    if (j == 1) {
      T o_left[R][R];
      cgt::load_mat<T, R>(Om, 0, C, c, o_left);
      cgt::solve_lower<T, R, R>(D, invd, o_left, w0);
    } else {
      T w0n[R][R];
      cgt::mm<T, R>(cprev, w0, t);
      cgt::solve_lower<T, R, R>(D, invd, t, w0n);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) w0[i][k] = -w0n[i][k];
    }
    // C_j = (D^{-1} O_j^T)^T
    T ot[R][R];
    cgt::transpose<T, R>(o_j, ot);
    cgt::solve_lower<T, R, R>(D, invd, ot, t);
    cgt::transpose<T, R>(t, cprev);
    cgt::mm_ta<T, R>(w0, w0, t);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) acc[i][k] = (j == 1) ? t[i][k]
                                                       : acc[i][k] + t[i][k];
    cgt::store_mat<T, R>(ds, j - 1, C, c, D);
    cgt::store_vec<T, R>(invds, j - 1, C, c, invd);
    cgt::store_mat<T, R>(cs, j - 1, C, c, cprev);
    cgt::store_mat<T, R>(w0s, j - 1, C, c, w0);
  }
  cgt::store_mat<T, R>(acc00, 0, C, c, acc);
  cgt::store_mat<T, R>(w0l, 0, C, c, w0);
  cgt::store_mat<T, R>(dl, 0, C, c, D);
  cgt::store_vec<T, R>(invdl, 0, C, c, invd);
}

// a0 = p00 u0^T + p01 u1^T,  a1 = p10 u0^T + p11 u1^T  (Sigma_BB U^T)
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
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) a0[i][k] += t[i][k];
  cgt::mm_tb<T, R>(p10, u0, a1);
  cgt::mm_tb<T, R>(p11, u1, t);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) a1[i][k] += t[i][k];
}

// One descending pass per chunk lane over stack rows s-3 .. 0 (steps s-2 ..
// 1), seeded with the step s-1 values (phi, u0, u1) computed by the caller:
//   di = D^{-1},  cd = C di
//   phi_off = -phi_{j+1} cd
//   phi_j   = di^T di + cd^T phi_{j+1} cd
//   u0_j    = D^{-T} (W0_j - C^T u0_{j+1}),   u1_j = -D^{-T} C^T u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
takahashi_backward_kernel(
    const T* __restrict__ ds, const T* __restrict__ invds,
    const T* __restrict__ cs, const T* __restrict__ w0s,
    const T* __restrict__ p00_p, const T* __restrict__ p01_p,
    const T* __restrict__ p10_p, const T* __restrict__ p11_p,
    const T* __restrict__ phi_p, const T* __restrict__ u0_p,
    const T* __restrict__ u1_p, int s, int C, T* diag_out, T* off_out,
    T* u0f, T* u1f) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T p00[R][R], p01[R][R], p10[R][R], p11[R][R], phi[R][R], u0[R][R],
      u1[R][R];
  cgt::load_mat<T, R>(p00_p, 0, C, c, p00);
  cgt::load_mat<T, R>(p01_p, 0, C, c, p01);
  cgt::load_mat<T, R>(p10_p, 0, C, c, p10);
  cgt::load_mat<T, R>(p11_p, 0, C, c, p11);
  cgt::load_mat<T, R>(phi_p, 0, C, c, phi);
  cgt::load_mat<T, R>(u0_p, 0, C, c, u0);
  cgt::load_mat<T, R>(u1_p, 0, C, c, u1);
  T eye[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) eye[i][k] = (i == k) ? T(1) : T(0);
  for (int t = s - 3; t >= 0; --t) {
    T D[R][R], invd[R], cm[R][R], di[R][R], cd[R][R], tm[R][R], tn[R][R];
    cgt::load_mat<T, R>(ds, t, C, c, D);
    cgt::load_vec<T, R>(invds, t, C, c, invd);
    cgt::load_mat<T, R>(cs, t, C, c, cm);
    cgt::solve_lower<T, R, R>(D, invd, eye, di);
    cgt::mm<T, R>(cm, di, cd);

    T phi_off[R][R], phi_j[R][R];
    cgt::mm<T, R>(phi, cd, phi_off);
    cgt::mm_ta<T, R>(di, di, phi_j);
    cgt::mm_ta<T, R>(cd, phi, tm);
    cgt::mm<T, R>(tm, cd, tn);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        phi_off[i][k] = -phi_off[i][k];
        phi_j[i][k] += tn[i][k];
      }

    T u0_j[R][R], u1_j[R][R];
    cgt::load_mat<T, R>(w0s, t, C, c, tn);
    cgt::mm_ta<T, R>(cm, u0, tm);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) tm[i][k] = tn[i][k] - tm[i][k];
    cgt::solve_lower_t<T, R, R>(D, invd, tm, u0_j);
    cgt::mm_ta<T, R>(cm, u1, tm);
    cgt::solve_lower_t<T, R, R>(D, invd, tm, u1_j);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) u1_j[i][k] = -u1_j[i][k];

    T a0[R][R], a1[R][R];
    sig_ut<T, R>(p00, p01, p10, p11, u0_j, u1_j, a0, a1);
    // Sigma_jj
    cgt::mm<T, R>(u0_j, a0, tm);
    cgt::mm<T, R>(u1_j, a1, tn);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) tm[i][k] = phi_j[i][k] + tm[i][k] + tn[i][k];
    cgt::store_mat<T, R>(diag_out, t, C, c, tm);
    // Sigma_{j+1,j}, with the previous step's u0 / u1
    cgt::mm<T, R>(u0, a0, tm);
    cgt::mm<T, R>(u1, a1, tn);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        tm[i][k] = phi_off[i][k] + tm[i][k] + tn[i][k];
        phi[i][k] = phi_j[i][k];
        u0[i][k] = u0_j[i][k];
        u1[i][k] = u1_j[i][k];
      }
    cgt::store_mat<T, R>(off_out, t, C, c, tm);
  }
  cgt::store_mat<T, R>(u0f, 0, C, c, u0);
  cgt::store_mat<T, R>(u1f, 0, C, c, u1);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_inverse_sweep(const T* R_cm, const T* O_cm, T jitter, int s, int d,
                         int C, T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                         T* invds, T* cs, T* w0s, cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                    \
  forward_sweep_inverse_kernel<T, RR>                                     \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(R_cm, O_cm, jitter, s, \
                                                   C, acc00, w0l, dl,     \
                                                   invdl, ds, invds, cs,  \
                                                   w0s)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T>
int launch_takahashi(const T* ds, const T* invds, const T* cs, const T* w0s,
                     const T* p00, const T* p01, const T* p10, const T* p11,
                     const T* phi, const T* u0, const T* u1, int s, int d,
                     int C, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                     \
  takahashi_backward_kernel<T, RR>                                         \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                         \
          ds, invds, cs, w0s, p00, p01, p10, p11, phi, u0, u1, s, C, diag, \
          off, u0f, u1f)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_forward_sweep_inverse_f32(const float* R_cm, const float* O_cm,
                                  float jitter, int s, int d, int C,
                                  float* acc00, float* w0l, float* dl,
                                  float* invdl, float* ds, float* invds,
                                  float* cs, float* w0s, void* stream) {
  return launch_inverse_sweep<float>(R_cm, O_cm, jitter, s, d, C, acc00, w0l,
                                     dl, invdl, ds, invds, cs, w0s,
                                     (cudaStream_t)stream);
}

int cgt_forward_sweep_inverse_f64(const double* R_cm, const double* O_cm,
                                  double jitter, int s, int d, int C,
                                  double* acc00, double* w0l, double* dl,
                                  double* invdl, double* ds, double* invds,
                                  double* cs, double* w0s, void* stream) {
  return launch_inverse_sweep<double>(R_cm, O_cm, jitter, s, d, C, acc00,
                                      w0l, dl, invdl, ds, invds, cs, w0s,
                                      (cudaStream_t)stream);
}

int cgt_takahashi_backward_f32(const float* ds, const float* invds,
                               const float* cs, const float* w0s,
                               const float* p00, const float* p01,
                               const float* p10, const float* p11,
                               const float* phi, const float* u0,
                               const float* u1, int s, int d, int C,
                               float* diag, float* off, float* u0f,
                               float* u1f, void* stream) {
  return launch_takahashi<float>(ds, invds, cs, w0s, p00, p01, p10, p11, phi,
                                 u0, u1, s, d, C, diag, off, u0f, u1f,
                                 (cudaStream_t)stream);
}

int cgt_takahashi_backward_f64(const double* ds, const double* invds,
                               const double* cs, const double* w0s,
                               const double* p00, const double* p01,
                               const double* p10, const double* p11,
                               const double* phi, const double* u0,
                               const double* u1, int s, int d, int C,
                               double* diag, double* off, double* u0f,
                               double* u1f, void* stream) {
  return launch_takahashi<double>(ds, invds, cs, w0s, p00, p01, p10, p11,
                                  phi, u0, u1, s, d, C, diag, off, u0f, u1f,
                                  (cudaStream_t)stream);
}

}  // extern "C"
