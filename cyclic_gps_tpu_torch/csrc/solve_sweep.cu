// The two kernels of the block-tridiagonal solve x = J^{-1} y: the forward
// sweep that streams the hat back-substitution factors, and the descending
// back-substitution over them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   forward_sweep_collect_kernel <- :400 forward_sweep_collect_pallas
//                                   (kernel body _sweep_collect_kernel, :328)
//   backward_substitute_kernel   <- :1006 backward_substitute_pallas
//                                   (_backsub_kernel, :976)
//
// What bounds them on the H100: both stream stacks of R x R blocks, one
// thread per chunk lane c walking that chunk's s-1 rows (ascending for the
// sweep, descending for the back-substitution).  Per row the sweep reads
// 2 R^2 + R values and writes 2 R^2 + R + 1; the back-substitution reads
// 2 R^2 + R and writes R.  In bytes that is ~440 MB and ~240 MB at rank 5,
// N = 1e6, float32 (bounds of ~0.13 and ~0.07 ms).  With C = N/s lanes
// (7,813 at s = 128: ~61 blocks of 128 for 132 SMs) and a dependent chain
// of small products per row, the sweep is latency- and occupancy-bound like
// the likelihood's sweep; the back-substitution is a pure multiply-add walk
// whose loads dominate.
//
// What the simple design does about it: the elimination state and the
// carried x_{j+1} stay in registers, each stack row is read or written once,
// and the lane axis is innermost so every access coalesces.  The descending
// walk indexes its rows backwards with plain strides (no reversed copy).
#include "blockmath.cuh"

namespace {

// Forward sweep (the elimination of forward_sweep.cu) that also writes, for
// every interior step j = 1..s-1 (stack row j-1), the hat factors of the
// back-substitution, each by one back substitution against D_j^T as the TPU
// kernel does:  hat_C = D^{-T} C^T,  hat_W0 = D^{-T} W0,  hat_w = D^{-T} w,
// and the step's pivot log-determinant 2 log|D_j|.
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
forward_sweep_collect_kernel(const T* __restrict__ Rm,
                             const T* __restrict__ Om,
                             const T* __restrict__ ym, T jitter, int s, int C,
                             T* acc00, T* accy0, T* w0l, T* wl, T* dl,
                             T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                             T* ld_rows) {
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

    T ct[R][R], t[R][R], v[R];
    cgt::transpose<T, R>(st.cprev, ct);
    cgt::solve_lower_t<T, R, R>(st.D, st.invd, ct, t);
    cgt::store_mat<T, R>(hc, j - 1, C, c, t);
    cgt::solve_lower_t<T, R, R>(st.D, st.invd, st.w0, t);
    cgt::store_mat<T, R>(hw0, j - 1, C, c, t);
    cgt::solve_lower_t_vec<T, R>(st.D, st.invd, st.w, v);
    cgt::store_vec<T, R>(hw, j - 1, C, c, v);
  }
  cgt::store_sweep_state<T, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                               mh, ld);
}

// One descending pass per chunk lane over stack rows s-2 .. 0 (steps s-1 ..
// 1), the whole stack included:
//   x_{s-1} = hat_w - hat_W0 x_b - hat_W1 x_{b,next}
//   x_j     = hat_w - hat_W0 x_b - hat_C x_{j+1}
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
backward_substitute_kernel(const T* __restrict__ hc,
                           const T* __restrict__ hw0,
                           const T* __restrict__ hw,
                           const T* __restrict__ hw1_p,
                           const T* __restrict__ xb_p,
                           const T* __restrict__ xbn_p, int s, int C,
                           T* x_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  T xb[R], x[R];
  cgt::load_vec<T, R>(xb_p, 0, C, c, xb);
  for (int t = s - 2; t >= 0; --t) {
    T m[R][R], common[R], tv[R];
    cgt::load_vec<T, R>(hw, t, C, c, common);
    cgt::load_mat<T, R>(hw0, t, C, c, m);
    cgt::mv<T, R>(m, xb, tv);
#pragma unroll
    for (int i = 0; i < R; ++i) common[i] -= tv[i];
    if (t == s - 2) {
      T xbn[R];
      cgt::load_mat<T, R>(hw1_p, 0, C, c, m);
      cgt::load_vec<T, R>(xbn_p, 0, C, c, xbn);
      cgt::mv<T, R>(m, xbn, tv);
    } else {
      cgt::load_mat<T, R>(hc, t, C, c, m);
      cgt::mv<T, R>(m, x, tv);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = common[i] - tv[i];
    cgt::store_vec<T, R>(x_out, t, C, c, x);
  }
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_collect(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                   int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                   T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                   T* ld_rows, cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                      \
  forward_sweep_collect_kernel<T, RR>                                       \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                          \
          R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, \
          mh, ld, hc, hw0, hw, ld_rows)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsub(const T* hc, const T* hw0, const T* hw, const T* hw1,
                   const T* xb, const T* xbn, int s, int d, int C, T* x,
                   cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                   \
  backward_substitute_kernel<T, RR>                                      \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(hc, hw0, hw, hw1, xb, \
                                                   xbn, s, C, x)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cgt_forward_sweep_collect_f32(const float* R_cm, const float* O_cm,
                                  const float* y_cm, float jitter, int s,
                                  int d, int C, float* acc00, float* accy0,
                                  float* w0l, float* wl, float* dl,
                                  float* invdl, float* mh, float* ld,
                                  float* hc, float* hw0, float* hw,
                                  float* ld_rows, void* stream) {
  return launch_collect<float>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                               accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0, hw,
                               ld_rows, (cudaStream_t)stream);
}

int cgt_forward_sweep_collect_f64(const double* R_cm, const double* O_cm,
                                  const double* y_cm, double jitter, int s,
                                  int d, int C, double* acc00, double* accy0,
                                  double* w0l, double* wl, double* dl,
                                  double* invdl, double* mh, double* ld,
                                  double* hc, double* hw0, double* hw,
                                  double* ld_rows, void* stream) {
  return launch_collect<double>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0,
                                hw, ld_rows, (cudaStream_t)stream);
}

int cgt_backward_substitute_f32(const float* hc, const float* hw0,
                                const float* hw, const float* hw1,
                                const float* xb, const float* xbn, int s,
                                int d, int C, float* x, void* stream) {
  return launch_backsub<float>(hc, hw0, hw, hw1, xb, xbn, s, d, C, x,
                               (cudaStream_t)stream);
}

int cgt_backward_substitute_f64(const double* hc, const double* hw0,
                                const double* hw, const double* hw1,
                                const double* xb, const double* xbn, int s,
                                int d, int C, double* x, void* stream) {
  return launch_backsub<double>(hc, hw0, hw, hw1, xb, xbn, s, d, C, x,
                                (cudaStream_t)stream);
}

}  // extern "C"
