// The two kernels of the block-tridiagonal solve x = J^{-1} y at block sizes
// d = 9..15, with d a runtime argument, on the chunk-major layout.
//
// Replaces (cyclic_gps_tpu/ops/pallas_wide.py):
//   rt_collect_kernel  <- :366 forward_sweep_collect_wide_pallas
//                         (kernel body _wide_collect_kernel, :258)
//   rt_backsub_kernel  <- :496 backward_substitute_wide_pallas
//                         (_wide_backsub_kernel, :462)
// and stands for the plain Pallas kernels they are the wide twins of,
// pallas_sweep.py:400 forward_sweep_collect_pallas and :1006
// backward_substitute_pallas (kernels 8 and 9, solve_sweep.cu at d <= 8),
// at d = 9..15: the same boundary, the same sweep, hats and pivot rule.
//
// The TPU kernels take the wide layout (an 8 x 8 block plus row-packed
// strips), which exists for the TPU's 8-sublane tiles.  It is not carried
// over: on the H100 it would only add relayout passes on the host and an
// unpack / pack per block in the thread.  These kernels read and write the
// chunk-major [s, d, d, C] / [s, d, C] stacks of kernels 8 and 9, so the
// engine's glue (partitioned._hat_sweep, _back_substitute) is the same at
// every d.
//
// Outputs as solve_sweep.cu: the sweep's final state (acc00, accy0, W0, w,
// D, 1/diag D), the lanes' mh and ld partials, and for every interior step
// j = 1..s-1 (stack row j-1) hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0,
// hat_w = D^{-T} w by back substitution against D^T, and the row's pivot
// log-det 2 log|D_j|.  The back-substitution walks rows s-2 .. 0:
//   x_{s-1} = hat_w - hat_W0 x_b - hat_W1 x_{b,next}
//   x_j     = hat_w - hat_W0 x_b - hat_C x_{j+1}
//
// What bounds them on the H100: per row the sweep reads 2 d^2 + d values
// and writes 2 d^2 + d + 1, the back-substitution reads 2 d^2 + d and
// writes d (~2.4 GB and ~1.2 GB at d = 12, N = 1e6, float32: byte bounds
// of ~0.72 and ~0.37 ms).  One thread per chunk lane walks the lane's s-1
// rows in order, each row of the sweep a dependent chain of ~10 d^3
// operations on blocks in local memory (rtblock.cuh: d is a runtime value,
// so one instance per dtype serves d = 9..15), with C = N/s lanes (7,813 at
// N = 1e6, s = 128): latency- and occupancy-bound, far from both bounds.
// A warp per chunk, or blocks in shared memory, is later work.
#include "rtblock.cuh"

namespace {

using namespace cgt::rt;

template <typename T>
__global__ void __launch_bounds__(CGT_THREADS)
rt_collect_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                  const T* __restrict__ ym, T jitter, int s, int d, int C,
                  T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl, T* mh,
                  T* ld, T* hc, T* hw0, T* hw, T* ld_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Carry<T> st;
  Mat<T> o_left, P, o_j, t;
  Vec<T> y_j;
  load_m<T>(Om, 0, d, C, c, o_left);
  for (int j = 1; j < s; ++j) {
    load_m<T>(Rm, j, d, C, c, P);
    for (int i = 0; i < d; ++i) P[i][i] += jitter;
    load_m<T>(Om, j, d, C, c, o_j);
    load_v<T>(ym, j, d, C, c, y_j);
    const T ldl = elim_step<T>(j == 1, P, o_j, y_j, o_left, st, t, d);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;
    // P and t are scratch from here on
    transpose<T>(st.cprev, P, d);
    solve_lower_t<T>(st.D, st.invd, P, t, d);
    store_m<T>(hc, j - 1, d, C, c, t);
    solve_lower_t<T>(st.D, st.invd, st.w0, t, d);
    store_m<T>(hw0, j - 1, d, C, c, t);
    solve_lower_t_vec<T>(st.D, st.invd, st.w, y_j, d);
    store_v<T>(hw, j - 1, d, C, c, y_j);
  }
  store_m<T>(acc00, 0, d, C, c, st.acc);
  store_v<T>(accy0, 0, d, C, c, st.accy0);
  store_m<T>(w0l, 0, d, C, c, st.w0);
  store_v<T>(wl, 0, d, C, c, st.w);
  store_m<T>(dl, 0, d, C, c, st.D);
  store_v<T>(invdl, 0, d, C, c, st.invd);
  mh[c] = st.mh;
  ld[c] = st.ld;
}

template <typename T>
__global__ void __launch_bounds__(CGT_THREADS)
rt_backsub_kernel(const T* __restrict__ hc, const T* __restrict__ hw0,
                  const T* __restrict__ hw, const T* __restrict__ hw1_p,
                  const T* __restrict__ xb_p, const T* __restrict__ xbn_p,
                  int s, int d, int C, T* x_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Mat<T> m;
  Vec<T> xb, x, common, tv;
  load_v<T>(xb_p, 0, d, C, c, xb);
  for (int r = s - 2; r >= 0; --r) {
    load_v<T>(hw, r, d, C, c, common);
    load_m<T>(hw0, r, d, C, c, m);
    mv_op<T, false>(m, xb, tv, d);
    for (int i = 0; i < d; ++i) common[i] -= tv[i];
    if (r == s - 2) {
      load_m<T>(hw1_p, 0, d, C, c, m);
      load_v<T>(xbn_p, 0, d, C, c, x);  // x_{b,next} in place of x_{j+1}
    } else {
      load_m<T>(hc, r, d, C, c, m);
    }
    mv_op<T, false>(m, x, tv, d);
    for (int i = 0; i < d; ++i) x[i] = common[i] - tv[i];
    store_v<T>(x_out, r, d, C, c, x);
  }
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_collect(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                   int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                   T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                   T* ld_rows, cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  rt_collect_kernel<T><<<blocks_for(C), CGT_THREADS, 0, stream>>>(
      R_cm, O_cm, y_cm, jitter, s, d, C, acc00, accy0, w0l, wl, dl, invdl,
      mh, ld, hc, hw0, hw, ld_rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsub(const T* hc, const T* hw0, const T* hw, const T* hw1,
                   const T* xb, const T* xbn, int s, int d, int C, T* x,
                   cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  rt_backsub_kernel<T><<<blocks_for(C), CGT_THREADS, 0, stream>>>(
      hc, hw0, hw, hw1, xb, xbn, s, d, C, x);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_RT_SOLVE(T, SUF)                                                  \
  int cgt_rt_forward_sweep_collect_##SUF(                                    \
      const T* R_cm, const T* O_cm, const T* y_cm, T jitter, int s, int d,   \
      int C, T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl, T* mh,      \
      T* ld, T* hc, T* hw0, T* hw, T* ld_rows, void* stream) {               \
    return launch_collect<T>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,       \
                             accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0, hw, \
                             ld_rows, (cudaStream_t)stream);                 \
  }                                                                           \
  int cgt_rt_backward_substitute_##SUF(const T* hc, const T* hw0,            \
                                       const T* hw, const T* hw1,            \
                                       const T* xb, const T* xbn, int s,     \
                                       int d, int C, T* x, void* stream) {   \
    return launch_backsub<T>(hc, hw0, hw, hw1, xb, xbn, s, d, C, x,          \
                             (cudaStream_t)stream);                          \
  }

CGT_RT_SOLVE(float, f32)
CGT_RT_SOLVE(double, f64)
#undef CGT_RT_SOLVE

}  // extern "C"
