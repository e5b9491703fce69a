// The descending pass of the analytic backward on WIDE-layout stacks (block
// size d = 8 + e, e in 1..7): back-substitution fused with the hat-form
// Takahashi recursion, one chunk lane per thread.
//
// Replaces: cyclic_gps_tpu/ops/pallas_wide.py:1199
// backward_solve_takahashi_wide_pallas (kernel body
// _wide_backsolve_takahashi_kernel, :1093), the wide twin of
// backward_sweep.cu's backward_solve_takahashi_kernel.
//
// Inputs: the stacks of wide_sweep.cu's collect instance (hat_C, hat_W0,
// pinv as wide pairs [s-1, 8, 8, C] / [s-1, 3e, 8, C], hat_w [s-1, d, C]),
// the right coupling's hat hat_W1 as a wide pair, the boundary solution
// x_b and its next-chunk shift [d, C], and the reduced system's
// selected-inverse blocks p00, p01, p10, p11 as wide pairs [8, 8, C] /
// [3e, 8, C].  Outputs: x rows [s-1, d, C], Sigma_jj and Sigma_{j+1,j} as
// wide stacks, and the final u0 / u1 as wide pairs.  Per step:
//   x_j     = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}
//   phi_off = -phi_{j+1} hat_C_j^T
//   phi_j   = pinv_j + hat_C_j phi_{j+1} hat_C_j^T
//   u0_j    = hat_W0_j - hat_C_j u0_{j+1},   u1_j = -hat_C_j u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
// with (a0, a1) = Sigma_BB U^T; row s-2 seeds phi = pinv, u0 = hat_W0,
// u1 = hat_W1 and carries the W1 term of the solve.
//
// What bounds it on the H100: per row it reads 3 d^2 + d values and writes
// 2 d^2 + d, but each thread runs a dependent chain of ~26 d^3 operations
// on blocks in local memory, with C = N/s lanes: latency- and
// occupancy-bound, like wide_sweep.cu.  The design is that of the plain
// kernel with d a runtime value (rtblock.cuh): one instance per dtype,
// the rows walked backwards with plain strides, every stack row read or
// written once.  Spreading a chunk over a warp is later work.
#include "wideblock.cuh"

namespace {

using namespace cgt::wide;

template <typename T>
__global__ void __launch_bounds__(CGT_THREADS)
wide_backward_kernel(
    const T* __restrict__ hc11, const T* __restrict__ hcst,
    const T* __restrict__ hw011, const T* __restrict__ hw0st,
    const T* __restrict__ hw, const T* __restrict__ pinv11,
    const T* __restrict__ pinvst, const T* __restrict__ hw1_11,
    const T* __restrict__ hw1_st, const T* __restrict__ xb_p,
    const T* __restrict__ xbn_p, const T* __restrict__ p00_11,
    const T* __restrict__ p00_st, const T* __restrict__ p01_11,
    const T* __restrict__ p01_st, const T* __restrict__ p10_11,
    const T* __restrict__ p10_st, const T* __restrict__ p11_11,
    const T* __restrict__ p11_st, int s, int e, int C, T* x_out, T* dg11,
    T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst, T* u1f11, T* u1fst) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int d = 8 + e;
  Mat<T> p00, p01, p10, p11, phi, u0, u1;
  load_w<T>(p00_11, p00_st, 0, e, C, c, p00);
  load_w<T>(p01_11, p01_st, 0, e, C, c, p01);
  load_w<T>(p10_11, p10_st, 0, e, C, c, p10);
  load_w<T>(p11_11, p11_st, 0, e, C, c, p11);
  Vec<T> xb, x, common, tv;
  load_v<T>(xb_p, 0, d, C, c, xb);
  // per row: hc, hw0 (becomes u0_j), pinv (becomes phi_j), u1n = u1_j
  Mat<T> hc, hw0, pinv, u1n, a0, a1, dg, of, t;
  for (int r = s - 2; r >= 0; --r) {
    load_w<T>(hc11, hcst, r, e, C, c, hc);
    load_w<T>(hw011, hw0st, r, e, C, c, hw0);
    load_w<T>(pinv11, pinvst, r, e, C, c, pinv);
    load_v<T>(hw, r, d, C, c, common);
    mv_op<T, false>(hw0, xb, tv, d);
    for (int i = 0; i < d; ++i) common[i] -= tv[i];
    if (r == s - 2) {
      Vec<T> xbn;
      load_w<T>(hw1_11, hw1_st, 0, e, C, c, u1);
      load_v<T>(xbn_p, 0, d, C, c, xbn);
      mv_op<T, false>(u1, xbn, tv, d);
      for (int i = 0; i < d; ++i) x[i] = common[i] - tv[i];
      copy_<T>(pinv, phi, d);
      copy_<T>(hw0, u0, d);
      sig_ut<T>(p00, p01, p10, p11, u0, u1, a0, a1, t, d);
      copy_<T>(phi, dg, d);
      mm_add<T>(u0, a0, dg, t, d);
      mm_add<T>(u1, a1, dg, t, d);
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) of[i][k] = -a1[i][k];
    } else {
      mv_op<T, false>(hc, x, tv, d);
      for (int i = 0; i < d; ++i) x[i] = common[i] - tv[i];
      // phi_off (into of), phi_j (into pinv), u0_j (into hw0), u1_j
      mm_tb<T>(phi, hc, of, d);
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) of[i][k] = -of[i][k];
      mm<T>(hc, phi, a0, d);
      mm_tb<T>(a0, hc, t, d);
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) pinv[i][k] += t[i][k];
      mm<T>(hc, u0, t, d);
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) hw0[i][k] -= t[i][k];
      mm<T>(hc, u1, u1n, d);
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) u1n[i][k] = -u1n[i][k];
      sig_ut<T>(p00, p01, p10, p11, hw0, u1n, a0, a1, t, d);
      copy_<T>(pinv, dg, d);
      mm_add<T>(hw0, a0, dg, t, d);
      mm_add<T>(u1n, a1, dg, t, d);
      mm_add<T>(u0, a0, of, t, d);
      mm_add<T>(u1, a1, of, t, d);
      copy_<T>(pinv, phi, d);
      copy_<T>(hw0, u0, d);
      copy_<T>(u1n, u1, d);
    }
    store_v<T>(x_out, r, d, C, c, x);
    store_w<T>(dg11, dgst, r, e, C, c, dg);
    store_w<T>(of11, ofst, r, e, C, c, of);
  }
  store_w<T>(u0f11, u0fst, 0, e, C, c, u0);
  store_w<T>(u1f11, u1fst, 0, e, C, c, u1);
}

template <typename T>
int launch_wide_backward(const T* hc11, const T* hcst, const T* hw011,
                         const T* hw0st, const T* hw, const T* pinv11,
                         const T* pinvst, const T* hw1_11, const T* hw1_st,
                         const T* xb, const T* xbn, const T* p00_11,
                         const T* p00_st, const T* p01_11, const T* p01_st,
                         const T* p10_11, const T* p10_st, const T* p11_11,
                         const T* p11_st, int s, int e, int C, T* x, T* dg11,
                         T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst,
                         T* u1f11, T* u1fst, cudaStream_t stream) {
  if (e < 1 || e > WMAX - 8) return int(cudaErrorInvalidValue);
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
  wide_backward_kernel<T><<<blocks, CGT_THREADS, 0, stream>>>(
      hc11, hcst, hw011, hw0st, hw, pinv11, pinvst, hw1_11, hw1_st, xb, xbn,
      p00_11, p00_st, p01_11, p01_st, p10_11, p10_st, p11_11, p11_st, s, e,
      C, x, dg11, dgst, of11, ofst, u0f11, u0fst, u1f11, u1fst);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_WIDE_BACKWARD(T, SUF)                                             \
  int cgt_wide_backward_##SUF(                                               \
      const T* hc11, const T* hcst, const T* hw011, const T* hw0st,          \
      const T* hw, const T* pinv11, const T* pinvst, const T* hw1_11,        \
      const T* hw1_st, const T* xb, const T* xbn, const T* p00_11,           \
      const T* p00_st, const T* p01_11, const T* p01_st, const T* p10_11,    \
      const T* p10_st, const T* p11_11, const T* p11_st, int s, int e,       \
      int C, T* x, T* dg11, T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst,   \
      T* u1f11, T* u1fst, void* stream) {                                     \
    return launch_wide_backward<T>(                                           \
        hc11, hcst, hw011, hw0st, hw, pinv11, pinvst, hw1_11, hw1_st, xb,    \
        xbn, p00_11, p00_st, p01_11, p01_st, p10_11, p10_st, p11_11, p11_st, \
        s, e, C, x, dg11, dgst, of11, ofst, u0f11, u0fst, u1f11, u1fst,      \
        (cudaStream_t)stream);                                                \
  }

CGT_WIDE_BACKWARD(float, f32)
CGT_WIDE_BACKWARD(double, f64)
#undef CGT_WIDE_BACKWARD

}  // extern "C"
