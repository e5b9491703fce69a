// Forward sweep of the partitioned engine on WIDE-layout inputs (block size
// d = 8 + e, e in 1..7), plain and collecting the shared backward stacks.
//
// Replaces (cyclic_gps_tpu/ops/pallas_wide.py):
//   wide_sweep_kernel<T, false>  <- :166 forward_sweep_wide_pallas
//                                   (kernel body _wide_sweep_kernel, :33)
//   wide_sweep_kernel<T, true>   <- :998 forward_sweep_solveinv_wide_pallas
//                                   (_wide_solveinv_kernel, :884)
//
// Inputs R11 / O11 [s, 8, 8, C], Rst / Ost [s, 3e, 8, C], y [s, d, C]; the
// matrix outputs are wide pairs too (wideblock.cuh), so the kernels, their
// plain twins (ops/wide_cuda.py) and the JAX package exchange the same
// arrays.  Stacks stay at the true chunk count C: the TPU kernels' padding
// of the chunk axis to their lane tile (and its log-det correction) has no
// counterpart here.
//
// What bounds them on the H100: one thread per chunk lane walks its s-1
// interior rows in order, each a dependent chain of d x d Cholesky, solves
// and products (~15 d^3 operations, ~22 d^3 with the collect), so with
// C = N/s lanes (7,813 at N = 1e6, s = 128) they are latency- and
// occupancy-bound, far from both the byte bound (each input row read once,
// 2 d^2 + d values) and the operation bound.  The TPU kernels' 8-aligned
// panel algebra exists for its 8-sublane tiles and is not carried over: a
// thread unpacks each block to a dense d x d array (local memory; d is a
// runtime value, so one instance per dtype serves e = 1..7 and the build
// stays cheap) and runs the same elimination as forward_sweep.cu.  A warp
// per chunk, or blocks in registers, is later work.
#include "wideblock.cuh"

namespace {

using namespace cgt::wide;

template <typename T, bool COLLECT>
__global__ void __launch_bounds__(CGT_THREADS)
wide_sweep_kernel(const T* __restrict__ R11, const T* __restrict__ Rst,
                  const T* __restrict__ O11, const T* __restrict__ Ost,
                  const T* __restrict__ ym, T jitter, int s, int e, int C,
                  T* acc11, T* accst, T* accy0, T* w011, T* w0st, T* wl,
                  T* d11, T* dst, T* invd, T* mh, T* ld, T* hc11, T* hcst,
                  T* hw011, T* hw0st, T* hw, T* pinv11, T* pinvst) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int d = 8 + e;
  Carry<T> st;
  Mat<T> o_left, P, o_j, t;
  Vec<T> y_j;
  load_w<T>(O11, Ost, 0, e, C, c, o_left);
  for (int j = 1; j < s; ++j) {
    load_w<T>(R11, Rst, j, e, C, c, P);
    for (int i = 0; i < d; ++i) P[i][i] += jitter;
    load_w<T>(O11, Ost, j, e, C, c, o_j);
    load_v<T>(ym, j, d, C, c, y_j);
    elim_step<T>(j == 1, P, o_j, y_j, o_left, st, t, d);
    if constexpr (COLLECT) {
      // the hats and pinv from the triangular inverse di = D^{-1}, as the
      // TPU kernel's emit: hat_C = di^T C^T, hat_W0 = di^T W0,
      // hat_w = di^T w, pinv = di^T di
      Mat<T>& di = o_j;  // scratch from here on
      for (int i = 0; i < d; ++i)
        for (int k = 0; k < d; ++k) P[i][k] = (i == k) ? T(1) : T(0);
      solve_lower<T>(st.D, st.invd, P, di, d);
      transpose<T>(st.cprev, P, d);
      mm_ta<T>(di, P, t, d);
      store_w<T>(hc11, hcst, j - 1, e, C, c, t);
      mm_ta<T>(di, st.w0, t, d);
      store_w<T>(hw011, hw0st, j - 1, e, C, c, t);
      mv_op<T, true>(di, st.w, y_j, d);
      store_v<T>(hw, j - 1, d, C, c, y_j);
      mm_ta<T>(di, di, t, d);
      store_w<T>(pinv11, pinvst, j - 1, e, C, c, t);
    }
  }
  store_w<T>(acc11, accst, 0, e, C, c, st.acc);
  store_v<T>(accy0, 0, d, C, c, st.accy0);
  store_w<T>(w011, w0st, 0, e, C, c, st.w0);
  store_v<T>(wl, 0, d, C, c, st.w);
  store_w<T>(d11, dst, 0, e, C, c, st.D);
  store_v<T>(invd, 0, d, C, c, st.invd);
  mh[c] = st.mh;
  ld[c] = st.ld;
}

template <typename T, bool COLLECT>
int launch_wide_sweep(const T* R11, const T* Rst, const T* O11, const T* Ost,
                      const T* y, T jitter, int s, int e, int C, T* acc11,
                      T* accst, T* accy0, T* w011, T* w0st, T* wl, T* d11,
                      T* dst, T* invd, T* mh, T* ld, T* hc11, T* hcst,
                      T* hw011, T* hw0st, T* hw, T* pinv11, T* pinvst,
                      cudaStream_t stream) {
  if (e < 1 || e > WMAX - 8) return int(cudaErrorInvalidValue);
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
  wide_sweep_kernel<T, COLLECT><<<blocks, CGT_THREADS, 0, stream>>>(
      R11, Rst, O11, Ost, y, jitter, s, e, C, acc11, accst, accy0, w011,
      w0st, wl, d11, dst, invd, mh, ld, hc11, hcst, hw011, hw0st, hw, pinv11,
      pinvst);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_WIDE_SWEEP(T, SUF)                                                \
  int cgt_wide_sweep_##SUF(const T* R11, const T* Rst, const T* O11,         \
                           const T* Ost, const T* y, T jitter, int s, int e, \
                           int C, T* acc11, T* accst, T* accy0, T* w011,     \
                           T* w0st, T* wl, T* d11, T* dst, T* invd, T* mh,   \
                           T* ld, void* stream) {                            \
    return launch_wide_sweep<T, false>(                                       \
        R11, Rst, O11, Ost, y, jitter, s, e, C, acc11, accst, accy0, w011,  \
        w0st, wl, d11, dst, invd, mh, ld, nullptr, nullptr, nullptr,        \
        nullptr, nullptr, nullptr, nullptr, (cudaStream_t)stream);           \
  }                                                                           \
  int cgt_wide_sweep_solveinv_##SUF(                                         \
      const T* R11, const T* Rst, const T* O11, const T* Ost, const T* y,    \
      T jitter, int s, int e, int C, T* acc11, T* accst, T* accy0, T* w011,  \
      T* w0st, T* wl, T* d11, T* dst, T* invd, T* mh, T* ld, T* hc11,        \
      T* hcst, T* hw011, T* hw0st, T* hw, T* pinv11, T* pinvst,              \
      void* stream) {                                                         \
    return launch_wide_sweep<T, true>(                                        \
        R11, Rst, O11, Ost, y, jitter, s, e, C, acc11, accst, accy0, w011,  \
        w0st, wl, d11, dst, invd, mh, ld, hc11, hcst, hw011, hw0st, hw,     \
        pinv11, pinvst, (cudaStream_t)stream);                               \
  }

CGT_WIDE_SWEEP(float, f32)
CGT_WIDE_SWEEP(double, f64)
#undef CGT_WIDE_SWEEP

}  // extern "C"
