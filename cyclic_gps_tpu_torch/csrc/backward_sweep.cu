// The two kernels of the analytic backward of (mahal, logdet): the forward
// sweep that streams the shared hat stacks, and the descending pass that
// runs the back-substitution and the hat-form Takahashi recursion on them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   forward_sweep_solveinv_kernel,  <- :772 forward_sweep_solveinv_pallas
//   solveinv_warp_kernel               (kernel body _sweep_solveinv_kernel,
//                                      :699)
//   backward_solve_takahashi_kernel, <- :918 backward_solve_takahashi_pallas
//   backsolve_warp_kernel               (_backsolve_takahashi_kernel, :845)
//
// What bounds them on the H100: both are streaming passes over stacks of
// R x R blocks, each chunk lane c walking that chunk's s-1 rows in order
// (ascending for the sweep, descending for the walk).  Per row the sweep
// reads 2 R^2 + R floats and writes 3 R^2 + R; the walk reads the same
// 3 R^2 + R and writes 2 R^2 + R -- so in bytes they sit at about the
// card's memory rate for ~540 MB each at rank 5, N = 1e6 (~0.16 ms).  But
// with C = N/s lanes (7,813 at s = 128: ~61 blocks of 128 for 132 SMs)
// each lane runs a dependent chain of ~15 R x R products per row, so like
// the forward sweep they are latency- and occupancy-bound, not
// bandwidth-bound.
//
// Two designs, routed by block size in the launchers:
// * R = 1..8: ONE THREAD PER CHUNK LANE.  Everything carried between rows
//   (the elimination state; phi, u0, u1 and x_{j+1} of the walk) stays in
//   registers, each stack row is read or written exactly once, and the lane
//   axis is innermost so every access coalesces.  The descending walk
//   indexes its rows backwards with plain strides -- no reversed copy.
// * R = 16 (the celerite family's boundary chain at nblocks = 8: C = 245
//   lanes of s = 32 at N = 1e6, then 8): ONE WARP PER CHUNK LANE on
//   rtcoop.cuh, as the kernels of block sizes 9-15.  Held per thread, a
//   16 x 16 row is ~14 blocks of local memory and 245 threads fill two of
//   the card's 132 SMs, so one lane's chain of dependent products ran from
//   memory at one thread's pace.  Here the lane's blocks sit in shared
//   memory and its 32 threads share every product, the Cholesky's trailing
//   updates and the triangular solves; the 8 (float32) or 4 (float64)
//   lanes of a thread block load and store their rows as whole 32-byte
//   spans.  The sweep is Sweep::step on the d = 16 triangle Tri16 followed
//   by Sweep::hats, the hats from di = D^{-1} as wide_sweep.cu's
//   collecting sweep (kernel 21) builds them; the walk is wide_backward.cu's
//   recursion (kernel 22) on chunk-major tiles.  Both sum as the thread
//   kernels do, so the two designs agree to rounding.
#include "blockmath.cuh"
#include "rtcoop.cuh"

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

namespace co = cgt::coop;

// the block size of the warp-per-lane instances
constexpr int WARP_D = 16;

// The sweep's lane region: Sweep's blocks and vectors, then di = D^{-1},
// hat_C, pinv and hat_w (hat_W0 goes into Sweep's free X).
enum { SV_DI = co::SW_BLOCKS, SV_HC, SV_PINV, SV_BLOCKS };
enum { SV_HW = co::SW_VECS, SV_VECS };

// forward_sweep_solveinv_kernel<T, 16> as one warp per chunk lane: per row
// Sweep::step, then Sweep::hats (di = D^{-1} one column per thread, and
// hat_C = di^T C^T, hat_W0 = di^T W0, hat_w = di^T w, pinv = di^T di).
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
solveinv_warp_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                     const T* __restrict__ ym, T jitter, int s, int C,
                     T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                     T* mh, T* ld, T* hc, T* hw0, T* hw, T* pinv,
                     T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int d = WARP_D;
  const int stride = co::region(d, SV_BLOCKS, SV_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri16 tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C;
  co::Sweep<T> sw(sm + tl * stride, d, SV_BLOCKS);
  const int o_di = sw.block(SV_DI), o_hc = sw.block(SV_HC);
  const int o_pinv = sw.block(SV_PINV), o_hw = sw.vec(SV_HW);
  const int o_sc = sw.vec(co::SW_SC);
  tile.load_m(Om, 0, sw.w0);  // o_left
  for (int j = 1; j < s; ++j) {
    tile.load_m(Rm, j, sw.p);
    tile.load_m(Om, j, sw.o);
    tile.load_v(ym, j, sw.y);
    __syncthreads();
    T ldl = T(0);
    if (live) ldl = sw.step(w, tri, j == 1, jitter);
    sw.advance(j == 1);
    if (live) {
      sw.hats(w, o_di, o_hc, o_pinv, o_hw);
      if (w.lane == 0) sw.at(o_sc)[0] = T(2) * ldl;
    }
    __syncthreads();
    tile.store_m(hc, j - 1, o_hc);
    tile.store_m(hw0, j - 1, sw.x);
    tile.store_v(hw, j - 1, o_hw);
    tile.store_m(pinv, j - 1, o_pinv);
    tile.store_s(ld_rows, j - 1, o_sc);
  }
  if (live && w.lane == 0) {
    sw.at(o_sc)[1] = sw.mh;
    sw.at(o_sc)[2] = sw.ld;
  }
  __syncthreads();
  tile.store_m(acc00, 0, sw.block(co::SW_ACC));
  tile.store_v(accy0, 0, sw.vec(co::SW_ACCY0));
  tile.store_m(w0l, 0, sw.w0);
  tile.store_v(wl, 0, sw.wv);
  tile.store_m(dl, 0, sw.p);
  tile.store_v(invdl, 0, sw.vec(co::SW_INVD));
  tile.store_s(mh, 0, o_sc + 1);
  tile.store_s(ld, 0, o_sc + 2);
}

// The walk's lane region: 14 blocks and 5 vectors (wide_backward.cu's).
enum { BW_P00, BW_P01, BW_P10, BW_P11, BW_PHI, BW_U0, BW_U1, BW_HC, BW_HW0,
       BW_PINV, BW_U1N, BW_A0, BW_A1, BW_OF, BW_BLOCKS };
enum { BW_XB, BW_XA, BW_XN, BW_HW, BW_XBN, BW_VECS };

// xn = (hw - hw0 xb) - m x, one element per thread
template <typename T>
__device__ __forceinline__ void back_row(const co::Warp& w, const T* hw,
                                         const T* hw0, const T* xb,
                                         const T* m, const T* x, T* xn) {
  const int i = w.lane, d = w.d, ld = w.ld;
  if (i >= d) return;
  T a = hw0[i * ld] * xb[0];
  for (int p = 1; p < d; ++p) a += hw0[i * ld + p] * xb[p];
  const T common = hw[i] - a;
  T b = m[i * ld] * x[0];
  for (int p = 1; p < d; ++p) b += m[i * ld + p] * x[p];
  xn[i] = common - b;
}

// backward_solve_takahashi_kernel<T, 16> as one warp per chunk lane: the
// rows of wide_backward.cu's kernel 22 on chunk-major tiles.  (Not shared
// with kernel 22 through a helper: with nvcc 12.8 for sm_90a that moved
// kernel 22's register allocation, 166 / 80 registers at float64 /
// float32 to 157-161 / 72.)  The carried blocks (p00..p11, phi, u0, u1)
// never leave the SM, and phi, u0, u1 and x hand over to the next row by
// swapping offsets with the blocks the row's inputs land in.  hat_C is
// read from row s-3 down (the seed row s-2 does not use it).
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
backsolve_warp_kernel(
    const T* __restrict__ hc_p, const T* __restrict__ hw0_p,
    const T* __restrict__ hw_p, const T* __restrict__ pinv_p,
    const T* __restrict__ hw1_p, const T* __restrict__ xb_p,
    const T* __restrict__ xbn_p, const T* __restrict__ p00_p,
    const T* __restrict__ p01_p, const T* __restrict__ p10_p,
    const T* __restrict__ p11_p, int s, int C, T* x_out, T* diag_out,
    T* off_out, T* u0f, T* u1f) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int d = WARP_D;
  const int stride = co::region(d, BW_BLOCKS, BW_VECS);
  const int bs = d * co::pad_ld(d);
  const int vb = BW_BLOCKS * bs;  // the vectors follow the blocks
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const int wl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + wl < C;
  T* me = sm + wl * stride;
  T* const p00 = me + BW_P00 * bs;
  T* const p01 = me + BW_P01 * bs;
  T* const p10 = me + BW_P10 * bs;
  T* const p11 = me + BW_P11 * bs;
  T* const hc = me + BW_HC * bs;  // hat_C, then Sigma_jj
  T* const a0 = me + BW_A0 * bs;
  T* const a1 = me + BW_A1 * bs;
  T* const of = me + BW_OF * bs;
  const T* const xb = me + vb + BW_XB * d;
  const T* const hwv = me + vb + BW_HW * d;
  const T* const xbn = me + vb + BW_XBN * d;
  // carried blocks and their partners, swapped at the end of every step
  int o_phi = BW_PHI * bs, o_pinv = BW_PINV * bs;  // phi_{j+1} | pinv -> phi_j
  int o_u0 = BW_U0 * bs, o_hw0 = BW_HW0 * bs;      // u0_{j+1} | hat_W0 -> u0_j
  int o_u1 = BW_U1 * bs, o_u1n = BW_U1N * bs;      // u1_{j+1} | u1_j
  int o_x = vb + BW_XA * d, o_xn = vb + BW_XN * d;  // x_{j+1} | x_j
  tile.load_m(p00_p, 0, BW_P00 * bs);
  tile.load_m(p01_p, 0, BW_P01 * bs);
  tile.load_m(p10_p, 0, BW_P10 * bs);
  tile.load_m(p11_p, 0, BW_P11 * bs);
  tile.load_v(xb_p, 0, vb + BW_XB * d);
  for (int r = s - 2; r >= 0; --r) {
    const bool first = r == s - 2;
    if (!first) tile.load_m(hc_p, r, BW_HC * bs);
    tile.load_m(hw0_p, r, o_hw0);
    tile.load_m(pinv_p, r, o_pinv);
    tile.load_v(hw_p, r, vb + BW_HW * d);
    if (first) {
      tile.load_m(hw1_p, 0, o_u1n);  // u1_{s-1} = hat_W1
      tile.load_v(xbn_p, 0, vb + BW_XBN * d);
    }
    __syncthreads();
    if (live) {
      T* const phi = me + o_phi;
      T* const pinv = me + o_pinv;
      T* const u0 = me + o_u0;
      T* const hw0 = me + o_hw0;
      T* const u1 = me + o_u1;
      T* const u1n = me + o_u1n;
      if (first) {
        back_row<T>(w, hwv, hw0, xb, u1n, xbn, me + o_xn);
        co::sig_ut<T>(w, p00, p01, p10, p11, hw0, u1n, a0, a1);
        __syncwarp();
        co::mm2_add<T>(w, pinv, hw0, a0, u1n, a1, hc);  // Sigma_jj
        co::neg<T>(w, a1, of);                           // Sigma_{j+1,j}
      } else {
        back_row<T>(w, hwv, hw0, xb, hc, me + o_x, me + o_xn);
        co::mm_op<T, false, true, co::NEG>(w, phi, hc, of);  // phi_off
        co::mm<T>(w, hc, phi, a0);                            // hat_C phi
        co::mm_op<T, false, false, co::NEG>(w, hc, u1, u1n);  // u1_j
        __syncwarp();
        co::mm_op<T, false, true, co::ADD>(w, a0, hc, pinv);  // phi_j
        co::mm_op<T, false, false, co::SUB>(w, hc, u0, hw0);  // u0_j
        __syncwarp();
        co::sig_ut<T>(w, p00, p01, p10, p11, hw0, u1n, a0, a1);
        __syncwarp();
        co::mm2_add<T>(w, pinv, hw0, a0, u1n, a1, hc);  // Sigma_jj
        co::mm2_add<T>(w, of, u0, a0, u1, a1, of);      // Sigma_{j+1,j}
      }
    }
    // phi_j, u0_j, u1_j and x_j carry to the next step
    const int t_phi = o_phi, t_u0 = o_u0, t_u1 = o_u1, t_x = o_x;
    o_phi = o_pinv;
    o_pinv = t_phi;
    o_u0 = o_hw0;
    o_hw0 = t_u0;
    o_u1 = o_u1n;
    o_u1n = t_u1;
    o_x = o_xn;
    o_xn = t_x;
    __syncthreads();
    tile.store_v(x_out, r, o_x);
    tile.store_m(diag_out, r, BW_HC * bs);
    tile.store_m(off_out, r, BW_OF * bs);
    __syncthreads();  // the next step's load overwrites hat_C's block
  }
  tile.store_m(u0f, 0, o_u0);
  tile.store_m(u1f, 0, o_u1);
}

// dynamic shared bytes of one thread block of the sweep and of the walk
template <typename T>
size_t solveinv_warp_smem() {
  return co::smem_bytes<T>(WARP_D, SV_BLOCKS, SV_VECS);
}

template <typename T>
size_t backsolve_warp_smem() {
  return co::smem_bytes<T>(WARP_D, BW_BLOCKS, BW_VECS);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

template <typename T>
int launch_solveinv(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                    int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                    T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                    T* pinv, T* ld_rows, cudaStream_t stream) {
  if (d == WARP_D) {
    const size_t smem = solveinv_warp_smem<T>();
    const cudaError_t err = co::prepare(solveinv_warp_kernel<T>, smem);
    if (err != cudaSuccess) return int(err);
    solveinv_warp_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS,
                              smem, stream>>>(
        R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, mh,
        ld, hc, hw0, hw, pinv, ld_rows);
    return int(cudaGetLastError());
  }
#define CGT_LAUNCH(RR)                                                     \
  forward_sweep_solveinv_kernel<T, RR>                                     \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                         \
          R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, \
          mh, ld, hc, hw0, hw, pinv, ld_rows)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsolve(const T* hc, const T* hw0, const T* hw, const T* pinv,
                     const T* hw1, const T* xb, const T* xbn, const T* p00,
                     const T* p01, const T* p10, const T* p11, int s, int d,
                     int C, T* x, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
  if (d == WARP_D) {
    const size_t smem = backsolve_warp_smem<T>();
    const cudaError_t err = co::prepare(backsolve_warp_kernel<T>, smem);
    if (err != cudaSuccess) return int(err);
    backsolve_warp_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS,
                               smem, stream>>>(
        hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01, p10, p11, s, C, x, diag,
        off, u0f, u1f);
    return int(cudaGetLastError());
  }
#define CGT_LAUNCH(RR)                                                      \
  backward_solve_takahashi_kernel<T, RR>                                    \
      <<<blocks_for(C), CGT_THREADS, 0, stream>>>(                          \
          hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01, p10, p11, s, C, x,     \
          diag, off, u0f, u1f)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
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

// dynamic shared bytes per thread block of the warp-per-lane sweep and
// walk at block size d (16 only; the second argument 1 for float64)
int cgt_solveinv_warp_smem_bytes(int d, int f64) {
  if (d != WARP_D) return -1;
  return int(f64 ? solveinv_warp_smem<double>() : solveinv_warp_smem<float>());
}

int cgt_backsolve_warp_smem_bytes(int d, int f64) {
  if (d != WARP_D) return -1;
  return int(f64 ? backsolve_warp_smem<double>()
                 : backsolve_warp_smem<float>());
}

}  // extern "C"
