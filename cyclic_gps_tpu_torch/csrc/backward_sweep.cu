// The two kernels of the analytic backward of (mahal, logdet): the forward
// sweep that streams the shared hat stacks, and the descending pass that
// runs the back-substitution and the hat-form Takahashi recursion on them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   solveinv_split_kernel,          <- :772 forward_sweep_solveinv_pallas
//   solveinv_warp_kernel               (kernel body _sweep_solveinv_kernel,
//                                      :699)
//   backsolve_split_kernel,          <- :918 backward_solve_takahashi_pallas
//   backsolve_warp_kernel               (_backsolve_takahashi_kernel, :845)
//
// What bounds them on the H100: both are streaming passes over stacks of
// R x R blocks, each chunk lane c walking that chunk's s-1 rows in order
// (ascending for the sweep, descending for the walk).  Per row the sweep
// reads 2 R^2 + R floats and writes 3 R^2 + R; the walk reads the same
// 3 R^2 + R and writes 2 R^2 + R -- so in bytes they sit at about the
// card's memory rate for ~540 MB each at rank 5, N = 1e6 (~0.16 ms).  But
// with C = N/s lanes (7,813 at s = 128) each lane runs a dependent chain
// of R x R products per row, so one thread per lane leaves them latency-
// and occupancy-bound; with the chain split off, the sweep's time on the
// H100 is mostly its stores of the four stacks.
//
// Three designs, routed by block size in the launchers:
// * The sweep at R = 1..8: THE CHAIN SPLIT FROM THE OUTPUTS
//   (solveinv_split_kernel, below, on pipeline.cuh's elim_split): lane
//   groups of 32 lanes, two a block at rank 5 float32 (123 blocks at
//   N = 1e6), in each one warp running the elimination's carried part
//   while three warps copy the rows in ahead of it with cp.async and
//   form each row's hats, pinv, log-det and its terms of the sums from
//   what the chain parks in shared memory.  Where the split design loses
//   (float64 rank 8 falls into local memory: ops/_build.py's
//   ELIM_THREAD), the wrapper takes the thread-per-lane sweep
//   (forward_sweep_solveinv_kernel, kept at float64 ranks 7-8 only,
//   cgt_forward_sweep_solveinv_thread_f64).
// * The walk at R = 1..8: the same split (backsolve_split_kernel, below):
//   32 lanes a block, one warp running the rows' serial chain (x, phi,
//   u0, u1) while three warps form the selected-inverse blocks of the rows
//   before it.  It indexes its rows backwards with plain strides -- no
//   reversed copy.
#include "blockmath.cuh"
#include "pipeline.cuh"
#include "rtcoop.cuh"

namespace {

namespace pp = cgt::pipe;

// Kernel 6's outputs of stack row t (elim_split's emit): the triangular
// inverse di = D^{-1}, then hat_C = di^T C^T, hat_W0 = di^T W0, hat_w =
// di^T w and pinv = di^T di.
template <typename T, int R>
struct SolveinvHats {
  T *hc, *hw0, *hw, *pinv;
  int C;
  __device__ __forceinline__ void operator()(int t, int c, const T (&D)[R][R],
                                             const T (&invd)[R],
                                             const T (&cprev)[R][R],
                                             const T (&w0)[R][R],
                                             const T (&w)[R]) const {
    T eye[R][R], di[R][R], m[R][R], ct[R][R], v[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) eye[i][k] = (i == k) ? T(1) : T(0);
    cgt::solve_lower<T, R, R>(D, invd, eye, di);
    cgt::transpose<T, R>(cprev, ct);
    cgt::mm_ta<T, R>(di, ct, m);  // di^T C^T
    cgt::store_mat<T, R>(hc, t, C, c, m);
    cgt::mm_ta<T, R>(di, w0, m);
    cgt::store_mat<T, R>(hw0, t, C, c, m);
    cgt::mv_ta<T, R>(di, w, v);
    cgt::store_vec<T, R>(hw, t, C, c, v);
    cgt::mm_ta<T, R>(di, di, m);
    cgt::store_mat<T, R>(pinv, t, C, c, m);
  }
};

// Kernel 6 at ranks 1-8: the forward sweep that also writes, for every
// interior step j = 1..s-1 (stack row j-1): hat_C = D^{-T} C^T, hat_W0 =
// D^{-T} W0, hat_w = D^{-T} w and pinv = P^{-1} = D^{-T} D^{-1}, all from
// the triangular inverse di = D^{-1} (one inversion and four products, as
// the TPU kernel's emit), and 2 log|D_j|.  The split design of
// pipeline.cuh's elim_split: a chain warp runs the elimination's carried
// part down tiles of 3 rows while three warps copy the rows in and form
// the inversion, the four products, ld_rows and the sums.
template <typename T, int R>
__global__ void __launch_bounds__(pp::Elim<T, R>::THREADS)
solveinv_split_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                      const T* __restrict__ ym, T jitter, int s, int C,
                      T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                      T* mh, T* ld, T* hc, T* hw0, T* hw, T* pinv,
                      T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  pp::elim_split<T, R>(reinterpret_cast<T*>(cgt_smem), Rm, Om, ym, jitter,
                       s, C, acc00, accy0, w0l, wl, dl, invdl, mh, ld,
                       ld_rows, SolveinvHats<T, R>{hc, hw0, hw, pinv, C});
}

// Kernel 6 one thread per chunk lane (float64 ranks 7-8 only): the carried
// state in registers, each step's hats from the triangular inverse
// di = D^{-1} as SolveinvHats forms them.
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
  const SolveinvHats<T, R> hats{hc, hw0, hw, pinv, C};
  for (int j = 1; j < s; ++j) {
    T P[R][R], o_j[R][R], y_j[R];
    cgt::load_mat<T, R>(Rm, j, C, c, P);
#pragma unroll
    for (int i = 0; i < R; ++i) P[i][i] += jitter;
    cgt::load_mat<T, R>(Om, j, C, c, o_j);
    cgt::load_vec<T, R>(ym, j, C, c, y_j);
    const T ldl = cgt::elim_step<T, R>(j == 1, P, o_j, y_j, o_left, st);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;
    hats(j - 1, c, st.D, st.invd, st.cprev, st.w0, st.w);
  }
  cgt::store_sweep_state<T, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                               mh, ld);
}

// Kernel 7 at ranks 1-8: the descending pass with the outputs taken off
// its serial chain.  Of what a row carries to the next only phi, u0, u1
// and x depend on the row before; a0, a1, Sigma_jj and Sigma_{j+1,j} read
// the chain but feed nothing back into it.  So a thread block takes 32
// chunk lanes (K7::LANES) and walks their rows in tiles of K7_ROWS = 3,
// its warps specialised: warp 0 (the chain), one thread per lane, runs
// the rows of tile u in descending order with phi, u0, u1 and x in its
// registers (x_j, and per row four products: hat_C phi, (hat_C phi)
// hat_C^T, hat_C u0 and hat_C u1; nine stay with the outputs), stores
// x_j and parks each row's (phi_j, u0_j, u1_j) in shared memory;
// warps 1-3 (the outputs) each take one row of tile u - 1 and form
//   a0, a1        = Sigma_bb U_j^T (p00..p11, read from device memory)
//   Sigma_jj      = phi_j + u0_j a0 + u1_j a1
//   Sigma_{j+1,j} = -phi_{j+1} hat_C_j^T + u0_{j+1} a0 + u1_{j+1} a1
// from the parked states of rows j and j + 1.  Two tile buffers let the
// two overlap, with one named barrier a tile.  Every sum is the
// thread-per-lane kernel's, in its order.
#define K7_ROWS 3       // rows in a tile = output warps
#define K7_THREADS 128  // warp 0 runs the chain, warps 1-3 the outputs
#define K7_STAGES 3     // rows of the chain's inputs in shared memory

// A thread block's shared memory, lane innermost: two tile buffers of
// K7_ROWS + 1 slots of (phi, u0, u1) -- slot 0 the state the tile starts
// from (its row j + 1 is the previous tile's last row), slot i + 1 the
// state after the tile's row i -- then a ring of K7_STAGES rows of the
// chain's inputs (hat_W0, hat_C, pinv, hat_w), copied in asynchronously
// two rows ahead of the chain.  32 lanes a block, or 16 or 8 where 32
// would not fit the 227 KB of shared memory a block may take.
template <typename T, int R>
struct K7 {
  static constexpr int E = 3 * R * R;            // phi, u0, u1 of one row
  static constexpr int BUF = (K7_ROWS + 1) * E;  // one tile buffer
  static constexpr int IN = 3 * R * R + R;       // one row's inputs
  static constexpr int N = 2 * BUF + K7_STAGES * IN;  // per lane
  static constexpr int LANES = pp::lanes_for(size_t(N) * sizeof(T));
  static constexpr size_t SMEM = size_t(N) * LANES * sizeof(T);
};

// Start copying row t's chain inputs into a ring slot (one group; an
// empty group past the last row keeps the count of groups per row).
template <typename T, int R>
__device__ __forceinline__ void stage_row(int t, int C, int c, T* slot,
                                          const T* __restrict__ hc,
                                          const T* __restrict__ hw0,
                                          const T* __restrict__ hw,
                                          const T* __restrict__ pinv) {
  constexpr int L = K7<T, R>::LANES;
  if (t >= 0) {
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const size_t g = cgt::mat_at<R>(t, a, b, C, c);
        pp::stage(slot + (a * R + b) * L, hw0 + g);
        pp::stage(slot + (R * R + a * R + b) * L, hc + g);
        pp::stage(slot + (2 * R * R + a * R + b) * L, pinv + g);
      }
#pragma unroll
    for (int a = 0; a < R; ++a)
      pp::stage(slot + (3 * R * R + a) * L,
                hw + cgt::vec_at<R>(t, a, C, c));
  }
  pp::stage_commit();
}

// The chain: one lane's rows of tile u, descending.  Row s-2 is the
// Takahashi seed (phi = pinv, u0 = hat_W0, u1 = hat_W1) and the last
// interior row of the solve (it carries the W1 term); every later row is
//   x_j  = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}
//   phi_j = pinv_j + hat_C_j phi_{j+1} hat_C_j^T
//   u0_j = hat_W0_j - hat_C_j u0_{j+1},   u1_j = -hat_C_j u1_{j+1}
// Row q of the chain (t = s-2-q) reads its inputs from ring slot
// q % K7_STAGES and first starts the copy of row q + K7_STAGES - 1.
template <typename T, int R>
__device__ __forceinline__ void chain_tile(
    int u, int s, int C, int c, T* buf, T* ring, const T* __restrict__ hc,
    const T* __restrict__ hw0, const T* __restrict__ hw,
    const T* __restrict__ pinv, const T* __restrict__ hw1_p,
    const T* __restrict__ xbn_p, const T (&xb)[R], T (&phi)[R][R],
    T (&u0)[R][R], T (&u1)[R][R], T (&x)[R], T* x_out) {
  using K = K7<T, R>;
  constexpr int L = K::LANES;
  if (u > 0) {
    pp::park_put<T, R, L>(buf, 0, phi);
    pp::park_put<T, R, L>(buf, R * R, u0);
    pp::park_put<T, R, L>(buf, 2 * R * R, u1);
  }
#pragma unroll 1
  for (int i = 0; i < K7_ROWS; ++i) {
    const int q = u * K7_ROWS + i;
    const int t = s - 2 - q;
    if (t < 0) break;
    stage_row<T, R>(t - (K7_STAGES - 1), C, c,
                    ring + ((q + K7_STAGES - 1) % K7_STAGES) * K::IN * L, hc,
                    hw0, hw, pinv);
    pp::stage_wait<K7_STAGES - 1>();
    const T* in = ring + (q % K7_STAGES) * K::IN * L;
    T hw0_j[R][R], common[R], tv[R];
    pp::park_get<T, R, L>(in, 0, hw0_j);
#pragma unroll
    for (int a = 0; a < R; ++a) common[a] = in[(3 * R * R + a) * L];
    cgt::mv<T, R>(hw0_j, xb, tv);
#pragma unroll
    for (int a = 0; a < R; ++a) common[a] -= tv[a];
    if (t == s - 2) {
      T xbn[R];
      cgt::load_mat<T, R>(hw1_p, 0, C, c, u1);
      cgt::load_vec<T, R>(xbn_p, 0, C, c, xbn);
      cgt::mv<T, R>(u1, xbn, tv);
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = common[a] - tv[a];
      pp::park_get<T, R, L>(in, 2 * R * R, phi);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) u0[a][b] = hw0_j[a][b];
    } else {
      T hc_j[R][R], tm[R][R];
      pp::park_get<T, R, L>(in, R * R, hc_j);
      cgt::mv<T, R>(hc_j, x, tv);
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = common[a] - tv[a];
      cgt::mm<T, R>(hc_j, phi, tm);
      cgt::mm_tb<T, R>(tm, hc_j, phi);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b)
          phi[a][b] += in[(2 * R * R + a * R + b) * L];
      cgt::mm<T, R>(hc_j, u0, tm);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) u0[a][b] = hw0_j[a][b] - tm[a][b];
      cgt::mm<T, R>(hc_j, u1, tm);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) u1[a][b] = -tm[a][b];
    }
    cgt::store_vec<T, R>(x_out, t, C, c, x);
    pp::park_put<T, R, L>(buf, (i + 1) * K::E, phi);
    pp::park_put<T, R, L>(buf, (i + 1) * K::E + R * R, u0);
    pp::park_put<T, R, L>(buf, (i + 1) * K::E + 2 * R * R, u1);
  }
}

// out = a b^T + c d^T, the two products summed as sig_ut sums them
template <typename T, int R>
__device__ __forceinline__ void mm_tb2(const T* __restrict__ a_p,
                                       const T* __restrict__ c_p, int C,
                                       int c, const T (&b)[R][R],
                                       const T (&d)[R][R], T (&out)[R][R]) {
  T m[R][R], t[R][R];
  cgt::load_mat<T, R>(a_p, 0, C, c, m);
  cgt::mm_tb<T, R>(m, b, out);
  cgt::load_mat<T, R>(c_p, 0, C, c, m);
  cgt::mm_tb<T, R>(m, d, t);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] += t[i][k];
}

// An output warp: row t's Sigma_jj and Sigma_{j+1,j} from the states
// parked after it (cur) and after row t + 1 (prev; not read at the seed
// row, whose Sigma_{j+1,j} is -a1).
template <typename T, int R>
__device__ __forceinline__ void output_row(
    int t, int s, int C, int c, const T* cur, const T* prev,
    const T* __restrict__ hc, const T* __restrict__ p00_p,
    const T* __restrict__ p01_p, const T* __restrict__ p10_p,
    const T* __restrict__ p11_p, T* diag_out, T* off_out) {
  constexpr int L = K7<T, R>::LANES;
  T u0[R][R], u1[R][R], a0[R][R], a1[R][R], m[R][R], tm[R][R];
  pp::park_get<T, R, L>(cur, R * R, u0);
  pp::park_get<T, R, L>(cur, 2 * R * R, u1);
  mm_tb2<T, R>(p00_p, p01_p, C, c, u0, u1, a0);  // Sigma_bb U^T
  mm_tb2<T, R>(p10_p, p11_p, C, c, u0, u1, a1);
  cgt::mm<T, R>(u0, a0, m);
  cgt::mm<T, R>(u1, a1, tm);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = cur[(i * R + k) * L] + m[i][k] +
                                          tm[i][k];
  cgt::store_mat<T, R>(diag_out, t, C, c, m);
  if (t == s - 2) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) m[i][k] = -a1[i][k];
  } else {
    T hc_j[R][R];
    cgt::load_mat<T, R>(hc, t, C, c, hc_j);
    pp::park_get<T, R, L>(prev, 0, m);  // phi_{j+1}
    cgt::mm_tb<T, R>(m, hc_j, tm);  // -phi_off
    pp::park_get<T, R, L>(prev, R * R, u0);
    pp::park_get<T, R, L>(prev, 2 * R * R, u1);
    cgt::mm<T, R>(u0, a0, m);
    cgt::mm<T, R>(u1, a1, hc_j);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) m[i][k] = -tm[i][k] + m[i][k] + hc_j[i][k];
  }
  cgt::store_mat<T, R>(off_out, t, C, c, m);
}

template <typename T, int R>
__global__ void __launch_bounds__(K7_THREADS)
backsolve_split_kernel(
    const T* __restrict__ hc, const T* __restrict__ hw0,
    const T* __restrict__ hw, const T* __restrict__ pinv,
    const T* __restrict__ hw1_p, const T* __restrict__ xb_p,
    const T* __restrict__ xbn_p, const T* __restrict__ p00_p,
    const T* __restrict__ p01_p, const T* __restrict__ p10_p,
    const T* __restrict__ p11_p, int s, int C, T* x_out, T* diag_out,
    T* off_out, T* u0f, T* u1f) {
  using K = K7<T, R>;
  constexpr int L = K::LANES;
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * L + lane;
  const bool live = lane < L && c < C;
  T* area = reinterpret_cast<T*>(cgt_smem) + lane;
  const int ntiles = (s + 1) / K7_ROWS;  // s - 1 rows
  // step u: the chain runs tile u while the outputs form tile u - 1; one
  // barrier a step
  if (warp == 0) {
    T xb[R], x[R], phi[R][R], u0[R][R], u1[R][R];
    T* ring = area + 2 * K::BUF * L;
    if (live) {
      cgt::load_vec<T, R>(xb_p, 0, C, c, xb);
#pragma unroll
      for (int q = 0; q < K7_STAGES - 1; ++q)
        stage_row<T, R>(s - 2 - q, C, c, ring + q * K::IN * L, hc, hw0, hw,
                        pinv);
    }
#pragma unroll 1
    for (int u = 0; u <= ntiles; ++u) {
      if (u < ntiles && live)
        chain_tile<T, R>(u, s, C, c, area + (u % 2) * K::BUF * L, ring, hc,
                         hw0, hw, pinv, hw1_p, xbn_p, xb, phi, u0, u1, x,
                         x_out);
      pp::bar<K7_THREADS>();
    }
    if (live) {
      cgt::store_mat<T, R>(u0f, 0, C, c, u0);
      cgt::store_mat<T, R>(u1f, 0, C, c, u1);
    }
  } else {
    const int i = warp - 1;  // this warp's row of a tile
#pragma unroll 1
    for (int u = 0; u <= ntiles; ++u) {
      const int t = s - 2 - ((u - 1) * K7_ROWS + i);
      if (u > 0 && t >= 0 && live) {
        const T* buf = area + ((u - 1) % 2) * K::BUF * L;
        output_row<T, R>(t, s, C, c, buf + (i + 1) * K::E * L,
                         buf + i * K::E * L, hc, p00_p, p01_p, p10_p, p11_p,
                         diag_out, off_out);
      }
      pp::bar<K7_THREADS>();
    }
  }
}

namespace co = cgt::coop;

// the block size of the warp-per-lane instances
constexpr int WARP_D = 16;

// The sweep's lane region: Sweep's blocks and vectors, then di = D^{-1},
// hat_C, pinv and hat_w (hat_W0 goes into Sweep's free X).
enum { SV_DI = co::SW_BLOCKS, SV_HC, SV_PINV, SV_BLOCKS };
enum { SV_HW = co::SW_VECS, SV_VECS };

// kernel 6 at block size 16 as one warp per chunk lane: per row
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

// kernel 7 at block size 16 as one warp per chunk lane: the
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

template <typename T, int R>
int launch_solveinv_split(const T* R_cm, const T* O_cm, const T* y_cm,
                          T jitter, int s, int C, T* acc00, T* accy0, T* w0l,
                          T* wl, T* dl, T* invdl, T* mh, T* ld, T* hc,
                          T* hw0, T* hw, T* pinv, T* ld_rows,
                          cudaStream_t stream) {
  using K = pp::Elim<T, R>;
  const cudaError_t err = co::prepare(solveinv_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  solveinv_split_kernel<T, R>
      <<<(C + K::BLOCK_LANES - 1) / K::BLOCK_LANES, K::THREADS, K::SMEM,
         stream>>>(
          R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl,
          mh, ld, hc, hw0, hw, pinv, ld_rows);
  return int(cudaGetLastError());
}

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
#define CGT_LAUNCH(RR)                                                    \
  return launch_solveinv_split<T, RR>(R_cm, O_cm, y_cm, jitter, s, C,     \
                                      acc00, accy0, w0l, wl, dl, invdl, mh, \
                                      ld, hc, hw0, hw, pinv, ld_rows, stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// the thread-per-lane sweep at float64 rank d (7 or 8)
int launch_solveinv_thread(const double* R_cm, const double* O_cm,
                           const double* y_cm, double jitter, int s, int d,
                           int C, double* acc00, double* accy0, double* w0l,
                           double* wl, double* dl, double* invdl, double* mh,
                           double* ld, double* hc, double* hw0, double* hw,
                           double* pinv, double* ld_rows,
                           cudaStream_t stream) {
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
#define CGT_LAUNCH(RR)                                                      \
  forward_sweep_solveinv_kernel<double, RR>                                 \
      <<<blocks, CGT_THREADS, 0, stream>>>(R_cm, O_cm, y_cm, jitter, s, C,  \
                                           acc00, accy0, w0l, wl, dl,       \
                                           invdl, mh, ld, hc, hw0, hw,      \
                                           pinv, ld_rows)
  CGT_THREAD_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T, int R>
int launch_split(const T* hc, const T* hw0, const T* hw, const T* pinv,
                 const T* hw1, const T* xb, const T* xbn, const T* p00,
                 const T* p01, const T* p10, const T* p11, int s, int C,
                 T* x, T* diag, T* off, T* u0f, T* u1f,
                 cudaStream_t stream) {
  using K = K7<T, R>;
  const cudaError_t err = co::prepare(backsolve_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  backsolve_split_kernel<T, R>
      <<<(C + K::LANES - 1) / K::LANES, K7_THREADS, K::SMEM, stream>>>(
          hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01, p10, p11, s, C, x, diag,
          off, u0f, u1f);
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
#define CGT_LAUNCH(RR)                                                   \
  return launch_split<T, RR>(hc, hw0, hw, pinv, hw1, xb, xbn, p00, p01,  \
                             p10, p11, s, C, x, diag, off, u0f, u1f,     \
                             stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// thread blocks of solveinv_split_kernel<T, R> one SM holds
template <typename T, int R>
int solveinv_split_blocks() {
  using K = pp::Elim<T, R>;
  if (co::prepare(solveinv_split_kernel<T, R>, K::SMEM) != cudaSuccess)
    return -1;
  return pp::blocks_per_sm(solveinv_split_kernel<T, R>, K::THREADS, K::SMEM);
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

int cgt_forward_sweep_solveinv_thread_f64(
    const double* R_cm, const double* O_cm, const double* y_cm,
    double jitter, int s, int d, int C, double* acc00, double* accy0,
    double* w0l, double* wl, double* dl, double* invdl, double* mh,
    double* ld, double* hc, double* hw0, double* hw, double* pinv,
    double* ld_rows, void* stream) {
  return launch_solveinv_thread(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
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

// thread blocks an SM of kernel 6's split design at rank r (1..8; the
// second argument 1 for float64; its shared bytes: solve_sweep.cu's
// cgt_elim_split_smem_bytes)
int cgt_solveinv_split_blocks_per_sm(int r, int f64) {
#define CGT_LAUNCH(RR)                             \
  return f64 ? solveinv_split_blocks<double, RR>() \
             : solveinv_split_blocks<float, RR>()
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of kernel 7's split design at rank
// r (1..8; the second argument 1 for float64)
int cgt_backsolve_split_smem_bytes(int r, int f64) {
#define CGT_LAUNCH(RR)                                                  \
  return int(f64 ? K7<double, RR>::SMEM : K7<float, RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
