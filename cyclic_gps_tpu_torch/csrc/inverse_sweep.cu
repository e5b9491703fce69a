// The two kernels of the selected inversion (the diagonal and lag-1 blocks
// of J^{-1}): the forward sweep that streams the raw factors of every
// interior step, and the descending Takahashi recursion over them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   inverse_split_kernel         <- :534 forward_sweep_inverse_pallas
//                                   (_sweep_inverse_collect_kernel, :483)
//   takahashi_split_kernel       <- :648 takahashi_backward_pallas
//                                   (_takahashi_kernel, :585)
//
// What bounds them on the H100: both stream stacks of R x R blocks, each
// chunk lane c walking that chunk's rows.  Per row the sweep reads 2 R^2
// values and writes 3 R^2 + R (D, invd, C, W0); the recursion reads those
// 3 R^2 + R and writes 2 R^2 (Sigma_jj, Sigma_{j+1,j}).  In bytes that is
// ~520 MB and ~510 MB at rank 5, N = 1e6, float32 (bounds of ~0.15 ms
// each).  The recursion does ~25 R x R products per row, with C = N/s
// lanes (7,813 at s = 128).
//
// The sweep is pipeline.cuh's split elimination (inverse_split_kernel,
// below) without the right-hand side: lane groups of 32 lanes, two a
// block at rank 5 float32 (123 blocks at N = 1e6 against the ~61 of one
// thread per lane), in each one warp running the elimination's carried
// part (no w) while three warps copy the rows' (P, O) in ahead of it with
// cp.async and store each row's raw factors from what the chain parks.
// Where the split design loses (float64 rank 8, ops/_build.py's
// ELIM_THREAD), the wrapper takes the thread-per-lane kernel
// (forward_sweep_inverse_kernel, kept at float64 ranks 7-8 only,
// cgt_forward_sweep_inverse_thread_f64).  The recursion takes 32 lanes a
// block (245 blocks) and splits
// each lane's rows between warps (takahashi_split_kernel, below): of its
// ~25 products only four a row cross rows.  The TPU kernel also carries a0
// and a1 from step to step (its scratch), but no step reads the carried
// values: the off-diagonal block uses this step's a0/a1 and the previous
// step's u0/u1.  So the recursion carries only phi, u0 and u1.
#include "blockmath.cuh"
#include "pipeline.cuh"
#include "rtcoop.cuh"

namespace {

namespace pp = cgt::pipe;

// Kernel 10's outputs of stack row t (elim_split's emit without the
// right-hand side): the raw factors D_j (as chol forms it), 1/diag(D_j),
// C_j = O_j D_j^{-T} and W0_j.
template <typename T, int R>
struct InverseFactors {
  T *ds, *invds, *cs, *w0s;
  int C;
  __device__ __forceinline__ void operator()(int t, int c, const T (&D)[R][R],
                                             const T (&invd)[R],
                                             const T (&cprev)[R][R],
                                             const T (&w0)[R][R],
                                             const T (&)[R]) const {
    cgt::store_mat<T, R>(ds, t, C, c, D);
    cgt::store_vec<T, R>(invds, t, C, c, invd);
    cgt::store_mat<T, R>(cs, t, C, c, cprev);
    cgt::store_mat<T, R>(w0s, t, C, c, w0);
  }
};

// Kernel 10 at ranks 1-8: the forward elimination without a right-hand
// side (forward_sweep.cu's with no w, accy0 or mh), writing the raw
// factors of every interior step j = 1..s-1 (stack row j-1), on
// pipeline.cuh's split sweep.  Its W0 recursion (elim_carry) and its sum
// of W0^T W0 (elim_output_row, elim_accumulate) are the thread-per-lane
// kernel's below, in the same order, so the outputs are that kernel's to
// the bit.
template <typename T, int R>
__global__ void __launch_bounds__(pp::Elim<T, R, false>::THREADS)
inverse_split_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                     T jitter, int s, int C, T* acc00, T* w0l, T* dl,
                     T* invdl, T* ds, T* invds, T* cs, T* w0s) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  pp::elim_split<T, R, false>(
      reinterpret_cast<T*>(cgt_smem), Rm, Om, nullptr, jitter, s, C, acc00,
      nullptr, w0l, nullptr, dl, invdl, nullptr, nullptr, nullptr,
      InverseFactors<T, R>{ds, invds, cs, w0s, C});
}

// The same sweep one thread per chunk lane (float64 ranks 7-8 only).
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

// Kernel 11 at ranks 1-8: the Takahashi recursion with the outputs and
// the per-row factors taken off its serial chain.  Per row (steps s-2 .. 1
// descending, stack rows t = s-3 .. 0) it computes
//   di = D^{-1},  cd = C di,  pinv = di^T di,  hw0 = di^T W0
//   phi_j = pinv + cd^T phi_{j+1} cd
//   u0_j  = hw0 - cd^T u0_{j+1},   u1_j = -cd^T u1_{j+1}
//   a0, a1        = Sigma_BB U_j^T (p00 u0_j^T + p01 u1_j^T, ...)
//   Sigma_jj      = phi_j + u0_j a0 + u1_j a1
//   Sigma_{j+1,j} = -phi_{j+1} cd + u0_{j+1} a0 + u1_{j+1} a1
// Only phi, u0 and u1 cross rows, at four products a row; the hats (di,
// cd, pinv, hw0) depend on the row's own factors and the outputs feed
// nothing back.  So a thread block takes 32 chunk lanes (K11::LANES; 16,
// 8 or 4 where shared memory is short) and walks their rows in tiles of
// K11_ROWS = 3, its warps specialised:
// * warp 0 (the chain), one thread per lane, runs the rows of tile u with
//   phi, u0 and u1 in its registers, reading each row's (cd, pinv, hw0)
//   from rings of hat tiles in shared memory, and parks each row's
//   (phi_j, u0_j, u1_j) in one of two tile buffers;
// * warps 1-3 each take one row of a tile: they copy the raw factors
//   (D, 1/diag D, C, W0) of their row of tile u + 2 into shared memory with
//   cp.async, build the hats of tile u + 1 from the copy that has landed,
//   and form Sigma_jj and Sigma_{j+1,j} of tile u - 1 from the parked states
//   (cd from the hat ring, p00..p11 copied into shared memory once).
// One named barrier a tile.  The hat form reorders u0's and u1's sums:
// D^{-T} (W0 - C^T u0) becomes D^{-T} W0 - (C D^{-1})^T u0, so u0, u1 and
// the Sigma blocks differ from the thread-per-lane recursion of earlier
// versions by rounding (phi and every other sum keep that kernel's order).
#define K11_ROWS 3       // rows in a tile = output warps
#define K11_THREADS 128  // warp 0 runs the chain, warps 1-3 the rest
#define K11_CDS 3        // tiles of cd in its ring: built, chained, output

// A thread block's shared memory per lane, lane innermost: two tile
// buffers of K11_ROWS + 1 slots of (phi, u0, u1) -- slot 0 the state the
// tile starts from (the seed at the first tile, else the previous tile's
// last row), slot i + 1 the state after the tile's row i; the rows' hats,
// cd in a ring of K11_CDS tiles (the outputs read it a tile after the
// chain) and (pinv, hw0) in a ring of two; per output warp two slots of
// its row's raw factors (D, C, W0, 1/diag D); and p00, p01, p10, p11.
template <typename T, int R>
struct K11 {
  static constexpr int E = 3 * R * R;              // phi, u0, u1 of one row
  static constexpr int BUF = (K11_ROWS + 1) * E;   // one tile buffer
  static constexpr int CDS = K11_CDS * K11_ROWS * R * R;
  static constexpr int PW = 2 * R * R;             // pinv, hw0 of one row
  static constexpr int PWS = 2 * K11_ROWS * PW;
  static constexpr int RAW = 3 * R * R + R;        // D, C, W0, invd
  static constexpr int RAWS = 2 * K11_ROWS * RAW;
  static constexpr int PS = 4 * R * R;             // p00, p01, p10, p11
  static constexpr int N = 2 * BUF + CDS + PWS + RAWS + PS;  // per lane
  static constexpr int LANES = pp::lanes_for(size_t(N) * sizeof(T));
  static constexpr size_t SMEM = size_t(N) * LANES * sizeof(T);
};

// Start copying stack row t's raw factors into a raw slot (one group; an
// empty group where the row does not exist keeps the count of groups).
template <typename T, int R>
__device__ __forceinline__ void stage_raw(int t, int C, int c, T* slot,
                                          const T* __restrict__ ds,
                                          const T* __restrict__ invds,
                                          const T* __restrict__ cs,
                                          const T* __restrict__ w0s) {
  constexpr int L = K11<T, R>::LANES;
  if (t >= 0) {
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const size_t g = cgt::mat_at<R>(t, a, b, C, c);
        pp::stage(slot + (a * R + b) * L, ds + g);
        pp::stage(slot + (R * R + a * R + b) * L, cs + g);
        pp::stage(slot + (2 * R * R + a * R + b) * L, w0s + g);
      }
#pragma unroll
    for (int a = 0; a < R; ++a)
      pp::stage(slot + (3 * R * R + a) * L,
                invds + cgt::vec_at<R>(t, a, C, c));
  }
  pp::stage_commit();
}

// A row's hats from its raw factors: cd = C D^{-1}, pinv = D^{-T} D^{-1},
// hw0 = D^{-T} W0 (into pw), as the thread-per-lane recursion formed di
// and cd.
template <typename T, int R>
__device__ __forceinline__ void build_hats(const T* raw, T* cd, T* pw) {
  constexpr int L = K11<T, R>::LANES;
  T D[R][R], invd[R], m[R][R], di[R][R], t[R][R];
  pp::park_get<T, R, L>(raw, 0, D);
#pragma unroll
  for (int a = 0; a < R; ++a) invd[a] = raw[(3 * R * R + a) * L];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = (i == k) ? T(1) : T(0);
  cgt::solve_lower<T, R, R>(D, invd, m, di);
  pp::park_get<T, R, L>(raw, R * R, m);
  cgt::mm<T, R>(m, di, t);
  pp::park_put<T, R, L>(cd, 0, t);
  cgt::mm_ta<T, R>(di, di, t);
  pp::park_put<T, R, L>(pw, 0, t);  // pinv
  pp::park_get<T, R, L>(raw, 2 * R * R, m);
  cgt::mm_ta<T, R>(di, m, t);
  pp::park_put<T, R, L>(pw, R * R, t);  // hw0
}

// The chain: one lane's rows of tile u, descending (row q of the walk is
// stack row t = s-3-q), each from its hats in the rings' tiles of u (cds,
// pws).
template <typename T, int R>
__device__ __forceinline__ void takahashi_chain_tile(int u, int s, T* buf,
                                                     const T* cds,
                                                     const T* pws,
                                                     T (&phi)[R][R],
                                                     T (&u0)[R][R],
                                                     T (&u1)[R][R]) {
  using K = K11<T, R>;
  constexpr int L = K::LANES;
  pp::park_put<T, R, L>(buf, 0, phi);
  pp::park_put<T, R, L>(buf, R * R, u0);
  pp::park_put<T, R, L>(buf, 2 * R * R, u1);
#pragma unroll 1
  for (int i = 0; i < K11_ROWS; ++i) {
    const int t = s - 3 - (u * K11_ROWS + i);
    if (t < 0) break;
    const T* pw = pws + i * K::PW * L;
    T cd[R][R], tm[R][R];
    pp::park_get<T, R, L>(cds + i * R * R * L, 0, cd);
    cgt::mm_ta<T, R>(cd, phi, tm);
    cgt::mm<T, R>(tm, cd, phi);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) phi[a][b] += pw[(a * R + b) * L];
    cgt::mm_ta<T, R>(cd, u0, tm);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b)
        u0[a][b] = pw[(R * R + a * R + b) * L] - tm[a][b];
    cgt::mm_ta<T, R>(cd, u1, tm);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) u1[a][b] = -tm[a][b];
    pp::park_put<T, R, L>(buf, (i + 1) * K::E, phi);
    pp::park_put<T, R, L>(buf, (i + 1) * K::E + R * R, u0);
    pp::park_put<T, R, L>(buf, (i + 1) * K::E + 2 * R * R, u1);
  }
}

// out = a b^T + c d^T with a, c a lane's blocks in shared memory, the two
// products summed as the thread-per-lane kernel's sig_ut summed them
template <typename T, int R>
__device__ __forceinline__ void mm_tb2_park(const T* a_p, const T* c_p,
                                            const T (&b)[R][R],
                                            const T (&d)[R][R],
                                            T (&out)[R][R]) {
  constexpr int L = K11<T, R>::LANES;
  T m[R][R], t[R][R];
  pp::park_get<T, R, L>(a_p, 0, m);
  cgt::mm_tb<T, R>(m, b, out);
  pp::park_get<T, R, L>(c_p, 0, m);
  cgt::mm_tb<T, R>(m, d, t);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) out[i][k] += t[i][k];
}

// An output warp: stack row t's Sigma_jj and Sigma_{j+1,j} from the states
// parked after it (cur) and after the row before it in the walk (prev),
// with the row's cd from the ring and p00..p11 from shared memory (ps).
template <typename T, int R>
__device__ __forceinline__ void takahashi_output_row(int t, int C, int c,
                                                     const T* cur,
                                                     const T* prev,
                                                     const T* cd,
                                                     const T* ps,
                                                     T* diag_out,
                                                     T* off_out) {
  constexpr int L = K11<T, R>::LANES;
  T u0[R][R], u1[R][R], a0[R][R], a1[R][R], m[R][R], tm[R][R];
  pp::park_get<T, R, L>(cur, R * R, u0);
  pp::park_get<T, R, L>(cur, 2 * R * R, u1);
  constexpr int RR = R * R * L;
  mm_tb2_park<T, R>(ps, ps + RR, u0, u1, a0);  // Sigma_BB U^T
  mm_tb2_park<T, R>(ps + 2 * RR, ps + 3 * RR, u0, u1, a1);
  cgt::mm<T, R>(u0, a0, m);
  cgt::mm<T, R>(u1, a1, tm);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = cur[(i * R + k) * L] + m[i][k] +
                                          tm[i][k];
  cgt::store_mat<T, R>(diag_out, t, C, c, m);
  pp::park_get<T, R, L>(cd, 0, u0);
  pp::park_get<T, R, L>(prev, 0, m);   // phi_{j+1}
  cgt::mm<T, R>(m, u0, tm);            // -phi_off
  pp::park_get<T, R, L>(prev, R * R, u0);
  pp::park_get<T, R, L>(prev, 2 * R * R, u1);
  cgt::mm<T, R>(u0, a0, m);
  cgt::mm<T, R>(u1, a1, u0);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = -tm[i][k] + m[i][k] + u0[i][k];
  cgt::store_mat<T, R>(off_out, t, C, c, m);
}

template <typename T, int R>
__global__ void __launch_bounds__(K11_THREADS)
takahashi_split_kernel(
    const T* __restrict__ ds, const T* __restrict__ invds,
    const T* __restrict__ cs, const T* __restrict__ w0s,
    const T* __restrict__ p00_p, const T* __restrict__ p01_p,
    const T* __restrict__ p10_p, const T* __restrict__ p11_p,
    const T* __restrict__ phi_p, const T* __restrict__ u0_p,
    const T* __restrict__ u1_p, int s, int C, T* diag_out, T* off_out,
    T* u0f, T* u1f) {
  using K = K11<T, R>;
  constexpr int L = K::LANES;
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * L + lane;
  const bool live = lane < L && c < C;
  T* area = reinterpret_cast<T*>(cgt_smem) + lane;
  T* cds = area + 2 * K::BUF * L;
  T* pws = cds + K::CDS * L;
  T* ps = pws + K::PWS * L + K::RAWS * L;
  const int ntiles = s / K11_ROWS;  // s - 2 rows
  // step u: the chain runs tile u while the other warps build the hats of
  // tile u + 1 and form the outputs of tile u - 1; one barrier a step,
  // and one before the first for the hats of tile 0
  if (warp == 0) {
    T phi[R][R], u0[R][R], u1[R][R];
    if (live) {
      cgt::load_mat<T, R>(phi_p, 0, C, c, phi);
      cgt::load_mat<T, R>(u0_p, 0, C, c, u0);
      cgt::load_mat<T, R>(u1_p, 0, C, c, u1);
    }
    pp::bar<K11_THREADS>();
#pragma unroll 1
    for (int u = 0; u < ntiles; ++u) {
      if (live)
        takahashi_chain_tile<T, R>(
            u, s, area + (u % 2) * K::BUF * L,
            cds + (u % K11_CDS) * K11_ROWS * R * R * L,
            pws + (u % 2) * K11_ROWS * K::PW * L, phi, u0, u1);
      pp::bar<K11_THREADS>();
    }
    if (live) {
      cgt::store_mat<T, R>(u0f, 0, C, c, u0);
      cgt::store_mat<T, R>(u1f, 0, C, c, u1);
    }
  } else {
    const int i = warp - 1;  // this warp's row of a tile
    T* raw = pws + K::PWS * L + i * 2 * K::RAW * L;  // two slots
    // stack row of this warp's row of tile v, and where its hats go
    auto row = [&](int v) { return s - 3 - (v * K11_ROWS + i); };
    auto cd_of = [&](int v) {
      return cds + ((v % K11_CDS) * K11_ROWS + i) * R * R * L;
    };
    auto pw_of = [&](int v) {
      return pws + ((v % 2) * K11_ROWS + i) * K::PW * L;
    };
    if (live) {
      if (i == 0) {  // p00..p11, for all three output warps
        const T* srcs[4] = {p00_p, p01_p, p10_p, p11_p};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int a = 0; a < R * R; ++a)
            pp::stage(ps + (q * R * R + a) * L,
                      srcs[q] + size_t(a) * C + c);
      }
      stage_raw<T, R>(row(0), C, c, raw, ds, invds, cs, w0s);
      stage_raw<T, R>(row(1), C, c, raw + K::RAW * L, ds, invds, cs, w0s);
      pp::stage_wait<1>();
      if (row(0) >= 0) build_hats<T, R>(raw, cd_of(0), pw_of(0));
    }
    pp::bar<K11_THREADS>();
#pragma unroll 1
    for (int u = 0; u <= ntiles; ++u) {
      if (live && u < ntiles) {
        stage_raw<T, R>(row(u + 2), C, c, raw + (u % 2) * K::RAW * L, ds,
                        invds, cs, w0s);
        pp::stage_wait<1>();
        if (row(u + 1) >= 0)
          build_hats<T, R>(raw + ((u + 1) % 2) * K::RAW * L, cd_of(u + 1),
                           pw_of(u + 1));
      }
      const int t = row(u - 1);
      if (live && u > 0 && t >= 0) {
        const T* buf = area + ((u - 1) % 2) * K::BUF * L;
        takahashi_output_row<T, R>(t, C, c, buf + (i + 1) * K::E * L,
                                   buf + i * K::E * L, cd_of(u - 1), ps,
                                   diag_out, off_out);
      }
      if (u < ntiles) pp::bar<K11_THREADS>();
    }
  }
}

template <typename T, int R>
int launch_inverse_split(const T* R_cm, const T* O_cm, T jitter, int s,
                         int C, T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                         T* invds, T* cs, T* w0s, cudaStream_t stream) {
  using K = pp::Elim<T, R, false>;
  const cudaError_t err =
      cgt::coop::prepare(inverse_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  inverse_split_kernel<T, R>
      <<<(C + K::BLOCK_LANES - 1) / K::BLOCK_LANES, K::THREADS, K::SMEM,
         stream>>>(R_cm, O_cm, jitter, s, C, acc00, w0l, dl, invdl, ds,
                   invds, cs, w0s);
  return int(cudaGetLastError());
}

template <typename T>
int launch_inverse_sweep(const T* R_cm, const T* O_cm, T jitter, int s, int d,
                         int C, T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                         T* invds, T* cs, T* w0s, cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                      \
  return launch_inverse_split<T, RR>(R_cm, O_cm, jitter, s, C, acc00, w0l, \
                                     dl, invdl, ds, invds, cs, w0s, stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// the thread-per-lane kernel at float64 rank d (7 or 8)
int launch_inverse_sweep_thread(const double* R_cm, const double* O_cm,
                                double jitter, int s, int d, int C,
                                double* acc00, double* w0l, double* dl,
                                double* invdl, double* ds, double* invds,
                                double* cs, double* w0s,
                                cudaStream_t stream) {
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
#define CGT_LAUNCH(RR)                                                    \
  forward_sweep_inverse_kernel<double, RR>                                \
      <<<blocks, CGT_THREADS, 0, stream>>>(R_cm, O_cm, jitter, s, C,      \
                                           acc00, w0l, dl, invdl, ds,     \
                                           invds, cs, w0s)
  CGT_THREAD_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

// thread blocks of inverse_split_kernel<T, R> one SM holds
template <typename T, int R>
int inverse_split_blocks() {
  using K = pp::Elim<T, R, false>;
  if (cgt::coop::prepare(inverse_split_kernel<T, R>, K::SMEM) != cudaSuccess)
    return -1;
  return pp::blocks_per_sm(inverse_split_kernel<T, R>, K::THREADS, K::SMEM);
}

template <typename T, int R>
int launch_takahashi_split(const T* ds, const T* invds, const T* cs,
                           const T* w0s, const T* p00, const T* p01,
                           const T* p10, const T* p11, const T* phi,
                           const T* u0, const T* u1, int s, int C, T* diag,
                           T* off, T* u0f, T* u1f, cudaStream_t stream) {
  using K = K11<T, R>;
  const cudaError_t err =
      cgt::coop::prepare(takahashi_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  takahashi_split_kernel<T, R>
      <<<(C + K::LANES - 1) / K::LANES, K11_THREADS, K::SMEM, stream>>>(
          ds, invds, cs, w0s, p00, p01, p10, p11, phi, u0, u1, s, C, diag,
          off, u0f, u1f);
  return int(cudaGetLastError());
}

template <typename T>
int launch_takahashi(const T* ds, const T* invds, const T* cs, const T* w0s,
                     const T* p00, const T* p01, const T* p10, const T* p11,
                     const T* phi, const T* u0, const T* u1, int s, int d,
                     int C, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                    \
  return launch_takahashi_split<T, RR>(ds, invds, cs, w0s, p00, p01, p10, \
                                       p11, phi, u0, u1, s, C, diag, off, \
                                       u0f, u1f, stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
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

int cgt_forward_sweep_inverse_thread_f64(const double* R_cm,
                                         const double* O_cm, double jitter,
                                         int s, int d, int C, double* acc00,
                                         double* w0l, double* dl,
                                         double* invdl, double* ds,
                                         double* invds, double* cs,
                                         double* w0s, void* stream) {
  return launch_inverse_sweep_thread(R_cm, O_cm, jitter, s, d, C, acc00, w0l,
                                     dl, invdl, ds, invds, cs, w0s,
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

// dynamic shared bytes per thread block and thread blocks an SM of kernel
// 10's split design (pipeline.cuh's Elim without the right-hand side) at
// rank r (1..8; the second argument 1 for float64)
int cgt_inverse_split_smem_bytes(int r, int f64) {
#define CGT_LAUNCH(RR)                                    \
  return int(f64 ? pp::Elim<double, RR, false>::SMEM \
                 : pp::Elim<float, RR, false>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

int cgt_inverse_split_blocks_per_sm(int r, int f64) {
#define CGT_LAUNCH(RR)                            \
  return f64 ? inverse_split_blocks<double, RR>() \
             : inverse_split_blocks<float, RR>()
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of kernel 11's split design at
// rank r (1..8; the second argument 1 for float64)
int cgt_takahashi_split_smem_bytes(int r, int f64) {
#define CGT_LAUNCH(RR) \
  return int(f64 ? K11<double, RR>::SMEM : K11<float, RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
