// Shared device functions of the split designs at ranks 1-8: the walks,
// kernel 7 (backward_sweep.cu), kernel 9 (solve_sweep.cu) and kernel 11
// (inverse_sweep.cu), and the collecting sweeps, kernel 6
// (backward_sweep.cu) and kernel 8 (solve_sweep.cu).  Each takes a few
// chunk lanes a thread block and splits a lane's rows between warps: one
// warp runs the serial chain, the others stage the rows' inputs or form
// the outputs from what the chain parks in shared memory.  What they
// share:
//
//   park_get / park_put  a lane's R x R block in a shared-memory area laid
//                        out [n][L] (lane innermost: conflict-free)
//   bar<THREADS>(id)     a named barrier between warps that reach it from
//                        their own loops (id 1 by default)
//   stage, stage_commit, one element copied from device to shared memory
//   stage_wait<N>        with cp.async, committed as a group per row or
//                        tile and waited for by the thread that issued it
//   lanes_for            the chunk lanes a thread block takes
//   Elim, elim_split     the split elimination sweep of kernels 1, 6, 8
//                        and 10 (below): its tile and ring layout, the
//                        rows' staging, the chain step (elim_step's
//                        carried part) and the output warps' rows
#pragma once

#include "blockmath.cuh"

namespace cgt {
namespace pipe {

// a lane's R x R block at element offset o of a [n][L] area
template <typename T, int R, int L>
__device__ __forceinline__ void park_get(const T* p, int o, T (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = p[(o + i * R + k) * L];
}

template <typename T, int R, int L>
__device__ __forceinline__ void park_put(T* p, int o, const T (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) p[(o + i * R + k) * L] = m[i][k];
}

// Named barrier `id` over THREADS threads (the chain warp and the other
// warps of one lane group, or some of them): each reaches it from its own
// loop.
template <int THREADS>
__device__ __forceinline__ void bar(int id = 1) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

// One element copied from device to shared memory without passing
// through registers (cp.async); a group of them is committed, and waited
// for by the thread that issued it.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   unsigned(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N groups of this thread are in flight
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Thread blocks of `threads` threads and `smem` dynamic shared bytes one SM
// holds at once (by registers and shared memory) of a kernel already
// allowed that shared memory (coop::prepare), or -1 if the runtime
// refuses the query.
template <typename K>
inline int blocks_per_sm(K* kernel, int threads, size_t smem) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kernel, threads, smem) == cudaSuccess
             ? n
             : -1;
}

// The lanes a thread block takes when each lane needs `per_lane` bytes of
// shared memory: 32, or 16, 8, 4 where 32 would pass the 227 KB a block
// may take.
constexpr int lanes_for(size_t per_lane) {
  return per_lane * 32 <= 232448   ? 32
         : per_lane * 16 <= 232448 ? 16
         : per_lane * 8 <= 232448  ? 8
                                   : 4;
}

// ---------------------------------------------------------------------------
// The split elimination sweep (kernels 1, 6, 8 and 10 at ranks 1-8).
//
// Per chunk lane the sweep eliminates rows j = 1..s-1 in order (blockmath's
// elim_step).  Of each row's work only four pieces carry to the next row:
//   P_j - C_{j-1} C_{j-1}^T and its Cholesky (D_j, 1/diag D_j),
//   W0_j and w_j (two solves against D_j), and C_j = O_j D_j^{-T}.
// The row's outputs -- its hats for the descending walk, 2 log|D_j| -- and
// the sums W0^T W0, W0^T w, ||w||^2 and log|D| feed nothing back.  So a
// lane group of 32 chunk lanes (Elim::LANES; 16, 8 or 4 where shared
// memory is short) walks its rows in tiles of ELIM_ROWS = 3 with four
// warps:
// * a chain warp, one thread per lane, runs the carried part down tile u
//   from a ring of Elim::SLOTS input tiles (3, or 2 where shared memory is
//   short), and parks each row's (C_j, W0_j, D_j, 1/diag D_j, w_j,
//   pivots) in one of two tile buffers;
// * three output warps each take one row of a tile: they copy its (P, O,
//   y) into the ring with cp.async SLOTS - 1 tiles ahead of the chain, and
//   from the parked state of tile u - 1 form its outputs (the kernel's
//   `emit`, and ld_rows) and its terms of the four sums, which the warp of
//   row 0 adds up in row order after a barrier of the three.
// One named barrier a tile over the group's four warps.  A thread block
// holds two lane groups where their shared memory fits one block an SM
// (Elim::GROUPS; ranks 1-5 at float32, 1-3 at float64): its warps 0
// and 1 run the two chains, so they issue from two of the SM's four
// schedulers (two blocks of one chain each would put both chains on
// warp slot 0's), and the block's 64 lanes fill an SM in one wave at
// N = 1e6 (123 blocks).  The chain takes only the lower
// triangle of P (Cholesky reads no more) and parks D without its
// diagonal and upper triangle (the solves read 1/diag D and the strictly
// lower part); the pivots, parked, give log|D_j| in chol's order.  Every
// sum keeps elim_step's order, so the outputs are the thread-per-lane
// kernel's to the bit.
//
// The kernels differ in their emit (6 and 8 their hats, 10 the raw
// factors, 1 nothing) and in the switch V: with it (1, 6, 8) the sweep
// carries the right-hand side (y_j, w_j) and forms the log-dets; without
// it (10, the selected inversion's sweep) no y is staged, no w carried or
// parked, and of the sums only W0^T W0 is kept (the layout shrinks, but
// at no rank enough to add a ring slot or a lane group).
// ---------------------------------------------------------------------------
#define ELIM_ROWS 3  // rows in a tile = output warps of a lane group

// A lane group's shared memory per lane, lane innermost: a ring of SLOTS
// tiles of ELIM_ROWS rows of inputs (P's lower triangle, O, y), then two
// tile buffers of ELIM_ROWS parked rows (C, W0, D's strictly lower part,
// 1/diag D, w, pivots; an output warp overwrites its row with its terms
// of the sums: W0^T W0, W0^T w, ||w||^2, log|D|).  Without V no y or w.
// A block holds GROUPS lane groups of LANES lanes, their areas one after
// the other.
template <typename T, int R, bool V = true>
struct Elim {
  static constexpr int TRI = R * (R + 1) / 2;  // lower triangle
  static constexpr int LOW = R * (R - 1) / 2;  // strictly lower part
  static constexpr int VR = V ? R : 0;         // y_j or w_j
  static constexpr int IN_O = TRI, IN_Y = TRI + R * R;
  static constexpr int IN = IN_Y + VR;  // one row's inputs
  static constexpr int PK_W0 = R * R, PK_D = 2 * R * R, PK_INVD = PK_D + LOW,
                       PK_W = PK_INVD + R, PK_PIV = PK_W + VR;
  static constexpr int PARK = PK_PIV + R;  // one row's parked state
  static constexpr int BUFS = 2 * ELIM_ROWS * PARK;
  // a ring of 3 tiles where 32 lanes fit it, else of 2
  static constexpr int SLOTS =
      size_t(3 * ELIM_ROWS * IN + BUFS) * sizeof(T) * 32 <= 232448 ? 3 : 2;
  static constexpr int RING = SLOTS * ELIM_ROWS * IN;
  static constexpr int N = RING + BUFS;  // per lane
  static constexpr int LANES = lanes_for(size_t(N) * sizeof(T));
  static constexpr int GROUPS =
      LANES == 32 && size_t(N) * sizeof(T) * 64 <= 232448 ? 2 : 1;
  static constexpr int THREADS = GROUPS * (ELIM_ROWS + 1) * 32;
  static constexpr int BLOCK_LANES = GROUPS * LANES;  // lanes a block
  static constexpr size_t SMEM = size_t(N) * LANES * GROUPS * sizeof(T);
};

// element (i, k) of a packed lower triangle, k <= i (or k < i without
// the diagonal)
__device__ __forceinline__ constexpr int tri_at(int i, int k) {
  return i * (i + 1) / 2 + k;
}
__device__ __forceinline__ constexpr int low_at(int i, int k) {
  return i * (i - 1) / 2 + k;
}

// chol's arithmetic, the pivots returned in place of their log sum
// (half_logdet sums them as chol does)
template <typename T, int R>
__device__ __forceinline__ void chol_pivots(const T (&a)[R][R], T (&L)[R][R],
                                            T (&invd)[R], T (&piv)[R]) {
  T x[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) x[i][k] = a[i][k];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    piv[j] = x[j][j];
    const T pinv = rsqrt_(piv[j]);
    invd[j] = pinv;
#pragma unroll
    for (int i = 0; i < R; ++i) L[i][j] = (i >= j) ? x[i][j] * pinv : T(0);
#pragma unroll
    for (int i = j + 1; i < R; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) x[i][k] -= L[i][j] * L[k][j];
  }
}

template <typename T, int R>
__device__ __forceinline__ T half_logdet(const T (&piv)[R]) {
  T ld = T(0);
#pragma unroll
  for (int j = 0; j < R; ++j) ld += T(0.5) * log_(piv[j]);
  return ld;
}

// elim_step's carried part, in its arithmetic and order: D_j, 1/diag D_j
// and the pivots, W0_j, w_j (with V) and C_j (the sums of SweepCarry stay
// unset).  ``first`` marks row 1, whose W0 is seeded from the
// left-boundary coupling o_left.
template <typename T, int R, bool V>
__device__ __forceinline__ void elim_carry(bool first, const T (&p_in)[R][R],
                                           const T (&o_j)[R][R],
                                           const T (&y_j)[R],
                                           const T (&o_left)[R][R],
                                           SweepCarry<T, R>& st,
                                           T (&piv)[R]) {
  T P[R][R];
  T t[R][R];
  if (first) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) P[i][k] = p_in[i][k];
  } else {
    mm_tb<T, R>(st.cprev, st.cprev, t);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) P[i][k] = p_in[i][k] - t[i][k];
  }
  chol_pivots<T, R>(P, st.D, st.invd, piv);
  if (first) {
    solve_lower<T, R, R>(st.D, st.invd, o_left, st.w0);
    if constexpr (V) solve_lower_vec<T, R>(st.D, st.invd, y_j, st.w);
  } else {
    mm<T, R>(st.cprev, st.w0, t);
    T w0n[R][R];
    solve_lower<T, R, R>(st.D, st.invd, t, w0n);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) st.w0[i][k] = -w0n[i][k];
    if constexpr (V) {
      T rv[R];
      mv<T, R>(st.cprev, st.w, rv);
#pragma unroll
      for (int i = 0; i < R; ++i) rv[i] = y_j[i] - rv[i];
      solve_lower_vec<T, R>(st.D, st.invd, rv, st.w);
    }
  }
  // C_j = (D^{-1} O_j^T)^T
  T ot[R][R];
  transpose<T, R>(o_j, ot);
  solve_lower<T, R, R>(st.D, st.invd, ot, t);
  transpose<T, R>(t, st.cprev);
}

// Copy row j's inputs (P's lower triangle, O_j, y_j with V) into a ring
// slot (one group; an empty group past the last row keeps the count of
// groups).
template <typename T, int R, int L, bool V>
__device__ __forceinline__ void elim_stage_row(int j, int s, int C, int c,
                                               T* slot,
                                               const T* __restrict__ Rm,
                                               const T* __restrict__ Om,
                                               const T* __restrict__ ym) {
  using K = Elim<T, R, V>;
  if (j < s) {
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        stage(slot + tri_at(a, b) * L, Rm + mat_at<R>(j, a, b, C, c));
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b)
        stage(slot + (K::IN_O + a * R + b) * L,
              Om + mat_at<R>(j, a, b, C, c));
    if constexpr (V)
#pragma unroll
      for (int a = 0; a < R; ++a)
        stage(slot + (K::IN_Y + a) * L, ym + vec_at<R>(j, a, C, c));
  }
  stage_commit();
}

// The chain: row j from its ring slot `in`, its state parked in `pk`.
template <typename T, int R, int L, bool V>
__device__ __forceinline__ void elim_chain_row(bool first, const T* in,
                                               T jitter,
                                               const T* __restrict__ Om,
                                               int C, int c,
                                               SweepCarry<T, R>& st, T* pk) {
  using K = Elim<T, R, V>;
  T P[R][R], o_j[R][R], y_j[R] = {}, o_left[R][R], piv[R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b)
      P[a][b] = b <= a ? in[tri_at(a, b) * L] : T(0);
#pragma unroll
  for (int a = 0; a < R; ++a) P[a][a] += jitter;
  park_get<T, R, L>(in, K::IN_O, o_j);
  if constexpr (V)
#pragma unroll
    for (int a = 0; a < R; ++a) y_j[a] = in[(K::IN_Y + a) * L];
  if (first) load_mat<T, R>(Om, 0, C, c, o_left);
  elim_carry<T, R, V>(first, P, o_j, y_j, o_left, st, piv);
  park_put<T, R, L>(pk, 0, st.cprev);
  park_put<T, R, L>(pk, K::PK_W0, st.w0);
#pragma unroll
  for (int a = 1; a < R; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b) pk[(K::PK_D + low_at(a, b)) * L] = st.D[a][b];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    pk[(K::PK_INVD + a) * L] = st.invd[a];
    if constexpr (V) pk[(K::PK_W + a) * L] = st.w[a];
    pk[(K::PK_PIV + a) * L] = piv[a];
  }
}

// An output warp: row j's ld_rows (with V) and emit(t = j - 1, c, D,
// 1/diag D, C_j, W0_j, w_j) from its parked state, then its terms of the
// sums in place of that state.  D is rebuilt as chol forms it: the parked
// strictly lower part, the diagonal pivot * rsqrt(pivot), zeros above
// (the solves of 6's and 8's emits read no diagonal, so there it costs
// nothing); w is zero without V.
template <typename T, int R, int L, bool V, class Emit>
__device__ __forceinline__ void elim_output_row(int j, int C, int c, T* pk,
                                                T* ld_rows, Emit& emit) {
  using K = Elim<T, R, V>;
  T cprev[R][R], w0[R][R], D[R][R], invd[R], w[R] = {}, piv[R];
  park_get<T, R, L>(pk, 0, cprev);
  park_get<T, R, L>(pk, K::PK_W0, w0);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    invd[a] = pk[(K::PK_INVD + a) * L];
    if constexpr (V) w[a] = pk[(K::PK_W + a) * L];
    piv[a] = pk[(K::PK_PIV + a) * L];
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b)
      D[a][b] = b < a    ? pk[(K::PK_D + low_at(a, b)) * L]
                : b == a ? piv[a] * invd[a]
                         : T(0);
  T ldl = T(0);
  if constexpr (V) {
    ldl = half_logdet<T, R>(piv);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;
  }
  emit(j - 1, c, D, invd, cprev, w0, w);
  T t[R][R];
  mm_ta<T, R>(w0, w0, t);
  park_put<T, R, L>(pk, 0, t);
  if constexpr (V) {
    T rv[R];
    mv_ta<T, R>(w0, w, rv);
    T ww = T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) ww += w[i] * w[i];
#pragma unroll
    for (int a = 0; a < R; ++a) pk[(R * R + a) * L] = rv[a];
    pk[(R * R + R) * L] = ww;
    pk[(R * R + R + 1) * L] = ldl;
  }
}

// Warp 1: add row j's terms (parked by its output warp) to the sums, as
// elim_step does (row 1 starts them); without V only acc00.
template <typename T, int R, int L, bool V>
__device__ __forceinline__ void elim_accumulate(bool first, const T* pk,
                                                T (&acc00)[R][R],
                                                T (&accy0)[R], T& mh,
                                                T& ld) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const T v = pk[(a * R + b) * L];
      acc00[a][b] = first ? v : acc00[a][b] + v;
    }
  if constexpr (V) {
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const T v = pk[(R * R + a) * L];
      accy0[a] = first ? v : accy0[a] + v;
    }
    const T ww = pk[(R * R + R) * L], ldl = pk[(R * R + R + 1) * L];
    mh = first ? ww : mh + ww;
    ld = first ? ldl : ld + ldl;
  }
}

// Row i of tile v (row j = v ELIM_ROWS + i + 1) of a lane group: its
// ring slot (tile v % SLOTS) and its parked row (tile buffer v % 2), at a
// lane's column.
template <typename T, int R, bool V>
__device__ __forceinline__ T* elim_in(T* ring, int v, int i) {
  using K = Elim<T, R, V>;
  return ring + ((v % K::SLOTS) * ELIM_ROWS + i) * K::IN * K::LANES;
}

template <typename T, int R, bool V>
__device__ __forceinline__ T* elim_pk(T* parks, int v, int i) {
  using K = Elim<T, R, V>;
  return parks + ((v % 2) * ELIM_ROWS + i) * K::PARK * K::LANES;
}

constexpr int ELIM_GROUP_THREADS = (ELIM_ROWS + 1) * 32;

// A lane group's chain warp: step u runs tile u (one barrier a step, and
// one before the first), then the lane's last state (w_last with V only).
// Not inlined, as the output warps' code is not: each role's registers
// are allocated on their own.  On the H100 that ran rank 5 float32 ~10 %
// faster than one inlined body and took kernel 8's float64 rank-7
// instance off 32 registers and 27 KB of spill stores; the float64 rank-8
// instances fall there either way (ops/_build.py's ELIM_THREAD routes
// such instances to the thread-per-lane kernels).
template <typename T, int R, bool V>
__device__ __noinline__ void elim_chain_warp(T* ring, T* parks,
                                             const T* __restrict__ Om,
                                             T jitter, int s, int C, int c,
                                             bool live, int bar_group,
                                             T* w0l, T* wl, T* dl,
                                             T* invdl) {
  constexpr int L = Elim<T, R, V>::LANES;
  const int ntiles = (s + ELIM_ROWS - 2) / ELIM_ROWS;  // s - 1 rows
  SweepCarry<T, R> st;
  bar<ELIM_GROUP_THREADS>(bar_group);
#pragma unroll 1
  for (int u = 0; u <= ntiles; ++u) {
    if (u < ntiles && live) {
#pragma unroll 1
      for (int i = 0; i < ELIM_ROWS; ++i) {
        const int j = u * ELIM_ROWS + i + 1;
        if (j >= s) break;
        elim_chain_row<T, R, L, V>(j == 1, elim_in<T, R, V>(ring, u, i),
                                   jitter, Om, C, c, st,
                                   elim_pk<T, R, V>(parks, u, i));
      }
    }
    bar<ELIM_GROUP_THREADS>(bar_group);
  }
  if (live) {
    store_mat<T, R>(w0l, 0, C, c, st.w0);
    if constexpr (V) store_vec<T, R>(wl, 0, C, c, st.w);
    store_mat<T, R>(dl, 0, C, c, st.D);
    store_vec<T, R>(invdl, 0, C, c, st.invd);
  }
}

// A lane group's output warp of row i: step u copies its row of tile
// u + SLOTS - 1 and forms its row of tile u - 1; the row-0 warp then adds
// the tile's terms, in row order, and writes the lane's sums (acc00, and
// with V accy0, mh and ld).
template <typename T, int R, bool V, class Emit>
__device__ __noinline__ void elim_output_warp(
    T* ring, T* parks, const T* __restrict__ Rm, const T* __restrict__ Om,
    const T* __restrict__ ym, int s, int C, int c, bool live, int i,
    int bar_group, int bar_out, T* acc00_out, T* accy0_out, T* mh_out,
    T* ld_out, T* ld_rows, Emit emit) {
  constexpr int L = Elim<T, R, V>::LANES, S = Elim<T, R, V>::SLOTS;
  const int ntiles = (s + ELIM_ROWS - 2) / ELIM_ROWS;
  T acc00[R][R], accy0[R], mh = T(0), ld = T(0);  // row 0's warp: sums
  if (live) {
#pragma unroll 1
    for (int v = 0; v < S - 1; ++v)
      elim_stage_row<T, R, L, V>(v * ELIM_ROWS + i + 1, s, C, c,
                                 elim_in<T, R, V>(ring, v, i), Rm, Om, ym);
    stage_wait<S - 2>();
  }
  bar<ELIM_GROUP_THREADS>(bar_group);
#pragma unroll 1
  for (int u = 0; u <= ntiles; ++u) {
    const int j = (u - 1) * ELIM_ROWS + i + 1;  // row i of tile u - 1
    if (live) {
      const int v = u + S - 1;
      elim_stage_row<T, R, L, V>(v * ELIM_ROWS + i + 1, s, C, c,
                                 elim_in<T, R, V>(ring, v, i), Rm, Om, ym);
      if (u > 0 && j < s)
        elim_output_row<T, R, L, V>(j, C, c,
                                    elim_pk<T, R, V>(parks, u - 1, i),
                                    ld_rows, emit);
      stage_wait<S - 2>();  // tile u + 1 has landed
    }
    if (u > 0) {
      bar<ELIM_ROWS * 32>(bar_out);  // the group's three output warps
      if (i == 0 && live) {
#pragma unroll 1
        for (int r = 0; r < ELIM_ROWS; ++r) {
          const int jr = (u - 1) * ELIM_ROWS + r + 1;
          if (jr >= s) break;
          elim_accumulate<T, R, L, V>(jr == 1,
                                      elim_pk<T, R, V>(parks, u - 1, r),
                                      acc00, accy0, mh, ld);
        }
      }
    }
    bar<ELIM_GROUP_THREADS>(bar_group);
  }
  if (i == 0 && live) {
    store_mat<T, R>(acc00_out, 0, C, c, acc00);
    if constexpr (V) {
      store_vec<T, R>(accy0_out, 0, C, c, accy0);
      mh_out[c] = mh;
      ld_out[c] = ld;
    }
  }
}

// The emit of a sweep that stores nothing per stack row (kernel 1: of its
// rows only ld_rows leaves).
struct ElimNoEmit {
  template <class... A>
  __device__ __forceinline__ void operator()(A&&...) const {}
};

// The sweep of one thread block (launched with Elim<T, R, V>::THREADS
// threads and Elim<T, R, V>::SMEM bytes of dynamic shared memory at
// `smem`): the outputs of forward_sweep.cu's sweep (acc00, accy0, w0l, wl,
// dl, invdl, mh, ld per lane) and ld_rows [s-1, C] -- without V only
// acc00, w0l, dl and invdl (ym and the other outputs unread) -- and
// emit(t, c, D, invd, C_j, W0_j, w_j) for every stack row t = j - 1 (the
// kernel's hats or raw factors).  Step u: the chain runs tile u while the
// output warps start copying tile u + SLOTS - 1 and form the outputs of
// tile u - 1.
template <typename T, int R, bool V = true, class Emit>
__device__ __forceinline__ void elim_split(
    T* smem, const T* __restrict__ Rm, const T* __restrict__ Om,
    const T* __restrict__ ym, T jitter, int s, int C, T* acc00_out,
    T* accy0_out, T* w0l, T* wl, T* dl, T* invdl, T* mh_out, T* ld_out,
    T* ld_rows, Emit emit) {
  using K = Elim<T, R, V>;
  constexpr int L = K::LANES, G = K::GROUPS;
  // warps 0..G-1 run the chains of lane groups 0..G-1; warp G + h forms
  // row h / G of group h % G
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool is_chain = warp < G;
  const int g = is_chain ? warp : (warp - G) % G;
  const int c = (blockIdx.x * G + g) * L + lane;
  const bool live = lane < L && c < C;
  const int bar_group = 1 + 2 * g, bar_out = 2 + 2 * g;  // named barriers
  T* ring = smem + g * K::N * L + lane;
  T* parks = ring + K::RING * L;
  if (is_chain)
    elim_chain_warp<T, R, V>(ring, parks, Om, jitter, s, C, c, live,
                             bar_group, w0l, wl, dl, invdl);
  else
    elim_output_warp<T, R, V>(ring, parks, Rm, Om, ym, s, C, c, live,
                              (warp - G) / G, bar_group, bar_out, acc00_out,
                              accy0_out, mh_out, ld_out, ld_rows, emit);
}

// The float64 ranks at which the four elimination sweeps (kernels 1, 6, 8
// and 10) keep a thread-per-lane instance beside the split one (the C
// entries cgt_*_thread_f64; ops/_build.py's ELIM_THREAD routes to them
// where the split design loses, and chip_smoke.py's [elim-pick] times the
// two); any other rank returns cudaErrorInvalidValue.
#define CGT_THREAD_RANK_SWITCH(r, CALL)          \
  switch (r) {                                   \
    case 7: CALL(7); break;                      \
    case 8: CALL(8); break;                      \
    default: return int(cudaErrorInvalidValue); \
  }

}  // namespace pipe
}  // namespace cgt
