// Cooperative runtime-d block algebra: ONE WARP PER CHUNK LANE, the lane's
// d x d blocks in shared memory, d a runtime value in 9..15 (one instance
// per dtype), or up to 16 where a kernel hands `Sweep::step` the d = 16
// triangle `Tri16` (which also picks the d = 16 paired solve,
// `solve_pair<.., true>`).  It carries the Takahashi walks
// (rt_inverse.cu's rt_takahashi_kernel, wide_backward.cu's
// wide_backward_kernel and backward_sweep.cu's backsolve_warp_kernel at
// d = 16) and the forward sweeps on one elimination step (`Sweep`),
// whose rows start with a Cholesky of the pivot block (`chol`): the
// likelihood's (rt_solve.cu's rt_sweep_kernel, forward_sweep.cu's
// forward_sweep_warp_kernel at d = 16, and wide_sweep.cu's
// wide_sweep_kernel on the wide layout), the three that collect the
// backward's stacks (rt_solve.cu's rt_collect_kernel; with
// `Sweep::hats`, wide_sweep.cu's wide_solveinv_kernel and
// backward_sweep.cu's solveinv_warp_kernel at d = 16) and the selected
// inversion's, which has no right-hand side (rt_inverse.cu's
// rt_inverse_sweep_kernel); celerite_sweep.cu's warp instance, which
// builds its rows in place at d = 2 nblocks (16 at nblocks 8); and the
// solve's back-substitution (rt_solve.cu's rt_backsub_warp_kernel), two
// matrix-vector products a row (`dot_v`).  `rt_size` and WMAX give the
// runtime block sizes every kernel of 9..15 takes.
//
// Why not the first port's design (one thread per lane, every block in local
// memory): a walk step is a dependent chain of ~30 d^3 operations over ~14
// blocks, a sweep row one of ~10-22 d^3.  Held per thread that is 8-25 KB
// of stack, more local memory than the 50 MB L2 holds at C = 7,813 lanes,
// so operands stream through HBM; and C threads make ~2 warps per SM, too
// few to hide any latency.  Here the lane's blocks sit in shared memory
// (~5-9 KB at float32, d = 12) and its 32 threads share every product, so
// an SM holds 24 warps at float32 (12 at float64; three thread blocks, by
// the register budget) and no operand leaves the SM between a step's tile
// load and its tile store.
//
// Threads.  A thread block covers LANES consecutive chunk lanes with
// LANES * sizeof(T) = 32 B (8 lanes at float32, 4 at float64), one warp
// each.  In a product every output element is owned by one thread of the
// warp (elements lane, lane + 32, ... of the block in row-major order) and
// summed in ascending k, as blockmath.cuh's mm_op, so results agree with the
// thread-per-lane algebra to rounding.  Triangular solves against a d x d
// right-hand side run one column per thread; the Cholesky splits each
// column's trailing update over the warp.  __syncwarp() separates
// dependent operations; __syncthreads() only brackets the block-wide tile
// loads and stores.
//
// Shared layout.  Lane l of the block owns `stride` numbers from
// l * stride: NB blocks of d x ld numbers (row stride ld = d | 1, odd, so a
// walk down a column -- the transposed operand of a product, a column
// solve -- touches distinct banks) and NV vectors of d.  A block is named by
// its offset in the region, the same in every lane, so a kernel hands the
// carried blocks to the next step by swapping offsets: no block is copied.
//
// Tiles.  The global stacks keep the chunk-major layout, lanes innermost:
// for one element the tile's LANES lanes are 32 consecutive bytes.  In a
// tile load thread t fetches elements t / LANES, + 32, ... of lane
// t % LANES, so each group of LANES neighbouring threads reads one whole
// 32-byte span; stores mirror it.  Lanes past C (the ragged last tile)
// neither load, compute nor store.
#pragma once

#include "blockmath.cuh"

namespace cgt {
namespace rt {

constexpr int WMAX = 15;  // the largest runtime block size

// the runtime block sizes the chunk-major kernels take
__host__ __device__ __forceinline__ bool rt_size(int d) {
  return d > 8 && d <= WMAX;
}

}  // namespace rt

namespace coop {

// chunk lanes per thread block, one warp each: LANES * sizeof(T) = 32 B
// (MIN_BLOCKS: the thread blocks an SM should hold, the register budget
// of __launch_bounds__; d = 12 fits three in shared memory)
template <typename T>
struct Tile {
  static constexpr int LANES = 32 / int(sizeof(T));
  static constexpr int THREADS = 32 * LANES;
  static constexpr int MIN_BLOCKS = 3;
};

// row stride of a d x d block in shared memory (odd)
__host__ __device__ __forceinline__ int pad_ld(int d) { return d | 1; }

// numbers in one lane's region: nb blocks and nv vectors
__host__ __device__ __forceinline__ int region(int d, int nb, int nv) {
  return nb * d * pad_ld(d) + nv * d;
}

// dynamic shared bytes of one thread block
template <typename T>
inline size_t smem_bytes(int d, int nb, int nv) {
  return size_t(Tile<T>::LANES) * region(d, nb, nv) * sizeof(T);
}

// registers a thread needs to hold its share of one d x d block of a tile
// (Tiles::fetch_m) at every runtime d
constexpr int TILE_REGS = (rt::WMAX * rt::WMAX + 31) / 32;

template <typename T>
inline int grid_for(int C) {
  return (C + Tile<T>::LANES - 1) / Tile<T>::LANES;
}

// Allow a kernel `bytes` of dynamic shared memory (above the 48 KB
// default) and ask for the largest shared carve-out, so that several
// tiles share an SM.
template <typename K>
inline cudaError_t prepare(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// The elements q = q0, q0 + 32, ... of a row-major block with d columns as
// (q, i, k), without a division per element (32 = di d + dk).
struct Walk {
  int q0, i0, k0, di, dk, d;
  __device__ __forceinline__ Walk(int q0_, int d_)
      : q0(q0_), i0(q0_ / d_), k0(q0_ % d_), di(32 / d_), dk(32 % d_),
        d(d_) {}
};

// A position on a Walk: for (Cursor c(w); c.q < n; c.next(w)) ...
struct Cursor {
  int q, i, k;
  __device__ __forceinline__ explicit Cursor(const Walk& w)
      : q(w.q0), i(w.i0), k(w.k0) {}
  __device__ __forceinline__ void next(const Walk& w) {
    q += 32;
    i += w.di;
    k += w.dk;
    if (k >= w.d) {
      k -= w.d;
      ++i;
    }
  }
};

// One warp's share of its lane's d x d algebra: this thread owns the
// output elements of the Walk from its lane.
struct Warp {
  Walk w;
  int lane, d, ld, dd;
  __device__ __forceinline__ explicit Warp(int d_)
      : w(int(threadIdx.x & 31), d_), lane(int(threadIdx.x & 31)), d(d_),
        ld(pad_ld(d_)), dd(d_ * d_) {}
};

// sum_p op(a)[i][p] op(b)[p][k], ascending p (op transposes where TA / TB)
template <typename T, bool TA, bool TB>
__device__ __forceinline__ T dot(const T* a, const T* b, int i, int k, int d,
                                 int ld) {
  const T* pa = a + (TA ? i : i * ld);
  const T* pb = b + (TB ? k * ld : k);
  const int sa = TA ? ld : 1;
  const int sb = TB ? 1 : ld;
  T acc = pa[0] * pb[0];
  for (int p = 1; p < d; ++p) acc += pa[p * sa] * pb[p * sb];
  return acc;
}

enum Mode { SET, ADD, SUB, NEG };

// out = op(a) op(b), out += .., out -= .., or out = -(..); out must not
// alias a or b
template <typename T, bool TA, bool TB, Mode M>
__device__ __forceinline__ void mm_op(const Warp& w, const T* a, const T* b,
                                      T* out) {
  for (Cursor c(w.w); c.q < w.dd; c.next(w.w)) {
    const T v = dot<T, TA, TB>(a, b, c.i, c.k, w.d, w.ld);
    T& o = out[c.i * w.ld + c.k];
    if (M == SET) o = v;
    if (M == ADD) o += v;
    if (M == SUB) o -= v;
    if (M == NEG) o = -v;
  }
}

template <typename T>
__device__ __forceinline__ void mm(const Warp& w, const T* a, const T* b,
                                   T* out) {
  mm_op<T, false, false, SET>(w, a, b, out);
}

template <typename T>
__device__ __forceinline__ void mm_ta(const Warp& w, const T* a, const T* b,
                                      T* out) {
  mm_op<T, true, false, SET>(w, a, b, out);
}

// out += a b
template <typename T>
__device__ __forceinline__ void mm_add(const Warp& w, const T* a, const T* b,
                                       T* out) {
  mm_op<T, false, false, ADD>(w, a, b, out);
}

// out = (base + x0 y0) + x1 y1; out may be base
template <typename T>
__device__ __forceinline__ void mm2_add(const Warp& w, const T* base,
                                        const T* x0, const T* y0,
                                        const T* x1, const T* y1, T* out) {
  for (Cursor c(w.w); c.q < w.dd; c.next(w.w)) {
    const int o = c.i * w.ld + c.k;
    const T v = base[o] + dot<T, false, false>(x0, y0, c.i, c.k, w.d, w.ld);
    out[o] = v + dot<T, false, false>(x1, y1, c.i, c.k, w.d, w.ld);
  }
}

// out = -a; out may be a
template <typename T>
__device__ __forceinline__ void neg(const Warp& w, const T* a, T* out) {
  for (Cursor c(w.w); c.q < w.dd; c.next(w.w))
    out[c.i * w.ld + c.k] = -a[c.i * w.ld + c.k];
}

// a0 = p00 u0^T + p01 u1^T,  a1 = p10 u0^T + p11 u1^T  (Sigma_BB U^T)
template <typename T>
__device__ __forceinline__ void sig_ut(const Warp& w, const T* p00,
                                       const T* p01, const T* p10,
                                       const T* p11, const T* u0,
                                       const T* u1, T* a0, T* a1) {
  for (Cursor c(w.w); c.q < w.dd; c.next(w.w)) {
    const int i = c.i, k = c.k, o = i * w.ld + k;
    a0[o] = dot<T, false, true>(p00, u0, i, k, w.d, w.ld) +
            dot<T, false, true>(p01, u1, i, k, w.d, w.ld);
    a1[o] = dot<T, false, true>(p10, u0, i, k, w.d, w.ld) +
            dot<T, false, true>(p11, u1, i, k, w.d, w.ld);
  }
}

// x = L^{-1}, the forward substitution of blockmath.cuh's solve_lower on the
// identity, one column per thread
template <typename T>
__device__ __forceinline__ void solve_lower(const Warp& w, const T* L,
                                            const T* invd, T* x) {
  const int e = w.lane, d = w.d, ld = w.ld;
  if (e >= d) return;
  for (int i = 0; i < d; ++i) {
    T acc = (i == e) ? T(1) : T(0);
    for (int k = 0; k < i; ++k) acc -= L[i * ld + k] * x[k * ld + e];
    x[i * ld + e] = acc * invd[i];
  }
}

// ---------------------------------------------------------------------------
// The cooperative elimination step: blockmath.cuh's chol, triangular solves
// and elim_step, each summing in the order blockmath.cuh sums.
// ---------------------------------------------------------------------------

// out[i] = / += / -= sum_p op(a)[i][p] x[p] (ascending p; op transposes
// where TA), one element per thread; out must not alias a or x
template <typename T, bool TA, Mode M>
__device__ __forceinline__ void mv_op(const Warp& w, const T* a, const T* x,
                                      T* out) {
  const int i = w.lane, d = w.d;
  if (i >= d) return;
  const T* pa = a + (TA ? i : i * w.ld);
  const int sa = TA ? w.ld : 1;
  T acc = pa[0] * x[0];
  for (int p = 1; p < d; ++p) acc += pa[p * sa] * x[p];
  if (M == SET) out[i] = acc;
  if (M == ADD) out[i] += acc;
  if (M == SUB) out[i] -= acc;
  if (M == NEG) out[i] = -acc;
}

// sum_p a[p] x[p] in ascending p (one row of a product by a vector, as
// mv_op sums it)
template <typename T>
__device__ __forceinline__ T dot_v(const T* a, const T* x, int d) {
  T acc = a[0] * x[0];
  for (int p = 1; p < d; ++p) acc += a[p] * x[p];
  return acc;
}

// sum_i v[i]^2 in ascending i, in every thread
template <typename T>
__device__ __forceinline__ T sumsq(const Warp& w, const T* v) {
  T acc = T(0);
  for (int i = 0; i < w.d; ++i) acc += v[i] * v[i];
  return acc;
}

// This thread's share of a d x d block's lower triangle: the elements
// lane, lane + 32, ... in row-major order (t = a (a + 1) / 2 + b, b <= a),
// as (a * ld, b); b = -1 past the triangle.  M slots: four hold the 120
// elements of d = 15 (`Tri`), five the 136 of d = 16 (`Tri16`).
template <int M>
struct TriM {
  static constexpr int SLOTS = M;
  int ra[M], b[M];
  __device__ __forceinline__ explicit TriM(const Warp& w) {
    const int n = w.d * (w.d + 1) / 2;
    int a = 0, bb = w.lane;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      while (bb > a) bb -= ++a;
      ra[m] = a * w.ld;
      b[m] = w.lane + 32 * m < n ? bb : -1;
      bb += 32;
    }
  }
};
using Tri = TriM<4>;
using Tri16 = TriM<5>;

// Lower Cholesky of the SPD block x (lower triangle read) in place, as
// blockmath.cuh's chol: right-looking, rsqrt pivots, no floor.  Leaves L in
// x (upper triangle zeroed) and 1/L_jj in invd, and returns the half
// log-determinant sum_j 0.5 log(pivot_j) (ascending j) in every thread.
// Per column: every thread reads the pivot, threads i > j scale L[i][j],
// and the warp splits the trailing update of the lower triangle.
template <typename T, int M>
__device__ __forceinline__ T chol(const Warp& w, const TriM<M>& tri, T* x,
                                  T* invd) {
  const int d = w.d, ld = w.ld, i = w.lane;
  T half = T(0);
  for (int j = 0; j < d; ++j) {
    __syncwarp();
    const T piv = x[j * ld + j];
    const T pinv = rsqrt_(piv);
    half += T(0.5) * log_(piv);
    if (i > j && i < d) {
      x[i * ld + j] *= pinv;
      x[j * ld + i] = T(0);
    }
    __syncwarp();
    if (i == j) {  // nobody reads the pivot's place from here on
      x[j * ld + j] = piv * pinv;
      invd[j] = pinv;
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (tri.b[m] > j)
        x[tri.ra[m] + tri.b[m]] -= x[tri.ra[m] + j] * x[tri.b[m] * ld + j];
  }
  __syncwarp();
  return half;
}

// One column of a triangular solve against the factor L (1/diag in invd):
// y at src[i * ss], x at dst[i * ds] (dst may be src); FWD L x = y as
// blockmath.cuh's solve_lower, else L^T x = y by back substitution (rows
// d-1 .. 0, each summing k = i+1 .. d-1 in ascending order); with neg the
// column is negated after
template <typename T, bool FWD>
__device__ __forceinline__ void solve_col(const T* L, const T* invd, int d,
                                          int ld, const T* src, int ss,
                                          T* dst, int ds, bool neg) {
  if (FWD) {
    for (int i = 0; i < d; ++i) {
      T acc = src[i * ss];
      for (int k = 0; k < i; ++k) acc -= L[i * ld + k] * dst[k * ds];
      dst[i * ds] = acc * invd[i];
    }
  } else {
    for (int i = d - 1; i >= 0; --i) {
      T acc = src[i * ss];
      for (int k = i + 1; k < d; ++k) acc -= L[k * ld + i] * dst[k * ds];
      dst[i * ds] = acc * invd[i];
    }
  }
  if (neg)
    for (int i = 0; i < d; ++i) dst[i * ds] = -dst[i * ds];
}

// A d x d right-hand side Y and where its solution X goes: Y (X) as stored
// at y (x), or as the transpose of the block stored there where ty (tx);
// x may be y
template <typename T>
struct Rhs {
  const T* y;
  T* x;
  bool ty, tx, neg;
};

// Two triangular solves with d x d right-hand sides and one with a vector,
// at once: threads 0-15 take r0's columns, 16-31 r1's, and thread 31 (no
// column of either at d <= 15) the vector yv -> xv (xv may be yv; none
// where xv is null).  FWD: L X = Y, else L^T X = Y.  D16: d may be 16,
// where thread 31 owns r1's last column, so it solves the vector after it
// (a second serial chain of d^2 / 2 multiply-adds).
template <typename T, bool FWD, bool D16 = false>
__device__ __forceinline__ void solve_pair(const Warp& w, const T* L,
                                           const T* invd, const Rhs<T>& r0,
                                           const Rhs<T>& r1,
                                           const T* yv = nullptr,
                                           T* xv = nullptr) {
  const int e = w.lane & 15, ld = w.ld;
  const bool vec = w.lane == 31 && xv != nullptr;
  if (D16) {
    if (e < w.d) {
      const Rhs<T> r = w.lane < 16 ? r0 : r1;
      solve_col<T, FWD>(L, invd, w.d, ld, r.y + (r.ty ? e * ld : e),
                        r.ty ? 1 : ld, r.x + (r.tx ? e * ld : e),
                        r.tx ? 1 : ld, r.neg);
    }
    if (vec) solve_col<T, FWD>(L, invd, w.d, ld, yv, 1, xv, 1, false);
    return;
  }
  if (e >= w.d && !vec) return;
  const Rhs<T> r = w.lane < 16 ? r0 : r1;
  const T* src = vec ? yv : r.y + (r.ty ? e * ld : e);
  T* dst = vec ? xv : r.x + (r.tx ? e * ld : e);
  solve_col<T, FWD>(L, invd, w.d, ld, src, vec || r.ty ? 1 : ld, dst,
                    vec || r.tx ? 1 : ld, !vec && r.neg);
}

// The lane's state in the forward sweep of the chunk interior (the
// cooperative twin of blockmath.cuh's SweepCarry and elim_step), as
// offsets in the lane's region: the blocks P (R_j, then D_j), O (O_j, then
// C_j), CP (C_{j-1}), W0, X (scratch, then W0's successor), ACC; the
// vectors Y (y_j, then w_j), W (w_{j-1}), ACCY0, INVD, and SC, whose first
// numbers hold per-lane scalars for Tiles::store_s.  A kernel's own blocks
// and vectors follow (`block`, `vec`).  mh and ld are in registers.
enum { SW_P, SW_O, SW_CP, SW_W0, SW_X, SW_ACC, SW_BLOCKS };
enum { SW_Y, SW_W, SW_ACCY0, SW_INVD, SW_SC, SW_VECS };

template <typename T>
struct Sweep {
  T* me;          // the lane's region
  int d, bs, vb;  // block size d * ld, offset of the first vector
  int p, o, cp, w0, x, y, wv;  // the offsets that move
  T mh, ld;
  __device__ __forceinline__ Sweep(T* me_, int d_, int nblocks)
      : me(me_), d(d_), bs(d_ * pad_ld(d_)), vb(nblocks * bs),
        p(SW_P * bs), o(SW_O * bs), cp(SW_CP * bs), w0(SW_W0 * bs),
        x(SW_X * bs), y(vb + SW_Y * d_), wv(vb + SW_W * d_), mh(0), ld(0) {}
  __device__ __forceinline__ int block(int k) const { return k * bs; }
  __device__ __forceinline__ int vec(int k) const { return vb + k * d; }
  __device__ __forceinline__ T* at(int off) const { return me + off; }

  // Eliminate row j (P = R_j, O = O_j, Y = y_j loaded; at the first row
  // W0 = o_left): P = (R_j + jitter I) - C C^T, its factor D, W0 =
  // D^{-1} o_left (first) or -D^{-1} C W0, w = D^{-1} (y - C w),
  // C_j = (D^{-1} O_j^T)^T, then the sums acc += W0^T W0, accy0 +=
  // W0^T w, mh += ||w||^2, ld += log|D|.  Returns the row's half
  // log-determinant.  The new state is read under the names `advance`
  // gives; all but acc and accy0 are final when this returns.  VEC =
  // false drops the right-hand side (w, accy0, mh; Y is neither read nor
  // written) for a sweep that has none, the selected inversion's.  The
  // triangle's type sets the largest d: `Tri` 15, `Tri16` 16.
  template <bool VEC = true, int M = 4>
  __device__ __forceinline__ T step(const Warp& w, const TriM<M>& tri,
                                    bool first, T jitter) {
    T* const P = me + p;
    T* const O = me + o;
    const T* const C = me + cp;
    T* const W0 = me + w0;
    T* const X = me + x;
    T* const Y = me + y;
    T* const invd = me + vec(SW_INVD);
    for (Cursor c(w.w); c.q < w.dd; c.next(w.w)) {
      const int q = c.i * w.ld + c.k;
      if (c.k <= c.i) {
        T v = P[q];
        if (c.i == c.k) v += jitter;
        if (!first) v -= dot<T, false, true>(C, C, c.i, c.k, w.d, w.ld);
        P[q] = v;
      }
      if (!first) X[q] = dot<T, false, false>(C, W0, c.i, c.k, w.d, w.ld);
    }
    if (VEC && !first) mv_op<T, false, SUB>(w, C, me + wv, Y);
    __syncwarp();
    const T ldl = chol<T>(w, tri, P, invd);
    // W0 (or -(C W0)) and O^T solved in place, O stored as its transpose
    const Rhs<T> r0 = first ? Rhs<T>{W0, W0, false, false, false}
                            : Rhs<T>{X, X, false, false, true};
    solve_pair<T, true, (M > 4)>(w, P, invd, r0,
                                 Rhs<T>{O, O, true, true, false},
                                 VEC ? Y : nullptr, VEC ? Y : nullptr);
    __syncwarp();
    const T* const W0n = first ? W0 : X;
    T* const acc = me + block(SW_ACC);
    T* const accy0 = me + vec(SW_ACCY0);
    if (first) {
      mm_op<T, true, false, SET>(w, W0n, W0n, acc);
      if (VEC) mv_op<T, true, SET>(w, W0n, Y, accy0);
    } else {
      mm_op<T, true, false, ADD>(w, W0n, W0n, acc);
      if (VEC) mv_op<T, true, ADD>(w, W0n, Y, accy0);
    }
    if (VEC) {
      const T ww = sumsq<T>(w, Y);
      mh = first ? ww : mh + ww;
    }
    ld = first ? ldl : ld + ldl;
    return ldl;
  }

  // rename after `step` (every thread, live or not: the tile loads use
  // the offsets): C_j, W0_j, w_j take their names, and the next row loads
  // into the freed blocks
  __device__ __forceinline__ void advance(bool first) {
    const int t_cp = cp, t_y = y;
    cp = o;
    o = t_cp;
    y = wv;
    wv = t_y;
    if (!first) {
      const int t_w0 = w0;
      w0 = x;
      x = t_w0;
    }
  }

  // After `step` and `advance`: the row's hats from the triangular inverse
  // di = D^{-1} (into the kernel's block `o_di`), as the TPU kernels' emit
  // builds them: hat_C = di^T C^T (block `o_hc`), hat_W0 = di^T W0 (into
  // the free X), pinv = di^T di (block `o_pinv`), hat_w = di^T w (vector
  // `o_hw`).
  __device__ __forceinline__ void hats(const Warp& w, int o_di, int o_hc,
                                       int o_pinv, int o_hw) const {
    T* const di = at(o_di);
    solve_lower<T>(w, at(p), at(vec(SW_INVD)), di);
    __syncwarp();
    mm_op<T, true, true, SET>(w, di, at(cp), at(o_hc));
    mm_op<T, true, false, SET>(w, di, at(w0), at(x));
    mm_op<T, true, false, SET>(w, di, di, at(o_pinv));
    mv_op<T, true, SET>(w, di, at(wv), at(o_hw));
  }
};

// element q of a wide block (a11 elements 0..63, then the strip's rows of
// 8: A21, A12^T, A22; ops/wideblock.py) -> its offset in the dense d x ld
// block, or -1 for the A22 strip's padding columns (>= e)
__device__ __forceinline__ int wide_dense(int q, int e, int ld) {
  if (q < 64) return (q >> 3) * ld + (q & 7);
  const int row = (q - 64) >> 3, col = q & 7;
  if (row < e) return (8 + row) * ld + col;
  if (row < 2 * e) return col * ld + 8 + row - e;
  return col < e ? (8 + row - 2 * e) * ld + 8 + col : -1;
}

// The block-wide tile loads and stores of one thread block: its LANES
// chunk lanes from c0 = blockIdx.x * LANES, each lane's region at
// sm + lane * stride.
template <typename T>
struct Tiles {
  static constexpr int L = Tile<T>::LANES;
  T* sm;
  int stride, d, ld, C, c0;
  int l;      // this thread's lane of the tile (threadIdx.x % L)
  bool live;  // that lane is < C
  Walk w;     // its elements: threadIdx.x / L, + 32, ...
  __device__ __forceinline__ Tiles(T* sm_, int stride_, int d_, int C_)
      : sm(sm_), stride(stride_), d(d_), ld(pad_ld(d_)), C(C_),
        c0(int(blockIdx.x) * L), l(int(threadIdx.x) % L),
        live(c0 + l < C_), w(int(threadIdx.x) / L, d_) {}

  // step j of a chunk-major stack [*, d, d, C] into block `off`
  __device__ __forceinline__ void load_m(const T* __restrict__ src, int j,
                                         int off) const {
    if (!live) return;
    T* dst = sm + l * stride + off;
    const T* p = src + size_t(j) * d * d * C + c0 + l;
    for (Cursor c(w); c.q < d * d; c.next(w))
      dst[c.i * ld + c.k] = p[size_t(c.q) * C];
  }

  __device__ __forceinline__ void store_m(T* dst, int j, int off) const {
    if (!live) return;
    const T* src = sm + l * stride + off;
    T* p = dst + size_t(j) * d * d * C + c0 + l;
    for (Cursor c(w); c.q < d * d; c.next(w))
      p[size_t(c.q) * C] = src[c.i * ld + c.k];
  }

  // step j of a chunk-major stack [*, d, d, C] into registers: this
  // thread's elements of its lane, as load_m takes them (buf[m] holds
  // element w.q0 + 32 m), all loads issued before any is used; put_m then
  // writes them into block `off`.  K = TILE_REGS covers every d <= WMAX.
  template <int K>
  __device__ __forceinline__ void fetch_m(const T* __restrict__ src, int j,
                                          T (&buf)[K]) const {
    if (!live) return;
    const T* p = src + size_t(j) * d * d * C + c0 + l;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int q = w.q0 + 32 * m;
      if (q < d * d) buf[m] = p[size_t(q) * C];
    }
  }

  template <int K>
  __device__ __forceinline__ void put_m(const T (&buf)[K], int off) const {
    if (!live) return;
    T* dst = sm + l * stride + off;
    Cursor c(w);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (c.q < d * d) dst[c.i * ld + c.k] = buf[m];
      c.next(w);
    }
  }

  // fetch_m / put_m of a vector stack [*, d, C] (d <= 32: one element a
  // thread at most)
  __device__ __forceinline__ T fetch_v(const T* __restrict__ src,
                                       int j) const {
    if (!live || w.q0 >= d) return T(0);
    return src[(size_t(j) * d + w.q0) * C + c0 + l];
  }

  __device__ __forceinline__ void put_v(T v, int off) const {
    if (live && w.q0 < d) sm[l * stride + off + w.q0] = v;
  }

  // step j of a vector stack [*, d, C] into the vector at `off`
  __device__ __forceinline__ void load_v(const T* __restrict__ src, int j,
                                         int off) const {
    if (!live) return;
    const T* p = src + size_t(j) * d * C + c0 + l;
    for (int q = w.q0; q < d; q += 32) sm[l * stride + off + q] =
        p[size_t(q) * C];
  }

  __device__ __forceinline__ void store_v(T* dst, int j, int off) const {
    if (!live) return;
    T* p = dst + size_t(j) * d * C + c0 + l;
    for (int q = w.q0; q < d; q += 32) p[size_t(q) * C] =
        sm[l * stride + off + q];
  }

  // the lane's scalar at `off` into element j of a stack [*, C] (threads
  // 0..LANES-1, thread t for lane t)
  __device__ __forceinline__ void store_s(T* dst, int j, int off) const {
    if (int(threadIdx.x) >= L || !live) return;
    dst[size_t(j) * C + c0 + l] = sm[l * stride + off];
  }

  // step j of a wide pair (a11 [*, 8, 8, C], st [*, 3e, 8, C], e = d - 8)
  // unpacked into the dense block `off`; the strip's padding is not read
  __device__ __forceinline__ void load_w(const T* __restrict__ a11,
                                         const T* __restrict__ st, int j,
                                         int off) const {
    if (!live) return;
    const int e = d - 8;
    T* dst = sm + l * stride + off;
    const T* pa = a11 + size_t(j) * 64 * C + c0 + l;
    const T* ps = st + size_t(j) * 24 * e * C + c0 + l;
    for (int q = w.q0; q < 64 + 24 * e; q += 32) {
      const int o = wide_dense(q, e, ld);
      if (o >= 0) dst[o] = q < 64 ? pa[size_t(q) * C] : ps[size_t(q - 64) * C];
    }
  }

  // the dense block `off` packed into step j of a wide pair, the A22
  // strip's columns >= e written as zeros
  __device__ __forceinline__ void store_w(T* a11, T* st, int j,
                                          int off) const {
    if (!live) return;
    const int e = d - 8;
    const T* src = sm + l * stride + off;
    T* pa = a11 + size_t(j) * 64 * C + c0 + l;
    T* ps = st + size_t(j) * 24 * e * C + c0 + l;
    for (int q = w.q0; q < 64 + 24 * e; q += 32) {
      const int o = wide_dense(q, e, ld);
      const T v = o >= 0 ? src[o] : T(0);
      if (q < 64)
        pa[size_t(q) * C] = v;
      else
        ps[size_t(q - 64) * C] = v;
    }
  }
};

}  // namespace coop
}  // namespace cgt
