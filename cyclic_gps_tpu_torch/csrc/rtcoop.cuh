// Cooperative runtime-d block algebra: ONE WARP PER CHUNK LANE, the lane's
// d x d blocks in shared memory, d a runtime value in 9..15 (one instance
// per dtype).  It carries the two Takahashi walks, rt_inverse.cu's
// rt_takahashi_kernel and wide_backward.cu's wide_backward_kernel.
//
// Why not rtblock.cuh's design (one thread per lane, every block in local
// memory): a walk step is a dependent chain of ~30 d^3 operations over ~14
// blocks.  Held per thread that is 8-25 KB of stack, more local memory
// than the 50 MB L2 holds at C = 7,813 lanes, so operands stream through
// HBM; and C threads make ~2 warps per SM, too few to hide any latency.
// Here the lane's blocks sit in shared memory (~9 KB at float32, d = 12)
// and its 32 threads share every product, so an SM holds 16-24 warps at
// float32 (8-12 at float64) and no operand leaves the SM between a step's
// tile load and its tile store.
//
// Threads.  A thread block covers LANES consecutive chunk lanes with
// LANES * sizeof(T) = 32 B (8 lanes at float32, 4 at float64), one warp
// each.  In a product every output element is owned by one thread of the
// warp (elements lane, lane + 32, ... of the block in row-major order) and
// summed in ascending k, as rtblock.cuh's mm_op, so results agree with the
// thread-per-lane algebra to rounding.  Triangular solves against a d x d
// right-hand side run one column per thread.  __syncwarp() separates
// dependent operations; __syncthreads() only brackets the block-wide tile
// loads and stores.
//
// Shared layout.  Lane l of the block owns `stride` numbers from
// l * stride: NB blocks of d x ld numbers (row stride ld = d | 1, odd, so a
// walk down a column -- the transposed operand of a product, a column
// solve -- touches distinct banks) and NV vectors of d.  A block is named by
// its offset in the region, the same in every lane, so a kernel hands the
// carried blocks to the next step by swapping offsets: the walks copy no
// block.
//
// Tiles.  The global stacks keep the chunk-major layout, lanes innermost:
// for one element the tile's LANES lanes are 32 consecutive bytes.  In a
// tile load thread t fetches elements t / LANES, + 32, ... of lane
// t % LANES, so each group of LANES neighbouring threads reads one whole
// 32-byte span; stores mirror it.  Lanes past C (the ragged last tile)
// neither load, compute nor store.
#pragma once

#include "rtblock.cuh"

namespace cgt {
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

// x = L^{-1}, the forward substitution of rtblock.cuh's solve_lower on the
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

// x0 = L^{-T} x0 and x1 = L^{-T} x1 in place (back substitution), one
// column per thread: threads 0-15 take x0, 16-31 x1; with neg1, x1's
// thread negates its column after
template <typename T>
__device__ __forceinline__ void solve_lower_t(const Warp& w, const T* L,
                                              const T* invd, T* x0, T* x1,
                                              bool neg1) {
  const int e = w.lane & 15, d = w.d, ld = w.ld;
  if (e >= d) return;
  T* x = w.lane < 16 ? x0 : x1;
  for (int i = d - 1; i >= 0; --i) {
    T acc = x[i * ld + e];
    for (int k = i + 1; k < d; ++k) acc -= L[k * ld + i] * x[k * ld + e];
    x[i * ld + e] = acc * invd[i];
  }
  if (neg1 && w.lane >= 16)
    for (int i = 0; i < d; ++i) x[i * ld + e] = -x[i * ld + e];
}

// element q of a wide block (a11 elements 0..63, then the strip's rows of
// 8: A21, A12^T, A22; wideblock.cuh) -> its offset in the dense d x ld
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
