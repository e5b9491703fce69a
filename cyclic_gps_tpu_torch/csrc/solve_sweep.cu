// The two kernels of the block-tridiagonal solve x = J^{-1} y: the forward
// sweep that streams the hat back-substitution factors, and the descending
// back-substitution over them.
//
// Replaces (cyclic_gps_tpu/ops/pallas_sweep.py):
//   collect_split_kernel         <- :400 forward_sweep_collect_pallas
//                                   (kernel body _sweep_collect_kernel, :328)
//   backsub_split_kernel         <- :1006 backward_substitute_pallas
//                                   (_backsub_kernel, :976)
//
// What bounds them on the H100: both stream stacks of R x R blocks, each
// chunk lane c walking that chunk's s-1 rows (ascending for the sweep,
// descending for the back-substitution).  Per row the sweep reads
// 2 R^2 + R values and writes 2 R^2 + R + 1; the back-substitution reads
// 2 R^2 + R and writes R.  In bytes that is ~440 MB and ~240 MB at rank 5,
// N = 1e6, float32 (bounds of ~0.13 and ~0.07 ms).  With C = N/s lanes
// (7,813 at s = 128) each lane runs a dependent chain of small products
// per row, so both are latency-bound unless the chain is split from the
// rest.
//
// Both split each lane's rows between warps, one running the serial chain
// while the others copy rows in with cp.async and form what feeds nothing
// back: the sweep is pipeline.cuh's elim_split (the elimination's carried
// part on the chain; the three back substitutions, ld_rows and the sums
// on three output warps; two lane groups of 32 a block at rank 5 float32,
// 123 blocks at N = 1e6), the back-substitution is backsub_split_kernel
// below (32 lanes a block, 245 blocks).  With the chain split off, the
// sweep's time on the H100 is mostly its stores of the hat stacks.  Both
// index their rows with plain strides (no reversed copy).  Where the split
// sweep loses (float64 rank 8 falls into local memory: ops/_build.py's
// ELIM_THREAD), the wrapper takes the thread-per-lane sweep
// (forward_sweep_collect_kernel, kept at float64 ranks 7-8 only,
// cgt_forward_sweep_collect_thread_f64).
#include "blockmath.cuh"
#include "pipeline.cuh"
#include "rtcoop.cuh"

namespace {

namespace pp = cgt::pipe;

// Kernel 8's outputs of stack row t (elim_split's emit), each by one back
// substitution against D_j^T as the TPU kernel writes them.
template <typename T, int R>
struct CollectHats {
  T *hc, *hw0, *hw;
  int C;
  __device__ __forceinline__ void operator()(int t, int c, const T (&D)[R][R],
                                             const T (&invd)[R],
                                             const T (&cprev)[R][R],
                                             const T (&w0)[R][R],
                                             const T (&w)[R]) const {
    T ct[R][R], m[R][R], v[R];
    cgt::transpose<T, R>(cprev, ct);
    cgt::solve_lower_t<T, R, R>(D, invd, ct, m);
    cgt::store_mat<T, R>(hc, t, C, c, m);
    cgt::solve_lower_t<T, R, R>(D, invd, w0, m);
    cgt::store_mat<T, R>(hw0, t, C, c, m);
    cgt::solve_lower_t_vec<T, R>(D, invd, w, v);
    cgt::store_vec<T, R>(hw, t, C, c, v);
  }
};

// Kernel 8 at ranks 1-8: the forward sweep (the elimination of
// forward_sweep.cu) that also writes, for every interior step j = 1..s-1
// (stack row j-1), the hat factors of the back-substitution, each by one
// back substitution against D_j^T as the TPU kernel does:  hat_C =
// D^{-T} C^T,  hat_W0 = D^{-T} W0,  hat_w = D^{-T} w, and the step's
// pivot log-determinant 2 log|D_j|.  The split design of
// pipeline.cuh's elim_split: a chain warp runs the elimination's carried
// part down tiles of 3 rows while three warps copy the rows in and form
// these three solves, ld_rows and the sums.
template <typename T, int R>
__global__ void __launch_bounds__(pp::Elim<T, R>::THREADS)
collect_split_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                     const T* __restrict__ ym, T jitter, int s, int C,
                     T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                     T* mh, T* ld, T* hc, T* hw0, T* hw, T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  pp::elim_split<T, R>(reinterpret_cast<T*>(cgt_smem), Rm, Om, ym, jitter,
                       s, C, acc00, accy0, w0l, wl, dl, invdl, mh, ld,
                       ld_rows, CollectHats<T, R>{hc, hw0, hw, C});
}

// Kernel 8 one thread per chunk lane (float64 ranks 7-8 only): the carried
// state in registers, each step's three back substitutions as CollectHats
// forms them.
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
  const CollectHats<T, R> hats{hc, hw0, hw, C};
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

// Kernel 9 at ranks 1-8: the back-substitution with its loads taken off
// the chain.  One descending pass per chunk lane over stack rows s-2 .. 0
// (steps s-1 .. 1), the whole stack included:
//   common_j = hat_w_j - hat_W0_j x_b
//   x_{s-1}  = common - hat_W1 x_{b,next}
//   x_j      = common_j - hat_C_j x_{j+1}
// Only x crosses rows, at R^2 multiply-adds a row; common_j depends on
// the row alone.  A thread block takes 32 chunk lanes (K9::LANES; 16, 8
// or 4 where shared memory is short) and walks their rows in tiles of
// K9_ROWS = 3 through a ring of K9_SLOTS = 4 tiles in shared memory:
// * warps 1-3 each take one row of a tile: they copy its (hat_C, hat_W0,
//   hat_w) in with cp.async K9_SLOTS - 1 tiles ahead of the chain, and
//   once the copy of tile u + 1 has landed form its common_j in place of
//   hat_w (x_b, each lane's own, loaded once);
// * warp 0 (the chain), one thread per lane, runs x_j down tile u from
//   the ring and stores it.
// One named barrier a tile.  Every sum keeps the order of the
// thread-per-lane kernel it replaces, so x is that kernel's to the bit.
#define K9_ROWS 3        // rows in a tile (a multiple of the 3 stagers)
#define K9_THREADS 128   // warp 0 runs the chain, warps 1-3 stage the rows
#define K9_SLOTS 4       // tiles in the ring

// A thread block's shared memory per lane, lane innermost: K9_SLOTS tiles
// of K9_ROWS rows of (hat_C, hat_W0, hat_w -> common).
template <typename T, int R>
struct K9 {
  static constexpr int IN = 2 * R * R + R;  // one row
  static constexpr int N = K9_SLOTS * K9_ROWS * IN;
  static constexpr int LANES = pp::lanes_for(size_t(N) * sizeof(T));
  static constexpr size_t SMEM = size_t(N) * LANES * sizeof(T);
};

template <typename T, int R>
__global__ void __launch_bounds__(K9_THREADS)
backsub_split_kernel(const T* __restrict__ hc, const T* __restrict__ hw0,
                     const T* __restrict__ hw, const T* __restrict__ hw1_p,
                     const T* __restrict__ xb_p,
                     const T* __restrict__ xbn_p, int s, int C,
                     T* x_out) {
  using K = K9<T, R>;
  constexpr int L = K::LANES;
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * L + lane;
  const bool live = lane < L && c < C;
  T* ring = reinterpret_cast<T*>(cgt_smem) + lane;
  const int ntiles = (s + K9_ROWS - 2) / K9_ROWS;  // s - 1 rows
  // row i of tile v: stack row s-2-(v K9_ROWS + i), in ring slot v % K9_SLOTS
  auto at = [&](int v, int i) {
    return ring + ((v % K9_SLOTS) * K9_ROWS + i) * K::IN * L;
  };
  // step u: the chain runs tile u while warps 1-3 start copying tile
  // u + K9_SLOTS - 1 and form the common terms of tile u + 1; one barrier
  // a step, and one before the first for tile 0
  if (warp == 0) {
    T x[R];
    pp::bar<K9_THREADS>();
#pragma unroll 1
    for (int u = 0; u < ntiles; ++u) {
      if (live) {
#pragma unroll
        for (int i = 0; i < K9_ROWS; ++i) {
          const int t = s - 2 - (u * K9_ROWS + i);
          if (t < 0) break;
          const T* in = at(u, i);
          T m[R][R], tv[R];
          if (t == s - 2) {
            T xbn[R];
            cgt::load_mat<T, R>(hw1_p, 0, C, c, m);
            cgt::load_vec<T, R>(xbn_p, 0, C, c, xbn);
            cgt::mv<T, R>(m, xbn, tv);
          } else {
            pp::park_get<T, R, L>(in, 0, m);
            cgt::mv<T, R>(m, x, tv);
          }
#pragma unroll
          for (int a = 0; a < R; ++a)
            x[a] = in[(2 * R * R + a) * L] - tv[a];
          cgt::store_vec<T, R>(x_out, t, C, c, x);
        }
      }
      pp::bar<K9_THREADS>();
    }
  } else {
    T xb[R];
    if (live) cgt::load_vec<T, R>(xb_p, 0, C, c, xb);
    // copy this warp's rows of tile v (one group, empty past the stack)
    auto stage_tile = [&](int v) {
      for (int i = warp - 1; i < K9_ROWS; i += K9_THREADS / 32 - 1) {
        const int t = s - 2 - (v * K9_ROWS + i);
        if (t < 0) break;
        T* in = at(v, i);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b) {
            const size_t g = cgt::mat_at<R>(t, a, b, C, c);
            if (t != s - 2) pp::stage(in + (a * R + b) * L, hc + g);
            pp::stage(in + (R * R + a * R + b) * L, hw0 + g);
          }
#pragma unroll
        for (int a = 0; a < R; ++a)
          pp::stage(in + (2 * R * R + a) * L,
                    hw + cgt::vec_at<R>(t, a, C, c));
      }
      pp::stage_commit();
    };
    // common_j = hat_w_j - hat_W0_j x_b for this warp's rows of tile v
    auto form_common = [&](int v) {
      for (int i = warp - 1; i < K9_ROWS; i += K9_THREADS / 32 - 1) {
        const int t = s - 2 - (v * K9_ROWS + i);
        if (t < 0) break;
        T* in = at(v, i);
        T m[R][R], tv[R];
        pp::park_get<T, R, L>(in, R * R, m);
        cgt::mv<T, R>(m, xb, tv);
#pragma unroll
        for (int a = 0; a < R; ++a) in[(2 * R * R + a) * L] -= tv[a];
      }
    };
    if (live) {
#pragma unroll 1
      for (int v = 0; v < K9_SLOTS - 1; ++v) stage_tile(v);
      pp::stage_wait<K9_SLOTS - 2>();
      form_common(0);
    }
    pp::bar<K9_THREADS>();
#pragma unroll 1
    for (int u = 0; u < ntiles; ++u) {
      if (live && u + 1 < ntiles) {
        stage_tile(u + K9_SLOTS - 1);
        pp::stage_wait<K9_SLOTS - 2>();
        form_common(u + 1);
      }
      pp::bar<K9_THREADS>();
    }
  }
}

template <typename T, int R>
int launch_collect_split(const T* R_cm, const T* O_cm, const T* y_cm,
                         T jitter, int s, int C, T* acc00, T* accy0, T* w0l,
                         T* wl, T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0,
                         T* hw, T* ld_rows, cudaStream_t stream) {
  using K = pp::Elim<T, R>;
  const cudaError_t err =
      cgt::coop::prepare(collect_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  collect_split_kernel<T, R>
      <<<(C + K::BLOCK_LANES - 1) / K::BLOCK_LANES, K::THREADS, K::SMEM,
         stream>>>(
          R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl,
          mh, ld, hc, hw0, hw, ld_rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_collect(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                   int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                   T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                   T* ld_rows, cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                       \
  return launch_collect_split<T, RR>(R_cm, O_cm, y_cm, jitter, s, C, acc00, \
                                     accy0, w0l, wl, dl, invdl, mh, ld, hc, \
                                     hw0, hw, ld_rows, stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// the thread-per-lane sweep at float64 rank d (7 or 8)
int launch_collect_thread(const double* R_cm, const double* O_cm,
                          const double* y_cm, double jitter, int s, int d,
                          int C, double* acc00, double* accy0, double* w0l,
                          double* wl, double* dl, double* invdl, double* mh,
                          double* ld, double* hc, double* hw0, double* hw,
                          double* ld_rows, cudaStream_t stream) {
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
#define CGT_LAUNCH(RR)                                                     \
  forward_sweep_collect_kernel<double, RR>                                 \
      <<<blocks, CGT_THREADS, 0, stream>>>(R_cm, O_cm, y_cm, jitter, s, C, \
                                           acc00, accy0, w0l, wl, dl,      \
                                           invdl, mh, ld, hc, hw0, hw,     \
                                           ld_rows)
  CGT_THREAD_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

template <typename T, int R>
int launch_backsub_split(const T* hc, const T* hw0, const T* hw,
                         const T* hw1, const T* xb, const T* xbn, int s,
                         int C, T* x, cudaStream_t stream) {
  using K = K9<T, R>;
  const cudaError_t err =
      cgt::coop::prepare(backsub_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  backsub_split_kernel<T, R>
      <<<(C + K::LANES - 1) / K::LANES, K9_THREADS, K::SMEM, stream>>>(
          hc, hw0, hw, hw1, xb, xbn, s, C, x);
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsub(const T* hc, const T* hw0, const T* hw, const T* hw1,
                   const T* xb, const T* xbn, int s, int d, int C, T* x,
                   cudaStream_t stream) {
#define CGT_LAUNCH(RR)                                                 \
  return launch_backsub_split<T, RR>(hc, hw0, hw, hw1, xb, xbn, s, C, x, \
                                     stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// thread blocks of collect_split_kernel<T, R> one SM holds
template <typename T, int R>
int collect_split_blocks() {
  using K = pp::Elim<T, R>;
  if (cgt::coop::prepare(collect_split_kernel<T, R>, K::SMEM) != cudaSuccess)
    return -1;
  return pp::blocks_per_sm(collect_split_kernel<T, R>, K::THREADS, K::SMEM);
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

int cgt_forward_sweep_collect_thread_f64(
    const double* R_cm, const double* O_cm, const double* y_cm,
    double jitter, int s, int d, int C, double* acc00, double* accy0,
    double* w0l, double* wl, double* dl, double* invdl, double* mh,
    double* ld, double* hc, double* hw0, double* hw, double* ld_rows,
    void* stream) {
  return launch_collect_thread(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
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

// dynamic shared bytes per thread block of kernel 8's, kernel 6's and
// kernel 1's split designs (one layout, pipeline.cuh's Elim) at rank r
// (1..8; the second argument 1 for float64)
int cgt_elim_split_smem_bytes(int r, int f64) {
#define CGT_LAUNCH(RR) \
  return int(f64 ? pp::Elim<double, RR>::SMEM : pp::Elim<float, RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// thread blocks an SM of kernel 8's split design at rank r (1..8; the
// second argument 1 for float64)
int cgt_collect_split_blocks_per_sm(int r, int f64) {
#define CGT_LAUNCH(RR)                             \
  return f64 ? collect_split_blocks<double, RR>() \
             : collect_split_blocks<float, RR>()
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of kernel 9's split design at
// rank r (1..8; the second argument 1 for float64)
int cgt_backsub_split_smem_bytes(int r, int f64) {
#define CGT_LAUNCH(RR) \
  return int(f64 ? K9<double, RR>::SMEM : K9<float, RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
