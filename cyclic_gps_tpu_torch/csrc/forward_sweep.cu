// Forward sweep of the partitioned block-Thomas engine: eliminates every
// chunk interior of a chunk-major SPD block-tridiagonal system and keeps
// nothing but each chunk's final state.
//
// Replaces: cyclic_gps_tpu/ops/pallas_sweep.py:248 forward_sweep_pallas
// (kernel body _sweep_kernel, pallas_sweep.py:163).
//
// What bounds it on the H100: each chunk lane c walks its s-1 interior rows
// in order, a dependent chain of an R x R Cholesky, triangular solves and
// products per row, over C = N/s lanes (7,813 at N = 1e6, s = 128).  It
// reads R_cm, O_cm, y_cm once (2 R^2 + R floats per row) and writes O(R^2)
// floats per lane, so its bound is those bytes, but the chain's latency
// sets its time.
//
// Designs, routed by block size in the launcher:
// * R = 1..8: THE CHAIN SPLIT FROM THE REST (sweep_split_kernel, on
//   pipeline.cuh's elim_split, the sweep of kernels 6 and 8 with an emit
//   that stores nothing): lane groups of 32 lanes, two a block at rank 5
//   float32 (123 blocks at N = 1e6 against the ~61 of one thread per
//   lane), in each one warp running the elimination's carried part while
//   three warps copy the rows in ahead of it with cp.async and form each
//   row's log-det and its terms of the sums.  Every sum keeps elim_step's
//   order, so the outputs are the thread-per-lane kernel's to the bit.
//   Where the split design loses (float64 rank 8 falls into local
//   memory: ops/_build.py's ELIM_THREAD), the wrapper takes the
//   thread-per-lane kernel (forward_sweep_kernel, kept at float64 ranks
//   7-8 only, cgt_forward_sweep_thread_f64): the carried state in
//   registers, each input row read once, coalesced over the lane axis.
// * R = 16 (the celerite family's boundary chain at nblocks = 8: C = 245
//   lanes of s = 32 at N = 1e6, then 8): ONE WARP PER CHUNK LANE on
//   rtcoop.cuh.  Held per thread, the rank-16 state lives in local memory
//   and 245 threads fill two of the card's 132 SMs, so each row ran from
//   memory at one thread's pace.  Here the row is Sweep::step on the d = 16
//   triangle Tri16 (rt_solve.cu's rt_sweep_kernel, which runs block sizes
//   9-15, at d = 16; kernel 6's warp instance without its hats): the lane's
//   blocks sit in shared memory, its 32 threads share every product, the
//   Cholesky's trailing updates and the triangular solves, and the 8
//   (float32) or 4 (float64) lanes of a thread block load their rows as
//   whole 32-byte spans.  It sums as the thread kernel did, so the two
//   designs agree to rounding.  (A copy, not rt_sweep_kernel templated on
//   its triangle, so that kernel's register allocation at 9-15 stays as
//   it is.)
#include "blockmath.cuh"
#include "pipeline.cuh"
#include "rtcoop.cuh"

namespace {

namespace pp = cgt::pipe;

// Kernel 1 at ranks 1-8: pipeline.cuh's split sweep with no per-row
// outputs but ld_rows.
template <typename T, int R>
__global__ void __launch_bounds__(pp::Elim<T, R>::THREADS)
sweep_split_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                   const T* __restrict__ ym, T jitter, int s, int C,
                   T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                   T* mh, T* ld, T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  pp::elim_split<T, R>(reinterpret_cast<T*>(cgt_smem), Rm, Om, ym, jitter,
                       s, C, acc00, accy0, w0l, wl, dl, invdl, mh, ld,
                       ld_rows, pp::ElimNoEmit{});
}

// The thread-per-lane design (float64 ranks 7-8 only).
template <typename T, int R>
__global__ void __launch_bounds__(CGT_THREADS)
forward_sweep_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                     const T* __restrict__ ym, T jitter, int s, int C,
                     T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl,
                     T* mh, T* ld, T* ld_rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  cgt::SweepCarry<T, R> st;
  T o_left[R][R];
  cgt::load_mat<T, R>(Om, 0, C, c, o_left);
  for (int j = 1; j < s; ++j) {
    T P[R][R], o_j[R][R], y_j[R];
    cgt::load_mat<T, R>(Rm, j, C, c, P);
#pragma unroll
    for (int i = 0; i < R; ++i) P[i][i] += jitter;
    cgt::load_mat<T, R>(Om, j, C, c, o_j);
    cgt::load_vec<T, R>(ym, j, C, c, y_j);
    const T ldl = cgt::elim_step<T, R>(j == 1, P, o_j, y_j, o_left, st);
    ld_rows[size_t(j - 1) * C + c] = T(2) * ldl;
  }
  cgt::store_sweep_state<T, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                               mh, ld);
}

namespace co = cgt::coop;

// the block size of the warp-per-lane instance
constexpr int WARP_D = 16;

// forward_sweep_kernel<T, 16> as one warp per chunk lane: per row
// Sweep::step on Tri16; per row only the pivot log-det leaves the SM, and
// the final state as the thread kernel's.
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
forward_sweep_warp_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                          const T* __restrict__ ym, T jitter, int s, int C,
                          T* acc00, T* accy0, T* w0l, T* wl, T* dl,
                          T* invdl, T* mh, T* ld, T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int d = WARP_D;
  const int stride = co::region(d, co::SW_BLOCKS, co::SW_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri16 tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C;
  co::Sweep<T> sw(sm + tl * stride, d, co::SW_BLOCKS);
  const int o_sc = sw.vec(co::SW_SC);
  tile.load_m(Om, 0, sw.w0);  // o_left
  for (int j = 1; j < s; ++j) {
    tile.load_m(Rm, j, sw.p);
    tile.load_m(Om, j, sw.o);
    tile.load_v(ym, j, sw.y);
    __syncthreads();
    if (live) {
      const T ldl = sw.step(w, tri, j == 1, jitter);
      if (w.lane == 0) sw.at(o_sc)[0] = T(2) * ldl;
    }
    sw.advance(j == 1);
    __syncthreads();
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

// dynamic shared bytes of one thread block of the warp-per-lane instance
template <typename T>
size_t warp_smem() {
  return co::smem_bytes<T>(WARP_D, co::SW_BLOCKS, co::SW_VECS);
}

template <typename T, int R>
int launch_sweep_split(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                       int s, int C, T* acc00, T* accy0, T* w0l, T* wl,
                       T* dl, T* invdl, T* mh, T* ld, T* ld_rows,
                       cudaStream_t stream) {
  using K = pp::Elim<T, R>;
  const cudaError_t err = co::prepare(sweep_split_kernel<T, R>, K::SMEM);
  if (err != cudaSuccess) return int(err);
  sweep_split_kernel<T, R>
      <<<(C + K::BLOCK_LANES - 1) / K::BLOCK_LANES, K::THREADS, K::SMEM,
         stream>>>(R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl,
                   dl, invdl, mh, ld, ld_rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_forward_sweep(const T* R_cm, const T* O_cm, const T* y_cm,
                         T jitter, int s, int d, int C, T* acc00, T* accy0,
                         T* w0l, T* wl, T* dl, T* invdl, T* mh, T* ld,
                         T* ld_rows, cudaStream_t stream) {
  if (d == WARP_D) {
    const size_t smem = warp_smem<T>();
    const cudaError_t err = co::prepare(forward_sweep_warp_kernel<T>, smem);
    if (err != cudaSuccess) return int(err);
    forward_sweep_warp_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS,
                                   smem, stream>>>(
        R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, mh,
        ld, ld_rows);
    return int(cudaGetLastError());
  }
#define CGT_LAUNCH(RR)                                                    \
  return launch_sweep_split<T, RR>(R_cm, O_cm, y_cm, jitter, s, C, acc00, \
                                   accy0, w0l, wl, dl, invdl, mh, ld,     \
                                   ld_rows, stream)
  CGT_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// the thread-per-lane kernel at float64 rank d (7 or 8)
int launch_forward_sweep_thread(const double* R_cm, const double* O_cm,
                                const double* y_cm, double jitter, int s,
                                int d, int C, double* acc00, double* accy0,
                                double* w0l, double* wl, double* dl,
                                double* invdl, double* mh, double* ld,
                                double* ld_rows, cudaStream_t stream) {
  const int blocks = (C + CGT_THREADS - 1) / CGT_THREADS;
#define CGT_LAUNCH(RR)                                                      \
  forward_sweep_kernel<double, RR><<<blocks, CGT_THREADS, 0, stream>>>(     \
      R_cm, O_cm, y_cm, jitter, s, C, acc00, accy0, w0l, wl, dl, invdl, mh, \
      ld, ld_rows)
  CGT_THREAD_RANK_SWITCH(d, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

// thread blocks of sweep_split_kernel<T, R> one SM holds
template <typename T, int R>
int sweep_split_blocks() {
  using K = pp::Elim<T, R>;
  if (co::prepare(sweep_split_kernel<T, R>, K::SMEM) != cudaSuccess)
    return -1;
  return pp::blocks_per_sm(sweep_split_kernel<T, R>, K::THREADS, K::SMEM);
}

}  // namespace

extern "C" {

int cgt_forward_sweep_f32(const float* R_cm, const float* O_cm,
                          const float* y_cm, float jitter, int s, int d,
                          int C, float* acc00, float* accy0, float* w0l,
                          float* wl, float* dl, float* invdl, float* mh,
                          float* ld, float* ld_rows, void* stream) {
  return launch_forward_sweep<float>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                     accy0, w0l, wl, dl, invdl, mh, ld,
                                     ld_rows, (cudaStream_t)stream);
}

int cgt_forward_sweep_f64(const double* R_cm, const double* O_cm,
                          const double* y_cm, double jitter, int s, int d,
                          int C, double* acc00, double* accy0, double* w0l,
                          double* wl, double* dl, double* invdl, double* mh,
                          double* ld, double* ld_rows, void* stream) {
  return launch_forward_sweep<double>(R_cm, O_cm, y_cm, jitter, s, d, C,
                                      acc00, accy0, w0l, wl, dl, invdl, mh,
                                      ld, ld_rows, (cudaStream_t)stream);
}

int cgt_forward_sweep_thread_f64(const double* R_cm, const double* O_cm,
                                 const double* y_cm, double jitter, int s,
                                 int d, int C, double* acc00, double* accy0,
                                 double* w0l, double* wl, double* dl,
                                 double* invdl, double* mh, double* ld,
                                 double* ld_rows, void* stream) {
  return launch_forward_sweep_thread(R_cm, O_cm, y_cm, jitter, s, d, C,
                                     acc00, accy0, w0l, wl, dl, invdl, mh,
                                     ld, ld_rows, (cudaStream_t)stream);
}

// dynamic shared bytes per thread block of the warp-per-lane instance at
// block size d (16 only; the second argument 1 for float64)
int cgt_forward_sweep_warp_smem_bytes(int d, int f64) {
  if (d != WARP_D) return -1;
  return int(f64 ? warp_smem<double>() : warp_smem<float>());
}

// thread blocks an SM of kernel 1's split design at rank r (1..8; the
// second argument 1 for float64; its shared bytes: solve_sweep.cu's
// cgt_elim_split_smem_bytes)
int cgt_sweep_split_blocks_per_sm(int r, int f64) {
#define CGT_LAUNCH(RR) \
  return f64 ? sweep_split_blocks<double, RR>() : sweep_split_blocks<float, RR>()
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
