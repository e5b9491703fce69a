// The likelihood's fused sweep and the two kernels of the
// block-tridiagonal solve x = J^{-1} y at block sizes d = 9..15, with d a
// runtime argument, on the chunk-major layout.
//
// Replaces:
//   rt_sweep_kernel    <- cyclic_gps_tpu/ops/pallas_sweep.py:248
//                         forward_sweep_pallas (kernel body _sweep_kernel,
//                         :163) at d = 9..15, where forward_sweep.cu has no
//                         instance (it takes 1..8 and 16)
//   rt_collect_kernel  <- cyclic_gps_tpu/ops/pallas_wide.py:366
//                         forward_sweep_collect_wide_pallas
//                         (kernel body _wide_collect_kernel, :258)
//   rt_backsub_warp_kernel
//                      <- pallas_wide.py:496 backward_substitute_wide_pallas
//                         (_wide_backsub_kernel, :462)
// The last two stand for the plain Pallas kernels they are the wide twins
// of, pallas_sweep.py:400 forward_sweep_collect_pallas and :1006
// backward_substitute_pallas (kernels 8 and 9, solve_sweep.cu at d <= 8),
// at d = 9..15: the same boundary, the same sweep, hats and pivot rule.
//
// The TPU's wide kernels take the wide layout (an 8 x 8 block plus
// row-packed strips), which exists for the TPU's 8-sublane tiles.  It is
// not carried over: on the H100 it would only add relayout passes on the
// host and an unpack / pack per block in the thread.  These kernels read
// and write the chunk-major [s, d, d, C] / [s, d, C] stacks of kernels 1,
// 8 and 9, so the engine's glue (partitioned._forward_state,
// _ld_rows_cm_impl, _hat_sweep, _back_substitute) is the same at every d.
//
// Outputs.  Both sweeps end with the state forward_sweep.cu writes
// (acc00, accy0, W0, w, D, 1/diag D, the lanes' mh and ld partials) and
// write every interior step's pivot log-det 2 log|D_j| (stack row j-1 for
// step j = 1..s-1).  The collecting sweep also writes, per step, hat_C =
// D^{-T} C^T, hat_W0 = D^{-T} W0 and hat_w = D^{-T} w by back
// substitution against D^T.  The back-substitution walks rows s-2 .. 0:
//   x_{s-1} = hat_w - hat_W0 x_b - hat_W1 x_{b,next}
//   x_j     = hat_w - hat_W0 x_b - hat_C x_{j+1}
//
// What bounds them on the H100 (SXM peaks at its 700 W limit: 3.35 TB/s,
// 67 TFLOP/s float32): per row the likelihood's sweep reads 2 d^2 + d
// values and writes one, the collecting sweep reads as much and writes
// 2 d^2 + d + 1, the back-substitution reads 2 d^2 + d and writes d
// (~1.2, ~2.4 and ~1.2 GB at d = 12, N = 1e6, float32: byte bounds of
// ~0.36, ~0.72 and ~0.37 ms).  A sweep row is a dependent chain of ~8-10
// d^3 operations that starts with a Cholesky of the pivot block, with
// C = N/s lanes (7,813 at N = 1e6, s = 128): how fast one lane walks its
// rows bounds them, not the bytes.  Measured at that size on an H100 SXM
// (700 W; chip_smoke.py, PERF.md): the likelihood's sweep 6.6 ms and the
// collecting sweep 8.6 ms (5.5 and 8.4 % of their byte bounds).  The
// back-substitution's row is two d x d matrix-vector products, only the
// second of which waits for the row before: the bytes bound it.
//
// All three run one warp per chunk lane on rtcoop.cuh, and the 8 (float32)
// or 4 (float64) lanes of a thread block load and store their rows as
// whole 32-byte spans.  The sweeps (its Sweep step) hold the lane's blocks
// (the pivot and its factor, O_j and C_{j-1}, W0 and its scratch partner,
// acc; the collecting sweep adds hat_C) and vectors in shared memory and
// spread the Cholesky's trailing updates, the products and the triangular
// solves over the warp (the elimination's two forward solves and w's in
// one pass; the collecting sweep's three hats in one back-substitution
// pass).  The likelihood's sweep is the collecting one without the hats:
// per row it stores one number per lane.  The back-substitution holds two
// copies of a row's inputs, so that the block loads row r-1 while its
// warps compute row r (one barrier a row; each thread fetches its share of
// row r-1 into registers before the products and writes it to shared
// memory after them, so its loads are all in flight at once), and thread
// i of a warp computes element i of x_r: 1.3 ms at that size (28.7 % of
// its byte bound), where a thread-per-lane kernel with its blocks in local
// memory took 9.2 ms.
#include "rtcoop.cuh"

namespace {

using namespace cgt::rt;
namespace co = cgt::coop;

// the sweep's lane region: the elimination's blocks and vectors, then
// hat_C and hat_w
enum { CL_HC = co::SW_BLOCKS, CL_BLOCKS };
enum { CL_HW = co::SW_VECS, CL_VECS };

template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
rt_collect_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                  const T* __restrict__ ym, T jitter, int s, int d, int C,
                  T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl, T* mh,
                  T* ld, T* hc, T* hw0, T* hw, T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int stride = co::region(d, CL_BLOCKS, CL_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C;
  co::Sweep<T> sw(sm + tl * stride, d, CL_BLOCKS);
  const int o_hc = sw.block(CL_HC), o_hw = sw.vec(CL_HW);
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
      // hat_C = D^{-T} C^T, hat_W0 = D^{-T} W0 (into the free X) and
      // hat_w = D^{-T} w in one back-substitution pass
      co::solve_pair<T, false>(
          w, sw.at(sw.p), sw.at(sw.vec(co::SW_INVD)),
          co::Rhs<T>{sw.at(sw.cp), sw.at(o_hc), true, false, false},
          co::Rhs<T>{sw.at(sw.w0), sw.at(sw.x), false, false, false},
          sw.at(sw.wv), sw.at(o_hw));
      if (w.lane == 0) sw.at(o_sc)[0] = T(2) * ldl;
    }
    __syncthreads();
    tile.store_m(hc, j - 1, o_hc);
    tile.store_m(hw0, j - 1, sw.x);
    tile.store_v(hw, j - 1, o_hw);
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

// The likelihood's sweep: rt_collect_kernel without the hats.  Per row
// only the pivot log-det leaves the SM; the final state as
// forward_sweep.cu's.
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
rt_sweep_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                const T* __restrict__ ym, T jitter, int s, int d, int C,
                T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl, T* mh,
                T* ld, T* ld_rows) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int stride = co::region(d, co::SW_BLOCKS, co::SW_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri tri(w);
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

// The back-substitution's lane region: two copies of a row's inputs
// (hat_C, or hat_W1 on row s-2, and hat_W0; hat_w), the one the warp reads
// and the one the next row loads into, then x_b and two copies of x (the
// row the warp writes and the one it reads, x_{j+1}).
enum { BK_HC0, BK_W00, BK_HC1, BK_W01, BK_BLOCKS };
enum { BK_HW0, BK_HW1, BK_XB, BK_X0, BK_X1, BK_VECS };

// rows s-2 .. 0, one barrier a row: after it the block stores x_{r+1}
// and fetches row r-1 into registers, each warp computes its lane's x_r
// (thread i its element i, with the sums of the thread-per-lane design:
// ascending p, the product subtracted from hat_w, then the second from
// that) while those loads are in flight, and the block then writes row
// r-1 into the other copy
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
rt_backsub_warp_kernel(const T* __restrict__ hc, const T* __restrict__ hw0,
                       const T* __restrict__ hw, const T* __restrict__ hw1_p,
                       const T* __restrict__ xb_p,
                       const T* __restrict__ xbn_p, int s, int d, int C,
                       T* x_out) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int stride = co::region(d, BK_BLOCKS, BK_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const int ld = co::pad_ld(d), bs = d * ld, vb = BK_BLOCKS * bs;
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const int i = int(threadIdx.x) & 31;   // the element of x it owns
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C && i < d;
  T* const me = sm + tl * stride;
  const T* const xb = me + vb + BK_XB * d;
  // row s-2: hat_W1 in hat_C's place, x_{b,next} in x_{j+1}'s
  tile.load_m(hw1_p, 0, BK_HC0 * bs);
  tile.load_m(hw0, s - 2, BK_W00 * bs);
  tile.load_v(hw, s - 2, vb + BK_HW0 * d);
  tile.load_v(xb_p, 0, vb + BK_XB * d);
  tile.load_v(xbn_p, 0, vb + BK_X1 * d);
  int k = 0;  // the copy row r reads
  for (int r = s - 2; r >= 0; --r, k ^= 1) {
    __syncthreads();
    if (r < s - 2) tile.store_v(x_out, r + 1, vb + (BK_X0 + (k ^ 1)) * d);
    T nhc[co::TILE_REGS], nw0[co::TILE_REGS], nhw = T(0);
    if (r > 0) {
      tile.fetch_m(hc, r - 1, nhc);
      tile.fetch_m(hw0, r - 1, nw0);
      nhw = tile.fetch_v(hw, r - 1);
    }
    if (live) {
      const T common =
          me[vb + (BK_HW0 + k) * d + i] -
          co::dot_v(me + (BK_W00 + 2 * k) * bs + i * ld, xb, d);
      me[vb + (BK_X0 + k) * d + i] =
          common - co::dot_v(me + (BK_HC0 + 2 * k) * bs + i * ld,
                             me + vb + (BK_X0 + (k ^ 1)) * d, d);
    }
    if (r > 0) {
      tile.put_m(nhc, (BK_HC0 + 2 * (k ^ 1)) * bs);
      tile.put_m(nw0, (BK_W00 + 2 * (k ^ 1)) * bs);
      tile.put_v(nhw, vb + (BK_HW0 + (k ^ 1)) * d);
    }
  }
  __syncthreads();
  tile.store_v(x_out, 0, vb + (BK_X0 + (k ^ 1)) * d);
}

// dynamic shared bytes of one thread block of rt_collect_kernel
template <typename T>
size_t collect_smem(int d) {
  return co::smem_bytes<T>(d, CL_BLOCKS, CL_VECS);
}

// dynamic shared bytes of one thread block of rt_sweep_kernel
template <typename T>
size_t sweep_smem(int d) {
  return co::smem_bytes<T>(d, co::SW_BLOCKS, co::SW_VECS);
}

// dynamic shared bytes of one thread block of rt_backsub_warp_kernel
template <typename T>
size_t backsub_smem(int d) {
  return co::smem_bytes<T>(d, BK_BLOCKS, BK_VECS);
}

template <typename T>
int launch_sweep(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                 int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                 T* dl, T* invdl, T* mh, T* ld, T* ld_rows,
                 cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  const size_t smem = sweep_smem<T>(d);
  const cudaError_t err = co::prepare(rt_sweep_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  rt_sweep_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                       stream>>>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                 accy0, w0l, wl, dl, invdl, mh, ld, ld_rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_collect(const T* R_cm, const T* O_cm, const T* y_cm, T jitter,
                   int s, int d, int C, T* acc00, T* accy0, T* w0l, T* wl,
                   T* dl, T* invdl, T* mh, T* ld, T* hc, T* hw0, T* hw,
                   T* ld_rows, cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  const size_t smem = collect_smem<T>(d);
  const cudaError_t err = co::prepare(rt_collect_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  rt_collect_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                         stream>>>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,
                                   accy0, w0l, wl, dl, invdl, mh, ld, hc,
                                   hw0, hw, ld_rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_backsub(const T* hc, const T* hw0, const T* hw, const T* hw1,
                   const T* xb, const T* xbn, int s, int d, int C, T* x,
                   cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  if (s < 2) return int(cudaSuccess);  // no interior row
  const size_t smem = backsub_smem<T>(d);
  const cudaError_t err = co::prepare(rt_backsub_warp_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  rt_backsub_warp_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS,
                              smem, stream>>>(hc, hw0, hw, hw1, xb, xbn, s,
                                              d, C, x);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_RT_SOLVE(T, SUF)                                                  \
  int cgt_rt_forward_sweep_##SUF(const T* R_cm, const T* O_cm,              \
                                 const T* y_cm, T jitter, int s, int d,      \
                                 int C, T* acc00, T* accy0, T* w0l, T* wl,   \
                                 T* dl, T* invdl, T* mh, T* ld, T* ld_rows,  \
                                 void* stream) {                             \
    return launch_sweep<T>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00, accy0, \
                           w0l, wl, dl, invdl, mh, ld, ld_rows,              \
                           (cudaStream_t)stream);                            \
  }                                                                           \
  int cgt_rt_forward_sweep_collect_##SUF(                                    \
      const T* R_cm, const T* O_cm, const T* y_cm, T jitter, int s, int d,   \
      int C, T* acc00, T* accy0, T* w0l, T* wl, T* dl, T* invdl, T* mh,      \
      T* ld, T* hc, T* hw0, T* hw, T* ld_rows, void* stream) {               \
    return launch_collect<T>(R_cm, O_cm, y_cm, jitter, s, d, C, acc00,       \
                             accy0, w0l, wl, dl, invdl, mh, ld, hc, hw0, hw, \
                             ld_rows, (cudaStream_t)stream);                 \
  }                                                                           \
  int cgt_rt_backward_substitute_##SUF(const T* hc, const T* hw0,            \
                                       const T* hw, const T* hw1,            \
                                       const T* xb, const T* xbn, int s,     \
                                       int d, int C, T* x, void* stream) {   \
    return launch_backsub<T>(hc, hw0, hw, hw1, xb, xbn, s, d, C, x,          \
                             (cudaStream_t)stream);                          \
  }

CGT_RT_SOLVE(float, f32)
CGT_RT_SOLVE(double, f64)
#undef CGT_RT_SOLVE

// dynamic shared bytes per thread block of the likelihood's sweep at
// block size d (the second argument 1 for float64)
int cgt_rt_sweep_smem_bytes(int d, int f64) {
  if (!cgt::rt::rt_size(d)) return -1;
  return int(f64 ? sweep_smem<double>(d) : sweep_smem<float>(d));
}

// dynamic shared bytes per thread block of the collecting sweep
int cgt_rt_collect_smem_bytes(int d, int f64) {
  if (!cgt::rt::rt_size(d)) return -1;
  return int(f64 ? collect_smem<double>(d) : collect_smem<float>(d));
}

// dynamic shared bytes per thread block of the back-substitution
int cgt_rt_backsub_smem_bytes(int d, int f64) {
  if (!cgt::rt::rt_size(d)) return -1;
  return int(f64 ? backsub_smem<double>(d) : backsub_smem<float>(d));
}

}  // extern "C"
