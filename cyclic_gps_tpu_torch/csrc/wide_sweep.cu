// Forward sweep of the partitioned engine on WIDE-layout inputs (block size
// d = 8 + e, e in 1..7), plain and collecting the shared backward stacks.
//
// Replaces (cyclic_gps_tpu/ops/pallas_wide.py):
//   wide_sweep_kernel<T>     <- :166 forward_sweep_wide_pallas
//                               (kernel body _wide_sweep_kernel, :33)
//   wide_solveinv_kernel<T>  <- :998 forward_sweep_solveinv_wide_pallas
//                               (_wide_solveinv_kernel, :884)
//
// Inputs R11 / O11 [s, 8, 8, C], Rst / Ost [s, 3e, 8, C], y [s, d, C]; the
// matrix outputs are wide pairs too (ops/wideblock.py's layout: the 8 x 8
// block, then the strips A21, A12^T and A22, the last zero-padded to 8
// columns; rtcoop.cuh's wide_dense), so the kernels, their
// plain twins (ops/wide_cuda.py) and the JAX package exchange the same
// arrays.  Stacks stay at the true chunk count C: the TPU kernels' padding
// of the chunk axis to their lane tile (and its log-det correction) has no
// counterpart here.
//
// What bounds them on the H100: each walks its lane's s-1 interior rows in
// order, each row a dependent chain of d x d Cholesky, solves and products
// (~15 d^3 operations, ~22 d^3 with the collect), with C = N/s lanes
// (7,813 at N = 1e6, s = 128), far from both the byte bound (each input
// row read once, 2 d^2 + d values) and the operation bound.  The TPU
// kernels' 8-aligned panel algebra exists for its 8-sublane tiles and is
// not carried over: the blocks are unpacked to dense d x d on load (d is a
// runtime value, so one instance per dtype serves e = 1..7) and run the
// elimination of forward_sweep.cu in rtcoop.cuh's cooperative form.
//
// Both run one warp per chunk lane on rtcoop.cuh (its Sweep step): the
// lane's blocks and vectors in shared memory (the elimination's six blocks
// and five vectors; the collecting sweep adds di = D^{-1}, hat_C, pinv and
// hat_w), the Cholesky's trailing updates, the products and the solves
// spread over the warp, and the 8 (float32) or 4 (float64) lanes of a
// thread block unpacking their rows from the wide pairs as whole 32-byte
// spans and packing the emissions back the same way.  They are one loop,
// `wide_rows`: the plain sweep (kernel 16) is the collecting one (21)
// without the hats, as rt_solve.cu's rt_sweep_kernel is rt_collect_kernel
// without them.  On an H100 SXM (700 W; chip_smoke.py, PERF.md) at d = 12,
// N = 1e6 the plain sweep takes 7.6 ms and the collecting one 12.4 ms
// (4.8 and 7.6 % of their byte bounds); the thread-per-lane kernel 16 they
// replaced took 51 ms (its blocks in local memory, 8.4 KB of stack per
// thread at float32).
#include "rtcoop.cuh"

namespace {

namespace co = cgt::coop;
using cgt::rt::WMAX;

// the collecting sweep's lane region: the elimination's blocks and
// vectors, then di, hat_C, pinv and hat_w
enum { SI_DI = co::SW_BLOCKS, SI_HC, SI_PINV, SI_BLOCKS };
enum { SI_HW = co::SW_VECS, SI_VECS };

// the lane region of the plain sweep (HATS = false) or the collecting one
__host__ __device__ __forceinline__ int wide_region(int d, bool hats) {
  return hats ? co::region(d, SI_BLOCKS, SI_VECS)
              : co::region(d, co::SW_BLOCKS, co::SW_VECS);
}

// The sweeps' rows j = 1..s-1 on the wide pairs and their final state;
// HATS also streams each row's hats and pinv (the hat pointers are unused
// without it).
template <typename T, bool HATS>
__device__ __forceinline__ void wide_rows(
    const T* __restrict__ R11, const T* __restrict__ Rst,
    const T* __restrict__ O11, const T* __restrict__ Ost,
    const T* __restrict__ ym, T jitter, int s, int e, int C, T* acc11,
    T* accst, T* accy0, T* w011, T* w0st, T* wl, T* d11, T* dst, T* invd,
    T* mh, T* ld, T* hc11, T* hcst, T* hw011, T* hw0st, T* hw, T* pinv11,
    T* pinvst) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int d = 8 + e;
  const int stride = wide_region(d, HATS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C;
  co::Sweep<T> sw(sm + tl * stride, d, HATS ? SI_BLOCKS : co::SW_BLOCKS);
  const int o_di = sw.block(SI_DI), o_hc = sw.block(SI_HC);
  const int o_pinv = sw.block(SI_PINV), o_hw = sw.vec(SI_HW);
  const int o_sc = sw.vec(co::SW_SC);
  tile.load_w(O11, Ost, 0, sw.w0);  // o_left
  for (int j = 1; j < s; ++j) {
    tile.load_w(R11, Rst, j, sw.p);
    tile.load_w(O11, Ost, j, sw.o);
    tile.load_v(ym, j, sw.y);
    __syncthreads();
    if (live) sw.step(w, tri, j == 1, jitter);
    sw.advance(j == 1);
    if (HATS && live) sw.hats(w, o_di, o_hc, o_pinv, o_hw);
    __syncthreads();
    if (HATS) {
      tile.store_w(hc11, hcst, j - 1, o_hc);
      tile.store_w(hw011, hw0st, j - 1, sw.x);
      tile.store_v(hw, j - 1, o_hw);
      tile.store_w(pinv11, pinvst, j - 1, o_pinv);
    }
  }
  if (live && w.lane == 0) {
    sw.at(o_sc)[0] = sw.mh;
    sw.at(o_sc)[1] = sw.ld;
  }
  __syncthreads();
  tile.store_w(acc11, accst, 0, sw.block(co::SW_ACC));
  tile.store_v(accy0, 0, sw.vec(co::SW_ACCY0));
  tile.store_w(w011, w0st, 0, sw.w0);
  tile.store_v(wl, 0, sw.wv);
  tile.store_w(d11, dst, 0, sw.p);
  tile.store_v(invd, 0, sw.vec(co::SW_INVD));
  tile.store_s(mh, 0, o_sc);
  tile.store_s(ld, 0, o_sc + 1);
}

template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
wide_sweep_kernel(const T* __restrict__ R11, const T* __restrict__ Rst,
                  const T* __restrict__ O11, const T* __restrict__ Ost,
                  const T* __restrict__ ym, T jitter, int s, int e, int C,
                  T* acc11, T* accst, T* accy0, T* w011, T* w0st, T* wl,
                  T* d11, T* dst, T* invd, T* mh, T* ld) {
  wide_rows<T, false>(R11, Rst, O11, Ost, ym, jitter, s, e, C, acc11, accst,
                      accy0, w011, w0st, wl, d11, dst, invd, mh, ld, nullptr,
                      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
wide_solveinv_kernel(const T* __restrict__ R11, const T* __restrict__ Rst,
                     const T* __restrict__ O11, const T* __restrict__ Ost,
                     const T* __restrict__ ym, T jitter, int s, int e, int C,
                     T* acc11, T* accst, T* accy0, T* w011, T* w0st, T* wl,
                     T* d11, T* dst, T* invd, T* mh, T* ld, T* hc11,
                     T* hcst, T* hw011, T* hw0st, T* hw, T* pinv11,
                     T* pinvst) {
  wide_rows<T, true>(R11, Rst, O11, Ost, ym, jitter, s, e, C, acc11, accst,
                     accy0, w011, w0st, wl, d11, dst, invd, mh, ld, hc11,
                     hcst, hw011, hw0st, hw, pinv11, pinvst);
}

// dynamic shared bytes of one thread block of a sweep at block size 8 + e
template <typename T>
size_t wide_smem(int e, bool hats) {
  return size_t(co::Tile<T>::LANES) * wide_region(8 + e, hats) * sizeof(T);
}

template <typename T>
int launch_wide_sweep(const T* R11, const T* Rst, const T* O11, const T* Ost,
                      const T* y, T jitter, int s, int e, int C, T* acc11,
                      T* accst, T* accy0, T* w011, T* w0st, T* wl, T* d11,
                      T* dst, T* invd, T* mh, T* ld, cudaStream_t stream) {
  if (e < 1 || e > WMAX - 8) return int(cudaErrorInvalidValue);
  const size_t smem = wide_smem<T>(e, false);
  const cudaError_t err = co::prepare(wide_sweep_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  wide_sweep_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                         stream>>>(R11, Rst, O11, Ost, y, jitter, s, e, C,
                                   acc11, accst, accy0, w011, w0st, wl, d11,
                                   dst, invd, mh, ld);
  return int(cudaGetLastError());
}

template <typename T>
int launch_wide_solveinv(const T* R11, const T* Rst, const T* O11,
                         const T* Ost, const T* y, T jitter, int s, int e,
                         int C, T* acc11, T* accst, T* accy0, T* w011,
                         T* w0st, T* wl, T* d11, T* dst, T* invd, T* mh,
                         T* ld, T* hc11, T* hcst, T* hw011, T* hw0st, T* hw,
                         T* pinv11, T* pinvst, cudaStream_t stream) {
  if (e < 1 || e > WMAX - 8) return int(cudaErrorInvalidValue);
  const size_t smem = wide_smem<T>(e, true);
  const cudaError_t err = co::prepare(wide_solveinv_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  wide_solveinv_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                            stream>>>(
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
    return launch_wide_sweep<T>(R11, Rst, O11, Ost, y, jitter, s, e, C,      \
                                acc11, accst, accy0, w011, w0st, wl, d11,    \
                                dst, invd, mh, ld, (cudaStream_t)stream);    \
  }                                                                           \
  int cgt_wide_sweep_solveinv_##SUF(                                         \
      const T* R11, const T* Rst, const T* O11, const T* Ost, const T* y,    \
      T jitter, int s, int e, int C, T* acc11, T* accst, T* accy0, T* w011,  \
      T* w0st, T* wl, T* d11, T* dst, T* invd, T* mh, T* ld, T* hc11,        \
      T* hcst, T* hw011, T* hw0st, T* hw, T* pinv11, T* pinvst,              \
      void* stream) {                                                         \
    return launch_wide_solveinv<T>(                                           \
        R11, Rst, O11, Ost, y, jitter, s, e, C, acc11, accst, accy0, w011,  \
        w0st, wl, d11, dst, invd, mh, ld, hc11, hcst, hw011, hw0st, hw,     \
        pinv11, pinvst, (cudaStream_t)stream);                               \
  }

CGT_WIDE_SWEEP(float, f32)
CGT_WIDE_SWEEP(double, f64)
#undef CGT_WIDE_SWEEP

// dynamic shared bytes per thread block of the plain and the collecting
// sweep at block size 8 + e
int cgt_wide_sweep_smem_bytes(int e, int f64) {
  if (e < 1 || e > WMAX - 8) return -1;
  return int(f64 ? wide_smem<double>(e, false) : wide_smem<float>(e, false));
}

int cgt_wide_solveinv_smem_bytes(int e, int f64) {
  if (e < 1 || e > WMAX - 8) return -1;
  return int(f64 ? wide_smem<double>(e, true) : wide_smem<float>(e, true));
}

}  // extern "C"
