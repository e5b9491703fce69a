// The two kernels of the selected inversion (the diagonal and lag-1 blocks
// of J^{-1}) at block sizes d = 9..15, with d a runtime argument, on the
// chunk-major layout.
//
// Replaces (cyclic_gps_tpu/ops/pallas_wide.py):
//   rt_inverse_sweep_kernel <- :641 forward_sweep_inverse_wide_pallas
//                              (kernel body _wide_inverse_collect_kernel,
//                              :558)
//   rt_takahashi_kernel     <- :812 takahashi_backward_wide_pallas
//                              (_wide_takahashi_kernel, :717)
// and stands for the plain Pallas kernels they are the wide twins of,
// pallas_sweep.py:534 forward_sweep_inverse_pallas and :648
// takahashi_backward_pallas (kernels 10 and 11, inverse_sweep.cu at
// d <= 8), at d = 9..15: the same boundary, the same raw factors and
// recursion, the same pivot rule.
//
// The TPU kernels take the wide layout (an 8 x 8 block plus row-packed
// strips), which exists for the TPU's 8-sublane tiles.  It is not carried
// over: on the H100 it would only add relayout passes on the host and an
// unpack / pack per block.  These kernels read and write the chunk-major
// [s, d, d, C] stacks of kernels 10 and 11, so the engine's glue
// (partitioned._inverse_from_cm) is the same at every d.
//
// The sweep writes, for every interior step j = 1..s-1 (stack row j-1),
// D_j, 1/diag(D_j), C_j = O_j D_j^{-T} and W0_j, and the final acc00, W0,
// D, 1/diag D.  The recursion walks rows s-3 .. 0 (steps s-2 .. 1) from
// the step s-1 seeds (phi, u0, u1):
//   di = D^{-1},  cd = C di,  phi_off = -phi_{j+1} cd
//   phi_j = di^T di + cd^T phi_{j+1} cd
//   u0_j = D^{-T} (W0_j - C^T u0_{j+1}),  u1_j = -D^{-T} C^T u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
// with (a0, a1) = Sigma_BB U^T.
//
// What bounds them on the H100 (SXM peaks at its 700 W limit: 3.35 TB/s,
// 67 TFLOP/s float32): per row the sweep reads 2 d^2 values and writes
// 3 d^2 + d, the recursion reads 3 d^2 + d and writes 2 d^2 (~2.9 GB each
// at d = 12, N = 1e6, float32: byte bounds of ~0.87 ms), and a recursion
// row is a dependent chain of ~33 d^3 operations (~0.85 ms of float32
// peak at that size; the bound at d = 15).  So both are bound by
// how fast one lane can walk its rows, not by bytes.  Measured at d = 12,
// N = 1e6 on an H100 SXM (700 W; chip_smoke.py, PERF.md): the sweep
// 6.7 ms and the recursion 14.3 ms, 13.1 and 6.1 % of their byte bounds.
//
// Both run one warp per chunk lane on rtcoop.cuh, the lane's blocks in
// shared memory, every product spread over the warp, and the 8 (float32)
// or 4 (float64) lanes of a thread block loading and storing their rows as
// whole 32-byte spans.  The sweep is rtcoop.cuh's Sweep step without its
// right-hand side (6 blocks and 5 vectors per lane; the cooperative
// Cholesky, the two forward solves of W0 and O_j^T in one pass) and
// stores the four factors of every row.  The recursion holds 14 blocks per
// lane; its seven carried blocks (p00..p11, phi, u0, u1) never leave the
// SM, and 16-24 warps per SM at float32 (8-12 at float64), not ~2, hide
// the latency of the dependent chain.
#include "rtcoop.cuh"

namespace {

using namespace cgt::rt;

namespace co = cgt::coop;

// The sweep: rtcoop.cuh's Sweep step without its right-hand side, storing
// every row's raw factors.  Each thread stores and reloads the same
// elements of its lane's pivot block (the tile mapping of load_m and
// store_m), so D_j leaves the block before R_{j+1} lands in it without a
// barrier between.
template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
rt_inverse_sweep_kernel(const T* __restrict__ Rm, const T* __restrict__ Om,
                        T jitter, int s, int d, int C, T* acc00, T* w0l,
                        T* dl, T* invdl, T* ds, T* invds, T* cs, T* w0s) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int stride = co::region(d, co::SW_BLOCKS, co::SW_VECS);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const co::Tri tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + tl < C;
  co::Sweep<T> sw(sm + tl * stride, d, co::SW_BLOCKS);
  const int o_invd = sw.vec(co::SW_INVD);
  tile.load_m(Om, 0, sw.w0);  // o_left
  for (int j = 1; j < s; ++j) {
    tile.load_m(Rm, j, sw.p);
    tile.load_m(Om, j, sw.o);
    __syncthreads();
    if (live) sw.template step<false>(w, tri, j == 1, jitter);
    sw.advance(j == 1);
    __syncthreads();
    tile.store_m(ds, j - 1, sw.p);
    tile.store_v(invds, j - 1, o_invd);
    tile.store_m(cs, j - 1, sw.cp);
    tile.store_m(w0s, j - 1, sw.w0);
  }
  tile.store_m(acc00, 0, sw.block(co::SW_ACC));
  tile.store_m(w0l, 0, sw.w0);
  tile.store_m(dl, 0, sw.p);
  tile.store_v(invdl, 0, o_invd);
}


// the recursion's lane region: 14 blocks and 1/diag D
enum { TK_P00, TK_P01, TK_P10, TK_P11, TK_PHI, TK_U0, TK_U1, TK_D, TK_CM,
       TK_W0, TK_X1, TK_X2, TK_X3, TK_X4, TK_BLOCKS };
constexpr int TK_VECS = 1;

template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
rt_takahashi_kernel(const T* __restrict__ ds, const T* __restrict__ invds,
                    const T* __restrict__ cs, const T* __restrict__ w0s,
                    const T* __restrict__ p00_p, const T* __restrict__ p01_p,
                    const T* __restrict__ p10_p, const T* __restrict__ p11_p,
                    const T* __restrict__ phi_p, const T* __restrict__ u0_p,
                    const T* __restrict__ u1_p, int s, int d, int C,
                    T* diag_out, T* off_out, T* u0f, T* u1f) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int stride = co::region(d, TK_BLOCKS, TK_VECS);
  const int bs = d * co::pad_ld(d);
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const int wl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + wl < C;
  T* me = sm + wl * stride;
  // fixed blocks, then the carried ones and their scratch partners, whose
  // offsets swap at the end of every step
  T* const p00 = me + TK_P00 * bs;
  T* const p01 = me + TK_P01 * bs;
  T* const p10 = me + TK_P10 * bs;
  T* const p11 = me + TK_P11 * bs;
  T* const D = me + TK_D * bs;
  T* const cm = me + TK_CM * bs;
  T* const x2 = me + TK_X2 * bs;
  T* const x4 = me + TK_X4 * bs;
  const T* const invd = me + TK_BLOCKS * bs;
  int o_phi = TK_PHI * bs, o_x3 = TK_X3 * bs;  // phi_{j+1} | phi_j
  int o_u0 = TK_U0 * bs, o_w0 = TK_W0 * bs;    // u0_{j+1} | W0_j -> u0_j
  int o_u1 = TK_U1 * bs, o_x1 = TK_X1 * bs;    // u1_{j+1} | scratch -> u1_j
  tile.load_m(p00_p, 0, TK_P00 * bs);
  tile.load_m(p01_p, 0, TK_P01 * bs);
  tile.load_m(p10_p, 0, TK_P10 * bs);
  tile.load_m(p11_p, 0, TK_P11 * bs);
  tile.load_m(phi_p, 0, o_phi);
  tile.load_m(u0_p, 0, o_u0);
  tile.load_m(u1_p, 0, o_u1);
  for (int r = s - 3; r >= 0; --r) {
    tile.load_m(ds, r, TK_D * bs);
    tile.load_v(invds, r, TK_BLOCKS * bs);
    tile.load_m(cs, r, TK_CM * bs);
    tile.load_m(w0s, r, o_w0);
    __syncthreads();
    if (live) {
      T* const phi = me + o_phi;
      T* const u0 = me + o_u0;
      T* const u1 = me + o_u1;
      T* const w0 = me + o_w0;
      T* const x1 = me + o_x1;
      T* const x3 = me + o_x3;
      co::solve_lower<T>(w, D, invd, x1);  // x1 = di = D^{-1}
      __syncwarp();
      co::mm<T>(w, cm, x1, x2);            // x2 = cd = C di
      co::mm_ta<T>(w, x1, x1, x3);         // x3 = di^T di
      __syncwarp();
      co::mm_ta<T>(w, x2, phi, x1);        // x1 = cd^T phi
      co::mm_op<T, false, false, co::NEG>(w, phi, x2, x4);  // x4 = phi_off
      __syncwarp();
      co::mm_add<T>(w, x1, x2, x3);        // x3 = phi_j
      co::mm_op<T, true, false, co::SUB>(w, cm, u0, w0);  // W0 - C^T u0
      __syncwarp();
      co::mm_ta<T>(w, cm, u1, x1);         // x1 = C^T u1
      __syncwarp();
      // w0 = u0_j = D^{-T} w0, x1 = u1_j = -D^{-T} x1
      co::solve_pair<T, false>(w, D, invd,
                               co::Rhs<T>{w0, w0, false, false, false},
                               co::Rhs<T>{x1, x1, false, false, true});
      __syncwarp();
      // a0 into D, a1 into cm (the factors are spent)
      co::sig_ut<T>(w, p00, p01, p10, p11, w0, x1, D, cm);
      __syncwarp();
      co::mm2_add<T>(w, x3, w0, D, x1, cm, x2);  // x2 = Sigma_jj
      co::mm2_add<T>(w, x4, u0, D, u1, cm, x4);  // x4 = Sigma_{j+1,j}
    }
    // phi_j, u0_j, u1_j carry to the next step
    const int t_phi = o_phi, t_u0 = o_u0, t_u1 = o_u1;
    o_phi = o_x3;
    o_x3 = t_phi;
    o_u0 = o_w0;
    o_w0 = t_u0;
    o_u1 = o_x1;
    o_x1 = t_u1;
    __syncthreads();
    tile.store_m(diag_out, r, TK_X2 * bs);
    tile.store_m(off_out, r, TK_X4 * bs);
  }
  tile.store_m(u0f, 0, o_u0);
  tile.store_m(u1f, 0, o_u1);
}

// dynamic shared bytes of one thread block of rt_inverse_sweep_kernel
template <typename T>
size_t inverse_sweep_smem(int d) {
  return co::smem_bytes<T>(d, co::SW_BLOCKS, co::SW_VECS);
}

template <typename T>
int launch_inverse_sweep(const T* R_cm, const T* O_cm, T jitter, int s, int d,
                         int C, T* acc00, T* w0l, T* dl, T* invdl, T* ds,
                         T* invds, T* cs, T* w0s, cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  const size_t smem = inverse_sweep_smem<T>(d);
  const cudaError_t err = co::prepare(rt_inverse_sweep_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  rt_inverse_sweep_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS,
                               smem, stream>>>(R_cm, O_cm, jitter, s, d, C,
                                               acc00, w0l, dl, invdl, ds,
                                               invds, cs, w0s);
  return int(cudaGetLastError());
}

// dynamic shared bytes of one thread block of rt_takahashi_kernel
template <typename T>
size_t takahashi_smem(int d) {
  return co::smem_bytes<T>(d, TK_BLOCKS, TK_VECS);
}

template <typename T>
int launch_takahashi(const T* ds, const T* invds, const T* cs, const T* w0s,
                     const T* p00, const T* p01, const T* p10, const T* p11,
                     const T* phi, const T* u0, const T* u1, int s, int d,
                     int C, T* diag, T* off, T* u0f, T* u1f,
                     cudaStream_t stream) {
  if (!rt_size(d)) return int(cudaErrorInvalidValue);
  const size_t smem = takahashi_smem<T>(d);
  const cudaError_t err = co::prepare(rt_takahashi_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  rt_takahashi_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                           stream>>>(ds, invds, cs, w0s, p00, p01, p10, p11,
                                     phi, u0, u1, s, d, C, diag, off, u0f,
                                     u1f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_RT_INVERSE(T, SUF)                                                \
  int cgt_rt_forward_sweep_inverse_##SUF(                                    \
      const T* R_cm, const T* O_cm, T jitter, int s, int d, int C,           \
      T* acc00, T* w0l, T* dl, T* invdl, T* ds, T* invds, T* cs, T* w0s,     \
      void* stream) {                                                         \
    return launch_inverse_sweep<T>(R_cm, O_cm, jitter, s, d, C, acc00, w0l,  \
                                   dl, invdl, ds, invds, cs, w0s,            \
                                   (cudaStream_t)stream);                    \
  }                                                                           \
  int cgt_rt_takahashi_backward_##SUF(                                       \
      const T* ds, const T* invds, const T* cs, const T* w0s, const T* p00,  \
      const T* p01, const T* p10, const T* p11, const T* phi, const T* u0,   \
      const T* u1, int s, int d, int C, T* diag, T* off, T* u0f, T* u1f,     \
      void* stream) {                                                         \
    return launch_takahashi<T>(ds, invds, cs, w0s, p00, p01, p10, p11, phi,  \
                               u0, u1, s, d, C, diag, off, u0f, u1f,         \
                               (cudaStream_t)stream);                        \
  }

CGT_RT_INVERSE(float, f32)
CGT_RT_INVERSE(double, f64)
#undef CGT_RT_INVERSE

// dynamic shared bytes per thread block of the sweep at block size d (the
// second argument 1 for float64)
int cgt_rt_inverse_sweep_smem_bytes(int d, int f64) {
  if (!cgt::rt::rt_size(d)) return -1;
  return int(f64 ? inverse_sweep_smem<double>(d)
                 : inverse_sweep_smem<float>(d));
}

// dynamic shared bytes per thread block of the recursion at block size d
int cgt_rt_takahashi_smem_bytes(int d, int f64) {
  if (!cgt::rt::rt_size(d)) return -1;
  return int(f64 ? takahashi_smem<double>(d) : takahashi_smem<float>(d));
}

}  // extern "C"
