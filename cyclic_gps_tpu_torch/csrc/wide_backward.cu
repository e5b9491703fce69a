// The descending pass of the analytic backward on WIDE-layout stacks (block
// size d = 8 + e, e in 1..7): back-substitution fused with the hat-form
// Takahashi recursion.
//
// Replaces: cyclic_gps_tpu/ops/pallas_wide.py:1199
// backward_solve_takahashi_wide_pallas (kernel body
// _wide_backsolve_takahashi_kernel, :1093), the wide twin of
// backward_sweep.cu's backsolve_split_kernel
// (pallas_sweep.py:918).
//
// Inputs: the stacks of wide_sweep.cu's collect instance (hat_C, hat_W0,
// pinv as wide pairs [s-1, 8, 8, C] / [s-1, 3e, 8, C], hat_w [s-1, d, C]),
// the right coupling's hat hat_W1 as a wide pair, the boundary solution
// x_b and its next-chunk shift [d, C], and the reduced system's
// selected-inverse blocks p00, p01, p10, p11 as wide pairs [8, 8, C] /
// [3e, 8, C].  Outputs: x rows [s-1, d, C], Sigma_jj and Sigma_{j+1,j} as
// wide stacks, and the final u0 / u1 as wide pairs.  Per step:
//   x_j     = hat_w_j - hat_W0_j x_b - hat_C_j x_{j+1}
//   phi_off = -phi_{j+1} hat_C_j^T
//   phi_j   = pinv_j + hat_C_j phi_{j+1} hat_C_j^T
//   u0_j    = hat_W0_j - hat_C_j u0_{j+1},   u1_j = -hat_C_j u1_{j+1}
//   Sigma_jj      = phi_j + u0_j a0_j + u1_j a1_j
//   Sigma_{j+1,j} = phi_off + u0_{j+1} a0_j + u1_{j+1} a1_j
// with (a0, a1) = Sigma_BB U^T; row s-2 seeds phi = pinv, u0 = hat_W0,
// u1 = hat_W1 and carries the W1 term of the solve.
//
// What bounds it on the H100 (SXM peaks at its 700 W limit: 3.35 TB/s,
// 67 TFLOP/s float32): per row it reads 3 d^2 + d values and writes
// 2 d^2 + d (~0.93 ms of bytes at d = 12, N = 1e6, float32), and runs a
// dependent chain of ~26 d^3 operations per row (~0.67 ms of float32 peak
// there); on celerite's boundary chain (C = 245 lanes of 31 rows) the
// bound is microseconds and the walk's latency is all there is.
//
// Design: one warp per chunk lane on rtcoop.cuh.  The lane's 14 blocks
// (the seven carried ones p00..p11, phi, u0, u1, the row's hat_C, hat_W0,
// pinv and four of scratch) and five vectors sit in shared memory; every
// product is spread over the warp, and the thread block's 8 (float32) or
// 4 (float64) lanes unpack their rows from the wide pairs as whole 32-byte
// spans and pack them back the same way, zeroing the A22 strip's padding
// columns.  Only the rows the recursion uses are read (hat_C from row
// s-3 down).
#include "rtcoop.cuh"

namespace {

namespace co = cgt::coop;

// the lane region: 14 blocks and 5 vectors
enum { WB_P00, WB_P01, WB_P10, WB_P11, WB_PHI, WB_U0, WB_U1, WB_HC, WB_HW0,
       WB_PINV, WB_U1N, WB_A0, WB_A1, WB_OF, WB_BLOCKS };
enum { WB_XB, WB_XA, WB_XN, WB_HW, WB_XBN, WB_VECS };

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

template <typename T>
__global__ void __launch_bounds__(co::Tile<T>::THREADS, co::Tile<T>::MIN_BLOCKS)
wide_backward_kernel(
    const T* __restrict__ hc11, const T* __restrict__ hcst,
    const T* __restrict__ hw011, const T* __restrict__ hw0st,
    const T* __restrict__ hw, const T* __restrict__ pinv11,
    const T* __restrict__ pinvst, const T* __restrict__ hw1_11,
    const T* __restrict__ hw1_st, const T* __restrict__ xb_p,
    const T* __restrict__ xbn_p, const T* __restrict__ p00_11,
    const T* __restrict__ p00_st, const T* __restrict__ p01_11,
    const T* __restrict__ p01_st, const T* __restrict__ p10_11,
    const T* __restrict__ p10_st, const T* __restrict__ p11_11,
    const T* __restrict__ p11_st, int s, int e, int C, T* x_out, T* dg11,
    T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst, T* u1f11, T* u1fst) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  T* sm = reinterpret_cast<T*>(cgt_smem);
  const int d = 8 + e;
  const int stride = co::region(d, WB_BLOCKS, WB_VECS);
  const int bs = d * co::pad_ld(d);
  const int vb = WB_BLOCKS * bs;  // the vectors follow the blocks
  const co::Tiles<T> tile(sm, stride, d, C);
  const co::Warp w(d);
  const int wl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const bool live = int(blockIdx.x) * co::Tile<T>::LANES + wl < C;
  T* me = sm + wl * stride;
  T* const p00 = me + WB_P00 * bs;
  T* const p01 = me + WB_P01 * bs;
  T* const p10 = me + WB_P10 * bs;
  T* const p11 = me + WB_P11 * bs;
  T* const hc = me + WB_HC * bs;  // hat_C, then Sigma_jj
  T* const a0 = me + WB_A0 * bs;
  T* const a1 = me + WB_A1 * bs;
  T* const of = me + WB_OF * bs;
  const T* const xb = me + vb + WB_XB * d;
  const T* const hwv = me + vb + WB_HW * d;
  const T* const xbn = me + vb + WB_XBN * d;
  // carried blocks and their partners, swapped at the end of every step
  int o_phi = WB_PHI * bs, o_pinv = WB_PINV * bs;  // phi_{j+1} | pinv -> phi_j
  int o_u0 = WB_U0 * bs, o_hw0 = WB_HW0 * bs;      // u0_{j+1} | hat_W0 -> u0_j
  int o_u1 = WB_U1 * bs, o_u1n = WB_U1N * bs;      // u1_{j+1} | u1_j
  int o_x = vb + WB_XA * d, o_xn = vb + WB_XN * d;  // x_{j+1} | x_j
  tile.load_w(p00_11, p00_st, 0, WB_P00 * bs);
  tile.load_w(p01_11, p01_st, 0, WB_P01 * bs);
  tile.load_w(p10_11, p10_st, 0, WB_P10 * bs);
  tile.load_w(p11_11, p11_st, 0, WB_P11 * bs);
  tile.load_v(xb_p, 0, vb + WB_XB * d);
  for (int r = s - 2; r >= 0; --r) {
    const bool first = r == s - 2;
    if (!first) tile.load_w(hc11, hcst, r, WB_HC * bs);
    tile.load_w(hw011, hw0st, r, o_hw0);
    tile.load_w(pinv11, pinvst, r, o_pinv);
    tile.load_v(hw, r, vb + WB_HW * d);
    if (first) {
      tile.load_w(hw1_11, hw1_st, 0, o_u1n);  // u1_{s-1} = hat_W1
      tile.load_v(xbn_p, 0, vb + WB_XBN * d);
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
    tile.store_w(dg11, dgst, r, WB_HC * bs);
    tile.store_w(of11, ofst, r, WB_OF * bs);
    __syncthreads();  // the next step's load overwrites hat_C's block
  }
  tile.store_w(u0f11, u0fst, 0, o_u0);
  tile.store_w(u1f11, u1fst, 0, o_u1);
}

// dynamic shared bytes of one thread block at block size 8 + e
template <typename T>
size_t wide_backward_smem(int e) {
  return co::smem_bytes<T>(8 + e, WB_BLOCKS, WB_VECS);
}

template <typename T>
int launch_wide_backward(const T* hc11, const T* hcst, const T* hw011,
                         const T* hw0st, const T* hw, const T* pinv11,
                         const T* pinvst, const T* hw1_11, const T* hw1_st,
                         const T* xb, const T* xbn, const T* p00_11,
                         const T* p00_st, const T* p01_11, const T* p01_st,
                         const T* p10_11, const T* p10_st, const T* p11_11,
                         const T* p11_st, int s, int e, int C, T* x, T* dg11,
                         T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst,
                         T* u1f11, T* u1fst, cudaStream_t stream) {
  if (e < 1 || e > cgt::rt::WMAX - 8) return int(cudaErrorInvalidValue);
  const size_t smem = wide_backward_smem<T>(e);
  const cudaError_t err = co::prepare(wide_backward_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  wide_backward_kernel<T><<<co::grid_for<T>(C), co::Tile<T>::THREADS, smem,
                            stream>>>(
      hc11, hcst, hw011, hw0st, hw, pinv11, pinvst, hw1_11, hw1_st, xb, xbn,
      p00_11, p00_st, p01_11, p01_st, p10_11, p10_st, p11_11, p11_st, s, e,
      C, x, dg11, dgst, of11, ofst, u0f11, u0fst, u1f11, u1fst);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CGT_WIDE_BACKWARD(T, SUF)                                             \
  int cgt_wide_backward_##SUF(                                               \
      const T* hc11, const T* hcst, const T* hw011, const T* hw0st,          \
      const T* hw, const T* pinv11, const T* pinvst, const T* hw1_11,        \
      const T* hw1_st, const T* xb, const T* xbn, const T* p00_11,           \
      const T* p00_st, const T* p01_11, const T* p01_st, const T* p10_11,    \
      const T* p10_st, const T* p11_11, const T* p11_st, int s, int e,       \
      int C, T* x, T* dg11, T* dgst, T* of11, T* ofst, T* u0f11, T* u0fst,   \
      T* u1f11, T* u1fst, void* stream) {                                     \
    return launch_wide_backward<T>(                                           \
        hc11, hcst, hw011, hw0st, hw, pinv11, pinvst, hw1_11, hw1_st, xb,    \
        xbn, p00_11, p00_st, p01_11, p01_st, p10_11, p10_st, p11_11, p11_st, \
        s, e, C, x, dg11, dgst, of11, ofst, u0f11, u0fst, u1f11, u1fst,      \
        (cudaStream_t)stream);                                                \
  }

CGT_WIDE_BACKWARD(float, f32)
CGT_WIDE_BACKWARD(double, f64)
#undef CGT_WIDE_BACKWARD

// dynamic shared bytes per thread block at block size 8 + e
int cgt_wide_backward_smem_bytes(int e, int f64) {
  if (e < 1 || e > cgt::rt::WMAX - 8) return -1;
  return int(f64 ? wide_backward_smem<double>(e) : wide_backward_smem<float>(e));
}

}  // extern "C"
