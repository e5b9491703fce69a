// Mega-fused celerite likelihood sweep: each chunk interior row's precision
// blocks are built from its gap width in closed form (2 x 2 oscillator
// algebra, celerite.cuh) and eliminated in place -- the posterior-precision
// system K never reaches device memory.
//
// Replaces: cyclic_gps_tpu/ops/celerite_pallas.py:285
// celerite_gap_mahal_sweep_pallas (kernel body _cel_sweep_kernel, :232, row
// terms _cel_row_terms, :183).  It is the celerite twin of
// gap_mahal_sweep_kernel (gap_emission.cu): the same walk, with the Pade
// gap emission replaced by the closed forms.
//
// What bounds it on the H100 (SXM peaks at its 700 W limit: 3.35 TB/s,
// 67 TFLOP/s float32): per row the closed forms cost ~60 flops per
// oscillator, but the elimination works on dense R x R blocks (R = 2
// nblocks): a Cholesky, three triangular solves and four products, ~8 R^3
// flops, against 3 floats of gap input and R of right-hand side, so its
// bound is the operations.  Each chunk lane walks its s - 1 rows in order,
// a dependent chain per row, with C = N/s lanes (7,813 at N = 1e6,
// s = 128): how fast one lane walks bounds it.
//
// Two designs, routed by nblocks in the launcher:
// * nblocks 5..8 (R = 10..16): ONE WARP PER CHUNK LANE on rtcoop.cuh's
//   Sweep (at d = R, with the d = 16 triangle `Tri16`): the lane's blocks
//   in shared memory -- the pivot (K_j, then its factor), the coupling
//   (off, then C_j), C_{j-1}, W0 and its partner, acc -- and the row's
//   closed-form terms beside them as 4 numbers per oscillator (d_left of
//   the previous gap, off, d_right and log|Q1|: every gap term is 2 x 2
//   block-diagonal).  Per row thread k < nblocks runs oscillator k's closed
//   forms, the warp forms K_j = I + d_left + d_right + boost real_j and the
//   dense coupling, and Sweep::step eliminates the row.  boost and the
//   oscillators' blocks of G, the same for every lane, sit once per thread
//   block.  Nothing but the row's inputs (dt, gv, real, y) is read inside
//   the loop, and every lane's row is its own warp's, so the loop has no
//   block-wide barrier; row 0 (k0) and the last coupling (o_last) leave
//   through the tile stores once each.  7.2 KB per lane at R = 16, 8 lanes
//   (59,008 B) per block.  On an H100 SXM (700 W; chip_smoke.py, PERF.md)
//   at N = 1e6 it takes 12.1 ms at nblocks 8 and 7.9 ms at nblocks 6; the
//   thread-per-lane kernel took 51.6 ms at nblocks 8 (~1,500 floats of
//   state per thread in local memory).
// * nblocks 1..4 (R <= 8): ONE THREAD PER CHUNK LANE, the state in
//   registers and local memory (blockmath.cuh's elim_step, fully unrolled
//   at these widths).  There a warp per lane leaves most of its threads
//   idle: at nblocks 2 and 4 it takes 2.4 and 4.7 ms where this kernel
//   takes 0.32-0.34 and 0.94-0.95 ms (the same card, one run), so the
//   launcher switches at 5.
// Both sum lq's oscillators in ascending k and K's terms in one order, and
// both eliminate as blockmath.cuh's elim_step sums, so they agree to
// rounding.
#include "celerite.cuh"
#include "rtcoop.cuh"

namespace {

// Gap terms of one row from its gap width, valid-masked by gv (the
// closed-form twin of gapsmem.cuh's gsm::row_terms):
//   off     = -Q1^{-1} e
//   d_left  = Q1^{-1} - I
//   d_right = e^T Q1^{-1} e = -e^T off   (symmetrised)
// Q1^{-1} by the 2 x 2 adjugate; returns the gap's log|Q1| (times gv).
template <int NB>
__device__ __forceinline__ float cel_row_terms(
    const float (&g)[NB][4], float dt, float gv,
    float (&d_left)[2 * NB][2 * NB], float (&d_right)[2 * NB][2 * NB],
    float (&off)[2 * NB][2 * NB]) {
  constexpr int R = 2 * NB;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      d_left[i][k] = 0.f;
      d_right[i][k] = 0.f;
      off[i][k] = 0.f;
    }
  float lq = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float em[4], q[3];
    cgt::osc_core(g[k], dt, em, q);
    const float e00 = 1.f + em[0], e01 = em[1], e10 = em[2];
    const float e11 = 1.f + em[3];
    const float det = q[0] * q[2] - q[1] * q[1];
    const float inv_det = 1.f / det;
    const float i00 = q[2] * inv_det, i01 = -q[1] * inv_det;
    const float i11 = q[0] * inv_det;
    const float o00 = -(i00 * e00 + i01 * e10) * gv;
    const float o01 = -(i00 * e01 + i01 * e11) * gv;
    const float o10 = -(i01 * e00 + i11 * e10) * gv;
    const float o11 = -(i01 * e01 + i11 * e11) * gv;
    const float dr00 = -(e00 * o00 + e10 * o10);
    const float dr01 = -(e00 * o01 + e10 * o11);
    const float dr10 = -(e01 * o00 + e11 * o10);
    const float dr11 = -(e01 * o01 + e11 * o11);
    const int a = 2 * k, b = 2 * k + 1;
    off[a][a] = o00;
    off[a][b] = o01;
    off[b][a] = o10;
    off[b][b] = o11;
    d_left[a][a] = (i00 - 1.f) * gv;
    d_left[a][b] = i01 * gv;
    d_left[b][a] = i01 * gv;
    d_left[b][b] = (i11 - 1.f) * gv;
    d_right[a][a] = dr00 * gv;
    d_right[a][b] = 0.5f * (dr01 + dr10) * gv;
    d_right[b][a] = d_right[a][b];
    d_right[b][b] = dr11 * gv;
    lq += logf(det);
  }
  return lq * gv;
}

// K row j = I + d_left(gap j-1) + d_right(gap j) + boost * is_real(j)
template <int R>
__device__ __forceinline__ void k_row(const float (&d_left_prev)[R][R],
                                      const float (&d_right)[R][R],
                                      const float (&boost)[R][R], float real,
                                      float (&k)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c)
      k[i][c] = ((i == c) ? 1.f : 0.f) + d_left_prev[i][c] + d_right[i][c] +
                boost[i][c] * real;
}

// Iteration j = -1 builds gap 0 (the chunk-boundary row 0, streamed OUT as
// k0, and the left coupling); iteration j >= 0 builds gap j+1 and
// eliminates row j+1 in place.
template <int NB>
__global__ void __launch_bounds__(CGT_THREADS)
celerite_gap_mahal_sweep_kernel(const float* __restrict__ gb,
                                const float* __restrict__ boost_p,
                                const float* __restrict__ dt,
                                const float* __restrict__ gv,
                                const float* __restrict__ real,
                                const float* __restrict__ wrap,
                                const float* __restrict__ ym, int s, int C,
                                float* acc00, float* accy0, float* w0l,
                                float* wl, float* dl, float* invdl, float* mh,
                                float* ld, float* lq_out, float* k0_out,
                                float* olast_out) {
  constexpr int R = 2 * NB;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g[NB][4];
  cgt::load_osc<NB>(gb, g);
  float boost[R][R], d_left[R][R], o_left[R][R];
  cgt::load_dense<float, R>(boost_p, boost);
  cgt::SweepCarry<float, R> st;
  float lq_sum = 0.f;
  for (int j = -1; j < s - 1; ++j) {
    const size_t ij = size_t(j + 1) * C + c;  // gap j+1
    float dl_n[R][R], dr[R][R], off[R][R], k[R][R];
    lq_sum += cel_row_terms<NB>(g, dt[ij], gv[ij], dl_n, dr, off);
    if (j < 0) {
      float wr[R][R];
      cgt::load_mat<float, R>(wrap, 0, C, c, wr);
      k_row<R>(wr, dr, boost, real[ij], k);
      cgt::store_mat<float, R>(k0_out, 0, C, c, k);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int b = 0; b < R; ++b) o_left[i][b] = off[i][b];
    } else {
      float y_j[R];
      k_row<R>(d_left, dr, boost, real[ij], k);
      cgt::load_vec<float, R>(ym, j + 1, C, c, y_j);
      cgt::elim_step<float, R>(j == 0, k, off, y_j, o_left, st);
      if (j == s - 2) cgt::store_mat<float, R>(olast_out, 0, C, c, off);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b) d_left[i][b] = dl_n[i][b];
  }
  cgt::store_sweep_state<float, R>(st, C, c, acc00, accy0, w0l, wl, dl, invdl,
                                   mh, ld);
  lq_out[c] = lq_sum;
}

namespace co = cgt::coop;
using Tile = co::Tile<float>;

// the launcher takes the warp instance from this nblocks up
constexpr int WARP_NB = 5;

// One lane's region at R = 2 nblocks (offsets in floats): Sweep's blocks
// and vectors, then the row's closed-form terms, 4 numbers per oscillator
// k each: d_left of the previous gap at 4k + (00, 01, 11), off at 4k +
// (00, 01, 10, 11), d_right at 4k + (00, 01, 11) with log|Q1| at 4k + 3.
// After the LANES regions the block's constants: boost [R][R], then the
// oscillators' blocks of G [nblocks][4].
enum { CS_DL = co::SW_VECS, CS_OFF = CS_DL + 2, CS_DR = CS_OFF + 2,
       CS_VECS = CS_DR + 2 };

__host__ __device__ __forceinline__ int cel_region(int nb) {
  return co::region(2 * nb, co::SW_BLOCKS, CS_VECS);
}

// dynamic shared bytes of one thread block of the warp instance
inline size_t cel_smem(int nb) {
  const int r = 2 * nb;
  return (size_t(Tile::LANES) * cel_region(nb) + r * r + 4 * nb) *
         sizeof(float);
}

// Row j's terms from its gap (thread k < nblocks: oscillator k), then K
// into the pivot block and the dense coupling into `ob`; at the first
// (row 0, j = -1) the pivot block holds the chunk-crossing d_left (wrap)
// on entry.  Returns the gap's log|Q1| (times gv) in thread 0.
__device__ __forceinline__ float cel_build(const co::Warp& w,
                                           const co::Sweep<float>& sw,
                                           const float* boost,
                                           const float* gsh, int nb,
                                           float dt, float gv, float real,
                                           bool first, float* ob) {
  float* const dl = sw.at(sw.vec(CS_DL));
  float* const off = sw.at(sw.vec(CS_OFF));
  float* const dr = sw.at(sw.vec(CS_DR));
  float* const K = sw.at(sw.p);
  const int t = w.lane;
  float dl00 = 0.f, dl01 = 0.f, dl11 = 0.f;
  if (t < nb) {  // the closed forms of cel_row_terms, oscillator t
    const float g[4] = {gsh[4 * t], gsh[4 * t + 1], gsh[4 * t + 2],
                        gsh[4 * t + 3]};
    float em[4], q[3];
    cgt::osc_core(g, dt, em, q);
    const float e00 = 1.f + em[0], e01 = em[1], e10 = em[2];
    const float e11 = 1.f + em[3];
    const float det = q[0] * q[2] - q[1] * q[1];
    const float inv_det = 1.f / det;
    const float i00 = q[2] * inv_det, i01 = -q[1] * inv_det;
    const float i11 = q[0] * inv_det;
    const float o00 = -(i00 * e00 + i01 * e10) * gv;
    const float o01 = -(i00 * e01 + i01 * e11) * gv;
    const float o10 = -(i01 * e00 + i11 * e10) * gv;
    const float o11 = -(i01 * e01 + i11 * e11) * gv;
    const float dr00 = -(e00 * o00 + e10 * o10);
    const float dr01 = -(e00 * o01 + e10 * o11);
    const float dr10 = -(e01 * o00 + e11 * o10);
    const float dr11 = -(e01 * o01 + e11 * o11);
    off[4 * t] = o00;
    off[4 * t + 1] = o01;
    off[4 * t + 2] = o10;
    off[4 * t + 3] = o11;
    dr[4 * t] = dr00 * gv;
    dr[4 * t + 1] = 0.5f * (dr01 + dr10) * gv;
    dr[4 * t + 2] = dr11 * gv;
    dr[4 * t + 3] = logf(det);
    dl00 = (i00 - 1.f) * gv;
    dl01 = i01 * gv;
    dl11 = (i11 - 1.f) * gv;
  }
  __syncwarp();
  // K = I + d_left(previous gap) + d_right + boost real, the coupling
  // dense; the 2 x 2 block terms are zero off the diagonal blocks
  const int R = w.d;
  for (co::Cursor c(w.w); c.q < w.dd; c.next(w.w)) {
    const int i = c.i, k = c.k, o = i * w.ld + k, kb = 4 * (i >> 1);
    const bool blk = (i >> 1) == (k >> 1);
    const int e = (i & 1) + (k & 1);  // 00, 01 / 10, 11
    const float left = first ? K[o] : (blk ? dl[kb + e] : 0.f);
    const float right = blk ? dr[kb + e] : 0.f;
    K[o] = (((i == k) ? 1.f : 0.f) + left + right) + boost[i * R + k] * real;
    ob[o] = blk ? off[kb + 2 * (i & 1) + (k & 1)] : 0.f;
  }
  float lq = 0.f;
  if (t == 0) {
    for (int k = 0; k < nb; ++k) lq += dr[4 * k + 3];
    lq *= gv;
  }
  __syncwarp();
  if (t < nb) {  // the next row's d_left, after every thread read this one's
    dl[4 * t] = dl00;
    dl[4 * t + 1] = dl01;
    dl[4 * t + 2] = dl11;
  }
  return lq;
}

// nblocks 5..8 (and any nblocks where the caller forces it): one warp per
// chunk lane.  Iteration j = -1 builds gap 0 (row 0, streamed out as k0,
// and the left coupling into W0); iteration j >= 0 builds gap j+1 and
// eliminates row j+1.
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
celerite_gap_mahal_sweep_warp_kernel(
    const float* __restrict__ gb, const float* __restrict__ boost_p,
    const float* __restrict__ dt, const float* __restrict__ gv,
    const float* __restrict__ real, const float* __restrict__ wrap,
    const float* __restrict__ ym, int nb, int s, int C, float* acc00,
    float* accy0, float* w0l, float* wl, float* dl, float* invdl, float* mh,
    float* ld, float* lq_out, float* k0_out, float* olast_out) {
  extern __shared__ __align__(16) unsigned char cgt_smem[];
  float* sm = reinterpret_cast<float*>(cgt_smem);
  const int R = 2 * nb;
  const int stride = cel_region(nb);
  float* const boost = sm + Tile::LANES * stride;  // then G's blocks
  for (int q = int(threadIdx.x); q < R * R + 4 * nb; q += Tile::THREADS)
    boost[q] = q < R * R ? boost_p[q] : gb[q - R * R];
  const co::Tiles<float> tile(sm, stride, R, C);
  const co::Warp w(R);
  const co::Tri16 tri(w);
  const int tl = int(threadIdx.x) >> 5;  // this warp's lane of the tile
  const int c = int(blockIdx.x) * Tile::LANES + tl;
  const bool live = c < C;
  co::Sweep<float> sw(sm + tl * stride, R, co::SW_BLOCKS);
  const int o_sc = sw.vec(co::SW_SC);
  tile.load_m(wrap, 0, sw.p);  // row 0's d_left: the chunk-crossing gap
  __syncthreads();
  float lq = 0.f;
  for (int j = -1; j < s - 1; ++j) {
    if (live) {
      const size_t ij = size_t(j + 1) * C + c;  // gap j+1
      lq += cel_build(w, sw, boost, boost + R * R, nb, dt[ij], gv[ij],
                      real[ij], j < 0, sw.at(j < 0 ? sw.w0 : sw.o));
      if (j >= 0 && w.lane < R)
        sw.at(sw.y)[w.lane] = ym[(size_t(j + 1) * R + w.lane) * C + c];
      __syncwarp();
    }
    if (j < 0 || j == s - 2) {  // row 0 and the last coupling leave
      __syncthreads();
      if (j < 0)
        tile.store_m(k0_out, 0, sw.p);
      else
        tile.store_m(olast_out, 0, sw.o);
      __syncthreads();
    }
    if (j >= 0) {
      if (live) sw.step(w, tri, j == 0, 0.f);
      sw.advance(j == 0);
    }
  }
  if (live && w.lane == 0) {
    sw.at(o_sc)[0] = sw.mh;
    sw.at(o_sc)[1] = sw.ld;
    sw.at(o_sc)[2] = lq;
  }
  __syncthreads();
  tile.store_m(acc00, 0, sw.block(co::SW_ACC));
  tile.store_v(accy0, 0, sw.vec(co::SW_ACCY0));
  tile.store_m(w0l, 0, sw.w0);
  tile.store_v(wl, 0, sw.wv);
  tile.store_m(dl, 0, sw.p);
  tile.store_v(invdl, 0, sw.vec(co::SW_INVD));
  tile.store_s(mh, 0, o_sc);
  tile.store_s(ld, 0, o_sc + 1);
  tile.store_s(lq_out, 0, o_sc + 2);
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

int launch_warp(const float* gb, const float* boost, const float* dt,
                const float* gv, const float* real, const float* wrap,
                const float* y, int nb, int s, int C, float* acc00,
                float* accy0, float* w0l, float* wl, float* dl, float* invdl,
                float* mh, float* ld, float* lq, float* k0, float* olast,
                cudaStream_t stream) {
  if (nb < 1 || nb > 8) return int(cudaErrorInvalidValue);
  const size_t smem = cel_smem(nb);
  const cudaError_t err =
      co::prepare(celerite_gap_mahal_sweep_warp_kernel, smem);
  if (err != cudaSuccess) return int(err);
  celerite_gap_mahal_sweep_warp_kernel<<<co::grid_for<float>(C),
                                         Tile::THREADS, smem, stream>>>(
      gb, boost, dt, gv, real, wrap, y, nb, s, C, acc00, accy0, w0l, wl, dl,
      invdl, mh, ld, lq, k0, olast);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// nblocks 1..4: one thread per lane; 5..8: one warp per lane
int cgt_celerite_gap_mahal_sweep_f32(
    const float* gb, const float* boost, const float* dt, const float* gv,
    const float* real, const float* wrap, const float* y, int nb, int s,
    int C, float* acc00, float* accy0, float* w0l, float* wl, float* dl,
    float* invdl, float* mh, float* ld, float* lq, float* k0, float* olast,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nb >= WARP_NB)
    return launch_warp(gb, boost, dt, gv, real, wrap, y, nb, s, C, acc00,
                       accy0, w0l, wl, dl, invdl, mh, ld, lq, k0, olast, st);
#define CGT_LAUNCH(NB)                                                      \
  celerite_gap_mahal_sweep_kernel<NB><<<blocks_for(C), CGT_THREADS, 0, st>>>( \
      gb, boost, dt, gv, real, wrap, y, s, C, acc00, accy0, w0l, wl, dl,     \
      invdl, mh, ld, lq, k0, olast)
  switch (nb) {
    case 1: CGT_LAUNCH(1); break;
    case 2: CGT_LAUNCH(2); break;
    case 3: CGT_LAUNCH(3); break;
    case 4: CGT_LAUNCH(4); break;
    default: return int(cudaErrorInvalidValue);
  }
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

// the warp-per-lane instance at any nblocks 1..8 (to time the two designs)
int cgt_celerite_gap_mahal_sweep_warp_f32(
    const float* gb, const float* boost, const float* dt, const float* gv,
    const float* real, const float* wrap, const float* y, int nb, int s,
    int C, float* acc00, float* accy0, float* w0l, float* wl, float* dl,
    float* invdl, float* mh, float* ld, float* lq, float* k0, float* olast,
    void* stream) {
  return launch_warp(gb, boost, dt, gv, real, wrap, y, nb, s, C, acc00,
                     accy0, w0l, wl, dl, invdl, mh, ld, lq, k0, olast,
                     (cudaStream_t)stream);
}

// dynamic shared bytes per thread block of the warp instance at nblocks
int cgt_celerite_sweep_smem_bytes(int nb) {
  if (nb < 1 || nb > 8) return -1;
  return int(cel_smem(nb));
}

}  // extern "C"
