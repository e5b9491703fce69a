// LEG gap emission kernels: gap widths -> the PEG transition and noise
// blocks, the chunk-major posterior-precision (K) system, and the K system
// fused into its forward elimination.  All three share one body of math:
// structured Pade-7 (e, Q1), the Cholesky of Q1 with the push-through
// precision terms (gapsmem.cuh: the emission with the generator in shared
// memory), and (kernel 4) one elimination step.
//
// Replaces (cyclic_gps_tpu/ops/expm_pallas.py):
//   transition_and_noise_thread_kernel, transition_and_noise_rows_kernel
//                                <- :297 transition_and_noise_pallas
//                                   (kernel body _tn_kernel, :279)
//   k_system_tiled_kernel        <- :530 k_system_pallas (_ksys_kernel, :482)
//   gap_mahal_sweep_kernel       <- :769 gap_mahal_sweep_pallas
//                                   (_gap_sweep_kernel, :708)
//
// What bounds them on the H100: arithmetic per byte is high (a rank-5 gap
// costs ~25 small matrix products, two LU solves and a Cholesky, against 4
// bytes of input), so kernels 3 and 4 are not bandwidth-bound.  Kernel 2
// writes e and Q, 2 R^2 floats a gap against ~17 R^3 operations, so it sits
// near both of the card's limits (at rank 5 its bytes need ~90 % of the
// time its operations do).  Every gap is built where it is used, so device
// memory sees only dt (and v) in and the outputs out; the lane axis is
// innermost so loads and stores coalesce; the squaring loop runs each
// lane's own count.
//
// Kernel 2 has two designs, picked by the gap count M (expm_cuda.py's
// TN_ROWS_MAX_M).  At large M, one thread per gap
// (transition_and_noise_thread_kernel): the generator and its norms once
// per block in shared memory (gapsmem.cuh's GenS) and the emission from
// gapsmem.cuh's inlined helpers, the code kernels 3-5 run, so no stack
// frame and three blocks an SM at rank 5.  At small M (the chunk-crossing
// gaps, M = C = 7,813 at N = 1e6) one thread a gap leaves most of the
// card's warp schedulers idle and the time is one thread's chain of ~33 R^3
// operations.  There R lanes can build a gap, a row each
// (transition_and_noise_rows_kernel), which cuts the chain to ~R^2 a
// product but costs ~2.3x the thread design's issue slots a gap (R^2
// shuffles a lane a product): on the H100 at rank 5 it is the faster up to
// 4,096 gaps, a tie at M = C = 7,813 and the slower from 12,000 on.  One
// warp a gap, an entry a lane, its products read from shared memory, was
// slower than one thread a gap from 4,096 gaps on (the shared-memory reads
// bound it; not kept).  Two more changes to the thread
// design were timed on the card and dropped, both slower at M = 1e6:
// sorting each block's gaps by (branch, squaring rounds) so a warp runs
// one branch and one round count (the stores of the sorted gaps scatter,
// or, parked in shared memory for coalesced stores, the block waits at a
// barrier for its slowest warp), and giving the direct branch only the a
// terms of the Pade-7 (a second copy of the code, or the guarded one,
// spilled).
//
// k_system (kernel 3) and gap_mahal_sweep (kernel 4) first ran one thread
// per chunk lane, walking the lane's s gaps in order (61 thread blocks at
// N = 1e6, C = 7,813 lanes of s = 128, for 132 SMs).  Neither needs that
// chain for the emission: kernel 3 carries only d_left from a gap to the
// next, so it now builds every gap in a thread of its own, in tiles of
// 32 lanes by K3_ROWS rows with one halo gap a tile (below).  Kernel 4's
// elimination does carry state from gap to gap, so it takes the emission
// off that serial chain: a thread block takes 32 chunk lanes and walks
// their gaps in tiles of K4_ROWS = 3 rows, its warps specialised.  Warps
// 1-3 (the producers) each build one row of a tile (32 gaps, one per
// thread) with gapsmem.cuh's copy of the emission (the generator in shared
// memory, nothing on a stack) and park (d_left, d_right, off, log|Q1|) in
// shared memory; warp 0 (the consumer), one thread per lane, runs the
// previous tile's elimination steps in order with the sweep state in its
// registers.  Two tile buffers let the two overlap, with one barrier a
// tile.  At N = 1e6 that is 245 thread blocks of 128 threads, and a chain
// of s elimination steps per lane instead of s emissions and eliminations.
#include "gapsmem.cuh"

namespace {

// Kernel 2 at large M: one thread per gap, CGT_THREADS gaps a block, three
// blocks an SM up to rank 5 (168 registers, nothing on a stack at rank 5;
// at ranks 6-8 the emission alone needs all 255 and spills a little).
template <int R>
__global__ void __launch_bounds__(CGT_THREADS, R <= 5 ? 3 : 1)
transition_and_noise_thread_kernel(const float* __restrict__ g,
                                   const float* __restrict__ diffs, int M,
                                   float* __restrict__ e_out,
                                   float* __restrict__ q_out) {
  __shared__ gsm::GenS<R> gs;
  gsm::load_gen<R>(g, gs);
  __syncthreads();
  const int m = blockIdx.x * CGT_THREADS + threadIdx.x;
  if (m >= M) return;
  const float dt = diffs[m];
  const bool vl = gsm::van_loan<R>(gs, dt);
  const int nsq = gsm::rounds<R>(gs, dt);
  float e[R][R], q[R][R];
  {
    float g1[R][R], f3[R][R];
    gsm::pade7<R>(gs, ldexpf(dt, -nsq), e, g1, f3);
#pragma unroll 1
    for (int k = 0; k < nsq; ++k) gsm::square<R>(vl, e, g1, f3);
    gsm::q_of<R>(vl, e, g1, q);
  }
  cgt::store_mat<float, R>(e_out, 0, M, m, e);
  cgt::store_mat<float, R>(q_out, 0, M, m, q);
}

// Kernel 2 at small M: R lanes a gap, lane i holding row i of every R x R
// block of its gap in registers; 32 / R gaps a warp, TNR_WARPS warps a
// block.  A product A B is, for lane i, row i of A times the rows of B
// shuffled from the gap's lanes (R^2 shuffles and multiply-adds a lane,
// gsm::pade7's operands and summation order), so the gap's chain is ~R^2
// a product instead of R^3.  The two unpivoted LU solves (cgt::lu_solve's
// steps) give each lane its own right-hand-side columns: every lane
// eliminates the gap's matrix, read from the gap's area of shared memory,
// and solves its columns; the solutions come back to rows through that
// area.  A warp squares to its gaps' largest round count, each gap keeping
// only its own rounds, and forms both Q branches, each gap keeping its
// own: the shuffles need the whole warp.  The block writes its gaps' e
// and Q through shared memory, consecutive gaps an entry.
#define TNR_WARPS 4
#define TNR_FULL 0xffffffffu

template <int R>
struct TnR {
  static constexpr int G = 32 / R;            // gaps a warp
  static constexpr int GAPS = TNR_WARPS * G;  // gaps a block
  static constexpr int RR = R * R;
  // a gap's blocks in shared memory, each RR floats at offset (name) * RR
  enum { NU, DE, VPU, X1, X2, NB };
  static constexpr int AREA = NB * RR + 1;  // odd: gaps' areas spread over
                                            // the banks
};

// out = row i of A B: a is row i of A; row p of B is b in lane base + p
template <int R>
__device__ __forceinline__ void rmm(const float (&a)[R], const float (&b)[R],
                                    int base, float (&out)[R]) {
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float bpk = __shfl_sync(TNR_FULL, b[k], base + p);
      out[k] = p == 0 ? a[0] * bpk : out[k] + a[p] * bpk;
    }
}

// out = row i of A B^T (row k of B is b in lane base + k)
template <int R>
__device__ __forceinline__ void rmm_tb(const float (&a)[R],
                                       const float (&b)[R], int base,
                                       float (&out)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const float bkp = __shfl_sync(TNR_FULL, b[p], base + k);
      out[k] = p == 0 ? a[0] * bkp : out[k] + a[p] * bkp;
    }
}

// cgt::lu_solve of the R x R matrix at p (row-major; its transpose where
// T) for this lane's NC right-hand-side columns x[c], solved in place
template <int R, int NC, bool T>
__device__ __forceinline__ void lane_lu(const float* p, float (&x)[NC][R]) {
  float m[R][R], pinv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < R; ++k) m[r][k] = T ? p[k * R + r] : p[r * R + k];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    pinv[j] = 1.f / m[j][j];
#pragma unroll
    for (int r = j + 1; r < R; ++r) {
      const float f = m[r][j] * pinv[j];
#pragma unroll
      for (int k = j + 1; k < R; ++k) m[r][k] -= f * m[j][k];
#pragma unroll
      for (int c = 0; c < NC; ++c) x[c][r] -= f * x[c][j];
    }
  }
#pragma unroll
  for (int r = R - 1; r >= 0; --r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float acc = x[c][r];
#pragma unroll
      for (int k = r + 1; k < R; ++k) acc -= m[r][k] * x[c][k];
      x[c][r] = acc * pinv[r];
    }
}

template <int R>
__global__ void __launch_bounds__(TNR_WARPS * 32)
transition_and_noise_rows_kernel(const float* __restrict__ g,
                                 const float* __restrict__ diffs, int M,
                                 float* __restrict__ e_out,
                                 float* __restrict__ q_out) {
  using W = TnR<R>;
  constexpr int RR = W::RR, G = W::G, GAPS = W::GAPS;
  __shared__ gsm::GenS<R> gs;
  __shared__ float work[TNR_WARPS * G * W::AREA];
  __shared__ float stage[2 * RR * GAPS];  // [e, q][entry][gap]
  gsm::load_gen<R>(g, gs);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gw = lane / R;    // the lane's gap in its warp
  const bool slot = gw < G;   // the last 32 - G R lanes hold no gap
  const int i = lane % R;     // the lane's row
  const int base = gw * R;    // its gap's first lane
  const int gb = warp * G + (slot ? gw : 0);  // its gap in the block
  const int m = blockIdx.x * GAPS + gb;
  const bool live = slot && m < M;
  float* const area = work + gb * W::AREA;
  const float dt = live ? diffs[m] : 0.f;
  const bool vl = gsm::van_loan<R>(gs, dt);
  const int nsq = gsm::rounds<R>(gs, dt);
  const float sc = ldexpf(dt, -nsq);
  float a[R], sm[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    a[k] = gs.gh[i * R + k] * sc;
    sm[k] = gs.sy[i * R + k] * sc;
  }
  // the Pade-7 polynomials (gsm::pade_parts)
  float a2[R], s2[R], a4[R], s4[R];
  {
    float t1[R], t2[R];
    rmm<R>(a, a, base, a2);
    rmm<R>(a, sm, base, t1);
    rmm_tb<R>(sm, a, base, t2);
#pragma unroll
    for (int k = 0; k < R; ++k) s2[k] = t1[k] - t2[k];
    rmm<R>(a2, a2, base, a4);
    rmm<R>(a2, s2, base, t1);
    rmm_tb<R>(s2, a2, base, t2);
#pragma unroll
    for (int k = 0; k < R; ++k) s4[k] = t1[k] + t2[k];
  }
  float pa[R], ps[R], vtl[R], vtr[R];
  {
    float a6[R], t1[R], t2[R];
    rmm<R>(a2, a4, base, a6);
    rmm<R>(a2, s4, base, t1);
    rmm_tb<R>(s2, a4, base, t2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float s6 = t1[k] + t2[k];
      const float id = (i == k) ? 1.f : 0.f;
      pa[k] = CGT_PADE7_B7 * a6[k] + CGT_PADE7_B5 * a4[k] +
              CGT_PADE7_B3 * a2[k] + CGT_PADE7_B1 * id;
      ps[k] = CGT_PADE7_B7 * s6 + CGT_PADE7_B5 * s4[k] +
              CGT_PADE7_B3 * s2[k];
      vtl[k] = CGT_PADE7_B6 * a6[k] + CGT_PADE7_B4 * a4[k] +
               CGT_PADE7_B2 * a2[k] + CGT_PADE7_B0 * id;
      vtr[k] = CGT_PADE7_B6 * s6 + CGT_PADE7_B4 * s4[k] +
               CGT_PADE7_B2 * s2[k];
    }
  }
  // gsm::pade_sums
  float de[R], vpu[R], vmu[R];
  {
    float utl[R], t1[R], t2[R];
    rmm<R>(a, pa, base, utl);
    rmm<R>(a, ps, base, t1);
    rmm_tb<R>(sm, pa, base, t2);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float utr = t1[k] + t2[k];
      if (slot) area[W::NU * RR + i * R + k] = vtl[k] + utl[k];
      de[k] = vtl[k] - utl[k];
      vpu[k] = vtr[k] + utr;
      vmu[k] = vtr[k] - utr;
      if (slot) area[W::DE * RR + i * R + k] = de[k];
    }
  }
  __syncwarp();
  // f3 = nu^{-T} de^T: this lane's right-hand side is de^T's column i,
  // de's row i; its solution f3's column i
  float f3[R];
  {
    float x[1][R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[0][r] = de[r];
    lane_lu<R, 1, true>(area + W::NU * RR, x);
    if (slot) {
#pragma unroll
      for (int r = 0; r < R; ++r) area[W::X1 * RR + r * R + i] = x[0][r];
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < R; ++k) f3[k] = area[W::X1 * RR + i * R + k];
  {
    float t[R];
    rmm<R>(vmu, f3, base, t);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      vpu[k] -= t[k];
      if (slot) area[W::VPU * RR + i * R + k] = vpu[k];
    }
  }
  __syncwarp();
  // [f1 | g1] = de^{-1} [nu | v_tr + u_tr]: this lane's columns i of nu
  // and of v_tr + u_tr, its solutions f1's and g1's columns i
  {
    float x[2][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[0][r] = area[W::NU * RR + r * R + i];
      x[1][r] = area[W::VPU * RR + r * R + i];
    }
    lane_lu<R, 2, false>(area + W::DE * RR, x);
    if (slot) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        area[W::X1 * RR + r * R + i] = x[0][r];
        area[W::X2 * RR + r * R + i] = x[1][r];
      }
    }
  }
  __syncwarp();
  float f1[R], g1[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    f1[k] = area[W::X1 * RR + i * R + k];
    g1[k] = area[W::X2 * RR + i * R + k];
  }
  // the squaring rounds (gsm::square), to the warp's largest count
  const int nmax = __reduce_max_sync(TNR_FULL, nsq);
#pragma unroll 1
  for (int n = 0; n < nmax; ++n) {
    float f1n[R], t1[R], t2[R], f3n[R];
    rmm<R>(f1, f1, base, f1n);
    rmm<R>(f1, g1, base, t1);
    rmm<R>(g1, f3, base, t2);
    rmm<R>(f3, f3, base, f3n);
    if (n < nsq) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (vl) {
          g1[k] = t1[k] + t2[k];
          f3[k] = f3n[k];
        }
        f1[k] = f1n[k];
      }
    }
  }
  // Q1 (gsm::q_of): sym(g1 f1^T) or sym(I - f1 f1^T); the unsymmetrised
  // rows parked in the NU block, which nothing reads any more
  {
    float t[R], u[R];
    rmm_tb<R>(g1, f1, base, t);
    rmm_tb<R>(f1, f1, base, u);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      t[k] = vl ? t[k] : ((i == k) ? 1.f : 0.f) - u[k];
      if (slot) area[W::NU * RR + i * R + k] = t[k];
    }
    __syncwarp();
    if (live) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        stage[(i * R + k) * GAPS + gb] = f1[k];
        stage[(RR + i * R + k) * GAPS + gb] =
            0.5f * (t[k] + area[W::NU * RR + k * R + i]);
      }
    }
  }
  __syncthreads();
  const int m0 = blockIdx.x * GAPS;
  for (int u = threadIdx.x; u < 2 * RR * GAPS; u += TNR_WARPS * 32) {
    const int gap = u % GAPS, x = (u / GAPS) % RR;
    if (m0 + gap < M)
      (u < RR * GAPS ? e_out : q_out)[size_t(x) * M + m0 + gap] = stage[u];
  }
}

// Kernel 3 fused into the forward sweep: gap 0 gives the chunk-boundary row
// 0 (streamed OUT as k0) and the left coupling; gap g >= 1 gives row g,
// eliminated in place.  K never reaches device memory.
#define K4_LANES 32    // chunk lanes per thread block
#define K4_ROWS 3      // gaps per lane in a tile = producer warps
#define K4_THREADS 128  // warp 0 eliminates, warps 1-3 build the tiles

template <int R>
struct K4 {
  static constexpr int E = 3 * R * R + 1;  // d_left, d_right, off, log|Q1|
  // two tiles of K4_ROWS gap records, then the consumer's d_left of the
  // previous gap and the left coupling, per lane
  static constexpr int DLP = 2 * K4_ROWS * E, OL = DLP + R * R,
                       N = OL + R * R;
  static constexpr size_t SMEM = size_t(N) * K4_LANES * 4;
};

// a lane's R x R block at element offset o of a [n][K4_LANES] area
template <int R>
__device__ __forceinline__ void lane_get(const float* p, int o,
                                         float (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) m[i][k] = p[(o + i * R + k) * K4_LANES];
}

template <int R>
__device__ __forceinline__ void lane_put(float* p, int o,
                                         const float (&m)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) p[(o + i * R + k) * K4_LANES] = m[i][k];
}

// K row j = I + d_left(gap j-1) + d_right(gap j) + boost * is_real(j);
// row 0's d_left comes from the previous chunk's last gap (``wrap``).
//
// Nothing but d_left crosses from one gap to the next, so every gap is
// built by a thread of its own: a thread block takes K3_LANES (32) chunk
// lanes by K3_ROWS rows (gaps j0 .. j0 + K3_ROWS - 1), its thread row
// r = 1..K3_ROWS building gap j0 - 1 + r with gapsmem.cuh's emission (the
// generator in shared memory), writing its off and log|Q1| and parking
// its d_left in shared memory; thread row 0 builds the halo gap j0 - 1
// (or, at j0 = 0, parks the lane's wrap), whose d_left the tile's first K
// row needs.  After one barrier each thread of rows 1..K3_ROWS writes its
// K row from the d_left parked by the row above.  At N = 1e6 that is
// 245 x 19 thread blocks of 256 threads, and 1/K3_ROWS more emissions
// than gaps.
#define K3_LANES 32                            // chunk lanes per block
#define K3_ROWS 7                              // K rows per block
#define K3_THREADS (K3_LANES * (K3_ROWS + 1))  // row 0 builds the halo gap

// dynamic shared bytes: the d_left of thread rows 0..K3_ROWS-1, per lane
template <int R>
constexpr size_t k3_smem() {
  return size_t(K3_ROWS) * R * R * K3_LANES * sizeof(float);
}

// Two thread blocks an SM up to rank 5: the compiler holds the emission in
// 128 registers, at the cost of a small spill, and the SM gets 16 warps
// instead of 8 (at rank 5 on the H100 faster than one block an SM at 184
// registers; at ranks 6-8 the emission alone needs 254-255).
template <int R>
__global__ void __launch_bounds__(K3_THREADS, R <= 5 ? 2 : 1)
k_system_tiled_kernel(const float* __restrict__ g,
                      const float* __restrict__ boost_p,
                      const float* __restrict__ dt,
                      const float* __restrict__ gv,
                      const float* __restrict__ real,
                      const float* __restrict__ wrap, int s, int C,
                      float* k_out, float* off_out, float* lq_out) {
  extern __shared__ __align__(16) float cgt_smem[];
  __shared__ gsm::GenS<R> gs;
  __shared__ float boost[R * R];
  const int lane = threadIdx.x % K3_LANES;
  const int row = threadIdx.x / K3_LANES;
  const int c = blockIdx.x * K3_LANES + lane;
  const int j = blockIdx.y * K3_ROWS - 1 + row;  // this thread's gap
  gsm::load_gen<R>(g, gs);
  if (threadIdx.x < R * R) boost[threadIdx.x] = boost_p[threadIdx.x];
  __syncthreads();
  // [K3_ROWS][R * R][K3_LANES]: thread row r's d_left in slot r
  float* park = cgt_smem + lane;
  const bool live = c < C && j < s;
  float d_right[R][R];
  if (live && j < 0) {  // the halo of the first tile: wrap
#pragma unroll
    for (int e = 0; e < R * R; ++e)
      park[e * K3_LANES] = wrap[size_t(e) * C + c];
  } else if (live) {
    const size_t ij = size_t(j) * C + c;
    float d_left[R][R], off[R][R];
    const float lq =
        gsm::row_terms<R>(gs, dt[ij], gv[ij], d_left, d_right, off);
    if (row > 0) {
      cgt::store_mat<float, R>(off_out, j, C, c, off);
      lq_out[ij] = lq;
    }
    if (row < K3_ROWS) lane_put<R>(park, row * R * R, d_left);
  }
  __syncthreads();
  if (live && row > 0) {
    const float re = real[size_t(j) * C + c];
    const float* dlp = park + (row - 1) * R * R * K3_LANES;
    float k[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b)
        k[i][b] = ((i == b) ? 1.f : 0.f) + dlp[(i * R + b) * K3_LANES] +
                  d_right[i][b] + boost[i * R + b] * re;
    cgt::store_mat<float, R>(k_out, j, C, c, k);
  }
}

// The block's barrier between the producer warps and the consumer warp,
// which reach it from their own loops (a named barrier over all threads).
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(K4_THREADS) : "memory");
}

// The consumer: one lane's elimination steps over tile t's gaps, in order.
template <int R>
__device__ __forceinline__ void eliminate_tile(
    int t, int s, int C, int c, const float* tile, float* lane,
    const float* boost, const float* __restrict__ real,
    const float* __restrict__ wrap, const float* __restrict__ ym,
    float* k0_out, float* olast_out, cgt::SweepCarry<float, R>& st,
    float& lq_sum) {
  using K = K4<R>;
#pragma unroll 1
  for (int r = 0; r < K4_ROWS; ++r) {
    const int gi = t * K4_ROWS + r;
    if (gi >= s) break;
    const float* rec = tile + r * K::E * K4_LANES;
    lq_sum += rec[3 * R * R * K4_LANES];
    const size_t ij = size_t(gi) * C + c;
    const float re = real[ij];
    // K row gi = I + d_left(gap gi-1) + d_right(gap gi) + boost * is_real;
    // row 0's d_left comes from the previous chunk's last gap (wrap)
    float k[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float dlp = gi == 0 ? wrap[cgt::mat_at<R>(0, i, b, C, c)]
                                  : lane[(K::DLP + i * R + b) * K4_LANES];
        k[i][b] = ((i == b) ? 1.f : 0.f) + dlp +
                  rec[(R * R + i * R + b) * K4_LANES] + boost[i * R + b] * re;
      }
    float off[R][R];
    lane_get<R>(rec, 2 * R * R, off);
    if (gi == 0) {
      cgt::store_mat<float, R>(k0_out, 0, C, c, k);
      lane_put<R>(lane, K::OL, off);
    } else {
      float y_j[R], o_left[R][R];
      cgt::load_vec<float, R>(ym, gi, C, c, y_j);
      if (gi == 1) lane_get<R>(lane, K::OL, o_left);
      cgt::elim_step<float, R>(gi == 1, k, off, y_j, o_left, st);
      if (gi == s - 1) cgt::store_mat<float, R>(olast_out, 0, C, c, off);
    }
#pragma unroll
    for (int e = 0; e < R * R; ++e)
      lane[(K::DLP + e) * K4_LANES] = rec[e * K4_LANES];
  }
}

template <int R>
__global__ void __launch_bounds__(K4_THREADS)
gap_mahal_sweep_kernel(const float* __restrict__ g,
                       const float* __restrict__ boost_p,
                       const float* __restrict__ dt,
                       const float* __restrict__ gv,
                       const float* __restrict__ real,
                       const float* __restrict__ wrap,
                       const float* __restrict__ ym, int s, int C,
                       float* acc00, float* accy0, float* w0l, float* wl,
                       float* dl, float* invdl, float* mh, float* ld,
                       float* lq_out, float* k0_out, float* olast_out) {
  using K = K4<R>;
  extern __shared__ __align__(16) float cgt_smem[];
  __shared__ gsm::GenS<R> gs;
  __shared__ float boost[R * R];
  const int lane = threadIdx.x % K4_LANES;
  const int warp = threadIdx.x / K4_LANES;
  const int c = blockIdx.x * K4_LANES + lane;
  gsm::load_gen<R>(g, gs);
  if (threadIdx.x < R * R) boost[threadIdx.x] = boost_p[threadIdx.x];
  __syncthreads();
  // tile t in buffer t % 2: [K4_ROWS][E][K4_LANES]
  float* area = cgt_smem + lane;
  const int ntiles = (s + K4_ROWS - 1) / K4_ROWS;
  // step u: the producers build tile u while the consumer eliminates tile
  // u - 1; one barrier a step
  if (warp == 0) {
    cgt::SweepCarry<float, R> st;
    float lq_sum = 0.f;
#pragma unroll 1
    for (int u = 0; u <= ntiles; ++u) {
      if (u > 0 && c < C)
        eliminate_tile<R>(u - 1, s, C, c,
                          area + ((u - 1) % 2) * K4_ROWS * K::E * K4_LANES,
                          area, boost, real, wrap, ym, k0_out, olast_out, st,
                          lq_sum);
      tile_barrier();
    }
    if (c < C) {
      cgt::store_sweep_state<float, R>(st, C, c, acc00, accy0, w0l, wl, dl,
                                       invdl, mh, ld);
      lq_out[c] = lq_sum;
    }
  } else {
#pragma unroll 1
    for (int u = 0; u <= ntiles; ++u) {
      const int gi = u * K4_ROWS + warp - 1;
      if (u < ntiles && gi < s && c < C) {
        const size_t ij = size_t(gi) * C + c;
        float d_left[R][R], d_right[R][R], off[R][R];
        const float lq =
            gsm::row_terms<R>(gs, dt[ij], gv[ij], d_left, d_right, off);
        float* rec =
            area + ((u % 2) * K4_ROWS + warp - 1) * K::E * K4_LANES;
        lane_put<R>(rec, 0, d_left);
        lane_put<R>(rec, R * R, d_right);
        lane_put<R>(rec, 2 * R * R, off);
        rec[3 * R * R * K4_LANES] = lq;
      }
      tile_barrier();
    }
  }
}

template <int R>
inline int launch_gap_sweep(const float* g, const float* boost,
                            const float* dt, const float* gv,
                            const float* real, const float* wrap,
                            const float* y, int s, int C, float* const* o,
                            cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gap_mahal_sweep_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(K4<R>::SMEM));
  if (err != cudaSuccess) return int(err);
  const int blocks = (C + K4_LANES - 1) / K4_LANES;
  gap_mahal_sweep_kernel<R><<<blocks, K4_THREADS, K4<R>::SMEM, st>>>(
      g, boost, dt, gv, real, wrap, y, s, C, o[0], o[1], o[2], o[3], o[4],
      o[5], o[6], o[7], o[8], o[9], o[10]);
  return int(cudaGetLastError());
}

template <int R>
inline int launch_k_system(const float* g, const float* boost,
                           const float* dt, const float* gv,
                           const float* real, const float* wrap, int s,
                           int C, float* k, float* off, float* lq,
                           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      k_system_tiled_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(k3_smem<R>()));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((C + K3_LANES - 1) / K3_LANES,
                  (s + K3_ROWS - 1) / K3_ROWS);
  k_system_tiled_kernel<R><<<grid, K3_THREADS, k3_smem<R>(), st>>>(
      g, boost, dt, gv, real, wrap, s, C, k, off, lq);
  return int(cudaGetLastError());
}

inline int blocks_for(int n) { return (n + CGT_THREADS - 1) / CGT_THREADS; }

}  // namespace

extern "C" {

int cgt_transition_and_noise_f32(const float* g, const float* diffs, int r,
                                 int M, float* e, float* q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                         \
  transition_and_noise_thread_kernel<RR>       \
      <<<blocks_for(M), CGT_THREADS, 0, st>>>(g, diffs, M, e, q)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

// kernel 2 at small M: R lanes a gap
int cgt_transition_and_noise_rows_f32(const float* g, const float* diffs,
                                      int r, int M, float* e, float* q,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                   \
  transition_and_noise_rows_kernel<RR>                                   \
      <<<(M + TnR<RR>::GAPS - 1) / TnR<RR>::GAPS, TNR_WARPS * 32, 0, st>>>( \
          g, diffs, M, e, q)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
  return int(cudaGetLastError());
}

int cgt_k_system_f32(const float* g, const float* boost, const float* dt,
                     const float* gv, const float* real, const float* wrap,
                     int r, int s, int C, float* k, float* off, float* lq,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CGT_LAUNCH(RR)                                                    \
  return launch_k_system<RR>(g, boost, dt, gv, real, wrap, s, C, k, off, \
                             lq, st)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

int cgt_gap_mahal_sweep_f32(const float* g, const float* boost,
                            const float* dt, const float* gv,
                            const float* real, const float* wrap,
                            const float* y, int r, int s, int C, float* acc00,
                            float* accy0, float* w0l, float* wl, float* dl,
                            float* invdl, float* mh, float* ld, float* lq,
                            float* k0, float* olast, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* const outs[11] = {acc00, accy0, w0l, wl, dl, invdl,
                           mh, ld, lq, k0, olast};
#define CGT_LAUNCH(RR) \
  return launch_gap_sweep<RR>(g, boost, dt, gv, real, wrap, y, s, C, outs, st)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of kernel 3's rank-r instance
int cgt_k_system_smem_bytes(int r) {
#define CGT_LAUNCH(RR) return int(k3_smem<RR>())
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

// dynamic shared bytes per thread block of kernel 4's rank-r instance
int cgt_gap_mahal_sweep_smem_bytes(int r) {
#define CGT_LAUNCH(RR) return int(K4<RR>::SMEM)
  CGT_RANK_SWITCH(r, CGT_LAUNCH)
#undef CGT_LAUNCH
}

}  // extern "C"
