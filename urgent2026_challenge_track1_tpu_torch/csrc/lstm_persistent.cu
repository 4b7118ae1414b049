// K1p: the fused-input bidirectional LSTM, K8p: its one-direction training
// instance, and K2p / K3p / K4p / K6p: one direction over a hoisted input
// projection, as persistent, weight-stationary tensor-core recurrences for
// NVIDIA Hopper (sm_90a), bound with ctypes.  K1p and K8p first
// (fusedin_persistent_kernel, bf16, and f32 on 3xTF32 products: K1p-f32,
// K8p-f32); K2p-K6p (scan_persistent_kernel, bf16, and f32 on 3xTF32
// products: K2p-f32, K3p-f32, K4p-f32, K6p-f32) after it.  The training
// backwards K5p / K7p / K10p and their dW kernels are in
// lstm_persistent_bwd.cu, the pieces both use in lstm_persistent_common.cuh.
//
// Replaces urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:
// _fusedin_forward (body _fusedin_step) for bfloat16 and (K1p-f32, below)
// float32 inputs, beside K1's walk in lstm_kernels.cu (fusedin_kernel),
// which keeps every shape without a plan.  Each step computes, for both
// directions,
//   gates = x_t W_ih^T + round_bf16(h_{t-1}) W_hh^T + b      (f32 sums)
//   c = f c + i g,  h = o tanh(c)                             (f32 cell)
// and writes h (bf16) to out (R, T, 2H), forward || backward.
//
// What bounded the walk: every block re-read all of W_ih and W_hh (1.8 MB at
// N = 196, H = 392; 7.1 MB at N = 384, H = 768) from L2 on every step and
// multiplied them on CUDA cores for at most 8 rows, so a launch moved
// 12-341 GB through L2.  The arithmetic bound is 0.05-0.35 ms a launch.
//
// Design (ops/cuda_lstm.plan_persistent picks the numbers):
//   * one cooperative grid of 2 x G x S CTAs, one per SM: direction d, row
//     group g, column slice s.  CTA (d, g, s) owns hidden units
//     [s U, min((s + 1) U, H)) of direction d for the rows of group g, and
//     the four gate columns q H + u of each unit, so the cell update needs
//     nothing from other CTAs;
//   * its slice of [W_ih; W_hh] ((Kx + Kh) x 4U bf16, each K segment padded
//     to 16 with zero rows, zero columns past H; packed by
//     ops/cuda_lstm.pack_persistent_weights) is loaded into shared memory
//     once and stays there for the whole walk: weights cross L2 once per
//     launch;
//   * a step walks the group's rows in chunks of CH <= 64 rows: stage x_t and
//     add x_t W_ih on tensor cores (mma.sync m16n8k16 bf16 from ldmatrix,
//     f32 accumulators in registers; the 8 warps split the output columns
//     four ways and the K steps two ways, and the two partial sums are added
//     in shared memory in a fixed order, so a launch is deterministic); on
//     the first chunk wait for step t - 1 of the (d, g) group; stage
//     h_{t-1}, which is the bf16 output just written, out[r, t -/+ 1, d H :
//     d H + H] (the output tensor is the exchange buffer), with L2-only
//     copies (cp.async.cg: an L1 line could be stale); add h W_hh; run the
//     cell in f32 and write h.  Staging is cp.async, every copy of a chunk
//     in flight at once.  c lives in shared memory when the group's cells
//     fit, otherwise in a global (R, 2, H) f32 buffer; only its owner
//     touches it, and a chunk's c is loaded into registers before the
//     products;
//   * the barrier of a (d, g) group: __syncthreads, then one thread fences
//     and adds 1 to the group's counter; the S CTAs of the group wait until
//     it reaches S * step with acquire loads.  The wait is bounded: past
//     kSpinTimeoutNs it traps, so a planner error fails the launch instead
//     of hanging.  Rows are independent, so only the S CTAs of one (d, g)
//     wait on each other.
// What bounds it now: every phase of a step runs in turn.  Built with
// -DK1P_PHASE_CLOCKS, the kernel sums each CTA's clock64 cycles per phase
// (profile_k1p.py prints them; PERF.md has an H100's): at N = 384, H = 768
// and 48 rows the products, the staging of h (every CTA of the group reads
// all of its h from L2) and the cell lead.
//
// K8p (fusedin_persistent_kernel<T, true>) replaces
// urgent2026_challenge_track1_tpu/ops/pallas_lstm.py: _train_forward_streamin
// (body _train_fwd_streamin_body; K8, the training forward of one direction
// on the raw input) for bfloat16 and (K8p-f32) float32 inputs, beside K8's
// walk in lstm_kernels.cu (fusedin_kernel<true>), which keeps every shape
// without a plan (float32 at H = 1020).  Each step computes
//   gates = x_t W_ih^T + round_bf16(h_{t-1}) W_hh^T + round_bf16(b)  (f32)
// as K1p does for one direction, and stores h, the post-activation gates
// i, f, g, o (R, T, 4H) at q H + u and c (R, T, H) in bf16, the layout of
// _train_fwd_streamin_body.  The walk re-read all of [W_ih; W_hh] (1.8 MB at
// N = 196, H = 392; 7.1 MB at N = 384, H = 768) from L2 on every step for
// at most 8 rows on CUDA cores: 298-475x its bound (PERF.md).  The design is
// K1p's for one direction: a grid of G x S CTAs (the planner's dirs = 1, so
// a slice is half as wide as K1p's on the same card) keeps its [W_ih; W_hh]
// slice in shared memory, h is exchanged through out (R, T, H), and the
// residuals are stored as K4p stores them (below): a chunk's from
// registers, the last chunk's after the arrive, during the next wait.
// What bounds it: as K1p, the phases of a step in turn, one barrier a step.
//
// K1p-f32 and K8p-f32 (T = float; _fusedin_step and _train_fwd_streamin_body
// with f32 inputs, where h is not rounded before the product): the same
// walks with x, the weights, the bias, the exchanged h and the residuals in
// f32 and both products on the tensor cores as 3xTF32 (K4p-f32's, below).
// The f32 slice would not fit at the flow width with K1p's 8-element row
// pad (U = 8: 236,160 bytes), and a 4-float pad gives 2-way bank conflicts
// on the B fragments, so it is stored without a pad in mma fragment order
// (frag_index): a warp's B fragment is one 8-byte load a lane over 256
// consecutive bytes.  Where the two-direction slice needs more than half
// the SMs a direction (the flow width: 96 CTAs of U = 8), K1p-f32 runs one
// grid a direction, each writing its half of out (ops/cuda_lstm.k1_route).
// What bounds it: as K1p, plus three products a k8 step and twice the
// staged bytes; at the flow width one group of 16-row chunks a step.

#include "lstm_persistent_common.cuh"

namespace {

// Per-phase clock64 sums of each CTA (a measurement build only): the c
// load, staging x, x W_ih, the wait, staging h, h W_hh, the reduction, the
// cell, the arrival.
#ifdef K1P_PHASE_CLOCKS
constexpr int kPhases = 9;
constexpr int kMaxCtas = 1024;
__device__ long long phase_cycles[kMaxCtas][kPhases];
#define K1P_MARK(k)                                \
  if (threadIdx.x == 0) {                          \
    const long long now = clock64();               \
    cycles[k] += now - last;                       \
    last = now;                                    \
  }
#else
#define K1P_MARK(k)
#endif

// The partition of ops/cuda_lstm.PersistentPlan, and the shared-memory
// layout that follows from it (the planner reckons the same bytes).
struct Plan {
  int R, Tn, N, H;
  int S, G, U, rows;  // rows: rows per group
  int chunk;          // rows per chunk, a multiple of 16
  int c_in_smem;
  int kx, kh;         // K segments padded to 16
  int elem;           // bytes of an element: 2 (bf16) or 4 (f32)
  __host__ __device__ int cols() const { return 4 * U; }
  __host__ __device__ int ldw() const { return 4 * U + 8; }  // elements
  // the resident slice's elements: (kx + kh) rows of ldw(), or, on K1p-f32
  // and K8p-f32 (N > 0, f32), of 4U in fragment order (frag_index)
  __host__ __device__ size_t w_elems() const {
    return (size_t)(kx + kh) * (N > 0 && elem == 4 ? cols() : ldw());
  }
  // elements; a staged row is an odd multiple of 16 bytes
  __host__ __device__ int lda() const { return (kx > kh ? kx : kh) + 16 / elem; }
  __host__ __device__ int ldc() const { return 4 * U + 4; }  // f32
  // K1p (N > 0) keeps its bias (4U f32); K2p-K6p (N = 0) a double buffer
  // of the projection's 4U columns for a chunk (2 x chunk x 4U elements)
  __host__ __device__ size_t smem_bytes() const {
    const size_t e = elem;
    return e * w_elems() + e * chunk * lda() + 4 * (size_t)chunk * ldc() +
           (N > 0 ? 4 * (size_t)cols() : e * 2 * chunk * cols()) +
           (c_in_smem ? 4 * (size_t)rows * U : 0);
  }
};

// K1p's (dirs = 2) and K8p's (dirs = 1) arguments; T = float: K1p-f32
// (dirs = 2, or dirs = 1 for the direction reverse, whose h goes to its
// half of the (R, T, 2H) out) and K8p-f32 (dirs = 1).
template <typename T>
struct Args {
  const T* x;        // (R, T, N)
  const T* w;        // (dirs, S, kx + kh, 4U) packed [W_ih; W_hh] slices
  const T* bias;     // (dirs, S, 4U)
  T* out;            // (R, T, dirs H); K1p-f32 with dirs = 1: (R, T, 2H)
  float* c_global;   // (R, dirs, H) when !c_in_smem
  int* counters;     // (dirs, G) zeros
  Plan p;
  int reverse;       // K8p, and K1p-f32 with dirs = 1: the direction of its one walk
  T* gates;          // K8p: (R, T, 4H) post-activation gates
  T* c_res;          // K8p: (R, T, H) c of each step
};

// The slice's element (k, c) in fragment order (K1p-f32, K8p-f32): k8 x n8
// block (k / 8, c / 8) is 64 consecutive floats, row-major over the blocks,
// and holds lane l's two B elements W(k + l % 4, n + l / 4) and (k + 4 +
// l % 4, ...) of mma.m16n8k8 side by side at 2 l and 2 l + 1.  A warp's
// B fragment is then one 8-byte load a lane over 256 consecutive bytes:
// free of bank conflicts with no pad, so the slice takes 4U floats a row
// (the flow width's U = 8 fits only so; 4U + 8 would need 236,160 bytes).
__device__ __forceinline__ int frag_index(int k, int c, int C) {
  return ((k >> 3) * (C >> 3) + (c >> 3)) * 64 + 2 * (4 * (c & 7) + (k & 3)) + ((k >> 2) & 1);
}

// acc[m * NB + j] += A (row block m, k steps [k0, k1)) times W (the same k,
// this warp's column block j) for MT row blocks and NB column blocks; all
// MT x NB products of a k step are independent, and each A and B block is
// loaded once for them.  a_base / b_base: this lane's ldmatrix address of
// row block 0 / the warp's first column block at k = 0.
template <int MT, int NB>
__device__ __forceinline__ void mma_blocks(float (&acc)[kAccBlocks][4], unsigned a_base,
                                           unsigned b_base, int k0, int k1, unsigned lda_bytes,
                                           unsigned ldw_bytes) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 16) {
    unsigned a[MT][4], b[NB][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) load_a(a[m], a_base + m * 16 * lda_bytes + 2 * k);
#pragma unroll
    for (int j = 0; j < NB; ++j) load_b(b[j], b_base + k * ldw_bytes + j * kNGroups * 16);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_bf16(acc[m * NB + j], a[m], b[j]);
    }
  }
}

// The warp's accumulator blocks into acc_s (chunk x 4U f32), or, ADD, added
// to what another warp put there (the m16n8 layout: rows l / 4 and l / 4 + 8,
// columns 2 (l % 4) and + 1).
template <int MT, int NB, bool ADD, int NACC>
__device__ __forceinline__ void put_blocks(const float (&acc)[NACC][4], float* acc_s, int ldc,
                                           int ng, int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float* o = acc_s + (m * 16 + lane / 4) * ldc + (ng + j * kNGroups) * 8 + 2 * (lane % 4);
      float2 lo = make_float2(acc[m * NB + j][0], acc[m * NB + j][1]);
      float2 hi = make_float2(acc[m * NB + j][2], acc[m * NB + j][3]);
      if (ADD) {
        const float2 plo = *reinterpret_cast<const float2*>(o);
        const float2 phi = *reinterpret_cast<const float2*>(o + 8 * ldc);
        lo.x += plo.x;
        lo.y += plo.y;
        hi.x += phi.x;
        hi.y += phi.y;
      }
      *reinterpret_cast<float2*>(o) = lo;
      *reinterpret_cast<float2*>(o + 8 * ldc) = hi;
    }
  }
}

// acc += this warp's share of A (chunk x K, a_s) times W (K x 4U, w_seg):
// its column blocks and its half (kg) of the K steps.  The pads of lda and
// ldw make every ldmatrix free of bank conflicts (row strides an odd
// multiple of 16 bytes modulo 128).
__device__ __forceinline__ void mma_segment(float (&acc)[kAccBlocks][4], const bf16* a_s,
                                            int lda, const bf16* w_seg, int ldw, int K, int mt,
                                            int nb, int ng, int kg) {
  const int lane = threadIdx.x % 32;
  const unsigned a_base = smem_addr(a_s + (lane % 16) * lda + (lane / 16) * 8);
  const unsigned b_base = smem_addr(w_seg + (lane % 16) * ldw + ng * 8);
  const int half = (K / 16 + kKGroups - 1) / kKGroups * 16;
  const int k0 = kg * half;
  const int k1 = min(K, k0 + half);
  const unsigned lda_bytes = 2 * lda, ldw_bytes = 2 * ldw;
#define K1P_MMA(M, N)                                                        \
  case M * 16 + N:                                                           \
    mma_blocks<M, N>(acc, a_base, b_base, k0, k1, lda_bytes, ldw_bytes);    \
    break;
  switch (mt * 16 + nb) {
    K1P_SHAPES(K1P_MMA)
    default: break;  // nb = 0: no column block for this warp
  }
#undef K1P_MMA
}

// mma_blocks for f32 operands: k8 steps of three TF32 products, the small
// terms (lo hi, hi lo) summed apart and added to the big one's sum at the
// end of the warp's K range.  The A
// fragment comes from ldmatrix as for bf16 (an 8 x 8 b16 block is 8 x 4
// f32, and lane l gets the f32 at row l / 4, column l % 4: the m16n8k8 TF32
// layout); the B fragment, W (k + l % 4, n + l / 4) and (k + 4 + l % 4, ...),
// from two plain loads (b_base: this lane's element of the warp's first
// column block at k = 0; ldw = 4U + 8 is 8 or 24 modulo 32, so the 32 lanes
// hit 32 banks), or, FRAG (a slice in fragment order, frag_index), from one
// 8-byte load (b_base: the lane's pair of the warp's first block at k = 0;
// ldw: the floats of one k8 row of blocks, 8 x 4U).
template <int MT, int NB, bool FRAG = false>
__device__ __forceinline__ void mma_blocks_tf32(float (&acc)[kAccBlocksTf32][4], unsigned a_base,
                                                const float* b_base, int k0, int k1,
                                                unsigned lda_bytes, int ldw) {
  // the small terms' own sums: two dependent chains per block, not three
  float small[MT * NB][4] = {};
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    unsigned ah[MT][4], al[MT][4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      unsigned raw[4];
      load_a(raw, a_base + m * 16 * lda_bytes + 4 * k);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), ah[m][i], al[m][i]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if constexpr (FRAG) {
        const float2 b = *reinterpret_cast<const float2*>(b_base + (size_t)(k >> 3) * ldw +
                                                          j * kNGroups * 64);
        split_tf32(b.x, bh[j][0], bl[j][0]);
        split_tf32(b.y, bh[j][1], bl[j][1]);
      } else {
        const float* b = b_base + (size_t)k * ldw + j * kNGroups * 8;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4 * ldw], bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_tf32(small[m * NB + j], al[m], bh[j]);
        mma_tf32(small[m * NB + j], ah[m], bl[j]);
        mma_tf32(acc[m * NB + j], ah[m], bh[j]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < MT * NB; ++b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[b][i] += small[b][i];
  }
}

// mma_segment for f32: the same warp split (column blocks ng, ng + 4, ...,
// half kg of the K steps), 3xTF32 products.  The staged rows (lda = K + 4
// f32) are an odd multiple of 16 bytes, so ldmatrix is free of bank
// conflicts.
__device__ __forceinline__ void mma_segment(float (&acc)[kAccBlocksTf32][4], const float* a_s,
                                            int lda, const float* w_seg, int ldw, int K, int mt,
                                            int nb, int ng, int kg) {
  const int lane = threadIdx.x % 32;
  const unsigned a_base = smem_addr(a_s + (lane % 16) * lda + (lane / 16) * 4);
  const float* b_base = w_seg + (lane % 4) * ldw + ng * 8 + lane / 4;
  const int half = (K / 16 + kKGroups - 1) / kKGroups * 16;
  const int k0 = kg * half;
  const int k1 = min(K, k0 + half);
#define TF32_MMA(M, N)                                                               \
  case M * 16 + N:                                                                   \
    mma_blocks_tf32<M, N>(acc, a_base, b_base, k0, k1, 4 * (unsigned)lda, ldw);      \
    break;
  switch (mt * 16 + nb) {
    TF32_SHAPES(TF32_MMA)
    default: break;  // nb = 0: no column block for this warp
  }
#undef TF32_MMA
}

// mma_segment for f32 on a slice in fragment order (K1p-f32, K8p-f32; w_seg
// at the segment's first k8 row of blocks, C = 4U columns).
__device__ __forceinline__ void mma_segment_frag(float (&acc)[kAccBlocksTf32][4], const float* a_s,
                                                 int lda, const float* w_seg, int C, int K, int mt,
                                                 int nb, int ng, int kg) {
  const int lane = threadIdx.x % 32;
  const unsigned a_base = smem_addr(a_s + (lane % 16) * lda + (lane / 16) * 4);
  const float* b_base = w_seg + ng * 64 + 2 * lane;
  const int half = (K / 16 + kKGroups - 1) / kKGroups * 16;
  const int k0 = kg * half;
  const int k1 = min(K, k0 + half);
#define FRAG_MMA(M, N)                                                               \
  case M * 16 + N:                                                                   \
    mma_blocks_tf32<M, N, true>(acc, a_base, b_base, k0, k1, 4 * (unsigned)lda, 8 * C); \
    break;
  switch (mt * 16 + nb) {
    TF32_SHAPES(FRAG_MMA)
    default: break;  // nb = 0: no column block for this warp
  }
#undef FRAG_MMA
}

// acc_s = the sum of the kKGroups = 2 warp rows' partial products, in a
// fixed order (deterministic); ends with the block synchronised.  NACC:
// kAccBlocks (bf16 products) or kAccBlocksTf32 (f32).
template <int NACC>
__device__ __forceinline__ void reduce_blocks(const float (&acc)[NACC][4], float* acc_s, int ldc,
                                              int mt, int nb, int ng, int kg) {
  const int lane = threadIdx.x % 32;
#define K1P_PUT(M, N)                                         \
  case M * 16 + N:                                            \
    put_blocks<M, N, false>(acc, acc_s, ldc, ng, lane);       \
    break;
#define K1P_ADD(M, N)                                         \
  case M * 16 + N:                                            \
    put_blocks<M, N, true>(acc, acc_s, ldc, ng, lane);        \
    break;
  if (kg == 1) {
    if constexpr (NACC == kAccBlocks) {
      switch (mt * 16 + nb) {
        K1P_SHAPES(K1P_PUT)
        default: break;
      }
    } else {
      switch (mt * 16 + nb) {
        TF32_SHAPES(K1P_PUT)
        default: break;
      }
    }
  }
  __syncthreads();
  if (kg == 0) {
    if constexpr (NACC == kAccBlocks) {
      switch (mt * 16 + nb) {
        K1P_SHAPES(K1P_ADD)
        default: break;
      }
    } else {
      switch (mt * 16 + nb) {
        TF32_SHAPES(K1P_ADD)
        default: break;
      }
    }
  }
  __syncthreads();
#undef K1P_PUT
#undef K1P_ADD
}

// K4p/K6p/K8p: the residuals of a thread's cells of one chunk (i, f, g, o, c per
// slot, rows from rg) from registers to gates (R, T, 4H) and c_res (R, T, H)
// at step t.
template <typename T, int SLOTS>
__device__ __forceinline__ void store_residuals(T* gates, T* c_res, int Tn, int H,
                                                const T (&res)[SLOTS][5],
                                                const int (&cell_row)[SLOTS],
                                                const int (&cell_ul)[SLOTS], size_t rg, int rows,
                                                int t, int u0) {
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (cell_row[j] >= rows) continue;
    const size_t rt = (rg + cell_row[j]) * Tn + t;
    const int u = u0 + cell_ul[j];
    T* g = gates + rt * 4 * H + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[(size_t)q * H] = res[j][q];
    c_res[rt * H + u] = res[j][4];
  }
}

// STORE = false: K1p, both directions (d = blockIdx.z); STORE = true: K8p,
// one direction (a.reverse) that also stores the residuals.  T = float:
// K1p-f32 and K8p-f32, the same walk with f32 inputs, weights, exchange and
// residuals and 3xTF32 products from a slice in fragment order; K1p-f32
// walks both directions (gridDim.z = 2) or one (gridDim.z = 1: a.reverse,
// into its half of out), so a width whose slice needs more than half the
// SMs a direction runs as two launches.
template <typename T, bool STORE>
__global__ void __launch_bounds__(kThreads, 1) fusedin_persistent_kernel(const Args<T> a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kDirs = STORE ? 1 : 2;  // bf16: the directions of the grid
  constexpr int kAcc = kF32 ? kAccBlocksTf32 : kAccBlocks;
  constexpr int kSlots = kF32 ? kCellSlotsF32 : kCellSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan p = a.p;
  const int s = blockIdx.x, g = blockIdx.y, d = blockIdx.z;  // d = 0 on K8p
  const bool rev = (kF32 && !STORE) ? (gridDim.z == 2 ? d != 0 : a.reverse != 0)
                   : STORE           ? a.reverse != 0
                                     : d != 0;
  const int U = p.U, C = p.cols(), H = p.H;
  const int ldw = p.ldw(), lda = p.lda(), ldc = p.ldc();
  const int Kp = p.kx + p.kh;
  T* w_s = reinterpret_cast<T*>(smem);
  T* a_s = w_s + (size_t)Kp * (kF32 ? C : ldw);
  float* acc_s = reinterpret_cast<float*>(a_s + (size_t)p.chunk * lda);
  float* b_s = acc_s + (size_t)p.chunk * ldc;
  float* c_s = b_s + C;

  const int r_begin = g * p.rows;
  const int r_count = min(p.rows, p.R - r_begin);
  const int u0 = s * U;
  const int nu = min(U, H - u0);
  // out's row stride and this direction's first column (evaluated where it
  // is used, as bf16 K1p and K8p always have); the directions of the grid
  // (c_global's middle axis)
  const size_t ld_out = kF32 ? (STORE ? (size_t)H : 2 * (size_t)H) : kDirs * (size_t)H;
  auto col0 = [&] { return kF32 ? (STORE ? 0 : (size_t)rev * H) : (size_t)d * H; };
  const int nz = kF32 ? (int)gridDim.z : kDirs;
  int* counter = a.counters + d * p.G + g;
  // c of (row in group, unit in slice): shared memory or the global buffer
  float* cb = p.c_in_smem ? c_s : a.c_global + ((size_t)r_begin * nz + d) * H + u0;
  const size_t cld = p.c_in_smem ? (size_t)U : kF32 ? (size_t)nz * H : ld_out;

  // the weight slice (bf16: 16-byte vectors, 4U is a multiple of 16; f32:
  // into fragment order), the bias, a zero A buffer and a zero c
  const T* wg = a.w + (size_t)(d * p.S + s) * Kp * C;
  if constexpr (kF32) {
    for (int i = threadIdx.x; i < Kp * C; i += kThreads) {
      const int k = i / C;
      w_s[frag_index(k, i - k * C, C)] = __ldg(wg + i);
    }
  } else {
    const int vpr = C / 8;
    for (int i = threadIdx.x; i < Kp * vpr; i += kThreads) {
      const int k = i / vpr;
      const int v = i - k * vpr;
      *reinterpret_cast<uint4*>(w_s + (size_t)k * ldw + v * 8) =
          __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * C + v * 8));
    }
  }
  for (int j = threadIdx.x; j < C; j += kThreads)
    b_s[j] = to_f32(a.bias[(size_t)(d * p.S + s) * C + j]);
  for (int i = threadIdx.x; i < p.chunk * lda; i += kThreads) a_s[i] = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < r_count * U; i += kThreads) {
    const int row = i / U;
    const int ul = i - row * U;
    if (ul < nu) cb[row * cld + ul] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int ng = warp % kNGroups;
  const int kg = warp / kNGroups;
  const int nb = (C / 8 - ng + kNGroups - 1) / kNGroups;  // column blocks ng, ng + 4, ...
  // this thread's cells (row, unit) of a full chunk, i = tid + j * kThreads;
  // a row past the chunk's marks an empty slot
  int cell_row[kSlots], cell_ul[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = threadIdx.x + j * kThreads;
    cell_row[j] = i / U;
    cell_ul[j] = i - cell_row[j] * U;
    if (cell_ul[j] >= nu) cell_row[j] = p.chunk;
  }
  [[maybe_unused]] T res[kSlots][5];  // K8p: this thread's cells' residuals
#ifdef K1P_PHASE_CLOCKS
  long long cycles[kPhases] = {}, last = clock64();
#endif
  for (int step = 0; step < p.Tn; ++step) {
    const int t = rev ? p.Tn - 1 - step : step;
    const int tp = rev ? t + 1 : t - 1;
    for (int r0 = 0; r0 < r_count; r0 += p.chunk) {
      const int rows = min(p.chunk, r_count - r0);
      const int mt = (rows + 15) / 16;
      const size_t rg = (size_t)(r_begin + r0);
      [[maybe_unused]] const bool last_chunk = r0 + p.chunk >= r_count;
      float acc[kAcc][4] = {};
      // the chunk's c, loaded now: its latency hides behind the products
      float c_reg[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        c_reg[j] = cell_row[j] < rows ? cb[(size_t)(r0 + cell_row[j]) * cld + cell_ul[j]] : 0.f;
      }
      K1P_MARK(0)

      // x_t W_ih: independent of h, so the first chunk's runs before the wait
      stage<false>(a_s, lda, a.x + (rg * p.Tn + t) * p.N, (size_t)p.Tn * p.N, rows, p.N, p.kx);
      __syncthreads();
      K1P_MARK(1)
      if constexpr (kF32) {
        mma_segment_frag(acc, a_s, lda, w_s, C, p.kx, mt, nb, ng, kg);
      } else {
        mma_segment(acc, a_s, lda, w_s, ldw, p.kx, mt, nb, ng, kg);
      }
      __syncthreads();  // a_s is free
      K1P_MARK(2)
      if (step > 0) {
        if (r0 == 0) wait_for(counter, p.S * step);
        K1P_MARK(3)
        stage<true>(a_s, lda, a.out + (rg * p.Tn + tp) * ld_out + col0(), p.Tn * ld_out, rows, H,
                    p.kh);
        __syncthreads();
        K1P_MARK(4)
        if constexpr (kF32) {
          mma_segment_frag(acc, a_s, lda, w_s + (size_t)p.kx * C, C, p.kh, mt, nb, ng, kg);
        } else {
          mma_segment(acc, a_s, lda, w_s + (size_t)p.kx * ldw, ldw, p.kh, mt, nb, ng, kg);
        }
        K1P_MARK(5)
      }
      // acc_s: the chunk's pre-activations (without b)
      reduce_blocks(acc, acc_s, ldc, mt, nb, ng, kg);
      K1P_MARK(6)

#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int row = cell_row[j];
        const int ul = cell_ul[j];
        if (row >= rows) continue;
        const float* pre = acc_s + row * ldc + ul;
        const float ig = sigmoid_f(pre[0] + b_s[ul]);
        const float fg = sigmoid_f(pre[U] + b_s[U + ul]);
        const float gg = tanhf(pre[2 * U] + b_s[2 * U + ul]);
        const float og = sigmoid_f(pre[3 * U] + b_s[3 * U + ul]);
        const float c = fg * c_reg[j] + ig * gg;
        cb[(size_t)(r0 + row) * cld + ul] = c;
        a.out[((rg + row) * p.Tn + t) * ld_out + col0() + u0 + ul] = from_f32<T>(og * tanhf(c));
        if constexpr (STORE) {
          res[j][0] = from_f32<T>(ig);
          res[j][1] = from_f32<T>(fg);
          res[j][2] = from_f32<T>(gg);
          res[j][3] = from_f32<T>(og);
          res[j][4] = from_f32<T>(c);
        }
      }
      if constexpr (STORE) {
        if (!last_chunk)
          store_residuals(a.gates, a.c_res, p.Tn, H, res, cell_row, cell_ul, rg, rows, t, u0);
      }
      K1P_MARK(7)
      // the next chunk first writes a_s, free since the last product; acc_s
      // is written again only after two more barriers
    }
    // arrive: every h of this step is stored before the counter moves
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1);
    }
    if constexpr (STORE) {  // the last chunk's residuals, during the next wait
      const int r_last = (r_count - 1) / p.chunk * p.chunk;
      store_residuals(a.gates, a.c_res, p.Tn, H, res, cell_row, cell_ul,
                      (size_t)(r_begin + r_last), r_count - r_last, t, u0);
    }
    K1P_MARK(8)
  }
#ifdef K1P_PHASE_CLOCKS
  const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && cta < kMaxCtas) {
    for (int k = 0; k < kPhases; ++k) phase_cycles[cta][k] = cycles[k];
  }
#endif
}

// K1p (scan = false: N > 0) or K2p/K3p (scan: N = 0).
bool bad_plan(const Plan& p, bool scan) {
  const int col_blocks = (p.U + 7) / 8;  // column blocks of the widest warp column
  return p.R <= 0 || p.Tn <= 0 || (scan ? p.N != 0 : p.N <= 0) || p.H <= 0 || p.S <= 0 ||
         p.G <= 0 || p.U <= 0 || p.U % 4 != 0 || p.rows <= 0 || p.chunk <= 0 ||
         p.chunk % 16 != 0 || (long long)p.S * p.U < p.H || (long long)(p.S - 1) * p.U >= p.H ||
         (long long)p.G * p.rows < p.R || (long long)(p.G - 1) * p.rows >= p.R ||
         p.chunk > kMaxChunk || col_blocks > 8 || p.chunk / 16 * col_blocks > kAccBlocks ||
         p.chunk * p.U > kThreads * kCellSlots ||
         p.smem_bytes() > (size_t)kSmemLimit;
}

// ---------------------------------------------------------------------------
// K2p and K3p: one direction over a hoisted projection; K4p and K6p: the
// same walks that also store the backward's residuals.
//
// Replace urgent2026_challenge_track1_tpu/ops/pallas_lstm.py: lstm_scan_pallas
// (body _body; K2, forward or reverse) and _lean_forward_revmasked (body
// _lean_fwd_revmasked_body; K3, the reverse walk whose carried h and c are
// multiplied by m = (t < lengths[r]) after each step), _train_forward (body
// _train_fwd_body; K4, K2 that stores the residuals) and
// _train_forward_revmasked (body _train_fwd_revmasked_body; K6, K3 that
// stores them) for bfloat16 and (below) float32 inputs, beside the walks in
// lstm_kernels.cu (recurrence_kernel), which keep every shape without a
// plan (float32 at H = 1020).
// Each step computes
//   gates = x_proj_t + round_bf16(h_{t-1}) W_hh^T     (f32 sums)
//   c = f c + i g,  h = o tanh(c)                     (f32 cell)
// and writes the unmasked h (bf16) to out (R, T, H).
//
// What bounded the walk: every block re-read W_hh (1.2 MB at H = 392) from L2
// on every step for at most 8 rows on CUDA cores: 21.8 ms for 401 steps of 34
// rows, against an arithmetic bound of 0.017 ms.
//
// Design: K1p's (above) for one direction and without the W_ih segment.  One
// cooperative grid of G x S CTAs; CTA (g, s) keeps its Kh x 4U slice of
// W_hh^T (ops/cuda_lstm.pack_scan_weights) in shared memory for the whole
// walk and owns units [s U, min((s + 1) U, H)) for the rows of group g.  h
// is exchanged through out with L2-only copies, the per-group counter is the
// step barrier (bounded spin).  The projection does not depend on h, so a
// chunk's four U-wide column segments of x_proj for the next (step, chunk)
// are copied asynchronously into the other half of a double buffer before
// the wait, and land during it.  K3p: out holds the unmasked h, so a reader
// stages zeros for rows whose previous step t + 1 >= lengths[r], and the
// owner of c stores 0 after a step t >= lengths[r]; out then equals the
// plain version's at every step, padded ones included.  The floor is
// latency: T dependent steps, each at least one barrier round trip through
// L2.
//
// K2p with a carry (the streaming step's time path, ops/lstm.py:87-111's
// _scan_dir with initial_state and return_state): step 0 stages h0 (R, H),
// which is an input and so needs no wait, into the A buffer and multiplies
// it as a later step multiplies the h it reads back from out; c starts
// from c0 wherever the plan keeps it (shared memory or the global c
// buffer); the CTA that owns each cell writes the last step's h (the value
// it stores to out) to hT and its c to cT.  The plan depends on R and H
// only, so chunks of a stream run the arithmetic of one offline walk.  With
// the four pointers null the walk is the one without a carry.
//
// K4p / K6p (STORE): each cell also writes its post-activation gates i, f, g,
// o to gates (R, T, 4H) at q H + u and its c to c_res (R, T, H), bf16, the
// layout of _train_fwd_body (pallas_lstm.py:359-381).  K6p stores the
// unmasked c of the step, as _train_fwd_revmasked_body does, not the masked
// value it carries.  Nothing reads the residuals during the walk, so the
// last chunk of a step keeps them in registers and stores them after the
// arrive, where they overlap the next barrier wait (faster than storing them
// before it at 10 of 13 shape pairs, PERF.md).  Bytes rise from (4H + H) to
// (4H + 6H) bf16 a (row, step); the floor stays the barrier.
//
// K2p-K6p in float32 (T = float: K2p-f32, K3p-f32, K4p-f32, K6p-f32; _body,
// _lean_fwd_revmasked_body and the training bodies with f32 inputs, where h
// is not rounded before the product): the same walk, barrier, mask, carry
// (h0 and hT f32) and residual stores with every element f32, and the
// product h W_hh^T on the tensor cores as three TF32 products of split
// operands (3xTF32, above).  The walk they replace (recurrence_kernel in
// f32) re-read all of W_hh^T (2.4 MB at H = 392, 9.4 MB at H = 768) every
// step for a few rows on CUDA cores.  The slice (Kh x (4U + 8) f32), the
// staged h (chunk x (Kh + 4) f32) and the projection's double buffer
// double in shared memory, so the planner takes narrower chunks at the
// band paths and at H = 768 (ops/cuda_lstm.plan_persistent with elem = 4:
// 16-row chunks, three a step at the flow validation's 96 rows); h is
// staged with 16-byte L2-only copies of 4 f32 where H is a multiple of 4
// and plain L2 loads otherwise.  What bounds it: as in bf16 the barrier
// per step, plus three products and the splits, and twice the staged bytes
// per chunk.
// ---------------------------------------------------------------------------

template <typename T>
struct ScanArgs {
  const T* xp;         // (R, T, 4H) the hoisted projection, biases included
  const T* w;          // (S, Kh, 4U) packed W_hh^T slices
  const int* lengths;  // (R,) for K3p
  T* out;              // (R, T, H)
  float* c_global;     // (R, H) when !c_in_smem
  int* counters;       // (G) zeros
  Plan p;              // N = 0, kx = 0
  T* gates;            // (R, T, 4H) post-activation gates, K4p/K6p only
  T* c_res;            // (R, T, H) the unmasked c, K4p/K6p only
  // K2p's carry (null: start from zeros, write no final state)
  const T* h0;         // (R, H) step 0's h_{t-1}
  const float* c0;     // (R, H) step 0's c
  T* hT;               // (R, H) the last step's h
  float* cT;           // (R, H) the last step's c
};

// Copy the four nu-wide column segments q H + [u0, u0 + nu) of rows rows of
// the projection (row stride lds) into dst (row r at r 4U, segment q at q
// U) in asynchronous copies of BYTES; no wait.
template <int BYTES, typename T>
__device__ __forceinline__ void async_segments(T* dst, int U, const T* src, size_t lds, int H,
                                               int rows, int nu) {
  constexpr int E = BYTES / sizeof(T);
  const int per_seg = nu / E;
  const int per_row = 4 * per_seg;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int j = i - r * per_row;
    const int q = j / per_seg;
    const int v = j - q * per_seg;
    cp_async<BYTES, false>(dst + r * 4 * U + q * U + v * E, src + r * lds + q * H + v * E);
  }
}

// The segments' copy: 16-, 8- or 4-byte asynchronous copies where every
// address allows them, else plain 2-byte loads (bf16, H odd).  The copies
// land at the caller's next cp.async.wait_all.
template <typename T>
__device__ __forceinline__ void stage_segments(T* dst, int U, const T* src, size_t lds, int H,
                                               int rows, int nu) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) | (lds * sizeof(T)) |
                        (H * sizeof(T)) | (nu * sizeof(T)) | (U * sizeof(T));
  if ((mis & 15) == 0) {
    async_segments<16>(dst, U, src, lds, H, rows, nu);
  } else if ((mis & 7) == 0) {
    async_segments<8>(dst, U, src, lds, H, rows, nu);
  } else if ((mis & 3) == 0) {
    async_segments<4>(dst, U, src, lds, H, rows, nu);
  } else {
    const Bits<T>* in = reinterpret_cast<const Bits<T>*>(src);
    Bits<T>* o = reinterpret_cast<Bits<T>*>(dst);
    for (int i = threadIdx.x; i < rows * 4 * nu; i += kThreads) {
      const int r = i / (4 * nu);
      const int j = i - r * 4 * nu;
      const int q = j / nu;
      const int k = j - q * nu;
      o[r * 4 * U + q * U + k] = __ldg(in + r * lds + q * H + k);
    }
  }
}

// T = bf16: K2p, K3p, K4p, K6p; T = float: their float32 routes (K2p-f32,
// K3p-f32, K4p-f32, K6p-f32), the same walk with f32 exchange, carry,
// residuals and projection and 3xTF32 products.
template <typename T, bool REVERSE, bool MASKED, bool STORE>
__global__ void __launch_bounds__(kThreads, 1) scan_persistent_kernel(const ScanArgs<T> a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kAcc = kF32 ? kAccBlocksTf32 : kAccBlocks;
  constexpr int kSlots = kF32 ? kCellSlotsF32 : kCellSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan p = a.p;
  const int s = blockIdx.x, g = blockIdx.y;
  const int U = p.U, C = p.cols(), H = p.H;
  const int ldw = p.ldw(), lda = p.lda(), ldc = p.ldc();
  T* w_s = reinterpret_cast<T*>(smem);
  T* a_s = w_s + (size_t)p.kh * ldw;
  float* acc_s = reinterpret_cast<float*>(a_s + (size_t)p.chunk * lda);
  T* x_s = reinterpret_cast<T*>(acc_s + (size_t)p.chunk * ldc);  // 2 x chunk x 4U
  float* c_s = reinterpret_cast<float*>(x_s + 2 * (size_t)p.chunk * C);

  const int r_begin = g * p.rows;
  const int r_count = min(p.rows, p.R - r_begin);
  const int u0 = s * U;
  const int nu = min(U, H - u0);
  const size_t G4 = 4 * (size_t)H;
  int* counter = a.counters + g;
  float* cb = p.c_in_smem ? c_s : a.c_global + (size_t)r_begin * H + u0;
  const size_t cld = p.c_in_smem ? (size_t)U : (size_t)H;
  const int* len = MASKED ? a.lengths + r_begin : nullptr;  // the group's lengths

  // the weight slice (16-byte vectors; 4U elements are a multiple of 16
  // bytes), a zero A buffer and a zero c
  constexpr int V = 16 / sizeof(T);
  const T* wg = a.w + (size_t)s * p.kh * C;
  const int vpr = C / V;
  for (int i = threadIdx.x; i < p.kh * vpr; i += kThreads) {
    const int k = i / vpr;
    const int v = i - k * vpr;
    *reinterpret_cast<uint4*>(w_s + (size_t)k * ldw + v * V) =
        __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * C + v * V));
  }
  for (int i = threadIdx.x; i < p.chunk * lda; i += kThreads) a_s[i] = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < r_count * U; i += kThreads) {
    const int row = i / U;
    const int ul = i - row * U;
    if (ul < nu)
      cb[row * cld + ul] =
          a.c0 != nullptr ? __ldg(a.c0 + (size_t)(r_begin + row) * H + u0 + ul) : 0.f;
  }
  // the projection's segments of the first (step, chunk)
  auto x_src = [&](int step, int r0) {
    const int t = REVERSE ? p.Tn - 1 - step : step;
    return a.xp + ((size_t)(r_begin + r0) * p.Tn + t) * G4 + u0;
  };
  stage_segments(x_s, U, x_src(0, 0), p.Tn * G4, H, min(p.chunk, r_count), nu);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int ng = warp % kNGroups;
  const int kg = warp / kNGroups;
  const int nb = (C / 8 - ng + kNGroups - 1) / kNGroups;  // column blocks ng, ng + 4, ...
  int cell_row[kSlots], cell_ul[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = threadIdx.x + j * kThreads;
    cell_row[j] = i / U;
    cell_ul[j] = i - cell_row[j] * U;
    if (cell_ul[j] >= nu) cell_row[j] = p.chunk;
  }
  [[maybe_unused]] T res[kSlots][5];  // K4p/K6p: this thread's cells' residuals
  int buf = 0;
  for (int step = 0; step < p.Tn; ++step) {
    const int t = REVERSE ? p.Tn - 1 - step : step;
    const int tp = REVERSE ? t + 1 : t - 1;
    for (int r0 = 0; r0 < r_count; r0 += p.chunk) {
      const int rows = min(p.chunk, r_count - r0);
      const int mt = (rows + 15) / 16;
      const size_t rg = (size_t)(r_begin + r0);
      // the other half of x_s was read by the previous chunk's cells
      if (r0 > 0) __syncthreads();
      // the next (step, chunk)'s projection: in flight during the wait
      const bool last_chunk = r0 + p.chunk >= r_count;
      if (!last_chunk || step + 1 < p.Tn) {
        const int nr0 = last_chunk ? 0 : r0 + p.chunk;
        stage_segments(x_s + (size_t)(buf ^ 1) * p.chunk * C, U,
                       x_src(last_chunk ? step + 1 : step, nr0), p.Tn * G4, H,
                       min(p.chunk, r_count - nr0), nu);
      }
      float acc[kAcc][4] = {};
      float c_reg[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        c_reg[j] = cell_row[j] < rows ? cb[(size_t)(r0 + cell_row[j]) * cld + cell_ul[j]] : 0.f;
      }
      if (step > 0) {
        if (r0 == 0) wait_for(counter, p.S * step);
        // h_{t-1} from out, zero where the previous step was padded (K3p)
        stage<true>(a_s, lda, a.out + (rg * p.Tn + tp) * H, p.Tn * (size_t)H, rows, H, p.kh,
                    RowMask{MASKED ? len + r0 : nullptr, tp});
        __syncthreads();
        mma_segment(acc, a_s, lda, w_s, ldw, p.kh, mt, nb, ng, kg);
      } else if (a.h0 != nullptr) {
        // K2p's carry: step 0's h_{t-1} is an input, staged and multiplied
        // as a published step would be, so no wait
        stage<true>(a_s, lda, a.h0 + rg * H, (size_t)H, rows, H, p.kh);
        __syncthreads();
        mma_segment(acc, a_s, lda, w_s, ldw, p.kh, mt, nb, ng, kg);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // the prefetch has landed
      reduce_blocks(acc, acc_s, ldc, mt, nb, ng, kg);

      const T* xs = x_s + (size_t)buf * p.chunk * C;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int row = cell_row[j];
        const int ul = cell_ul[j];
        if (row >= rows) continue;
        const float* pre = acc_s + row * ldc + ul;
        const T* x = xs + row * C + ul;
        const float ig = sigmoid_f(pre[0] + to_f32(x[0]));
        const float fg = sigmoid_f(pre[U] + to_f32(x[U]));
        const float gg = tanhf(pre[2 * U] + to_f32(x[2 * U]));
        const float og = sigmoid_f(pre[3 * U] + to_f32(x[3 * U]));
        const float c = fg * c_reg[j] + ig * gg;
        cb[(size_t)(r0 + row) * cld + ul] =
            (MASKED && t >= __ldg(len + r0 + row)) ? 0.f : c;
        const T hv = from_f32<T>(og * tanhf(c));
        a.out[((rg + row) * p.Tn + t) * H + u0 + ul] = hv;
        if (a.hT != nullptr && step == p.Tn - 1) {  // the owner hands on its cells
          a.hT[(rg + row) * H + u0 + ul] = hv;
          a.cT[(rg + row) * H + u0 + ul] = c;
        }
        if constexpr (STORE) {  // the unmasked c, not cb's
          res[j][0] = from_f32<T>(ig);
          res[j][1] = from_f32<T>(fg);
          res[j][2] = from_f32<T>(gg);
          res[j][3] = from_f32<T>(og);
          res[j][4] = from_f32<T>(c);
        }
      }
      if constexpr (STORE) {
        if (!last_chunk)
          store_residuals(a.gates, a.c_res, p.Tn, H, res, cell_row, cell_ul, rg, rows, t, u0);
      }
      buf ^= 1;
    }
    // arrive: every h of this step is stored before the counter moves
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1);
    }
    if constexpr (STORE) {  // the last chunk's residuals, during the next wait
      const int r_last = (r_count - 1) / p.chunk * p.chunk;
      store_residuals(a.gates, a.c_res, p.Tn, H, res, cell_row, cell_ul,
                      (size_t)(r_begin + r_last), r_count - r_last, t, u0);
    }
  }
}

// Launch K1p (dirs = 2) or, store, K8p (dirs = 1) over the plan a.p: one
// cooperative grid of dim3(S, G, dirs) CTAs; T = float: K1p-f32 (dirs = 2,
// or 1 for the direction a.reverse) and K8p-f32.
template <typename T>
int launch_fusedin(const Args<T>& a, int dirs, bool store, void* stream) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  const Plan& p = a.p;
  const int col_blocks = (p.U + 7) / 8;
  // K8p walks one direction, bf16 K1p two, K1p-f32 one or two
  const bool dirs_ok = store ? dirs == 1 : kF32 ? (dirs == 1 || dirs == 2) : dirs == 2;
  if (!dirs_ok || bad_plan(p, false) || (!p.c_in_smem && a.c_global == nullptr) ||
      (store && (a.gates == nullptr || a.c_res == nullptr)) ||
      (kF32 && (p.chunk / 16 * col_blocks > kAccBlocksTf32 ||
                p.chunk * p.U > kThreads * kCellSlotsF32)))
    return (int)cudaErrorInvalidValue;
  const void* kernel = store ? reinterpret_cast<const void*>(fusedin_persistent_kernel<T, true>)
                             : reinterpret_cast<const void*>(fusedin_persistent_kernel<T, false>);
  const size_t smem = p.smem_bytes();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    void* params[] = {const_cast<Args<T>*>(&a)};
    e = cudaLaunchCooperativeKernel(kernel, dim3(p.S, p.G, dirs), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  }
  if (e != cudaSuccess) cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

Plan fusedin_plan(int R, int Tn, int N, int H, int S, int G, int U, int rows, int chunk,
                  int c_in_smem, int elem) {
  Plan p{};
  p.R = R;
  p.Tn = Tn;
  p.N = N;
  p.H = H;
  p.S = S;
  p.G = G;
  p.U = U;
  p.rows = rows;
  p.chunk = chunk;
  p.c_in_smem = c_in_smem;
  p.kx = (N + 15) / 16 * 16;
  p.kh = (H + 15) / 16 * 16;
  p.elem = elem;
  return p;
}

// The arguments of a K1p / K8p launch with elements T.
template <typename T>
Args<T> fusedin_args(const void* x, const void* w, const void* bias, void* out, void* gates,
                     void* c_res, void* c_global, void* counters, const Plan& p, int reverse) {
  return Args<T>{static_cast<const T*>(x), static_cast<const T*>(w),
                 static_cast<const T*>(bias), static_cast<T*>(out),
                 static_cast<float*>(c_global), static_cast<int*>(counters), p, reverse != 0,
                 static_cast<T*>(gates), static_cast<T*>(c_res)};
}

}  // namespace

extern "C" {

// The per-phase cycle sums of the last launch, (CTA, phase) into host;
// cudaErrorNotSupported unless built with -DK1P_PHASE_CLOCKS.
int lstm_persistent_phase_cycles(long long* host, int ctas) {
#ifdef K1P_PHASE_CLOCKS
  if (ctas > kMaxCtas) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, phase_cycles, sizeof(long long) * kPhases * ctas);
#else
  (void)host;
  (void)ctas;
  return (int)cudaErrorNotSupported;
#endif
}

// Shared-memory bytes of one CTA of a plan (the planner's reckoning, for a
// check from Python): K1p's and K8p's for N > 0, K2p-K6p's for N = 0, with
// elements of elem bytes (2: bf16; 4: f32).
long long lstm_persistent_smem(int N, int H, int U, int rows, int chunk, int c_in_smem,
                               int elem) {
  if (elem != 2 && elem != 4) return -1;
  Plan p{};
  p.N = N;
  p.H = H;
  p.U = U;
  p.rows = rows;
  p.chunk = chunk;
  p.c_in_smem = c_in_smem;
  p.kx = (N + 15) / 16 * 16;
  p.kh = (H + 15) / 16 * 16;
  p.elem = elem;
  return (long long)p.smem_bytes();
}

// K1p: x (R, T, N) bf16, the packed weights (2, S, Kx + Kh, 4U) and bias
// (2, S, 4U) bf16 -> out (R, T, 2H) bf16; c_global (R, 2, H) f32 scratch
// unless c_in_smem; counters (2, G) int32 zeros; dirs = 2.  elem = 4:
// K1p-f32, every one of these f32, and dirs = 2 or 1: then the one
// direction reverse (0 forward, 1 backward) from its own packed weights and
// bias (1, S, ...) into its half of out, with c_global (R, 1, H) and
// counters (1, G).  Returns the cudaError_t of the cooperative launch:
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident,
// cudaErrorInvalidValue for a plan that does not cover the rows and units
// exactly once or does not fit.
int lstm_fusedin_persistent(const void* x, const void* w, const void* bias, void* out,
                            void* c_global, void* counters, int R, int Tn, int N, int H, int S,
                            int G, int U, int rows, int chunk, int c_in_smem, int dirs,
                            int reverse, int elem, void* stream) {
  const Plan p = fusedin_plan(R, Tn, N, H, S, G, U, rows, chunk, c_in_smem, elem);
  if (elem == 4)
    return launch_fusedin(fusedin_args<float>(x, w, bias, out, nullptr, nullptr, c_global,
                                              counters, p, reverse),
                          dirs, false, stream);
  if (elem != 2) return (int)cudaErrorInvalidValue;
  return launch_fusedin(
      fusedin_args<bf16>(x, w, bias, out, nullptr, nullptr, c_global, counters, p, 0), dirs,
      false, stream);
}

// K8p: x (R, T, N) bf16, the packed weights (1, S, Kx + Kh, 4U) and bias
// (1, S, 4U) bf16 -> out (R, T, H), gates (R, T, 4H) and c_res (R, T, H)
// bf16, one walk forward (reverse = 0) or reverse; c_global (R, H) f32
// scratch unless c_in_smem; counters (G) int32 zeros; elem = 4: K8p-f32,
// every one of these f32.  Returns the cudaError_t of the cooperative
// launch, as lstm_fusedin_persistent.
int lstm_streamin_persistent(const void* x, const void* w, const void* bias, void* out,
                             void* gates, void* c_res, void* c_global, void* counters, int R,
                             int Tn, int N, int H, int reverse, int S, int G, int U, int rows,
                             int chunk, int c_in_smem, int elem, void* stream) {
  const Plan p = fusedin_plan(R, Tn, N, H, S, G, U, rows, chunk, c_in_smem, elem);
  if (elem == 4)
    return launch_fusedin(
        fusedin_args<float>(x, w, bias, out, gates, c_res, c_global, counters, p, reverse), 1,
        true, stream);
  if (elem != 2) return (int)cudaErrorInvalidValue;
  return launch_fusedin(
      fusedin_args<bf16>(x, w, bias, out, gates, c_res, c_global, counters, p, reverse), 1, true,
      stream);
}

// K2p (lengths == nullptr; forward, or reverse) and K3p (lengths (R,) int32,
// reverse only): xp (R, T, 4H) bf16, the packed W_hh^T (S, Kh, 4U) bf16 ->
// out (R, T, H) bf16; K4p / K6p the same with gates (R, T, 4H) and c_res
// (R, T, H) (both null for K2p / K3p), and, elem = 4, every one of these
// f32 (K2p-f32 - K6p-f32); K2p's carry: h0 (R, H) in the element type and
// c0 (R, H) f32, both or neither, the state before step 0, and hT, cT (the
// same), both or neither, the last step's (null for K3p-K6p); c_global
// (R, H) f32 scratch unless c_in_smem; counters (G) int32 zeros.  Returns the cudaError_t of
// the cooperative launch, as lstm_fusedin_persistent.
int lstm_scan_persistent(const void* xp, const void* w, const void* lengths, void* out,
                         void* gates, void* c_res, const void* h0, const void* c0, void* hT,
                         void* cT, void* c_global, void* counters, int R, int Tn, int H,
                         int reverse, int S, int G, int U, int rows, int chunk, int c_in_smem,
                         int elem, void* stream) {
  Plan p{};
  p.R = R;
  p.Tn = Tn;
  p.N = 0;
  p.H = H;
  p.S = S;
  p.G = G;
  p.U = U;
  p.rows = rows;
  p.chunk = chunk;
  p.c_in_smem = c_in_smem;
  p.kx = 0;
  p.kh = (H + 15) / 16 * 16;
  p.elem = elem;
  const bool masked = lengths != nullptr, store = gates != nullptr;
  const bool carry = h0 != nullptr || hT != nullptr;
  const int col_blocks = (U + 7) / 8;
  if ((h0 == nullptr) != (c0 == nullptr) || (hT == nullptr) != (cT == nullptr) ||
      (carry && (masked || store)) ||
      (elem != 2 && elem != 4) || bad_plan(p, true) || (!c_in_smem && c_global == nullptr) ||
      (masked && !reverse) || store != (c_res != nullptr) ||
      (elem == 4 && (chunk / 16 * col_blocks > kAccBlocksTf32 ||
                     chunk * U > kThreads * kCellSlotsF32)))
    return (int)cudaErrorInvalidValue;
  const int dir = masked ? 2 : reverse ? 1 : 0;  // forward, reverse, masked reverse
  const void* kernel;
  void* params[1];
  ScanArgs<bf16> ab{static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
                    static_cast<const int*>(lengths), static_cast<bf16*>(out),
                    static_cast<float*>(c_global), static_cast<int*>(counters), p,
                    static_cast<bf16*>(gates), static_cast<bf16*>(c_res),
                    static_cast<const bf16*>(h0), static_cast<const float*>(c0),
                    static_cast<bf16*>(hT), static_cast<float*>(cT)};
  ScanArgs<float> af{static_cast<const float*>(xp), static_cast<const float*>(w),
                     static_cast<const int*>(lengths), static_cast<float*>(out),
                     static_cast<float*>(c_global), static_cast<int*>(counters), p,
                     static_cast<float*>(gates), static_cast<float*>(c_res),
                     static_cast<const float*>(h0), static_cast<const float*>(c0),
                     static_cast<float*>(hT), static_cast<float*>(cT)};
  if (elem == 4) {
    // [store][forward, reverse, masked reverse]: K2p-f32, K3p-f32; K4p-f32, K6p-f32
    const void* kernels[2][3] = {
        {reinterpret_cast<const void*>(scan_persistent_kernel<float, false, false, false>),
         reinterpret_cast<const void*>(scan_persistent_kernel<float, true, false, false>),
         reinterpret_cast<const void*>(scan_persistent_kernel<float, true, true, false>)},
        {reinterpret_cast<const void*>(scan_persistent_kernel<float, false, false, true>),
         reinterpret_cast<const void*>(scan_persistent_kernel<float, true, false, true>),
         reinterpret_cast<const void*>(scan_persistent_kernel<float, true, true, true>)}};
    kernel = kernels[store][dir];
    params[0] = &af;
  } else {
    // [store][forward, reverse, masked reverse]
    const void* kernels[2][3] = {
        {reinterpret_cast<const void*>(scan_persistent_kernel<bf16, false, false, false>),
         reinterpret_cast<const void*>(scan_persistent_kernel<bf16, true, false, false>),
         reinterpret_cast<const void*>(scan_persistent_kernel<bf16, true, true, false>)},
        {reinterpret_cast<const void*>(scan_persistent_kernel<bf16, false, false, true>),
         reinterpret_cast<const void*>(scan_persistent_kernel<bf16, true, false, true>),
         reinterpret_cast<const void*>(scan_persistent_kernel<bf16, true, true, true>)}};
    kernel = kernels[store][dir];
    params[0] = &ab;
  }
  const size_t smem = p.smem_bytes();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(S, G, 1), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

}  // extern "C"
