// K5p / K7p: the training backwards, and K10p: both directions' backward
// in one grid, as persistent, weight-stationary tensor-core reverse walks
// for NVIDIA Hopper (sm_90a), and their dW kernels (dw_tc_kernel,
// dw_tf32_kernel, which K10p launches once per direction), bound with ctypes.
// The forward kernels are in lstm_persistent.cu; the pieces both use in
// lstm_persistent_common.cuh.

#include "lstm_persistent_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5p and K7p: the training backwards as persistent, weight-stationary
// tensor-core reverse walks, and their dW kernel.
//
// Replace urgent2026_challenge_track1_tpu/ops/pallas_lstm.py: _lstm_train_bwd
// (body _train_bwd_body; K5, the backward of K4, walked in the reverse of the
// scan's order) and _revmasked_bwd (body _train_bwd_revmasked_body; K7, the
// backward of K6: t = 0 .. T - 1, the carried dh and dc multiplied by m_t =
// (t < lengths[r])) for bfloat16 and float32 residuals, beside the walks in
// lstm_kernels.cu (backward_kernel, dw_kernel), which keep every shape
// without a plan.  Each step computes, for the state that entered step
// t from tp (the scan's previous step),
//   dh = dout_t + dh_s (m_t),  dc = dc_s (m_t) + dh o (1 - tanh^2 c)
//   dgates = [dc g i (1 - i), dc c_prev f (1 - f), dc i (1 - g^2),
//             dh tanh(c) o (1 - o)],  c_prev = c[tp] (m_tp)
//   dx_proj_t = round_bf16(dgates),  dh_s = dx_proj_t W_hh (4H x H, f32 sums),
//   dc_s = dc f
// and after the walk dW_hh^T = sum over (r, t) of h_prev^T dx_proj_t (f32),
// h_prev = h[tp] (zero where tp is outside [0, T) or, K7, padded).
//
// What bounded the walk: every block re-read all of W_hh (1.2 MB at H = 392,
// 4.7 MB at H = 768) from L2 on every step for at most 8 rows on CUDA cores,
// and dw_kernel summed the dW product (34-114 GFLOP of bf16 work at the
// train shapes) in an f32 FMA tile loop on CUDA cores.
//
// Design (ops/cuda_lstm.plan_backward picks the numbers):
//   * one cooperative grid of G x S CTAs, one per SM; CTA (g, s) owns units
//     [s U, min((s + 1) U, H)) for the rows of group g.  The cell backward of
//     a unit needs only its own four gate columns, c_prev, dout, dh and dc,
//     so dc stays with its owner (shared memory, or a global (R, H) f32
//     buffer), as c does in K2p;
//   * the CTA keeps rows [s U, s U + U) of W_hh^T (U x 4H bf16: the dh
//     product's B operand in its N x K layout, packed by
//     ops/cuda_lstm.pack_backward_weights) resident in shared memory;
//   * the exchange buffer is dx_proj: the dgates rounded to bf16 are what
//     the product multiplies.  A step waits on the group's counter, stages
//     the group's rows of dx_proj[:, te, 0:4H] (te: the step visited before)
//     with L2-only copies one K tile at a time, double-buffered, and
//     multiplies them by the slice with mma.sync m16n8k16 (bf16, f32 sums).
//     With U = 4-40 a chunk has 1-5 column blocks against 49-192 k16 steps,
//     so K is split over the eight warps (k16 step j of a tile to warp
//     j % 8) and the cell adds the eight partial sums in warp order: a
//     launch is deterministic;
//   * the cell's inputs of the next (step, chunk) (the CTA's 4U gate
//     columns, c_prev and dout) are copied into the other half of a double
//     buffer before the wait and land during it;
//   * K7p (MASKED): t = 0 .. T - 1; the owner multiplies the product dh_s
//     and dc by m_t and c_prev by m_{t+1}, as _train_bwd_revmasked_body
//     does (m_t after the product, so non-finite dgates of a padded step
//     give what JAX gives; staging zeros for those rows instead cost 20 %
//     more at 136 x 201, PERF.md); dx_proj is written at every step, padded
//     ones too.
// What bounds it: T dependent steps, each at least one barrier round trip
// through L2, and the staging of the group's 4H dgate columns from L2 each
// step (4x K4p's exchange bytes for the same products).
//
// The dW kernel (dw_tc_kernel): one CTA per 128 x 128 tile of dW^T (H x 4H)
// walks K = R T in 64-row stages (a three-stage cp.async ring) and sums on
// the tensor cores (ldmatrix.trans of h_prev and dx_proj, mma.sync, f32);
// its loader reads h with the scan's shift and K7's mask.  Where the tiles
// leave the card's CTA slots idle, K is cut into up to four parts written to
// a workspace and added in part order (dw_sum_kernel): deterministic.
//
// K5p / K7p in float32 (T = float; _train_bwd_body with f32 residuals, where
// dg_c = dgates.astype(f32) rounds nothing): the same walk, barrier, mask
// and dc with f32 cell inputs and dx_proj (the exchange, staged with 16-byte
// L2-only copies: a row of 4H f32 always allows them; the cell inputs in
// 16-, 8- or 4-byte copies as H allows), and the dh product as three TF32
// products of split operands (3xTF32, as K4p-f32's): k8 steps, step j of a
// tile to warp j % 8, partial sums added in warp order.  The slice (up x (kp
// + 4) f32), the staged dgates and the cell inputs double in shared memory,
// so the planner (elem = 4) takes narrower chunks and K tiles; at H = 768
// one slice of 8 units already takes 98.6 KB, so S = 96 CTAs share one
// group and each stages the group's whole 4H-wide dgates row a chunk.
// What bounds it: as in bf16 the barrier per step and the staging of the
// dgates from L2 (twice the bytes), plus three products and the splits.
// Its dW kernel (dw_tf32_kernel) sums the f32 product as 3xTF32 over
// dw_tc_kernel's tiles, loader and split.
//
// K10p (bwd2_persistent_kernel, bf16 and f32) replaces
// urgent2026_challenge_track1_tpu/ops/pallas_lstm.py: _lstm_train_bwd2
// (kernel _train_bwd2_kernel; K10, K5 for both directions in one launch)
// beside K10's walk in lstm_kernels.cu (backward_kernel with grid.y the
// direction, then dw_kernel), which keeps every shape without a plan.  The
// walk re-read W_hh from L2 every step for at most 8 rows on CUDA cores:
// 64-87x its bound (PERF.md).  Design: one cooperative grid of 2 x G x S
// CTAs, blockIdx.z the direction, each direction K5p's walk (above) with
// its own pointers and counters (ops/cuda_lstm.plan_backward with dirs = 2
// gives each direction half the SMs, and keeps dc in global memory where
// that leaves room for fewer K tiles); then K5p's dW kernel once per
// direction (dw_tc_kernel, dw_tf32_kernel).  What bounds it: K5p's
// barrier and dgates staging per step, the two directions side by side, each
// CTA walking about twice K5p's chunks a step.
// ---------------------------------------------------------------------------

constexpr int kBwdAccBlocks = 16;  // a warp's 16 x 8 accumulators: row blocks x column blocks

// The partition of ops/cuda_lstm.BackwardPlan and its shared-memory layout
// (the planner reckons the same bytes).
struct BwdPlan {
  int R, Tn, H;
  int S, G, U, rows;  // rows: rows per group
  int chunk;          // rows per chunk, a multiple of 16
  int kt;             // K tile of the staged dgates, a multiple of 16
  int dc_in_smem;
  int elem;           // bytes of an element: 2 (bf16) or 4 (f32)
  __host__ __device__ int kp() const { return (4 * H + 15) / 16 * 16; }
  __host__ __device__ int up() const { return (U + 7) / 8 * 8; }
  // elements; a slice row and a staged row are odd multiples of 16 bytes
  __host__ __device__ int ldk() const { return kp() + 16 / elem; }  // slice rows
  __host__ __device__ int lda() const { return kt + 16 / elem; }    // staged dgates
  __host__ __device__ int ldx() const { return 6 * U; }             // cell inputs
  __host__ __device__ int ntiles() const { return (kp() + kt - 1) / kt; }
  __host__ __device__ int nbuf() const { return ntiles() > 1 ? 2 : 1; }
  // the slice (up x ldk), the staged dgates (nbuf x chunk x lda), the
  // warps' partial dh (8 x chunk x up f32), the cell inputs (2 x chunk x
  // 6U: gates, c_prev, dout), elements of elem bytes, and dc (rows x U f32)
  // when it fits
  __host__ __device__ size_t smem_bytes() const {
    const size_t e = elem;
    return e * up() * ldk() + e * nbuf() * chunk * lda() + 4 * (size_t)kWarps * chunk * up() +
           e * 2 * chunk * ldx() + (dc_in_smem ? 4 * (size_t)rows * U : 0);
  }
};

template <typename T>
struct BwdArgs {
  const T* gates;      // (R, T, 4H) post-activation gates i, f, g, o
  const T* c;          // (R, T, H) the unmasked c of each step
  const T* dout;       // (R, T, H) incoming dh
  const T* w;          // (S, up, kp) packed rows of W_hh^T
  const int* lengths;  // (R,) K7p only
  T* dxp;              // (R, T, 4H) dx_proj, the exchange buffer
  float* dc_global;    // (R, H) when !dc_in_smem
  int* counters;       // (G) zeros
  int reverse;
  BwdPlan p;
};

// A 16 x 8 bf16 block of an N x K row-major matrix in shared memory as the B
// operand (its rows are B's columns): lanes 0-7 give the addresses of rows
// n .. n + 7 at column k, lanes 8-15 at column k + 8.  Of f32 rows (lanes
// 8-15 at column k + 4) it is the 8 x 8 TF32 B operand: lane l gets the f32
// at row n + l / 4, column k + l % 4 (+ 4).
__device__ __forceinline__ void load_b_nk(unsigned (&b)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// A 16 x 16 bf16 block of the A operand from a K x M row-major matrix in
// shared memory (A's transpose): lane l gives the address of row k + (l / 16)
// 8 + l % 8, column m + (l / 8 % 2) 8.
__device__ __forceinline__ void load_a_trans(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// rows x n elements of src (row stride lds) into dst (row stride ldd) in
// asynchronous copies of BYTES; no wait.
template <int BYTES, typename T>
__device__ __forceinline__ void async_cols_v(T* dst, int ldd, const T* src, size_t lds, int rows,
                                             int n) {
  constexpr int E = BYTES / sizeof(T);
  const int per_row = n / E;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int v = i - r * per_row;
    cp_async<BYTES, false>(dst + r * ldd + v * E, src + r * lds + v * E);
  }
}

// The same with the widest copies every address allows (they land at the
// caller's next wait), else plain 2-byte loads (bf16 at odd offsets; f32
// rows always allow 4-byte copies).
template <typename T>
__device__ __forceinline__ void async_cols(T* dst, int ldd, const T* src, size_t lds, int rows,
                                           int n) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) | smem_addr(dst) |
                        (lds * sizeof(T)) | (ldd * sizeof(T)) | (n * sizeof(T));
  if ((mis & 15) == 0) {
    async_cols_v<16>(dst, ldd, src, lds, rows, n);
  } else if ((mis & 7) == 0) {
    async_cols_v<8>(dst, ldd, src, lds, rows, n);
  } else if ((mis & 3) == 0) {
    async_cols_v<4>(dst, ldd, src, lds, rows, n);
  } else {
    const Bits<T>* in = reinterpret_cast<const Bits<T>*>(src);
    Bits<T>* o = reinterpret_cast<Bits<T>*>(dst);
    for (int i = threadIdx.x; i < rows * n; i += kThreads) {
      const int r = i / n;
      const int k = i - r * n;
      o[r * ldd + k] = __ldg(in + r * lds + k);
    }
  }
}

// acc[m * NB + j] += the staged dgates (row block m) times the slice (column
// block j) over this warp's k16 steps of a tile, ``steps`` of them, 8 k16
// steps apart; a_base / b_base: this lane's ldmatrix addresses at the warp's
// first step.
template <int MT, int NB>
__device__ __forceinline__ void bwd_mma(float (&acc)[kBwdAccBlocks][4], unsigned a_base,
                                        unsigned b_base, int steps, unsigned lda_bytes,
                                        unsigned ldk_bytes) {
  constexpr unsigned kStep = kWarps * 16 * sizeof(bf16);
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    unsigned a[MT][4], b[NB][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) load_a(a[m], a_base + m * 16 * lda_bytes + i * kStep);
#pragma unroll
    for (int j = 0; j < NB; ++j) load_b_nk(b[j], b_base + j * 8 * ldk_bytes + i * kStep);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_bf16(acc[m * NB + j], a[m], b[j]);
    }
  }
}

// bwd_mma for f32 operands (K5p-f32 / K7p-f32): k8 steps, 8 apart, of three
// TF32 products of split operands, the small terms (lo hi, hi lo) summed
// apart and added to the big one's sum at the end of the tile, as in
// mma_blocks_tf32.  A (the staged dgates) and B (the slice's N x K rows) both
// by ldmatrix: an 8 x 8 b16 block is 8 x 4 f32, the m16n8k8 TF32 layout of
// either operand.  Both are split in registers, per fragment.
template <int MT, int NB>
__device__ __forceinline__ void bwd_mma_tf32(float (&acc)[kAccBlocksTf32][4], unsigned a_base,
                                             unsigned b_base, int steps, unsigned lda_bytes,
                                             unsigned ldk_bytes) {
  constexpr unsigned kStep = kWarps * 8 * sizeof(float);
  float small[MT * NB][4] = {};
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    unsigned ah[MT][4], al[MT][4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      unsigned raw[4];
      load_a(raw, a_base + m * 16 * lda_bytes + i * kStep);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(raw[q]), ah[m][q], al[m][q]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      unsigned raw[2];
      load_b_nk(raw, b_base + j * 8 * ldk_bytes + i * kStep);
      split_tf32(__uint_as_float(raw[0]), bh[j][0], bl[j][0]);
      split_tf32(__uint_as_float(raw[1]), bh[j][1], bl[j][1]);
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
    for (int q = 0; q < 4; ++q) acc[b][q] += small[b][q];
  }
}

// The warp's accumulator blocks into its partial buffer (chunk x up f32; the
// m16n8 layout: rows l / 4 and l / 4 + 8, columns 2 (l % 4) and + 1).
template <int MT, int NB, int NACC>
__device__ __forceinline__ void bwd_put(const float (&acc)[NACC][4], float* part, int up,
                                        int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float* o = part + (m * 16 + lane / 4) * up + j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(o) = make_float2(acc[m * NB + j][0], acc[m * NB + j][1]);
      *reinterpret_cast<float2*>(o + 8 * up) = make_float2(acc[m * NB + j][2], acc[m * NB + j][3]);
    }
  }
}

// acc += this warp's K steps (warp, warp + 8, ...) of one K tile: the staged
// dgates a_s (chunk x kw, row stride lda) times the slice's columns [k0, k0
// + kw) (w_s, row stride ldk); k16 steps of bf16 products, or k8 steps of
// 3xTF32 products (T = float).
template <typename T, int NACC>
__device__ __forceinline__ void bwd_tile(float (&acc)[NACC][4], const T* a_s, int lda,
                                         const T* w_s, int ldk, int k0, int kw, int mt, int nb,
                                         int warp, int lane) {
  constexpr int KS = 32 / sizeof(T);  // the depth of one product: 16 bf16, 8 TF32
  constexpr int B8 = 16 / sizeof(T);  // the elements of an 8 x 8 b16 block's row
  const int steps = (kw / KS - warp + kWarps - 1) / kWarps;
  if (steps <= 0) return;
  const unsigned a_base = smem_addr(a_s + (lane % 16) * lda + (lane / 16) * B8 + warp * KS);
  const unsigned b_base =
      smem_addr(w_s + (lane % 8) * ldk + k0 + (lane / 8 % 2) * B8 + warp * KS);
  const unsigned lda_bytes = sizeof(T) * lda, ldk_bytes = sizeof(T) * ldk;
  if constexpr (std::is_same_v<T, float>) {
#define BWD_MMA(M, N)                                                        \
  case M * 16 + N:                                                           \
    bwd_mma_tf32<M, N>(acc, a_base, b_base, steps, lda_bytes, ldk_bytes);    \
    break;
    switch (mt * 16 + nb) {
      TF32_SHAPES(BWD_MMA)
      default: break;
    }
#undef BWD_MMA
  } else {
#define BWD_MMA(M, N)                                                        \
  case M * 16 + N:                                                           \
    bwd_mma<M, N>(acc, a_base, b_base, steps, lda_bytes, ldk_bytes);         \
    break;
    switch (mt * 16 + nb) {
      K1P_SHAPES(BWD_MMA)
      default: break;
    }
#undef BWD_MMA
  }
}

template <int NACC>
__device__ __forceinline__ void bwd_partials(const float (&acc)[NACC][4], float* part, int up,
                                             int mt, int nb, int lane) {
#define BWD_PUT(M, N)                            \
  case M * 16 + N:                               \
    bwd_put<M, N>(acc, part, up, lane);          \
    break;
  if constexpr (NACC == kAccBlocksTf32) {
    switch (mt * 16 + nb) {
      TF32_SHAPES(BWD_PUT)
      default: break;
    }
  } else {
    switch (mt * 16 + nb) {
      K1P_SHAPES(BWD_PUT)
      default: break;
    }
  }
#undef BWD_PUT
}

// The walk of one direction's (g, s) CTA (blockIdx.x = s, blockIdx.y = g).
// T = bf16: K5p, K7p; T = float: their float32 route, the same walk with
// f32 exchange, cell inputs and dx_proj and 3xTF32 products.
template <typename T, bool MASKED>
__device__ __forceinline__ void bwd_walk(const BwdArgs<T>& a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kAcc = kF32 ? kAccBlocksTf32 : kBwdAccBlocks;
  constexpr int kSlots = kF32 ? kCellSlotsF32 : kCellSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdPlan p = a.p;
  const int s = blockIdx.x, g = blockIdx.y;
  const int U = p.U, H = p.H, up = p.up(), kp = p.kp();
  const int ldk = p.ldk(), lda = p.lda(), ldx = p.ldx();
  const int G4 = 4 * H;
  T* w_s = reinterpret_cast<T*>(smem);
  T* a_s = w_s + (size_t)up * ldk;
  float* part_s = reinterpret_cast<float*>(a_s + (size_t)p.nbuf() * p.chunk * lda);
  T* x_s = reinterpret_cast<T*>(part_s + (size_t)kWarps * p.chunk * up);
  float* dc_s = reinterpret_cast<float*>(x_s + 2 * (size_t)p.chunk * ldx);

  const int r_begin = g * p.rows;
  const int r_count = min(p.rows, p.R - r_begin);
  const int u0 = s * U;
  const int nu = min(U, H - u0);
  int* counter = a.counters + g;
  float* dcb = p.dc_in_smem ? dc_s : a.dc_global + (size_t)r_begin * H + u0;
  const size_t dcld = p.dc_in_smem ? (size_t)U : (size_t)H;
  const int* len = MASKED ? a.lengths + r_begin : nullptr;  // the group's lengths
  const bool rev = MASKED || a.reverse;  // visits t = 0 .. T - 1
  const size_t ldg4 = (size_t)p.Tn * G4, ldh = (size_t)p.Tn * H;

  // the weight slice (16-byte vectors; kp is a multiple of 16), zero dgate
  // buffers and a zero dc
  constexpr int V = 16 / sizeof(T);
  const T* wg = a.w + (size_t)s * up * kp;
  const int vpr = kp / V;
  for (int i = threadIdx.x; i < up * vpr; i += kThreads) {
    const int n = i / vpr;
    const int v = i - n * vpr;
    *reinterpret_cast<uint4*>(w_s + (size_t)n * ldk + v * V) =
        __ldg(reinterpret_cast<const uint4*>(wg + (size_t)n * kp + v * V));
  }
  for (int i = threadIdx.x; i < p.nbuf() * p.chunk * lda; i += kThreads)
    a_s[i] = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < r_count * U; i += kThreads) {
    const int row = i / U;
    const int ul = i - row * U;
    if (ul < nu) dcb[row * dcld + ul] = 0.f;
  }
  // the cell's inputs of (step, chunk r0): the CTA's four gate columns,
  // c_prev (none at the scan's first step) and dout, row r at r 6U
  auto fetch = [&](T* dst, int step, int r0) {
    const int t = rev ? step : p.Tn - 1 - step;
    const int tp = rev ? t + 1 : t - 1;
    const int n = min(p.chunk, r_count - r0);
    const size_t rt = (size_t)(r_begin + r0) * p.Tn;
    for (int q = 0; q < 4; ++q)
      async_cols(dst + q * U, ldx, a.gates + (rt + t) * G4 + q * H + u0, ldg4, n, nu);
    if (tp >= 0 && tp < p.Tn)
      async_cols(dst + 4 * U, ldx, a.c + (rt + tp) * H + u0, ldh, n, nu);
    async_cols(dst + 5 * U, ldx, a.dout + (rt + t) * H + u0, ldh, n, nu);
  };
  fetch(x_s, 0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = up / 8;
  const int ntiles = p.ntiles();
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
  int buf = 0;
  for (int step = 0; step < p.Tn; ++step) {
    const int t = rev ? step : p.Tn - 1 - step;
    const int te = rev ? t - 1 : t + 1;  // visited before: its dgates give dh
    const int tp = rev ? t + 1 : t - 1;  // the scan's previous step
    const bool has_prev = tp >= 0 && tp < p.Tn;
    for (int r0 = 0; r0 < r_count; r0 += p.chunk) {
      const int rows = min(p.chunk, r_count - r0);
      const int mt = (rows + 15) / 16;
      const size_t rg = (size_t)(r_begin + r0);
      // the previous chunk's cells read x_s[buf ^ 1] and part_s
      if (r0 > 0) __syncthreads();
      // the next (step, chunk)'s cell inputs: in flight during the wait
      const bool last_chunk = r0 + p.chunk >= r_count;
      if (!last_chunk || step + 1 < p.Tn)
        fetch(x_s + (size_t)(buf ^ 1) * p.chunk * ldx, last_chunk ? step + 1 : step,
              last_chunk ? 0 : r0 + p.chunk);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float dc_reg[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        dc_reg[j] =
            cell_row[j] < rows ? dcb[(size_t)(r0 + cell_row[j]) * dcld + cell_ul[j]] : 0.f;
      }
      if (step > 0) {
        if (r0 == 0) wait_for(counter, p.S * step);
        // dh_s = dx_proj[:, te] W_hh, K tile by K tile (K7p's m_t is applied
        // by the cell, after the product, as _train_bwd_revmasked_body does)
        float acc[kAcc][4] = {};
        const T* src = a.dxp + (rg * p.Tn + te) * G4;
        auto stage_tile = [&](int k) {
          const int k0 = k * p.kt;
          const int kw = min(p.kt, kp - k0);
          stage<true, false>(a_s + (size_t)(k & 1) * p.chunk * lda, lda, src + k0, ldg4, rows,
                             max(0, min(kw, G4 - k0)), kw);
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        };
        stage_tile(0);
        for (int k = 0; k < ntiles; ++k) {
          if (k + 1 < ntiles) {
            stage_tile(k + 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          }
          __syncthreads();
          const int k0 = k * p.kt;
          bwd_tile(acc, a_s + (size_t)(k & 1) * p.chunk * lda, lda, w_s, ldk, k0,
                   min(p.kt, kp - k0), mt, nb, warp, lane);
          if (k + 1 < ntiles) __syncthreads();  // the buffer of tile k + 2
        }
        bwd_partials(acc, part_s + (size_t)warp * p.chunk * up, up, mt, nb, lane);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // the cell inputs have landed
      __syncthreads();

      const T* xs = x_s + (size_t)buf * p.chunk * ldx;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int row = cell_row[j];
        const int ul = cell_ul[j];
        if (row >= rows) continue;
        const T* x = xs + row * ldx + ul;
        const float ig = to_f32(x[0]);
        const float fg = to_f32(x[U]);
        const float gg = to_f32(x[2 * U]);
        const float og = to_f32(x[3 * U]);
        float m = 1.f, mp = 1.f;
        if constexpr (MASKED) {
          const int lr = __ldg(len + r0 + row);
          m = t < lr ? 1.f : 0.f;
          mp = tp < lr ? 1.f : 0.f;
        }
        const float cp = has_prev ? to_f32(x[4 * U]) * mp : 0.f;
        float dhs = 0.f;  // the eight warps' partial sums, in warp order
        if (step > 0) {
          const float* pp = part_s + (size_t)row * up + ul;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) dhs += pp[(size_t)w * p.chunk * up];
        }
        const float tc = tanhf(fg * cp + ig * gg);
        const float dhv = to_f32(x[5 * U]) + dhs * m;
        const float dcv = dc_reg[j] * m + dhv * og * (1.f - tc * tc);
        T* o = a.dxp + ((rg + row) * p.Tn + t) * G4 + u0 + ul;
        o[0] = from_f32<T>(dcv * gg * ig * (1.f - ig));
        o[H] = from_f32<T>(dcv * cp * fg * (1.f - fg));
        o[2 * H] = from_f32<T>(dcv * ig * (1.f - gg * gg));
        o[3 * H] = from_f32<T>(dhv * tc * og * (1.f - og));
        dcb[(size_t)(r0 + row) * dcld + ul] = dcv * fg;
      }
      buf ^= 1;
    }
    // arrive: every dgate of this step is stored before the counter moves
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1);
    }
  }
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1) bwd_persistent_kernel(const BwdArgs<T> a) {
  bwd_walk<T, MASKED>(a);
}

// K10p: K5p's walk for both directions in one grid, direction blockIdx.z
// (0: f, the forward scan's backward; 1: b, the reverse scan's), each with
// its own inputs, dx_proj, dc and counters.  Each z-slice is a K5p grid of
// the same plan running the same code, so K10p equals two K5p launches of
// that plan bit for bit.  The direction's arguments are picked once, by
// value, so the kernel holds one copy of the walk, not one per direction.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) bwd2_persistent_kernel(const BwdArgs<T> f,
                                                                      const BwdArgs<T> b) {
  const BwdArgs<T> a = blockIdx.z == 0 ? f : b;
  bwd_walk<T, false>(a);
}

bool bad_bwd_plan(const BwdPlan& p) {
  const int col_blocks = p.up() / 8;
  const bool f32 = p.elem == 4;
  return (p.elem != 2 && !f32) || p.R <= 0 || p.Tn <= 0 || p.H <= 0 || p.S <= 0 || p.G <= 0 ||
         p.U <= 0 || p.U % 4 != 0 || p.rows <= 0 || p.chunk <= 0 || p.chunk % 16 != 0 ||
         p.chunk > kMaxChunk || p.kt <= 0 || p.kt % 16 != 0 || (long long)p.S * p.U < p.H ||
         (long long)(p.S - 1) * p.U >= p.H || (long long)p.G * p.rows < p.R ||
         (long long)(p.G - 1) * p.rows >= p.R || col_blocks > 8 ||
         p.chunk / 16 * col_blocks > (f32 ? kAccBlocksTf32 : kBwdAccBlocks) ||
         p.chunk * p.U > kThreads * (f32 ? kCellSlotsF32 : kCellSlots) ||
         p.smem_bytes() > (size_t)kSmemLimit;
}

constexpr int kDwTile = 128;          // output rows (units) and columns (gate columns) of a CTA
constexpr int kDwK = 64;              // (row, step) pairs a stage holds
constexpr int kDwStages = 3;
constexpr int kDwLd = kDwTile + 8;    // row stride of a staged tile: bf16 an odd multiple of
                                      // 16 B, f32 8 modulo 32 words (conflict-free fragments)
constexpr size_t kDwSmem = 2 * (size_t)kDwStages * kDwK * kDwLd * sizeof(bf16);
// The float32 dW kernel's stages: 64 rows of f32 (three stages, 209 KB: one
// CTA a SM, which its 3xTF32 accumulators need for registers anyway)
constexpr size_t kDwSmemF32 = 2 * (size_t)kDwStages * kDwK * kDwLd * sizeof(float);

template <typename T>
struct DwArgs {
  const T* h;           // (R, T, H)
  const T* dxp;         // (R, T, 4H)
  const int* lengths;   // (R,) K7p's mask, or null
  float* out;           // (split, H, 4H): dW^T, or its parts
  int R, Tn, H, reverse;
  int kc;               // (row, step) pairs of a part, a multiple of kDwK (R T < 2^31)
};

// One stage: rows [k0, k0 + kDwK) of K (flat (r, t)) of h_prev, units [m0,
// m0 + 128), into As ([k][m]) and of dx_proj, columns [n0, n0 + 128), into
// Bs ([k][n]); 16-byte L2-only asynchronous copies where rows and addresses
// allow them (vec_h, vec_d; 2-8 % faster than copies through L1, which two
// bf16 CTAs' shared memory leave small), else plain loads; zeros past K, H,
// 4H and for h_prev rows outside the scan or padded.
template <typename T>
__device__ __forceinline__ void dw_load(T* As, T* Bs, const DwArgs<T>& a, int k0, int k_end,
                                        int m0, int n0, bool vec_h, bool vec_d) {
  constexpr int E = 16 / sizeof(T);  // elements of one 16-byte copy
  constexpr int kVec = kDwTile / E;
  const int G4 = 4 * a.H;
  for (int i = threadIdx.x; i < kDwK * kVec; i += kThreads) {
    const int kk = i / kVec;
    const int v = i - kk * kVec;
    const int n = k0 + kk;
    const T* hs = nullptr;
    const T* ds = nullptr;
    if (n < k_end) {
      const int r = n / a.Tn;
      const int t = n - r * a.Tn;
      const int tp = a.reverse ? t + 1 : t - 1;
      if (tp >= 0 && tp < a.Tn && (a.lengths == nullptr || tp < __ldg(a.lengths + r)))
        hs = a.h + ((size_t)r * a.Tn + tp) * a.H + m0 + v * E;
      ds = a.dxp + (size_t)n * G4 + n0 + v * E;
    }
    const int m = m0 + v * E, c = n0 + v * E;
    T* ha = As + kk * kDwLd + v * E;
    T* db = Bs + kk * kDwLd + v * E;
    if (hs != nullptr && vec_h && m + E <= a.H) {
      cp_async<16, true>(ha, hs);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        ha[e] = (hs != nullptr && m + e < a.H) ? hs[e] : from_f32<T>(0.f);
    }
    if (ds != nullptr && vec_d && c + E <= G4) {
      cp_async<16, true>(db, ds);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        db[e] = (ds != nullptr && c + e < G4) ? ds[e] : from_f32<T>(0.f);
    }
  }
}

// A warp's 64 x 32 block of dW^T (4 x 4 accumulator blocks, the m16n8
// layout) into part blockIdx.z of out, rows past H and columns past 4H
// dropped.
template <typename T>
__device__ __forceinline__ void dw_store(const float (&acc)[4][4][4], const DwArgs<T>& a, int wm,
                                         int wn, int m0, int n0, int lane) {
  const int G4 = 4 * a.H;
  float* out = a.out + (size_t)blockIdx.z * a.H * G4;
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = n0 + wn + nb * 8 + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mb * 16 + lane / 4 + 8 * half;
        if (row >= a.H) continue;
        if (col < G4) out[(size_t)row * G4 + col] = acc[mb][nb][2 * half];
        if (col + 1 < G4) out[(size_t)row * G4 + col + 1] = acc[mb][nb][2 * half + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) dw_tc_kernel(const DwArgs<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);         // kDwStages x kDwK x kDwLd
  bf16* Bs = As + (size_t)kDwStages * kDwK * kDwLd;  // the same
  const int m0 = blockIdx.y * kDwTile, n0 = blockIdx.x * kDwTile;
  const int G4 = 4 * a.H;
  const int K = a.R * a.Tn;
  const int k_begin = blockIdx.z * a.kc;
  const int k_end = min(K, k_begin + a.kc);
  const int nk = k_end > k_begin ? (k_end - k_begin + kDwK - 1) / kDwK : 0;
  const bool vec_h = a.H % 8 == 0 && (reinterpret_cast<uintptr_t>(a.h) & 15) == 0;
  const bool vec_d = G4 % 8 == 0 && (reinterpret_cast<uintptr_t>(a.dxp) & 15) == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;  // the warp's 64 x 32 block
  float acc[4][4][4] = {};

  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < nk)
      dw_load(As + (size_t)st * kDwK * kDwLd, Bs + (size_t)st * kDwK * kDwLd, a,
              k_begin + st * kDwK, k_end, m0, n0, vec_h, vec_d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0; i < nk; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDwStages - 2) : "memory");
    __syncthreads();
    const bf16* A = As + (size_t)(i % kDwStages) * kDwK * kDwLd;
    const bf16* B = Bs + (size_t)(i % kDwStages) * kDwK * kDwLd;
#pragma unroll
    for (int kk = 0; kk < kDwK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
        load_a_trans(af[mb], smem_addr(A + (kk + lane / 16 * 8 + lane % 8) * kDwLd + wm +
                                       mb * 16 + lane / 8 % 2 * 8));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        load_b(bfr[nb], smem_addr(B + (kk + lane % 16) * kDwLd + wn + nb * 8));
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[mb][nb], af[mb], bfr[nb]);
      }
    }
    const int next = i + kDwStages - 1;
    if (next < nk)
      dw_load(As + (size_t)(next % kDwStages) * kDwK * kDwLd,
              Bs + (size_t)(next % kDwStages) * kDwK * kDwLd, a,
              k_begin + next * kDwK, k_end, m0, n0, vec_h, vec_d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  dw_store(acc, a, wm, wn, m0, n0, lane);
}

// The float32 dW kernel (K5p-f32 / K7p-f32): dw_tc_kernel's tiles, split and
// loader over f32 operands, each product three TF32 products of split
// operands (3xTF32; the small terms summed apart and added at the end of the
// part).  ldmatrix .trans moves 16-bit elements only, so both fragments come
// from plain shared loads: A (h_prev^T) at (k + l % 4 (+ 4), m + l / 4 (+ 8))
// of the [k][m] stage, B at (k + l % 4 (+ 4), n + l / 4) of the [k][n] one;
// with a row stride of 8 modulo 32 words the 32 lanes hit 32 banks.  The
// tensor cores' f32 sums drift with the length of the chain they add to (on
// an H100, dW summed over a whole part left the float64 product in
// proportion to the part's rows, many times a CPU 3xTF32 sum's error), so
// the big products of each 64-row stage are summed on the tensor cores from
// zero and then added to the part's sum in f32 on the CUDA cores.  The
// three accumulator sets take the registers of a second CTA, so one CTA a
// SM, with three 64-row stages (209 KB) in its shared memory.
__global__ void __launch_bounds__(kThreads, 1) dw_tf32_kernel(const DwArgs<float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);         // kDwStages x kDwK x kDwLd
  float* Bs = As + (size_t)kDwStages * kDwK * kDwLd;  // the same
  const int m0 = blockIdx.y * kDwTile, n0 = blockIdx.x * kDwTile;
  const int K = a.R * a.Tn;
  const int k_begin = blockIdx.z * a.kc;
  const int k_end = min(K, k_begin + a.kc);
  const int nk = k_end > k_begin ? (k_end - k_begin + kDwK - 1) / kDwK : 0;
  const bool vec_h = a.H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.h) & 15) == 0;
  const bool vec_d = (reinterpret_cast<uintptr_t>(a.dxp) & 15) == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;  // the warp's 64 x 32 block
  // the part's sum (CUDA-core adds), a stage's big products (tensor cores,
  // from zero each stage) and the part's small terms
  float acc[4][4][4] = {}, stage[4][4][4], small[4][4][4] = {};

  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < nk)
      dw_load(As + (size_t)st * kDwK * kDwLd, Bs + (size_t)st * kDwK * kDwLd, a,
              k_begin + st * kDwK, k_end, m0, n0, vec_h, vec_d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0; i < nk; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDwStages - 2) : "memory");
    __syncthreads();
    // this lane's element of the warp's first blocks at k = 0
    const float* A = As + (size_t)(i % kDwStages) * kDwK * kDwLd + (lane % 4) * kDwLd + wm +
                     lane / 4;
    const float* B = Bs + (size_t)(i % kDwStages) * kDwK * kDwLd + (lane % 4) * kDwLd + wn +
                     lane / 4;
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int q = 0; q < 4; ++q) stage[mb][nb][q] = 0.f;
      }
    }
#pragma unroll 1
    for (int kk = 0; kk < kDwK; kk += 8) {
      unsigned ah[4][4], al[4][4], bh[4][2], bl[4][2];
      const float* ak = A + kk * kDwLd;
      const float* bk = B + kk * kDwLd;
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        split_tf32(ak[mb * 16], ah[mb][0], al[mb][0]);
        split_tf32(ak[mb * 16 + 8], ah[mb][1], al[mb][1]);
        split_tf32(ak[4 * kDwLd + mb * 16], ah[mb][2], al[mb][2]);
        split_tf32(ak[4 * kDwLd + mb * 16 + 8], ah[mb][3], al[mb][3]);
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        split_tf32(bk[nb * 8], bh[nb][0], bl[nb][0]);
        split_tf32(bk[4 * kDwLd + nb * 8], bh[nb][1], bl[nb][1]);
      }
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          mma_tf32(small[mb][nb], al[mb], bh[nb]);
          mma_tf32(small[mb][nb], ah[mb], bl[nb]);
          mma_tf32(stage[mb][nb], ah[mb], bh[nb]);
        }
      }
    }
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mb][nb][q] += stage[mb][nb][q];
      }
    }
    const int next = i + kDwStages - 1;
    if (next < nk)
      dw_load(As + (size_t)(next % kDwStages) * kDwK * kDwLd,
              Bs + (size_t)(next % kDwStages) * kDwK * kDwLd, a,
              k_begin + next * kDwK, k_end, m0, n0, vec_h, vec_d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][nb][q] += small[mb][nb][q];
    }
  }
  dw_store(acc, a, wm, wn, m0, n0, lane);
}

// dw = the sum of the split parts of dW^T, in part order.
__global__ void dw_sum_kernel(const float* __restrict__ parts, float* __restrict__ dw, size_t n,
                              int split) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = parts[i];
    for (int z = 1; z < split; ++z) v += parts[z * n + i];
    dw[i] = v;
  }
}

// The plan of a K5p/K7p/K10p launch.
BwdPlan bwd_plan(int R, int Tn, int H, int S, int G, int U, int rows, int chunk, int kt,
                 int dc_in_smem, int elem) {
  BwdPlan p{};
  p.R = R;
  p.Tn = Tn;
  p.H = H;
  p.S = S;
  p.G = G;
  p.U = U;
  p.rows = rows;
  p.chunk = chunk;
  p.kt = kt;
  p.dc_in_smem = dc_in_smem;
  p.elem = elem;
  return p;
}

// One direction's K5p/K7p/K10p arguments, elements of type T.
template <typename T>
BwdArgs<T> bwd_args(const void* gates, const void* c, const void* dout, const void* w,
                    const void* lengths, void* dxp, void* dc_global, void* counters, int reverse,
                    const BwdPlan& p) {
  return {static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<const T*>(dout),
          static_cast<const T*>(w),     static_cast<const int*>(lengths), static_cast<T*>(dxp),
          static_cast<float*>(dc_global), static_cast<int*>(counters), reverse, p};
}

}  // namespace

extern "C" {

// K5p/K7p's shared-memory bytes of one CTA with elements of elem bytes (2:
// bf16; 4: f32) (the planner's reckoning, for a check from Python).
long long lstm_persistent_bwd_smem(int H, int U, int rows, int chunk, int kt, int dc_in_smem,
                                   int elem) {
  if (elem != 2 && elem != 4) return -1;
  BwdPlan p{};
  p.H = H;
  p.U = U;
  p.rows = rows;
  p.chunk = chunk;
  p.kt = kt;
  p.dc_in_smem = dc_in_smem;
  p.elem = elem;
  return (long long)p.smem_bytes();
}

// K5p (lengths == nullptr; forward or reverse scan) and K7p (lengths (R,)
// int32, reverse only): gates (R, T, 4H), c, dout (R, T, H), the packed
// W_hh^T rows (S, up, kp) -> dxp (R, T, 4H), every one of these bf16 (elem
// = 2) or f32 (elem = 4: the float32 route); dc_global (R, H) f32 scratch
// unless dc_in_smem; counters (G) int32 zeros.  Returns the cudaError_t of
// the cooperative launch, as lstm_fusedin_persistent.
int lstm_bwd_persistent(const void* gates, const void* c, const void* dout, const void* w,
                        const void* lengths, void* dxp, void* dc_global, void* counters, int R,
                        int Tn, int H, int reverse, int S, int G, int U, int rows, int chunk,
                        int kt, int dc_in_smem, int elem, void* stream) {
  const BwdPlan p = bwd_plan(R, Tn, H, S, G, U, rows, chunk, kt, dc_in_smem, elem);
  const bool masked = lengths != nullptr;
  if (bad_bwd_plan(p) || (!dc_in_smem && dc_global == nullptr) || (masked && !reverse))
    return (int)cudaErrorInvalidValue;
  const BwdArgs<bf16> ab =
      bwd_args<bf16>(gates, c, dout, w, lengths, dxp, dc_global, counters, reverse, p);
  const BwdArgs<float> af =
      bwd_args<float>(gates, c, dout, w, lengths, dxp, dc_global, counters, reverse, p);
  // [f32][masked]
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(bwd_persistent_kernel<bf16, false>),
       reinterpret_cast<const void*>(bwd_persistent_kernel<bf16, true>)},
      {reinterpret_cast<const void*>(bwd_persistent_kernel<float, false>),
       reinterpret_cast<const void*>(bwd_persistent_kernel<float, true>)}};
  const void* kernel = kernels[elem == 4][masked];
  void* params[] = {elem == 4 ? const_cast<void*>(static_cast<const void*>(&af))
                              : const_cast<void*>(static_cast<const void*>(&ab))};
  const size_t smem = p.smem_bytes();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(S, G, 1), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

// K10p: per direction (f: the forward scan's backward, b: the reverse
// scan's) gates (R, T, 4H), c, dout (R, T, H) and the packed W_hh^T rows
// (S, up, kp) -> dxp (R, T, 4H), every one of these bf16 (elem = 2) or f32
// (elem = 4); dc_* (R, H) f32 scratch unless dc_in_smem; counters_* (G)
// int32 zeros.  One cooperative grid of dim3(S, G, 2).  Returns the
// cudaError_t of the launch, as lstm_fusedin_persistent.
int lstm_bwd2_persistent(const void* gates_f, const void* c_f, const void* dout_f, const void* w_f,
                         void* dxp_f, void* dc_f, void* counters_f, const void* gates_b,
                         const void* c_b, const void* dout_b, const void* w_b, void* dxp_b,
                         void* dc_b, void* counters_b, int R, int Tn, int H, int S, int G, int U,
                         int rows, int chunk, int kt, int dc_in_smem, int elem, void* stream) {
  const BwdPlan p = bwd_plan(R, Tn, H, S, G, U, rows, chunk, kt, dc_in_smem, elem);
  if (bad_bwd_plan(p) || (!dc_in_smem && (dc_f == nullptr || dc_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const BwdArgs<bf16> hf = bwd_args<bf16>(gates_f, c_f, dout_f, w_f, nullptr, dxp_f, dc_f,
                                          counters_f, 0, p);
  const BwdArgs<bf16> hb = bwd_args<bf16>(gates_b, c_b, dout_b, w_b, nullptr, dxp_b, dc_b,
                                          counters_b, 1, p);
  const BwdArgs<float> ff = bwd_args<float>(gates_f, c_f, dout_f, w_f, nullptr, dxp_f, dc_f,
                                            counters_f, 0, p);
  const BwdArgs<float> fb = bwd_args<float>(gates_b, c_b, dout_b, w_b, nullptr, dxp_b, dc_b,
                                            counters_b, 1, p);
  const bool f32 = elem == 4;
  const void* kernel = f32 ? reinterpret_cast<const void*>(bwd2_persistent_kernel<float>)
                           : reinterpret_cast<const void*>(bwd2_persistent_kernel<bf16>);
  void* params[] = {f32 ? const_cast<void*>(static_cast<const void*>(&ff))
                        : const_cast<void*>(static_cast<const void*>(&hf)),
                    f32 ? const_cast<void*>(static_cast<const void*>(&fb))
                        : const_cast<void*>(static_cast<const void*>(&hb))};
  const size_t smem = p.smem_bytes();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(S, G, 2), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

// The dW kernel of K5p/K7p: h (R, T, H), dxp (R, T, 4H) bf16 (elem = 2:
// dw_tc_kernel) or f32 (elem = 4: dw_tf32_kernel), lengths (R,) int32 or
// null (K7p's mask) -> dw (H, 4H) f32 = sum over (r, t) of h_prev^T dxp,
// K = R T in ``split`` parts (1-64); split > 1 writes the parts to ws
// (split, H, 4H) f32 and sums them in order into dw.  Returns the
// cudaError_t of the launches.
int lstm_bwd_dw(const void* h, const void* dxp, const void* lengths, void* dw, void* ws, int R,
                int Tn, int H, int reverse, int split, int elem, void* stream) {
  const long long K = (long long)R * Tn;
  if (R <= 0 || Tn <= 0 || H <= 0 || split < 1 || split > 64 || (split > 1 && ws == nullptr) ||
      K + kDwK >= (1ll << 31) || (elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  const int kc = (int)(((K + split - 1) / split + kDwK - 1) / kDwK * kDwK);
  float* out = static_cast<float*>(split > 1 ? ws : dw);
  const int* lens = static_cast<const int*>(lengths);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((4 * H + kDwTile - 1) / kDwTile, (H + kDwTile - 1) / kDwTile, split);
  cudaError_t e;
  if (elem == 4) {
    const DwArgs<float> a{static_cast<const float*>(h), static_cast<const float*>(dxp), lens,
                          out, R, Tn, H, reverse, kc};
    e = cudaFuncSetAttribute(dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDwSmemF32);
    if (e == cudaSuccess) {
      dw_tf32_kernel<<<grid, kThreads, kDwSmemF32, st>>>(a);
      e = cudaGetLastError();
    }
  } else {
    const DwArgs<bf16> a{static_cast<const bf16*>(h), static_cast<const bf16*>(dxp), lens, out,
                         R, Tn, H, reverse, kc};
    e = cudaFuncSetAttribute(dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDwSmem);
    if (e == cudaSuccess) {
      dw_tc_kernel<<<grid, kThreads, kDwSmem, st>>>(a);
      e = cudaGetLastError();
    }
  }
  if (e == cudaSuccess && split > 1) {
    const size_t n = (size_t)H * 4 * H;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
    dw_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), static_cast<float*>(dw),
                                          n, split);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // extern "C"
