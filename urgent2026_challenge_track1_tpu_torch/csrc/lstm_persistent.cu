// K1p: the fused-input bidirectional LSTM, K2p / K3p / K4p / K6p: one
// direction over a hoisted input projection, and K5p / K7p: the training
// backwards, as persistent, weight-stationary tensor-core recurrences for
// NVIDIA Hopper (sm_90a), bound with ctypes.  K1p first; K2p-K6p
// (scan_persistent_kernel, bf16, and for K4p/K6p also f32 on 3xTF32
// products) after it; K5p/K7p (bwd_persistent_kernel, bf16 and f32) and
// their dW kernels (dw_tc_kernel, dw_tf32_kernel) at the end of the
// namespace.
//
// Replaces urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:
// _fusedin_forward (body _fusedin_step) for bfloat16 inputs, beside K1's walk
// in lstm_kernels.cu (fusedin_kernel), which keeps float32 and every shape
// without a plan.  Each step computes, for both directions,
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The products of a chunk: the 16 x 8 output blocks (mt row blocks x 4U / 8
// column blocks) are split over kNGroups warp columns (column blocks
// ng, ng + 4, ...) and the K steps of each segment over kKGroups warp rows,
// whose partial sums are added in shared memory in a fixed order.  A warp
// holds mt x nb <= kAccBlocks accumulator blocks; mt <= 4, nb <= 8.
constexpr int kNGroups = 4;
constexpr int kKGroups = kWarps / kNGroups;
static_assert(kKGroups == 2, "reduce_blocks adds two warp rows");
constexpr int kAccBlocks = 16;
constexpr int kMaxChunk = 64;
constexpr int kCellSlots = 8;     // cells (row, unit) a thread updates per chunk
constexpr int kCellSlotsF32 = 4;  // and on the float32 route (registers for the f32 residuals)
constexpr int kSmemLimit = 232448;  // 227 KB of dynamic shared memory a block
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

// The partition of ops/cuda_lstm.PersistentPlan, and the shared-memory
// layout that follows from it (the planner reckons the same bytes).
struct Plan {
  int R, Tn, N, H;
  int S, G, U, rows;  // rows: rows per group
  int chunk;          // rows per chunk, a multiple of 16
  int c_in_smem;
  int kx, kh;         // K segments padded to 16
  int elem;           // bytes of an element: 2 (bf16) or 4 (f32, K4p/K6p only)
  __host__ __device__ int cols() const { return 4 * U; }
  __host__ __device__ int ldw() const { return 4 * U + 8; }  // elements
  // elements; a staged row is an odd multiple of 16 bytes
  __host__ __device__ int lda() const { return (kx > kh ? kx : kh) + 16 / elem; }
  __host__ __device__ int ldc() const { return 4 * U + 4; }  // f32
  // K1p (N > 0) keeps its bias (4U f32); K2p-K6p (N = 0) a double buffer
  // of the projection's 4U columns for a chunk (2 x chunk x 4U elements)
  __host__ __device__ size_t smem_bytes() const {
    const size_t e = elem;
    return e * (kx + kh) * ldw() + e * chunk * lda() + 4 * (size_t)chunk * ldc() +
           (N > 0 ? 4 * (size_t)cols() : e * 2 * chunk * cols()) +
           (c_in_smem ? 4 * (size_t)rows * U : 0);
  }
};

struct Args {
  const bf16* x;     // (R, T, N)
  const bf16* w;     // (2, S, kx + kh, 4U) packed [W_ih; W_hh] slices
  const bf16* bias;  // (2, S, 4U)
  bf16* out;         // (R, T, 2H)
  float* c_global;   // (R, 2, H) when !c_in_smem
  int* counters;     // (2, G) zeros
  Plan p;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + __expf(-x)); }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the group's counter reaches target (every CTA of the group has
// finished the previous step), then release the block.
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  if (threadIdx.x == 0) {
    const unsigned long long start = globaltimer();
    while (ld_acquire(counter) < target) {
      if (globaltimer() - start > kSpinTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// Conversions between an element type (bf16, or f32 on K4p/K6p's float32
// route) and the f32 of the cell.
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// The unsigned integer of an element's bits, for plain copies.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;

// One asynchronous copy of BYTES from global to shared memory: L2_ONLY
// (16 bytes) goes around L1 (cp.async.cg), else through it (cp.async.ca).
template <int BYTES, bool L2_ONLY>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (L2_ONLY) {
    static_assert(BYTES == 16, "cp.async.cg copies 16 bytes");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

// Rows that a masked stage leaves zero: row r of the staged block is
// dropped when step >= len[r] (K3p's h of a padded step).  len == nullptr
// keeps every row.
struct RowMask {
  const int* len;
  int step;
  __device__ __forceinline__ bool drops(int r) const {
    return len != nullptr && step >= __ldg(len + r);
  }
};

// Copy rows x n elements from src (row stride lds) to dst (row stride ldd)
// in asynchronous copies of BYTES (all in flight at once); rows the mask
// drops are written as zeros instead.
template <int BYTES, bool L2_ONLY, typename T>
__device__ __forceinline__ void async_rows(T* dst, int ldd, const T* src, size_t lds, int rows,
                                           int n, RowMask mask) {
  constexpr int E = BYTES / sizeof(T);
  const int per_row = n / E;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int v = i - r * per_row;
    if (mask.drops(r)) {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[r * ldd + v * E + e] = from_f32<T>(0.f);
    } else {
      cp_async<BYTES, L2_ONLY>(dst + r * ldd + v * E, src + r * lds + v * E);
    }
  }
}

// The same with plain loads, for rows whose addresses allow no 16-byte
// copies around L1 (h when H is not a multiple of 16 bytes) or no 4-byte
// copies.
template <bool L2_ONLY, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ldd, const T* src, size_t lds, int rows,
                                          int n, RowMask mask) {
  const Bits<T>* in = reinterpret_cast<const Bits<T>*>(src);
  Bits<T>* o = reinterpret_cast<Bits<T>*>(dst);
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    const int r = i / n;
    const int k = i - r * n;
    o[r * ldd + k] = mask.drops(r) ? 0
                     : L2_ONLY     ? __ldcg(in + r * lds + k)
                                   : __ldg(in + r * lds + k);
  }
}

// Stage rows x n of src into dst and zero its columns [n, npad) and the
// rows ``mask`` drops; returns when this thread's copies (and every other
// asynchronous copy it issued) have landed (a __syncthreads must follow),
// or, !WAIT, with the copies in flight (the caller commits and waits).
template <bool L2_ONLY, bool WAIT = true, typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, size_t lds, int rows, int n,
                                      int npad, RowMask mask = {nullptr, 0}) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) | (lds * sizeof(T)) | (n * sizeof(T));
  if ((mis & 15) == 0) {
    async_rows<16, L2_ONLY>(dst, ldd, src, lds, rows, n, mask);
  } else if (!L2_ONLY && (mis & 7) == 0) {
    async_rows<8, false>(dst, ldd, src, lds, rows, n, mask);
  } else if (!L2_ONLY && (mis & 3) == 0) {
    async_rows<4, false>(dst, ldd, src, lds, rows, n, mask);
  } else {
    copy_rows<L2_ONLY>(dst, ldd, src, lds, rows, n, mask);
  }
  const int pad = npad - n;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * ldd + n + (i - r * pad)] = from_f32<T>(0.f);
  }
  if constexpr (WAIT) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A 16 x 16 bf16 block of a row-major matrix in shared memory as the A
// operand of mma.m16n8k16 (lane l gives the address of row l % 16, column
// block l / 16).
__device__ __forceinline__ void load_a(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// A 16 x 8 bf16 block of a row-major K x N matrix in shared memory as the B
// operand (lanes 0-15 give the addresses of rows k .. k + 15).
__device__ __forceinline__ void load_b(unsigned (&b)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// d += a b on the tensor cores: 16 x 16 bf16 times 16 x 8 bf16, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// Calls OP(MT, NB) for the warp's (mt, nb); the planner keeps mt x nb within
// these cases.
#define K1P_SHAPES(OP)                                                                      \
  OP(1, 1) OP(1, 2) OP(1, 3) OP(1, 4) OP(1, 5) OP(1, 6) OP(1, 7) OP(1, 8) OP(2, 1) OP(2, 2) \
  OP(2, 3) OP(2, 4) OP(2, 5) OP(2, 6) OP(2, 7) OP(2, 8) OP(3, 1) OP(3, 2) OP(3, 3) OP(3, 4) \
  OP(3, 5) OP(4, 1) OP(4, 2) OP(4, 3) OP(4, 4)

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

// ---------------------------------------------------------------------------
// Float32 products, 3xTF32 on the tensor cores (K4p/K6p's float32 route).
//
// mma.sync has no f32 x f32 product.  Each f32 operand x is split into its
// TF32 head hi and the TF32 head lo of the rest (split_tf32);
// a b is then a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped lo lo term is
// below 2^-20 |a b|), summed in f32, the small terms apart: f32's accuracy
// (~1e-6 relative) at three TF32 products, where one TF32 product keeps
// about three decimal digits: over the train steps' few hundred steps it
// moves the outputs by 2e-5 to 8e-5, which persistent_checks.F32_LIMIT
// (1e-5) refuses (PERF.md).  The operands are split in registers, per fragment:
// hi and lo of the resident slice would double it, and fit beside one chunk
// at none of the train steps' plans (PERF.md).  A warp holds at most
// kAccBlocksTf32 accumulator blocks (the planner keeps to that), which
// leaves registers for the hi and lo fragments.
// ---------------------------------------------------------------------------

constexpr int kAccBlocksTf32 = 8;
#define TF32_SHAPES(OP)                                                                     \
  OP(1, 1) OP(1, 2) OP(1, 3) OP(1, 4) OP(1, 5) OP(1, 6) OP(1, 7) OP(1, 8) OP(2, 1) OP(2, 2) \
  OP(2, 3) OP(2, 4) OP(3, 1) OP(3, 2) OP(4, 1) OP(4, 2)

// x = hi + lo + r, |r| < 2^-20 |x|: hi is x with its low 13 mantissa bits
// cleared (a TF32 value), lo the rest, exact in f32, cleared the same way.
// Two integer ops and a subtraction: a split by two cvt.rna.tf32.f32 ran
// longer on an H100 at equal error (PERF.md).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b on the tensor cores: 16 x 8 TF32 times 8 x 8 TF32, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_blocks for f32 operands: k8 steps of three TF32 products, the small
// terms (lo hi, hi lo) summed apart and added to the big one's sum at the
// end of the warp's K range.  The A
// fragment comes from ldmatrix as for bf16 (an 8 x 8 b16 block is 8 x 4
// f32, and lane l gets the f32 at row l / 4, column l % 4: the m16n8k8 TF32
// layout); the B fragment, W (k + l % 4, n + l / 4) and (k + 4 + l % 4, ...),
// from two plain loads (b_base: this lane's element of the warp's first
// column block at k = 0; ldw = 4U + 8 is 8 or 24 modulo 32, so the 32 lanes
// hit 32 banks).
template <int MT, int NB>
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
      const float* b = b_base + (size_t)k * ldw + j * kNGroups * 8;
      split_tf32(b[0], bh[j][0], bl[j][0]);
      split_tf32(b[4 * ldw], bh[j][1], bl[j][1]);
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

__global__ void __launch_bounds__(kThreads, 1) fusedin_persistent_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan p = a.p;
  const int s = blockIdx.x, g = blockIdx.y, d = blockIdx.z;
  const int U = p.U, C = p.cols(), H = p.H;
  const int ldw = p.ldw(), lda = p.lda(), ldc = p.ldc();
  const int Kp = p.kx + p.kh;
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* a_s = w_s + (size_t)Kp * ldw;
  float* acc_s = reinterpret_cast<float*>(a_s + (size_t)p.chunk * lda);
  float* b_s = acc_s + (size_t)p.chunk * ldc;
  float* c_s = b_s + C;

  const int r_begin = g * p.rows;
  const int r_count = min(p.rows, p.R - r_begin);
  const int u0 = s * U;
  const int nu = min(U, H - u0);
  const size_t ld_out = 2 * (size_t)H;
  int* counter = a.counters + d * p.G + g;
  // c of (row in group, unit in slice): shared memory or the global buffer
  float* cb = p.c_in_smem ? c_s : a.c_global + ((size_t)r_begin * 2 + d) * H + u0;
  const size_t cld = p.c_in_smem ? (size_t)U : ld_out;

  // the weight slice (16-byte vectors; 4U is a multiple of 16), the bias,
  // a zero A buffer and a zero c
  const bf16* wg = a.w + (size_t)(d * p.S + s) * Kp * C;
  const int vpr = C / 8;
  for (int i = threadIdx.x; i < Kp * vpr; i += kThreads) {
    const int k = i / vpr;
    const int v = i - k * vpr;
    *reinterpret_cast<uint4*>(w_s + (size_t)k * ldw + v * 8) =
        __ldg(reinterpret_cast<const uint4*>(wg + (size_t)k * C + v * 8));
  }
  for (int j = threadIdx.x; j < C; j += kThreads)
    b_s[j] = __bfloat162float(a.bias[(size_t)(d * p.S + s) * C + j]);
  for (int i = threadIdx.x; i < p.chunk * lda; i += kThreads) a_s[i] = __float2bfloat16(0.f);
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
  int cell_row[kCellSlots], cell_ul[kCellSlots];
#pragma unroll
  for (int j = 0; j < kCellSlots; ++j) {
    const int i = threadIdx.x + j * kThreads;
    cell_row[j] = i / U;
    cell_ul[j] = i - cell_row[j] * U;
    if (cell_ul[j] >= nu) cell_row[j] = p.chunk;
  }
#ifdef K1P_PHASE_CLOCKS
  long long cycles[kPhases] = {}, last = clock64();
#endif
  for (int step = 0; step < p.Tn; ++step) {
    const int t = d ? p.Tn - 1 - step : step;
    const int tp = d ? t + 1 : t - 1;
    for (int r0 = 0; r0 < r_count; r0 += p.chunk) {
      const int rows = min(p.chunk, r_count - r0);
      const int mt = (rows + 15) / 16;
      const size_t rg = (size_t)(r_begin + r0);
      float acc[kAccBlocks][4] = {};
      // the chunk's c, loaded now: its latency hides behind the products
      float c_reg[kCellSlots];
#pragma unroll
      for (int j = 0; j < kCellSlots; ++j) {
        c_reg[j] = cell_row[j] < rows ? cb[(size_t)(r0 + cell_row[j]) * cld + cell_ul[j]] : 0.f;
      }
      K1P_MARK(0)

      // x_t W_ih: independent of h, so the first chunk's runs before the wait
      stage<false>(a_s, lda, a.x + (rg * p.Tn + t) * p.N, (size_t)p.Tn * p.N, rows, p.N, p.kx);
      __syncthreads();
      K1P_MARK(1)
      mma_segment(acc, a_s, lda, w_s, ldw, p.kx, mt, nb, ng, kg);
      __syncthreads();  // a_s is free
      K1P_MARK(2)
      if (step > 0) {
        if (r0 == 0) wait_for(counter, p.S * step);
        K1P_MARK(3)
        stage<true>(a_s, lda, a.out + (rg * p.Tn + tp) * ld_out + (size_t)d * H, p.Tn * ld_out,
                    rows, H, p.kh);
        __syncthreads();
        K1P_MARK(4)
        mma_segment(acc, a_s, lda, w_s + (size_t)p.kx * ldw, ldw, p.kh, mt, nb, ng, kg);
        K1P_MARK(5)
      }
      // acc_s: the chunk's pre-activations (without b)
      reduce_blocks(acc, acc_s, ldc, mt, nb, ng, kg);
      K1P_MARK(6)

#pragma unroll
      for (int j = 0; j < kCellSlots; ++j) {
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
        a.out[((rg + row) * p.Tn + t) * ld_out + (size_t)d * H + u0 + ul] =
            __float2bfloat16(og * tanhf(c));
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
// stores them) for bfloat16 inputs, and K4 and K6 also for float32 inputs
// (below), beside the walks in lstm_kernels.cu (recurrence_kernel), which
// keep float32 K2 and K3 and every shape without a plan.
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
// buffer); the CTA that owns each cell writes the last step's h (the bf16
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
// K4p / K6p in float32 (T = float; _train_fwd_body with f32 inputs, where h
// is not rounded before the product): the same walk, barrier, mask and
// residual stores with every element f32, and the product h W_hh^T on the
// tensor cores as three TF32 products of split operands (3xTF32, above).
// The slice (Kh x (4U + 8) f32), the staged h (chunk x (Kh + 4) f32) and
// the projection's double buffer double in shared memory, so the planner
// takes narrower chunks at the band paths (ops/cuda_lstm.plan_persistent
// with elem = 4); h is staged with 16-byte L2-only copies of 4 f32 where H
// is a multiple of 4 and plain L2 loads otherwise.  What bounds it: as in
// bf16 the barrier per step, plus three products and the splits, and twice
// the staged bytes per chunk.
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

// K4p/K6p: the residuals of a thread's cells of one chunk (i, f, g, o, c per
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

// T = bf16: K2p, K3p, K4p, K6p; T = float (STORE only): K4p and K6p's
// float32 route, the same walk with f32 exchange, residuals and projection
// and 3xTF32 products.
template <typename T, bool REVERSE, bool MASKED, bool STORE>
__global__ void __launch_bounds__(kThreads, 1) scan_persistent_kernel(const ScanArgs<T> a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  static_assert(!kF32 || STORE, "the float32 route is K4p/K6p's");
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

// T = bf16: K5p, K7p; T = float: their float32 route, the same walk with
// f32 exchange, cell inputs and dx_proj and 3xTF32 products.
template <typename T, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1) bwd_persistent_kernel(const BwdArgs<T> a) {
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
// check from Python): K1p's for N > 0, K2p-K6p's for N = 0, with elements
// of elem bytes (2: bf16; 4: f32, N = 0 only).
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
// unless c_in_smem; counters (2, G) int32 zeros.  Returns the cudaError_t of
// the cooperative launch: cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident, cudaErrorInvalidValue for a plan that does not
// cover the rows and units exactly once or does not fit.
int lstm_fusedin_persistent(const void* x, const void* w, const void* bias, void* out,
                            void* c_global, void* counters, int R, int Tn, int N, int H, int S,
                            int G, int U, int rows, int chunk, int c_in_smem, void* stream) {
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
         static_cast<const bf16*>(bias), static_cast<bf16*>(out),
         static_cast<float*>(c_global), static_cast<int*>(counters), Plan{}};
  Plan& p = a.p;
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
  p.elem = 2;
  if (bad_plan(p, false) || (!c_in_smem && c_global == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = p.smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(fusedin_persistent_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fusedin_persistent_kernel),
                                    dim3(S, G, 2), dim3(kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  }
  if (e != cudaSuccess) cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

// K2p (lengths == nullptr; forward, or reverse) and K3p (lengths (R,) int32,
// reverse only): xp (R, T, 4H) bf16, the packed W_hh^T (S, Kh, 4U) bf16 ->
// out (R, T, H) bf16; K4p / K6p the same with gates (R, T, 4H) and c_res
// (R, T, H) (both null for K2p / K3p), and, elem = 4, every one of these
// f32 (K4p / K6p only); K2p's carry: h0 (R, H) bf16 and c0 (R, H) f32, both
// or neither, the state before step 0, and hT, cT (the same), both or
// neither, the last step's (null for K3p-K6p); c_global (R, H) f32 scratch
// unless c_in_smem; counters (G) int32 zeros.  Returns the cudaError_t of
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
      (masked && !reverse) || store != (c_res != nullptr) || (elem == 4 && !store) ||
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
                     static_cast<float*>(gates), static_cast<float*>(c_res), nullptr, nullptr,
                     nullptr, nullptr};
  if (elem == 4) {
    const void* kernels[3] = {
        reinterpret_cast<const void*>(scan_persistent_kernel<float, false, false, true>),
        reinterpret_cast<const void*>(scan_persistent_kernel<float, true, false, true>),
        reinterpret_cast<const void*>(scan_persistent_kernel<float, true, true, true>)};
    kernel = kernels[dir];
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
  const bool masked = lengths != nullptr;
  if (bad_bwd_plan(p) || (!dc_in_smem && dc_global == nullptr) || (masked && !reverse))
    return (int)cudaErrorInvalidValue;
  BwdArgs<bf16> ab{static_cast<const bf16*>(gates), static_cast<const bf16*>(c),
                   static_cast<const bf16*>(dout),  static_cast<const bf16*>(w),
                   static_cast<const int*>(lengths), static_cast<bf16*>(dxp),
                   static_cast<float*>(dc_global), static_cast<int*>(counters), reverse, p};
  BwdArgs<float> af{static_cast<const float*>(gates), static_cast<const float*>(c),
                    static_cast<const float*>(dout),  static_cast<const float*>(w),
                    static_cast<const int*>(lengths), static_cast<float*>(dxp),
                    static_cast<float*>(dc_global), static_cast<int*>(counters), reverse, p};
  // [f32][masked]
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(bwd_persistent_kernel<bf16, false>),
       reinterpret_cast<const void*>(bwd_persistent_kernel<bf16, true>)},
      {reinterpret_cast<const void*>(bwd_persistent_kernel<float, false>),
       reinterpret_cast<const void*>(bwd_persistent_kernel<float, true>)}};
  const void* kernel = kernels[elem == 4][masked];
  void* params[] = {elem == 4 ? static_cast<void*>(&af) : static_cast<void*>(&ab)};
  const size_t smem = p.smem_bytes();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(S, G, 1), dim3(kThreads), params, smem,
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
