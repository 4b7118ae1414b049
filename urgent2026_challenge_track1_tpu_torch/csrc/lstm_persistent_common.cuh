// Shared pieces of the persistent kernels (csrc/lstm_persistent.cu: K1p,
// K8p, K2p-K6p; csrc/lstm_persistent_bwd.cu: K5p, K7p, K10p and their dW
// kernels): the launch constants, the step barrier, element conversions,
// asynchronous staging, the ldmatrix loads and the bf16 and TF32 mma.sync
// products.  Each source includes it into its own anonymous namespace, so
// the two compile in parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

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

// Calls OP(MT, NB) for the warp's (mt, nb); the planner keeps mt x nb within
// these cases.
#define K1P_SHAPES(OP)                                                                      \
  OP(1, 1) OP(1, 2) OP(1, 3) OP(1, 4) OP(1, 5) OP(1, 6) OP(1, 7) OP(1, 8) OP(2, 1) OP(2, 2) \
  OP(2, 3) OP(2, 4) OP(2, 5) OP(2, 6) OP(2, 7) OP(2, 8) OP(3, 1) OP(3, 2) OP(3, 3) OP(3, 4) \
  OP(3, 5) OP(4, 1) OP(4, 2) OP(4, 3) OP(4, 4)

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

}  // namespace
