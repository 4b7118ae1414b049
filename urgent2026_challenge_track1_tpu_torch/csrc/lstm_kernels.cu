// LSTM recurrence kernels for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Three kernels carry the BSRNN inference path, four more its training step,
// and three more the training step under the two experiment toggles of
// ops/cuda_lstm.py (STREAM_INPUT_TRAIN, FUSED_BIDIR_TRAIN):
//
//   K1 lstm_fusedin_bilstm
//      Replaces urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:
//      _fusedin_forward (body _fusedin_step).  Bidirectional LSTM on the raw
//      input x (R, T, N): every step computes x_t W_ih^T + h W_hh^T + b for
//      both directions; writes (R, T, 2H) with forward || backward in place.
//   K2 lstm_scan
//      Replaces pallas_lstm.py:lstm_scan_pallas (body _body).  One direction
//      over a hoisted input projection x_proj (R, T, 4H) that already holds
//      the biases; ``reverse`` walks t = T-1 .. 0.  With a carry (the
//      streaming step's scan, ops/lstm.py:87-111) it starts from (h0, c0)
//      and writes the last step's (hT, cT).
//   K3 lstm_revmasked
//      Replaces pallas_lstm.py:_lean_forward_revmasked (body
//      _lean_fwd_revmasked_body).  Reverse walk over x_proj (R, T, 4H) with
//      int32 lengths (R,): h is written unmasked at every t, then h and c
//      are zeroed wherever t >= len[r], so valid positions equal a fresh
//      reverse scan of the valid prefix.
//   K4 lstm_train_fwd
//      Replaces pallas_lstm.py:_train_forward (body _train_fwd_body).  K2
//      that also stores the residuals of the backward: the post-activation
//      gates i, f, g, o (R, T, 4H) and the cell state c (R, T, H), both in
//      the input type.
//   K5 lstm_train_bwd
//      Replaces pallas_lstm.py:_lstm_train_bwd (body _train_bwd_body).  Walks
//      K4's scan backwards from the stored gates, c and h and the incoming
//      dh: writes dx_proj (R, T, 4H) in the input type and dW_hh^T (H, 4H)
//      in float32.
//   K6 lstm_revmasked_train_fwd
//      Replaces pallas_lstm.py:_train_forward_revmasked (body
//      _train_fwd_revmasked_body).  K3 that also stores K4's residuals (h
//      and c unmasked, as the Pallas body stores them).
//   K7 lstm_revmasked_bwd
//      Replaces pallas_lstm.py:_revmasked_bwd (body
//      _train_bwd_revmasked_body).  K5 for K6's masked walk: the incoming
//      dh, dc are multiplied by m_t = (t < len), the stored c_prev and h_prev
//      by m_{t+1}.
//   K8 lstm_train_fwd_streamin
//      Replaces pallas_lstm.py:_train_forward_streamin (body
//      _train_fwd_streamin_body).  K4 with the input product moved into the
//      kernel: each step computes x_t W_ih^T + round(h) W_hh^T (both summed
//      in f32) + b (b rounded to the input type), from the raw x (R, T, N)
//      staged in shared memory; stores h, gates and c as K4.  K1's device
//      code, one direction, with the template flag STREAM.
//   K9 (pallas_lstm.py:_train_forward2, both directions of K4 in one
//      launch) has no launcher here: ops/cuda_lstm.py runs K4's route once a
//      direction for it.
//   K10 lstm_train_bwd2
//      Replaces pallas_lstm.py:_lstm_train_bwd2 (_train_bwd2_kernel).  K5 for
//      both directions: one backward-walk launch with grid.y = direction,
//      then one dW reduction launch with grid.z = direction; K5's device
//      code, so the outputs equal K5's per direction bit for bit.
//
// Numerics follow the Pallas bodies: gates i, f, g, o; h and c are f32;
// products accumulate in f32; h is rounded to the input type before the
// h W_hh^T product (pallas_lstm.py:56-58); outputs are stored in the input
// type.  Inputs and weights are float32 or bfloat16.
//
// What bounds these kernels on an H100: the recurrence is sequential in t,
// and each step is a thin (rows x H) x (H x 4H) product.  At the BSRNN
// widths (N = 196, H = 392; flow N = 384, H = 768) the bytes that must move
// are small next to the operations (each weight is reused by every row), so
// the bound is the tensor-core rate; what really limits this first design
// is latency and CUDA-core FMA issue: one step cannot start before the
// previous one ends.
//
// Design (simple and correct first):
//   * the time loop lives inside the block; blocks own disjoint tiles of
//     ROWS rows (grid.x), and K1 and K10 run both directions on grid.y;
//   * thread t owns hidden units t, t + blockDim, ... (U of them: U = 1 for
//     H <= 512, U = 2 for H <= 1024) of every row of its tile and computes
//     the four gate columns u, H+u, 2H+u, 3H+u of each, so the c/h update
//     needs no exchange between threads: c stays in registers, h (f32,
//     ROWS x H) stays in shared memory, and two __syncthreads() per step
//     separate the reads of h from its update;
//   * weights are read from global memory on every step (coalesced over u)
//     and stay resident in the 50 MB L2 (3.7 MB in bf16 at H = 392, 7.1 MB
//     at N = 384, H = 768);
//   * the ragged edges are not padded: a thread whose unit lies past H (H =
//     392 is no multiple of 32) reads a clamped column (in K1's one-row,
//     two-unit instance a checked load gives it zero) and stores nothing,
//     and the rows past R in the last tile are skipped.
// Tensor cores (wgmma), TMA, splitting 4H across SMs and CUDA graphs are
// left to later work.  With few rows (R = 34 on the time path at batch 1)
// the grid fills only a few of the 132 SMs; the wrapper then picks smaller
// row tiles (ROWS in {1, 2, 4, 8}) to spread the rows over more blocks.
// With U = 2 each thread holds twice the accumulators; the wrapper caps the
// row tile there (ops/cuda_lstm.py, from the ptxas register and spill
// report of the build).
//
// Training kernels.  Numerics follow the Pallas training bodies: gates and
// c residuals are stored in the input type and the backward recomputes
// c_t = f c_prev + i g from those stored values (pallas_lstm.py:405-409);
// dgates is rounded to the input type before both the dh product and the
// dW product (:421-430); dW_hh^T is accumulated in f32 over every step and
// row (:426-430, :722).  h_prev and c_prev are the stored h and c one scan
// step earlier (zero before the first step); the kernels index t -/+ 1
// themselves instead of taking shifted copies.
//   * K4 and K6 are K2 and K3 with three extra stores per step.
//   * K5 and K7 run two kernels each.  The first walks the scan backwards
//     with the K2 layout (time loop in the block, thread t owns units u of
//     each row of its tile, dh and dc in registers); this step's rounded
//     dgates (ROWS x 4H, f32) go through shared memory for the product
//     dh_prev = dgates W_hh, which reads W_hh (4H, H) coalesced over u.  The
//     second is the dW_hh^T reduction: a tiled f32 product over all R*T
//     (row, step) pairs, h_prev^T (H x RT) times dgates (RT x 4H), where the
//     dgates are the stored dx_proj (the same rounded values); each block
//     owns a 64 x 64 output tile and sums the pairs in one fixed order, so
//     two runs give bitwise-equal dW (no atomics).
//   * K8 reads x (N wide) instead of x_proj (4H wide) and adds N 4H
//     multiply-adds per row and step to K4's H 4H: the same latency-bound
//     walk with a longer step.  K10 halves the launches of a
//     bidirectional layer and fills twice the blocks of one direction.
// What bounds them: K4/K6 are K2/K3 plus residual stores (latency-bound
// the same way); the backward recurrence does the same product per step as
// the forward; the dW reduction is 2 H 4H R T operations over inputs that
// are read once per output tile from L2, on CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads per block
constexpr int kMaxUnits = 2;      // hidden units per thread: H <= 1024

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the storage type T, returned as f32
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// The j-th hidden unit of this thread.
__device__ __forceinline__ int unit(int j) { return threadIdx.x + j * blockDim.x; }

// The column of unit j clamped into [0, H): a thread whose unit lies past H
// reads a valid column and computes values that are never stored, so the
// hot loops need no bounds check.
__device__ __forceinline__ int column(int j, int H) { return min(unit(j), H - 1); }

// A weight of the hot loops.  The weights reach the kernels inside the
// per-direction argument structs, where __restrict__ does not tell the
// compiler that they are read-only: float weights go through the read-only
// data cache (__ldg), which made the float32 walks as fast as with raw
// __restrict__ parameters again; bfloat16 weights are read plainly, which
// measured faster for them (same-card A/Bs on an H100, PERF.md).
__device__ __forceinline__ float weight(const float* p) { return __ldg(p); }
__device__ __forceinline__ float weight(const __nv_bfloat16* p) { return to_f(*p); }

// acc[r][j][g] += sum_k v_s[r * ld + k] * w[k * 4H + g * H + unit(j)]
// The weight loads take one of two forms, fixed at compile time: the
// clamped column of each unit (no check in the loop), or, CHECKED, a check
// of u < H at every load.  Neither is faster everywhere; the kernels pick
// per instance from same-card A/Bs on an H100 (PERF.md).
template <typename T, int ROWS, int U, bool CHECKED = false>
__device__ __forceinline__ void add_product(float (&acc)[ROWS][U][4],
                                            const float* __restrict__ v_s, int ld,
                                            const T* __restrict__ w, int K, int H) {
  const size_t G = 4 * (size_t)H;
  const T* wu[U];
#pragma unroll
  for (int j = 0; j < U; ++j) wu[j] = w + (CHECKED ? unit(j) : column(j, H));
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[U][4];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const T* wk = wu[j] + k * G;
      const bool in = !CHECKED || unit(j) < H;
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[j][g] = in ? weight(wk + g * H) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = v_s[r * ld + k];  // same address across the warp: broadcast
#pragma unroll
      for (int j = 0; j < U; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][j][g] = fmaf(v, wv[j][g], acc[r][j][g]);
      }
    }
  }
}

// One cell update: returns h, updates c, leaves the post-activation gates
// i, f, g, o in a.
__device__ __forceinline__ float cell(float (&a)[4], float& c) {
  a[0] = sigmoid_f(a[0]);
  a[1] = sigmoid_f(a[1]);
  a[2] = tanhf(a[2]);
  a[3] = sigmoid_f(a[3]);
  c = a[1] * c + a[0] * a[2];
  return a[3] * tanhf(c);
}

// One direction of a recurrence launch (grid.y picks d0 or d1; every
// launch of the recurrence now has one direction, d0 = d1).
template <typename T>
struct Walk {
  const T* xp;     // (R, T, 4H) input projection incl. biases
  const T* whh_t;  // (H, 4H)
  T* out;          // (R, T, H) h
  T* gates;        // (R, T, 4H) post-activation gates (STORE)
  T* c;            // (R, T, H) cell state (STORE)
  int reverse;
  // K2's carry (null: start from zeros, write no final state)
  const T* h0;      // (R, H) the h before the first step
  const float* c0;  // (R, H) the c before the first step
  T* hT;            // (R, H) the last step's h
  float* cT;        // (R, H) the last step's c
};

// K2 (MASKED = false), K3 (MASKED = true, reverse = 1) and, with STORE, K4
// and K6: the same walk that also writes the gates and c residuals.  K2 with a carry: h_s and c start from h0 and c0 (h0 is already
// in T, so its rounding is exact), and the last step's h and c go to hT and
// cT; with the pointers null the walk is the one without a carry.
template <typename T, int ROWS, int U, bool MASKED, bool STORE>
__global__ void __launch_bounds__(kMaxThreads)
recurrence_kernel(const Walk<T> d0, const Walk<T> d1, const int* __restrict__ lengths,
                  int R, int Tn, int H) {
  extern __shared__ float h_s[];  // ROWS x H, values already rounded to T
  const Walk<T> d = blockIdx.y ? d1 : d0;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x)
    h_s[i] = (d.h0 != nullptr && i / H < nrows) ? to_f(d.h0[(size_t)r0 * H + i]) : 0.f;
  float c[ROWS][U];
  int len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      c[r][j] = (d.c0 != nullptr && r < nrows && unit(j) < H)
                    ? d.c0[(size_t)(r0 + r) * H + unit(j)]
                    : 0.f;
    }
    len[r] = (MASKED && r < nrows) ? lengths[r0 + r] : 0;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = d.reverse ? Tn - 1 - s : s;
    float acc[ROWS][U][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int u = unit(j);
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][j][g] = 0.f;
        if (r < nrows && u < H) {
          const T* x = d.xp + ((size_t)(r0 + r) * Tn + t) * G + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][j][g] = to_f(x[g * H]);
        }
      }
    }
    add_product<T, ROWS, U>(acc, h_s, H, d.whh_t, H, H);
    __syncthreads();  // every read of h_s for this step is done
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int u = unit(j);
        if (u >= H) continue;
        float h = cell(acc[r][j], c[r][j]);
        const size_t row = (size_t)(r0 + r) * Tn + t;
        d.out[row * H + u] = from_f<T>(h);
        if (STORE) {
          T* g = d.gates + row * G + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q * H] = from_f<T>(acc[r][j][q]);
          d.c[row * H + u] = from_f<T>(c[r][j]);
        }
        if (MASKED && t >= len[r]) {
          c[r][j] = 0.f;
          h = 0.f;
        }
        h_s[r * H + u] = round_to<T>(h);
      }
    }
    __syncthreads();  // h_s holds this step's state
  }
  if (d.hT != nullptr) {  // each thread hands on the cells it owns
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int u = unit(j);
        if (u >= H) continue;
        const size_t o = (size_t)(r0 + r) * H + u;
        d.hT[o] = from_f<T>(h_s[r * H + u]);
        d.cT[o] = c[r][j];
      }
    }
  }
}

// Stage this step's input rows x[r0 .. r0 + nrows, t, :] into x_s (f32).
template <typename T>
__device__ __forceinline__ void stage_rows(float* x_s, const T* __restrict__ x, int r0,
                                           int nrows, int t, int Tn, int N) {
  for (int i = threadIdx.x; i < nrows * N; i += blockDim.x) {
    const int r = i / N;
    const int k = i - r * N;
    x_s[i] = to_f(x[((size_t)(r0 + r) * Tn + t) * N + k]);
  }
}

// K1 (STREAM = false): both directions, grid.y = direction (0 forward, 1
// backward); the bias starts the accumulator, and h goes to its half of the
// (R, T, 2H) output.  K8 (STREAM = true): one direction (grid.y = 1, the
// walk's order from ``reverse``) with K4's residual stores; the step's
// pre-activation is (x_t W_ih^T + round(h) W_hh^T) + b: both products sum
// into one f32 accumulator, then the bias (rounded to T) is added.
template <typename T, int ROWS, int U, bool STREAM>
__global__ void __launch_bounds__(kMaxThreads)
fusedin_kernel(const T* __restrict__ x, const T* __restrict__ w_ih_t,
               const T* __restrict__ w_hh_t, const T* __restrict__ bias,
               T* __restrict__ out, T* __restrict__ gates_out, T* __restrict__ c_out,
               int R, int Tn, int N, int H, int reverse) {
  extern __shared__ float smem[];
  float* h_s = smem;             // ROWS x H
  float* x_s = smem + ROWS * H;  // ROWS x N: this step's input rows
  const int dir = blockIdx.y;
  const bool rev = STREAM ? reverse : dir;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;
  const size_t ld_out = STREAM ? H : 2 * (size_t)H;
  const T* wi = w_ih_t + dir * (size_t)N * G;
  const T* wh = w_hh_t + dir * (size_t)H * G;

  float b[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = unit(j);
#pragma unroll
    for (int g = 0; g < 4; ++g) b[j][g] = u < H ? to_f(bias[dir * G + g * H + u]) : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * (H + N); i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  stage_rows(x_s, x, r0, nrows, rev ? Tn - 1 : 0, Tn, N);
  float c[ROWS][U];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < U; ++j) c[r][j] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = rev ? Tn - 1 - s : s;
    float acc[ROWS][U][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][j][g] = STREAM ? 0.f : b[j][g];
      }
    }
    // checked loads at one row and two units a thread: K1 there (the flow
    // enhancement's time path, 48 rows) took 166 ms a launch against 374
    // with clamped columns; at four rows checked loads cost K1 20 %, and
    // K2-K4 at one row 13-56 % (same-card A/B on an H100, PERF.md)
    constexpr bool kChecked = ROWS == 1 && U == 2;
    add_product<T, ROWS, U, kChecked>(acc, x_s, N, wi, N, H);
    add_product<T, ROWS, U, kChecked>(acc, h_s, H, wh, H, H);
    __syncthreads();  // x_s and h_s are free
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int u = unit(j);
        if (u >= H) continue;
        if (STREAM) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][j][g] += b[j][g];
        }
        const float h = cell(acc[r][j], c[r][j]);
        const size_t row = (size_t)(r0 + r) * Tn + t;
        out[row * ld_out + dir * H + u] = from_f<T>(h);
        if (STREAM) {
          T* g = gates_out + row * G + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q * H] = from_f<T>(acc[r][j][q]);
          c_out[row * H + u] = from_f<T>(c[r][j]);
        }
        h_s[r * H + u] = round_to<T>(h);
      }
    }
    if (s + 1 < Tn) stage_rows(x_s, x, r0, nrows, rev ? t - 1 : t + 1, Tn, N);
    __syncthreads();
  }
}

// One direction of a backward launch (grid.y picks d0 or d1).
template <typename T>
struct Back {
  const T* gates;  // (R, T, 4H) stored post-activation gates
  const T* c;      // (R, T, H) stored cell state
  const T* h;      // (R, T, H) stored h (read by the dW reduction)
  const T* dout;   // (R, T, H) incoming dh
  const T* w4h;    // (4H, H) W_hh
  T* dxp;          // (R, T, 4H) dx_proj
  float* dw;       // (H, 4H) dW_hh^T
  int reverse;
};

// K5 (MASKED = false), K7 (MASKED = true, reverse = 1) and K10 (two
// directions): the first of their two kernels, the backward walk.  The
// forward scan entered step t with the state of step tp (t - 1, or t + 1
// when reverse); this kernel visits the steps in the opposite order and
// hands dh, dc on to tp.
template <typename T, int ROWS, int U, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
backward_kernel(const Back<T> d0, const Back<T> d1, const int* __restrict__ lengths,
                int R, int Tn, int H) {
  extern __shared__ float dg_s[];  // ROWS x 4H: this step's dgates, rounded to T
  const Back<T> d = blockIdx.y ? d1 : d0;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;

  for (int i = threadIdx.x; i < ROWS * 4 * H; i += blockDim.x) dg_s[i] = 0.f;
  float dh[ROWS][U], dc[ROWS][U];
  int len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      dh[r][j] = 0.f;
      dc[r][j] = 0.f;
    }
    len[r] = (MASKED && r < nrows) ? lengths[r0 + r] : Tn;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = d.reverse ? s : Tn - 1 - s;
    const int tp = d.reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < Tn;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int u = unit(j);
        if (u >= H) continue;
        const size_t row = (size_t)(r0 + r) * Tn + t;
        const T* g = d.gates + row * G + u;
        const float ig = to_f(g[0]);
        const float fg = to_f(g[H]);
        const float gg = to_f(g[2 * H]);
        const float og = to_f(g[3 * H]);
        const float m = (MASKED && t >= len[r]) ? 0.f : 1.f;
        const float mp = (MASKED && tp >= len[r]) ? 0.f : 1.f;
        const float cp =
            has_prev ? to_f(d.c[((size_t)(r0 + r) * Tn + tp) * H + u]) * mp : 0.f;
        const float tc = tanhf(fg * cp + ig * gg);
        const float dhv = to_f(d.dout[row * H + u]) + dh[r][j] * m;
        const float dcv = dc[r][j] * m + dhv * og * (1.f - tc * tc);
        float dq[4];
        dq[0] = dcv * gg * ig * (1.f - ig);
        dq[1] = dcv * cp * fg * (1.f - fg);
        dq[2] = dcv * ig * (1.f - gg * gg);
        dq[3] = dhv * tc * og * (1.f - og);
        T* o = d.dxp + row * G + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q * H] = from_f<T>(dq[q]);
          dg_s[r * G + q * H + u] = round_to<T>(dq[q]);
        }
        dc[r][j] = dcv * fg;
      }
    }
    __syncthreads();  // dg_s holds this step's dgates
    float acc[ROWS][U];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < U; ++j) acc[r][j] = 0.f;
    }
    const T* wu[U];
#pragma unroll
    for (int j = 0; j < U; ++j) wu[j] = d.w4h + column(j, H);
#pragma unroll 4
    for (size_t q = 0; q < G; ++q) {
      float w[U];
#pragma unroll
      for (int j = 0; j < U; ++j) w[j] = weight(wu[j] + q * H);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = dg_s[r * G + q];
#pragma unroll
        for (int j = 0; j < U; ++j) acc[r][j] = fmaf(v, w[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < U; ++j) dh[r][j] = acc[r][j];
    }
    __syncthreads();  // every read of dg_s for this step is done
  }
}

// K5, K7 and K10, second kernel: dw (H, 4H) f32 = sum over (r, t) of
// h_prev(r, t)^T dgates(r, t), with h_prev = h at step tp (zero where tp is
// outside [0, T), and, MASKED, where tp >= len[r]) and dgates = dxp.
// grid.z picks the direction.
constexpr int kTileK = 64;   // output rows (hidden unit k) per block
constexpr int kTileJ = 64;   // output columns (gate column j) per block
constexpr int kTileN = 16;   // (row, step) pairs per shared-memory stage
constexpr int kDwThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kDwThreads)
dw_kernel(const Back<T> d0, const Back<T> d1, const int* __restrict__ lengths, int R,
          int Tn, int H) {
  __shared__ float a_s[kTileN][kTileK];
  __shared__ float b_s[kTileN][kTileJ];
  const Back<T> d = blockIdx.z ? d1 : d0;
  const int k0 = blockIdx.y * kTileK;
  const int j0 = blockIdx.x * kTileJ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t G = 4 * (size_t)H;
  const long long n_total = (long long)R * Tn;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long n0 = 0; n0 < n_total; n0 += kTileN) {
    for (int i = threadIdx.x; i < kTileN * kTileK; i += kDwThreads) {
      const int nn = i / kTileK;
      const int kk = i - nn * kTileK;
      const long long n = n0 + nn;
      float v = 0.f;
      if (n < n_total && k0 + kk < H) {
        const int r = (int)(n / Tn);
        const int t = (int)(n - (long long)r * Tn);
        const int tp = d.reverse ? t + 1 : t - 1;
        if (tp >= 0 && tp < Tn && (!MASKED || tp < lengths[r]))
          v = to_f(d.h[((size_t)r * Tn + tp) * H + k0 + kk]);
      }
      a_s[nn][kk] = v;
    }
    for (int i = threadIdx.x; i < kTileN * kTileJ; i += kDwThreads) {
      const int nn = i / kTileJ;
      const int jj = i - nn * kTileJ;
      const long long n = n0 + nn;
      b_s[nn][jj] = (n < n_total && j0 + jj < (int)G) ? to_f(d.dxp[n * G + j0 + jj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kTileN; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[nn][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[nn][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jc = j0 + tx * 4 + j;
      if (jc < (int)G) d.dw[k * G + jc] = acc[i][j];
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

// Threads of a block: ceil(H / U) rounded up to whole warps.
int threads_for(int H, int U) { return ((H + U - 1) / U + 31) / 32 * 32; }

template <typename T, int ROWS, int U, bool MASKED, bool STORE>
cudaError_t run_recurrence(const Walk<T>& d0, const Walk<T>& d1, int ndir,
                           const int* lengths, int R, int Tn, int H, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * H * sizeof(float);
  auto kern = recurrence_kernel<T, ROWS, U, MASKED, STORE>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS, ndir), threads_for(H, U), smem, stream>>>(
      d0, d1, lengths, R, Tn, H);
  return cudaGetLastError();
}

template <typename T, int ROWS, int U, bool MASKED>
cudaError_t run_backward(const Back<T>& d0, const Back<T>& d1, int ndir,
                         const int* lengths, int R, int Tn, int H, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * 4 * H * sizeof(float);
  auto kern = backward_kernel<T, ROWS, U, MASKED>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS, ndir), threads_for(H, U), smem, stream>>>(
      d0, d1, lengths, R, Tn, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((4 * H + kTileJ - 1) / kTileJ, (H + kTileK - 1) / kTileK, ndir);
  dw_kernel<T, MASKED><<<grid, kDwThreads, 0, stream>>>(d0, d1, lengths, R, Tn, H);
  return cudaGetLastError();
}

// K1 (two directions) or K8 (STREAM, one).
template <typename T, int ROWS, int U, bool STREAM>
cudaError_t run_fusedin(const void* x, const void* w_ih_t, const void* w_hh_t,
                        const void* bias, void* out, void* gates, void* c, int R, int Tn,
                        int N, int H, int reverse, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * (H + N) * sizeof(float);
  auto kern = fusedin_kernel<T, ROWS, U, STREAM>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS, STREAM ? 1 : 2), threads_for(H, U), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih_t),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(bias), static_cast<T*>(out),
      static_cast<T*>(gates), static_cast<T*>(c), R, Tn, N, H, reverse);
  return cudaGetLastError();
}

bool bad_shape(int R, int Tn, int H, int rows) {
  return R <= 0 || Tn <= 0 || H <= 0 || H > kMaxUnits * kMaxThreads ||
         !(rows == 1 || rows == 2 || rows == 4 || rows == 8);
}

// Row tile (1, 2, 4, 8) x units per thread (1 for H <= 512, else 2): calls
// F::template run<ROWS, U>().
template <typename F>
cudaError_t dispatch(const F& f, int rows, int H) {
  if (H <= kMaxThreads) {
    switch (rows) {
      case 1: return f.template run<1, 1>();
      case 2: return f.template run<2, 1>();
      case 4: return f.template run<4, 1>();
      default: return f.template run<8, 1>();
    }
  }
  switch (rows) {
    case 1: return f.template run<1, 2>();
    case 2: return f.template run<2, 2>();
    case 4: return f.template run<4, 2>();
    default: return f.template run<8, 2>();
  }
}

template <typename T, bool MASKED, bool STORE>
struct RecurrenceLaunch {
  Walk<T> d0, d1;
  int ndir;
  const int* lengths;
  int R, Tn, H;
  cudaStream_t st;
  template <int ROWS, int U>
  cudaError_t run() const {
    return run_recurrence<T, ROWS, U, MASKED, STORE>(d0, d1, ndir, lengths, R, Tn, H, st);
  }
};

template <typename T, bool MASKED>
struct BackwardLaunch {
  Back<T> d0, d1;
  int ndir;
  const int* lengths;
  int R, Tn, H;
  cudaStream_t st;
  template <int ROWS, int U>
  cudaError_t run() const {
    return run_backward<T, ROWS, U, MASKED>(d0, d1, ndir, lengths, R, Tn, H, st);
  }
};

template <typename T, bool STREAM>
struct FusedinLaunch {
  const void *x, *w_ih_t, *w_hh_t, *bias;
  void *out, *gates, *c;
  int R, Tn, N, H, reverse;
  cudaStream_t st;
  template <int ROWS, int U>
  cudaError_t run() const {
    return run_fusedin<T, ROWS, U, STREAM>(x, w_ih_t, w_hh_t, bias, out, gates, c, R, Tn, N,
                                           H, reverse, st);
  }
};

// K1 and K8.
template <bool STREAM>
int fusedin(const void* x, const void* w_ih_t, const void* w_hh_t, const void* bias,
            void* out, void* gates, void* c, int R, int Tn, int N, int H, int reverse,
            int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows) || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch(FusedinLaunch<__nv_bfloat16, STREAM>{
        x, w_ih_t, w_hh_t, bias, out, gates, c, R, Tn, N, H, reverse, st}, rows, H);
  return (int)dispatch(FusedinLaunch<float, STREAM>{
      x, w_ih_t, w_hh_t, bias, out, gates, c, R, Tn, N, H, reverse, st}, rows, H);
}

template <typename T>
Walk<T> walk(const void* xp, const void* whh_t, void* out, void* gates, void* c,
             int reverse) {
  return Walk<T>{static_cast<const T*>(xp), static_cast<const T*>(whh_t),
                 static_cast<T*>(out), static_cast<T*>(gates), static_cast<T*>(c), reverse};
}

template <typename T>
Back<T> back(const void* gates, const void* c, const void* h, const void* dout,
             const void* w4h, void* dxp, void* dw, int reverse) {
  return Back<T>{static_cast<const T*>(gates), static_cast<const T*>(c),
                 static_cast<const T*>(h), static_cast<const T*>(dout),
                 static_cast<const T*>(w4h), static_cast<T*>(dxp),
                 static_cast<float*>(dw), reverse};
}

template <typename T>
Walk<T> with_carry(Walk<T> d, const void* h0, const void* c0, void* hT, void* cT) {
  d.h0 = static_cast<const T*>(h0);
  d.c0 = static_cast<const float*>(c0);
  d.hT = static_cast<T*>(hT);
  d.cT = static_cast<float*>(cT);
  return d;
}

// One-direction walk (K2, K3, K4, K6); h0 .. cT: K2's carry (null: none).
template <bool MASKED, bool STORE>
int one_walk(const void* xp, const void* whh_t, const int* lengths, void* out, void* gates,
             void* c, int R, int Tn, int H, int reverse, int dtype, int rows,
             void* stream, const void* h0 = nullptr, const void* c0 = nullptr,
             void* hT = nullptr, void* cT = nullptr) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Walk<__nv_bfloat16> d =
        with_carry(walk<__nv_bfloat16>(xp, whh_t, out, gates, c, reverse), h0, c0, hT, cT);
    return (int)dispatch(RecurrenceLaunch<__nv_bfloat16, MASKED, STORE>{
        d, d, 1, lengths, R, Tn, H, st}, rows, H);
  }
  const Walk<float> d = with_carry(walk<float>(xp, whh_t, out, gates, c, reverse), h0, c0, hT,
                                   cT);
  return (int)dispatch(RecurrenceLaunch<float, MASKED, STORE>{d, d, 1, lengths, R, Tn, H, st},
                       rows, H);
}

// One-direction backward (K5, K7).
template <bool MASKED>
int one_backward(const void* gates, const void* c, const void* h, const int* lengths,
                 const void* dout, const void* w4h, void* dxp, void* dw, int R, int Tn,
                 int H, int reverse, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Back<__nv_bfloat16> d =
        back<__nv_bfloat16>(gates, c, h, dout, w4h, dxp, dw, reverse);
    return (int)dispatch(BackwardLaunch<__nv_bfloat16, MASKED>{d, d, 1, lengths, R, Tn, H, st},
                         rows, H);
  }
  const Back<float> d = back<float>(gates, c, h, dout, w4h, dxp, dw, reverse);
  return (int)dispatch(BackwardLaunch<float, MASKED>{d, d, 1, lengths, R, Tn, H, st}, rows, H);
}

}  // namespace

// C interface.  dtype: 0 = float32, 1 = bfloat16.  rows: rows per block
// (1, 2, 4 or 8).  Returns the cudaError_t of the launch (0 on success).
extern "C" {

int lstm_fusedin_bilstm(const void* x, const void* w_ih_t, const void* w_hh_t,
                        const void* bias, void* out, int R, int Tn, int N, int H,
                        int dtype, int rows, void* stream) {
  return fusedin<false>(x, w_ih_t, w_hh_t, bias, out, nullptr, nullptr, R, Tn, N, H, 0,
                        dtype, rows, stream);
}

// K2; h0 (R, H) in the input's type and c0 (R, H) float32, both or neither,
// start the walk from a carried state; hT and cT (the same shapes), both or
// neither, receive the last step's.
int lstm_scan(const void* xp, const void* whh_t, void* out, const void* h0, const void* c0,
              void* hT, void* cT, int R, int Tn, int H, int reverse, int dtype, int rows,
              void* stream) {
  if ((h0 == nullptr) != (c0 == nullptr) || (hT == nullptr) != (cT == nullptr))
    return (int)cudaErrorInvalidValue;
  return one_walk<false, false>(xp, whh_t, nullptr, out, nullptr, nullptr, R, Tn, H,
                                reverse, dtype, rows, stream, h0, c0, hT, cT);
}

int lstm_revmasked(const void* xp, const void* whh_t, const int* lengths, void* out,
                   int R, int Tn, int H, int dtype, int rows, void* stream) {
  return one_walk<true, false>(xp, whh_t, lengths, out, nullptr, nullptr, R, Tn, H, 1,
                               dtype, rows, stream);
}

// K4 and K6: h, gates and c in the layouts (R, T, H), (R, T, 4H), (R, T, H).
int lstm_train_fwd(const void* xp, const void* whh_t, void* out, void* gates, void* c,
                   int R, int Tn, int H, int reverse, int dtype, int rows, void* stream) {
  return one_walk<false, true>(xp, whh_t, nullptr, out, gates, c, R, Tn, H, reverse, dtype,
                               rows, stream);
}

int lstm_revmasked_train_fwd(const void* xp, const void* whh_t, const int* lengths,
                             void* out, void* gates, void* c, int R, int Tn, int H,
                             int dtype, int rows, void* stream) {
  return one_walk<true, true>(xp, whh_t, lengths, out, gates, c, R, Tn, H, 1, dtype, rows,
                              stream);
}

// K5 and K7: from K4's (K6's) gates, c and h, the incoming dout (R, T, H)
// and W_hh (4H, H) to dxp (R, T, 4H) and dw = dW_hh^T (H, 4H) float32.
int lstm_train_bwd(const void* gates, const void* c, const void* h, const void* dout,
                   const void* w4h, void* dxp, void* dw, int R, int Tn, int H,
                   int reverse, int dtype, int rows, void* stream) {
  return one_backward<false>(gates, c, h, nullptr, dout, w4h, dxp, dw, R, Tn, H, reverse,
                             dtype, rows, stream);
}

int lstm_revmasked_bwd(const void* gates, const void* c, const void* h,
                       const int* lengths, const void* dout, const void* w4h, void* dxp,
                       void* dw, int R, int Tn, int H, int dtype, int rows, void* stream) {
  return one_backward<true>(gates, c, h, lengths, dout, w4h, dxp, dw, R, Tn, H, 1, dtype,
                            rows, stream);
}

// K8: x (R, T, N), w_ih_t (N, 4H), bias (4H,), w_hh_t (H, 4H) -> h, gates, c
// as K4.
int lstm_train_fwd_streamin(const void* x, const void* w_ih_t, const void* bias,
                            const void* w_hh_t, void* out, void* gates, void* c, int R,
                            int Tn, int N, int H, int reverse, int dtype, int rows,
                            void* stream) {
  return fusedin<true>(x, w_ih_t, w_hh_t, bias, out, gates, c, R, Tn, N, H, reverse, dtype,
                       rows, stream);
}

// K10: K5 for both directions (forward: reverse = 0, backward: reverse = 1)
// in one walk launch and one dW launch.
int lstm_train_bwd2(const void* gates_f, const void* c_f, const void* h_f,
                    const void* dout_f, const void* w4h_f, void* dxp_f, void* dw_f,
                    const void* gates_b, const void* c_b, const void* h_b,
                    const void* dout_b, const void* w4h_b, void* dxp_b, void* dw_b, int R,
                    int Tn, int H, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch(BackwardLaunch<__nv_bfloat16, false>{
        back<__nv_bfloat16>(gates_f, c_f, h_f, dout_f, w4h_f, dxp_f, dw_f, 0),
        back<__nv_bfloat16>(gates_b, c_b, h_b, dout_b, w4h_b, dxp_b, dw_b, 1), 2, nullptr,
        R, Tn, H, st}, rows, H);
  return (int)dispatch(BackwardLaunch<float, false>{
      back<float>(gates_f, c_f, h_f, dout_f, w4h_f, dxp_f, dw_f, 0),
      back<float>(gates_b, c_b, h_b, dout_b, w4h_b, dxp_b, dw_b, 1), 2, nullptr, R, Tn, H,
      st}, rows, H);
}

}  // extern "C"
