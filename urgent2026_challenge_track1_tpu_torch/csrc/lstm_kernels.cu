// LSTM recurrence kernels for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Three kernels carry the BSRNN inference path, four more its training step:
//
//   K1 lstm_fusedin_bilstm
//      Replaces urgent2026_challenge_track1_tpu/ops/pallas_lstm.py:
//      _fusedin_forward (body _fusedin_step).  Bidirectional LSTM on the raw
//      input x (R, T, N): every step computes x_t W_ih^T + h W_hh^T + b for
//      both directions; writes (R, T, 2H) with forward || backward in place.
//   K2 lstm_scan
//      Replaces pallas_lstm.py:lstm_scan_pallas (body _body).  One direction
//      over a hoisted input projection x_proj (R, T, 4H) that already holds
//      the biases; ``reverse`` walks t = T-1 .. 0.
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
//
// Numerics follow the Pallas bodies: gates i, f, g, o; h and c are f32;
// products accumulate in f32; h is rounded to the input type before the
// h W_hh^T product (pallas_lstm.py:56-58); outputs are stored in the input
// type.  Inputs and weights are float32 or bfloat16.
//
// What bounds these kernels on an H100: the recurrence is sequential in t,
// and each step is a thin (rows x H) x (H x 4H) product.  At the BSRNN
// widths (N = 196, H = 392) the bytes that must move are small next to the
// operations (each weight is reused by every row), so the bound is the
// tensor-core rate; what really limits this first design is latency and
// CUDA-core FMA issue: one step cannot start before the previous one ends.
//
// Design (simple and correct first):
//   * the time loop lives inside the block; blocks own disjoint tiles of
//     ROWS rows (grid.x), and K1 runs both directions on grid.y;
//   * thread u owns hidden unit u of every row of its tile and computes the
//     four gate columns u, H+u, 2H+u, 3H+u, so the c/h update needs no
//     exchange between threads: c stays in registers, h (f32, ROWS x H)
//     stays in shared memory, and two __syncthreads() per step separate the
//     reads of h from its update;
//   * weights are read from global memory on every step (coalesced over u)
//     and stay resident in the 50 MB L2 (3.7 MB in bf16 at these widths);
//   * the ragged edges (H = 392 is no multiple of 32; R is not padded) are
//     bounds checks, not padding.
// Tensor cores (wgmma), TMA, splitting 4H across SMs and CUDA graphs are
// left to later work.  With few rows (R = 34 on the time path at batch 1)
// the grid fills only a few of the 132 SMs; the wrapper then picks smaller
// row tiles (ROWS in {1, 2, 4, 8}) to spread the rows over more blocks.
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
//     with the K2 layout (time loop in the block, thread u owns unit u of
//     each row of its tile, dh and dc in registers); this step's rounded
//     dgates (ROWS x 4H, f32) go through shared memory for the product
//     dh_prev = dgates W_hh, which reads W_hh (4H, H) coalesced over u.  The
//     second is the dW_hh^T reduction: a tiled f32 product over all R*T
//     (row, step) pairs, h_prev^T (H x RT) times dgates (RT x 4H), where the
//     dgates are the stored dx_proj (the same rounded values); each block
//     owns a 64 x 64 output tile and sums the pairs in one fixed order, so
//     two runs give bitwise-equal dW (no atomics).
// What bounds them: K4/K6 are K2/K3 plus residual stores (latency-bound the
// same way); the backward recurrence does the same product per step as the
// forward; the dW reduction is 2 H 4H R T operations over inputs that are
// read once per output tile from L2, on CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // hidden units per block: H <= 512

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

// acc[r][g] += sum_k v_s[r * ld + k] * w[k * 4H + g * H + u]
template <typename T, int ROWS>
__device__ __forceinline__ void add_product(float (&acc)[ROWS][4],
                                            const float* __restrict__ v_s, int ld,
                                            const T* __restrict__ w, int K, int H,
                                            int u) {
  const size_t G = 4 * (size_t)H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const T* wk = w + k * G + u;
    const float w0 = to_f(wk[0]);
    const float w1 = to_f(wk[H]);
    const float w2 = to_f(wk[2 * H]);
    const float w3 = to_f(wk[3 * H]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = v_s[r * ld + k];  // same address across the warp: broadcast
      acc[r][0] = fmaf(v, w0, acc[r][0]);
      acc[r][1] = fmaf(v, w1, acc[r][1]);
      acc[r][2] = fmaf(v, w2, acc[r][2]);
      acc[r][3] = fmaf(v, w3, acc[r][3]);
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

// K2 (MASKED = false), K3 (MASKED = true, reverse = 1) and, with STORE, K4
// and K6: the same walk that also writes the gates and c residuals.
template <typename T, int ROWS, bool MASKED, bool STORE>
__global__ void __launch_bounds__(kMaxThreads)
recurrence_kernel(const T* __restrict__ xp, const T* __restrict__ whh_t,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  T* __restrict__ gates_out, T* __restrict__ c_out, int R,
                  int Tn, int H, int reverse) {
  extern __shared__ float h_s[];  // ROWS x H, values already rounded to T
  const int u = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) h_s[i] = 0.f;
  float c[ROWS];
  int len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    c[r] = 0.f;
    len[r] = (MASKED && r < nrows) ? lengths[r0 + r] : 0;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = reverse ? Tn - 1 - s : s;
    float acc[ROWS][4];
    if (u < H) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
        if (r < nrows) {
          const T* x = xp + ((size_t)(r0 + r) * Tn + t) * G + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = to_f(x[g * H]);
        }
      }
      add_product<T, ROWS>(acc, h_s, H, whh_t, H, H, u);
    }
    __syncthreads();  // every read of h_s for this step is done
    if (u < H) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          float h = cell(acc[r], c[r]);
          const size_t row = (size_t)(r0 + r) * Tn + t;
          out[row * H + u] = from_f<T>(h);
          if (STORE) {
            T* g = gates_out + row * G + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) g[q * H] = from_f<T>(acc[r][q]);
            c_out[row * H + u] = from_f<T>(c[r]);
          }
          if (MASKED && t >= len[r]) {
            c[r] = 0.f;
            h = 0.f;
          }
          h_s[r * H + u] = round_to<T>(h);
        }
      }
    }
    __syncthreads();  // h_s holds this step's state
  }
}

// K1: grid.y = direction (0 forward, 1 backward).
template <typename T, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
fusedin_kernel(const T* __restrict__ x, const T* __restrict__ w_ih_t,
               const T* __restrict__ w_hh_t, const T* __restrict__ bias,
               T* __restrict__ out, int R, int Tn, int N, int H) {
  extern __shared__ float smem[];
  float* h_s = smem;             // ROWS x H
  float* x_s = smem + ROWS * H;  // ROWS x N: this step's input rows
  const int dir = blockIdx.y;
  const int u = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;
  const T* wi = w_ih_t + dir * (size_t)N * G;
  const T* wh = w_hh_t + dir * (size_t)H * G;

  float b[4] = {0.f, 0.f, 0.f, 0.f};
  if (u < H) {
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = to_f(bias[dir * G + g * H + u]);
  }
  for (int i = threadIdx.x; i < ROWS * (H + N); i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  auto stage_x = [&](int t) {
    for (int i = threadIdx.x; i < nrows * N; i += blockDim.x) {
      const int r = i / N;
      const int k = i - r * N;
      x_s[i] = to_f(x[((size_t)(r0 + r) * Tn + t) * N + k]);
    }
  };
  stage_x(dir ? Tn - 1 : 0);
  float c[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) c[r] = 0.f;
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = dir ? Tn - 1 - s : s;
    float acc[ROWS][4];
    if (u < H) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = b[g];
      }
      add_product<T, ROWS>(acc, x_s, N, wi, N, H, u);
      add_product<T, ROWS>(acc, h_s, H, wh, H, H, u);
    }
    __syncthreads();  // x_s and h_s are free
    if (u < H) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          const float h = cell(acc[r], c[r]);
          out[((size_t)(r0 + r) * Tn + t) * (2 * (size_t)H) + dir * H + u] = from_f<T>(h);
          h_s[r * H + u] = round_to<T>(h);
        }
      }
    }
    if (s + 1 < Tn) stage_x(dir ? t - 1 : t + 1);
    __syncthreads();
  }
}

// K5 (MASKED = false) and K7 (MASKED = true, reverse = 1): the first of
// their two kernels, the backward walk.  The forward scan entered step t
// with the state of step tp (t - 1, or t + 1 when reverse); this kernel
// visits the steps in the opposite order and hands dh, dc on to tp.
template <typename T, int ROWS, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
backward_kernel(const T* __restrict__ gates, const T* __restrict__ cst,
                const T* __restrict__ dout, const T* __restrict__ w4h,
                const int* __restrict__ lengths, T* __restrict__ dxp, int R,
                int Tn, int H, int reverse) {
  extern __shared__ float dg_s[];  // ROWS x 4H: this step's dgates, rounded to T
  const int u = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - r0);
  const size_t G = 4 * (size_t)H;

  for (int i = threadIdx.x; i < ROWS * 4 * H; i += blockDim.x) dg_s[i] = 0.f;
  float dh[ROWS], dc[ROWS];
  int len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    dh[r] = 0.f;
    dc[r] = 0.f;
    len[r] = (MASKED && r < nrows) ? lengths[r0 + r] : Tn;
  }
  __syncthreads();

  for (int s = 0; s < Tn; ++s) {
    const int t = reverse ? s : Tn - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;
    const bool has_prev = tp >= 0 && tp < Tn;
    if (u < H) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          const size_t row = (size_t)(r0 + r) * Tn + t;
          const T* g = gates + row * G + u;
          const float ig = to_f(g[0]);
          const float fg = to_f(g[H]);
          const float gg = to_f(g[2 * H]);
          const float og = to_f(g[3 * H]);
          const float m = (MASKED && t >= len[r]) ? 0.f : 1.f;
          const float mp = (MASKED && tp >= len[r]) ? 0.f : 1.f;
          const float cp =
              has_prev ? to_f(cst[((size_t)(r0 + r) * Tn + tp) * H + u]) * mp : 0.f;
          const float tc = tanhf(fg * cp + ig * gg);
          const float dhv = to_f(dout[row * H + u]) + dh[r] * m;
          const float dcv = dc[r] * m + dhv * og * (1.f - tc * tc);
          float d[4];
          d[0] = dcv * gg * ig * (1.f - ig);
          d[1] = dcv * cp * fg * (1.f - fg);
          d[2] = dcv * ig * (1.f - gg * gg);
          d[3] = dhv * tc * og * (1.f - og);
          T* o = dxp + row * G + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            o[q * H] = from_f<T>(d[q]);
            dg_s[r * G + q * H + u] = round_to<T>(d[q]);
          }
          dc[r] = dcv * fg;
        }
      }
    }
    __syncthreads();  // dg_s holds this step's dgates
    if (u < H) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (size_t j = 0; j < G; ++j) {
        const float w = to_f(w4h[j * H + u]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(dg_s[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dh[r] = acc[r];
    }
    __syncthreads();  // every read of dg_s for this step is done
  }
}

// K5 and K7, second kernel: dw (H, 4H) f32 = sum over (r, t) of
// h_prev(r, t)^T dgates(r, t), with h_prev = h at step tp (zero where tp is
// outside [0, T), and, MASKED, where tp >= len[r]) and dgates = dxp.
constexpr int kTileK = 64;   // output rows (hidden unit k) per block
constexpr int kTileJ = 64;   // output columns (gate column j) per block
constexpr int kTileN = 16;   // (row, step) pairs per shared-memory stage
constexpr int kDwThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kDwThreads)
dw_kernel(const T* __restrict__ h, const T* __restrict__ dxp,
          const int* __restrict__ lengths, float* __restrict__ dw, int R, int Tn,
          int H, int reverse) {
  __shared__ float a_s[kTileN][kTileK];
  __shared__ float b_s[kTileN][kTileJ];
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
        const int tp = reverse ? t + 1 : t - 1;
        if (tp >= 0 && tp < Tn && (!MASKED || tp < lengths[r]))
          v = to_f(h[((size_t)r * Tn + tp) * H + k0 + kk]);
      }
      a_s[nn][kk] = v;
    }
    for (int i = threadIdx.x; i < kTileN * kTileJ; i += kDwThreads) {
      const int nn = i / kTileJ;
      const int jj = i - nn * kTileJ;
      const long long n = n0 + nn;
      b_s[nn][jj] = (n < n_total && j0 + jj < (int)G) ? to_f(dxp[n * G + j0 + jj]) : 0.f;
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
      if (jc < (int)G) dw[k * G + jc] = acc[i][j];
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

int threads_for(int H) { return (H + 31) / 32 * 32; }

template <typename T, int ROWS, bool MASKED, bool STORE>
cudaError_t run_recurrence(const void* xp, const void* whh_t, const int* lengths,
                           void* out, void* gates, void* c, int R, int Tn, int H,
                           int reverse, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * H * sizeof(float);
  auto kern = recurrence_kernel<T, ROWS, MASKED, STORE>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS), threads_for(H), smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(whh_t), lengths,
      static_cast<T*>(out), static_cast<T*>(gates), static_cast<T*>(c), R, Tn, H,
      reverse);
  return cudaGetLastError();
}

template <typename T, int ROWS, bool MASKED>
cudaError_t run_backward(const void* gates, const void* c, const void* h,
                         const void* dout, const void* w4h, const int* lengths,
                         void* dxp, float* dw, int R, int Tn, int H, int reverse,
                         cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * 4 * H * sizeof(float);
  auto kern = backward_kernel<T, ROWS, MASKED>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS), threads_for(H), smem, stream>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c),
      static_cast<const T*>(dout), static_cast<const T*>(w4h), lengths,
      static_cast<T*>(dxp), R, Tn, H, reverse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((4 * H + kTileJ - 1) / kTileJ, (H + kTileK - 1) / kTileK);
  dw_kernel<T, MASKED><<<grid, kDwThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(dxp), lengths, dw, R, Tn, H,
      reverse);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t run_fusedin(const void* x, const void* w_ih_t, const void* w_hh_t,
                        const void* bias, void* out, int R, int Tn, int N, int H,
                        cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * (H + N) * sizeof(float);
  auto kern = fusedin_kernel<T, ROWS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS, 2), threads_for(H), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih_t),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(bias),
      static_cast<T*>(out), R, Tn, N, H);
  return cudaGetLastError();
}

bool bad_shape(int R, int Tn, int H, int rows) {
  return R <= 0 || Tn <= 0 || H <= 0 || H > kMaxThreads ||
         !(rows == 1 || rows == 2 || rows == 4 || rows == 8);
}

template <typename T, bool MASKED, bool STORE>
cudaError_t dispatch_recurrence(const void* xp, const void* whh_t, const int* lengths,
                                void* out, void* gates, void* c, int R, int Tn, int H,
                                int reverse, int rows, cudaStream_t st) {
  switch (rows) {
    case 1: return run_recurrence<T, 1, MASKED, STORE>(xp, whh_t, lengths, out, gates, c, R, Tn, H, reverse, st);
    case 2: return run_recurrence<T, 2, MASKED, STORE>(xp, whh_t, lengths, out, gates, c, R, Tn, H, reverse, st);
    case 4: return run_recurrence<T, 4, MASKED, STORE>(xp, whh_t, lengths, out, gates, c, R, Tn, H, reverse, st);
    default: return run_recurrence<T, 8, MASKED, STORE>(xp, whh_t, lengths, out, gates, c, R, Tn, H, reverse, st);
  }
}

template <typename T, bool MASKED>
cudaError_t dispatch_backward(const void* gates, const void* c, const void* h,
                              const void* dout, const void* w4h, const int* lengths,
                              void* dxp, float* dw, int R, int Tn, int H, int reverse,
                              int rows, cudaStream_t st) {
  switch (rows) {
    case 1: return run_backward<T, 1, MASKED>(gates, c, h, dout, w4h, lengths, dxp, dw, R, Tn, H, reverse, st);
    case 2: return run_backward<T, 2, MASKED>(gates, c, h, dout, w4h, lengths, dxp, dw, R, Tn, H, reverse, st);
    case 4: return run_backward<T, 4, MASKED>(gates, c, h, dout, w4h, lengths, dxp, dw, R, Tn, H, reverse, st);
    default: return run_backward<T, 8, MASKED>(gates, c, h, dout, w4h, lengths, dxp, dw, R, Tn, H, reverse, st);
  }
}

template <typename T>
cudaError_t dispatch_fusedin(const void* x, const void* w_ih_t, const void* w_hh_t,
                             const void* bias, void* out, int R, int Tn, int N, int H,
                             int rows, cudaStream_t st) {
  switch (rows) {
    case 1: return run_fusedin<T, 1>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, st);
    case 2: return run_fusedin<T, 2>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, st);
    case 4: return run_fusedin<T, 4>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, st);
    default: return run_fusedin<T, 8>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, st);
  }
}

}  // namespace

// C interface.  dtype: 0 = float32, 1 = bfloat16.  rows: rows per block
// (1, 2, 4 or 8).  Returns the cudaError_t of the launch (0 on success).
extern "C" {

int lstm_fusedin_bilstm(const void* x, const void* w_ih_t, const void* w_hh_t,
                        const void* bias, void* out, int R, int Tn, int N, int H,
                        int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows) || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_fusedin<__nv_bfloat16>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, rows, st);
  return (int)dispatch_fusedin<float>(x, w_ih_t, w_hh_t, bias, out, R, Tn, N, H, rows, st);
}

int lstm_scan(const void* xp, const void* whh_t, void* out, int R, int Tn, int H,
              int reverse, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_recurrence<__nv_bfloat16, false, false>(xp, whh_t, nullptr, out, nullptr, nullptr, R, Tn, H, reverse, rows, st);
  return (int)dispatch_recurrence<float, false, false>(xp, whh_t, nullptr, out, nullptr, nullptr, R, Tn, H, reverse, rows, st);
}

int lstm_revmasked(const void* xp, const void* whh_t, const int* lengths, void* out,
                   int R, int Tn, int H, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_recurrence<__nv_bfloat16, true, false>(xp, whh_t, lengths, out, nullptr, nullptr, R, Tn, H, 1, rows, st);
  return (int)dispatch_recurrence<float, true, false>(xp, whh_t, lengths, out, nullptr, nullptr, R, Tn, H, 1, rows, st);
}

// K4 and K6: h, gates and c in the layouts (R, T, H), (R, T, 4H), (R, T, H).
int lstm_train_fwd(const void* xp, const void* whh_t, void* out, void* gates, void* c,
                   int R, int Tn, int H, int reverse, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_recurrence<__nv_bfloat16, false, true>(xp, whh_t, nullptr, out, gates, c, R, Tn, H, reverse, rows, st);
  return (int)dispatch_recurrence<float, false, true>(xp, whh_t, nullptr, out, gates, c, R, Tn, H, reverse, rows, st);
}

int lstm_revmasked_train_fwd(const void* xp, const void* whh_t, const int* lengths,
                             void* out, void* gates, void* c, int R, int Tn, int H,
                             int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_recurrence<__nv_bfloat16, true, true>(xp, whh_t, lengths, out, gates, c, R, Tn, H, 1, rows, st);
  return (int)dispatch_recurrence<float, true, true>(xp, whh_t, lengths, out, gates, c, R, Tn, H, 1, rows, st);
}

// K5 and K7: from K4's (K6's) gates, c and h, the incoming dout (R, T, H)
// and W_hh (4H, H) to dxp (R, T, 4H) and dw = dW_hh^T (H, 4H) float32.
int lstm_train_bwd(const void* gates, const void* c, const void* h, const void* dout,
                   const void* w4h, void* dxp, void* dw, int R, int Tn, int H,
                   int reverse, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 1)
    return (int)dispatch_backward<__nv_bfloat16, false>(gates, c, h, dout, w4h, nullptr, dxp, dwf, R, Tn, H, reverse, rows, st);
  return (int)dispatch_backward<float, false>(gates, c, h, dout, w4h, nullptr, dxp, dwf, R, Tn, H, reverse, rows, st);
}

int lstm_revmasked_bwd(const void* gates, const void* c, const void* h,
                       const int* lengths, const void* dout, const void* w4h, void* dxp,
                       void* dw, int R, int Tn, int H, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 1)
    return (int)dispatch_backward<__nv_bfloat16, true>(gates, c, h, dout, w4h, lengths, dxp, dwf, R, Tn, H, 1, rows, st);
  return (int)dispatch_backward<float, true>(gates, c, h, dout, w4h, lengths, dxp, dwf, R, Tn, H, 1, rows, st);
}

}  // extern "C"
