// LSTM recurrence kernels for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Three kernels carry the BSRNN inference path:
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

// One cell update: returns h, updates c.
__device__ __forceinline__ float cell(const float (&a)[4], float& c) {
  const float i_g = sigmoid_f(a[0]);
  const float f_g = sigmoid_f(a[1]);
  const float g_g = tanhf(a[2]);
  const float o_g = sigmoid_f(a[3]);
  c = f_g * c + i_g * g_g;
  return o_g * tanhf(c);
}

// K2 (MASKED = false) and K3 (MASKED = true, reverse = 1).
template <typename T, int ROWS, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
recurrence_kernel(const T* __restrict__ xp, const T* __restrict__ whh_t,
                  const int* __restrict__ lengths, T* __restrict__ out, int R,
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
          out[((size_t)(r0 + r) * Tn + t) * H + u] = from_f<T>(h);
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

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

int threads_for(int H) { return (H + 31) / 32 * 32; }

template <typename T, int ROWS, bool MASKED>
cudaError_t run_recurrence(const void* xp, const void* whh_t, const int* lengths,
                           void* out, int R, int Tn, int H, int reverse,
                           cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * H * sizeof(float);
  auto kern = recurrence_kernel<T, ROWS, MASKED>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + ROWS - 1) / ROWS), threads_for(H), smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(whh_t), lengths,
      static_cast<T*>(out), R, Tn, H, reverse);
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

template <typename T, bool MASKED>
cudaError_t dispatch_recurrence(const void* xp, const void* whh_t, const int* lengths,
                                void* out, int R, int Tn, int H, int reverse, int rows,
                                cudaStream_t st) {
  switch (rows) {
    case 1: return run_recurrence<T, 1, MASKED>(xp, whh_t, lengths, out, R, Tn, H, reverse, st);
    case 2: return run_recurrence<T, 2, MASKED>(xp, whh_t, lengths, out, R, Tn, H, reverse, st);
    case 4: return run_recurrence<T, 4, MASKED>(xp, whh_t, lengths, out, R, Tn, H, reverse, st);
    default: return run_recurrence<T, 8, MASKED>(xp, whh_t, lengths, out, R, Tn, H, reverse, st);
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
    return (int)dispatch_recurrence<__nv_bfloat16, false>(xp, whh_t, nullptr, out, R, Tn, H, reverse, rows, st);
  return (int)dispatch_recurrence<float, false>(xp, whh_t, nullptr, out, R, Tn, H, reverse, rows, st);
}

int lstm_revmasked(const void* xp, const void* whh_t, const int* lengths, void* out,
                   int R, int Tn, int H, int dtype, int rows, void* stream) {
  if (bad_shape(R, Tn, H, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_recurrence<__nv_bfloat16, true>(xp, whh_t, lengths, out, R, Tn, H, 1, rows, st);
  return (int)dispatch_recurrence<float, true>(xp, whh_t, lengths, out, R, Tn, H, 1, rows, st);
}

}  // extern "C"
