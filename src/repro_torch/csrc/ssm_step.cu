// Mamba2 decode step (one token a sequence) for Hopper, sm_90a: the mixer's
// recurrence from the in-projection's output to the gated norm's input.
//
// Replaces no TPU kernel: the JAX package's decode step is plain jnp
// (repro/models/ssm.py::mamba2_mixer_step and ::ssd_step), which XLA fuses on
// the TPU. Eager PyTorch runs the same code as about 30 kernels a layer, five
// of them full passes over the fp32 state; here it is two kernels a layer,
// and the state is read once and written once, in place.
//
// Layout (element strides; the last dimension of every operand is 1):
//   xbc      (B, C) the in-projection's x|B|C columns, C = H*P + 2N, rows xbc_sb apart
//   dt       (B, H) the in-projection's raw dt columns, rows dt_sb apart
//   conv_buf (B, K-1, C) the last K-1 inputs of the conv, rows buf_sb, steps buf_sk apart
//   conv_w   (K, C), conv_b (C), dt_bias, A_log, D (H): contiguous
//   conv     (B, C) scratch: the conv step's output, contiguous
//   state    (B, H, P, N) fp32, contiguous, 16-byte aligned
//   y        (B, H, P), contiguous
// K = 4. x, dt, the buffer, the weights, conv and y share one type T (float
// or bfloat16); the state is fp32.
//
// 1. conv_step, one thread per (batch, channel): the depthwise causal conv
//    over the window [conv_buf | xbc] with f32 accumulation, the bias and the
//    SiLU, each rounded to T where the plain path rounds (the window's
//    product, the bias add, the SiLU); then the window shifts in place. A
//    channel has one owner, so the shift races with nothing.
// 2. state_step, one block per (tile of 512 float4 of a head's state, head,
//    batch), 128 threads, four float4 a thread loaded before any is used:
//      dt'   = softplus(dt + dt_bias), A = -exp(A_log), dA = exp(dt' A)
//      state = state dA + (dt' x_p) B_n              (f32, written in place)
//      y_p   = sum_n C_n state_pn + D x_p            (f32, one rounding to T)
//    A row of N/4 float4 sits on N/4 neighbouring lanes, whose partial sums
//    meet by warp shuffles. B and C are shared by the heads: each block reads
//    them from conv, written by step 1. They are two kernels because a single
//    one would have every head's block read the shared B/C window while the
//    block that owns it shifts it.
//
// Bound: bytes. The state's read and write are 2 B H P N 4 bytes, 16.8 MB at
// mamba2-370m's decode shape (B=8, H=32, P=64, N=128): 5.0 us at 3.35 TB/s.
// The conv step's bytes are about 13 B C 2 (0.5 MB there); the update does 4
// FLOP per 8 bytes of state, so no tensor core helps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int K = 4;         // conv width
constexpr int MAX_P = 64;    // head dim
constexpr int MAX_N = 128;   // state dim: a power of two from 4
constexpr int CONV_THREADS = 256;
constexpr int STATE_THREADS = 128;
constexpr int STATE_ITER = 4;  // float4 of state a thread
constexpr int TILE = STATE_THREADS * STATE_ITER;  // float4 of state a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T and back: the rounding a plain op with a T result makes
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
conv_step(const T* __restrict__ xbc, long long xbc_sb, T* __restrict__ buf, long long buf_sb,
          long long buf_sk, const T* __restrict__ w, const T* __restrict__ bias,
          T* __restrict__ conv, int C) {
  const int c = blockIdx.x * CONV_THREADS + threadIdx.x;
  const long long b = blockIdx.y;
  if (c >= C) return;
  T* win = buf + b * buf_sb + c;
  T x[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) x[k] = win[k * buf_sk];
  x[K - 1] = xbc[b * xbc_sb + c];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) acc = fmaf(to_f32(x[k]), to_f32(w[(long long)k * C + c]), acc);
  const float v = round_to<T>(round_to<T>(acc) + to_f32(bias[c]));
  conv[b * C + c] = from_f32<T>(v / (1.f + expf(-v)));
#pragma unroll
  for (int k = 0; k < K - 1; ++k) win[k * buf_sk] = x[k + 1];
}

template <typename T>
__global__ void __launch_bounds__(STATE_THREADS)
state_step(float* __restrict__ state, const T* __restrict__ conv, const T* __restrict__ dt,
           long long dt_sb, const T* __restrict__ dt_bias, const T* __restrict__ A_log,
           const T* __restrict__ D, T* __restrict__ y, int H, int P, int N) {
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int C = H * P + 2 * N;
  const int shift = __ffs(N) - 3;  // log2 of the float4 a row
  const int lpr = 1 << shift;
  const int units = P << shift;  // float4 of the head's state
  const int e0 = blockIdx.x * TILE + threadIdx.x;
  float4* st = reinterpret_cast<float4*>(state + (b * H + h) * (long long)P * N);

  float4 s[STATE_ITER];
#pragma unroll
  for (int i = 0; i < STATE_ITER; ++i) {
    const int e = e0 + i * STATE_THREADS;
    s[i] = e < units ? st[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the head's decay, in every thread (the same few f32 operations)
  const float v = to_f32(dt[b * dt_sb + h]) + to_f32(dt_bias[h]);
  const float dt1 = v > 20.f ? v : log1pf(expf(v));
  const float dA = expf(dt1 * -expf(to_f32(A_log[h])));
  const float d = to_f32(D[h]);
  // a thread's four columns of B and C are the same in every row it holds
  const T* row = conv + b * C;
  const int n0 = 4 * (threadIdx.x & (lpr - 1));
  float Bn[4], Cn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Bn[k] = to_f32(row[H * P + n0 + k]);
    Cn[k] = to_f32(row[H * P + N + n0 + k]);
  }
#pragma unroll
  for (int i = 0; i < STATE_ITER; ++i) {
    const int e = e0 + i * STATE_THREADS;
    const bool live = e < units;  // a row's lanes are all live or all not
    const int p = e >> shift;
    const float xp = live ? to_f32(row[h * P + p]) : 0.f;
    const float u = dt1 * xp;
    float4 t = s[i];
    t.x = fmaf(t.x, dA, u * Bn[0]);
    t.y = fmaf(t.y, dA, u * Bn[1]);
    t.z = fmaf(t.z, dA, u * Bn[2]);
    t.w = fmaf(t.w, dA, u * Bn[3]);
    float part = Cn[0] * t.x + Cn[1] * t.y + Cn[2] * t.z + Cn[3] * t.w;
    for (int off = lpr >> 1; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (live) {
      st[e] = t;
      if ((threadIdx.x & (lpr - 1)) == 0)
        y[(b * H + h) * (long long)P + p] = from_f32<T>(fmaf(d, xp, part));
    }
  }
}

template <typename T>
cudaError_t launch(const void* xbc, long long xbc_sb, const void* dt, long long dt_sb,
                   void* buf, long long buf_sb, long long buf_sk, const void* w, const void* bias,
                   const void* dt_bias, const void* A_log, const void* D, void* conv,
                   void* state, void* y, int Bsz, int H, int P, int N, cudaStream_t stream) {
  const int C = H * P + 2 * N;
  const T* x = static_cast<const T*>(xbc);
  T* cv = static_cast<T*>(conv);
  conv_step<T><<<dim3((C + CONV_THREADS - 1) / CONV_THREADS, Bsz), CONV_THREADS, 0, stream>>>(
      x, xbc_sb, static_cast<T*>(buf), buf_sb, buf_sk, static_cast<const T*>(w),
      static_cast<const T*>(bias), cv, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int units = P * (N / 4);
  state_step<T><<<dim3((units + TILE - 1) / TILE, H, Bsz), STATE_THREADS, 0, stream>>>(
      static_cast<float*>(state), cv, static_cast<const T*>(dt), dt_sb,
      static_cast<const T*>(dt_bias), static_cast<const T*>(A_log), static_cast<const T*>(D),
      static_cast<T*>(y), H, P, N);
  return cudaGetLastError();
}

}  // namespace

// One decode step of a Mamba2 layer: writes conv (scratch) and y, and
// updates conv_buf and state in place. dtype 0 = float32, 1 = bfloat16.
// Returns the first launch's cudaError_t (0 on success).
extern "C" int mamba2_step_fwd(
    const void* xbc, long long xbc_sb, const void* dt, long long dt_sb,
    void* conv_buf, long long buf_sb, long long buf_sk,
    const void* conv_w, const void* conv_b, const void* dt_bias, const void* A_log,
    const void* D, void* conv, void* state, void* y,
    int Bsz, int H, int P, int N, int dtype, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || H > 65535 || P <= 0 || P > MAX_P || N < 4 ||
      N > MAX_N || (N & (N - 1)) != 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(state) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xbc, xbc_sb, dt, dt_sb, conv_buf, buf_sb, buf_sk, conv_w, conv_b,
                              dt_bias, A_log, D, conv, state, y, Bsz, H, P, N, st);
  return (int)launch<bf16>(xbc, xbc_sb, dt, dt_sb, conv_buf, buf_sb, buf_sk, conv_w, conv_b,
                           dt_bias, A_log, D, conv, state, y, Bsz, H, P, N, st);
}
