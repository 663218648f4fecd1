// Blockwise causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_bhsd.
//
// Layout: q (B, S, H, D), k/v (B, S, K, D), o (B, S, H, D), read and written
// through element strides (the last dimension must be contiguous), so the
// caller needs no transpose and no padding. H % K == 0; the kv head of query
// head h is h / (H / K).
//
// One block per (q tile of 64 rows, head, batch). Where the TPU runs the kv
// blocks as a sequential grid axis with the running max/denominator/output
// in VMEM scratch, here a loop inside the block walks the kv tiles from the
// first to the last one that the causal mask and the window allow (the
// Pallas kernel's `pl.when` skip), with the running state in registers:
//
//   * 256 threads; row r of the q tile belongs to the 4 adjacent threads
//     4r..4r+3 (one warp holds 8 rows), so row reductions are two shuffles.
//   * Q, K and V tiles are staged in shared memory as fp32 (loads convert
//     from the input type), rows padded by one word against bank conflicts.
//   * S = Q K^T: each thread computes 16 of its row's 64 scores; the scale
//     D**-0.5 is applied to the fp32 scores. Masked scores are -inf.
//   * Online softmax in fp32. A row whose max is still -inf uses 0 as its
//     reference, so exp(-inf - -inf) never happens; such a row keeps l = 0
//     and acc = 0, and is stored as exact zeros (the reference's l == 0
//     guard, kernel.py:85). Rows with a live key get the same softmax as the
//     reference's -1e30 convention.
//   * P goes through shared memory (each row only within its own warp);
//     each thread accumulates D/4 output columns of its row.
//
// No tensor cores, no TMA: this is the simple, correct first version. The
// bound on H100 is in kernel.py's note beside the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int COLS = BK / 4;  // scores per thread per kv tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Strides {
  long long b, s, h;  // element strides of one tensor; the last dim is 1
};

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK: (64, D + 1); sV: (64, D); sP: (64, 65) -- all fp32
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
                 int group, int S, int window, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row within the tile
  const int l4 = tid & 3;  // this thread's quarter of the row
  const int qi = q0 + r;   // absolute q position
  const float NEG = -INFINITY;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int pos = q0 + rr;
    sQ[rr * DP + d] = pos < S ? to_f32(qb[pos * qs.s + d]) : 0.f;
  }

  // kv tiles that can hold a live key for some row of this tile
  int t_end = (S + BK - 1) / BK;
  if (causal) t_end = min(t_end, min(q0 + BQ - 1, S - 1) / BK + 1);
  int t_begin = 0;
  if (window > 0) {
    const int kmin = q0 - window + 1;  // smallest key row q0 can see
    t_begin = kmin > 0 ? kmin / BK : 0;
  }

  float m = NEG, l = 0.f;
  float acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) acc[i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V are consumed (and Q is staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const int pos = k0 + rr;
      const bool in = pos < S;
      sK[rr * DP + d] = in ? to_f32(kb[pos * ks.s + d]) : 0.f;
      sV[rr * D + d] = in ? to_f32(vb[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = sQ[r * DP + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[j] += qv * sK[(l4 + 4 * j) * DP + d];
    }

    float mx = NEG;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int kpos = k0 + l4 + 4 * j;
      bool live = kpos < S;
      if (causal) live = live && kpos <= qi;
      if (window > 0) live = live && kpos > qi - window;
      s[j] = live ? s[j] * scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_ref = m_new == NEG ? 0.f : m_new;
    const float corr = expf(m - m_ref);  // 0 while m is -inf
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = expf(s[j] - m_ref);
      rs += p;
      sP[r * (BK + 1) + l4 + 4 * j] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // row r's P is written and read by the same warp

#pragma unroll
    for (int i = 0; i < DC; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * (BK + 1) + c];
      const float* vr = sV + c * D + l4;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[i] += p * vr[4 * i];
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  if (qi < S) {
    const float denom = l == 0.f ? 1.f : l;
    T* ob = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DC; ++i) ob[l4 + 4 * i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int B, int H, int K, int S,
                   int window, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, H / K, S, window, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, seq,
// head) for each of q, k, v, o; the head_dim stride must be 1. Returns a
// cudaError_t (0 on success). Allocates nothing and does not synchronize.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int H, int K, int S, int D, int window, int causal,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, qs, ks, vs, os, B, H, K, S, window, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, qs, ks, vs, os, B, H, K, S, window, causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, qs, ks, vs, os, B, H, K, S, window,
                                          causal, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, qs, ks, vs, os, B, H, K, S, window,
                                           causal, st);
  return (int)cudaErrorInvalidValue;
}
