// Mamba2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsp (body `_ssd_kernel`).
//
// Layout: x (B, S, H, P) pre-multiplied by dt, a (B, S, H), Bm and Cm
// (B, S, N), y (B, S, H, P), all read and written through element strides
// (the last dimension of x, Bm, Cm and y must be contiguous), so the caller
// needs no transpose and no padding. The initial state s0 and the final
// state are (B, H, P, N) fp32, contiguous; s0 may be null (zeros).
//
// For each chunk of `chunk` steps, with a_cs the cumulative sum of a over
// the chunk (fp32):
//
//   y      = ((C B^T) o exp(segsum a)) x + exp(a_cs) . (C state^T)
//   state' = exp(a_cs[-1]) state + x^T (B . exp(a_cs[-1] - a_cs))
//
// Where the TPU runs the chunks as a sequential grid axis with the (P, N)
// state in VMEM scratch, here one block owns one (batch, head) pair and
// loops over the chunks itself, with the state in shared memory:
//
//   * 256 threads. The chunk's a (and its cumsum), B, C and x are staged in
//     shared memory as fp32 (loads convert from the input type), rows padded
//     by one word against bank conflicts.
//   * y: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16r (r < 8) and
//     columns tx + 16q (q < 4) of the chunk's (L, P) output, in registers.
//     First the inter-chunk term C state^T, scaled by exp(a_cs[i]); then the
//     intra-chunk term, column block by column block: a (L, 32) tile of
//     (C B^T) o exp(segsum) is formed in shared memory, then multiplied by
//     the matching 32 rows of x. exp(a_cs[i] - a_cs[j]) is evaluated only
//     for i >= j: above the diagonal the exponent is positive and may
//     overflow, and inf * 0 would be NaN; there the tile holds exact zeros.
//     Tiles wholly above the diagonal are skipped.
//   * state: thread (tp, tn) of an 8 x 32 grid owns rows tp + 8r (r < 8)
//     and columns tn + 32q (q < 4) of the (P, N) state, and updates them in
//     place after the chunk's y is done with the old state.
//   * The ragged tail: steps at or past S are loaded as x = B = C = a = 0,
//     which are the reference's identity padding steps (the state passes
//     through unchanged), and their y rows are not stored.
//
// No tensor cores, no TMA: this is the simple, correct first version. The
// bound on H100 is in kernel.py's note beside the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 128;  // chunk
constexpr int MAX_P = 64;   // head dim
constexpr int MAX_N = 128;  // state dim
constexpr int JB = 32;      // columns of one (C B^T) tile
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Strides {
  long long b, s, h;  // element strides (batch, seq, head); the last dim is 1
};

size_t smem_bytes(int L, int P, int N) {
  // sB, sC: (L, N + 1); sX: (L, P + 1); state: (P, N + 1); tile: (L, JB + 1);
  // a_cs and the decay to the chunk's end: (L) each -- all fp32
  return sizeof(float) * ((size_t)2 * L * (N + 1) + (size_t)L * (P + 1) +
                          (size_t)P * (N + 1) + (size_t)L * (JB + 1) + 2 * (size_t)L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ fin, Strides xs, Strides as, Strides bs, Strides cs,
                Strides ys, int S, int H, int P, int N, int L) {
  const int NP = N + 1, PP = P + 1, TP = JB + 1;
  extern __shared__ float smem[];
  float* sB = smem;             // (L, N + 1)
  float* sC = sB + L * NP;      // (L, N + 1)
  float* sX = sC + L * NP;      // (L, P + 1)
  float* sSt = sX + L * PP;     // (P, N + 1)
  float* sT = sSt + P * NP;     // (L, JB + 1)
  float* sCs = sT + L * TP;     // (L)
  float* sDe = sCs + L;         // (L)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // y and tile grid, 16 x 16
  const int tp = tid >> 5, tn = tid & 31;  // state grid, 8 x 32

  const T* xb = x + b * xs.b + h * xs.h;
  const T* ab = a + b * as.b + h * as.h;
  const T* Bb = Bm + b * bs.b;
  const T* Cb = Cm + b * cs.b;
  T* yb = y + b * ys.b + h * ys.h;
  const size_t st_off = ((size_t)b * H + h) * (size_t)P * N;

  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    sSt[p * NP + n] = s0 ? s0[st_off + i] : 0.f;
  }

  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's tiles and state are consumed
    for (int i = tid; i < L * N; i += THREADS) {
      const int l = i / N, n = i % N;
      const int t = t0 + l;
      const bool in = t < S;
      sB[l * NP + n] = in ? to_f32(Bb[t * bs.s + n]) : 0.f;
      sC[l * NP + n] = in ? to_f32(Cb[t * cs.s + n]) : 0.f;
    }
    for (int i = tid; i < L * P; i += THREADS) {
      const int l = i / P, p = i % P;
      const int t = t0 + l;
      sX[l * PP + p] = t < S ? to_f32(xb[t * xs.s + p]) : 0.f;
    }
    if (tid < 32) {
      // inclusive cumsum of a over the chunk: lane l sums steps 4l..4l+3,
      // then a warp scan of the lane totals
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = 4 * tid + k;
        const int t = t0 + l;
        run += (l < L && t < S) ? to_f32(ab[t * as.s]) : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = 4 * tid + k;
        if (l < L) sCs[l] = excl + v[k];
      }
    }
    __syncthreads();
    const float cs_end = sCs[L - 1];
    for (int l = tid; l < L; l += THREADS) sDe[l] = expf(cs_end - sCs[l]);

    // ---- y, inter-chunk term: exp(a_cs[i]) * sum_n C[i, n] state[p, n]
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        cv[r] = i < L ? sC[i * NP + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        sv[q] = p < P ? sSt[p * NP + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * sv[q];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float d = i < L ? expf(sCs[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= d;
    }

    // ---- y, intra-chunk term, one (L, JB) tile of (C B^T) o exp(segsum) at a time
    for (int j0 = 0; j0 < L; j0 += JB) {
      const int r0 = j0 / 16;  // rows ty + 16r below r0 * 16 lie above the diagonal
      __syncthreads();        // the previous tile is consumed
      float sc[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) sc[r][0] = sc[r][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + tx + 16 * q;
          bv[q] = j < L ? sB[j * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ty + 16 * r;
          if (r >= r0 && i < L) {
            const float cv = sC[i * NP + n];
            sc[r][0] += cv * bv[0];
            sc[r][1] += cv * bv[1];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i >= L) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int jj = tx + 16 * q;
          const int j = j0 + jj;
          // exp only on and below the diagonal; exact zeros above it
          sT[i * TP + jj] = (j <= i && j < L) ? sc[r][q] * expf(sCs[i] - sCs[j]) : 0.f;
        }
      }
      __syncthreads();
      const int jn = min(JB, L - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          xv[q] = p < P ? sX[(j0 + jj) * PP + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ty + 16 * r;
          if (r >= r0 && i < L) {
            const float tv = sT[i * TP + jj];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += tv * xv[q];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const int t = t0 + i;
      if (i >= L || t >= S) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) yb[t * ys.s + p] = from_f32<T>(acc[r][q]);
      }
    }

    // ---- state' = exp(a_cs[-1]) state + x^T (B . exp(a_cs[-1] - a_cs))
    __syncthreads();  // every thread's y is done with the old state
    float su[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) su[r][q] = 0.f;
    for (int l = 0; l < L; ++l) {
      const float de = sDe[l];
      float bw[4], xv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = tn + 32 * q;
        bw[q] = n < N ? sB[l * NP + n] * de : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int p = tp + 8 * r;
        xv[r] = p < P ? sX[l * PP + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) su[r][q] += xv[r] * bw[q];
    }
    const float decay = expf(cs_end);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int p = tp + 8 * r;
      if (p >= P) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = tn + 32 * q;
        if (n < N) sSt[p * NP + n] = sSt[p * NP + n] * decay + su[r][q];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    fin[st_off + i] = sSt[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* Bm, const void* Cm,
                   const float* s0, void* y, float* fin, Strides xs, Strides as, Strides bs,
                   Strides cs, Strides ys, int Bsz, int S, int H, int P, int N, int L,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), fin, xs, as, bs, cs, ys, S, H, P, N, L);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a, Bm, Cm and y share it). Strides
// are in elements: (batch, seq, head) for x, a and y, (batch, seq, -) for Bm
// and Cm; the last dimension of x, Bm, Cm and y must be contiguous. s0 (may
// be null) and fin are contiguous (B, H, P, N) fp32. Returns a cudaError_t
// (0 on success). Allocates nothing and does not synchronize.
extern "C" int ssd_scan_fwd(
    const void* x, const void* a, const void* Bm, const void* Cm, const void* s0,
    void* y, void* fin,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss,
    long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh,
    int Bsz, int S, int H, int P, int N, int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N ||
      chunk <= 0 || chunk > MAX_L)
    return (int)cudaErrorInvalidValue;
  const Strides xs{x_sb, x_ss, x_sh}, as{a_sb, a_ss, a_sh}, bs{b_sb, b_ss, 0},
      cs{c_sb, c_ss, 0}, ys{y_sb, y_ss, y_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s0f = static_cast<const float*>(s0);
  float* finf = static_cast<float*>(fin);
  if (dtype == 0)
    return (int)launch<float>(x, a, Bm, Cm, s0f, y, finf, xs, as, bs, cs, ys, Bsz, S, H, P, N,
                              chunk, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, a, Bm, Cm, s0f, y, finf, xs, as, bs, cs, ys, Bsz, S, H,
                                      P, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}
