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
// For each chunk c of L steps, with a_cs the cumulative sum of a over the
// chunk (fp32) and prev the state that enters the chunk:
//
//   y      = ((C B^T) o exp(segsum a)) x + exp(a_cs) . (C prev^T)
//   S_c    = x^T (B . exp(a_cs[-1] - a_cs))          (the chunk's own state)
//   state' = exp(a_cs[-1]) prev + S_c
//
// Where the TPU walks the chunks as a sequential grid axis with the state in
// VMEM, here the scan is split into the SSD paper's chunk-parallel phases
// (arXiv:2405.21060 section 6), kernels on one stream:
//
//   1. ssd_chunk_state, one block per (chunk, head, batch): a_cs by a warp
//      scan, S_c and the chunk's decay exp(a_cs[-1]), written to fp32
//      scratch (B, H, nc, P, N) and (B, H, nc).
//   2. ssd_state_pass, one block per (P*N tile, head, batch), elementwise:
//      carry = carry * decay_c + S_c over the chunks in order, from s0 or
//      zeros; S_c is overwritten by the state that enters chunk c, and the
//      last carry is the final state. The only sequential part; each
//      thread keeps four chunks' loads in flight.
//   3. ssd_chunk_scan: a_cs again, and y from C, B, x and the entering
//      state.
//
// exp(a_cs[i] - a_cs[j]) is evaluated only on and below the diagonal
// (j <= i): above it the exponent is positive and may overflow, and inf * 0
// would be NaN; there the scores are exact zeros. Steps at or past S (the
// ragged last chunk) are loaded as x = B = C = a = 0, the reference's
// identity padding steps, and their y rows are not stored.
//
// bfloat16: the four products on the tensor cores with `wgmma` (fp32
// accumulators), operands in 128-byte-swizzled shared memory. Three fp32
// factors are fed as bf16 pairs, v = hi + lo with hi = bf16(v) and
// lo = bf16(v - hi), two products each: x . decay, the entering state and
// the decayed scores. (One bf16 rounding of the decayed scores lies past
// the 2e-2 bar at N = 128: unlike softmax weights they are not bounded by
// 1, and 128 of them sum into each y.)
//   * chunk_state (one warpgroup): S_c (P x N) = (x . decay)^T B, both
//     MN-major as they lie (rows of l).
//   * chunk_scan, one block per (chunk, group of HG heads, batch), two
//     warpgroups of 64 rows (the first needs only keys 0-63). C and B are
//     staged once and the scores C B^T (both K-major as they lie) formed
//     once in registers; then per head C prev^T (the state K-major, rows
//     of P), the rows scaled by exp(a_cs) in registers, and (scores o
//     decay) x with the scores as the register A operand and x MN-major,
//     into the same accumulator. x, the state and a_cs of the next head
//     are copied while this one computes.
//
// float32: CUDA cores (TF32 stays off), register micro-tiles read as float4
// from rows padded against bank conflicts, and a fourth kernel:
//   * ssd_chunk_cb forms C B^T once per (chunk, batch) for every head, in
//     64 x 64 tiles on and below the diagonal, into fp32 scratch
//     (B, nc, L, L).
//   * chunk_state: 8 x 4 micro-tiles laid out so a float4 read of x or B
//     takes one shared-memory wavefront; narrow states split the steps
//     over thread groups and sum their partial tiles.
//   * chunk_scan, one block per (chunk, head, batch): C prev^T, then the
//     decayed scores a key block at a time, times x. C and the scores
//     share one region and the state and x another, so two blocks fit on
//     an SM.
//
// Inputs arrive by 16-byte `cp.async` where the pointers, strides and row
// widths allow it, else by narrower loads inside the kernel.
//
// The bound on H100 is in kernel.py's note beside the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_L = 128;  // chunk
constexpr int MAX_P = 64;   // head dim
constexpr int MAX_N = 128;  // state dim
constexpr int THREADS = 256;
constexpr int XP = MAX_P + 4;  // f32 row pitch of x and the score tile (floats)

struct Strides {
  long long b, s, h;  // element strides (batch, seq, head); the last dim is 1
};

// One call's shape, and which operands take 16-byte copies.
struct Shape {
  int S, H, P, N, L, nc;
  int vec_x, vec_bc, vec_y, vec_st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Inclusive cumsum of a over the chunk's L (<= 128) steps into sCs, by one
// warp: lane l sums steps 4l..4l+3, then a warp scan of the lane totals.
// Steps at or past S count as 0.
template <typename T>
__device__ __forceinline__ void chunk_cumsum(float* sCs, const T* ab, long long a_ss, int t0,
                                             int L, int S, int lane) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = 4 * lane + k;
    const int t = t0 + l;
    run += (l < L && t < S) ? to_f32(ab[t * a_ss]) : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = 4 * lane + k;
    if (l < L) sCs[l] = excl + v[k];
  }
}

// Rows [0, rows) x columns [0, cols) of an fp32 tile with row pitch
// `pitch`: row r < nvalid and column c < ncols from src (row r at
// src + r * rs), zeros elsewhere. cols is a multiple of 4. With vec
// (ncols % 4 == 0, src and rs 16-byte aligned) by cp.async, one commit
// group left open; else by plain loads.
__device__ __forceinline__ void stage_f32(float* dst, int pitch, const float* src, long long rs,
                                          int rows, int nvalid, int ncols, int cols, bool vec,
                                          int tid) {
  if (vec) {
    const int q = cols / 4;
    for (int i = tid; i < rows * q; i += THREADS) {
      const int r = i / q, c = (i % q) * 4;
      const bool valid = r < nvalid && c < ncols;
      cp_async16(smem_u32(dst + r * pitch + c), valid ? src + r * rs + c : src, valid);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i % cols;
      dst[r * pitch + c] = (r < nvalid && c < ncols) ? src[r * rs + c] : 0.f;
    }
  }
}

// Byte offset of element (r, c) of a bf16 tile of `rows` rows in the
// 128-byte-swizzled layout the wgmma descriptors name: column halves of
// 64 (rows * 128 bytes apart), rows of 128 bytes, 16-byte chunks XOR-ed
// with row % 8.
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (c >> 6) * (rows * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_pair(uint8_t* tile, uint32_t off, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + off) = wg::pack_bf16(lo, hi);
}

// Two fp32 values as bf16 pairs, v = hi + lo to about 16 bits:
// hi = bf16(v), lo = bf16(v - hi) (v - hi is exact in fp32).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = wg::pack_bf16(v0 - hf.x, v1 - hf.y);
}

// A bf16 tile in the swizzled layout: rows [0, rows) x columns [0, cols)
// (cols a multiple of 16), row r < nvalid and column c < ncols from src,
// zeros elsewhere. With vec (ncols % 8 == 0, src and rs 16-byte aligned) by
// cp.async, one commit group left open; else by 2-byte loads.
__device__ __forceinline__ void stage_bf16(uint8_t* tile, const bf16* src, long long rs, int rows,
                                           int nvalid, int ncols, int cols, bool vec, int tid,
                                           int nthreads) {
  const uint32_t base = smem_u32(tile);
  if (vec) {
    const int q = cols / 8;
    for (int i = tid; i < rows * q; i += nthreads) {
      const int r = i / q, c = (i % q) * 8;
      const bool valid = r < nvalid && c < ncols;
      cp_async16(base + sw_off(r, c, rows), valid ? src + r * rs + c : src, valid);
    }
  } else {
    const int q = cols / 2;
#pragma unroll 4
    for (int i = tid; i < rows * q; i += nthreads) {
      const int r = i / q, c = (i % q) * 2;
      const bool in = r < nvalid;
      const float lo = in && c < ncols ? __bfloat162float(src[r * rs + c]) : 0.f;
      const float hi = in && c + 1 < ncols ? __bfloat162float(src[r * rs + c + 1]) : 0.f;
      st_pair(tile, sw_off(r, c, rows), lo, hi);
    }
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void fence_async() {  // generic-proxy writes -> wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor offset (in 16-byte units) of the 16-column k step kk of a
// K-major tile of `rows` rows
__device__ __forceinline__ uint64_t kstep(int kk, int rows) {
  return (uint64_t)(((kk >> 2) * (rows * 128) + (kk & 3) * 32) >> 4);
}

// ============================================================ state_pass
// carry = carry * decay_c + S_c over the chunks; S_c <- the entering state.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decays,
               const float* __restrict__ s0, float* __restrict__ fin, int H, int nc, int PN,
               int vec) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (i >= PN) return;
  float* st = states + bh * nc * PN + i;
  const float* dec = decays + bh * nc;
  if (vec) {  // PN % 4 == 0, every pointer 16-byte aligned
    float4 carry = s0 ? *reinterpret_cast<const float4*>(s0 + bh * PN + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nc; c0 += 4) {
      float4 v[4];
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < nc) {
          v[k] = *reinterpret_cast<const float4*>(st + (size_t)(c0 + k) * PN);
          d[k] = dec[c0 + k];
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < nc) {
          *reinterpret_cast<float4*>(st + (size_t)(c0 + k) * PN) = carry;
          carry = make_float4(carry.x * d[k] + v[k].x, carry.y * d[k] + v[k].y,
                              carry.z * d[k] + v[k].z, carry.w * d[k] + v[k].w);
        }
    }
    *reinterpret_cast<float4*>(fin + bh * PN + i) = carry;
  } else {
    const int w = min(4, PN - i);
    for (int e = 0; e < w; ++e) {
      float carry = s0 ? s0[bh * PN + i + e] : 0.f;
      for (int c = 0; c < nc; ++c) {
        const float v = st[(size_t)c * PN + e];
        st[(size_t)c * PN + e] = carry;
        carry = carry * dec[c] + v;
      }
      fin[bh * PN + i + e] = carry;
    }
  }
}

// ======================================================= bfloat16: wgmma
namespace tc {

// chunk_state: 128 threads (one warpgroup). x . decay as a bf16 pair (two
// MN-major A tiles of 128 rows l x 64 p) and B as it lies (an MN-major B
// tile of 128 rows l x NW, N padded to 64 or 128), in swizzled shared
// memory.
__host__ __device__ constexpr int state_smem(int NW) { return 1024 + 2 * 128 * 128 + 128 * NW * 2 + MAX_L * 4; }

template <int NW>
__global__ void __launch_bounds__(128)
ssd_chunk_state_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a,
                     const bf16* __restrict__ Bm, float* __restrict__ states,
                     float* __restrict__ decays, Strides xs, Strides as, Strides bs, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sXh = align1024(smem_raw);  // x . decay, hi
  uint8_t* sXl = sXh + 128 * 128;      // ... and lo
  uint8_t* sB = sXl + 128 * 128;       // B: NW / 64 column halves of 128 rows
  float* sCs = reinterpret_cast<float*>(sB + 128 * NW * 2);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int L = sh.L, t0 = c * L, nvalid = min(L, sh.S - t0);
  const int LK = round_up(L, 16);
  stage_bf16(sB, Bm + b * bs.b + t0 * bs.s, bs.s, 128, nvalid, sh.N, NW, sh.vec_bc, tid, 128);
  cp_async_commit();
  if (tid < 32) chunk_cumsum(sCs, a + b * as.b + h * as.h, as.s, t0, L, sh.S, tid);
  __syncthreads();
  const float cs_end = sCs[L - 1];
  // x . exp(a_cs[-1] - a_cs) as a bf16 pair, 8 columns (16 bytes) a step
  const bf16* xb = x + b * xs.b + h * xs.h + t0 * xs.s;
#pragma unroll 4
  for (int i = tid; i < LK * 8; i += 128) {
    const int l = i / 8, p0 = (i % 8) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (l < nvalid && p0 < sh.P) {
      const float de = expf(cs_end - sCs[l]);
      if (sh.vec_x) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + l * xs.s + p0);
        const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(pr[e]);
          v[2 * e] = f.x * de, v[2 * e + 1] = f.y * de;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (p0 + e < sh.P) v[e] = to_f32(xb[l * xs.s + p0 + e]) * de;
      }
    }
    uint4 hi, lo;
    split2(v[0], v[1], hi.x, lo.x);
    split2(v[2], v[3], hi.y, lo.y);
    split2(v[4], v[5], hi.z, lo.z);
    split2(v[6], v[7], hi.w, lo.w);
    const uint32_t off = sw_off(l, p0, 128);
    *reinterpret_cast<uint4*>(sXh + off) = hi;
    *reinterpret_cast<uint4*>(sXl + off) = lo;
  }
  cp_async_wait<0>();
  fence_async();
  __syncthreads();

  float acc[NW / 2];
#pragma unroll
  for (int k = 0; k < NW / 2; ++k) acc[k] = 0.f;
  // all MN-major: 16 rows of l = 2048 bytes a k step; B's halves 128 rows apart
  const uint64_t dh = wg::desc(smem_u32(sXh), 128 * 128, 1024);
  const uint64_t dl = wg::desc(smem_u32(sXl), 128 * 128, 1024);
  const uint64_t db = wg::desc(smem_u32(sB), 128 * 128, 1024);
  wg::wg_fence();
  for (int kk = 0; kk < LK / 16; ++kk) {
    wg::wgmma_ss<1, 1>(acc, dh + kk * (2048 >> 4), db + kk * (2048 >> 4), 1);
    wg::wgmma_ss<1, 1>(acc, dl + kk * (2048 >> 4), db + kk * (2048 >> 4), 1);
  }
  wg::wg_commit();
  wg::wg_wait<0>();
  wg::hold(acc);

  // acc[4cc + 2r + e]: p = row0 + 8r, n = 8cc + col0 + e
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const size_t PN = (size_t)sh.P * sh.N;
  float* out = states + (((size_t)b * sh.H + h) * sh.nc + c) * PN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + 8 * r;
    if (p >= sh.P) continue;
#pragma unroll
    for (int cc = 0; cc < NW / 8; ++cc) {
      const int n = 8 * cc + col0;
      if (n + 1 < sh.N && sh.N % 2 == 0) {
        *reinterpret_cast<float2*>(out + p * sh.N + n) = make_float2(acc[4 * cc + 2 * r], acc[4 * cc + 2 * r + 1]);
      } else {
        if (n < sh.N) out[p * sh.N + n] = acc[4 * cc + 2 * r];
        if (n + 1 < sh.N) out[p * sh.N + n + 1] = acc[4 * cc + 2 * r + 1];
      }
    }
  }
  if (tid == 0) decays[((size_t)b * sh.H + h) * sh.nc + c] = expf(cs_end);
}

// chunk_scan: 256 threads (two warpgroups of 64 rows; the first needs only
// keys 0-63) walk HG heads of one (chunk, batch) pair. C and B are staged
// once; with HG > 1 the scores C B^T are formed once and kept in
// registers, and x, the entering state (a bf16 pair) and a_cs are
// double-buffered per head, the next head's copied while this one
// computes. HG = 1 (one head a block, for narrow states, where C and B are
// small and more blocks an SM pay better) forms the scores a key block at
// a time and keeps one buffer. C and B are RT rows (64 or 128) of NH
// column halves, x RT rows of 64, the state 64 rows (p) of NH halves.
constexpr int HG_WIDE = 4;  // heads a block for N > 64
__host__ __device__ constexpr int scan_head_bytes(int RT, int NH) { return RT * 128 + 2 * 64 * 128 * NH; }
__host__ __device__ constexpr int scan_smem(int HG, int RT, int NH) {
  return 1024 + 2 * RT * 128 * NH + (HG > 1 ? 2 : 1) * (scan_head_bytes(RT, NH) + MAX_L * 4);
}

template <int HG>
__global__ void __launch_bounds__(THREADS, HG > 1 ? 1 : 2)
ssd_chunk_scan_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ states, bf16* __restrict__ y, Strides xs,
                    Strides as, Strides bs, Strides cs, Strides ys, Shape sh, int has_s0) {
  extern __shared__ uint8_t smem_raw[];
  const int L = sh.L, N = sh.N, P = sh.P;
  const int RT = L > 64 ? 128 : 64, NH = N > 64 ? 2 : 1, NK = round_up(N, 16) / 16;
  uint8_t* sC = align1024(smem_raw);
  uint8_t* sB = sC + RT * 128 * NH;
  uint8_t* sHead = sB + RT * 128 * NH;  // two buffers: x, state hi, state lo
  float* sCs = reinterpret_cast<float*>(sHead + (HG > 1 ? 2 : 1) * scan_head_bytes(RT, NH));
  auto bufX = [&](int k) { return sHead + k * scan_head_bytes(RT, NH); };
  auto bufPh = [&](int k) { return bufX(k) + RT * 128; };
  auto bufPl = [&](int k) { return bufPh(k) + 64 * 128 * NH; };

  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * HG, nh = min(HG, sh.H - h0);
  const int tid = threadIdx.x;
  const int t0 = c * L, nvalid = min(L, sh.S - t0);
  const bool has_prev = c > 0 || has_s0;
  stage_bf16(sC, Cm + b * cs.b + t0 * cs.s, cs.s, RT, nvalid, N, NK * 16, sh.vec_bc, tid, THREADS);
  stage_bf16(sB, Bm + b * bs.b + t0 * bs.s, bs.s, RT, nvalid, N, NK * 16, sh.vec_bc, tid, THREADS);

  // a head's entering state: this thread's quads (row p, columns n .. n+3)
  // in registers, then as a bf16 pair into the buffer
  const int quads = 64 * NK * 4;
  auto load_prev = [&](int h, float4 (&pv)[8]) {
    const float* st = states + (((size_t)b * sh.H + h) * sh.nc + c) * (size_t)P * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + THREADS * j, p = i / (NK * 4), n = 4 * (i % (NK * 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < quads && p < P) {
        if (sh.vec_st && n + 3 < N) {
          v = *reinterpret_cast<const float4*>(st + p * N + n);
        } else {
          if (n < N) v.x = st[p * N + n];
          if (n + 1 < N) v.y = st[p * N + n + 1];
          if (n + 2 < N) v.z = st[p * N + n + 2];
          if (n + 3 < N) v.w = st[p * N + n + 3];
        }
      }
      pv[j] = v;
    }
  };
  auto store_prev = [&](int k, const float4 (&pv)[8]) {
    uint8_t *ph = bufPh(k), *pl = bufPl(k);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = tid + THREADS * j, p = i / (NK * 4), n = 4 * (i % (NK * 4));
      if (i >= quads) continue;
      uint32_t h01, l01, h23, l23;
      split2(pv[j].x, pv[j].y, h01, l01);
      split2(pv[j].z, pv[j].w, h23, l23);
      const uint32_t off = sw_off(p, n, 64);  // n % 8 is 0 or 4: the quad stays in one chunk
      *reinterpret_cast<uint2*>(ph + off) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(pl + off) = make_uint2(l01, l23);
    }
  };
  auto stage_head = [&](int k, int h) {  // x by cp.async (one commit group), a_cs by warp 0
    stage_bf16(bufX(k), x + b * xs.b + h * xs.h + t0 * xs.s, xs.s, RT, nvalid, P, 64, sh.vec_x,
               tid, THREADS);
    cp_async_commit();
    if (tid < 32) chunk_cumsum(sCs + k * MAX_L, a + b * as.b + h * as.h, as.s, t0, L, sh.S, tid);
  };

  float4 pv[8];
  stage_head(0, h0);
  if (has_prev) {
    load_prev(h0, pv);
    store_prev(0, pv);
  }
  cp_async_wait<0>();
  fence_async();
  __syncthreads();

  const int wgi = tid / 128;
  const bool rows = wgi * 64 < L;  // does this warpgroup hold rows of the chunk?
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rbase = wgi * 64;
  const int row0 = rbase + warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const uint64_t dC = wg::desc(smem_u32(sC) + rbase * 128, 16, 1024);
  const uint64_t dB = wg::desc(smem_u32(sB), 16, 1024);

  // the scores C B^T of key block jb
  auto scores = [&](float (&s)[32], int jb) {
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = 0.f;
    wg::wg_fence();
    for (int kk = 0; kk < NK; ++kk)
      wg::wgmma_ss<0, 0>(s, dC + kstep(kk, RT), dB + ((jb * 64 * 128) >> 4) + kstep(kk, RT), 1);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::hold(s);
  };
  // with HG > 1, key blocks 0 .. wgi once for every head
  float sS[HG > 1 ? 2 : 1][32];
  if (HG > 1 && rows) {
    scores(sS[0], 0);
    if (wgi == 1) scores(sS[HG > 1 ? 1 : 0], 1);
  }

  for (int k = 0; k < nh; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    const bool more = HG > 1 && k + 1 < nh;
    if (more) {  // the next head's copies, in flight while this one computes
      stage_bf16(bufX(nxt), x + b * xs.b + (h0 + k + 1) * xs.h + t0 * xs.s, xs.s, RT, nvalid, P,
                 64, sh.vec_x, tid, THREADS);
      cp_async_commit();
      if (has_prev) load_prev(h0 + k + 1, pv);
    }
    if (rows) {
      const float* cs_ = sCs + cur * MAX_L;
      float csr[2];  // a_cs of the rows row0, row0 + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) csr[r] = cs_[min(row0 + 8 * r, L - 1)];
      float acc[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] = 0.f;
      if (has_prev) {  // exp(a_cs_i) (C prev^T)_i
        const uint64_t dPh = wg::desc(smem_u32(bufPh(cur)), 16, 1024);
        const uint64_t dPl = wg::desc(smem_u32(bufPl(cur)), 16, 1024);
        wg::wg_fence();
        for (int kk = 0; kk < NK; ++kk) {
          wg::wgmma_ss<0, 0>(acc, dC + kstep(kk, RT), dPh + kstep(kk, 64), 1);
          wg::wgmma_ss<0, 0>(acc, dC + kstep(kk, RT), dPl + kstep(kk, 64), 1);
        }
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::hold(acc);
        const float ex[2] = {expf(csr[0]), expf(csr[1])};
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] *= ex[(q >> 1) & 1];
      }
      // + (scores o decay) x over key blocks of 64 on and below the diagonal
      const uint64_t dX = wg::desc(smem_u32(bufX(cur)), RT * 128, 1024);  // MN-major: 16 keys = 2048 bytes
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        if (jb > wgi) break;
        float(&sj)[32] = sS[HG > 1 ? jb : 0];
        if (HG == 1) scores(sS[0], jb);
        uint32_t pa[4][4], pl[4][4];  // the decayed scores as a bf16 pair, A fragments
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // fragment element 8 kk + 2 q + e: row row0 + 8 (q % 2), key 16 kk + 8 (q / 2) + col0 + e
              const int r = q & 1, i = row0 + 8 * r, j = jb * 64 + 16 * kk + 8 * (q >> 1) + col0 + e;
              w[e] = (j <= i && j < L) ? sj[8 * kk + 2 * q + e] * expf(csr[r] - cs_[j]) : 0.f;
            }
            split2(w[0], w[1], pa[kk][q], pl[kk][q]);
          }
        wg::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dxk = dX + ((jb * 64 * 128 + kk * 2048) >> 4);
          wg::wgmma_rs_n64(acc, pa[kk], dxk);
          wg::wgmma_rs_n64(acc, pl[kk], dxk);
        }
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::hold(acc);
        wg::hold(pa);
        wg::hold(pl);
      }
      const int h = h0 + k;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r, t = t0 + i;
        if (i >= L || t >= sh.S) continue;
        bf16* yr = y + b * ys.b + (long long)t * ys.s + h * ys.h;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int p = 8 * cc + col0;
          if (p + 1 < P && sh.vec_y) {
            *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                __floats2bfloat162_rn(acc[4 * cc + 2 * r], acc[4 * cc + 2 * r + 1]);
          } else {
            if (p < P) yr[p] = __float2bfloat16(acc[4 * cc + 2 * r]);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16(acc[4 * cc + 2 * r + 1]);
          }
        }
      }
    }
    if (more) {
      if (has_prev) store_prev(nxt, pv);
      if (tid < 32)
        chunk_cumsum(sCs + nxt * MAX_L, a + b * as.b + (h0 + k + 1) * as.h, as.s, t0, L, sh.S, tid);
    }
    cp_async_wait<0>();
    fence_async();
    __syncthreads();  // the next head's buffer is in; this head's is free
  }
}

}  // namespace tc

// ================================================= float32: CUDA cores
namespace f32 {

// chunk_state: 8 x 4 micro-tiles (rows 8 pg .. +7 of P, columns 4 ng .. +3
// of N); a tile takes NG = N4 / 4 x 8 threads, and when that is fewer than
// 256, KS = 256 / (8 NG) groups of threads take every KS-th step l and
// their partial tiles are summed through shared memory.
__host__ __device__ constexpr int state_tile_threads(int N4) { return 8 * (N4 / 4); }
__host__ __device__ constexpr int state_floats(int LR, int N4) {
  // staging (x, B) and, after the steps, the partial tiles share a region
  return (LR * (XP + N4 + 4) > 32 * (THREADS / state_tile_threads(N4) - 1) * state_tile_threads(N4)
              ? LR * (XP + N4 + 4)
              : 32 * (THREADS / state_tile_threads(N4) - 1) * state_tile_threads(N4));
}
__host__ __device__ constexpr int state_smem(int LR, int N4) { return 4 * (state_floats(LR, N4) + 2 * MAX_L); }

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ Bm, float* __restrict__ states,
                    float* __restrict__ decays, Strides xs, Strides as, Strides bs, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int L = sh.L, N = sh.N, P = sh.P;
  const int LR = round_up(L, 16), N4 = round_up(N, 4), NPP = N4 + 4;
  float* sX = smem;
  float* sB = sX + LR * XP;
  float* sCs = smem + state_floats(LR, N4);
  float* sDe = sCs + MAX_L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * L, nvalid = min(L, sh.S - t0);
  stage_f32(sX, XP, x + b * xs.b + h * xs.h + t0 * xs.s, xs.s, LR, nvalid, P, MAX_P, sh.vec_x, tid);
  stage_f32(sB, NPP, Bm + b * bs.b + t0 * bs.s, bs.s, LR, nvalid, N, N4, sh.vec_bc, tid);
  cp_async_commit();
  if (tid < 32) chunk_cumsum(sCs, a + b * as.b + h * as.h, as.s, t0, L, sh.S, tid);
  __syncthreads();
  const float cs_end = sCs[L - 1];
  for (int l = tid; l < L; l += THREADS) sDe[l] = expf(cs_end - sCs[l]);
  cp_async_wait<0>();
  __syncthreads();

  // a warp spans 4 row groups x 8 column quads where it can, so a float4
  // read of x or B takes one shared-memory wavefront
  const int NG = N4 / 4, ntile = state_tile_threads(N4), KS = THREADS / ntile;
  const int ks = tid / ntile, t = tid % ntile;
  int pg, ng;
  if (NG % 8 == 0) {
    const int lane = t % 32, w = t / 32;
    ng = (w % (NG / 8)) * 8 + lane % 8;
    pg = (w / (NG / 8)) * 4 + lane / 8;
  } else {
    ng = t % NG;
    pg = t / NG;
  }
  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  if (ks < KS) {
#pragma unroll 2
    for (int l = ks; l < nvalid; l += KS) {
      const float de = sDe[l];
      const float4 x0 = *reinterpret_cast<const float4*>(sX + l * XP + 8 * pg);
      const float4 x1 = *reinterpret_cast<const float4*>(sX + l * XP + 8 * pg + 4);
      const float4 bv = *reinterpret_cast<const float4*>(sB + l * NPP + 4 * ng);
      const float xe[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float be[4] = {bv.x * de, bv.y * de, bv.z * de, bv.w * de};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xe[u], be[v], acc[u][v]);
    }
  }
  if (KS > 1) {  // sum the partial tiles of the step groups into group 0's
    float* red = smem;
    const int stride = (KS - 1) * ntile;
    __syncthreads();  // staging is consumed
    if (ks > 0 && ks < KS)
#pragma unroll
      for (int k = 0; k < 32; ++k) red[k * stride + (ks - 1) * ntile + t] = acc[k / 4][k % 4];
    __syncthreads();
    if (ks == 0)
      for (int g = 0; g < KS - 1; ++g)
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k / 4][k % 4] += red[k * stride + g * ntile + t];
  }
  if (ks == 0) {
    float* out = states + (((size_t)b * sh.H + h) * sh.nc + c) * (size_t)P * N;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = 8 * pg + u, n = 4 * ng;
      if (p >= P) continue;
      if (sh.vec_st && n + 3 < N) {
        *reinterpret_cast<float4*>(out + p * N + n) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (n + v < N) out[p * N + n + v] = acc[u][v];
      }
    }
  }
  if (tid == 0) decays[((size_t)b * sh.H + h) * sh.nc + c] = expf(cs_end);
}

// chunk_cb: C B^T of one (chunk, batch) pair, which every head shares, in
// 64 x 64 tiles on and below the diagonal, into fp32 scratch (B, nc, L, L).
// A block per tile; thread (ty, tx) owns rows ty + 16 r, columns tx + 16 q.
constexpr int CB_T = 64;
__host__ __device__ constexpr int cb_smem(int N4) { return 4 * 2 * CB_T * (N4 + 4); }

__global__ void __launch_bounds__(THREADS)
ssd_chunk_cb_f32(const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ cb, Strides bs, Strides cs, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int L = sh.L, N = sh.N, N4 = round_up(N, 4), NPP = N4 + 4;
  float* sC = smem;
  float* sB = sC + CB_T * NPP;
  const int nt = (L + CB_T - 1) / CB_T, tiles = nt * (nt + 1) / 2;
  const int c = blockIdx.x / tiles, b = blockIdx.y;
  int it = 0, jt = blockIdx.x % tiles;  // the tile (it, jt), jt <= it
  while (jt > it) jt -= ++it;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * L, nvalid = min(L, sh.S - t0);
  const int i0 = it * CB_T, j0 = jt * CB_T;
  stage_f32(sC, NPP, Cm + b * cs.b + (t0 + i0) * cs.s, cs.s, CB_T, nvalid - i0, N, N4, sh.vec_bc, tid);
  stage_f32(sB, NPP, Bm + b * bs.b + (t0 + j0) * bs.s, bs.s, CB_T, nvalid - j0, N, N4, sh.vec_bc, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 2
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = *reinterpret_cast<const float4*>(sC + (ty + 16 * r) * NPP + n);
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(sB + (tx + 16 * q) * NPP + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[r][q] = fmaf(cv[r].x, bv[q].x, s[r][q]);
        s[r][q] = fmaf(cv[r].y, bv[q].y, s[r][q]);
        s[r][q] = fmaf(cv[r].z, bv[q].z, s[r][q]);
        s[r][q] = fmaf(cv[r].w, bv[q].w, s[r][q]);
      }
  }
  float* out = cb + ((size_t)b * sh.nc + c) * L * L;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= L) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j < L) out[i * L + j] = s[r][q];
    }
  }
}

// chunk_scan: two regions, so that two blocks fit on an SM: the first
// holds C (LR x NPP) and, once C prev^T is formed, the decayed scores of
// one key block (LR x XP); the second the entering state transposed
// (N4 x XP) and then x (LR x XP)
__host__ __device__ constexpr int scan_region1(int LR, int N4) { return LR * ((N4 + 4) > XP ? (N4 + 4) : XP); }
__host__ __device__ constexpr int scan_smem(int LR, int N4) {
  return 4 * (scan_region1(LR, N4) + (LR > N4 ? LR : N4) * XP + MAX_L);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ Cm, const float* __restrict__ cb,
                   const float* __restrict__ states, float* __restrict__ y, Strides xs,
                   Strides as, Strides cs, Strides ys, Shape sh, int has_s0) {
  extern __shared__ __align__(16) float smem[];
  const int L = sh.L, N = sh.N, P = sh.P;
  const int LR = round_up(L, 16), N4 = round_up(N, 4), NPP = N4 + 4;
  float* sC = smem;                        // C, then the scores
  float* sU = smem + scan_region1(LR, N4);  // entering state^T, then x
  float* sCs = sU + (LR > N4 ? LR : N4) * XP;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 r, columns 4 tx .. + 3
  const int t0 = c * L, nvalid = min(L, sh.S - t0);
  stage_f32(sC, NPP, Cm + b * cs.b + t0 * cs.s, cs.s, LR, nvalid, N, N4, sh.vec_bc, tid);
  cp_async_commit();
  // this thread's C B^T entries on and below the diagonal, both key blocks
  // (rows ty + 16 r of block jb, r >= 4 jb), loaded while the tiles arrive
  const float* cbb = cb + ((size_t)b * sh.nc + c) * L * L;
  float g[2][8][4];
#pragma unroll
  for (int jb = 0; jb < 2; ++jb)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ty + 16 * r, j = 64 * jb + tx + 16 * q;
        g[jb][r][q] = (r >= 4 * jb && i < L && j <= i) ? cbb[i * L + j] : 0.f;
      }
  const bool has_prev = c > 0 || has_s0;
  if (has_prev) {  // prev^T: lanes along p, so the shared stores do not collide
    const float* st = states + (((size_t)b * sh.H + h) * sh.nc + c) * (size_t)P * N;
#pragma unroll 4
    for (int i = tid; i < MAX_P * (N4 / 4); i += THREADS) {
      const int p = i % MAX_P, n = 4 * (i / MAX_P);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < P) {
        if (sh.vec_st) {
          const float4 w = *reinterpret_cast<const float4*>(st + p * N + n);
          v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) v[e] = st[p * N + n + e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sU[(n + e) * XP + p] = v[e];
    }
  }
  if (tid < 32) chunk_cumsum(sCs, a + b * as.b + h * as.h, as.s, t0, L, sh.S, tid);
  cp_async_wait<0>();
  __syncthreads();

  const int RR = (L + 15) / 16;  // row groups that hold rows < L
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  if (has_prev) {  // exp(a_cs_i) (C prev^T)_i
#pragma unroll 2
    for (int n = 0; n < N4; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = *reinterpret_cast<const float4*>(sU + (n + e) * XP + 4 * tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= RR) continue;
        const float4 cv = *reinterpret_cast<const float4*>(sC + (ty + 16 * r) * NPP + n);
        const float ce[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r][0] = fmaf(ce[e], pv[e].x, acc[r][0]);
          acc[r][1] = fmaf(ce[e], pv[e].y, acc[r][1]);
          acc[r][2] = fmaf(ce[e], pv[e].z, acc[r][2]);
          acc[r][3] = fmaf(ce[e], pv[e].w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float d = i < L ? expf(sCs[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= d;
    }
  }
  __syncthreads();  // C and the entering state are consumed
  float* sX = sU;
  float* sS = sC;
  stage_f32(sX, XP, x + b * xs.b + h * xs.h + t0 * xs.s, xs.s, LR, nvalid, P, MAX_P, sh.vec_x, tid);
  cp_async_commit();

  // + ((C B^T) o decay) x, key blocks of 64; a row's scores are written and
  // read by the half-warp that owns the row
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    const int j0 = 64 * jb;
    if (j0 >= L) break;
#pragma unroll
    for (int r = 4 * jb; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= LR) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx + 16 * q;
        sS[i * XP + tx + 16 * q] = j <= i && i < L ? g[jb][r][q] * expf(sCs[i] - sCs[j]) : 0.f;
      }
    }
    if (jb == 0) {  // x has landed, for every thread
      cp_async_wait<0>();
      __syncthreads();
    } else {
      __syncwarp();
    }
    const int jn = min(64, LR - j0);
#pragma unroll 2
    for (int jj = 0; jj < jn; jj += 4) {
      float4 xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = *reinterpret_cast<const float4*>(sX + (j0 + jj + e) * XP + 4 * tx);
#pragma unroll
      for (int r = 4 * jb; r < 8; ++r) {
        if (r >= RR) continue;
        const float4 sv = *reinterpret_cast<const float4*>(sS + (ty + 16 * r) * XP + jj);
        const float se[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r][0] = fmaf(se[e], xv[e].x, acc[r][0]);
          acc[r][1] = fmaf(se[e], xv[e].y, acc[r][1]);
          acc[r][2] = fmaf(se[e], xv[e].z, acc[r][2]);
          acc[r][3] = fmaf(se[e], xv[e].w, acc[r][3]);
        }
      }
    }
    __syncwarp();  // the tile is read before the next block rewrites it
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r, t = t0 + i;
    if (i >= L || t >= sh.S) continue;
    float* yr = y + b * ys.b + (long long)t * ys.s + h * ys.h;
    const int p = 4 * tx;
    if (sh.vec_y && p + 3 < P) {
      *reinterpret_cast<float4*>(yr + p) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p + q < P) yr[p + q] = acc[r][q];
    }
  }
}

}  // namespace f32

// The shared-memory limit of a kernel is raised once per device: `done`
// holds one bit per device (the attribute is per device, and setting it
// costs host time on every call).
template <typename Kernel>
cudaError_t configure(Kernel kernel, unsigned long long& done, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(done >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done |= 1ull << dev;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// 16-byte copies are safe for a tensor whose base, batch/seq/head strides
// and row width are all multiples of 16 bytes
bool vec_ok(const void* p, int el, long long sb, long long ss, long long sh, int cols) {
  return aligned16(p) && (sb * el) % 16 == 0 && (ss * el) % 16 == 0 && (sh * el) % 16 == 0 &&
         (cols * el) % 16 == 0;
}

#define SSD_TRY(expr)                          \
  do {                                         \
    const cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a, Bm, Cm and y share it). Strides
// are in elements: (batch, seq, head) for x, a and y, (batch, seq, -) for Bm
// and Cm; the last dimension of x, Bm, Cm and y must be contiguous. s0 (may
// be null) and fin are contiguous (B, H, P, N) fp32. `states` (B, H, nc, P,
// N), `decays` (B, H, nc) and, for float32 only, `cb` (B, nc, chunk,
// chunk), nc = ceil(S / chunk), are fp32 scratch the caller allocates.
// Launches chunk_state, (float32: chunk_cb,) state_pass and chunk_scan on
// `stream`. Returns a cudaError_t (0 on success); a launch the card refuses
// returns its error. Allocates nothing and does not synchronize.
extern "C" int ssd_scan_fwd(
    const void* x, const void* a, const void* Bm, const void* Cm, const void* s0,
    void* y, void* fin, void* states, void* decays, void* cb,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss,
    long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh,
    int Bsz, int S, int H, int P, int N, int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || H > 65535 || Bsz > 65535 || P <= 0 || P > MAX_P ||
      N <= 0 || N > MAX_N || chunk <= 0 || chunk > MAX_L || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int el = dtype == 0 ? 4 : 2;
  const int nc = (S + chunk - 1) / chunk;
  const Strides xs{x_sb, x_ss, x_sh}, as{a_sb, a_ss, a_sh}, bs{b_sb, b_ss, 0},
      cs{c_sb, c_ss, 0}, ys{y_sb, y_ss, y_sh};
  const Shape sh{S, H, P, N, chunk, nc,
                 vec_ok(x, el, x_sb, x_ss, x_sh, P),
                 vec_ok(Bm, el, b_sb, b_ss, 0, N) && vec_ok(Cm, el, c_sb, c_ss, 0, N),
                 vec_ok(y, el, y_sb, y_ss, y_sh, P),
                 N % 4 == 0 && aligned16(states)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stf = static_cast<float*>(states);
  float* dcf = static_cast<float*>(decays);
  const float* s0f = static_cast<const float*>(s0);
  const dim3 chunks(nc, H, Bsz);
  const int PN = P * N;
  const dim3 tiles((PN + 4 * THREADS - 1) / (4 * THREADS), H, Bsz);
  static unsigned long long done[7] = {0, 0, 0, 0, 0, 0, 0};
  const int vec_pass = PN % 4 == 0 && aligned16(states) && aligned16(fin) && (!s0 || aligned16(s0));

  if (dtype == 0) {
    using T = float;
    const T *xt = static_cast<const T*>(x), *at = static_cast<const T*>(a),
            *bt = static_cast<const T*>(Bm), *ct = static_cast<const T*>(Cm);
    if (cb == nullptr) return (int)cudaErrorInvalidValue;
    float* cbf = static_cast<float*>(cb);
    const int LR = round_up(chunk, 16), N4 = round_up(N, 4), nt = (chunk + f32::CB_T - 1) / f32::CB_T;
    // the largest shared-memory need of each kernel over the shapes it takes
    int state_max = 0;
    for (int n4 = 4; n4 <= MAX_N; n4 += 4) {
      const int need = f32::state_smem(MAX_L, n4);
      state_max = need > state_max ? need : state_max;
    }
    SSD_TRY(configure(f32::ssd_chunk_state_f32, done[0], state_max));
    SSD_TRY(configure(f32::ssd_chunk_scan_f32, done[1], f32::scan_smem(MAX_L, MAX_N)));
    SSD_TRY(configure(f32::ssd_chunk_cb_f32, done[2], f32::cb_smem(MAX_N)));
    f32::ssd_chunk_state_f32<<<chunks, THREADS, f32::state_smem(LR, N4), st>>>(
        xt, at, bt, stf, dcf, xs, as, bs, sh);
    SSD_TRY(cudaGetLastError());
    f32::ssd_chunk_cb_f32<<<dim3(nc * nt * (nt + 1) / 2, Bsz), THREADS, f32::cb_smem(N4), st>>>(
        bt, ct, cbf, bs, cs, sh);
    SSD_TRY(cudaGetLastError());
    ssd_state_pass<<<tiles, THREADS, 0, st>>>(stf, dcf, s0f, static_cast<float*>(fin), H, nc, PN, vec_pass);
    SSD_TRY(cudaGetLastError());
    f32::ssd_chunk_scan_f32<<<chunks, THREADS, f32::scan_smem(LR, N4), st>>>(
        xt, at, ct, cbf, stf, static_cast<T*>(y), xs, as, cs, ys, sh, s0 != nullptr);
    return (int)cudaGetLastError();
  }
  using T = bf16;
  const T *xt = static_cast<const T*>(x), *at = static_cast<const T*>(a),
          *bt = static_cast<const T*>(Bm), *ct = static_cast<const T*>(Cm);
  if (N <= 64) {
    SSD_TRY(configure(tc::ssd_chunk_state_bf16<64>, done[3], tc::state_smem(64)));
    tc::ssd_chunk_state_bf16<64><<<chunks, 128, tc::state_smem(64), st>>>(xt, at, bt, stf, dcf, xs, as, bs, sh);
  } else {
    SSD_TRY(configure(tc::ssd_chunk_state_bf16<128>, done[4], tc::state_smem(128)));
    tc::ssd_chunk_state_bf16<128><<<chunks, 128, tc::state_smem(128), st>>>(xt, at, bt, stf, dcf, xs, as, bs, sh);
  }
  SSD_TRY(cudaGetLastError());
  ssd_state_pass<<<tiles, THREADS, 0, st>>>(stf, dcf, s0f, static_cast<float*>(fin), H, nc, PN, vec_pass);
  SSD_TRY(cudaGetLastError());
  const int RT = chunk > 64 ? 128 : 64;
  if (N > 64) {
    constexpr int HG = tc::HG_WIDE;
    SSD_TRY(configure(tc::ssd_chunk_scan_bf16<HG>, done[5], tc::scan_smem(HG, 128, 2)));
    tc::ssd_chunk_scan_bf16<HG><<<dim3(nc, (H + HG - 1) / HG, Bsz), THREADS, tc::scan_smem(HG, RT, 2), st>>>(
        xt, at, bt, ct, stf, static_cast<T*>(y), xs, as, bs, cs, ys, sh, s0 != nullptr);
  } else {
    SSD_TRY(configure(tc::ssd_chunk_scan_bf16<1>, done[6], tc::scan_smem(1, 128, 1)));
    tc::ssd_chunk_scan_bf16<1><<<chunks, THREADS, tc::scan_smem(1, RT, 1), st>>>(
        xt, at, bt, ct, stf, static_cast<T*>(y), xs, as, bs, cs, ys, sh, s0 != nullptr);
  }
  return (int)cudaGetLastError();
}
