// Blockwise causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_bhsd (body
// `_flash_kernel`).
//
// Layout: q (B, S, H, D), k (B, S, K, D), v (B, S, K, Dv), o (B, S, H, Dv),
// read and written through element strides (the last dimension contiguous,
// every row 16-byte aligned), so the caller needs no transpose and no
// padding. H % K == 0; the kv head of query head h is h / (H / K). (D, Dv) is
// (64, 64), (128, 128), or (192, 128), MLA's prefill (DeepSeek-V3: q/k heads
// of 128 no-rope + 64 rope dims, v heads of 128): each body takes D_qk and
// D_v as two template dims.
//
// Both bodies compute what the Pallas kernel does: causal attention with an
// optional sliding window (kpos > qpos - window), keys past S masked, an fp32
// online softmax (running max, denominator, output), kv tiles that the mask
// and the window rule out skipped, and rows with no live key stored as exact
// zeros (the reference's l == 0 guard). A row whose max is still -inf uses 0
// as its reference, so exp(-inf - -inf) never happens. The softmax scale
// D**-0.5 is folded with log2(e) into one exp2.
//
// Where the TPU runs the kv blocks as a sequential grid axis with the state
// in VMEM scratch, here a loop inside the block walks the kv tiles. The grid
// is (head, batch, q tile) with the q tiles taken in reverse, so under the
// causal mask the heaviest tiles (the last rows, which visit the most kv
// tiles) are scheduled first.
//
// bfloat16: tensor cores.
//   * A block is two consumer warpgroups (256 threads), each owning 64 q
//     rows; both read the same K/V tiles of 64 keys.
//   * S = Q K^T with `wgmma.mma_async.m64n64k16.f32.bf16.bf16`, Q and K from
//     shared memory in the 128-byte-swizzled K-major layout the descriptors
//     name (a row of 64 bf16 is 128 bytes; D = 128 is two such column
//     halves, D = 192 three). A bf16 x bf16 product is exact in fp32, so S
//     matches the reference's upcast dot up to summation order.
//   * The online softmax runs on the accumulator fragments in registers:
//     each row lives in the 4 threads of a quad, so a row max or sum is two
//     shuffles; the output is rescaled only when some row's max moved.
//   * O += P V with a second wgmma: P is rounded to bf16 and fed from
//     registers as the A operand (the accumulator layout of the first
//     product is the register-A layout of the second); V's tile is the B
//     operand, MN-major, with the transpose bit set. Rounding P to bf16 is
//     the one rounding the reference does not make.
//   * K/V tiles arrive by `cp.async` 16-byte copies (src_size 0 zero-fills
//     the ragged tail) into a 3-stage ring, two tiles ahead of the one in
//     use, so the copies overlap the products. Each thread copies the same
//     chunks of every tile, their offsets computed once. cp.async writes
//     through the generic proxy; each thread fences to the async proxy
//     before the barrier that hands a tile to wgmma. cp.async and not TMA:
//     encoding a tensor map for every call would add host work to every launch, and
//     the copies are not what bounds this kernel (its scalar softmax work
//     is; PERF.md).
//
// float32: CUDA cores (TF32 stays off), register micro-tiles.
//   * 256 threads per 64-row q tile; thread (ty, tx) owns rows ty + 16 i
//     and keys tx + 16 j (i, j < 4) of S, and rows ty + 16 i by columns
//     64 c + 4 tx .. +3 of O. Q, K, P and V are read as float4 from rows
//     padded against bank conflicts: two vector loads per 16 FMAs.
//   * A row's 64 scores live in the 16 lanes of a half-warp: a row max or
//     sum is four shuffles. P goes through shared memory within the
//     half-warp that wrote it.
//   * K/V tiles are double-buffered with cp.async: tile t+1 is copied while
//     tile t is computed. At (192, 128) two buffers do not fit a block's
//     shared memory; one is used, each tile copied after the last is read.
//
// The bound on H100 is in kernel.py's note beside the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of one tensor; the last dim is 1
};

// kv tiles [begin, end) that hold a live key for some row of [q0, q_last]
__device__ __forceinline__ void kv_range(int q0, int q_last, int S, int bk, int window,
                                         int causal, int& begin, int& end) {
  end = (S + bk - 1) / bk;
  if (causal) end = min(end, q_last / bk + 1);
  begin = 0;
  if (window > 0) {
    const int kmin = q0 - window + 1;  // smallest key row q0 can see
    begin = kmin > 0 ? kmin / bk : 0;
  }
}

// 2^x in one MUFU instruction (exp2f adds range handling around it);
// 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool key_live(int kpos, int qpos, int S, int window, int causal) {
  return kpos < S && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// =================================================== bfloat16: wgmma path
namespace wg {

constexpr int BQ = 64;          // q rows per consumer warpgroup
constexpr int WGS = 2;          // consumer warpgroups per block
constexpr int ROWS = WGS * BQ;  // q rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int PF = 2;           // kv tiles in flight ahead of the one in use
constexpr int STAGES = PF + 1;  // K/V ring
constexpr int THREADS = 128 * WGS;

template <int DK, int DV>
struct Smem {
  static constexpr int Q_BYTES = ROWS * DK * 2;
  static constexpr int K_BYTES = BK * DK * 2;  // one K tile
  static constexpr int V_BYTES = BK * DV * 2;  // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment
};

// A thread's share of copying a (TILE_ROWS x D) bf16 tile into shared
// memory. The tile is D/64 column halves of (TILE_ROWS x 64), each row 128 bytes with its
// 16-byte chunks XOR-swizzled by row % 8 (the layout of a 128-byte-swizzle
// wgmma descriptor). A thread copies the same chunks of every tile, so
// their offsets are computed once.
template <int D, int TILE_ROWS>
struct Share {
  static constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  static constexpr int N = TILE_ROWS * CHUNKS / THREADS;
  int row[N];        // row within the tile
  long long off[N];  // element offset in the source: row * row_stride + column
  uint32_t soff[N];  // byte offset in the tile

  __device__ __forceinline__ Share(int tid, long long row_stride) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * THREADS, r = i / CHUNKS, cc = i % CHUNKS;
      row[j] = r;
      off[j] = r * row_stride + cc * 8;
      soff[j] = (cc / 8) * (TILE_ROWS * 128) + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
    }
  }
  // rows pos0 .. pos0 + TILE_ROWS - 1 of `src` (row pos0 at `at`); rows
  // past S are zero-filled
  __device__ __forceinline__ void copy(uint32_t dst, const __nv_bfloat16* src,
                                       const __nv_bfloat16* at, int pos0, int S) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool valid = pos0 + row[j] < S;
      cp_async16(dst + soff[j], valid ? at + off[j] : src, valid);
    }
  }
};

template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// Online-softmax step on a score tile in registers: s[4c + 2r + e] is row
// row0 + 8r, key k0 + 8c + col0 + e. Masks (when the tile needs it),
// updates the running max m and denominator l, turns s into P (fp32) and
// returns each row's correction of the running output (exactly 1 where the
// max did not move).
__device__ __forceinline__ void softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], bool masked, int k0, int row0,
                                        int col0, int S, int window, int causal, float sl2e) {
  if (masked) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // live keys of this row, as columns of the tile: lo <= column <= hi
      const int qpos = row0 + 8 * r;
      const int hi = min(S - 1, causal ? qpos : S) - k0;
      const int lo = window > 0 ? qpos - window + 1 - k0 : 0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * c + col0 + e;
          if (col < lo || col > hi) s[4 * c + 2 * r + e] = -INFINITY;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float m_ref = m_new == -INFINITY ? 0.f : m_new;
    const float neg = -m_ref * sl2e;
    corr[r] = m_new == m[r] ? 1.f : ex2(fmaf(m[r], sl2e, neg));  // 0 while m is -inf
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * c + 2 * r + e], sl2e, neg));
        s[4 * c + 2 * r + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[r] = l[r] * corr[r] + rs;
    m[r] = m_new;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, DK == 64 ? 2 : 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               Strides qs, Strides ks, Strides vs, Strides os, int group, int S,
               int window, int causal, float sl2e) {
  using SM = Smem<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + SM::Q_BYTES;  // stage s: its K tile, then its V tile

  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;  // heaviest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;                 // this thread's warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int qw0 = q0 + wgi * BQ;             // first q row of the warpgroup
  const int row0 = qw0 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);          // fragment column within 8

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  int t_begin, t_end;
  kv_range(q0, min(q0 + ROWS, S) - 1, S, BK, window, causal, t_begin, t_end);
  const Share<DK, BK> kshare(tid, ks.s);
  const Share<DV, BK> vshare(tid, vs.s);
  // the copy of kv tile t_begin + it into its stage, as one commit group
  auto fetch = [&](int it) {
    const int pos = (t_begin + it) * BK;
    if (pos < t_end * BK) {
      const uint32_t st = sKV + (it % STAGES) * SM::STAGE_BYTES;
      kshare.copy(st, kb, kb + pos * ks.s, pos, S);
      vshare.copy(st + SM::K_BYTES, vb, vb + pos * vs.s, pos, S);
    }
    cp_async_commit();
  };

  // prologue: Q and the first PF kv tiles, one commit group each
  {
    const Share<DK, ROWS> qshare(tid, qs.s);
    qshare.copy(sQ, qb, qb + q0 * qs.s, q0, S);
  }
#pragma unroll
  for (int i = 0; i < PF; ++i) fetch(i);

  // descriptors: this warpgroup's Q rows, and K / V of stage 0 (K-major
  // Q and K; V MN-major, its Dv halves BK * 128 bytes apart, its 8-key
  // groups 1024)
  const uint64_t dq = desc(sQ + wgi * (BQ * 128), 16, 1024);
  const uint64_t dk = desc(sKV, 16, 1024);
  const uint64_t dv = desc(sKV + SM::K_BYTES, BK * 128, 1024);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4];  // P in bf16 as the register A operand

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    cp_async_wait<PF - 1>();  // this thread's copies of tile t (and Q) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async -> wgmma
    __syncthreads();  // ... every thread's; and tile t - 1's stage is free
    const int k0 = t * BK;
    // does the tile hold a live key for this warpgroup's rows? (uniform)
    const bool live = (!causal || k0 <= qw0 + BQ - 1) &&
                      (window <= 0 || k0 + BK - 1 > qw0 - window);
    const uint64_t dks = dk + (it % STAGES) * (SM::STAGE_BYTES / 16);
    const uint64_t dvs = dv + (it % STAGES) * (SM::STAGE_BYTES / 16);
    float s[32];
    if (live) {
      // S = Q K^T over D in steps of 16 (32 bytes along a 128-byte row; each
      // further 64 columns of D are the next column half)
      wg_fence();
      wgmma_ss_n64_first(s, dq, dks);
#pragma unroll
      for (int kk = 1; kk < DK / 16; ++kk)
        wgmma_ss_n64(s, dq + ((kk / 4) * (ROWS * 128) + (kk % 4) * 32) / 16,
                     dks + ((kk / 4) * (BK * 128) + (kk % 4) * 32) / 16);
      wg_commit();
    }
    fetch(it + PF);
    if (!live) continue;
    wg_wait<0>();
    hold(s);

    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > qw0) ||
                        (window > 0 && k0 <= qw0 + BQ - 1 - window);
    float corr[2];
    softmax(s, m, l, corr, masked, k0, row0, col0, S, window, causal, sl2e);
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * c + 2 * r] *= corr[r];
          acc[4 * c + 2 * r + 1] *= corr[r];
        }
    }
    // P in bf16, one 16-key slice at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    // O += P V over the tile's keys, 16 at a time (16 rows of V = 2048 bytes)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pv<DV>(acc, pa[kk], dvs + kk * (2048 / 16));
    wg_commit();
    wg_wait<0>();
    hold(acc);
    hold(pa);  // live and unchanged until the products that read them are done
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + b * os.b + (long long)row * os.s + h * os.h + col0;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] / denom, acc[4 * c + 2 * r + 1] / denom);
  }
}

}  // namespace wg

// ================================================= float32: CUDA-core path
namespace f32 {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PP = BK + 16;  // P row pitch (floats): the two rows of a warp on other banks

constexpr int MAX_SMEM = 227 * 1024;  // a block's dynamic shared memory on sm_90

template <int DK, int DV>
struct Smem {
  static constexpr int PK = DK + 4;  // Q/K row pitch (floats), 16-byte aligned
  static constexpr int PV = DV + 4;  // V row pitch
  static constexpr int TILE = BK * (PK + PV);  // one K tile and its V tile
  // K/V buffers: two where they fit beside Q and P, else one
  static constexpr int BUFS = (BQ * PK + 2 * TILE + BQ * PP) * 4 <= MAX_SMEM ? 2 : 1;
  static constexpr int FLOATS = BQ * PK + BUFS * TILE + BQ * PP;
  static constexpr int BYTES = FLOATS * 4;
};

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int pos0, int S, int tid) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
  constexpr int P = D + 4;       // the row pitch in shared memory
#pragma unroll
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, cc = i % CHUNKS;
    const int pos = pos0 + r;
    const bool valid = pos < S;
    cp_async16(smem_u32(dst + r * P + cc * 4),
               src + (long long)(valid ? pos : 0) * row_stride + cc * 4, valid);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, DK == 64 ? 2 : 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
              Strides vs, Strides os, int group, int S, int window, int causal, float sl2e) {
  using SM = Smem<DK, DV>;
  constexpr int PK = SM::PK, PV = SM::PV;
  constexpr int NC = DV / 64;  // column quads of O a thread owns
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + BQ * PK;  // buffer u: its K tile, then its V tile
  float* sP = sKV + SM::BUFS * SM::TILE;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  int t_begin, t_end;
  kv_range(q0, min(q0 + BQ, S) - 1, S, BK, window, causal, t_begin, t_end);

  load_tile<DK, BQ>(sQ, qb, qs.s, q0, S, tid);
  load_tile<DK, BK>(sKV, kb, ks.s, t_begin * BK, S, tid);
  load_tile<DV, BK>(sKV + BK * PK, vb, vs.s, t_begin * BK, S, tid);
  cp_async_commit();

  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    if (SM::BUFS == 2) {
      if (t + 1 < t_end) {  // the next tile into the other buffer
        float* nb = sKV + ((it + 1) % 2) * SM::TILE;
        load_tile<DK, BK>(nb, kb, ks.s, (t + 1) * BK, S, tid);
        load_tile<DV, BK>(nb + BK * PK, vb, vs.s, (t + 1) * BK, S, tid);
      }
    } else if (it > 0) {  // one buffer: tile t, now that tile t - 1 is consumed
      load_tile<DK, BK>(sKV, kb, ks.s, t * BK, S, tid);
      load_tile<DV, BK>(sKV + BK * PK, vb, vs.s, t * BK, S, tid);
    }
    cp_async_commit();
    cp_async_wait<SM::BUFS - 1>();  // tile t has landed for this thread
    __syncthreads();                // ... for every thread
    const float* sK = sKV + (it % SM::BUFS) * SM::TILE;
    const float* sV = sK + BK * PK;
    const int k0 = t * BK;

    // S micro-tile: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * PK + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * PK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
    if (masked) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!key_live(k0 + tx + 16 * j, q0 + ty + 16 * i, S, window, causal))
            s[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float neg = -m_ref * sl2e;
      const float corr = ex2(fmaf(m[i], sl2e, neg));  // 0 while m is -inf
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(fmaf(s[i][j], sl2e, neg));
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncwarp();  // a row's P is written and read by one half-warp

    // O micro-tile += P V: rows ty + 16 i, columns 64 c + 4 tx .. + 3
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PP + kk);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = *reinterpret_cast<const float4*>(sV + (kk + e) * PV + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][c][0] = fmaf(pe[e], vv[e].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pe[e], vv[e].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pe[e], vv[e].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pe[e], vv[e].w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();  // tile t's buffer and P are consumed before they are rewritten
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) =
          make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom, acc[i][c][2] / denom,
                      acc[i][c][3] / denom);
  }
}

}  // namespace f32

// `configured` holds one bit per device on which the kernel's shared-memory
// limit has been raised (the attribute is per device, and setting it costs
// host time on every call, so it is set once).
template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, unsigned long long& configured, int smem, int rows_per_block,
                   int threads, const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B, int H, int K, int S,
                   int scale_dim, int window, int causal, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  // the softmax scale of the caller's head dim, which may be smaller than
  // the kernel's (the wrapper zero-pads D up to 64 or 128)
  const float sl2e = (float)(1.0 / sqrt((double)scale_dim)) * LOG2E;
  const dim3 grid(H, B, (S + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o), qs, ks,
                                          vs, os, H / K, S, window, causal, sl2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (D, Dv), the head dims of q/k and of
// v/o, is (64, 64), (128, 128) or (192, 128); scale_dim is the head dim whose
// 1/sqrt sets the softmax scale (D itself, or the true head dim of inputs
// zero-padded up to D). Strides are in elements, (batch, seq, head) for each
// of q, k, v, o; the head_dim stride must be 1 and every row must start
// 16-byte aligned. Returns a cudaError_t (0 on success); a launch
// the card refuses returns its error. Allocates nothing and does not
// synchronize.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int H, int K, int S, int D, int Dv, int window, int causal, int scale_dim,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || scale_dim <= 0 || scale_dim > D)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  static unsigned long long configured[6] = {0, 0, 0, 0, 0, 0};
#define FA_LAUNCH(i, T, NS, KERNEL, DK, DV, ROWS)                                           \
  return (int)launch<decltype(&NS::KERNEL<DK, DV>), T>(                                     \
      NS::KERNEL<DK, DV>, configured[i], NS::Smem<DK, DV>::BYTES, ROWS, NS::THREADS, q, k, v, o, \
      qs, ks, vs, os, B, H, K, S, scale_dim, window, causal, st)
  if (dtype == 0 && D == 64 && Dv == 64) FA_LAUNCH(0, float, f32, flash_fwd_f32, 64, 64, f32::BQ);
  if (dtype == 0 && D == 128 && Dv == 128)
    FA_LAUNCH(1, float, f32, flash_fwd_f32, 128, 128, f32::BQ);
  if (dtype == 0 && D == 192 && Dv == 128)
    FA_LAUNCH(4, float, f32, flash_fwd_f32, 192, 128, f32::BQ);
  if (dtype == 1 && D == 64 && Dv == 64) FA_LAUNCH(2, bf16, wg, flash_fwd_bf16, 64, 64, wg::ROWS);
  if (dtype == 1 && D == 128 && Dv == 128)
    FA_LAUNCH(3, bf16, wg, flash_fwd_bf16, 128, 128, wg::ROWS);
  if (dtype == 1 && D == 192 && Dv == 128)
    FA_LAUNCH(5, bf16, wg, flash_fwd_bf16, 192, 128, wg::ROWS);
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
