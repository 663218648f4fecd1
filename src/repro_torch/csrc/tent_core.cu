// The jitted engine core's two fp64 kernels for Hopper, sm_90a.
//
// Replace the reference's XLA-jitted programs behind EngineConfig.jit_core:
// repro/core/scheduler.py::tent_choose_wave_padded_jnp (one wave of Algorithm 1)
// repro/core/scheduler.py::tent_on_complete_many_jnp   (one Eq. 1 EWMA drain)
// Their plain versions are repro_torch/core/scheduler.py::*_torch, and the
// numpy twins they must equal bit for bit are `tent_choose_wave` and
// `TelemetryStore.on_complete_many`.
//
// Bit-exactness. Every product, sum, difference and quotient is an explicit
// round-to-nearest intrinsic (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn),
// and the library is built with --fmad=false, so neither nvcc nor ptxas can
// contract a multiply feeding an add into one fma: each operation rounds once,
// in the reference's order, as numpy does. Minima and maxima are exact in any
// order, so the block reductions below may take them in any order.
//
// Bound. Both kernels are chains of dependent steps: the wave chooser has one
// step per slice (each slice's pick reads the queue the previous pick
// charged), the drain one step per completion of a slot. The bytes (the
// padded arrays, once) and the float operations are tiny; the time is the
// serial steps times the latency of one step, plus the launch. Both run as
// one launch per call. For at most 32 candidates (every wave of the scenario
// library) the chooser is one warp with each candidate's inputs and charged
// queue in its lane's registers: a slice costs a redux.sync minimum and two
// ballots, with no block barrier and no shared memory. Wider waves take the
// block kernel, whose slices pay for block-wide reductions.
//
// Layouts (all float64, as the wrapper packs them into one staging buffer;
// integer and boolean values travel as exact doubles):
//   chooser in : q[pc] gl[pc] gr[pc] bw[pc] b0[pc] b1[pc] pen[pc] ex[pc]
//                len[ps] valid[ps] rr gamma
//   chooser out: choice[ps] queued_at[ps] q_out[pc] rr_out
//   drain state: b0[ps] b1[ps] q[ps] ew[ps] comp[ps] alpha[ps] b0a[ps] bw[ps]
//                (the first five updated in place)
//   drain batch: slot[pm] len[pm] queued_at[pm] t_obs[pm]

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int DRAIN_THREADS = 256;
constexpr int DRAIN_TILE = 2048;

// Python's min(a, b) and numpy's minimum for values that are not NaN
__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

// Min of v over the block; every thread gets it. `red` holds 32 doubles.
__device__ double block_min(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = dmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = dmin(m, red[w]);
  return m;
}

// Sum of n over the block; every thread gets it. `cnt` holds 32 ints.
__device__ int block_sum(int n, int* cnt) {
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) cnt[warp] = n;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += cnt[w];
  return s;
}

// Min of v over a full warp, exact for values that are not NaN: a double
// maps to an unsigned 64-bit key of the same order (negative values have
// their bits flipped, the others their sign bit set), and the warp takes the
// least key's high word, then the least low word under it, by redux.sync.
__device__ __forceinline__ double warp_min(double v) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  const unsigned long long key = (long long)u < 0 ? ~u : u | 0x8000000000000000ull;
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mhi = __reduce_min_sync(0xffffffffu, hi);
  const unsigned mlo = __reduce_min_sync(0xffffffffu, hi == mhi ? lo : 0xffffffffu);
  const unsigned long long m = (unsigned long long)mhi << 32 | mlo;
  return __longlong_as_double((long long)((long long)m < 0 ? m & 0x7fffffffffffffffull : ~m));
}

// score_d = pen * (b0 + b1 * (A + L) / bw), the reference's association order
__device__ __forceinline__ double score(double pen, double b0, double b1, double a, double len,
                                        double bw) {
  return __dmul_rn(pen, __dadd_rn(b0, __ddiv_rn(__dmul_rn(b1, __dadd_rn(a, len)), bw)));
}

// pc <= 32: one warp walks the wave's slices in order; candidate c lives on
// lane c (its eight inputs and its charged queue in registers). Per slice:
// the masked scores, their minimum by redux.sync (the all-excluded fallback the
// same way), the gamma window by ballot, its k-th member by popcount rank;
// that lane charges line 11 and writes the slice's outputs. Lengths and valid
// flags are read 32 slices at a time, one a lane, and broadcast by shuffle.
__global__ void __launch_bounds__(32)
tent_choose_wave_warp(const double* __restrict__ in, double* __restrict__ out, int pc, int ps) {
  const unsigned FULL = 0xffffffffu;
  const double *len = in + 8 * pc, *valid = len + ps;
  double *choice = out, *queued_at = out + ps, *q_out = out + 2 * ps;
  const int c = threadIdx.x;
  const bool live = c < pc;
  double q = 0.0, gl = 0.0, gr = 0.0, bw = 1.0, b0 = 0.0, b1 = 1.0, pen = INFINITY;
  bool ex = true;
  if (live) {
    q = in[c];
    gl = in[pc + c];
    gr = in[2 * pc + c];
    bw = in[3 * pc + c];
    b0 = in[4 * pc + c];
    b1 = in[5 * pc + c];
    pen = in[6 * pc + c];
    ex = in[7 * pc + c] != 0.0;
  }
  const double one_plus_gamma = __dadd_rn(1.0, valid[ps + 1]);
  long long rr = (long long)valid[ps];  // every lane keeps the same count
  const bool rr32 = rr >= 0 && rr + ps < (1LL << 32);  // rr % n in 32 bits
  const unsigned below = (1u << c) - 1u;  // the lanes before this one
  for (int t0 = 0; t0 < ps; t0 += 32) {
    const int tc = t0 + c;
    const double len_c = tc < ps ? len[tc] : 0.0;
    const unsigned valid_ball = __ballot_sync(FULL, tc < ps && valid[tc] != 0.0);
    const int n = ps - t0 < 32 ? ps - t0 : 32;
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      const double L = __shfl_sync(FULL, len_c, i);
      // masked scores: (A + gl) + gr, then + L
      const double a = __dadd_rn(__dadd_rn(q, gl), gr);
      double v = !live || ex ? INFINITY : score(pen, b0, b1, a, L, bw);
      double m = v;
      m = warp_min(m);
      if (isinf(m)) {
        // soft exclusion must not deadlock: the raw local cost model, mask off
        v = live ? score(pen, b0, b1, q, L, bw) : INFINITY;
        m = v;
        m = warp_min(m);
      }
      if (isfinite(m) && (valid_ball >> i) & 1u) {  // the same in every lane
        const double thr = __dmul_rn(one_plus_gamma, m);
        const bool in_w = live && v <= thr;
        const unsigned ball = __ballot_sync(FULL, in_w);
        const int n_win = __popc(ball);
        const unsigned w = (unsigned)(n_win > 1 ? n_win : 1);
        const long long k = rr32 ? (long long)((unsigned)rr % w) : rr % (long long)w;
        if (in_w && __popc(ball & below) == k) {
          q = __dadd_rn(q, L);  // line 11: A_d* += L
          choice[t] = (double)c;
          queued_at[t] = q;
        } else if (c == 0 && !(k >= 0 && k < n_win)) {  // no member: an empty window
          choice[t] = (double)pc;
          queued_at[t] = 0.0;
        }
        ++rr;
      } else if (c == 0) {
        choice[t] = -1.0;
        queued_at[t] = 0.0;
      }
    }
  }
  if (live) q_out[c] = q;
  if (c == 0) q_out[pc] = (double)rr;
}

// pc > 32: one block walks the wave's slices in order. Thread i owns candidates
// i, i + blockDim.x, ... (a stride loop past the block size); their scores and
// the charged queue live in shared memory (s[pc], q[pc]).
__global__ void __launch_bounds__(MAX_THREADS)
tent_choose_wave_padded(const double* __restrict__ in, double* __restrict__ out, int pc, int ps) {
  extern __shared__ double sh[];
  double* s = sh;
  double* q = sh + pc;
  __shared__ double red[32];
  __shared__ int cnt[32];
  __shared__ int chosen_sh;
  const double *q0 = in, *gl = in + pc, *gr = in + 2 * pc, *bw = in + 3 * pc, *b0 = in + 4 * pc,
               *b1 = in + 5 * pc, *pen = in + 6 * pc, *ex = in + 7 * pc;
  const double *len = in + 8 * pc, *valid = len + ps;
  double *choice = out, *queued_at = out + ps, *q_out = out + 2 * ps;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const double one_plus_gamma = __dadd_rn(1.0, valid[ps + 1]);
  long long rr = (long long)valid[ps];  // every thread keeps the same count
  for (int c = tid; c < pc; c += nt) q[c] = q0[c];
  __syncthreads();

  for (int t = 0; t < ps; ++t) {
    const double L = len[t];
    // masked scores: (A + gl) + gr, then + L
    double m = INFINITY;
    for (int c = tid; c < pc; c += nt) {
      const double a = __dadd_rn(__dadd_rn(q[c], gl[c]), gr[c]);
      const double v = ex[c] != 0.0 ? INFINITY : score(pen[c], b0[c], b1[c], a, L, bw[c]);
      s[c] = v;
      m = dmin(m, v);
    }
    m = block_min(m, red);
    if (isinf(m)) {
      // soft exclusion must not deadlock: the raw local cost model, mask off
      m = INFINITY;
      for (int c = tid; c < pc; c += nt) {
        const double v = score(pen[c], b0[c], b1[c], q[c], L, bw[c]);
        s[c] = v;
        m = dmin(m, v);
      }
      m = block_min(m, red);
    }
    const bool ok = isfinite(m) && valid[t] != 0.0;  // the same in every thread
    if (ok) {
      const double thr = __dmul_rn(one_plus_gamma, m);
      int mine = 0;
      for (int c = tid; c < pc; c += nt) mine += s[c] <= thr;
      const int n_win = block_sum(mine, cnt);
      const long long k = rr % (long long)(n_win > 1 ? n_win : 1);
      // the k-th window member in candidate order: candidates c0 + tid of
      // each stride round in turn, ranked by ballot and popcount
      long long before = 0;  // window members in earlier rounds
      if (tid == 0) chosen_sh = -1;  // ordered before the writers by the syncs below
      for (int c0 = 0; c0 < pc; c0 += nt) {
        const int c = c0 + tid;
        const bool in_w = c < pc && s[c] <= thr;
        const unsigned ball = __ballot_sync(0xffffffffu, in_w);
        __syncthreads();  // cnt is free
        if (lane == 0) cnt[warp] = __popc(ball);
        __syncthreads();
        long long rank = before + __popc(ball & ((1u << lane) - 1u));
        long long total = 0;
        for (int w = 0; w < (nt >> 5); ++w) {
          if (w < warp) rank += cnt[w];
          total += cnt[w];
        }
        if (in_w && rank == k) chosen_sh = c;
        before += total;
      }
      __syncthreads();
      if (tid == 0) {
        const int c = chosen_sh;  // -1 only for an empty window (gamma < 0)
        if (c >= 0) q[c] = __dadd_rn(q[c], L);  // line 11: A_d* += L
        choice[t] = c >= 0 ? (double)c : (double)pc;
        queued_at[t] = c >= 0 ? q[c] : 0.0;
      }
      ++rr;
    } else if (tid == 0) {
      choice[t] = -1.0;
      queued_at[t] = 0.0;
    }
    __syncthreads();
  }
  for (int c = tid; c < pc; c += nt) q_out[c] = q[c];
  if (tid == 0) q_out[pc] = (double)rr;
}

// One thread per slot d walks the whole batch in drain order and applies the
// completions of slot d only: that is the sequential per-slot recurrence
// (repeated slots included), and distinct slots run in parallel. The batch's
// slot column is staged through shared memory a tile at a time.
__global__ void __launch_bounds__(DRAIN_THREADS)
tent_on_complete_many(double* __restrict__ st, int ps, const double* __restrict__ batch, int pm) {
  __shared__ int tile[DRAIN_TILE];
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = d < ps;
  double b0 = 0, b1 = 0, q = 0, ew = 0, comp = 0, alpha = 0, b0a = 0, bw = 1;
  if (live) {
    b0 = st[d];
    b1 = st[ps + d];
    q = st[2 * ps + d];
    ew = st[3 * ps + d];
    comp = st[4 * ps + d];
    alpha = st[5 * ps + d];
    b0a = st[6 * ps + d];
    bw = st[7 * ps + d];
  }
  const double* lens = batch + pm;
  const double* qas = batch + 2 * pm;
  const double* tobs = batch + 3 * pm;
  for (int j0 = 0; j0 < pm; j0 += DRAIN_TILE) {
    const int n = pm - j0 < DRAIN_TILE ? pm - j0 : DRAIN_TILE;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = (int)batch[j0 + i];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      if (tile[i] != d) continue;
      const double L = lens[j0 + i], tob = tobs[j0 + i];
      const double x = __ddiv_rn(__dadd_rn(qas[j0 + i], L), bw);
      if (x > 0.0) {
        double sample = __ddiv_rn(__dsub_rn(tob, b0), x);
        sample = sample < 0.05 ? 0.05 : sample;  // min(max(sample, 0.05), 1e4)
        sample = 1e4 < sample ? 1e4 : sample;
        b1 = __dadd_rn(__dmul_rn(__dsub_rn(1.0, alpha), b1), __dmul_rn(alpha, sample));
      }
      double resid = __dsub_rn(tob, __dmul_rn(b1, x));
      resid = resid > 0.0 ? resid : 0.0;  // max(0.0, resid)
      b0 = __dadd_rn(__dmul_rn(__dsub_rn(1.0, b0a), b0), __dmul_rn(b0a, resid));
      const double qd = __dsub_rn(q, L);
      q = qd > 0.0 ? qd : 0.0;
      ew = __dadd_rn(__dmul_rn(__dsub_rn(1.0, alpha), ew), __dmul_rn(alpha, tob));
      comp = __dadd_rn(comp, 1.0);
    }
  }
  if (live) {
    st[d] = b0;
    st[ps + d] = b1;
    st[2 * ps + d] = q;
    st[3 * ps + d] = ew;
    st[4 * ps + d] = comp;
  }
}

}  // namespace

extern "C" {

// Shared memory the block chooser needs for pc candidates (scores and queues).
size_t tent_choose_wave_padded_smem(int pc) { return (size_t)pc * 2 * sizeof(double); }

// `out` holds 2 * ps + pc + 1 doubles: choices, queued_at, q_out, rr_out.
// One launch: the warp kernel for pc <= 32, else the block kernel.
int tent_choose_wave_padded_launch(const double* in, double* out, int pc, int ps, void* stream) {
  if (pc <= 0 || ps < 0) return (int)cudaErrorInvalidValue;
  if (pc <= 32) {
    tent_choose_wave_warp<<<1, 32, 0, (cudaStream_t)stream>>>(in, out, pc, ps);
    return (int)cudaGetLastError();
  }
  int threads = ((pc + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = tent_choose_wave_padded_smem(pc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tent_choose_wave_padded,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tent_choose_wave_padded<<<1, threads, smem, (cudaStream_t)stream>>>(in, out, pc, ps);
  return (int)cudaGetLastError();
}

int tent_on_complete_many_launch(double* state, int ps, const double* batch, int pm, void* stream) {
  if (ps <= 0 || pm < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (ps + DRAIN_THREADS - 1) / DRAIN_THREADS;
  tent_on_complete_many<<<blocks, DRAIN_THREADS, 0, (cudaStream_t)stream>>>(state, ps, batch, pm);
  return (int)cudaGetLastError();
}

}  // extern "C"
