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
// The drain costs its deepest slot's chain plus the launch, the staging of
// the batch and the linking pass (a warp step per 32 entries of a warp's
// segment, then a step per segment): each
// slot's thread walks only its own completions, linked in batch order in
// shared memory, with each entry's quotient x computed beforehand in
// parallel, so a step's chain is the sample's division and the two EWMA
// updates; the padded tail past the live count is never walked.
//
// Layouts (all float64, as the wrapper packs them into one staging buffer;
// integer and boolean values travel as exact doubles):
//   chooser in : q[pc] gl[pc] gr[pc] bw[pc] b0[pc] b1[pc] pen[pc] ex[pc]
//                len[ps] valid[ps] rr gamma
//   chooser out: choice[ps] queued_at[ps] q_out[pc] rr_out
//   drain state: b0[ps] b1[ps] q[ps] ew[ps] comp[ps] alpha[ps] b0a[ps] bw[ps]
//                (the first five updated in place)
//   drain batch: slot[pm] len[pm] queued_at[pm] t_obs[pm], the first m live

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int DRAIN_THREADS = 256;
constexpr int DRAIN_TILE = 1024;

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

// ---------------------------------------------------------------- the drain
// A block owns DRAIN_THREADS slots (several blocks above that) and drains
// the live batch a shared tile at a time, the slots' state in registers from
// tile to tile:
//   1. stage: the tile's four columns into shared memory by plain coalesced
//      loads (the first tile's asked for while the slots' state is in
//      flight, so a launch on host memory through a mapped pointer waits for
//      one round trip, not one per phase);
//   2. off the chain: an entry a thread, x = (queued_at + len) / bw[slot],
//      written over queued_at (the block's bandwidths in shared memory);
//   3. link: each warp walks its own segment of the tile backwards 32
//      entries at a time and threads each slot's entries into a list in
//      batch order (__match_any_sync groups the lanes of one slot; a lane's
//      successor is the next higher lane of its group, the highest takes the
//      old head, the lowest becomes the new head), then each slot's thread
//      joins its segments' lists in warp order: no atomics, deterministic;
//   4. walk: slot d's thread runs the recurrence down its own list, the
//      operands of the next entry read from shared memory before this
//      entry's chain, the x > 0 branch a select.
// Entries at or past the live count m are never read, so the padded tail
// costs nothing and the scratch row keeps its gathered value.

constexpr int DRAIN_WARPS = DRAIN_THREADS / 32;

// Staging of the tile of n entries at j0, in two halves so that a
// thread's loads are all in flight before the first store: its entries
// (tid, tid + DRAIN_THREADS, ...) into registers, then into shared memory.
constexpr int DRAIN_PER_THREAD = DRAIN_TILE / DRAIN_THREADS;
__device__ __forceinline__ void load_tile(double (&v)[4][DRAIN_PER_THREAD], const double* batch,
                                          int pm, int j0, int n) {
#pragma unroll
  for (int k = 0; k < DRAIN_PER_THREAD; ++k) {
    const int i = (int)threadIdx.x + k * DRAIN_THREADS;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c][k] = i < n ? batch[(size_t)c * pm + j0 + i] : 0.0;
  }
}
__device__ __forceinline__ void store_tile(double (*cols)[DRAIN_TILE],
                                           const double (&v)[4][DRAIN_PER_THREAD], int n) {
#pragma unroll
  for (int k = 0; k < DRAIN_PER_THREAD; ++k) {
    const int i = (int)threadIdx.x + k * DRAIN_THREADS;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i < n) cols[c][i] = v[c][k];
  }
}
// The entry's slot less the block's first, or -1 for another block's (or none)
__device__ __forceinline__ int local_slot(double sv, int base, int nslots) {
  return sv >= (double)base && sv < (double)(base + nslots) ? (int)sv - base : -1;
}

__global__ void __launch_bounds__(DRAIN_THREADS)
tent_on_complete_many(double* __restrict__ st, int ps, const double* __restrict__ batch, int pm,
                      int m) {
  __shared__ double cols[4][DRAIN_TILE];  // slot, len, queued_at then x, t_obs
  __shared__ int nxt[DRAIN_TILE];  // the slot's next entry in batch order, or -1
  __shared__ short seg_head[DRAIN_WARPS][DRAIN_THREADS];  // a segment's first entry of a slot
  __shared__ short seg_tail[DRAIN_WARPS][DRAIN_THREADS];  // and its last
  __shared__ double bws[DRAIN_THREADS];  // the block's slots' bandwidths
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * DRAIN_THREADS;
  const int nslots = ps - base < DRAIN_THREADS ? ps - base : DRAIN_THREADS;
  const int d = base + tid;
  const bool live = tid < nslots;
  // the state's loads and the first tile's go out together, before any is used
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
  const int n0 = m < DRAIN_TILE ? m : DRAIN_TILE;
  double v[4][DRAIN_PER_THREAD];
  load_tile(v, batch, pm, 0, n0);
  if (live) bws[tid] = bw;
  store_tile(cols, v, n0);
  const double oma = __dsub_rn(1.0, alpha), omb = __dsub_rn(1.0, b0a);
  for (int j0 = 0; j0 < m; j0 += DRAIN_TILE) {
    const int n = m - j0 < DRAIN_TILE ? m - j0 : DRAIN_TILE;
    // 1. stage the tile (the first is staged above)
    if (j0 > 0) {
      load_tile(v, batch, pm, j0, n);
      store_tile(cols, v, n);
    }
    __syncthreads();
    // 2. the state-free work: x = (queued_at + len) / bw, the reference's order
    for (int i = tid; i < n; i += DRAIN_THREADS) {
      const int s = local_slot(cols[0][i], base, nslots);
      if (s >= 0) cols[2][i] = __ddiv_rn(__dadd_rn(cols[2][i], cols[1][i]), bws[s]);
    }
    // 3. link: warp w's segment [w * seg, (w + 1) * seg), backwards
    const int seg = ((n + DRAIN_THREADS - 1) / DRAIN_THREADS) * 32;  // 32-entry steps
    const int nseg = (n + seg - 1) / seg;
    if (warp < nseg) {
      short* head = seg_head[warp];
      short* tail = seg_tail[warp];
      for (int t = lane; t < DRAIN_THREADS; t += 32) head[t] = -1;
      __syncwarp();
      const int lo = warp * seg, hi = lo + seg < n ? lo + seg : n;
      for (int c0 = lo + ((hi - 1 - lo) & ~31); c0 >= lo; c0 -= 32) {
        const int i = c0 + lane;
        const int s = i < hi ? local_slot(cols[0][i], base, nslots) : -1;
        const unsigned grp = __match_any_sync(0xffffffffu, s);
        int nx = -1;
        if (s >= 0) {
          const unsigned above = grp & ~((2u << lane) - 1u);  // the group's higher lanes
          nx = above ? c0 + __ffs(above) - 1 : head[s];
          if (nx < 0) tail[s] = (short)i;  // the segment's last entry of s
        }
        __syncwarp();  // every old head read before the new ones are written
        if (s >= 0) {
          nxt[i] = nx;
          if ((grp & ((1u << lane) - 1u)) == 0) head[s] = (short)i;  // the group's lowest lane
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // 4. join the slot's segments in warp order, then walk its list
    int i = -1;
    if (live) {
      int last = -1;
      for (int w = 0; w < nseg; ++w) {
        const int h = seg_head[w][tid];
        if (h < 0) continue;
        if (last >= 0) nxt[last] = h;
        else i = h;
        last = seg_tail[w][tid];
      }
    }
    if (i >= 0) {
      double x = cols[2][i], L = cols[1][i], tob = cols[3][i];
      int nx = nxt[i];
      for (;;) {
        double x2 = 0.0, L2 = 0.0, t2 = 0.0;
        int nx2 = -1;
        if (nx >= 0) {  // the next entry's operands, off this entry's chain
          x2 = cols[2][nx];
          L2 = cols[1][nx];
          t2 = cols[3][nx];
          nx2 = nxt[nx];
        }
        const bool pos = x > 0.0;
        double sample = __ddiv_rn(__dsub_rn(tob, b0), pos ? x : 1.0);
        sample = sample < 0.05 ? 0.05 : sample;  // min(max(sample, 0.05), 1e4)
        sample = 1e4 < sample ? 1e4 : sample;
        const double nb1 = __dadd_rn(__dmul_rn(oma, b1), __dmul_rn(alpha, sample));
        b1 = pos ? nb1 : b1;
        double resid = __dsub_rn(tob, __dmul_rn(b1, x));
        resid = resid > 0.0 ? resid : 0.0;  // max(0.0, resid)
        b0 = __dadd_rn(__dmul_rn(omb, b0), __dmul_rn(b0a, resid));
        const double qd = __dsub_rn(q, L);
        q = qd > 0.0 ? qd : 0.0;
        ew = __dadd_rn(__dmul_rn(oma, ew), __dmul_rn(alpha, tob));
        comp = __dadd_rn(comp, 1.0);
        if (nx < 0) break;
        x = x2;
        L = L2;
        tob = t2;
        nx = nx2;
      }
    }
    __syncthreads();  // the next tile is staged over this one
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

// The first m entries of the batch drain.
int tent_on_complete_many_launch(double* state, int ps, const double* batch, int pm, int m,
                                 void* stream) {
  if (ps <= 0 || pm < 0 || m < 0 || m > pm) return (int)cudaErrorInvalidValue;
  const int blocks = (ps + DRAIN_THREADS - 1) / DRAIN_THREADS;
  tent_on_complete_many<<<blocks, DRAIN_THREADS, 0, (cudaStream_t)stream>>>(state, ps, batch, pm,
                                                                           m);
  return (int)cudaGetLastError();
}

// The device pointer of a pinned host buffer, through which a kernel reads
// and writes it in place.
int tent_mapped_pointer(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}

// One staged drain, waited for: `dev` is the mapped device pointer of the
// pinned staging buffer (the eight state vectors over ps slots, then the four
// batch columns over pm), which the kernel reads and writes in place.
int tent_on_complete_many_staged(double* dev, int ps, int pm, int m, void* stream) {
  const int launched = tent_on_complete_many_launch(dev, ps, dev + 8 * (size_t)ps, pm, m, stream);
  if (launched != 0) return launched;
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

}  // extern "C"
