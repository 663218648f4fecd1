// The fused Monte Carlo spray sim for Hopper, sm_90a: a thread group per seed
// lane, the lane's rails across the group.
//
// Replaces the reference's fused lax.scan program that MonteCarloSweep vmaps
// over seeds: repro/core/jit_core.py::_build_sim (the `simulate` closure) with
// spray_single / spray_sweep around it. Its numpy twin, which every lane must
// equal bit for bit on the same draws, is
// repro_torch/core/jit_core.py::simulate_spray_ref; the plain torch version is
// repro_torch/kernels/spray_sim/ref.py::spray_sim_ref (the same loops, batched
// over lanes).
//
// Per lane: D rails plus the scratch row D; `rounds` waves of `wave` slices,
// each slice chosen (Algorithm 1 for tent, a rotation for round robin), posted
// on its rail's busy chain, checked against the rail's fault windows, retried
// once on a rail that is live at detection time, and at the end of the round
// drained through the Eq. 1 EWMA in completion order.
//
// Bound. Each lane is a chain of rounds x wave dependent slice steps (a step's
// choice reads the queues and busy times the previous one wrote). The bytes
// (the draws, once) and the fp64 operations are far below the card's rates;
// the latency of one step sets the time. So the design shortens the step:
// - a group of G threads runs a lane (G = 16 for D + 1 <= 16, 32 up to 32
//   rails, then two rails a thread up to 64). Rail d belongs to thread
//   d mod G of the group: its constants, queue, busy time and EWMA state live
//   in that thread's registers, and so do its jittered windows and the
//   healing minimum of each fault window where K is small (the KF / KS
//   variants), else they live in the group's part of shared memory;
// - before each choice every owner works out what posting the slice on its
//   own rail would do (the charge, the service time and fault test, the
//   rail's next score), so the divisions of a step run on all rails at once
//   and only the chosen rail's owner commits its outcome after the choice;
// - the choice's minimum is a redux.sync over order-preserving integer keys,
//   the gamma window a ballot, the k-th member in rail order a popcount
//   rank; the group learns the failure flag by ballot and the detection time
//   of a retry by shuffle;
// - no step touches device memory: the round's service multipliers are
//   copied into shared memory asynchronously one round ahead (cp.async), and
//   the round's slice records go to shared memory;
// - the end-of-round drain needs no sort. A rail's completed slices end in
//   slice order (its busy chain only grows), so the stable order of end times
//   within a rail is slice order; the failures drain into row D in slice
//   order; and the EWMA updates of one rail touch that rail alone. So each
//   owner walks a list of its own rails' records, all owners at once, and
//   the result equals the serial drain bit for bit.
// A lane runs fastest with a warp to itself (two half-warp groups in one warp
// slow each other down), so the binding's launch plan gives each lane its own
// block up to 8 lanes a SM and packs 16 lanes a block above that.
//
// Bit-exactness: every product, sum, difference and quotient is an explicit
// round-to-nearest intrinsic, and the library is built with --fmad=false, so
// nothing is contracted into an fma: each operation rounds once, in numpy's
// order. Minima and maxima are exact in any order for values that are not
// NaN, so the group reductions may take them in any order. Also handled:
// - the round-robin rotation (arange - rr) % D is numpy's floor modulo, and
//   C's % truncates toward zero (rescore);
// - the degradation factor is a product over the windows that must multiply
//   in window order (degfac());
// - effbw is the min of two products, taken as Python's min(a, b)
//   (candidates);
// - a service time is (L * jm) / effbw: one product, then one division.
//
// Layouts. `prog` (float64): bw_score, bw_src, bw_dst, pen, lat, alpha, b0a,
// b0, b1 over D + 1 rails (row D the scratch row's fills), then fail_start,
// fail_end (D x Kf), degs_start, degs_end, degs_factor (D x Ks), degd_start,
// degd_end, degd_factor (D x Kd). The draws are lane-major, as make_draws
// stacks them: uf (n, D, Kf, 2), us (n, D, Ks, 3), ud (n, D, Kd, 3), jm
// (n, rounds, wave, 2). `out` is (n_lanes, 5): throughput, healing_s,
// bytes_ok, lost, makespan.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_RAILS = 64;  // D + 1 rails: two a thread over a group of 32
constexpr int MAX_BLOCK = 256;  // threads a block (groups x G)
constexpr double FAR_WINDOW = 1e30;  // core/fabric.py: a window that never opens

struct Params {
  int n, D, R, W, Kf, Ks, Kd, round_robin;
  double L, det, gamma, inv;  // inv: 1 / fault_jitter, inf when it is 0
};

// A group's shared memory: doubles, then ints. The round's service
// multipliers, double-buffered (2 x (W, 2)); the round's slice records
// (end, queued_at); with win_smem, every rail's jittered fault windows with
// their healing minima (fs, fe, ma: D x Kf) and degradation windows (ss,
// se, sf: D x Ks; ds, de, df: D x Kd). Ints: each record's rail (D for a
// failure) and the next record of the same rail.
// The binding computes the same size (kernel.py::group_smem_bytes).
struct Layout {
  int jm, end, qat, fs, fe, ma, ss, se, sf, ds, de, df, n_doubles;
  int rail, next;
  long long bytes;
  __host__ __device__ Layout(int D, int W, int Kf, int Ks, int Kd, bool win_smem) {
    int b = 0;
    jm = b, b += 4 * W;
    end = b, b += W;
    qat = b, b += W;
    const int nf = win_smem ? D * Kf : 0, ns = win_smem ? D * Ks : 0, nd = win_smem ? D * Kd : 0;
    fs = b, b += nf;
    fe = b, b += nf;
    ma = b, b += nf;
    ss = b, b += ns;
    se = b, b += ns;
    sf = b, b += ns;
    ds = b, b += nd;
    de = b, b += nd;
    df = b, b += nd;
    n_doubles = b;
    rail = 0;
    next = W;
    bytes = (8LL * n_doubles + 4LL * 2 * W + 15) / 16 * 16;
  }
};

// Python's min(a, b) / max(a, b) and numpy's minimum / maximum for values that
// are not NaN: the first argument unless the second is strictly smaller/greater
__device__ __forceinline__ double pmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double pmax(double a, double b) { return b > a ? b : a; }

// 16-byte global -> shared copy, completed by cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One rail's windows of one kind, three values each: a fault window's onset,
// end and healing minimum, or a degradation window's start, end and factor.
// CAP > 0: at most CAP windows, in registers, the slots past K padded with a
// window that never opens (each() unrolls over all CAP, so every index is a
// constant and no loop branches); CAP == 0: K windows in the group's shared
// memory.
template <int CAP>
struct Win {
  double a_[CAP > 0 ? CAP : 1], b_[CAP > 0 ? CAP : 1], c_[CAP > 0 ? CAP : 1];
  double *pa, *pb, *pc;
  int K;
  __device__ __forceinline__ double& a(int k) {
    if constexpr (CAP > 0) return a_[k]; else return pa[k];
  }
  __device__ __forceinline__ double& b(int k) {
    if constexpr (CAP > 0) return b_[k]; else return pb[k];
  }
  __device__ __forceinline__ double& c(int k) {
    if constexpr (CAP > 0) return c_[k]; else return pc[k];
  }
  // f(a, b, c) on every window in window order (and on the padding)
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    if constexpr (CAP > 0) {
#pragma unroll
      for (int k = 0; k < CAP; ++k) f(a_[k], b_[k], c_[k]);
    } else {
      for (int k = 0; k < K; ++k) f(pa[k], pb[k], pc[k]);
    }
  }
};

// a fault window visible at t: onset + detect <= t < end + detect
template <int CAP>
__device__ __forceinline__ bool visible(Win<CAP>& f, double det, double t) {
  bool hit = false;
  f.each([&](double& a, double& b, double&) {
    hit |= (__dadd_rn(a, det) <= t) & (t < __dadd_rn(b, det));
  });
  return hit;
}

template <int CAP>
__device__ __forceinline__ bool overlaps(Win<CAP>& f, double st, double en) {
  bool hit = false;
  f.each([&](double& a, double& b, double&) { hit |= (a < en) & (b > st); });
  return hit;
}

// product of the active windows' factors, multiplied in window order
template <int CAP>
__device__ __forceinline__ double degfac(Win<CAP>& w, double t) {
  double out = 1.0;
  w.each([&](double& a, double& b, double& c) {
    out = (a <= t) & (t < b) ? __dmul_rn(out, c) : out;
  });
  return out;
}

// _jitter_windows_np: onset scaled and clamped at 0, duration scaled; with
// factors `fac`, np.clip(factor * (1 + u2 / inv), 0.01, 1.0) into c, else c = inf
// (a fault window's healing minimum). Window k of the rail is element
// i0 + k of the program's arrays and draws u[(i0 + k) * comps ...].
template <int CAP>
__device__ __forceinline__ void jitter(Win<CAP>& w, const double* start, const double* end,
                                       const double* fac, const double* u, int i0, int comps,
                                       double inv) {
#pragma unroll
  for (int k = 0; k < (CAP > 0 ? CAP : w.K); ++k) {
    if (k >= w.K) {  // padding: a window that never opens
      w.a(k) = INFINITY;
      w.b(k) = -INFINITY;
      w.c(k) = fac ? 1.0 : INFINITY;
      continue;
    }
    const int i = i0 + k;
    const double* ui = u + (size_t)i * comps;
    const double v = __dmul_rn(start[i], __dadd_rn(1.0, __ddiv_rn(ui[0], inv)));
    const double st = v > 0.0 ? v : 0.0;  // np.maximum(0.0, v)
    const double scale1 = __dadd_rn(1.0, __ddiv_rn(ui[1], inv));
    w.a(k) = st;
    w.b(k) = __dadd_rn(st, __ddiv_rn(__dsub_rn(end[i], start[i]), __ddiv_rn(1.0, scale1)));
    if (fac) {
      double f = __dmul_rn(fac[i], __dadd_rn(1.0, __ddiv_rn(ui[2], inv)));
      f = f < 0.01 ? 0.01 : f;
      f = f > 1.0 ? 1.0 : f;
      w.c(k) = f;
    } else {
      w.c(k) = INFINITY;
    }
  }
}

// The group's minimum of values that are not NaN, exact: a double maps to
// an unsigned 64-bit key of the same order (negative values have their bits
// flipped, the others their sign bit set), and the group takes the least
// key's high word, then the least low word under it, by redux.sync.
__device__ __forceinline__ double group_min(double v, unsigned mask) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  const unsigned long long key = (long long)u < 0 ? ~u : u | 0x8000000000000000ull;
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned mhi = __reduce_min_sync(mask, hi);
  const unsigned mlo = __reduce_min_sync(mask, hi == mhi ? lo : 0xffffffffu);
  const unsigned long long m = (unsigned long long)mhi << 32 | mlo;
  return __longlong_as_double((long long)((long long)m < 0 ? m & 0x7fffffffffffffffull : ~m));
}

// the group's ballot, bit g for the group's thread g
template <int G>
__device__ __forceinline__ unsigned group_ballot(unsigned mask, int gbase, bool p) {
  const unsigned b = __ballot_sync(mask, p);
  return G == 32 ? b : (b >> gbase) & ((1u << G) - 1u);
}

// Group-collective _select_np over the rails the threads own: the k-th
// member, in rail order, of the window of scores within opg = 1 + gamma of
// the minimum (k = rr mod its size for tent, 0 for round robin). With
// `use_mask`, a thread's `masked` rails score inf unless that leaves no
// finite score, in which case the raw scores stand (soft exclusion). Every
// thread returns the same rail; D for an empty window (gamma < 0), as the
// serial select did.
template <int G, int RPT>
__device__ __forceinline__ int choose(const double (&sc)[RPT], const bool (&masked)[RPT],
                                      bool use_mask, const bool (&present)[RPT], double opg,
                                      unsigned kr, unsigned mask, int gbase, int g, int D) {
  double e[RPT];
  double m = INFINITY;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    e[j] = use_mask && masked[j] ? INFINITY : sc[j];
    m = pmin(m, e[j]);
  }
  m = group_min(m, mask);
  if (!isfinite(m)) {  // no unmasked rail has a finite score: mask off
    m = INFINITY;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      e[j] = sc[j];
      m = pmin(m, e[j]);
    }
    m = group_min(m, mask);
  }
  const double thr = __dmul_rn(opg, m);
  unsigned ball[RPT];
  int n_w = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    ball[j] = group_ballot<G>(mask, gbase, present[j] && e[j] <= thr);
    n_w += __popc(ball[j]);
  }
  const int k = (int)(kr % (unsigned)(n_w > 1 ? n_w : 1));
  int before = 0, d = D;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const bool mine = ((ball[j] >> g) & 1u) && before + __popc(ball[j] & ((1u << g) - 1u)) == k;
    const unsigned who = group_ballot<G>(mask, gbase, mine);
    if (who) d = j * G + __ffs(who) - 1;
    before += __popc(ball[j]);
  }
  return d;
}

// One group of G threads per seed lane (RPT rails a thread); fault windows
// in registers up to KF a rail and degradation windows up to KS a rail, or
// both in shared memory (KF = KS = 0).
template <int G, int RPT, int KF, int KS>
__global__ void __launch_bounds__(MAX_BLOCK)
spray_sim(Params P, const double* __restrict__ prog, const double* __restrict__ uf,
          const double* __restrict__ us, const double* __restrict__ ud,
          const double* __restrict__ jm, double* __restrict__ out, int groups_per_block,
          int group_bytes) {
  static_assert(G == 16 || G == 32, "a group is a half warp or a warp");
  static_assert((KF > 0) == (KS > 0), "windows all in registers or all in shared memory");
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  const int lane = blockIdx.x * groups_per_block + grp;
  if (lane >= P.n) return;  // the whole group
  const int D = P.D, D1 = P.D + 1, R = P.R, W = P.W;
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << gbase;
  const Layout lay(D, W, P.Kf, P.Ks, P.Kd, KF == 0);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem + (size_t)grp * group_bytes;
  double* sd = reinterpret_cast<double*>(base);
  int* si = reinterpret_cast<int*>(base + (size_t)lay.n_doubles * 8);
  double *rec_end = sd + lay.end, *rec_qat = sd + lay.qat;
  int *rec_rail = si + lay.rail, *next_rec = si + lay.next;

  // round r's (W, 2) service multipliers into buffer r & 1, one slice's pair
  // (16 bytes) a copy
  const double* jm_lane = jm + (size_t)lane * R * W * 2;
  auto fetch_round = [&](int r) {
    double* dst = sd + lay.jm + (r & 1) * 2 * W;
    const double* src = jm_lane + (size_t)r * W * 2;
    for (int i = g; i < W; i += G) cp_async16(dst + 2 * i, src + 2 * i);
    cp_async_commit();
  };
  if (R > 0) fetch_round(0);

  // the rails this thread owns: d = j * G + g
  bool present[RPT], real[RPT];
  double q[RPT], busy[RPT], b0[RPT], b1[RPT], bws[RPT], bsrc[RPT], bdst[RPT], pen[RPT],
      lat[RPT], alpha[RPT], b0a[RPT];
  Win<KF> fw[RPT];
  Win<KS> sw[RPT], dw[RPT];
  const int nf = D * P.Kf, ns = D * P.Ks, nd = D * P.Kd;
  const double* win = prog + 9 * D1;
  const double *fail_start = win, *fail_end = win + nf;
  const double *degs_start = win + 2 * nf, *degs_end = degs_start + ns,
               *degs_factor = degs_end + ns;
  const double *degd_start = degs_factor + ns, *degd_end = degd_start + nd,
               *degd_factor = degd_end + nd;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int d = j * G + g;
    present[j] = d <= D;
    real[j] = d < D;
    const int i = present[j] ? d : D;  // a rail past D: never in a window
    bws[j] = prog[i];
    bsrc[j] = prog[D1 + i];
    bdst[j] = prog[2 * D1 + i];
    pen[j] = prog[3 * D1 + i];
    lat[j] = prog[4 * D1 + i];
    alpha[j] = prog[5 * D1 + i];
    b0a[j] = prog[6 * D1 + i];
    b0[j] = prog[7 * D1 + i];
    b1[j] = prog[8 * D1 + i];
    q[j] = 0.0;
    busy[j] = 0.0;
    fw[j].K = real[j] ? P.Kf : 0;
    sw[j].K = real[j] ? P.Ks : 0;
    dw[j].K = real[j] ? P.Kd : 0;
    if constexpr (KF == 0) {
      const int r = real[j] ? d : 0;
      fw[j].pa = sd + lay.fs + r * P.Kf, fw[j].pb = sd + lay.fe + r * P.Kf;
      fw[j].pc = sd + lay.ma + r * P.Kf;
      sw[j].pa = sd + lay.ss + r * P.Ks, sw[j].pb = sd + lay.se + r * P.Ks;
      sw[j].pc = sd + lay.sf + r * P.Ks;
      dw[j].pa = sd + lay.ds + r * P.Kd, dw[j].pb = sd + lay.de + r * P.Kd;
      dw[j].pc = sd + lay.df + r * P.Kd;
    }
    jitter(fw[j], fail_start, fail_end, nullptr, uf + (size_t)lane * nf * 2, d * P.Kf, 2, P.inv);
    jitter(sw[j], degs_start, degs_end, degs_factor, us + (size_t)lane * ns * 3, d * P.Ks, 3,
           P.inv);
    jitter(dw[j], degd_start, degd_end, degd_factor, ud + (size_t)lane * nd * 3, d * P.Kd, 3,
           P.inv);
  }

  const double L = P.L, det = P.det;
  const bool by_rr = P.round_robin != 0;
  const double opg = __dadd_rn(1.0, by_rr ? 0.0 : P.gamma);  // round robin: select(rot, 0, 0.0)
  double now = 0.0;
  unsigned rr = 0;  // < 2^31: the launcher checks 2 * R * W
  int total_ok = 0;
  double sc[RPT];

  // tent's cost model for rail j with queue qv: the score a choice reads
  auto tent_score = [&](int j, double qv) {
    return present[j] ? __dmul_rn(pen[j], __dadd_rn(b0[j], __ddiv_rn(__dmul_rn(
                            b1[j], __dadd_rn(qv, L)), bws[j])))
                      : INFINITY;
  };
  // every owned rail's score: tent's (after the drain), or the rotation
  // (before each choice; numpy's (i - rr) % D is a floor modulo, C's %
  // truncates toward zero)
  auto rescore = [&]() {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (!by_rr) {
        sc[j] = tent_score(j, q[j]);
      } else {
        int rot = j * G + g - (int)(rr % (unsigned)D);
        if (rot < 0) rot += D;
        sc[j] = real[j] ? (double)rot : INFINITY;
      }
    }
  };
  // Every thread works out, for each rail it owns, what posting the next
  // attempt there would do (started no earlier than t0, service multiplier
  // jmv): line 11's charge, the busy chain, the fault test, and (tent) the
  // rail's score with the charge held. Only the chosen rail's owner commits
  // its outcome, so the post's divisions need not wait for the choice.
  double c_q[RPT], c_start[RPT], c_endb[RPT], c_held[RPT];
  bool c_fail[RPT];
  auto candidates = [&](double t0, double jmv) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      c_q[j] = __dadd_rn(q[j], L);
      c_held[j] = by_rr ? 0.0 : tent_score(j, c_q[j]);
      c_start[j] = pmax(t0, busy[j]);
      const double eb = pmin(__dmul_rn(bsrc[j], degfac(sw[j], c_start[j])),
                             __dmul_rn(bdst[j], degfac(dw[j], c_start[j])));
      c_endb[j] = __dadd_rn(c_start[j], __ddiv_rn(__dmul_rn(L, jmv), eb));
      c_fail[j] = overlaps(fw[j], c_start[j], c_endb[j]);
    }
  };
  // The owner of rail d commits its candidate as slice w's attempt: the
  // charge, busy time and score of an attempt that holds, or the charge
  // withdrawn from one that fails (the caller rescores the rail then);
  // `last_try` records the slice (a failure as row D's). Selects, not
  // branches. Returns whether the attempt failed, and through t2 its
  // detection time; other threads return false.
  auto commit = [&](int d, int w, bool last_try, double& t2) {
    bool fail = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const bool own = j * G + g == d, holds = own & !c_fail[j];
      const double back = __dsub_rn(c_q[j], L);
      fail |= own & c_fail[j];
      q[j] = own ? (c_fail[j] ? back : c_q[j]) : q[j];
      busy[j] = holds ? c_endb[j] : busy[j];
      sc[j] = holds ? c_held[j] : sc[j];
      t2 = own ? __dadd_rn(c_start[j], det) : t2;
      if (own & (holds | last_try)) {
        rec_rail[w] = holds ? d : D;
        rec_end[w] = __dadd_rn(c_endb[j], lat[j]);
        rec_qat[w] = c_q[j];
      }
    }
    return fail;
  };
  // tent: the owner of rail d rescores it after a failed attempt
  auto rescore_rail = [&](int d) {
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (!by_rr && j * G + g == d) sc[j] = tent_score(j, q[j]);
  };
  // Each rail's records of the round, in slice order, as a list through
  // `next_rec` whose head and tail the rail's owner keeps; failures make
  // row D's list. A rail's completed slices end in slice order (its busy
  // chain only grows), so slice order is the drain's stable order of end
  // times within the rail; and the drain's updates of a rail touch that
  // rail alone. So each owner drains its own rails, all in parallel.
  int head[RPT], tail[RPT];
  auto append = [&](int d, int w) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const bool own = j * G + g == d;
      if (own & (tail[j] >= 0)) next_rec[tail[j]] = w;
      head[j] = own & (tail[j] < 0) ? w : head[j];
      tail[j] = own ? w : tail[j];
    }
  };

  if (!by_rr) rescore();
  for (int r = 0; r < R; ++r) {
    cp_async_wait_all();
    __syncwarp(mask);  // round r's multipliers are in; round r - 1's buffer is free
    if (r + 1 < R) fetch_round(r + 1);
    const double* jmr = sd + lay.jm + (r & 1) * 2 * W;
    bool excl[RPT];  // tent's mask: rails with a fault visible now, and row D
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      excl[j] = !real[j] || visible(fw[j], det, now);
      head[j] = tail[j] = -1;
    }
    for (int w = 0; w < W; ++w) {
      if (by_rr) rescore();
      candidates(now, jmr[2 * w]);
      const int d1 = choose<G, RPT>(sc, excl, !by_rr, present, opg, by_rr ? 0u : rr, mask, gbase,
                                    g, D);
      ++rr;
      double t2 = 0.0;
      int d_f = d1;
      if (group_ballot<G>(mask, gbase, commit(d1, w, false, t2))) {
        // the retry, at detection time, on a rail that is live then
        rescore_rail(d1);
        t2 = __shfl_sync(mask, t2, d1 & (G - 1), G);
        bool live_not[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) live_not[j] = !real[j] || visible(fw[j], det, t2);
        if (by_rr) rescore();
        candidates(t2, jmr[2 * w + 1]);
        const int d2 = choose<G, RPT>(sc, live_not, true, present, opg, by_rr ? 0u : rr, mask,
                                      gbase, g, D);
        ++rr;
        const bool f2 = group_ballot<G>(mask, gbase, commit(d2, w, true, t2));
        if (f2) rescore_rail(d2);
        d_f = f2 ? D : d2;  // a failure drains into the scratch row
      }
      total_ok += d_f < D;
      append(d_f, w);
    }
    __syncwarp(mask);  // the round's records are in
    // The round's first and last completed ends: a real rail's list holds
    // its completions in end order, so its head ends first and its tail
    // last (the maximum is the negated minimum of the negated ends).
    double my_first = INFINITY, my_last = INFINITY;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (!real[j] || tail[j] < 0) continue;
      my_first = pmin(my_first, rec_end[head[j]]);
      my_last = pmin(my_last, -rec_end[tail[j]]);
    }
    const double first = group_min(my_first, mask), last = -group_min(my_last, mask);
    const bool any_ok = last != -INFINITY;
    // The healing minima of the fault windows: each onset's earliest
    // completed end at or after it. Only a window with an onset no later
    // than `last` and a minimum above `first` can change, so the records
    // are read only in a round where some window of the group can.
    bool stale = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      fw[j].each([&](double& a, double&, double& c) { stale |= (a <= last) & (c > first); });
    if (group_ballot<G>(mask, gbase, stale)) {
      for (int v = 0; v < W; ++v) {
        if (rec_rail[v] >= D) continue;
        const double e = rec_end[v];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          fw[j].each([&](double& a, double&, double& c) { c = e >= a ? pmin(c, e) : c; });
      }
    }
    // the Eq. 1 EWMA drain, each owner down its rails' lists
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      for (int i = head[j]; i >= 0; i = i == tail[j] ? -1 : next_rec[i]) {
        const double tob = __dsub_rn(rec_end[i], now);
        const double a = alpha[j];
        const double x = __ddiv_rn(__dadd_rn(rec_qat[i], L), bws[j]);
        double sample = __ddiv_rn(__dsub_rn(tob, b0[j]), x > 0.0 ? x : 1.0);
        sample = sample < 0.05 ? 0.05 : sample;
        sample = sample > 1e4 ? 1e4 : sample;
        if (x > 0.0) b1[j] = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a), b1[j]), __dmul_rn(a, sample));
        double resid = __dsub_rn(tob, __dmul_rn(b1[j], x));
        resid = resid > 0.0 ? resid : 0.0;  // max(0.0, resid)
        b0[j] = __dadd_rn(__dmul_rn(__dsub_rn(1.0, b0a[j]), b0[j]), __dmul_rn(b0a[j], resid));
        const double v = __dsub_rn(q[j], L);
        q[j] = v > 0.0 ? v : 0.0;
      }
    }
    now = any_ok ? last : __dadd_rn(now, det);
    if (!by_rr) rescore();
  }
  const double bytes_ok = __dmul_rn((double)total_ok, L);
  const double makespan = now;
  const double throughput = __ddiv_rn(bytes_ok, pmax(makespan, 1e-12));
  const double lim = pmin(makespan, FAR_WINDOW * 0.5);
  bool any_valid = false;
  double heal = -INFINITY;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    fw[j].each([&](double& o, double&, double& c) {
      if (o < lim) {
        any_valid = true;
        heal = pmax(heal, __dsub_rn(c, o));
      }
    });
  }
  heal = -group_min(-heal, mask);
  any_valid = group_ballot<G>(mask, gbase, any_valid) != 0u;
  if (g == 0) {
    double* o = out + (size_t)lane * 5;
    o[0] = throughput;
    o[1] = any_valid ? heal : -1.0;
    o[2] = bytes_ok;
    o[3] = (double)((long long)R * W - total_ok);
    o[4] = makespan;
  }
}

template <int G, int RPT, int KF, int KS>
int launch(const Params& P, const double* prog, const double* uf, const double* us,
           const double* ud, const double* jm, double* out, int gpb, int group_bytes,
           cudaStream_t stream) {
  auto kern = spray_sim<G, RPT, KF, KS>;
  const size_t smem = (size_t)gpb * group_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (P.n + gpb - 1) / gpb;
  kern<<<blocks, gpb * G, smem, stream>>>(P, prog, uf, us, ud, jm, out, gpb, group_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one seed lane's group holds (Layout), with its
// windows in shared memory (win_smem) or in registers.
long long spray_sim_group_bytes(int D, int W, int Kf, int Ks, int Kd, int win_smem) {
  return Layout(D, W, Kf, Ks, Kd, win_smem != 0).bytes;
}

// The launch plan comes from the binding (kernel.py::launch_plan): G threads
// a lane, windows in registers up to kf_cap / ks_cap a rail (0: in shared
// memory), groups_per_block lanes a block with group_bytes of shared memory
// each. A plan this file has no kernel for, or too little shared memory, is
// refused with cudaErrorInvalidValue before anything runs.
int spray_sim_launch(const double* prog, const double* uf, const double* us, const double* ud,
                     const double* jm, double* out, int n_lanes, int D, int R, int W, int Kf,
                     int Ks, int Kd, int round_robin, double L, double det, double gamma,
                     double inv, int G, int kf_cap, int ks_cap, int groups_per_block,
                     int group_bytes, void* stream) {
  if (n_lanes <= 0 || D < 1 || D + 1 > MAX_RAILS || R < 0 || W < 0 || Kf < 0 || Ks < 0 ||
      Kd < 0 || 2LL * R * W >= (1LL << 31) || groups_per_block < 1 ||
      (long long)groups_per_block * G > MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  const bool regs = kf_cap > 0;
  if (regs != (ks_cap > 0) || (regs && (Kf > kf_cap || Ks > ks_cap || Kd > ks_cap)) ||
      group_bytes < Layout(D, W, Kf, Ks, Kd, !regs).bytes || group_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const Params P{n_lanes, D, R, W, Kf, Ks, Kd, round_robin, L, det, gamma, inv};
  cudaStream_t s = (cudaStream_t)stream;
  const int gpb = groups_per_block, gb = group_bytes;
  if (G == 16 && D + 1 <= 16) {
    if (kf_cap == 2 && ks_cap == 1) return launch<16, 1, 2, 1>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
    if (kf_cap == 2 && ks_cap == 3) return launch<16, 1, 2, 3>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
    if (kf_cap == 8 && ks_cap == 1) return launch<16, 1, 8, 1>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
    if (kf_cap == 8 && ks_cap == 3) return launch<16, 1, 8, 3>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
    if (!regs) return launch<16, 1, 0, 0>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
  } else if (G == 32 && !regs) {
    if (D + 1 <= 32) return launch<32, 1, 0, 0>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
    return launch<32, 2, 0, 0>(P, prog, uf, us, ud, jm, out, gpb, gb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
