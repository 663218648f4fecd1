// The fused Monte Carlo spray sim for Hopper, sm_90a: one seed lane a thread.
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
// Hazards, each handled where it arises below:
// - bit-exactness: every product, sum, difference and quotient is an explicit
//   round-to-nearest intrinsic, and the library is built with --fmad=false, so
//   nothing is contracted into an fma: each operation rounds once, in numpy's
//   order;
// - the round-robin rotation (arange - rr) % D is numpy's floor modulo, and
//   C's % truncates toward zero (rotation());
// - the degradation factor is a product over the windows that must multiply
//   in window order (degfac());
// - effbw is the min of two products, taken as Python's min(a, b) (effbw());
// - a service time is (L * jm) / effbw: one product, then one division;
// - the drain walks the round's slices in a stable order of their end times,
//   failed slices (key inf) last in slice order (the insertion sort);
// - the healing time is a min over ends and a max over onsets, exact in any
//   order, so it is kept as a running minimum per fault onset.
//
// Bound. Each lane is a chain of rounds x wave dependent slice steps (a step's
// choice reads the queues and busy times the previous one wrote), each some
// tens of fp64 operations over D + 1 rails, among them D + 1 divisions. The
// bytes (the draws, once) and the operations are far below the card's rates;
// the chain's latency sets the time, one thread's worth, with lanes in
// parallel across the SMs.
//
// Layouts. `prog` (float64): bw_score, bw_src, bw_dst, pen, lat, alpha, b0a,
// b0, b1 over D + 1 rails (row D the scratch row's fills), then fail_start,
// fail_end (D x Kf), degs_start, degs_end, degs_factor (D x Ks), degd_start,
// degd_end, degd_factor (D x Kd). Draws and scratch are lane-fastest: element
// i of lane l at [i * n_lanes + l]; uf (D, Kf, 2), us (D, Ks, 3), ud (D, Kd, 3),
// jm (rounds, wave, 2). `out` is (n_lanes, 5): throughput, healing_s,
// bytes_ok, lost, makespan.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // one warp a block: lanes spread over the SMs
constexpr int MAX_RAILS = 63;  // D + 1 rails fit a 64-bit mask
constexpr double FAR_WINDOW = 1e30;  // core/fabric.py: a window that never opens

struct Params {
  int n, D, R, W, Kf, Ks, Kd, round_robin;
  double L, det, gamma, inv;  // inv: 1 / fault_jitter, inf when it is 0
};

// Python's min(a, b) / max(a, b) and numpy's minimum / maximum for values that
// are not NaN: the first argument unless the second is strictly smaller/greater
__device__ __forceinline__ double pmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double pmax(double a, double b) { return b > a ? b : a; }

struct Lane {
  Params P;
  const double* prog;
  double* scr;
  int lane;
  // scratch bases (in units of n_lanes)
  int Q, BUSY, B0, B1, FS, FE, DSS, DSE, DSF, DDS, DDE, DDF, MA, DS, ENDS, OK, QAT, ORD;

  __device__ double& s(int base, int i) const { return scr[(size_t)(base + i) * P.n + lane]; }
  __device__ double c(int vec, int i) const { return prog[vec * (P.D + 1) + i]; }
  __device__ double bw_score(int i) const { return c(0, i); }
  __device__ double bw_src(int i) const { return c(1, i); }
  __device__ double bw_dst(int i) const { return c(2, i); }
  __device__ double pen(int i) const { return c(3, i); }
  __device__ double lat(int i) const { return c(4, i); }
  __device__ double alpha(int i) const { return c(5, i); }
  __device__ double b0a(int i) const { return c(6, i); }

  // rails d < D with a fault window visible at t (onset + detect <= t < end +
  // detect), and the scratch row D, which tent's choice always masks
  __device__ unsigned long long excluded(double t) const {
    unsigned long long m = 1ull << P.D;
    for (int d = 0; d < P.D; ++d)
      for (int k = 0; k < P.Kf; ++k) {
        const int i = d * P.Kf + k;
        if (__dadd_rn(s(FS, i), P.det) <= t && t < __dadd_rn(s(FE, i), P.det)) {
          m |= 1ull << d;
          break;
        }
      }
    return m;
  }

  __device__ bool overlaps(int d, double st, double en) const {
    if (d >= P.D) return false;
    for (int k = 0; k < P.Kf; ++k) {
      const int i = d * P.Kf + k;
      if (s(FS, i) < en && s(FE, i) > st) return true;
    }
    return false;
  }

  // product of the active windows' factors, multiplied in window order
  __device__ double degfac(int ST, int EN, int FAC, int K, int d, double t) const {
    double out = 1.0;
    if (d < P.D)
      for (int k = 0; k < K; ++k) {
        const int i = d * K + k;
        if (s(ST, i) <= t && t < s(EN, i)) out = __dmul_rn(out, s(FAC, i));
      }
    return out;
  }

  __device__ double effbw(int d, double t) const {
    return pmin(__dmul_rn(bw_src(d), degfac(DSS, DSE, DSF, P.Ks, d, t)),
                __dmul_rn(bw_dst(d), degfac(DDS, DDE, DDF, P.Kd, d, t)));
  }

  // _select_np: the (rr mod n_window)-th score within (1 + gamma) of the
  // minimum, in rail order
  __device__ int select(const double* sc, long long rr, double gamma) const {
    const int n = P.D + 1;
    double m = sc[0];
    for (int i = 1; i < n; ++i) m = pmin(m, sc[i]);
    const double thr = __dmul_rn(__dadd_rn(1.0, gamma), m);
    long long n_w = 0;
    for (int i = 0; i < n; ++i) n_w += sc[i] <= thr;
    const long long k = rr % (n_w > 1 ? n_w : 1);
    long long seen = 0;
    for (int i = 0; i < n; ++i)
      if (sc[i] <= thr && seen++ == k) return i;
    return P.D;  // unreachable for scores that are not NaN
  }

  // numpy's (i - rr) % D: floor modulo, never negative (C's % truncates)
  __device__ double rotation(int i, long long rr) const {
    long long r = ((long long)i - rr) % P.D;
    if (r < 0) r += P.D;
    return (double)r;
  }

  // `masked`: tent's mask (excluded rails and row D); round robin reads the
  // rails outside it as live, and ignores it for the first attempt (live_only)
  __device__ int choose(long long rr, unsigned long long masked, bool live_only) const {
    double sc[MAX_RAILS + 1];
    const int n = P.D + 1;
    if (!P.round_robin) {
      double mn = INFINITY;
      for (int i = 0; i < n; ++i) {
        const double qi = s(Q, i);
        const double v = __dmul_rn(
            pen(i), __dadd_rn(s(B0, i), __ddiv_rn(__dmul_rn(s(B1, i), __dadd_rn(qi, P.L)),
                                                 bw_score(i))));
        sc[i] = v;
        mn = pmin(mn, (masked >> i) & 1 ? INFINITY : v);
      }
      if (isfinite(mn))
        for (int i = 0; i < n; ++i)
          if ((masked >> i) & 1) sc[i] = INFINITY;
      return select(sc, rr, P.gamma);
    }
    for (int i = 0; i < n; ++i) sc[i] = i < P.D ? rotation(i, rr) : INFINITY;
    if (live_only) {
      double mn = INFINITY;
      for (int i = 0; i < n; ++i) mn = pmin(mn, (masked >> i) & 1 ? INFINITY : sc[i]);
      if (isfinite(mn))
        for (int i = 0; i < n; ++i)
          if ((masked >> i) & 1) sc[i] = INFINITY;
    }
    return select(sc, 0, 0.0);
  }
};

// _jitter_windows_np: onset scaled and clamped at 0, duration scaled
__device__ void jitter(const Lane& ln, const double* start, const double* end, const double* u,
                       int n_win, int comps, int S, int E, double inv) {
  const int N = ln.P.n;
  for (int i = 0; i < n_win; ++i) {
    const double u0 = u[(size_t)(i * comps) * N + ln.lane];
    const double u1 = u[(size_t)(i * comps + 1) * N + ln.lane];
    const double v = __dmul_rn(start[i], __dadd_rn(1.0, __ddiv_rn(u0, inv)));
    const double st = v > 0.0 ? v : 0.0;  // np.maximum(0.0, v)
    const double scale1 = __dadd_rn(1.0, __ddiv_rn(u1, inv));
    ln.s(S, i) = st;
    ln.s(E, i) = __dadd_rn(st, __ddiv_rn(__dsub_rn(end[i], start[i]), __ddiv_rn(1.0, scale1)));
  }
}

// np.clip(factor * (1 + u2 / inv), 0.01, 1.0)
__device__ void jitter_depth(const Lane& ln, const double* fac, const double* u, int n_win,
                             int F, double inv) {
  const int N = ln.P.n;
  for (int i = 0; i < n_win; ++i) {
    const double u2 = u[(size_t)(i * 3 + 2) * N + ln.lane];
    double v = __dmul_rn(fac[i], __dadd_rn(1.0, __ddiv_rn(u2, inv)));
    v = v < 0.01 ? 0.01 : v;
    v = v > 1.0 ? 1.0 : v;
    ln.s(F, i) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
spray_sim(Params P, const double* __restrict__ prog, const double* __restrict__ uf,
          const double* __restrict__ us, const double* __restrict__ ud,
          const double* __restrict__ jm, double* __restrict__ scr, double* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  const int D = P.D, D1 = P.D + 1, R = P.R, W = P.W, N = P.n;
  const int nf = D * P.Kf, ns = D * P.Ks, nd = D * P.Kd;
  Lane ln{P, prog, scr, lane};
  int b = 0;
  ln.Q = b; b += D1;
  ln.BUSY = b; b += D1;
  ln.B0 = b; b += D1;
  ln.B1 = b; b += D1;
  ln.FS = b; b += nf;
  ln.FE = b; b += nf;
  ln.DSS = b; b += ns;
  ln.DSE = b; b += ns;
  ln.DSF = b; b += ns;
  ln.DDS = b; b += nd;
  ln.DDE = b; b += nd;
  ln.DDF = b; b += nd;
  ln.MA = b; b += nf;
  ln.DS = b; b += W;
  ln.ENDS = b; b += W;
  ln.OK = b; b += W;
  ln.QAT = b; b += W;
  ln.ORD = b;

  const double* win = prog + 9 * D1;
  const double *fail_start = win, *fail_end = win + nf;
  const double *degs_start = win + 2 * nf, *degs_end = degs_start + ns,
               *degs_factor = degs_end + ns;
  const double *degd_start = degs_factor + ns, *degd_end = degd_start + nd,
               *degd_factor = degd_end + nd;
  for (int i = 0; i < D1; ++i) {
    ln.s(ln.Q, i) = 0.0;
    ln.s(ln.BUSY, i) = 0.0;
    ln.s(ln.B0, i) = ln.c(7, i);
    ln.s(ln.B1, i) = ln.c(8, i);
  }
  jitter(ln, fail_start, fail_end, uf, nf, 2, ln.FS, ln.FE, P.inv);
  jitter(ln, degs_start, degs_end, us, ns, 3, ln.DSS, ln.DSE, P.inv);
  jitter_depth(ln, degs_factor, us, ns, ln.DSF, P.inv);
  jitter(ln, degd_start, degd_end, ud, nd, 3, ln.DDS, ln.DDE, P.inv);
  jitter_depth(ln, degd_factor, ud, nd, ln.DDF, P.inv);
  for (int i = 0; i < nf; ++i) ln.s(ln.MA, i) = INFINITY;

  const double L = P.L;
  double now = 0.0;
  long long rr = 0, total_ok = 0;
  for (int r = 0; r < R; ++r) {
    const unsigned long long excl = ln.excluded(now);
    for (int w = 0; w < W; ++w) {
      const double jm1 = jm[(size_t)((r * W + w) * 2) * N + lane];
      const double jm2 = jm[(size_t)((r * W + w) * 2 + 1) * N + lane];
      const int d1 = ln.choose(rr, excl, false);
      ++rr;
      double& q1 = ln.s(ln.Q, d1);
      q1 = __dadd_rn(q1, L);
      const double qat1 = q1;
      const double start1 = pmax(now, ln.s(ln.BUSY, d1));  // max(now, busy[d1])
      const double endb1 = __dadd_rn(start1, __ddiv_rn(__dmul_rn(L, jm1), ln.effbw(d1, start1)));
      const bool f1 = ln.overlaps(d1, start1, endb1);
      if (!f1) ln.s(ln.BUSY, d1) = endb1;
      else q1 = __dsub_rn(q1, L);
      bool ok = true;
      int d_f = d1;
      double endb_f = endb1, qat_f = qat1;
      if (f1) {
        const double t2 = __dadd_rn(start1, P.det);
        const int d2 = ln.choose(rr, ln.excluded(t2), true);
        ++rr;
        double& q2 = ln.s(ln.Q, d2);
        q2 = __dadd_rn(q2, L);
        const double qat2 = q2;
        const double start2 = pmax(t2, ln.s(ln.BUSY, d2));
        const double endb2 =
            __dadd_rn(start2, __ddiv_rn(__dmul_rn(L, jm2), ln.effbw(d2, start2)));
        const bool f2 = ln.overlaps(d2, start2, endb2);
        if (!f2) ln.s(ln.BUSY, d2) = endb2;
        else q2 = __dsub_rn(q2, L);
        ok = !f2;
        d_f = d2;
        endb_f = endb2;
        qat_f = qat2;
      }
      ln.s(ln.DS, w) = (double)d_f;
      ln.s(ln.ENDS, w) = __dadd_rn(endb_f, ln.lat(d_f));
      ln.s(ln.OK, w) = ok ? 1.0 : 0.0;
      ln.s(ln.QAT, w) = qat_f;
      total_ok += ok;
    }
    // stable order of the end times, failed slices (key inf) last
    for (int w = 0; w < W; ++w) {
      const double key = ln.s(ln.OK, w) != 0.0 ? ln.s(ln.ENDS, w) : INFINITY;
      int pos = w;
      while (pos > 0) {
        const int prev = (int)ln.s(ln.ORD, pos - 1);
        const double pk = ln.s(ln.OK, prev) != 0.0 ? ln.s(ln.ENDS, prev) : INFINITY;
        if (!(key < pk)) break;
        ln.s(ln.ORD, pos) = (double)prev;
        --pos;
      }
      ln.s(ln.ORD, pos) = (double)w;
    }
    // completion-ordered EWMA drain (failures -> scratch row D)
    for (int j = 0; j < W; ++j) {
      const int w = (int)ln.s(ln.ORD, j);
      const int d = ln.s(ln.OK, w) != 0.0 ? (int)ln.s(ln.DS, w) : D;
      const double tob = __dsub_rn(ln.s(ln.ENDS, w), now);
      const double a = ln.alpha(d);
      const double x = __ddiv_rn(__dadd_rn(ln.s(ln.QAT, w), L), ln.bw_score(d));
      double& b0 = ln.s(ln.B0, d);
      double& b1 = ln.s(ln.B1, d);
      double sample = __ddiv_rn(__dsub_rn(tob, b0), x > 0.0 ? x : 1.0);
      sample = sample < 0.05 ? 0.05 : sample;
      sample = sample > 1e4 ? 1e4 : sample;
      if (x > 0.0) b1 = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a), b1), __dmul_rn(a, sample));
      double resid = __dsub_rn(tob, __dmul_rn(b1, x));
      resid = resid > 0.0 ? resid : 0.0;  // max(0.0, resid)
      b0 = __dadd_rn(__dmul_rn(__dsub_rn(1.0, ln.b0a(d)), b0), __dmul_rn(ln.b0a(d), resid));
      double& qd = ln.s(ln.Q, d);
      const double v = __dsub_rn(qd, L);
      qd = v > 0.0 ? v : 0.0;
    }
    // healing: each onset's earliest completed end at or after it; next round
    bool any_ok = false;
    double last = -INFINITY;
    for (int w = 0; w < W; ++w) {
      if (ln.s(ln.OK, w) == 0.0) continue;
      const double e = ln.s(ln.ENDS, w);
      any_ok = true;
      last = pmax(last, e);
      for (int i = 0; i < nf; ++i)
        if (e >= ln.s(ln.FS, i)) ln.s(ln.MA, i) = pmin(ln.s(ln.MA, i), e);
    }
    now = any_ok ? last : __dadd_rn(now, P.det);
  }
  const double bytes_ok = __dmul_rn((double)total_ok, L);
  const double makespan = now;
  const double throughput = __ddiv_rn(bytes_ok, pmax(makespan, 1e-12));
  const double lim = pmin(makespan, FAR_WINDOW * 0.5);
  bool any_valid = false;
  double heal = -INFINITY;
  for (int i = 0; i < nf; ++i) {
    const double o = ln.s(ln.FS, i);
    if (o < lim) {
      any_valid = true;
      heal = pmax(heal, __dsub_rn(ln.s(ln.MA, i), o));
    }
  }
  double* o = out + (size_t)lane * 5;
  o[0] = throughput;
  o[1] = any_valid ? heal : -1.0;
  o[2] = bytes_ok;
  o[3] = (double)((long long)R * W - total_ok);
  o[4] = makespan;
}

}  // namespace

extern "C" {

// Doubles of scratch one lane needs.
long long spray_sim_scratch_per_lane(int D, int W, int Kf, int Ks, int Kd) {
  return 4LL * (D + 1) + 3LL * D * Kf + 3LL * D * Ks + 3LL * D * Kd + (long long)D * Kf + 5LL * W;
}

int spray_sim_launch(const double* prog, const double* uf, const double* us, const double* ud,
                     const double* jm, double* scratch, double* out, int n_lanes, int D, int R,
                     int W, int Kf, int Ks, int Kd, int round_robin, double L, double det,
                     double gamma, double inv, void* stream) {
  if (n_lanes <= 0 || D < 1 || D > MAX_RAILS - 1 || R < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  Params P{n_lanes, D, R, W, Kf, Ks, Kd, round_robin, L, det, gamma, inv};
  const int blocks = (n_lanes + THREADS - 1) / THREADS;
  spray_sim<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(P, prog, uf, us, ud, jm, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
