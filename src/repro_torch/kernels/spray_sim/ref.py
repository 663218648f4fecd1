"""The plain torch version of the fused spray sim: `simulate_spray_ref`
batched over seed lanes (the reference's `vmap` form), float64.

Its loops over rounds and slices mirror `repro_torch.core.jit_core.
simulate_spray_ref` operation for operation, one tensor op per numpy op in
the same order (no fused ops), each lane in a row, so every lane is
bit-equal to the numpy twin on the same draws. Two shapes of the
computation differ and neither changes a value:
- the retry of a slice is computed only when some lane's first attempt
  failed; for the other lanes its updates add 0.0 or rewrite a value with
  itself, as the reference's masked form does;
- the drain applies each rail's completions in their completion order, as
  the reference does, but all rails' k-th completions at once (occurrence
  rounds, as `TelemetryStore.on_complete_many` does): the rails' updates
  touch disjoint state;
- the healing minima are kept as running minima over each round's ends
  instead of one minimum over all ends at the end (a minimum is exact in
  any order).
Only the CPU wrapper and the checks use it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

FAR_WINDOW = 1e30  # core.fabric.FAR_WINDOW: a window that never opens
_F64 = torch.float64


def _inv_fj(fj: float) -> float:
    return math.inf if fj == 0 else 1.0 / float(fj)


def _pos(v):
    """Python's max(0.0, v): v only if it is greater than 0.0."""
    return torch.where(v > 0.0, v, 0.0)


def spray_sim_ref(p, draws: Dict[str, np.ndarray], *, policy: str = "tent",
                  fault_jitter: float = 0.0, device="cpu") -> torch.Tensor:
    """Run `p` (a `SprayProgram`) for every lane of `draws` (`make_draws`
    arrays stacked on a leading lane axis). Returns an (n_lanes, 5) float64
    tensor of `(throughput, healing_s, bytes_ok, lost, makespan)`."""
    if policy not in ("tent", "round_robin"):
        raise ValueError(f"unsupported sweep policy {policy!r}")
    dev = torch.device(device)
    D, R, W = p.n_rails, p.rounds, p.wave
    L = float(p.length)
    det = float(p.detect)
    gamma = float(p.gamma)
    inv = _inv_fj(float(fault_jitter))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    uf, us, ud, jm = (t(draws[k]) for k in ("uf", "us", "ud", "jm"))
    N = uf.shape[0]

    def jitter(start, end, u):
        start, end = t(start), t(end)
        s = torch.maximum(torch.zeros((), dtype=_F64, device=dev),
                          start * (1.0 + u[..., 0] / inv))
        scale1 = 1.0 + u[..., 1] / inv
        return s, s + (end - start) / (1.0 / scale1)

    fs, fe = jitter(p.fail_start, p.fail_end, uf)  # (N, D, Kf)
    dss, dse = jitter(p.degs_start, p.degs_end, us)
    dsf = torch.clamp(t(p.degs_factor) * (1.0 + us[..., 2] / inv), 0.01, 1.0)
    dds, dde = jitter(p.degd_start, p.degd_end, ud)
    ddf = torch.clamp(t(p.degd_factor) * (1.0 + ud[..., 2] / inv), 0.01, 1.0)

    def ext(a, fill):
        return torch.cat([t(a), torch.full((1,), fill, dtype=_F64, device=dev)])

    bw_score = ext(p.bw_score, 1.0)
    bw_src = ext(p.bw_src, 1.0)
    bw_dst = ext(p.bw_dst, 1.0)
    pen = ext(p.penalty, math.inf)
    lat = ext(p.latency, 0.0)
    alpha = ext(p.ewma_alpha, 0.0)
    b0a = ext(p.beta0_alpha, 0.0)
    b0 = ext(p.beta0, 0.0).expand(N, D + 1).clone()
    b1 = ext(p.beta1, 1.0).expand(N, D + 1).clone()
    q = torch.zeros(N, D + 1, dtype=_F64, device=dev)
    busy = torch.zeros(N, D + 1, dtype=_F64, device=dev)
    rr = torch.zeros(N, dtype=torch.int64, device=dev)
    now = torch.zeros(N, dtype=_F64, device=dev)
    arange = torch.arange(D + 1, device=dev)
    real = arange < D

    def row(a, fill):  # a (N, D, K) and one more rail row of `fill`
        return torch.cat([a, torch.full_like(a[:, :1], fill)], dim=1)

    # the scratch row D: always masked for tent's choice (excluded at every
    # t), never overlapping a fault, never degraded
    fsd, fed = row(fs + det, -math.inf), row(fe + det, math.inf)
    fs_e, fe_e = row(fs, math.inf), row(fe, -math.inf)
    dss_e, dse_e, dsf_e = row(dss, math.inf), row(dse, math.inf), row(dsf, 1.0)
    dds_e, dde_e, ddf_e = row(dds, math.inf), row(dde, math.inf), row(ddf, 1.0)
    Ljm = L * jm  # (L * jm): the numerator of every service time

    def excluded_at(tt):  # (N, D + 1), the scratch row True
        tt = tt[:, None, None]
        return ((fsd <= tt) & (tt < fed)).any(2)

    def overlaps(d, s, e):
        ov = ((fs_e < e[:, None, None]) & (fe_e > s[:, None, None])).any(2)
        return ov.gather(1, d[:, None])[:, 0]

    def degfac(start, end, fac, tt):  # all rails; factors multiplied in k order
        tt = tt[:, None, None]
        f = torch.where((start <= tt) & (tt < end), fac, 1.0)
        out = f[..., 0]
        for k in range(1, f.shape[2]):
            out = out * f[..., k]
        return out

    def effbw(d, tt):
        both = torch.minimum(bw_src * degfac(dss_e, dse_e, dsf_e, tt),
                             bw_dst * degfac(dds_e, dde_e, ddf_e, tt))
        return both.gather(1, d[:, None])[:, 0]

    def select(scores, rr_, g):
        s_min = scores.amin(1)
        in_w = scores <= ((1.0 + g) * s_min)[:, None]
        cum = in_w.cumsum(1)
        k1 = rr_ % cum[:, -1].clamp(min=1) + 1
        # the k-th window member: the first index whose running count is k+1
        return (cum < k1[:, None]).sum(1)

    zero_rr = torch.zeros_like(rr)

    def choose(q_, rr_, masked):
        """`masked` is the tent mask (excluded rails and the scratch row);
        round robin reads its complement as the live rails."""
        if policy == "tent":
            s = pen * (b0 + b1 * (q_ + L) / bw_score)
            sx = s.masked_fill(masked, math.inf)
            se = torch.where(torch.isfinite(sx.amin(1))[:, None], sx, s)
            return select(se, rr_, gamma)
        rot = torch.where(real, ((arange - rr_[:, None]) % D).to(_F64), math.inf)
        if masked is not None:
            rx = torch.where(~masked, rot, math.inf)
            rot = torch.where(torch.isfinite(rx.amin(1))[:, None], rx, rot)
        return select(rot, zero_rr, 0.0)

    onsets = fs.reshape(N, -1)
    min_after = torch.full_like(onsets, math.inf)
    total_ok = torch.zeros(N, dtype=torch.int64, device=dev)
    L_col = torch.full((N, 1), L, dtype=_F64, device=dev)
    L64, zero = torch.tensor(L, dtype=_F64, device=dev), torch.zeros((), dtype=_F64, device=dev)
    posW = torch.arange(W, device=dev)[None, :, None]
    for r in range(R):
        excl = excluded_at(now)
        ds, ends, oks, qats = [], [], [], []
        for w in range(W):
            d1 = choose(q, rr, excl if policy == "tent" else None)
            rr = rr + 1
            i1 = d1[:, None]
            q = q.scatter_add(1, i1, L_col)
            qat1 = q.gather(1, i1)[:, 0]
            busy1 = busy.gather(1, i1)[:, 0]
            start1 = torch.maximum(now, busy1)
            endb1 = start1 + Ljm[:, r, w, 0] / effbw(d1, start1)
            f1 = overlaps(d1, start1, endb1)
            busy = busy.scatter(1, i1, torch.where(f1, busy1, endb1)[:, None])
            q = q.scatter_add(1, i1, torch.where(f1, -L64, zero)[:, None])
            if bool(f1.any()):
                t2 = start1 + det
                d2 = choose(q, rr, excluded_at(t2))
                rr = rr + f1.to(torch.int64)
                i2 = d2[:, None]
                q = q.scatter_add(1, i2, torch.where(f1, L64, zero)[:, None])
                qat2 = q.gather(1, i2)[:, 0]
                busy2 = busy.gather(1, i2)[:, 0]
                start2 = torch.maximum(t2, busy2)
                endb2 = start2 + Ljm[:, r, w, 1] / effbw(d2, start2)
                f2 = overlaps(d2, start2, endb2)
                busy = busy.scatter(1, i2, torch.where(f1 & ~f2, endb2, busy2)[:, None])
                q = q.scatter_add(1, i2, torch.where(f1 & f2, -L64, zero)[:, None])
                ok = ~(f1 & f2)
                d_f = torch.where(f1, d2, d1)
                endb_f = torch.where(f1, endb2, endb1)
                qat_f = torch.where(f1, qat2, qat1)
            else:
                ok, d_f, endb_f, qat_f = ~f1, d1, endb1, qat1
            ds.append(d_f)
            ends.append(endb_f + lat[d_f])
            oks.append(ok)
            qats.append(qat_f)
        ds, ends, oks, qats = (torch.stack(v, 1) for v in (ds, ends, oks, qats))
        # completion-ordered EWMA drain (failures -> scratch row D), a
        # rail's completions in its own order: occurrence round k updates
        # every rail's k-th completion at once
        key = torch.where(oks, ends, math.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        d_o = torch.where(oks, ds, D).gather(1, order)  # (N, W) rail per position
        hit = d_o[:, :, None] == arange  # (N, W, D + 1)
        occ = (hit.cumsum(1) - 1).gather(2, d_o[:, :, None])[:, :, 0]
        tob_o = ends.gather(1, order) - now[:, None]
        qat_o = qats.gather(1, order)
        for k in range(int(occ.max()) + 1):
            sel = hit & (occ == k)[:, :, None]
            have = sel.any(1)  # (N, D + 1): the rails with a k-th completion
            pos = (sel * posW).sum(1)
            tob = tob_o.gather(1, pos)
            x = (qat_o.gather(1, pos) + L) / bw_score
            sample = torch.clamp((tob - b0) / torch.where(x > 0, x, 1.0), 0.05, 1e4)
            b1n = torch.where(x > 0, (1 - alpha) * b1 + alpha * sample, b1)
            resid = _pos(tob - b1n * x)
            b0n = (1 - b0a) * b0 + b0a * resid
            b1 = torch.where(have, b1n, b1)
            b0 = torch.where(have, b0n, b0)
            q = torch.where(have, _pos(q - L), q)
        done = torch.where(oks, ends, math.inf)[:, :, None]
        after = torch.where(done >= onsets[:, None, :], done, math.inf).amin(1)
        min_after = torch.minimum(min_after, after)
        total_ok = total_ok + oks.sum(1)
        any_ok = oks.any(1)
        last = torch.where(oks, ends, -math.inf).amax(1)
        now = torch.where(any_ok, last, now + det)
    bytes_ok = total_ok.to(_F64) * L
    makespan = now
    throughput = bytes_ok / torch.where(1e-12 > makespan, 1e-12, makespan)
    half = FAR_WINDOW * 0.5
    valid = onsets < torch.where(half < makespan, half, makespan)[:, None]
    heal = torch.where(valid, min_after - onsets, -math.inf)
    healing = torch.where(valid.any(1), heal.amax(1), -1.0)
    lost = (R * W - total_ok).to(_F64)
    return torch.stack([throughput, healing, bytes_ok, lost, makespan], 1)
