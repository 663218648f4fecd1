"""The comparison that decides `correct`.

What the timed path produced, for a sample of the requests the window
finished, is held against the plain float32 reference of the model family
(`reference/<family>.py`), run once the window has closed over each
sampled prompt followed by the tokens served for it:

  token_gap          the widest gap by which a served token's logit lies
                     below the reference's best logit at that position
                     (prefill's logits choose the first token, the decode
                     steps through the shipped cache the others);
  prefill_cache_err  the cache as it arrived on the decode worker against
                     the reference's cache after the prompt: |got - want|
                     / |want| in the Frobenius norm, by the worst layer and
                     leaf;
  decode_cache_err   the same for the cache entries the decode steps wrote;
  shipped_differ     elements of the shipped cache that differ, bit for
                     bit, from the cache prefill produced (limit 0).

The reference runs in blocks of rows that share a prompt length, so that
it fits beside nothing else on the card.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

from .reference.common import Precision, rel_err

NAMES = ("token_gap", "prefill_cache_err", "decode_cache_err", "shipped_differ")
# tokens, and logits elements, of one block of reference rows
TOKEN_BUDGET = 16384
LOGIT_BUDGET = 250_000_000


def blocks(rows: List[Tuple[torch.Tensor, torch.Tensor]], vocab: int) -> Iterator[Tuple[int, List[int]]]:
    """Rows (prompt (S,), continuation (n - 1,)) grouped by shape into
    blocks that fit: (S, row indices)."""
    groups = defaultdict(list)
    for i, (p, c) in enumerate(rows):
        groups[(p.numel(), c.numel())].append(i)
    for (S, n), idx in sorted(groups.items()):
        per = max(1, min(TOKEN_BUDGET // (S + n), LOGIT_BUDGET // ((n + 1) * vocab)))
        for j0 in range(0, len(idx), per):
            yield S, idx[j0:j0 + per]


def reference(family, conf: dict, params: dict, rows, S: int, idx: List[int], prec: Precision):
    """The reference over one block: (logits (b, n, V) at positions S - 1 ..
    S + n - 2, prefill cache, decode-written cache), each cache leaf (L, b,
    ...)."""
    tokens = torch.stack([torch.cat([rows[i][0], rows[i][1]]) for i in idx])
    with torch.no_grad():
        return family.forward(conf, params, tokens.long(), S, prec)


def _row(cache: Dict[str, torch.Tensor], j: int) -> Dict[str, torch.Tensor]:
    return {k: v[:, j] for k, v in cache.items()}


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long().view(-1, 1).to(ref_logits.device))[:, 0]
    return float((best - got).max())


def cache_err(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The worst layer and leaf; a leaf's layer axis is its first."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            return math.inf
        for layer in range(w.shape[0]):
            e = rel_err(g[layer].float(), w[layer])
            worst = max(worst, e if math.isfinite(e) else math.inf)
    return worst


def bits_differ(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> int:
    n = 0
    for name, t in a.items():
        u = b.get(name)
        if u is None or u.shape != t.shape or u.dtype != t.dtype:
            n += t.numel()
            continue
        as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        n += int((t.contiguous().view(as_int) != u.contiguous().view(as_int)).sum())
    return n


class Row:
    """One sampled request's row: its prompt, the tokens served for it, and
    (for the rows whose caches were kept) the program's caches: `prefill`
    as prefill produced it, `shipped` as it arrived on the decode worker,
    `decoded` the decode-written entries, each leaf with its layer axis
    first."""

    def __init__(self, prompt, served, prefill=None, shipped=None, decoded=None):
        self.prompt, self.served = prompt, served
        self.prefill, self.shipped, self.decoded = prefill, shipped, decoded


def compare(family, conf: dict, params: dict, rows: List[Row]) -> Dict[str, float]:
    """The numbers for the program's rows against the float32 reference."""
    out = dict.fromkeys(NAMES, 0.0)
    out["shipped_differ"] = 0
    served = [torch.as_tensor(r.served).reshape(-1) for r in rows]
    inputs = [(r.prompt, served[i][:-1].to(r.prompt.device)) for i, r in enumerate(rows)]
    for S, idx in blocks(inputs, params["embed"].shape[0]):
        logits, shipped, decoded = reference(family, conf, params, inputs, S, idx, Precision())
        for j, i in enumerate(idx):
            r = rows[i]
            out["token_gap"] = max(out["token_gap"], token_gap(logits[j], served[i]))
            if r.shipped is not None:
                out["prefill_cache_err"] = max(out["prefill_cache_err"],
                                               cache_err(r.shipped, _row(shipped, j)))
                out["decode_cache_err"] = max(out["decode_cache_err"],
                                              cache_err(r.decoded, _row(decoded, j)))
                out["shipped_differ"] += bits_differ(r.prefill, r.shipped)
        del logits, shipped, decoded
    return out


def control(family, conf: dict, params: dict, rows: List[Tuple[torch.Tensor, torch.Tensor]],
            cache_rows: int, low: Precision) -> Dict[str, float]:
    """The same numbers for the reference computed in `low` precision put in
    the program's place, over prompts with a continuation (teacher forced):
    at each position the token that the low precision puts first, and the
    low-precision caches of the first `cache_rows` rows."""
    out = dict.fromkeys(NAMES[:3], 0.0)
    for S, idx in blocks(rows, params["embed"].shape[0]):
        want = reference(family, conf, params, rows, S, idx, Precision())
        got = reference(family, conf, params, rows, S, idx, low)
        for j, i in enumerate(idx):
            out["token_gap"] = max(out["token_gap"], token_gap(want[0][j], got[0][j].argmax(-1)))
            if i < cache_rows:
                out["prefill_cache_err"] = max(out["prefill_cache_err"],
                                               cache_err(_row(got[1], j), _row(want[1], j)))
                out["decode_cache_err"] = max(out["decode_cache_err"],
                                              cache_err(_row(got[2], j), _row(want[2], j)))
        del want, got
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
