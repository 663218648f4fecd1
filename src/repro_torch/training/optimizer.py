"""AdamW over the port's parameter tree: moments in fp32, params in the
model dtype (bf16 for production configs), decoupled weight decay, global
grad-norm clipping. Counterpart of `repro.training.optimizer`.

The update is computed in fp32 and cast back to each param's dtype, as the
reference's is. Unlike the reference's functional update, `adamw_update`
writes the params and the moments in place (under `torch.no_grad()`): a
functional copy of qwen2-0.5b's 494M parameters and their moments would
cost gigabytes on the card. It still returns the reference's triple.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(params: Any) -> Dict[str, Any]:
    """fp32 zero moments beside each param, and a 0-d int32 step."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


def lr_schedule(cfg: AdamWConfig, step: Any) -> torch.Tensor:
    """Linear warmup to `cfg.lr`, then cosine decay to `min_lr_ratio` of it
    at `total_steps`; fp32, on the step's device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares, each leaf widened to fp32 and summed in
    the reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: Dict[str, Any]
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on `params` and on `state`'s moments.
    Returns (params, state, {"grad_norm": the pre-clip global norm, "lr"}),
    `state["step"]` a new 0-d int32 tensor."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                 tree_leaves(state["v"]), strict=True)
    for p, g, m, v in leaves:
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm, "lr": lr}
