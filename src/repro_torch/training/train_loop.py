"""Single-host training loop used by examples and smoke-scale runs.

Counterpart of `repro.training.train_loop`. A step is one forward and
backward pass over the plain path (autograd; `use_pallas` is refused, as
the reference cannot differentiate through its Pallas kernels either)
and an in-place AdamW update. The params are the functional tree of
`models.init_params`, with `requires_grad` set on its leaves. No
`torch.compile`.

The enc-dec family's encoder frames for step `i` come from a
`torch.Generator` seeded with `i`, where the reference draws them from
`jax.random.normal(PRNGKey(i))`: the same distribution, not the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, default_device
from ..models import init_params, loss_fn
from .data import DataConfig, SyntheticTokens
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .tree import tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig) -> Callable:
    """`train_step(params, opt_state, batch) -> (params, opt_state, metrics)`:
    params and moments updated in place (the params require grad only
    inside the step), metrics {"loss", "ce", "lb_loss",
    "z_loss", "grad_norm", "lr"} as 0-d tensors (loss and aux detached)."""
    if cfg.use_pallas:
        raise ValueError(f"{cfg.name}: training takes the plain path (use_pallas=False); "
                         "the hand-written kernels have no backward pass")

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss, aux = loss_fn(cfg, params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:  # the caller's tree comes back as it went in: serving may use it
            for p in leaves:
                p.requires_grad_(False)
        grad_iter = iter(grads)
        grad_tree = tree_map(lambda _: next(grad_iter), params)
        params, opt_state, opt_aux = adamw_update(opt_cfg, params, grad_tree, opt_state)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}, **opt_aux}
        return params, opt_state, metrics

    return train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps: int
    tokens_per_sec: float


def train(
    cfg: ModelConfig,
    *,
    steps: int = 50,
    batch_size: int = 4,
    seq_len: int = 128,
    seed: int = 0,
    opt_cfg: Optional[AdamWConfig] = None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
) -> TrainResult:
    """Train from `init_params` (bf16, seeded by `seed`) on
    `SyntheticTokens(seed=seed)` for `steps` steps on `device` (CUDA unless
    the caller asks for the CPU; raises without a card)."""
    dev = default_device(device)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=max(steps // 10, 1), total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt_state = init_opt_state(params)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq_len, batch_size, seed=seed))
    losses = []
    t0 = time.perf_counter()
    it = iter(data)
    for step in range(steps):
        batch: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        if cfg.is_encdec:
            gen = torch.Generator(device=dev).manual_seed(step)
            batch["enc_frames"] = torch.randn((batch_size, seq_len // 4, cfg.d_model),
                                              generator=gen, device=dev).to(torch.bfloat16)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0:
            log(f"step {step:4d}  loss {loss:.4f}  gnorm {float(metrics['grad_norm']):.3f}")
    dt = time.perf_counter() - t0
    return TrainResult(losses=losses, steps=steps, tokens_per_sec=steps * batch_size * seq_len / dt)
