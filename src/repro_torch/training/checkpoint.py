"""Checkpointing: parameter tree <-> flat tensor table <-> disk / TENT segments.

Counterpart of `repro.training.checkpoint`. `flatten_state` produces the
named-tensor table that both the disk format and the TENT checkpoint
engine operate on -- a checkpoint *is* a set of segments, which is how the
paper's RL weight-update pipeline views it (Moonshot Checkpoint Engine
§5.1.2). Keys are the reference's ("params/layers/wq", "opt/m/embed",
"opt/step"), and so is the npz format: a bf16 leaf is stored as uint16
with a "<key>::dtype" = "bfloat16" side entry, so a file written by either
package loads in the other.

numpy has no bf16 without `ml_dtypes`, so the port's table gives each bf16
leaf as its uint16 bit view (the same bytes), and `unflatten_like`
reinterprets a 16-bit array under a bf16 template by its bits, where the
reference casts with `astype`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .tree import named_leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flatten_state(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """The tree's leaves as host numpy arrays under their keys, bf16 ones as
    their uint16 bit view."""
    return {key: _to_numpy(leaf) for key, leaf in named_leaves(tree, prefix)}


def _from_numpy(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: {arr.shape} != {tuple(like.shape)}")
    arr = np.array(arr, order="C")  # a copy the tensor owns, 0-d kept 0-d
    bits = like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "uV"
    if bits or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def unflatten_like(tree: Any, table: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """A tree shaped as `tree` whose leaves come from `table`, each on its
    template's device in its template's dtype. A uint16 array under a bf16
    template holds that leaf's bits and is reinterpreted, never cast."""
    if isinstance(tree, dict):
        return {k: unflatten_like(sub, table, f"{prefix}{k}/" if isinstance(sub, dict)
                                  else f"{prefix}{k}") for k, sub in tree.items()}
    return _from_numpy(table[prefix], tree, prefix)


def save_checkpoint(path: str, params: Any, opt_state: Any | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = dict(named_leaves(params, "params/"))
    if opt_state is not None:
        leaves.update(named_leaves(opt_state, "opt/"))
    packed = {}
    for key, leaf in leaves.items():
        packed[key] = _to_numpy(leaf)
        if leaf.dtype == torch.bfloat16:
            packed[key + "::dtype"] = np.asarray("bfloat16")
    np.savez(path, **packed)


def load_checkpoint(path: str, params_like: Any, opt_like: Any | None = None):
    """Leaves on the templates' devices; returns params, or (params, opt)
    when `opt_like` is given."""
    with np.load(path, allow_pickle=False) as raw:
        table = {k: raw[k] for k in raw.files if not k.endswith("::dtype")}
    params = unflatten_like(params_like, table, "params/")
    if opt_like is not None:
        return params, unflatten_like(opt_like, table, "opt/")
    return params
