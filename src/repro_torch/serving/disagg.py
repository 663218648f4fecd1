"""Real-compute prefill/decode disaggregation over TENT.

Counterpart of `repro.serving.disagg`. A prefill worker runs the model on
the prompt and produces a decode cache; the cache bytes are shipped to the
decode worker's node through one declarative TENT batch (the
PD-disaggregation elephant flow); the decode worker then generates tokens.
The engine is the host-side simulator, so the cache crosses to host memory
as raw bytes and back onto the model's device after the transfer.

Byte streams match the reference's: leaves in `jax.tree_util` order (dict
keys sorted), metas carrying numpy dtype names ("float32", "bfloat16").
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import Location, MemoryKind, TentEngine
from ..models import decode_step, prefill
from ..obs import spans as _spans


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return leaves.pop(0)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def tree_to_bytes(tree: Any) -> Tuple[np.ndarray, List[Tuple[tuple, str]]]:
    """Flatten a (nested dict) tree of tensors into one uint8 host array
    plus (shape, dtype name) metas. Leaves are joined on their own device
    and cross to the host in one copy."""
    with _spans.span("serving.pack"):
        leaves = _leaves(tree)
        metas = [(tuple(t.shape), _dtype_name(t.dtype)) for t in leaves]
        if not leaves:
            return np.zeros(0, np.uint8), metas
        blobs = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves]
        return torch.cat(blobs).cpu().numpy(), metas


def bytes_to_tree(data: np.ndarray, like: Any) -> Any:
    """Inverse of `tree_to_bytes`: shapes, dtypes and devices from `like`.
    Each leaf's bytes are copied on the host before they cross to its
    device; with spans on, those copies are `copy_ns` / `copy_bytes`."""
    rec = _spans.active
    with _spans.span("serving.unpack"):
        out = []
        off = 0
        for t in _leaves(like):
            nbytes = t.element_size() * t.numel()
            t0 = rec.begin() if rec is not None else 0
            leaf = np.array(data[off:off + nbytes], dtype=np.uint8)
            if rec is not None:
                rec.end(t0, "copy_ns", "copy_bytes", nbytes)
            out.append(torch.from_numpy(leaf).to(t.device).view(t.dtype).reshape(t.shape))
            off += nbytes
        return _unflatten(like, out)


def greedy_decode(cfg: ModelConfig, params: Any, cache: Any,
                  last_logits: torch.Tensor, start: int, n_new: int) -> np.ndarray:
    """Greedy tokens (B, n_new) int32: the argmax of `last_logits`, then
    n_new - 1 decode steps from position `start`. Updates `cache` in place."""
    tok = torch.argmax(last_logits, dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok, start + i)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()


@dataclasses.dataclass
class DisaggResult:
    tokens: np.ndarray  # (B, n_new)
    kv_transfer_seconds: float
    kv_bytes: int


class DisaggregatedServer:
    """Prefill on one node's GPUs, decode on another's, KV over TENT."""

    def __init__(self, engine: TentEngine, cfg: ModelConfig, params: Any,
                 *, prefill_node: int = 0, decode_node: int = 1):
        self.engine = engine
        self.cfg = cfg
        self.params = params
        self.prefill_node = prefill_node
        self.decode_node = decode_node
        spec = engine.topology.spec
        self._loc_p = Location(node=prefill_node, kind=MemoryKind.DEVICE_HBM, device=0,
                               numa=spec.node.gpu_numa(0))
        self._loc_d = Location(node=decode_node, kind=MemoryKind.DEVICE_HBM, device=0,
                               numa=spec.node.gpu_numa(0))

    def _stage_in(self, data: np.ndarray) -> Tuple[Any, Any]:
        """Register the handoff's source and destination segments and copy
        the cache's bytes into the source: (src, dst)."""
        nbytes = max(data.size, 1)
        eng = self.engine
        with _spans.span("serving.register") as sp:
            src = eng.register_segment(self._loc_p, nbytes, name="kv-src")
            dst = eng.register_segment(self._loc_d, nbytes, name="kv-dst")
        if sp is not None:
            sp.counters["segments_live"], sp.counters["segment_bytes_live"] = eng.segments.live()
        with _spans.span("serving.stage_in"):
            src.write(0, data)
        return src, dst

    def ship_kv_async(self, data: np.ndarray, on_done=None) -> Tuple[Any, int]:
        """Declarative KV-handoff intent: post the prefill->decode elephant
        flow as one async TENT batch and return (dst_segment, batch_id)
        immediately; the decode side is woken by the completion callback."""
        src, dst = self._stage_in(data)
        batch = self.engine.allocate_batch()
        self.engine.submit_transfer(
            batch, [(src.segment_id, 0, dst.segment_id, 0, src.length)])
        if on_done is not None:
            self.engine.on_batch_done(batch, on_done)
        return dst, batch

    def generate(self, prompt: torch.Tensor, n_new: int, max_len: int,
                 enc_frames: Optional[torch.Tensor] = None,
                 *, async_handoff: bool = False) -> DisaggResult:
        """enc_frames (B, S_enc, D): the encoder's input, enc-dec only; its
        cross-attention K/V ride in the shipped cache."""
        with _spans.request():
            return self._generate(prompt, n_new, max_len, enc_frames, async_handoff)

    def _generate(self, prompt, n_new, max_len, enc_frames, async_handoff) -> DisaggResult:
        B, S = prompt.shape
        # ---- prefill pool ----
        last_logits, cache = prefill(self.cfg, self.params, prompt, max_len,
                                     enc_frames=enc_frames)
        # ---- ship the cache through TENT ----
        data, _ = tree_to_bytes(cache)
        t0 = self.engine.fabric.now
        if async_handoff:
            # intent mode: the batch is posted and the decode worker starts
            # when the completion callback lands (here: drain the fabric --
            # the decode numerics need the full cache)
            done = {}
            dst, _ = self.ship_kv_async(
                data, lambda res: done.setdefault("res", res))
            self.engine.run_until_idle()
            res = done["res"]
        else:
            src, dst = self._stage_in(data)
            res = self.engine.transfer_sync(src.segment_id, 0, dst.segment_id, 0, src.length)
        if not res.ok:
            raise RuntimeError(f"KV handoff failed: {res.error}")
        secs = self.engine.fabric.now - t0
        cache = bytes_to_tree(dst.read(0, data.size), cache)
        rec = _spans.active
        if rec is not None:
            # the decode worker holds the cache; prefill's logits give token one
            rec.mark("serving.first_token")
        # ---- decode pool ----
        tokens = greedy_decode(self.cfg, self.params, cache, last_logits, S, n_new)
        return DisaggResult(tokens=tokens, kv_transfer_seconds=secs, kv_bytes=int(data.size))


def monolithic_generate(cfg: ModelConfig, params: Any, prompt: torch.Tensor, n_new: int,
                        max_len: int, enc_frames: Optional[torch.Tensor] = None) -> np.ndarray:
    B, S = prompt.shape
    last_logits, cache = prefill(cfg, params, prompt, max_len, enc_frames=enc_frames)
    return greedy_decode(cfg, params, cache, last_logits, S, n_new)
