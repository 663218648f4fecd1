"""Real-compute prefill/decode disaggregation over TENT.

Counterpart of `repro.serving.disagg`. A prefill worker runs the model on
the prompt and produces a decode cache; the cache bytes are shipped to the
decode worker's node through one declarative TENT batch (the
PD-disaggregation elephant flow); the decode worker then generates tokens.
The engine is the host-side simulator, so the cache crosses to host memory
as raw bytes and back onto the model's device after the transfer.

On a card the bytes land by DMA in page-locked host memory from PyTorch's
caching host allocator, which the handoff's source segment maps in place
(paper §3.1: a segment maps the application's own buffers); the
destination segment is the same kind of memory. Both segments are
deregistered when the batch lands and let go of their bytes (the engine
keeps its records of finished batches); the caller reads the destination
through a view of its own, whose read hands out the pinned bytes in place,
so they cross to the card by one DMA with no host copy. A block returns to
the allocator once the last view of it is gone, so a server reuses already
pinned, already touched pages from request to request.

Byte streams match the reference's: leaves in `jax.tree_util` order (dict
keys sorted), metas carrying numpy dtype names ("float32", "bfloat16").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..core import BatchResult, Location, MemoryKind, TentEngine
from ..core.segments import adoptable
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


def _pinned(n: int) -> torch.Tensor:
    """`n` bytes of page-locked host memory; a block goes back to PyTorch's
    caching host allocator, for the next request, once every view of it
    (a segment's numpy array among them) is gone."""
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


# leaves unpacked at byte offsets that are a multiple of this are views of
# the one transferred buffer; any other offset is a copy on the leaf's
# device, so every leaf starts where a vectorised kernel may load it
_VIEW_ALIGN = 16


def tree_to_bytes(tree: Any) -> Tuple[np.ndarray, List[Tuple[tuple, str]]]:
    """Flatten a (nested dict) tree of tensors into one uint8 host array
    plus (shape, dtype name) metas. Leaves are joined on their own device
    and cross to the host in one copy: from a card, one DMA into pinned
    memory (with spans on, `pinned_bytes`), whose array the caller holds."""
    with _spans.span("serving.pack") as sp:
        leaves = _leaves(tree)
        metas = [(tuple(t.shape), _dtype_name(t.dtype)) for t in leaves]
        if not leaves:
            return np.zeros(0, np.uint8), metas
        blobs = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves]
        flat = torch.cat(blobs)
        if flat.device.type != "cuda":
            return flat.cpu().numpy(), metas
        host = _pinned(flat.numel())
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        if sp is not None:
            sp.counters["pinned_bytes"] = host.numel()
        return host.numpy(), metas


def bytes_to_tree(data: np.ndarray, like: Any) -> Any:
    """Inverse of `tree_to_bytes`: shapes, dtypes and devices from `like`.
    `data` crosses once to each device among the leaves (on a card one
    blocking transfer, a DMA where `data` is pinned, as a landed view's
    `read` is; on the CPU none), and each leaf is a view of its byte range
    there, or a copy on that device where the range starts off
    `_VIEW_ALIGN`. So leaves on the CPU alias `data`."""
    with _spans.span("serving.unpack"):
        raw = torch.from_numpy(data)
        flat = {}
        out = []
        off = 0
        for t in _leaves(like):
            nbytes = t.element_size() * t.numel()
            if t.device not in flat:
                flat[t.device] = raw.to(t.device)
            piece = flat[t.device][off:off + nbytes]
            if off % _VIEW_ALIGN:
                piece = piece.clone()
            out.append(piece.view(t.dtype).reshape(t.shape))
            off += nbytes
        return _unflatten(like, out)


def greedy_decode(cfg: ModelConfig, params: Any, cache: Any,
                  last_logits: torch.Tensor, start: int, n_new: int) -> np.ndarray:
    """Greedy tokens (B, n_new) int32: the argmax of `last_logits`, then
    n_new - 1 decode steps from position `start`. Updates `cache` in place.

    The position lives on the device, a 0-d int64 tensor that each step
    reads there. Where the call has two steps or more and every cache leaf
    and `last_logits` is a plain (not DTensor) CUDA tensor on one card, the
    first step runs eagerly and one CUDA graph of a step, captured over the
    call's own cache, replays every later one (`_replayed`); otherwise each
    step runs eagerly. The tokens reach the host once, at the end. With
    spans on, a `serving.decode` span counts `graph_steps` and
    `eager_steps`."""
    tensors = _leaves(cache) + [last_logits]
    one_card = (last_logits.is_cuda and not any(isinstance(t, DTensor) for t in tensors)
                and len({t.device for t in tensors}) == 1)
    steps = max(n_new - 1, 0)
    with _spans.span("serving.decode") as sp:
        tok = _next_token(last_logits)
        pos = torch.full((), start, dtype=torch.int64, device=tok.device)
        if one_card and steps >= 2:
            out, replays = _replayed(cfg, params, cache, tok, pos, n_new), steps - 1
        else:
            out, replays = _eager(cfg, params, cache, tok, pos, steps), 0
        if sp is not None:
            sp.counters["graph_steps"] = replays
            sp.counters["eager_steps"] = steps - replays
        return out.cpu().numpy()


def _next_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def _eager(cfg, params, cache, tok, pos, steps: int) -> torch.Tensor:
    """`steps` decode steps, each dispatched op by op: the tokens (B, 1 +
    steps), `tok` first."""
    out = [tok]
    for _ in range(steps):
        logits, cache = decode_step(cfg, params, cache, tok, pos)
        tok = _next_token(logits)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1)


class _CardGraphs:
    """What a card's decode calls capture with. The side stream they capture
    and replay on: capture needs one other than the default stream, and
    cuBLAS keeps a workspace for each stream it runs on. The one memory pool
    every call's graph is captured into, so a call reuses the blocks of the
    call before (whose graph never replays again). And the last graph,
    held until the next capture has ended: dropping a pool's last graph
    retires the pool, whose blocks stay reserved until `empty_cache` or a
    failed allocation frees them, and a retired pool cannot take another
    capture."""

    def __init__(self, index: int):
        self.stream = torch.cuda.Stream(device=index)
        self.pool = torch.cuda.graph_pool_handle()
        self.graph: Optional[torch.cuda.CUDAGraph] = None


@functools.cache
def _card_graphs(index: int) -> _CardGraphs:
    return _CardGraphs(index)


def _replayed(cfg, params, cache, tok, pos, n_new: int) -> torch.Tensor:
    """The tokens (B, n_new), `tok` first, on the card: one eager step at
    `pos` (real work, which also warms cuBLAS and the allocator on the
    side stream), then one CUDA graph captured over `cache` and three
    static buffers (the token (B, 1), the position, the logits): a step,
    the argmax into the token buffer and the position's increment. Capture
    runs nothing; each of the n_new - 2 replays is one step, and one copy
    puts its token into the output. The graph calls this module's
    `decode_step` as the eager loop does. No copy of the cache is made; the
    graph's memory is the card's one decode pool (`_CardGraphs`)."""
    dev = tok.device
    home = _card_graphs(dev.index)
    out = torch.empty((tok.shape[0], n_new), dtype=torch.int32, device=dev)
    home.stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(home.stream):
        out[:, :1] = tok
        logits, cache = decode_step(cfg, params, cache, tok, pos)
        tok = _next_token(logits)
        out[:, 1:2] = tok
        pos += 1
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=home.pool, capture_error_mode="thread_local")
        try:
            logits, _ = decode_step(cfg, params, cache, tok, pos)
            tok.copy_(torch.argmax(logits, dim=-1)[:, None])
            pos += 1
        finally:
            graph.capture_end()
        home.graph = graph
        for j in range(2, n_new):
            graph.replay()
            out[:, j:j + 1] = tok
    torch.cuda.current_stream(dev).wait_stream(home.stream)
    return out


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
        device = next((t.device for t in _leaves(params) if isinstance(t, torch.Tensor)), None)
        self._pinned_dst = device is not None and device.type == "cuda"

    def _stage_in(self, data: np.ndarray) -> Tuple[Any, Any]:
        """Register the handoff's source and destination segments: (src,
        dst). The source is `data` itself where it is a 1-D C-contiguous
        uint8 array (with spans on, `adopted_bytes`), else a copy of it. The
        destination is pinned memory when the params live on a card, else
        plain; it is not zeroed, since the batch completes only once every
        slice has written its range."""
        nbytes = max(data.size, 1)
        adopt = adoptable(data, nbytes)
        eng = self.engine
        with _spans.span("serving.register") as sp:
            out = _pinned(nbytes).numpy() if self._pinned_dst else np.empty(nbytes, np.uint8)
            src = eng.register_segment(self._loc_p, nbytes, name="kv-src",
                                       buffer=data if adopt else None)
            dst = eng.register_segment(self._loc_d, nbytes, name="kv-dst", buffer=out)
        if sp is not None:
            sp.counters["segments_live"], sp.counters["segment_bytes_live"] = eng.segments.live()
        with _spans.span("serving.stage_in") as sp:
            if not adopt:
                src.write(0, data)
            elif sp is not None:
                sp.counters["adopted_bytes"] = nbytes
        return src, dst

    def _release(self, *segs) -> None:
        """Deregister the handoff's segments and drop their bytes; a caller
        reads them through a `view` taken before."""
        for seg in segs:
            self.engine.segments.deregister(seg.segment_id)
            seg.drop_bytes()

    def ship_kv_async(self, data: np.ndarray, on_done=None) -> Tuple[Any, int]:
        """Declarative KV-handoff intent: post the prefill->decode elephant
        flow as one async TENT batch and return (dst_segment, batch_id)
        immediately; the decode side is woken by the completion callback.
        When the batch lands, ok or failed, both segments are released
        before `on_done` runs; the returned segment is a view of the
        destination's bytes, which no slice writes after that, so its
        `read` hands them out in place."""
        src, dst = self._stage_in(data)
        out = dst.view()

        def landed(res) -> None:
            self._release(src, dst)
            if on_done is not None:
                on_done(res)

        try:
            batch = self.engine.allocate_batch()
            self.engine.submit_transfer(
                batch, [(src.segment_id, 0, dst.segment_id, 0, src.length)])
        except BaseException:
            self._release(src, dst)
            raise
        self.engine.on_batch_done(batch, landed)
        return out, batch

    def ship_kv(self, data: np.ndarray) -> Tuple[Any, BatchResult]:
        """Blocking KV handoff: `ship_kv_async`, then the engine driven until
        that batch has landed (`TentEngine.wait`), as `transfer_sync` is to
        `submit_transfer`. Returns (dst_segment, BatchResult), a failed
        result included; both segments are released by then."""
        dst, batch = self.ship_kv_async(data)
        return dst, self.engine.wait(batch)

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
            dst, res = self.ship_kv(data)
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
