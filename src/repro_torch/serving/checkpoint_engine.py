"""Moonshot-style checkpoint engine over TENT (paper §5.1.2 / Table 3).

In-place model weight updates for RL pipelines: a parameter-server node
holds the fresh checkpoint in host memory; every rank (GPU) pulls its weight
shard through the transfer engine. All ranks participate concurrently
(Checkpoint Engine v0.2.0 semantics). The backend under the pull — Mooncake
TE's static striping vs TENT's slice spraying — is the Table-3 ablation; the
checkpoint format, sharding, and update schedule stay fixed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import Location, MemoryKind, TentEngine
from ..core.segments import Segment


@dataclasses.dataclass
class UpdateResult:
    seconds: float
    bytes: int
    ranks: int

    @property
    def aggregate_bandwidth(self) -> float:
        return self.bytes / max(self.seconds, 1e-12)


class CheckpointEngine:
    def __init__(
        self,
        engine: TentEngine,
        *,
        nodes: int,
        gpus_per_node: int,
        source_node: int = 0,
        materialize: bool = True,
    ):
        self.engine = engine
        self.nodes = nodes
        self.gpus_per_node = gpus_per_node
        self.source_node = source_node
        self.materialize = materialize
        self.world = nodes * gpus_per_node
        self._src: Optional[Segment] = None
        self._dst: List[Segment] = []
        self._tensor_index: List[Tuple[str, int, int]] = []  # (name, offset, nbytes)
        self.total_bytes = 0

    # ------------------------------------------------------------- staging
    def register_checkpoint(self, table: Dict[str, "np.ndarray | int"]) -> None:
        """Stage a named-tensor table into the parameter-server host segment.

        Values may be arrays (bytes are staged and verifiable) or plain ints
        (sizes only — used with materialize=False for scale simulations).
        Empty or zero-byte tables are rejected: a 0-byte checkpoint would
        register 0-byte segments and post 0-byte per-rank transfers, which is
        never what an RL weight refresh means."""
        if not table:
            raise ValueError("register_checkpoint: empty checkpoint table")
        blobs = []
        off = 0
        self._tensor_index = []
        for name in sorted(table):
            v = table[name]
            if isinstance(v, (int, np.integer)):
                nbytes = int(v)
                raw = None
            else:
                raw = np.ascontiguousarray(v).view(np.uint8).reshape(-1)
                nbytes = raw.size
            self._tensor_index.append((name, off, nbytes))
            if self.materialize:
                assert raw is not None, "materialized checkpoints need real arrays"
                blobs.append(raw)
            off += nbytes
        if off == 0:
            raise ValueError(
                "register_checkpoint: checkpoint table is zero bytes "
                f"({len(table)} entries, all empty)")
        # pad so every rank's shard is equal-sized
        shard = (off + self.world - 1) // self.world
        self.total_bytes = shard * self.world
        self.shard_bytes = shard
        loc = Location(node=self.source_node, kind=MemoryKind.HOST_DRAM, device=0, numa=0)
        self._src = self.engine.register_segment(
            loc, self.total_bytes, name="ckpt-src", materialize=self.materialize)
        if self.materialize:
            payload = np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
            padded = np.zeros(self.total_bytes, dtype=np.uint8)
            padded[: payload.size] = payload
            self._src.write(0, padded)
        # per-rank GPU destination segments
        spec = self.engine.topology.spec
        self._dst = []
        for n in range(self.nodes):
            for g in range(self.gpus_per_node):
                loc = Location(
                    node=n, kind=MemoryKind.DEVICE_HBM, device=g,
                    numa=spec.node.gpu_numa(g),
                )
                self._dst.append(
                    self.engine.register_segment(
                        loc, shard, name=f"ckpt-r{n}.{g}", materialize=self.materialize)
                )

    # ------------------------------------------------------------- update
    def _submit_update(self) -> int:
        assert self._src is not None, "register_checkpoint first"
        batch = self.engine.allocate_batch()
        self.engine.submit_transfer(
            batch,
            [
                (self._src.segment_id, r * self.shard_bytes, dst.segment_id, 0, self.shard_bytes)
                for r, dst in enumerate(self._dst)
            ],
        )
        return batch

    def update_async(
        self, on_done: Optional[Callable[[UpdateResult], None]] = None
    ) -> int:
        """Overlap-mode weight refresh: the all-rank pull is submitted and the
        call returns immediately with the batch id, so the refresh contends
        with whatever live traffic (decode, KV promotion) shares the fabric.
        `on_done` fires with the `UpdateResult` when the last shard lands."""
        t0 = self.engine.fabric.now
        batch = self._submit_update()

        def _landed(res):
            assert res.ok, res.error
            if on_done is not None:
                on_done(UpdateResult(
                    seconds=self.engine.fabric.now - t0,
                    bytes=self.total_bytes, ranks=self.world))

        self.engine.on_batch_done(batch, _landed)
        return batch

    def update(self, *, verify: bool = False) -> UpdateResult:
        """One in-place weight refresh: every rank pulls its shard, one
        declarative batch, all ranks in flight concurrently."""
        t0 = self.engine.fabric.now
        batch = self._submit_update()
        res = self.engine.wait(batch)
        assert res.ok, res.error
        secs = self.engine.fabric.now - t0
        if verify:
            for r, dst in enumerate(self._dst):
                got = dst.read(0, self.shard_bytes)
                want = self._src.read(r * self.shard_bytes, self.shard_bytes)
                np.testing.assert_array_equal(got, want)
        return UpdateResult(seconds=secs, bytes=self.total_bytes, ranks=self.world)

    # ------------------------------------------------------------- readback
    def rank_table(self, rank: int) -> Dict[str, np.ndarray]:
        """Reassemble the tensors whose bytes landed (fully) in one rank's
        shard — used by tests to prove end-to-end integrity."""
        dst = self._dst[rank]
        lo = rank * self.shard_bytes
        hi = lo + self.shard_bytes
        out = {}
        for name, off, nbytes in self._tensor_index:
            if off >= lo and off + nbytes <= hi:
                out[name] = dst.read(off - lo, nbytes)
        return out
