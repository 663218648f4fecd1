"""Shared by the tests of the port's KV handoff (not collected): the engine
the serving benchmark builds, and one blocking handoff through it."""
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.core import BatchResult, TentEngine
from repro_torch.scenarios import get
from repro_torch.serving import DisaggregatedServer


def pd_engine() -> TentEngine:
    """The PD-disaggregation scenario's fabric and engine, policy tent."""
    spec = get("disagg_prefill_decode")
    return TentEngine(spec.topology.to_fabric_spec(),
                      config=spec.engine.to_engine_config("tent"), seed=spec.seed)


def ship(eng: TentEngine, data: np.ndarray, *, flap: bool = False,
         params: Optional[Any] = None) -> Tuple[Any, BatchResult]:
    """One handoff of `data` through `DisaggregatedServer.ship_kv` on `eng`:
    (the landed view, BatchResult). `flap`: rail (0, 1) fails from +0.2 to
    +2 ms virtual, while the flow runs. `params` on a card make the
    destination pinned, as the server's own do."""
    if flap:
        v0 = eng.fabric.now
        eng.fabric.schedule_failure(eng.topology.rdma_nic(0, 1).link_id,
                                    at=v0 + 2e-4, recover_at=v0 + 2e-3)
    return DisaggregatedServer(eng, None, params).ship_kv(data)
