"""The aten ops that one `prefill_forward` and one `decode_step` of the
qwen2-0.5b and mamba2-370m smoke configurations dispatch, by name, pinned
to the counts measured before the model gained `layer_types`, the dropless
MoE and the scalar multipliers (`fixtures/dispatch_counts.json`; a decode
step's since it reads its position on the device, which writes a slot by
`index_copy_`): those paths stay the paths the benchmark's cells measure,
op for op."""
import collections
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step, init_params, prefill_forward

PINNED = json.loads((Path(__file__).parent / "fixtures" / "dispatch_counts.json").read_text())
PROMPT = 40


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("key", sorted(PINNED))
def test_dispatched_ops_are_the_pinned_ones(key):
    arch, pallas, entry = key.split()
    cfg = get_smoke_config(arch).with_(use_pallas=pallas == "use_pallas=True", remat="none")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen)
    with torch.no_grad():
        with _Count() as prefill_ops:
            logits, cache = prefill_forward(cfg, params, tokens)
        cache = {n: F.pad(t, (0, 0, 0, 0, 0, 8)) if n in ("k", "v") else t
                 for n, t in cache.items()}
        token = logits.argmax(-1)[:, None]
        with _Count() as step_ops:
            decode_step(cfg, params, cache, token, PROMPT)
    got = prefill_ops if entry == "prefill_forward" else step_ops
    assert dict(sorted(got.ops.items())) == PINNED[key]
