"""The one traffic generator. A traffic mix is a data file under `traffic/`:

    {"loop": "closed", "batch": B, "prompt_lengths": [S, ...], "n_new": n, "why": "..."}

A call is one batch of B prompts of one length S, served for n tokens. The
calls come in blocks: each block is the multiset `prompt_lengths` in an
order drawn from the seed, so every seed serves the same work in another
order, and a window that closes at the end of a block has served whole
copies of the multiset. The loop is closed: one call in flight, the next
sent when the last has ended. Token ids are uniform over the vocabulary,
drawn on the device from the seed.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

KEYS = {"loop", "batch", "prompt_lengths", "n_new", "why"}


def derived_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of draws; any whole number seeds it."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0])


class Traffic:
    def __init__(self, spec: dict):
        if set(spec) != KEYS:
            raise ValueError(f"a traffic mix has the keys {sorted(KEYS)}, not {sorted(spec)}")
        if spec["loop"] != "closed":
            raise ValueError("the generator makes closed-loop traffic only")
        lengths = spec["prompt_lengths"]
        if not lengths or any(int(s) != s or s < 4 for s in lengths):
            raise ValueError(f"prompt lengths must be whole numbers of 4 or more: {lengths}")
        if int(spec["batch"]) < 1 or int(spec["n_new"]) < 2:
            raise ValueError("a call serves a batch of 1 or more for 2 or more tokens")
        self.batch = int(spec["batch"])
        self.lengths = [int(s) for s in lengths]
        self.n_new = int(spec["n_new"])

    def blocks(self, seed: int) -> Iterator[List[int]]:
        """The prompt length of each call, a block at a time."""
        rng = np.random.default_rng(derived_seed(seed, 0))
        while True:
            yield [self.lengths[i] for i in rng.permutation(len(self.lengths))]

    def shapes(self) -> List[int]:
        """Every prompt length a call can have, once each."""
        return sorted(set(self.lengths))


class Prompts:
    """Token ids for one run's calls, drawn in the order the calls are sent."""

    def __init__(self, seed: int, stream: int, vocab: int, device):
        self.vocab = vocab
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(derived_seed(seed, stream))

    def draw(self, batch: int, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (batch, length), generator=self.gen,
                             device=self.device)
