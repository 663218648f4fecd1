"""Deliberate no-global-rng violations through torch's global generator."""
import time

import torch


def draw_global(n):
    torch.manual_seed(0)  # VIOLATION: seeds the global generator
    torch.cuda.manual_seed_all(0)  # VIOLATION: and every card's
    a = torch.randn(n)  # VIOLATION: no generator=
    b = torch.randint(0, 10, (n,))  # VIOLATION: no generator=
    c = torch.rand_like(a)  # VIOLATION: takes no generator at all
    return a, b, c


def bad_seeds(obj):
    g1 = torch.Generator().manual_seed(id(obj))  # VIOLATION: id() seed
    g2 = torch.Generator().manual_seed(int(time.time()))  # VIOLATION: wall seed
    return g1, g2
