"""Known-clean twin of bad_torch_rng: seeded generators only."""
import torch


def draw_seeded(seed: int, n: int, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(n, generator=gen, device=device)
    b = torch.randint(0, 10, (n,), generator=gen, device=device)
    c = torch.empty(n).uniform_(-1.0, 1.0, generator=gen)
    return a, b, c
