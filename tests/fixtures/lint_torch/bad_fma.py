"""Deliberate fma-hazard violations: unguarded products feeding adds inside
bodies that torch.compile, TorchScript or Triton compile."""
import functools

import torch
import triton


@torch.compile
def blend(x, y, w):
    return x * w + y  # VIOLATION: torch.compile contracts it


@torch.compile(mode="reduce-overhead")
def residual(x, y, s):
    return y - x * s  # VIOLATION: decorator called with options


@torch.jit.script
def scaled(a, b, c):
    return a * b + c  # VIOLATION: TorchScript's fuser


@triton.jit
def axpy(x, y, a):
    return a * x + y  # VIOLATION: a Triton kernel


@functools.partial(torch.compile, fullgraph=True)
def shifted(x, y):
    return x * y + 1.0  # VIOLATION: compiled through functools.partial


def traced(x, y, z):
    return x * y + z  # VIOLATION: passed to torch.jit.trace below


traced_fn = torch.jit.trace(traced, (torch.zeros(2), torch.zeros(2), torch.zeros(2)))


@torch.compile
def offset(n):
    return n + 4 * 8  # clean: integer-constant product
