"""Public wrappers of the jitted engine core's kernels: the calls
`EngineJitCore` makes once per wave (`choose_wave_staged`) or drain
(`complete_many_staged`). The caller writes a call's padded inputs straight
into the host buffer of a `Staging`, through the numpy views that
`Staging.choose_inputs` / `Staging.drain_inputs` hand out in the kernels'
layouts, so the inputs are packed once. On a CUDA device that buffer is
pinned: it goes to the card in one copy, one launch runs the kernel, and
one copy brings the outputs back and waits for the kernel (as the
reference's `np.asarray` on a jax result does). On the CPU the views go to
the plain torch versions (`ref.py`). `choose_wave_padded_np` and
`complete_many_np` stage arrays the caller already holds. There is no
fallback: if a kernel cannot be built or launched, this raises.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import kernel
from .ref import tent_choose_wave_padded_ref, tent_on_complete_many_ref


class Staging:
    """One host buffer (pinned for a card) and one card buffer per size, for
    one device, reused from call to call (sizes are power-of-two buckets, so
    there are few). Each call ends by waiting for its copy back, so the next
    call may overwrite them; the outputs a call returns are views of the
    host buffer, valid until the next call."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def buffers(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        bufs = self._bufs.get(n)
        if bufs is None:
            on_card = self.device.type != "cpu"
            bufs = self._bufs[n] = (
                torch.empty(n, dtype=torch.float64, pin_memory=on_card),
                torch.empty(n, dtype=torch.float64, device=self.device))
        return bufs

    def choose_inputs(self, pc: int, ps: int) -> Tuple[np.ndarray, ...]:
        """The chooser's ten padded inputs as views of the host buffer, in
        the kernel's order: queued, foreign local, foreign remote,
        bandwidth, beta0, beta1, penalty, excluded over the pc candidates;
        lengths, valid over the ps slices. The caller fills every element."""
        hv = self.buffers(kernel.choose_in_size(pc, ps)
                          + kernel.choose_out_size(pc, ps))[0].numpy()
        cols = tuple(hv[i * pc:(i + 1) * pc] for i in range(8))
        return cols + (hv[8 * pc:8 * pc + ps], hv[8 * pc + ps:8 * pc + 2 * ps])

    def drain_inputs(self, ps: int, pm: int) -> Tuple[Tuple[np.ndarray, ...], ...]:
        """The drain's padded inputs as views of the host buffer: the eight
        state vectors of `TelemetryStore.gather_complete_state` over ps
        slots, and slots, lengths, queued_at, t_obs over pm completions.
        The caller fills every element."""
        hv = self.buffers(8 * ps + 4 * pm)[0].numpy()
        return (tuple(hv[i * ps:(i + 1) * ps] for i in range(8)),
                tuple(hv[8 * ps + i * pm:8 * ps + (i + 1) * pm] for i in range(4)))


def choose_wave_staged(staging: Staging, pc: int, ps: int, rr: int, gamma: float):
    """One padded wave of Algorithm 1 on `staging.device`, on the inputs
    written into `staging.choose_inputs(pc, ps)`. Returns numpy
    `(choices int64, queued_at, queued_out, rr_out int)`."""
    if staging.device.type == "cpu":
        c, qa, qo, rr_o = tent_choose_wave_padded_ref(
            *(torch.from_numpy(a) for a in staging.choose_inputs(pc, ps)), rr, gamma)
        return c.numpy(), qa.numpy(), qo.numpy(), int(rr_o)
    return card_choose(staging, pc, ps, rr, gamma)


def card_choose(staging: Staging, pc: int, ps: int, rr: int, gamma: float):
    """The card path of `choose_wave_staged`: one copy in, one launch, one
    copy back."""
    n_in, n_out = kernel.choose_in_size(pc, ps), kernel.choose_out_size(pc, ps)
    host, card = staging.buffers(n_in + n_out)
    hv = host.numpy()
    hv[n_in - 2], hv[n_in - 1] = rr, gamma
    card[:n_in].copy_(host[:n_in], non_blocking=True)
    kernel.choose_wave_padded(card[:n_in], card[n_in:n_in + n_out], pc, ps)
    host[n_in:n_in + n_out].copy_(card[n_in:n_in + n_out])  # waits for the kernel
    o = hv[n_in:n_in + n_out]
    return o[:ps].astype(np.int64), o[ps:2 * ps], o[2 * ps:2 * ps + pc], int(o[2 * ps + pc])


def complete_many_staged(staging: Staging, ps: int, pm: int):
    """One drain of a padded completion batch on `staging.device`, on the
    inputs written into `staging.drain_inputs(ps, pm)`. Returns the five
    updated state vectors as numpy."""
    if staging.device.type == "cpu":
        state, batch = staging.drain_inputs(ps, pm)
        out = tent_on_complete_many_ref(*(torch.from_numpy(a) for a in state + batch))
        return tuple(t.numpy() for t in out)
    return card_drain(staging, ps, pm)


def card_drain(staging: Staging, ps: int, pm: int):
    """The card path of `complete_many_staged`: one copy in, one launch, one
    copy back."""
    n = 8 * ps + 4 * pm
    host, card = staging.buffers(n)
    card.copy_(host, non_blocking=True)
    kernel.complete_many(card[:8 * ps], card[8 * ps:n], ps, pm)
    host[:5 * ps].copy_(card[:5 * ps])  # waits for the kernel
    hv = host.numpy()
    return tuple(hv[i * ps:(i + 1) * ps] for i in range(5))


def choose_wave_padded_np(arrays: Sequence[np.ndarray], rr: int, gamma: float,
                          staging: Staging):
    """`choose_wave_staged` on ten padded arrays in the order of
    `Staging.choose_inputs`, staged first."""
    pc, ps = len(arrays[0]), len(arrays[8])
    for view, a in zip(staging.choose_inputs(pc, ps), arrays):
        view[:] = a
    return choose_wave_staged(staging, pc, ps, rr, gamma)


def complete_many_np(state: Sequence[np.ndarray], slots, lengths, queued_at, t_obs,
                     staging: Staging):
    """`complete_many_staged` on the eight padded state vectors of
    `TelemetryStore.gather_complete_state` and a padded batch, staged
    first."""
    ps, pm = len(state[0]), len(slots)
    views, batch = staging.drain_inputs(ps, pm)
    for view, a in zip(views + batch, tuple(state) + (slots, lengths, queued_at, t_obs)):
        view[:] = a
    return complete_many_staged(staging, ps, pm)
