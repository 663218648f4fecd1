"""Public wrappers of the jitted engine core's kernels: the calls
`EngineJitCore` makes once per wave (`choose_wave_staged`) or drain
(`complete_many_staged`). The caller writes a call's padded inputs straight
into the host buffer of a `Staging`, through the numpy views that
`Staging.choose_inputs` / `Staging.drain_inputs` hand out in the kernels'
layouts, so the inputs are packed once. On a CUDA device that buffer is
pinned. A wave goes to the card in one copy, one launch runs the kernel,
and one copy brings the outputs back and waits for the kernel (as the
reference's `np.asarray` on a jax result does). A drain is one call of the
buffer's `kernel.StagedDrain`, resolved when the buffer is made: the
kernel reads and writes the pinned buffer in place through its mapped
device pointer, and the call returns when it has ended. A drain
reads only its first m (live) entries. On the CPU the views go to the
plain torch versions (`ref.py`). `choose_wave_padded_np` and
`complete_many_np` stage arrays the caller already holds. There is no
fallback: if a kernel cannot be built or launched, this raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernel
from .ref import tent_choose_wave_padded_ref, tent_on_complete_many_ref


class Staging:
    """One host buffer (pinned for a card) per size, for one device, reused
    from call to call (sizes are power-of-two buckets, so there are few),
    with the chooser's card buffer of that size and the drain's
    `kernel.StagedDrain` on it. Each call ends by waiting for the kernel, so
    the next call may overwrite the buffers; the outputs a call returns are
    views of the host buffer, valid until the next call."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._host: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}
        self._card: Dict[int, torch.Tensor] = {}
        self._drains: Dict[int, "kernel.StagedDrain"] = {}

    def host(self, n: int) -> Tuple[torch.Tensor, np.ndarray]:
        """The host buffer of n doubles and its numpy view."""
        buf = self._host.get(n)
        if buf is None:
            t = torch.empty(n, dtype=torch.float64, pin_memory=self.device.type != "cpu")
            buf = self._host[n] = (t, t.numpy())
        return buf

    def buffers(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        card = self._card.get(n)
        if card is None:
            card = self._card[n] = torch.empty(n, dtype=torch.float64, device=self.device)
        return self.host(n)[0], card

    def drain(self, n: int) -> "kernel.StagedDrain":
        """The drain bound to the host buffer of n doubles."""
        call = self._drains.get(n)
        if call is None:
            call = self._drains[n] = kernel.StagedDrain(self.host(n)[0], self.device)
        return call

    def choose_inputs(self, pc: int, ps: int) -> Tuple[np.ndarray, ...]:
        """The chooser's ten padded inputs as views of the host buffer, in
        the kernel's order: queued, foreign local, foreign remote,
        bandwidth, beta0, beta1, penalty, excluded over the pc candidates;
        lengths, valid over the ps slices. The caller fills every element."""
        hv = self.host(kernel.choose_in_size(pc, ps) + kernel.choose_out_size(pc, ps))[1]
        cols = tuple(hv[i * pc:(i + 1) * pc] for i in range(8))
        return cols + (hv[8 * pc:8 * pc + ps], hv[8 * pc + ps:8 * pc + 2 * ps])

    def drain_inputs(self, ps: int, pm: int) -> Tuple[Tuple[np.ndarray, ...], ...]:
        """The drain's padded inputs as views of the host buffer: the eight
        state vectors of `TelemetryStore.gather_complete_state` over ps
        slots, and slots, lengths, queued_at, t_obs over pm completions.
        The caller fills the state and the first m (live) completions; the
        drain reads no completion past them."""
        hv = self.host(8 * ps + 4 * pm)[1]
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


def complete_many_staged(staging: Staging, ps: int, pm: int, m: int):
    """One drain of the first m completions of a padded batch on
    `staging.device`, on the inputs written into `staging.drain_inputs(ps,
    pm)`. Returns the five updated state vectors as numpy; rows that no
    live completion names, the scratch row among them, keep their values."""
    if staging.device.type == "cpu":
        state, batch = staging.drain_inputs(ps, pm)
        out = tent_on_complete_many_ref(*(torch.from_numpy(a) for a in state),
                                        *(torch.from_numpy(a[:m]) for a in batch))
        return tuple(t.numpy() for t in out)
    return card_drain(staging, ps, pm, m)


def card_drain(staging: Staging, ps: int, pm: int, m: int):
    """The card path of `complete_many_staged`: one call of the buffer's
    `StagedDrain`, which returns when the kernel has ended."""
    n = 8 * ps + 4 * pm
    staging.drain(n)(ps, pm, m)
    hv = staging.host(n)[1]
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
                     staging: Staging, m: Optional[int] = None):
    """`complete_many_staged` on the eight padded state vectors of
    `TelemetryStore.gather_complete_state` and a padded batch whose first
    m (default all) entries are live, staged first."""
    ps, pm = len(state[0]), len(slots)
    views, batch = staging.drain_inputs(ps, pm)
    for view, a in zip(views + batch, tuple(state) + (slots, lengths, queued_at, t_obs)):
        view[:] = a
    return complete_many_staged(staging, ps, pm, pm if m is None else m)
