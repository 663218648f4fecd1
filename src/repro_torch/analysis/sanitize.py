"""Runtime sanitizer: the dynamic teeth behind no-wall-clock/no-global-rng.

The static rules prove engine *source* clean; this module catches what
statics can't — third-party callbacks, exec'd strings, getattr dispatch —
by monkeypatching the wall-clock functions and global-RNG entry points to
raise while a simulated path is running. Set `REPRO_SANITIZE=1` and every
`ScenarioRunner.run_policy` body executes under the patch; any engine-side
call to `time.time()` or `np.random.rand()` dies loudly with the invariant
it broke.

Scoping is by *caller module*: the stub raises only when the frame that
called it belongs to a `repro_torch.*` module outside `DYNAMIC_ALLOWLIST`.
Library internals (jax, numpy itself, pytest) keep working — jax probes
`time.monotonic` during tracing and that is not our violation to report.

Zero-cost-when-off, same bar as the flight recorder: with the env var
unset, `maybe_sanitized()` returns a nullcontext and no patching happens.
"""
from __future__ import annotations

import contextlib
import os
import random as _py_random
import sys
import time as _time
from typing import Iterator

import numpy as _np

__all__ = [
    "SanitizerError",
    "DYNAMIC_ALLOWLIST",
    "enabled",
    "sanitized",
    "maybe_sanitized",
]


class SanitizerError(RuntimeError):
    """A wall-clock or global-RNG call escaped onto a simulated path."""


#: repro modules allowed to touch the wall clock even under the sanitizer —
#: mirrors the static rule's ALLOWED_FILES (their job is wall timing).
DYNAMIC_ALLOWLIST = frozenset({
    "repro_torch.training.train_loop",
    "repro_torch.launch.dryrun",
    "repro_torch.obs.spans",
})

_ENV_VAR = "REPRO_SANITIZE"

# (module object, attribute name, invariant tag)
_WALL_CLOCK = [
    (_time, name, "no-wall-clock") for name in (
        "time", "time_ns", "perf_counter", "perf_counter_ns",
        "monotonic", "monotonic_ns", "process_time", "process_time_ns",
        "sleep",
    )
]
_NP_GLOBAL_RNG = [
    (_np.random, name, "no-global-rng") for name in (
        "seed", "random", "rand", "randn", "randint", "random_sample",
        "choice", "shuffle", "permutation", "uniform", "normal",
        "standard_normal", "exponential", "poisson", "beta", "gamma",
        "binomial", "bytes", "random_integers",
    ) if hasattr(_np.random, name)
]
_PY_GLOBAL_RNG = [
    (_py_random, name, "no-global-rng") for name in (
        "seed", "random", "uniform", "randint", "randrange", "choice",
        "choices", "shuffle", "sample", "gauss", "normalvariate",
        "expovariate", "betavariate", "gammavariate", "getrandbits",
    )
]

_PATCH_TABLE = _WALL_CLOCK + _NP_GLOBAL_RNG + _PY_GLOBAL_RNG


def enabled() -> bool:
    """True when `REPRO_SANITIZE` is set to a truthy value."""
    return os.environ.get(_ENV_VAR, "").strip().lower() in (
        "1", "true", "yes", "on")


def _caller_module(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return ""
    return frame.f_globals.get("__name__", "") or ""


def _make_stub(original, qualname: str, invariant: str):
    def stub(*args, **kwargs):
        mod = _caller_module()
        if mod.startswith("repro_torch.") and mod not in DYNAMIC_ALLOWLIST:
            raise SanitizerError(
                f"{invariant}: `{qualname}()` called from simulated-path "
                f"module `{mod}` under REPRO_SANITIZE — simulated time "
                "must come from Fabric.now and randomness from a seeded "
                "Generator (see docs/ANALYSIS.md)")
        return original(*args, **kwargs)

    stub.__tentlint_stub__ = True  # marks an active patch (re-entrancy)
    stub.__wrapped__ = original
    return stub


@contextlib.contextmanager
def sanitized() -> Iterator[None]:
    """Patch wall-clock and global-RNG entry points for the duration of
    the block. Re-entrant: nested blocks see the patch already applied and
    leave it untouched, so the outermost block owns the restore."""
    saved = []
    for mod, name, invariant in _PATCH_TABLE:
        current = getattr(mod, name)
        if getattr(current, "__tentlint_stub__", False):
            continue  # already patched by an enclosing block
        qual = f"{mod.__name__}.{name}"
        saved.append((mod, name, current))
        setattr(mod, name, _make_stub(current, qual, invariant))
    try:
        yield
    finally:
        for mod, name, original in reversed(saved):
            setattr(mod, name, original)


def maybe_sanitized():
    """`sanitized()` when REPRO_SANITIZE is on, else a no-op context.

    The simulated-path entry points (scenario runner policies) wrap their
    bodies in this so production runs pay nothing and sanitizer runs get
    full dynamic enforcement.
    """
    return sanitized() if enabled() else contextlib.nullcontext()
