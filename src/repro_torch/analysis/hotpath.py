"""The `@hot_path` contract marker.

The engine's hot-path sweep established the allocation discipline the wave engine
lives by: no per-item closures, no `functools.partial`, no comprehension
churn inside the per-event loops that run once per slice/completion/tick.
The decorator formalizes that sweep as a *contract*: tagging a function
declares "this body is on the per-event timed path", and the
`hot-path-alloc` lint rule (`repro.analysis.rules`) statically enforces the
discipline on every tagged body from then on.

The decorator itself is deliberately zero-cost: it sets one attribute and
returns the function unchanged — no wrapper frame, no signature change, no
import-time side effects — so tagging can never perturb the timed path it
protects (the same zero-cost-when-off bar the flight recorder holds).
"""
from __future__ import annotations

from typing import Callable, TypeVar

__all__ = ["hot_path", "is_hot_path"]

F = TypeVar("F", bound=Callable)

#: Attribute set on tagged functions; tests and tooling may enumerate it.
HOT_PATH_ATTR = "__tent_hot_path__"


def hot_path(fn: F) -> F:
    """Mark `fn` as being on the engine's per-event timed path.

    Purely declarative: the returned object *is* `fn` (identity preserved,
    no wrapper), with `__tent_hot_path__ = True` attached. The static
    `hot-path-alloc` rule keys off the decorator syntactically, so the tag
    works even on modules the linter never imports.
    """
    setattr(fn, HOT_PATH_ATTR, True)
    return fn


def is_hot_path(fn: Callable) -> bool:
    """True when `fn` (or the function behind a bound method) is tagged."""
    return bool(getattr(fn, HOT_PATH_ATTR, False))
