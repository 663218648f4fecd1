"""The parameter tree as the training modules walk it: nested dicts of
tensors, leaves in the reference's pytree order (sorted keys, depth
first), keys joined by "/" as `jax.tree_util`'s paths are in the
reference's checkpoint table."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs, e.g. ("params/layers/wq", tensor) with prefix
    "params/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            sub = tree[k]
            yield from named_leaves(sub, f"{prefix}{k}/" if isinstance(sub, dict)
                                    else f"{prefix}{k}")
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`fn` over the leaves, called in leaf order, in `tree`'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)
