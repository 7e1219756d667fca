"""Parameter definition + initialisation on the target device +
logical-axis sharding.

Every model declares its parameters as a tree (nested dicts and lists)
of :class:`ParamDef` leaves, like the reference.  :func:`init_params`
materialises it with one explicit ``torch.Generator`` on the target
device, so a full-width model is drawn where it will live instead of
being made on the host and copied.  The draws differ from the
reference's ``jax.random`` ones; parity tests share weights through
:func:`repro_torch.convert.params_from_jax` instead.

Logical axes ("vocab", "ff", "heads", "experts", …) are mapped to
physical mesh axes by the distribution layer's rule table
(:mod:`repro_torch.dist.sharding`): :func:`param_specs` turns a rule
table into one spec per leaf, a plain tuple of per-dimension entries
(``None``, an axis name or a tuple of axis names) that compares equal
to ``tuple()`` of the reference's ``PartitionSpec``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["ParamDef", "init_params", "tree_map", "tree_leaves",
           "tree_paths", "abstract_params", "param_specs", "count_params",
           "is_spec"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # None -> 1/sqrt(fan_in)

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists, visiting
    dict keys in sorted order (the order jax flattens them in).
    ``is_leaf`` marks nodes to hand to ``fn`` whole (a spec tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any,
                is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The leaves of a tree of dicts and lists, in :func:`tree_map`'s
    order."""
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_paths(tree: Any, prefix: tuple = (),
               is_leaf: Callable[[Any], bool] | None = None) -> list[tuple]:
    """The path (dict keys and list indices) of every leaf, in
    :func:`tree_map`'s order."""
    if is_leaf is not None and is_leaf(tree):
        return [prefix]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], prefix + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, prefix + (i,), is_leaf)]
    return [prefix]


def is_spec(x: Any) -> bool:
    """Leaf test for spec trees: a tuple of per-dimension entries, each
    ``None``, an axis name or a tuple of axis names (``()`` is the spec
    of a scalar)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _init_one(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else fan_in ** -0.5
    w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def init_params(defs: Any, gen: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Any:
    """Materialise a ParamDef tree on ``gen``'s device, leaf by leaf in
    a fixed order (deterministic per seed and device)."""
    return tree_map(lambda d: _init_one(d, gen, dtype, gen.device), defs)



def abstract_params(defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the reference's ShapeDtypeStruct tree)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def param_specs(defs: Any, rules: dict[str, Any]) -> Any:
    """Map logical axes -> specs via the rule table.

    ``rules`` maps logical axis name -> mesh axis (str | tuple | None).
    Unlisted logical axes are replicated.
    """
    return tree_map(lambda d: tuple(rules.get(a) if a else None
                                    for a in d.axes), defs)


def count_params(defs: Any) -> int:
    total = 0
    for d in tree_leaves(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
