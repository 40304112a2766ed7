"""Declarative parameter specs (port of ``repro.models.spec``, flat layout).

A model is a nested dict of ``ParamSpec`` leaves.  ``initialize`` draws the
actual tensors from an explicit ``torch.Generator``; ``stack(n, tree)``
prepends a ("layers", n) dimension to every leaf.  The init kinds match the
reference (``fan_in`` over the core shape after ``stack_dims``, ``normal``
0.02, ``small`` 0.006, ``unit_normal``, ``zeros``, ``ones``); the draws do
not — torch and ``jax.random`` give different numbers for the same seed, so
parity tests init in JAX and carry the weights over with
``repro_torch.interop``.  The lean/grouped layouts are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.devices import torch_dtype

#: elements per f32 draw when initialising a leaf
_DRAW_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names, len == len(shape)
    init: str = "fan_in"                     # fan_in | zeros | ones | normal | small | unit_normal
    dtype: Optional[str] = None              # override model dtype
    stack_dims: int = 0                      # leading stacked dims skipped by fan_in

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        assert 0 <= self.stack_dims <= len(self.shape), \
            (self.shape, self.stack_dims)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict, keys sorted at every level
    (the order ``jax.tree_util`` flattens dicts in)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, leaves):
    """Nested dict from (key path, leaf) pairs: the inverse of
    ``tree_leaves``."""
    out = {}
    for path, x in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def stack(n: int, tree):
    """Prepend a stacked-layers dimension to every spec in the tree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.dtype, s.stack_dims + 1),
                    tree)


def _scale(spec: ParamSpec) -> Optional[float]:
    """Std of the normal draw for ``spec`` (None for constant inits)."""
    if spec.init in ("zeros", "ones"):
        return None
    if spec.init == "normal":
        return 0.02
    if spec.init == "small":
        return 0.006
    if spec.init == "unit_normal":
        return 1.0
    if spec.init == "fan_in":
        core = spec.shape[spec.stack_dims:]
        fan = core[-2] if len(core) >= 2 else core[-1]
        return 1.0 / math.sqrt(max(fan, 1))
    raise ValueError(f"unknown init {spec.init}")


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device,
               dtype: str) -> torch.Tensor:
    dt = torch_dtype(spec.dtype or dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    std = _scale(spec)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    # draw in f32 chunks: a stacked expert leaf is ~9 GB in bf16, and a
    # whole-leaf f32 draw would more than double that transiently
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _DRAW_CHUNK):
        n = min(_DRAW_CHUNK, flat.numel() - lo)
        draw = torch.randn(n, generator=generator, device=device,
                           dtype=torch.float32)
        flat[lo:lo + n].copy_(draw.mul_(std))
    return out


def initialize(tree, generator: torch.Generator, device, dtype: str):
    """Materialise a spec tree.  Leaves are drawn in sorted key-path order
    from ``generator`` (which must live on ``device``)."""
    pairs = tree_leaves(tree)
    return tree_unflatten([p for p, _ in pairs],
                          [_init_leaf(s, generator, device, dtype)
                           for _, s in pairs])


def count_params(tree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(tree))
