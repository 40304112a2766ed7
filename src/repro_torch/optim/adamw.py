"""AdamW with f32 moments over low-precision params, global-norm clipping,
trainable masks (two-stage schedule) and a non-finite-grad skip — port of
``repro.optim.adamw``, not ``torch.optim.AdamW``.

Unlike the reference (pure functions over immutable arrays), updates are
in place, in chunks of at most ``CHUNK`` elements of each leaf's flat view:
the stacked expert weights of qwen2-moe-a2.7b are 184 M elements per layer,
and a whole-leaf f32 temporary would be several GB.  The arithmetic is the
reference's, op for op, with its f32 scalars (bias corrections, learning
rate, clip scale) computed in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.spec import tree_leaves, tree_map

#: elements per in-place update chunk
CHUNK = 1 << 25

_f32 = np.float32


def _chunks(*tensors):
    """Aligned flat chunks of same-shaped contiguous tensors."""
    flats = [t.view(-1) for t in tensors]
    n = flats[0].numel()
    for lo in range(0, n, CHUNK):
        yield [f[lo:lo + CHUNK] for f in flats]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    lr_schedule: Optional[Callable] = None   # step -> multiplier

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        dev = tree_leaves(params)[0][1].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update_leaf(self, p, g, st, *, step: int, scale=1.0, mask=1.0,
                    skip: bool = False):
        """One parameter leaf, in place: AdamW with a pre-scaled f32 grad.
        ``st`` is ``{"m", "v"}`` (f32, p's shape), ``scale`` the deferred
        global-norm clip factor, ``skip`` freezes params AND moments (a
        non-finite grad step)."""
        if skip:
            return p, st
        b1, b2 = self.b1, self.b2
        c1 = _f32(1) - _f32(b1) ** _f32(step)
        c2 = _f32(1) - _f32(b2) ** _f32(step)
        lr = _f32(self.lr) * (_f32(self.lr_schedule(step))
                              if self.lr_schedule else _f32(1))
        scale, mask = _f32(scale), float(mask)
        with torch.no_grad():
            for pc, gc, mc, vc in _chunks(p, g, st["m"], st["v"]):
                gf = gc.float() * float(scale)
                mc.mul_(b1).add_(gf * (1 - b1))
                vc.mul_(b2).add_(gf * (1 - b2) * gf)
                if mask == 0.0:
                    continue                 # p - lr * u * 0 == p exactly
                u = (mc / float(c1)) / (torch.sqrt(vc / float(c2)) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * pc.float()
                pc.copy_(pc.float() - float(lr) * u * mask)
        return p, st

    def update(self, grads, state, params, mask=None):
        """One step over the whole tree; params and state change in place.
        Returns (params, state)."""
        step = int(state["step"]) + 1
        scale, skip = ((1.0, False) if not self.clip_norm
                       else clip_guard(global_norm_sq(grads), self.clip_norm))
        apply_subtree(self, params, grads, {"m": state["m"], "v": state["v"]},
                      step=step, scale=scale, mask=mask, skip=skip)
        state["step"].fill_(step)
        return params, state


def global_norm_sq(tree) -> float:
    """Sum of squared f32 leaf norms, chunk by chunk: no f32 copy of a
    whole leaf is ever live."""
    total = None
    with torch.no_grad():
        for _, g in tree_leaves(tree):
            for (gc,) in _chunks(g.contiguous()):
                sq = torch.sum(torch.square(gc.float()))
                total = sq if total is None else total + sq
    return float(total) if total is not None else 0.0


def global_norm(tree) -> float:
    return math.sqrt(global_norm_sq(tree))


def clip_guard(gn_sq: float, clip_norm: float):
    """(scale, skip) from a squared global norm.  ``scale`` clips the update
    to ``clip_norm``; a non-finite norm returns ``skip=True`` with scale 0 so
    the caller freezes the step instead of writing NaN into every param."""
    gn = _f32(np.sqrt(_f32(gn_sq)))
    if not np.isfinite(gn):
        return 0.0, True
    return float(min(_f32(1.0), _f32(clip_norm) / (gn + _f32(1e-9)))), False


def apply_subtree(opt, params, grads, parts, *, step: int, scale=1.0,
                  mask=None, skip: bool = False):
    """Drive ``opt.update_leaf`` across a params subtree (in place).
    ``parts`` is a dict of state trees matching ``params`` leaf for leaf;
    ``mask`` is None or a matching tree of floats."""
    g_leaves = dict(tree_leaves(grads))
    part_leaves = {k: dict(tree_leaves(t)) for k, t in parts.items()}
    mk_leaves = dict(tree_leaves(mask)) if mask is not None else {}
    for path, p in tree_leaves(params):
        st = {k: part_leaves[k][path] for k in parts}
        opt.update_leaf(p, g_leaves[path].contiguous(), st, step=step,
                        scale=scale,
                        mask=mk_leaves.get(path, 1.0), skip=skip)
    return params, parts


def cosine_schedule(warmup: int, total: int):
    """step -> f32 multiplier: linear warm-up, then cosine decay to 0."""
    def f(step):
        s = _f32(step)
        warm = s / _f32(max(warmup, 1))
        prog = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                       _f32(0), _f32(1))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * prog))
        return _f32(warm if s < warmup else cos)
    return f
