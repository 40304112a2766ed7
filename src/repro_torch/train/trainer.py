"""Training step construction (port of ``repro.train.trainer``): gradient
accumulation over microbatches, stage masks, metrics.

PyTorch runs eagerly, so the step is a plain function; the reference's
``jax.lax.scan`` over microbatches is a Python loop.  Gradient compression
and the fused optimizer-in-backward step are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.models.spec import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import global_norm


def value_and_grad(fn, params, *args):
    """(fn(params, *args) detached, grads of every param leaf) — the
    counterpart of ``jax.value_and_grad`` over a nested dict of tensors.
    A leaf the loss does not reach gets a zero grad, as in JAX."""
    pairs = tree_leaves(params)
    leaves = [p for _, p in pairs]
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten([k for k, _ in pairs], grads)


def accumulator_init(params, accum_dtype=None):
    """Gradient-accumulation buffer for ``n_micro > 1``: f32 unless
    ``accum_dtype`` says otherwise — one full-tree f32 buffer keeps the
    cross-microbatch sum exact whatever the grad dtype.  (The reference's
    compressor-dtype policy comes with compression.)"""
    dt = accum_dtype or torch.float32
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                    params)


def to_device_batch(batch, device):
    """numpy batch from the data pipeline -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, optimizer, *, n_micro: int = 1,
                    mask_fn: Optional[Callable] = None,
                    compress: Optional[Callable] = None,
                    save_memory=True, fused: bool = False,
                    accum_dtype=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and optimizer state are updated in place.

    batch leaves (tensors on the params' device) have leading dim
    global_batch; accumulation splits it into ``n_micro`` slices run one
    after another (activation memory = one microbatch).  ``save_memory`` is
    forwarded to ``model.loss``."""
    if fused:
        raise NotImplementedError(
            "the fused optimizer-in-backward step: not ported yet "
            "(ROADMAP.md queue 1)")
    if compress is not None:
        raise NotImplementedError(
            "gradient compression: not ported yet (ROADMAP.md queue 1)")

    def loss_fn(params, mbatch):
        return model.loss(params, mbatch, save_memory=save_memory)

    def train_step(params, opt_state, batch):
        if n_micro > 1:
            gb = next(iter(batch.values())).shape[0]
            if gb % n_micro != 0:
                raise ValueError(
                    f"global batch {gb} is not divisible by n_micro="
                    f"{n_micro} (remainder {gb % n_micro}); pick n_micro "
                    f"dividing the global batch or pad the batch")
            mb = gb // n_micro
            grads = accumulator_init(params, accum_dtype=accum_dtype)
            loss = 0.0
            for j in range(n_micro):
                mbatch = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
                loss_j, g = value_and_grad(loss_fn, params, mbatch)
                for (_, a), (_, b) in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(a.dtype))
                del g
                loss = loss + loss_j
            grads = tree_map(lambda a: a.div_(n_micro), grads)
            loss = loss / n_micro
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        mask = mask_fn(params) if mask_fn else None
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             mask=mask)
        metrics = {"loss": float(loss), "grad_norm": gnorm,
                   "grads_finite": math.isfinite(gnorm),
                   "step": int(opt_state["step"])}
        return params, opt_state, metrics

    return train_step
