"""RevFFN reversible blocks and the O(1)-activation stack (port of
``repro.core.reversible``).

The paper's coupled update (Eqs. 1-2):

    Y1 = X1 + F(X1, X2)        F = cross-branch attention (Q from X1, K/V from X2)
    Y2 = X2 + G(Y1)            G = MLP or MoE

with inverse X2 = Y2 - G(Y1), then X1 = Y1 - F(X1, X2) as a fixed point in
X1 seeded at Y1.

``reversible_stack`` runs the layers inside a ``torch.autograd.Function``
that saves ONLY the stacked params (which autograd keeps anyway) and the
final outputs: the backward reconstructs each layer's input by inversion
and re-runs that one layer under ``enable_grad`` to differentiate it
(RevViT's pattern), so peak activation memory is one block, independent of
depth.  ``save_memory="half"`` saves the stream-1 inputs and inverts in
closed form; ``save_memory=False`` is the plain loop under autograd.
Per-layer policy lists, offload and the fused-optimizer walks are not
ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.spec import tree_leaves, tree_unflatten


def coupling(F: Callable, target: int, fp_iters: int = 1):
    """One reversible additive update of a single stream.

    F(params, shared, ctx, i, x1, x2) -> delta added to stream ``target``.
    ``fp_iters > 1`` allows the paper's cross form where F reads the stream
    it updates: the inverse runs that many fixed-point iterations seeded at
    Y.
    """
    assert target in (1, 2)

    def fwd(p, sh, ctx, i, x1, x2):
        if target == 1:
            return x1 + F(p, sh, ctx, i, x1, x2), x2
        return x1, x2 + F(p, sh, ctx, i, x1, x2)

    def inv(p, sh, ctx, i, y1, y2):
        if target == 1:
            x1 = y1                                  # paper: seed at Y1
            for _ in range(max(fp_iters, 1)):
                x1 = y1 - F(p, sh, ctx, i, x1, y2)
            return x1, y2
        x2 = y2
        for _ in range(max(fp_iters, 1)):
            x2 = y2 - F(p, sh, ctx, i, y1, x2)
        return y1, x2

    return fwd, inv


def make_coupled(F: Callable, G: Callable, *, mode: str = "cross",
                 fp_iters: int = 3):
    """Paper Eqs. 1-2: Y1 = X1 + F(X1, X2); Y2 = X2 + G(Y1).  mode="cross"
    inverts F by fixed point; "standard" asserts F ignores X1 (exact)."""
    it = fp_iters if mode == "cross" else 1
    return chain(coupling(F, 1, it), coupling(G, 2, 1))


def chain(*pairs):
    """Compose bijections: fwd applies in order, inv in reverse order."""
    def fwd(p, sh, ctx, i, x1, x2):
        for f, _ in pairs:
            x1, x2 = f(p, sh, ctx, i, x1, x2)
        return x1, x2

    def inv(p, sh, ctx, i, y1, y2):
        for _, g in reversed(pairs):
            y1, y2 = g(p, sh, ctx, i, y1, y2)
        return y1, y2

    return fwd, inv


# ------------------------------------------------------------ tree plumbing

def _flatten(tree):
    """(paths, leaves) of a nested dict, keys sorted (jax's order)."""
    pairs = tree_leaves(tree) if tree else []
    return [p for p, _ in pairs], [x for _, x in pairs]


class _Stack:
    """What the autograd Function needs besides tensors."""

    def __init__(self, block_fwd, block_inv, half_inv, n, offset, ctx,
                 paths, sh_paths):
        self.fwd, self.inv, self.half_inv = block_fwd, block_inv, half_inv
        self.n, self.offset, self.ctx = n, offset, ctx
        self.paths, self.sh_paths = paths, sh_paths


class _ReversibleFn(torch.autograd.Function):
    """apply(run, half, x1, x2, *stacked_leaves, *shared_leaves).

    Saves the stacked params, the shared leaves and the final (y1, y2) —
    plus, in "half" mode, the stream-1 input of every layer.  The backward
    walks the layers in reverse: it inverts layer i under ``no_grad``, re-runs
    it under ``enable_grad`` and back-propagates into its param slices, its
    shared leaves and its two inputs.  Each param slice's ``.grad`` is preset
    to slice i of one zeroed buffer per stacked leaf (param dtype), and each
    shared leaf's to its one buffer, so autograd adds every grad in place as
    soon as it is produced and frees it: the layer's grads never exist all
    at once beside the buffers."""

    @staticmethod
    def forward(ctx, run, half, x1, x2, *flat):
        n_st = len(run.paths)
        shared = tree_unflatten(run.sh_paths, flat[n_st:])
        x1s = []
        for j in range(run.n):
            if half:
                x1s.append(x1)
            lp = tree_unflatten(run.paths, [a[j] for a in flat[:n_st]])
            x1, x2 = run.fwd(lp, shared, run.ctx, run.offset + j, x1, x2)
        ctx.run, ctx.half = run, half
        extra = [torch.stack(x1s)] if half else []
        ctx.save_for_backward(x1, x2, *flat, *extra)
        return x1, x2

    @staticmethod
    def backward(ctx, c1, c2):
        run, half = ctx.run, ctx.half
        saved = ctx.saved_tensors
        y1, y2 = saved[0], saved[1]
        n_st, n_sh = len(run.paths), len(run.sh_paths)
        flat = saved[2:2 + n_st + n_sh]
        x1s = saved[-1] if half else None
        st_leaves, sh_leaves = flat[:n_st], flat[n_st:]
        need = ctx.needs_input_grad[4:]
        d_st = [torch.zeros_like(a) if need[k] else None
                for k, a in enumerate(st_leaves)]
        d_sh = [torch.zeros_like(a) if need[n_st + k] else None
                for k, a in enumerate(sh_leaves)]
        c1 = torch.zeros_like(y1) if c1 is None else c1
        c2 = torch.zeros_like(y2) if c2 is None else c2
        shared = tree_unflatten(run.sh_paths, sh_leaves)
        for j in reversed(range(run.n)):
            i = run.offset + j
            layer = [a[j] for a in st_leaves]
            lp = tree_unflatten(run.paths, layer)
            with torch.no_grad():
                if half:
                    x1 = x1s[j]
                    y1_j = x1s[j + 1] if j + 1 < run.n else y1
                    x2 = run.half_inv(lp, shared, run.ctx, i, x1, y1_j, y2)
                else:
                    x1, x2 = run.inv(lp, shared, run.ctx, i, y1, y2)
            with torch.enable_grad():
                a = x1.detach().requires_grad_()
                b = x2.detach().requires_grad_()
                bufs = [d if d is None else d[j] for d in d_st] + d_sh
                ins = []
                for leaf, buf in zip(layer + list(sh_leaves), bufs):
                    leaf = leaf.detach().requires_grad_(buf is not None)
                    leaf.grad = buf             # autograd adds into it
                    ins.append(leaf)
                o1, o2 = run.fwd(tree_unflatten(run.paths, ins[:n_st]),
                                 tree_unflatten(run.sh_paths, ins[n_st:]),
                                 run.ctx, i, a, b)
                wrt = [a, b] + [t for t in ins if t.requires_grad]
                torch.autograd.backward((o1, o2), (c1, c2), inputs=wrt)
            c1 = a.grad if a.grad is not None else torch.zeros_like(x1)
            c2 = b.grad if b.grad is not None else torch.zeros_like(x2)
            y1, y2 = x1, x2
        return (None, None, c1, c2, *d_st, *d_sh)


def reversible_stack(block_fwd: Callable, block_inv: Callable, n_layers: int,
                     save_memory=True, half_inv: Callable = None,
                     idx_offset: int = 0):
    """Return apply(stacked_params, shared, ctx, x1, x2) -> (y1, y2).

    ``stacked_params``: nested dict whose leaves have leading dim n_layers.
    ``shared``: differentiable dict shared across layers (grads summed).
    ``ctx``: non-differentiable dict (positions).

    save_memory: True — paper mode, O(1) activations, fixed-point inversion
    in the backward; "half" — save stream-1 inputs, exact closed-form
    ``half_inv`` (x2 = y2 - G(y1)); False — plain loop, autograd keeps
    everything (the SFT baseline).
    """
    if isinstance(save_memory, (list, tuple)):
        raise NotImplementedError(
            "per-layer activation policy lists (store / remat / offload): "
            "not ported yet (ROADMAP.md queue 1)")

    def plain(stacked, shared, ctx, x1, x2):
        paths, leaves = _flatten(stacked)
        # unbind, not a[i]: its backward stacks the per-layer grads once
        # instead of adding a full-size zero-padded grad per layer
        layers = [torch.unbind(a, 0) for a in leaves]
        for j in range(n_layers):
            lp = tree_unflatten(paths, [ls[j] for ls in layers])
            x1, x2 = block_fwd(lp, shared, ctx, idx_offset + j, x1, x2)
        return x1, x2

    if save_memory is False:
        return plain
    if save_memory == "half":
        assert half_inv is not None, "half mode needs a half_inv callable"
    elif save_memory is not True:
        raise ValueError(f"save_memory must be True, 'half' or False, got "
                         f"{save_memory!r}")

    def apply(stacked, shared, ctx, x1, x2):
        paths, leaves = _flatten(stacked)
        sh_paths, sh_leaves = _flatten(shared)
        run = _Stack(block_fwd, block_inv, half_inv, n_layers, idx_offset,
                     ctx, paths, sh_paths)
        return _ReversibleFn.apply(run, save_memory == "half", x1, x2,
                                   *leaves, *sh_leaves)

    return apply


# ------------------------------------------------------------ diagnostics

def reconstruction_metrics(r1, r2, x1, x2):
    """Per-layer inversion quality: (max_abs, mean_abs, rel) error of the
    reconstructed streams (r1, r2) against the true inputs (x1, x2), as f32
    scalars; ``rel`` divides the max error by the true streams' max
    magnitude."""
    d1 = (r1.float() - x1.float()).abs()
    d2 = (r2.float() - x2.float()).abs()
    max_abs = torch.maximum(d1.max(), d2.max())
    mean_abs = (d1.sum() + d2.sum()) / (d1.numel() + d2.numel())
    scale = torch.maximum(x1.float().abs().max(), x2.float().abs().max())
    return max_abs, mean_abs, max_abs / (scale + 1e-12)


@torch.no_grad()
def inversion_errors(block_fwd, block_inv, stacked, shared, ctx, x1, x2,
                     n_layers: int, idx_offset: int = 0):
    """Walk a stack forward keeping each layer's true inputs, then invert
    from the outputs the way the backward does — layer i seeded with layer
    i+1's reconstructed, not true, inputs, so errors accumulate with depth.
    Returns one ``reconstruction_metrics`` triple per layer (floats)."""
    paths, leaves = _flatten(stacked)
    layer = lambda j: tree_unflatten(paths, [a[j] for a in leaves])  # noqa: E731
    ins = []
    for j in range(n_layers):
        ins.append((x1, x2))
        x1, x2 = block_fwd(layer(j), shared, ctx, idx_offset + j, x1, x2)
    out = [None] * n_layers
    for j in reversed(range(n_layers)):
        x1, x2 = block_inv(layer(j), shared, ctx, idx_offset + j, x1, x2)
        out[j] = tuple(float(m) for m in reconstruction_metrics(
            x1, x2, *ins[j]))
    return out


def split_streams(h):
    """H (B,S,d) -> X1, X2 (B,S,d/2) along features (paper §3.1)."""
    d = h.shape[-1]
    return h[..., : d // 2], h[..., d // 2:]


def merge_streams(y1, y2):
    return torch.cat([y1, y2], dim=-1)
