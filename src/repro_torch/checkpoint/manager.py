"""Preemption-safe checkpointing (port of ``repro.checkpoint.manager``),
in the reference's on-disk format so a checkpoint written by either package
restores in the other.

Layout:  <dir>/step_<N>/proc<k>.npz  +  <dir>/step_<N>/META.json
The npz holds one array per leaf, ``a0`` .. ``a<n-1>``, in the leaf order
of ``jax.tree_util.tree_flatten`` (tuples and lists in order, dict keys
sorted); bf16 leaves are stored as their uint16 bits and named "bfloat16"
in META's ``dtypes``.  Writes go to ``step_<N>.tmp`` then ``os.replace`` ->
atomic publish; ``latest_step`` scans published directories, so a restart
after a kill resumes from the last complete save.  The asynchronous
checkpointer and multi-host shards are not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop


def _flatten(tree):
    """Leaves in jax.tree_util order, and a rebuild function."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (fl, rb) in zip(keys, parts):
                out[k] = rb(leaves[i:i + len(fl)])
                i += len(fl)
            return out
    elif isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]

        def rebuild(leaves):
            out, i = [], 0
            for fl, rb in parts:
                out.append(rb(leaves[i:i + len(fl)]))
                i += len(fl)
            return type(tree)(out)
    else:
        return [tree], lambda leaves: leaves[0]
    return [x for fl, _ in parts for x in fl], rebuild


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         process_index: int = 0, extra_meta: Optional[dict] = None):
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, _ = _flatten(tree)
    arrays, dtypes = {}, []
    for i, x in enumerate(flat):
        if isinstance(x, torch.Tensor):
            dtypes.append(str(x.dtype).replace("torch.", ""))
            arr = interop.to_numpy_tree(x)          # bf16 -> uint16 bits
        else:
            arr = np.asarray(x)
            dtypes.append(str(arr.dtype))
        arrays[f"a{i}"] = arr
    np.savez(os.path.join(tmp, f"proc{process_index}.npz"), **arrays)
    meta = {"step": step, "n_leaves": len(flat), "dtypes": dtypes,
            "layouts": None}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(tmp, "META.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    entries = os.listdir(ckpt_dir)
    # stale .tmp dirs are left by a crash between makedirs and os.replace;
    # the current save's tmp was already published, so these are orphans
    for d in entries:
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    steps = sorted(d for d in entries
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "META.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            process_index: int = 0) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes the dtype and device of its ``like`` leaf.  Raises on a leaf
    count or shape that does not match, and on a checkpoint that declares a
    lean layer-group layout (not ported yet)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(d, f"proc{process_index}.npz"))
    with open(os.path.join(d, "META.json")) as f:
        meta = json.load(f)
    if any(v is not None for v in (meta.get("layouts") or {}).values()):
        raise ValueError(
            f"checkpoint {d} was saved under layer->group map "
            f"{meta['layouts']}: lean layer groups are not ported yet, so "
            f"it has no restore target here")
    dtypes = meta.get("dtypes")
    flat, rebuild = _flatten(like)
    n_saved = meta.get("n_leaves", len(flat))
    if n_saved != len(flat):
        raise ValueError(
            f"checkpoint {d} holds {n_saved} leaves but the restore target "
            f"has {len(flat)}: the saved tree does not match the current "
            f"structure (another optimizer's state, or another model "
            f"config) — restore with what the checkpoint was written with, "
            f"or restart from scratch.")
    leaves = []
    for i, x in enumerate(flat):
        arr = data[f"a{i}"]
        if dtypes and dtypes[i] == "bfloat16":
            arr = arr.view(np.uint16)
        if tuple(arr.shape) != tuple(x.shape):
            raise ValueError(
                f"checkpoint {d} leaf {i} has shape {tuple(arr.shape)} but "
                f"the restore target expects {tuple(x.shape)}: the saved "
                f"tree does not match the current structure (optimizer-state "
                f"layout or model config mismatch).")
        t = interop.from_numpy_tree(arr, x.device)
        leaves.append(t.to(x.dtype))
    return rebuild(leaves), step
