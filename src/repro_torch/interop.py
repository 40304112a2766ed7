"""Move parameter trees between numpy (what the JAX package hands out) and
the port, by key path.

bf16 crosses as a uint16 bit view — the same convention as the reference
checkpoint format (``step_N/procK.npz`` stores bf16 leaves as uint16): a
numpy array whose dtype is named ``bfloat16`` (the ml_dtypes type JAX
returns) or is ``uint16`` becomes a ``torch.bfloat16`` tensor bit for bit,
and ``to_numpy_tree`` returns bf16 tensors as uint16 arrays.  No model
parameter is uint16, so the two never collide.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.spec import tree_map


def _is_bf16_bits(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or arr.dtype == np.uint16


def _leaf_to_torch(arr, device, dtype: Optional[torch.dtype]):
    arr = np.asarray(arr)
    if _is_bf16_bits(arr):
        arr = arr.view(np.uint16)
    # own writable memory: arrays handed out by JAX are read-only views
    arr = np.array(arr, order="C", copy=True)
    t = torch.from_numpy(arr)
    if arr.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """numpy (or array-like) nested dict -> torch tensors on ``device``.
    Floating leaves are cast to ``dtype`` when it is given."""
    return tree_map(lambda a: _leaf_to_torch(a, device, dtype), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy_tree(tree):
    """torch nested dict -> numpy arrays (bf16 as uint16 bit views)."""
    return tree_map(_leaf_to_numpy, tree)
