"""Reversible stream split/merge (port of ``repro.core.reversible``).

Serving runs only the coupled forward (y1 = x1 + F(x1, x2), then
y2 = x2 + G(y1)), written out in ``models.model``; the inverse, the
reversible ``autograd.Function`` and the mixed policies come with training.
"""
from __future__ import annotations

import torch


def split_streams(h):
    """H (B,S,d) -> X1, X2 (B,S,d/2) along features (paper §3.1)."""
    d = h.shape[-1]
    return h[..., : d // 2], h[..., d // 2:]


def merge_streams(y1, y2):
    return torch.cat([y1, y2], dim=-1)
