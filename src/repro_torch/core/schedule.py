"""Two-stage training schedule (paper §3.3; port of
``repro.core.schedule``).

Stage 1 (adapter warm-up): freeze all pre-trained weights; train only the
projection adapters P_up / P_down and the new reversible-stream norm
scales.  Stage 2 (joint fine-tuning): unfreeze everything EXCEPT the MoE
routers.

Masks are nested dicts of 0.0 / 1.0 matching the param tree, chosen by key
path; the optimizer multiplies updates by them, so frozen leaves keep
exactly their values (their moments still move, as in the reference).
"""
from __future__ import annotations

ADAPTER_KEYS = ("p_up", "p_down", "norm1", "norm2", "norm_mlp", "norm_cross")
ROUTER_KEYS = ("router",)


def _mask_tree(params, predicate, path=()):
    if isinstance(params, dict):
        return {k: _mask_tree(v, predicate, path + (k,))
                for k, v in params.items()}
    return 1.0 if predicate(path) else 0.0


def stage1_mask(params):
    """Trainable: adapters + new stream norms only."""
    return _mask_tree(params, lambda ks: any(k in ADAPTER_KEYS for k in ks))


def stage2_mask(params):
    """Trainable: everything except MoE routers."""
    return _mask_tree(params, lambda ks: not any(k in ROUTER_KEYS for k in ks))
