"""RevFFN projection adapters (paper §3.2; port of ``repro.core.adapters``).

P_up (d/2 -> d) before a pre-trained block, P_down (d -> d/2) after it, so
all heavy compute stays in the original d-dim space.  The PEFT baselines
(LoRA / DoRA / IA3) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.spec import ParamSpec


def adapter_specs(d_model: int) -> dict:
    half = d_model // 2
    return {
        "p_up": ParamSpec((half, d_model), ("stream", "embed")),
        # small init => reversible block starts near identity (stable warm-up)
        "p_down": ParamSpec((d_model, half), ("embed", "stream"), init="small"),
    }


def up(p, x):
    return torch.matmul(x, p["p_up"])


def down(p, x):
    return torch.matmul(x, p["p_down"])
