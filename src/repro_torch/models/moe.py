"""Mixture-of-Experts layer (port of ``repro.models.moe``): top-k router,
the sort-based dropless grouped backend, and the sigmoid-gated shared
expert.

Only ``moe_backend="grouped"`` is ported: stable sort by expert id, ragged
grouped GEMMs (the CUDA kernel on the card, the plain twin on the CPU),
gate-weighted f32 combine.  The einsum (capacity) backend and expert
parallelism raise ``NotImplementedError``.  Experts are zero-padded to a
multiple of 16 (EP_PAD); padded experts are masked to -1e30 in the router
and receive no tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec

EP_PAD = 16

MOE_BACKENDS = ("einsum", "grouped")


def padded_experts(num_experts: int) -> int:
    if num_experts >= EP_PAD:
        return int(math.ceil(num_experts / EP_PAD) * EP_PAD)
    return num_experts


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, ff = cfg.d_model, padded_experts(cfg.num_experts), cfg.d_ff_expert
    p = {
        "router": ParamSpec((d, e), ("embed", None), init="normal"),
        "w_gate": ParamSpec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((e, d, ff), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((e, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts > 0:
        ffs = cfg.num_shared_experts * cfg.d_ff_expert
        p["shared"] = {
            "w_gate": ParamSpec((d, ffs), ("embed", "mlp")),
            "w_up": ParamSpec((d, ffs), ("embed", "mlp")),
            "w_down": ParamSpec((ffs, d), ("mlp", "embed")),
            "gate": ParamSpec((d, 1), ("embed", None), init="zeros"),
        }
    return p


def _top_k(probs, k: int):
    """Top-k along the last axis with ties broken toward the lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` makes no such promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(p, cfg: ModelConfig, x):
    E = padded_experts(cfg.num_experts)
    logits = torch.matmul(x.float(), p["router"].float())
    if E > cfg.num_experts:  # mask padded experts
        pad_mask = torch.arange(E, device=x.device) < cfg.num_experts
        logits = torch.where(pad_mask, logits,
                             torch.full_like(logits, -1e30))
    return torch.softmax(logits, dim=-1)


def _route(p, cfg: ModelConfig, xf):
    """xf: (T, d) -> probs (T, E) f32, gate_vals (T, k) f32, expert_idx (T, k)."""
    probs = _router_probs(p, cfg, xf)
    gate_vals, expert_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_idx


def _switch_aux(cfg: ModelConfig, probs, expert_idx):
    """Global Switch load-balancing statistic of the grouped path."""
    E = padded_experts(cfg.num_experts)
    onehot = F.one_hot(expert_idx, E).float()
    frac = torch.mean(torch.sum(onehot, dim=1), dim=0)        # (E,)
    return (cfg.num_experts * torch.sum(frac * torch.mean(probs, dim=0))).float()


def _grouped_dispatch(p, cfg: ModelConfig, xf, probs, gate_vals, expert_idx):
    """Sort-based dropless dispatch.  Returns (y (T, d), aux scalar f32)."""
    from repro_torch.kernels.moe.ops import grouped_expert_ffn
    y = grouped_expert_ffn(xf, expert_idx, gate_vals.to(xf.dtype),
                           p["w_gate"], p["w_up"], p["w_down"])
    return y, _switch_aux(cfg, probs, expert_idx)


def _shared_expert(sh, x):
    hs = F.silu(torch.matmul(x, sh["w_gate"])) * torch.matmul(x, sh["w_up"])
    ys = torch.matmul(hs, sh["w_down"])
    return torch.sigmoid(torch.matmul(x, sh["gate"])), ys


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    backend = cfg.moe_backend
    assert backend in MOE_BACKENDS, backend
    if cfg.expert_parallel > 0:
        raise NotImplementedError(
            "expert parallelism: not ported yet (ROADMAP.md queue 1, "
            "multi-device)")
    if backend != "grouped":
        raise NotImplementedError(
            f"moe_backend={backend!r}: not ported yet — the port runs the "
            f"grouped backend only (ROADMAP.md queue 1)")
    xf = x.reshape(B * S, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xf)
    y, aux = _grouped_dispatch(p, cfg, xf, probs, gate_vals, expert_idx)
    y = y.reshape(B, S, d)
    if "shared" in p:
        sgate, ys = _shared_expert(p["shared"], x)
        y = y + sgate.to(y.dtype) * ys
    return y, aux


def moe_apply_oracle(p, cfg: ModelConfig, x):
    """Dense per-token oracle (every expert on every token); tests only."""
    E = padded_experts(cfg.num_experts)
    probs = _router_probs(p, cfg, x)
    gate_vals, expert_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    h = F.silu(torch.einsum("bsd,edf->bsef", x, p["w_gate"])) * \
        torch.einsum("bsd,edf->bsef", x, p["w_up"])
    out_all = torch.einsum("bsef,efd->bsed", h, p["w_down"])      # (B,S,E,d)
    sel = torch.sum(F.one_hot(expert_idx, E).float()
                    * gate_vals[..., None], dim=2)                 # (B,S,E)
    y = torch.einsum("bse,bsed->bsd", sel.to(x.dtype), out_all)
    if "shared" in p:
        sgate, ys = _shared_expert(p["shared"], x)
        y = y + sgate.to(y.dtype) * ys
    return y
