"""Linear-recurrence token mixers: the RWKV6 half of ``repro.models.ssm``
(time mix and channel mix).  The Mamba2 half is not ported yet.

RWKV6 has a per-channel, data-dependent decay.  ``rwkv_time_apply`` has the
reference's two branches: with ``cfg.use_flash_kernel``, a whole sequence
whose length is a multiple of 64 and no carried state, the wkv recurrence
goes through ``kernels.rwkv6_scan`` (the CUDA kernel on the card, its twin on
the CPU); otherwise the plain branch runs the chunked twin directly, with a
carried state and the final state returned when asked (the reference's
plain branch is a token-by-token scan; the chunked form computes the same
recurrence).  Every cast is the reference's: bf16 projections cast to f32
for r/k/v, the decay LoRA in f32, the per-head group norm with eps 64e-5 in
f32, the output cast to x's dtype before the gate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.models.spec import ParamSpec

#: the kernel branch's chunk; the reference takes it for S % 64 == 0
KERNEL_CHUNK = 64
GROUP_NORM_EPS = 64e-5


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size or 64
    H = cfg.d_model // hd
    return H, hd


def rwkv_dims_for(d: int, cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size or 64
    hd = min(hd, d)
    H = d // hd
    return H, hd


def rwkv_time_specs(cfg: ModelConfig, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    H, hd = rwkv_dims_for(d, cfg)
    return {
        "mu": ParamSpec((5, d), (None, "embed"), init="small"),   # r,k,v,w,g mixes
        "w_r": ParamSpec((d, d), ("embed", "heads")),
        "w_k": ParamSpec((d, d), ("embed", "heads")),
        "w_v": ParamSpec((d, d), ("embed", "heads")),
        "w_g": ParamSpec((d, d), ("embed", "heads")),
        "w_o": ParamSpec((d, d), ("heads", "embed")),
        "decay_base": ParamSpec((d,), ("heads",), init="zeros"),
        "decay_a": ParamSpec((d, 64), ("embed", None), init="small"),
        "decay_b": ParamSpec((64, d), (None, "heads"), init="zeros"),
        "u": ParamSpec((H, hd), (None, None), init="zeros"),
        "ln": ParamSpec((d,), ("heads",), init="zeros"),
    }


def rwkv_channel_specs(cfg: ModelConfig, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    ff = cfg.d_ff
    return {
        "mu": ParamSpec((2, d), (None, "embed"), init="small"),   # k, r mixes
        "w_k": ParamSpec((d, ff), ("embed", "mlp")),
        "w_v": ParamSpec((ff, d), ("mlp", "embed")),
        "w_r": ParamSpec((d, d), ("embed", "embed_out")),
    }


def _token_shift(x, last_x=None):
    B, S, d = x.shape
    if last_x is None:
        last_x = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    return torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm_out(p, o, g, x):
    """Per-head group norm of o (B, S, H, hd) f32, the ln scale, the cast to
    x's dtype, the gate and the output projection."""
    B, S, d = x.shape
    var = torch.mean(o * o, dim=-1, keepdim=True)
    o = o * torch.rsqrt(var + GROUP_NORM_EPS)
    o = o.reshape(B, S, d) * (1.0 + p["ln"].float())[None, None]
    return torch.matmul(o.to(x.dtype) * g, p["w_o"])


def rwkv_time_apply(p, cfg: ModelConfig, x, state=None, last_x=None,
                    return_state: bool = False):
    """RWKV6 time mix.  x: (B, S, d).  state: (B, H, hd, hd) [key x value].
    With ``return_state`` returns (out, final state, x[:, -1])."""
    B, S, d = x.shape
    H, hd = rwkv_dims_for(d, cfg)

    xs = _token_shift(x, last_x)
    mix = x[:, :, None, :] + p["mu"][None, None] * (xs - x)[:, :, None, :]
    xr, xk, xv, xw, xg = [mix[:, :, i, :] for i in range(5)]

    r = torch.matmul(xr, p["w_r"]).reshape(B, S, H, hd).float()
    k = torch.matmul(xk, p["w_k"]).reshape(B, S, H, hd).float()
    v = torch.matmul(xv, p["w_v"]).reshape(B, S, H, hd).float()
    g = F.silu(torch.matmul(xg, p["w_g"]))

    dlora = torch.matmul(torch.tanh(torch.matmul(xw.float(),
                                                 p["decay_a"].float())),
                         p["decay_b"].float())
    log_w = -torch.exp(p["decay_base"].float()[None, None] + dlora)
    w = torch.exp(log_w).reshape(B, S, H, hd)                   # in (0, 1)
    u = p["u"].float()
    heads = lambda a: a.transpose(1, 2)                         # noqa: E731

    if (cfg.use_flash_kernel and state is None and last_x is None
            and not return_state and S % KERNEL_CHUNK == 0 and S >= KERNEL_CHUNK):
        o = wkv.rwkv6_scan_trainable(heads(r), heads(k), heads(v), heads(w), u,
                                     chunk=KERNEL_CHUNK)
        return _group_norm_out(p, heads(o), g, x)

    # plain branch: pad to whole chunks with k = v = 0 and w = 1, which
    # leaves the outputs before the pad and the final state unchanged
    T = min(KERNEL_CHUNK, S)
    pad = (-S) % T
    if pad:
        padded = lambda a, val: torch.cat([a, torch.full(            # noqa: E731
            (B, pad, H, hd), val, dtype=a.dtype, device=a.device)], dim=1)
        r, k, v, w = (padded(r, 0.0), padded(k, 0.0), padded(v, 0.0),
                      padded(w, 1.0))
    o, final_state = wkv.rwkv6_scan_ref(heads(r), heads(k), heads(v), heads(w),
                                        u, state=state, chunk=T)
    out = _group_norm_out(p, heads(o)[:, :S], g, x)
    if return_state:
        return out, final_state, x[:, -1, :]
    return out


def rwkv_channel_apply(p, cfg: ModelConfig, x, last_x=None,
                       return_state: bool = False):
    xs = _token_shift(x, last_x)
    mk = x + p["mu"][0][None, None] * (xs - x)
    mr = x + p["mu"][1][None, None] * (xs - x)
    kk = torch.square(torch.relu(torch.matmul(mk, p["w_k"])))
    out = torch.sigmoid(torch.matmul(mr, p["w_r"])) * torch.matmul(kk, p["w_v"])
    if return_state:
        return out, x[:, -1, :]
    return out
