"""The dense/MoE and RWKV6 reversible models — port of
``repro.models.model``: the training path (reversible stack, chunked
cross-entropy loss) and, for dense/MoE, the serving paths (prefill against
a dense per-row KV buffer, decode against the paged KV pool).

Each layer is a reversible unit over the two feature streams (RevFFN):
y1 = x1 + F(x1, x2), then y2 = x2 + G(y1).  For dense/MoE, F is the
cross-branch attention (Q from stream 1, K/V from stream 2, through the
P_up/P_down adapters) and G the MoE (or MLP) block; the inverse runs
``inverse_fp_iters`` fixed-point iterations for F.  For RWKV6 (family
"ssm"), F is the time mix of stream 2 alone and G the channel mix, so the
inverse is closed-form; its decode paths are not ported yet.

The param tree keeps the reference's key paths and stacked leading (L, ...)
dims, so weights cross between the packages by path
(``repro_torch.interop``); the reference's layer ``scan`` is a Python loop
over layer slices.  The other families, per-layer activation policies,
lean layer groups and fold_adapters are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import devices
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapters as ad
from repro_torch.core.reversible import (make_coupled, merge_streams,
                                         reversible_stack, split_streams)
from repro_torch.models import common, moe as moe_lib, spec, ssm as ssm_lib
from repro_torch.models.common import (attention, attention_decode,
                                       attn_specs, init_kv_cache,
                                       lm_head_logits, mlp, mlp_specs,
                                       norm_spec, rms_norm)
from repro_torch.models.spec import ParamSpec


@dataclasses.dataclass
class StackDef:
    name: str
    n: int
    unit_specs: Any
    fwd: Callable             # (lp, sh, ctx, i, x1, x2) -> (y1, y2)
    inv: Callable             # its inverse
    half_inv: Callable        # exact x2 = y2 - G(y1) (semi-reversible)
    decode: Callable          # (lp, sh, ctx, i, x1, x2, cache) -> ((y1,y2), cache)
    cache_init: Callable      # (B, buf, dtype, device) -> unit cache
    decode_paged: Callable    # (lp, sh, ctx, i, x1, x2, pool, pt, wmask) -> ((y1,y2), pool)
    pool_init: Callable       # (n_pages, page_size, dtype, device) -> unit pool
    role: str = "main"


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param/cache tree (views, no copies)."""
    return spec.tree_map(lambda a: a[i], tree)


def _stack_layers(tree, n: int):
    """One unit's cache/pool tree repeated on a new leading layer axis."""
    return spec.tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.ndim),
                         tree)


# ===================================================================== blocks

def _normed(cfg: ModelConfig, x, scale):
    """rms_norm of a stream, in the model dtype: the train path's streams
    are f64 (``Model._embed_streams``), the blocks compute in cfg.dtype."""
    return rms_norm(x, scale, cfg.norm_eps).to(devices.torch_dtype(cfg.dtype))


def _attn_in(cfg: ModelConfig, lp, x1, x2):
    q_in = ad.up(lp["attn_ad"], _normed(cfg, x1, lp["norm1"]))
    kv_in = ad.up(lp["attn_ad"], _normed(cfg, x2, lp["norm2"]))
    return q_in, kv_in


def _attn_F(cfg: ModelConfig):
    """Paper Eq. 1: cross-branch attention residual (Q from x1, K/V from x2),
    causal."""
    def F(p, sh, ctx, i, x1, x2):
        q_in, kv_in = _attn_in(cfg, p, x1, x2)
        att = attention(p["attn"], cfg, q_in, kv_in,
                        positions_q=ctx["positions"],
                        positions_k=ctx["positions"], causal=True)
        return ad.down(p["attn_ad"], att)
    return F


def _mlp_G(cfg: ModelConfig):
    """Paper Eq. 2: FFN driven by the updated left stream."""
    def G(p, sh, ctx, i, y1, _y2=None):
        h = _normed(cfg, y1, p["norm_mlp"])
        return ad.down(p["mlp_ad"], mlp(p["mlp"], ad.up(p["mlp_ad"], h)))
    return G


def _moe_G(cfg: ModelConfig):
    def G(p, sh, ctx, i, y1, _y2=None):
        h = ad.up(p["mlp_ad"], _normed(cfg, y1, p["norm_mlp"]))
        y, _aux = moe_lib.moe_apply(p["moe"], cfg, h)
        return ad.down(p["mlp_ad"], y)
    return G


def _dense_sub_specs(cfg: ModelConfig, use_moe: bool = False) -> dict:
    half = cfg.stream_dim
    sp = {
        "norm1": norm_spec(half),
        "norm2": norm_spec(half),
        "attn_ad": ad.adapter_specs(cfg.d_model),
        "attn": attn_specs(cfg),
        "norm_mlp": norm_spec(half),
        "mlp_ad": ad.adapter_specs(cfg.d_model),
    }
    if use_moe:
        sp["moe"] = moe_lib.moe_specs(cfg)
    else:
        sp["mlp"] = mlp_specs(cfg)
    return sp


def build_dense(cfg: ModelConfig, use_moe: bool = False):
    if cfg.sliding_window is not None or cfg.local_global:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window / local-global attention is not "
            f"ported yet (ROADMAP.md queue 1)")
    G = _moe_G(cfg) if use_moe else _mlp_G(cfg)
    fwd, inv = make_coupled(_attn_F(cfg), G, mode=cfg.coupling,
                            fp_iters=cfg.inverse_fp_iters)

    def half_inv(lp, sh, ctx, i, x1, y1, y2):
        return y2 - G(lp, sh, ctx, i, y1)

    def decode(lp, sh, ctx, i, x1, x2, cu):
        q_in, kv_in = _attn_in(cfg, lp, x1, x2)
        att, nkv = attention_decode(lp["attn"], cfg, q_in, kv_in, cu["kv"],
                                    ctx["t"])
        y1 = x1 + ad.down(lp["attn_ad"], att)
        y2 = x2 + G(lp, sh, ctx, i, y1)
        return (y1, y2), {"kv": nkv}

    def cache_init(B, buf, dtype, device):
        return {"kv": init_kv_cache(cfg, B, buf, dtype, device)}

    def decode_paged(lp, sh, ctx, i, x1, x2, pu, pt, wmask):
        q_in, kv_in = _attn_in(cfg, lp, x1, x2)
        att, npu = common.attention_decode_paged(
            lp["attn"], cfg, q_in, kv_in, pu["kv"], pt, ctx["t"],
            write_mask=wmask, kv_len=ctx["kv_len"])
        y1 = x1 + ad.down(lp["attn_ad"], att)
        y2 = x2 + G(lp, sh, ctx, i, y1)
        return (y1, y2), {"kv": npu}

    def pool_init(n_pages, page_size, dtype, device):
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        return {"kv": {
            "k": torch.zeros((n_pages, page_size, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((n_pages, page_size, KV, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                              device=device)}}

    return [StackDef("layers", cfg.num_layers, _dense_sub_specs(cfg, use_moe),
                     fwd, inv, half_inv, decode, cache_init, decode_paged,
                     pool_init)], {}


def build_moe(cfg: ModelConfig):
    return build_dense(cfg, use_moe=True)


def _rwkv_serving(what: str):
    def not_ported(*_args, **_kw):
        raise NotImplementedError(
            f"rwkv6 {what}: not ported yet — recurrent decode needs the dense "
            f"engine mode (ROADMAP.md queue 1, item 1)")
    return not_ported


def build_rwkv(cfg: ModelConfig):
    """RWKV6 as a reversible unit, coupled in the "standard" mode: F, the
    time mix, reads stream 2 only, so the inverse is closed-form."""
    d = cfg.d_model

    def F(p, sh, ctx, i, x1, x2):           # token mix reads stream 2 only
        h = ad.up(p["attn_ad"], _normed(cfg, x2, p["norm2"]))
        return ad.down(p["attn_ad"], ssm_lib.rwkv_time_apply(p["time"], cfg, h))

    def G(p, sh, ctx, i, y1, _y2=None):     # channel mix driven by stream 1
        h = ad.up(p["mlp_ad"], _normed(cfg, y1, p["norm_mlp"]))
        return ad.down(p["mlp_ad"],
                       ssm_lib.rwkv_channel_apply(p["chan"], cfg, h))

    fwd, inv = make_coupled(F, G, mode="standard")
    sp = {
        "norm2": norm_spec(cfg.stream_dim),
        "attn_ad": ad.adapter_specs(d),
        "time": ssm_lib.rwkv_time_specs(cfg),
        "norm_mlp": norm_spec(cfg.stream_dim),
        "mlp_ad": ad.adapter_specs(d),
        "chan": ssm_lib.rwkv_channel_specs(cfg),
    }

    def half_inv(lp, sh, ctx, i, x1, y1, y2):
        return y2 - G(lp, sh, ctx, i, y1)

    return [StackDef("layers", cfg.num_layers, sp, fwd, inv, half_inv,
                     _rwkv_serving("decode"), _rwkv_serving("cache_init"),
                     _rwkv_serving("paged decode"),
                     _rwkv_serving("page pool"))], {}


_BUILDERS = {"dense": build_dense, "moe": build_moe, "ssm": build_rwkv}


# ===================================================================== model

class Model(nn.Module):
    """A config's param specs, its training loss and its decode entry
    points.

    Parameters live in a plain nested dict (the reference's pytree layout)
    that ``init`` returns and every entry point takes first, so weights from
    the JAX package cross unchanged.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        assert cfg.moe_backend in moe_lib.MOE_BACKENDS, (
            f"unknown moe_backend {cfg.moe_backend!r}; "
            f"known: {moe_lib.MOE_BACKENDS}")
        if cfg.family not in _BUILDERS:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                f"(ROADMAP.md queue 1, 'Other families')")
        if cfg.num_layer_groups or cfg.fold_adapters or not cfg.reversible:
            raise NotImplementedError(
                f"{cfg.name}: lean layer groups, fold_adapters and the "
                f"standard (non-reversible) path are not ported yet")
        if cfg.expert_parallel > 0:
            raise NotImplementedError(
                "expert parallelism: not ported yet (ROADMAP.md queue 1)")
        self.cfg = cfg
        self.stacks, self.shared_specs = _BUILDERS[cfg.family](cfg)
        d = cfg.d_model
        self.top_specs = {
            "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                               init="unit_normal"),
            "final_norm": norm_spec(d),
            "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab")),
        }

    # ------------------------------------------------------------- specs

    def param_specs(self):
        out = dict(self.top_specs)
        out["stacks"] = {s.name: spec.stack(s.n, s.unit_specs)
                         for s in self.stacks}
        return out

    def init(self, generator: torch.Generator, device="cuda"):
        """Random weights drawn from ``generator`` (which lives on
        ``device``).  Defaults to the card; raises when there is none and the
        CPU was not asked for."""
        return spec.initialize(self.param_specs(), generator,
                               devices.resolve(device), self.cfg.dtype)

    def num_params(self) -> int:
        return spec.count_params(self.param_specs())

    @property
    def dtype(self) -> torch.dtype:
        return devices.torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------ forward

    def _embed_streams(self, params, tokens):
        """The train path's two streams, in f64 whatever the model dtype;
        the blocks still compute in the model dtype (``_normed``).

        A layer's inverse subtracts what its forward added, and both round.
        In bf16 that leaves about one ulp of the stream per layer; in f32
        the reconstructed stream is off by an f32 ulp, which now and then
        flips a block input's bf16 rounding, and the flip grows through the
        layers below.  At rwkv6-3b's 32 layers the grads then leave those
        of stored activations (smallest cosine 0.38 with bf16 streams, 0.95
        with f32; PERF.md).  An f64 stream is off by an f64 ulp, far below
        any f32 or bf16 rounding of a block's input, so the inverse
        rebuilds every block input exactly."""
        B, S = tokens.shape
        h = params["embed"][tokens].double()
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        x1, x2 = split_streams(h)
        return x1, x2, {"positions": positions}

    def hidden_streams(self, params, tokens, save_memory=True):
        """The main stacks' output streams (y1, y2) for tokens (B, S).

        ``save_memory``: True (paper O(1) mode), "half" or False (plain
        loop, every activation kept); a per-layer policy list raises "not
        ported yet"."""
        x1, x2, ctx = self._embed_streams(params, tokens)
        shared = dict(params.get("shared", {}))
        for s in self.stacks:
            apply = reversible_stack(s.fwd, s.inv, s.n,
                                     save_memory=save_memory,
                                     half_inv=s.half_inv)
            x1, x2 = apply(params["stacks"][s.name], shared, ctx, x1, x2)
        return x1, x2

    def hidden(self, params, tokens, extras=None, save_memory=True):
        """Final-normed hidden states (B, S, d) — everything before the LM
        head."""
        if extras:
            raise NotImplementedError(
                "encoder / image extras: not ported yet (ROADMAP.md queue 1)")
        y1, y2 = self.hidden_streams(params, tokens, save_memory)
        return self._final_norm(params, y1, y2)

    def forward(self, params, tokens, extras=None, save_memory=True):
        return self.lm_logits(params,
                              self.hidden(params, tokens, extras, save_memory))

    def _nll(self, lm_head, h, tgt):
        """Per-position nll from final hidden states (chunk-sized)."""
        lg = lm_head_logits(h, lm_head, self.cfg.final_softcap).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None].long())[..., 0]
        return lse - gold

    def loss(self, params, batch, save_memory=True):
        """Next-token cross-entropy.  batch: tokens (B, S) [+ loss_mask].
        Sequence-chunked so the full (B, S, vocab) logits never
        materialise."""
        h = self.hidden(params, batch["tokens"], None, save_memory)
        return self._token_loss(params, h, batch)

    def loss_from_streams(self, params, y1, y2, batch):
        """Tail of ``loss`` from the main stacks' output streams: final norm
        + LM head + token CE."""
        return self._token_loss(params, self._final_norm(params, y1, y2),
                                batch)

    def _final_norm(self, params, y1, y2):
        """Final norm of the merged streams, in the model dtype."""
        return _normed(self.cfg, merge_streams(y1, y2), params["final_norm"])

    def _token_loss(self, params, h, batch):
        """Masked, sequence-chunked CE from final-normed hidden states.  Each
        chunk's body is checkpointed: otherwise autograd keeps every chunk's
        f32 logits, the whole (B, S, vocab) the chunking exists to avoid."""
        tokens = batch["tokens"]
        B, S, _ = h.shape
        tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)  # last: dummy
        valid = torch.ones((B, S), dtype=torch.float32, device=h.device)
        valid[:, -1] = 0.0
        mask = batch.get("loss_mask")
        if mask is not None:
            valid = valid * torch.cat([mask[:, 1:], mask[:, :1]],
                                      dim=1).float()
        ck = self.cfg.loss_chunk
        w = params["lm_head"]
        if ck and S > ck and S % ck == 0:
            nll = torch.cat([
                checkpoint(self._nll, w, h[:, c:c + ck], tgt[:, c:c + ck],
                           use_reentrant=False)
                for c in range(0, S, ck)], dim=1)
        else:
            nll = self._nll(w, h, tgt)
        return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)

    # ------------------------------------------------------------- decode

    def init_cache(self, params, batch_size: int, buf_len: int):
        """Dense per-row decode caches, stacked per layer:
        {"t": (B,), "layers": {"kv": {"k"/"v": (L, B, C, KV, hd),
        "pos": (L, B, C)}}}."""
        dev = params["embed"].device
        caches = {"t": torch.zeros((batch_size,), dtype=torch.int32,
                                   device=dev)}
        for s in self.stacks:
            caches[s.name] = _stack_layers(
                s.cache_init(batch_size, buf_len, self.dtype, dev), s.n)
        return caches

    def _walk(self, params, x1, x2, step):
        shared = dict(params.get("shared", {}))
        for s in self.stacks:
            stacked = params["stacks"][s.name]
            for i in range(s.n):
                x1, x2 = step(s, _layer(stacked, i), shared, i, x1, x2)
        return x1, x2

    def decode_step_hidden(self, params, cache, token):
        """Prefill/decode step up to the final norm.  token: (B, Sq); row b
        starts at position cache["t"][b].  The cache is updated in place and
        its ``t`` advanced by Sq.  Returns (h (B, Sq, d), cache)."""
        t = cache["t"]
        h = params["embed"][token]
        ctx = {"t": t}
        x1, x2 = split_streams(h)

        def step(s, lp, shared, i, x1, x2):
            (y1, y2), _ = s.decode(lp, shared, ctx, i, x1, x2,
                                   _layer(cache[s.name], i))
            return y1, y2

        x1, x2 = self._walk(params, x1, x2, step)
        cache["t"] = t + token.shape[1]
        h = self._final_norm(params, x1, x2)
        return h, cache

    # ------------------------------------------------------- paged decode

    def paged_supported(self) -> bool:
        main = [s for s in self.stacks if s.role == "main"]
        return bool(main) and all(s.decode_paged is not None
                                  and s.pool_init is not None for s in main)

    def init_kv_pool(self, n_pages: int, page_size: int, device="cuda"):
        """Paged KV storage: per main stack, pool leaves with a leading layer
        axis — k/v (L, P, page, KV, hd) and stored positions (L, P, page)."""
        if not self.paged_supported():
            raise ValueError(f"config {self.cfg.name} has no paged KV layout")
        dev = devices.resolve(device)
        pools = {}
        for s in self.stacks:
            pools[s.name] = _stack_layers(
                s.pool_init(n_pages, page_size, self.dtype, dev), s.n)
        return pools

    def decode_step_hidden_paged(self, params, pools, page_tables, t, token,
                                 write_mask, *, kv_len: int):
        """One decode step against the paged KV pool.  token: (B, 1); t: (B,)
        per-slot positions; page_tables: (B, n_pages) int32; write_mask: (B,)
        bool — rows not selected write nothing.  The pools are updated in
        place.  Returns (h (B, 1, d), pools)."""
        B, Sq = token.shape
        assert Sq == 1, "paged decode is single-position"
        h = params["embed"][token]
        ctx = {"t": t, "kv_len": kv_len}
        x1, x2 = split_streams(h)

        def step(s, lp, shared, i, x1, x2):
            (y1, y2), _ = s.decode_paged(lp, shared, ctx, i, x1, x2,
                                         _layer(pools[s.name], i),
                                         page_tables, write_mask)
            return y1, y2

        x1, x2 = self._walk(params, x1, x2, step)
        h = self._final_norm(params, x1, x2)
        return h, pools

    def lm_logits(self, params, h):
        """LM-head logits from final-normed hidden states (any leading shape)."""
        return lm_head_logits(h, params["lm_head"], self.cfg.final_softcap)
