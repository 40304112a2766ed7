"""Shared model components (port of ``repro.models.common``): norms, RoPE,
GQA attention on the training path (flash kernels or the q-chunked plain
branch), GQA decode attention over a dense KV buffer and over the paged
pool, LM head, SwiGLU MLP.

Every function keeps the reference's dtype at each step: ``rms_norm`` works
in f32, attention scores are f32 and the probabilities are cast to V's dtype
before P·V.  The reference's ``attention_decode`` takes a scalar ``t`` and is
vmapped over slots; here ``t`` is a per-row (B,) tensor and the slot axis is
written out.  KV buffers and pools are updated in place (the reference
returns fresh arrays); callers own them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec

NEG_INF = -1e30


def _not_ported(what: str):
    return NotImplementedError(
        f"{what}: not ported yet (ROADMAP.md queue 1)")


# ---------------------------------------------------------------- norms

def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def norm_spec(dim: int) -> ParamSpec:
    # zero-init: rms_norm uses (1 + scale) so this is identity-scale at init
    return ParamSpec((dim,), (None,), init="zeros")


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=None)
def _log_f32(theta: float) -> float:
    """log(theta) rounded as the reference's f32 ``jnp.log(theta)``."""
    return float(torch.log(torch.tensor(theta, dtype=torch.float32)))


def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-_log_f32(theta) * ar / half)
    ang = positions[..., None].float() * freqs               # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def attn_specs(cfg: ModelConfig) -> dict:
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": ParamSpec((d, q_dim), ("embed", "heads")),
        "wk": ParamSpec((d, kv_dim), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kv_dim), ("embed", "kv_heads")),
        "wo": ParamSpec((q_dim, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((q_dim,), ("heads",), init="zeros")
        p["bk"] = ParamSpec((kv_dim,), ("kv_heads",), init="zeros")
        p["bv"] = ParamSpec((kv_dim,), ("kv_heads",), init="zeros")
    return p


def _proj(x, w, b=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _qkv(p, cfg: ModelConfig, xq, xkv, pos_q):
    B, Sq, _ = xq.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(xq, p["wq"], p.get("bq")).reshape(B, Sq, H, hd)
    k = _proj(xkv, p["wk"], p.get("bk")).reshape(B, Sq, KV, hd)
    v = _proj(xkv, p["wv"], p.get("bv")).reshape(B, Sq, KV, hd)
    return rope(q, pos_q, cfg.rope_theta), rope(k, pos_q, cfg.rope_theta), v


# ------------------------------------------------------ train-path attention

def attention(p, cfg: ModelConfig, xq, xkv, *, positions_q, positions_k,
              causal: bool = True, window: Optional[int] = None):
    """GQA self/cross-branch attention over whole sequences (the
    reference's cache-free path).  xq: (B, Sq, d), xkv: (B, Skv, d).

    With ``cfg.use_flash_kernel`` and Sq, Skv multiples of the flash blocks
    this is the flash branch (``kernels.flash_attention``: the CUDA kernels
    on the card, their twins on the CPU), which like the reference's assumes
    positions 0..S-1.  Otherwise the plain branch: f32 scores, softmax cast
    to V's dtype, chunked over ``cfg.attn_q_chunk`` query rows so the full
    Sq x Skv score matrix never materialises.
    """
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(xq, p["wq"], p.get("bq")).reshape(B, Sq, H, hd)
    k = _proj(xkv, p["wk"], p.get("bk")).reshape(B, Skv, KV, hd)
    v = _proj(xkv, p["wv"], p.get("bv")).reshape(B, Skv, KV, hd)
    q = rope(q, positions_q, cfg.rope_theta)
    k = rope(k, positions_k, cfg.rope_theta)

    if cfg.use_flash_kernel:
        bq = min(cfg.flash_block_q, Sq)
        bk = min(cfg.flash_block_k, Skv)
        if Sq % bq == 0 and Skv % bk == 0:
            from repro_torch.kernels.flash_attention import (
                flash_attention_trainable)
            out = flash_attention_trainable(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal, window, cfg.logit_softcap, cfg.flash_block_q,
                cfg.flash_block_k)
            out = out.transpose(1, 2).reshape(B, Sq, H * hd)
            return torch.matmul(out, p["wo"])

    G = H // KV
    kf = k.float()

    def attend(q_blk, pos_q_blk):
        n = q_blk.shape[1]
        qg = q_blk.reshape(B, n, KV, G, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), kf) * hd ** -0.5
        scores = softcap(scores, cfg.logit_softcap)
        pq = pos_q_blk[:, None, None, :, None]
        pk = positions_k[:, None, None, None, :]
        mask = torch.ones_like(scores, dtype=torch.bool)
        if causal:
            mask = mask & (pq >= pk)
        if window is not None:
            mask = mask & ((pq - pk) < window)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(
            B, n, H * hd)

    qc = cfg.attn_q_chunk
    if qc and Sq > qc and Sq % qc == 0:
        out = torch.cat([attend(q[:, c:c + qc], positions_q[:, c:c + qc])
                         for c in range(0, Sq, qc)], dim=1)
    else:
        out = attend(q, positions_q)
    return torch.matmul(out, p["wo"])


# ------------------------------------------------------- decode-path attention

def init_kv_cache(cfg: ModelConfig, batch: int, buf_len: int,
                  dtype=torch.bfloat16, device="cpu"):
    """Dense per-row KV buffer.  Unlike the reference (one ``pos`` row shared
    by a batch that moves in lockstep), ``pos`` is per row: (B, C)."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, buf_len, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, buf_len, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, buf_len), -1, dtype=torch.int32,
                          device=device),
    }


def _attend_cache(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,hd), k/v: (B,C,KV,hd), mask: (B,1,1,Sq,C) or broadcastable."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    scores = softcap(scores, cfg.logit_softcap)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(B, Sq, H * hd)


def attention_decode(p, cfg: ModelConfig, xq, xkv, cache, t):
    """Self-attention with a dense per-row KV buffer (the reference's
    non-rolling, window-free path; windows are not ported yet).

    xq/xkv: (B, Sq, d); t: (B,) per-row start positions.  Writes row b's new
    K/V at positions t[b] .. t[b]+Sq-1 and attends over the whole buffer,
    masked by stored positions.  As ``jax.lax.dynamic_update_slice`` in the
    reference does, a write that would run past the buffer is shifted back
    to end at its last entry.  Returns (out (B, Sq, d), cache) — ``cache``
    is updated in place.
    """
    B, Sq, _ = xq.shape
    C = cache["k"].shape[1]
    if Sq > C:
        raise _not_ported("prefill longer than the KV buffer")
    dev = xq.device
    ar = torch.arange(Sq, dtype=torch.int32, device=dev)
    pos_q = t.to(torch.int32)[:, None] + ar[None, :]              # (B, Sq)
    q, k, v = _qkv(p, cfg, xq, xkv, pos_q)

    start = torch.clamp(t.to(torch.int64), 0, C - Sq)
    idx = start[:, None] + ar[None, :].to(torch.int64)            # (B, Sq)
    rows = torch.arange(B, device=dev)[:, None]
    cache["k"][rows, idx] = k.to(cache["k"].dtype)
    cache["v"][rows, idx] = v.to(cache["v"].dtype)
    cache["pos"][rows, idx] = pos_q

    pk = cache["pos"][:, None, None, None, :]                     # (B,1,1,1,C)
    pq = pos_q[:, None, None, :, None]                            # (B,1,1,Sq,1)
    mask = (pk >= 0) & (pk <= pq)
    out = _attend_cache(q, cache["k"], cache["v"], mask, cfg)
    return torch.matmul(out, p["wo"]), cache


def attention_decode_paged(p, cfg: ModelConfig, xq, xkv, pool, page_table, t,
                           *, write_mask, kv_len: Optional[int] = None):
    """Paged decode self-attention: one layer's KV state lives in a pool of
    physical pages shared across slots; a per-slot page table maps logical
    positions to pages.

    xq/xkv: (B, 1, d); t: (B,) per-slot positions; pool: {"k"/"v":
    (P, page, KV, hd), "pos": (P, page)}; page_table: (B, n_pages) int32,
    -1 = unmapped; write_mask: (B,) bool — rows not selected write nothing.
    The new K/V lands at logical slot ``t`` through the page table (in
    place), then ``paged_attention`` reads every mapped page.  Returns
    (out (B, 1, d), pool).
    """
    from repro_torch.kernels import paged_attention as pk

    B = xq.shape[0]
    P, page = pool["pos"].shape
    n_pages = page_table.shape[1]
    C = kv_len if kv_len is not None else n_pages * page

    t32 = t.to(torch.int32)
    q, k, v = _qkv(p, cfg, xq, xkv, t32[:, None])

    slot = t.to(torch.int64)
    page_idx = torch.clamp(slot // page, 0, n_pages - 1)
    off = slot % page
    phys = page_table[torch.arange(B, device=xq.device), page_idx].to(torch.int64)
    # the reference scatters masked rows to index P with mode="drop"; torch
    # has no drop mode, so the rows are filtered out before the write
    keep = write_mask & (phys >= 0) & (slot < C)
    ph, of = phys[keep], off[keep]
    pool["k"][ph, of] = k[:, 0][keep].to(pool["k"].dtype)
    pool["v"][ph, of] = v[:, 0][keep].to(pool["v"].dtype)
    pool["pos"][ph, of] = t32[keep]

    out = pk.paged_attention(q[:, 0].contiguous(), pool["k"], pool["v"],
                             pool["pos"], page_table, t32, kv_len=C,
                             softcap=cfg.logit_softcap)
    return torch.matmul(out[:, None], p["wo"]), pool


# ---------------------------------------------------------------- LM head

def lm_head_logits(h, w, cap: Optional[float] = None):
    """Vocabulary logits from final hidden states (any leading shape)."""
    return softcap(torch.matmul(h, w), cap)


# ---------------------------------------------------------------- MLP

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, ff), ("embed", "mlp")),
        "w_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def mlp(p, x):
    h = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    return torch.matmul(h, p["w_down"])
