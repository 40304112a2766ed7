"""Paged decode attention for the serving engine (port of
``repro.kernels.paged_attention``).

``paged_attention`` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors and runs the plain twin
``paged_attention_ref`` for CPU tensors.  The twin gathers the mapped pages
into a contiguous per-slot buffer and runs the dense decode-attention math
over it, mirroring the reference's ``paged_attention_jax`` op for op.
``LAUNCHES`` counts kernel launches.

Shapes (decode: one query position per slot):

  q          (B, H, hd)
  k/v pool   (P, page, KV, hd)     P physical pages of ``page`` positions
  pos pool   (P, page) int32       stored absolute positions, -1 = invalid
  page_table (B, n_pages) int32    physical page per logical page, -1 = unmapped
  t          (B,) int32            current query position per slot
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: CUDA kernel launches since import (reset by callers that count a run)
LAUNCHES = 0


# ------------------------------------------------------------------ the twin

def gather_pages(k_pool, v_pool, pos_pool, page_table, kv_len: int):
    """Materialise each slot's logical KV buffer from the pool.  Returns
    ((B, kv_len, KV, hd) x2, (B, kv_len)); unmapped pages surface as
    pos = -1 (their K/V rows are arbitrary and must be masked)."""
    page = k_pool.shape[1]
    pt = page_table[:, : -(-kv_len // page)].long()
    safe = torch.clamp(pt, 0, k_pool.shape[0] - 1)
    B = pt.shape[0]
    k = k_pool[safe].reshape(B, -1, *k_pool.shape[2:])[:, :kv_len]
    v = v_pool[safe].reshape(B, -1, *v_pool.shape[2:])[:, :kv_len]
    pos = torch.where(pt[:, :, None] >= 0, pos_pool[safe],
                      torch.full_like(pos_pool[safe], -1))
    pos = pos.reshape(B, -1)[:, :kv_len]
    return k, v, pos


def paged_attention_ref(q, k_pool, v_pool, pos_pool, page_table, t, *,
                        kv_len: int, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Plain paged decode attention: gather + dense masked softmax."""
    B, H, hd = q.shape
    k, v, pos = gather_pages(k_pool, v_pool, pos_pool, page_table, kv_len)
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    pk = pos[:, None, None, None, :]                        # (B,1,1,1,C)
    pq = t.to(pos.dtype)[:, None, None, None, None]         # (B,1,1,1,1)
    mask = (pk >= 0) & (pk <= pq)
    if window is not None:
        mask = mask & ((pq - pk) < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(B, 1, H * hd)
    return out[:, 0]


# ---------------------------------------------------------------- the kernel

def _check_cuda_args(q, k_pool, v_pool, pos_pool, page_table, t):
    B, H, hd = q.shape
    P, page, KV, hd2 = k_pool.shape
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pos_pool", pos_pool), ("page_table", page_table),
                    ("t", t)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pool and v_pool must share a "
                        "dtype")
    for name, x in (("pos_pool", pos_pool), ("page_table", page_table),
                    ("t", t)):
        if x.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32")
    if (hd2 != hd or v_pool.shape != k_pool.shape or H % KV
            or pos_pool.shape != (P, page) or page_table.shape[0] != B
            or t.shape != (B,)):
        raise ValueError(
            f"paged_attention: inconsistent shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} pos {tuple(pos_pool.shape)} table "
            f"{tuple(page_table.shape)} t {tuple(t.shape)}")


def paged_attention(q, k_pool, v_pool, pos_pool, page_table, t, *,
                    kv_len: int, window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Paged decode attention; returns (B, H*hd) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, pos_pool, page_table, t,
                                   kv_len=kv_len, window=window,
                                   softcap=softcap)
    if window is not None and (not isinstance(window, int) or window <= 0):
        raise ValueError("paged_attention: window must be a positive Python "
                         "int or None on CUDA")
    if softcap is not None and softcap <= 0:
        raise ValueError("paged_attention: softcap must be positive or None")
    _check_cuda_args(q, k_pool, v_pool, pos_pool, page_table, t)
    lib = build.library()
    B, H, hd = q.shape
    P, page, KV, _ = k_pool.shape
    out = torch.empty((B, H * hd), dtype=q.dtype, device=q.device)
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), page_table.data_ptr(), t.data_ptr(),
        out.data_ptr(), B, H, KV, hd, P, page, page_table.shape[1], kv_len,
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_paged_attention")
    LAUNCHES += 1
    return out
