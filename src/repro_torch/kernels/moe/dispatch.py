"""Sort-based dropless token dispatch for MoE (port of
``repro.kernels.moe.dispatch``).

Stable-argsort the (token, k) assignments by expert id, gather tokens into
expert-contiguous rows, run one ragged grouped GEMM per projection, and
scatter-add the results back under the gate weights.  Each expert's run of
sorted rows is padded to a multiple of ``block_m`` so every ``block_m``-row
tile belongs to exactly one expert; padding rows are zero and compute zero.

Everything stays on the tensors' device — no host sync: the padded buffer
size ``m_pad`` is the static worst case ``T*k + E*(block_m-1)`` rounded up,
and the number of tiles that hold rows at all (``n_used_tiles``) is a device
int32 the CUDA kernel reads to skip the dead tail.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class DispatchPlan(NamedTuple):
    """Index state of one sorted dispatch (all int tensors).

    order:        (T*k,)  assignment slots sorted stably by expert id
    dest:         (T*k,)  destination row of each sorted slot in the padded
                          expert-contiguous buffer
    tile_expert:  (m_pad / block_m,) int32 expert id owning each tile
    group_sizes:  (E,)    real (unpadded) rows per expert
    m_pad:        int     padded row count (multiple of block_m)
    block_m:      int
    top_k:        int
    n_used_tiles: (1,) int32 tiles below sum(padded group sizes); every
                  tile at or past it is all padding
    """
    order: torch.Tensor
    dest: torch.Tensor
    tile_expert: torch.Tensor
    group_sizes: torch.Tensor
    m_pad: int
    block_m: int
    top_k: int
    n_used_tiles: torch.Tensor


def make_plan(expert_idx, num_experts: int, block_m: int) -> DispatchPlan:
    """expert_idx: (T, k) int — top-k expert assignment per token."""
    T, k = expert_idx.shape
    M = T * k
    dev = expert_idx.device
    m_pad = round_up(M + num_experts * (block_m - 1), block_m)

    flat_e = expert_idx.reshape(M).to(torch.int64)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]

    sizes = torch.bincount(flat_e, minlength=num_experts)
    padded = (sizes + block_m - 1) // block_m * block_m
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    pstart = torch.cat([zero, torch.cumsum(padded, 0)])[:num_experts]
    start = torch.cat([zero, torch.cumsum(sizes, 0)])[:num_experts]

    rank = torch.arange(M, device=dev) - start[sorted_e]
    dest = pstart[sorted_e] + rank

    n_tiles = m_pad // block_m
    tile_row0 = torch.arange(n_tiles, device=dev) * block_m
    # largest e with pstart[e] <= tile_row0; empty experts (duplicate starts)
    # resolve to the following non-empty one, trailing tiles clamp to E-1
    tile_expert = torch.clamp(
        torch.searchsorted(pstart, tile_row0, right=True) - 1,
        0, num_experts - 1).to(torch.int32)
    n_used = (padded.sum() // block_m).to(torch.int32).reshape(1)

    return DispatchPlan(order=order, dest=dest, tile_expert=tile_expert,
                        group_sizes=sizes, m_pad=m_pad, block_m=block_m,
                        top_k=k, n_used_tiles=n_used)


def permute(x, plan: DispatchPlan):
    """x: (T, d) -> (m_pad, d), rows grouped by expert (zeros in padding).
    A token routed to k experts contributes k gathered copies."""
    src = plan.order // plan.top_k
    out = torch.zeros((plan.m_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    out[plan.dest] = x[src]
    return out


def combine(ys, gates, plan: DispatchPlan, num_tokens: int):
    """ys: (m_pad, d), gates: (T, k) -> y: (T, d).

    Gathers each slot's expert output back out of the padded buffer and
    adds a token's k contributions under their gate weights in f32,
    rounding once.  The reference scatter-adds them in sorted (expert
    ascending) order; here each token's k rows are gathered in that order
    and summed, which needs no atomics, so the result is the same on every
    run (``index_add_`` on CUDA adds in a nondeterministic order).
    """
    M = plan.order.numel()
    inv = torch.empty_like(plan.order)
    inv[plan.order] = torch.arange(M, device=plan.order.device)
    rows = plan.dest[inv].reshape(num_tokens, plan.top_k)  # row of slot (t, j)
    rows, by_row = torch.sort(rows, dim=1)
    g = torch.gather(gates, 1, by_row)
    contrib = ys[rows].float() * g[..., None].float()      # (T, k, d)
    return contrib.sum(dim=1).to(ys.dtype)
