"""Plain-PyTorch twin of the ragged grouped GEMM (port of
``repro.kernels.moe.ref``): the CPU path and the CUDA kernel's oracle.

Reshape the padded row buffer into (n_tiles, block_m, K) tiles, gather each
tile's expert weight block, batch the matmuls in f32, round once to the
input dtype.  The (n_tiles, K, N) gathered-weight intermediate makes this
the memory-hungry path; it exists as the twin, not the hot path.
"""
from __future__ import annotations

import torch


def grouped_matmul_ref(lhs, rhs, tile_expert, *, block_m: int):
    """lhs: (m_pad, K), rhs: (E, K, N), tile_expert: (m_pad/block_m,) int."""
    m_pad, K = lhs.shape
    N = rhs.shape[-1]
    assert m_pad % block_m == 0, (m_pad, block_m)
    tiles = lhs.reshape(m_pad // block_m, block_m, K).float()
    w = rhs[tile_expert.long()].float()
    out = torch.bmm(tiles, w)
    return out.to(lhs.dtype).reshape(m_pad, N)
