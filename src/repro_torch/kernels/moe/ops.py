"""Grouped-MoE ops (port of ``repro.kernels.moe.ops``): the grouped GEMM
wrapper, its ``autograd.Function`` and the full dropless expert FFN
(dispatch -> grouped GEMMs -> combine).

``grouped_matmul_kernel`` launches the hand-written CUDA kernel
(``csrc/grouped_gemm.cu``) for CUDA tensors and runs the plain twin
(``ref.grouped_matmul_ref``) for CPU tensors — the device of the tensors
decides, nothing else.  ``LAUNCHES`` counts launches of the forward read,
``TRANS_LAUNCHES`` those of the transposed read, so a run can show that its
main path went through the kernel.

``grouped_matmul`` is the differentiable entry point.  As the reference's
``custom_vjp`` it saves exactly (lhs, rhs, tile_expert), plus the device
int32 used-tile count the kernel reads:

  * d_lhs is the same kernel against the transposed expert weights, read
    in place (``trans_rhs``) — never a transposed copy;
  * d_rhs is the per-tile contraction lhs_t^T ct_t segment-summed into
    expert slots in f32 (torch, as the reference's is jnp), in chunks of
    tiles so the (tiles, K, N) f32 transient stays bounded.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.moe import dispatch as dsp
from repro_torch.kernels.moe.ref import grouped_matmul_ref

#: the CUDA kernel's row tile; the dispatch plan's block_m must equal it
KERNEL_BLOCK_M = 64

#: CUDA kernel launches since import, forward and transposed read (reset by
#: callers that count a run)
LAUNCHES = 0
TRANS_LAUNCHES = 0

#: upper bound on the f32 per-tile transient of d_rhs, in bytes
D_RHS_CHUNK_BYTES = 1 << 28


def default_block_m(device) -> int:
    """The kernel's row tile on CUDA; small tiles on the CPU so per-expert
    padding (E * (block_m - 1) rows worst case) stays negligible in tests
    (the reference uses 16 off-TPU too)."""
    return KERNEL_BLOCK_M if torch.device(device).type == "cuda" else 16


def _check_cuda_args(lhs, rhs, tile_expert, block_m, n_used_tiles,
                     trans_rhs=False):
    if block_m != KERNEL_BLOCK_M:
        raise ValueError(f"grouped_matmul: block_m={block_m} but the CUDA "
                         f"kernel's row tile is {KERNEL_BLOCK_M}")
    for name, t in (("lhs", lhs), ("rhs", rhs), ("tile_expert", tile_expert),
                    ("n_used_tiles", n_used_tiles)):
        if not t.is_cuda or t.device != lhs.device:
            raise ValueError(f"grouped_matmul: {name} must be on {lhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"grouped_matmul: lhs {lhs.dtype} != rhs {rhs.dtype}")
    if tile_expert.dtype != torch.int32 or n_used_tiles.dtype != torch.int32:
        raise TypeError("grouped_matmul: tile_expert and n_used_tiles must "
                        "be int32")
    m_pad, K = lhs.shape
    E, K2, N = rhs.shape
    if trans_rhs:
        N, K2 = K2, N
    epc = 16 // lhs.element_size()
    if K != K2 or m_pad % block_m or K % epc or N % epc:
        raise ValueError(f"grouped_matmul: shapes lhs {tuple(lhs.shape)} rhs "
                         f"{tuple(rhs.shape)} need K equal, m_pad % {block_m} "
                         f"== 0 and K, N multiples of {epc}")
    if tile_expert.shape != (m_pad // block_m,) or n_used_tiles.numel() != 1:
        raise ValueError("grouped_matmul: tile_expert must be (m_pad/block_m,) "
                         "and n_used_tiles one element")
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("grouped_matmul: operands must be 16-byte aligned")


def grouped_matmul_kernel(lhs, rhs, tile_expert, block_m: int,
                          n_used_tiles: Optional[torch.Tensor] = None, *,
                          trans_rhs: bool = False):
    """out[m] = lhs[m] @ B[tile_expert[m // block_m]], f32 accumulation,
    out in lhs.dtype; B = rhs, or rhs.transpose(1, 2) when ``trans_rhs``.

    lhs: (m_pad, K) expert-contiguous rows, rhs: (E, K, N) — or (E, N, K)
    with ``trans_rhs`` —, tile_expert: (m_pad/block_m,) int32,
    n_used_tiles: (1,) int32 — tiles at or past it are all padding and come
    back zero (required on CUDA).
    """
    global LAUNCHES, TRANS_LAUNCHES
    if lhs.device.type == "cpu":
        w = rhs.transpose(1, 2) if trans_rhs else rhs
        return grouped_matmul_ref(lhs, w, tile_expert, block_m=block_m)
    if n_used_tiles is None:
        raise ValueError("grouped_matmul: the CUDA kernel needs n_used_tiles")
    _check_cuda_args(lhs, rhs, tile_expert, block_m, n_used_tiles, trans_rhs)
    lib = build.library()
    m_pad, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.empty((m_pad, N), dtype=lhs.dtype, device=lhs.device)
    err = lib.repro_grouped_gemm(
        lhs.data_ptr(), rhs.data_ptr(), tile_expert.data_ptr(),
        n_used_tiles.data_ptr(), out.data_ptr(), m_pad, K, N, E, block_m,
        int(trans_rhs), build.dtype_code(lhs.dtype),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.check(err, "repro_grouped_gemm")
    if trans_rhs:
        TRANS_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def grouped_d_rhs(lhs, ct, tile_expert, block_m: int, num_experts: int):
    """d_rhs[e] = sum over tiles t of expert e of lhs_t^T @ ct_t, in f32,
    cast to lhs.dtype (the reference's per-tile einsum + segment sum)."""
    n_tiles = lhs.shape[0] // block_m
    K, N = lhs.shape[1], ct.shape[1]
    acc = torch.zeros((num_experts, K, N), dtype=torch.float32,
                      device=lhs.device)
    lt = lhs.reshape(n_tiles, block_m, K)
    ctt = ct.reshape(n_tiles, block_m, N)
    step = max(1, D_RHS_CHUNK_BYTES // (K * N * 4))
    te = tile_expert.long()
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        # the chunk's products are a temporary: freed before the next chunk
        # is allocated, so one chunk's transient is live at a time
        acc.index_add_(0, te[t0:t1], torch.bmm(
            lt[t0:t1].transpose(1, 2).float(), ctt[t0:t1].float()))
    return acc.to(lhs.dtype)


class GroupedMatmul(torch.autograd.Function):
    """Differentiable in lhs and rhs; residuals (lhs, rhs, tile_expert,
    n_used_tiles)."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, block_m, n_used_tiles):
        ctx.block_m = block_m
        ctx.save_for_backward(lhs, rhs, tile_expert, n_used_tiles)
        return grouped_matmul_kernel(lhs, rhs, tile_expert, block_m,
                                     n_used_tiles)

    @staticmethod
    def backward(ctx, ct):
        lhs, rhs, tile_expert, n_used_tiles = ctx.saved_tensors
        ct = ct.to(lhs.dtype).contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = grouped_matmul_kernel(ct, rhs, tile_expert, ctx.block_m,
                                          n_used_tiles, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            d_rhs = grouped_d_rhs(lhs, ct, tile_expert, ctx.block_m,
                                  rhs.shape[0])
        return d_lhs, d_rhs, None, None, None


def grouped_matmul(lhs, rhs, tile_expert, block_m: int,
                   n_used_tiles: Optional[torch.Tensor] = None):
    """Differentiable out[m] = lhs[m] @ rhs[tile_expert[m // block_m]]."""
    if n_used_tiles is None:
        if lhs.is_cuda:
            raise ValueError("grouped_matmul: the CUDA kernel needs "
                             "n_used_tiles")
        n_used_tiles = torch.full((1,), lhs.shape[0] // block_m,
                                  dtype=torch.int32)
    return GroupedMatmul.apply(lhs, rhs, tile_expert, block_m, n_used_tiles)


def grouped_expert_ffn(x, expert_idx, gates, w_gate, w_up, w_down, *,
                       block_m: Optional[int] = None):
    """Dropless SwiGLU expert FFN over sorted tokens.

    x: (T, d); expert_idx/gates: (T, k); w_gate/w_up: (E, d, f);
    w_down: (E, f, d).  Returns (T, d) = sum_k gate * expert_k(x).
    """
    block_m = block_m or default_block_m(x.device)
    num_tokens = x.shape[0]
    plan = dsp.make_plan(expert_idx, w_gate.shape[0], block_m)
    xs = dsp.permute(x, plan)
    te, nu = plan.tile_expert, plan.n_used_tiles
    g = grouped_matmul(xs, w_gate, te, block_m, nu)
    u = grouped_matmul(xs, w_up, te, block_m, nu)
    h = F.silu(g) * u
    ys = grouped_matmul(h, w_down, te, block_m, nu)
    return dsp.combine(ys, gates, plan, num_tokens)
