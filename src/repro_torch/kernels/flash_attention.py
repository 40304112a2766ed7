"""Flash attention on the training path (port of
``repro.kernels.flash_attention`` and of ``flash_attention_trainable`` in
``repro.kernels.ops``): the forward emitting (o, lse), the dq pass and the
dk/dv pass, and the ``autograd.Function`` that pairs them.

Each wrapper launches its hand-written CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors and runs its plain twin for
CPU tensors; the device of the tensors decides, nothing else.  ``LAUNCHES``
counts kernel launches per kernel.

The twins follow the reference's tiled pure-JAX paths
(``flash_attention_fwd_jax``, ``flash_attention_bwd_jax``): a loop over q
tiles for the forward and dq, over k tiles for dk/dv, so no (Sq, Skv)
tensor is built.  Masked scores are NEG_INF, as in the reference, so a row
with no valid key gives o = mean(v) and lse = -1e30.  The backward gives
masked entries p = ds = 0; on every row with a valid key that is exactly
what both reference backward paths compute.

Shapes: q/o/do (B, H, Sq, hd), k/v (B, KV, Skv, hd) with H % KV == 0
(GQA), lse/delta (B, H, Sq) f32.  Unlike the reference's wrapper, head_dim
is not padded to 128 (that is the TPU MXU's tiling, not Hopper's); the
kernels take hd in {32, 64, 128}.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128)

#: CUDA kernel launches since import, per kernel (reset by callers that
#: count a run)
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _scale(q, scale):
    return scale if scale is not None else q.shape[-1] ** -0.5


def _mask(pos_q, pos_k, causal: bool, window: Optional[int]):
    """(len(pos_q), len(pos_k)) validity: the reference's _mask_positions."""
    mask = torch.ones((pos_q.numel(), pos_k.numel()), dtype=torch.bool,
                      device=pos_q.device)
    if causal:
        mask &= pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        mask &= (pos_q[:, None] - pos_k[None, :]) < window
    return mask


def _scores(qt, kt, scale, softcap):
    """(B,KV,G,bq,hd) x (B,KV,bk,hd) -> scores and tanh(s / cap) (or None)."""
    s = torch.einsum("bkgqh,bksh->bkgqs", qt, kt) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = t * softcap
    return s, t


# ------------------------------------------------------------------ twins

def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            block_q: int = 128):
    """Plain forward emitting (o in q.dtype, lse f32), tiled over q."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = _scale(q, scale)
    qg = q.reshape(B, KV, G, Sq, hd).float()
    kf, vf = k.float(), v.float()
    pos_k = torch.arange(Skv, device=q.device)
    o = torch.empty((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        s, _ = _scores(qg[:, :, :, q0:q1], kf, scale, softcap)
        mask = _mask(torch.arange(q0, q1, device=q.device), pos_k, causal,
                     window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        o[:, :, :, q0:q1] = torch.einsum("bkgqs,bksh->bkgqh", p, vf) / l[..., None]
        lse[:, :, :, q0:q1] = m + torch.log(l)
    return (o.reshape(B, H, Sq, hd).to(q.dtype), lse.reshape(B, H, Sq))


def _p_ds(qt, kt, vt, dot, lset, deltat, mask, scale, softcap):
    s, t = _scores(qt, kt, scale, softcap)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.where(mask, torch.exp(s - lset[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bkgqh,bksh->bkgqs", dot, vt)
    ds = p * (dp - deltat[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def _bwd_inputs(q, k, v, lse, delta, do):
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    return (q.reshape(B, KV, G, Sq, hd).float(),
            do.reshape(B, KV, G, Sq, hd).float(),
            lse.reshape(B, KV, G, Sq).float(),
            delta.reshape(B, KV, G, Sq).float(), k.float(), v.float())


def flash_bwd_dq_ref(q, k, v, lse, delta, do, *, causal: bool = True,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None, block_q: int = 128):
    """Plain dq from (q, k, v, lse, delta = rowsum(do * o), do), tiled
    over q.  Returns dq in q.dtype."""
    B, H, Sq, hd = q.shape
    scale = _scale(q, scale)
    qg, dog, lseg, deltag, kf, vf = _bwd_inputs(q, k, v, lse, delta, do)
    pos_k = torch.arange(k.shape[2], device=q.device)
    dq = torch.empty_like(qg)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        mask = _mask(torch.arange(q0, q1, device=q.device), pos_k, causal,
                     window)
        _, ds = _p_ds(qg[:, :, :, q0:q1], kf, vf, dog[:, :, :, q0:q1],
                      lseg[..., q0:q1], deltag[..., q0:q1], mask, scale,
                      softcap)
        dq[:, :, :, q0:q1] = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    return dq.reshape(B, H, Sq, hd).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, lse, delta, do, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None, block_k: int = 128):
    """Plain dk, dv (group-reduced to (B, KV, Skv, hd)), tiled over k."""
    Sq, Skv = q.shape[2], k.shape[2]
    scale = _scale(q, scale)
    qg, dog, lseg, deltag, kf, vf = _bwd_inputs(q, k, v, lse, delta, do)
    pos_q = torch.arange(Sq, device=q.device)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k0 in range(0, Skv, block_k):
        k1 = min(k0 + block_k, Skv)
        mask = _mask(pos_q, torch.arange(k0, k1, device=q.device), causal,
                     window)
        p, ds = _p_ds(qg, kf[:, :, k0:k1], vf[:, :, k0:k1], dog, lseg, deltag,
                      mask, scale, softcap)
        dv[:, :, k0:k1] = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
        dk[:, :, k0:k1] = torch.einsum("bkgqs,bkgqh->bksh", ds, qg) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, lse, delta, do, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            block_q: int = 128, block_k: int = 128):
    """Plain backward: (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dq = flash_bwd_dq_ref(q, k, v, lse, delta, do, block_q=block_q, **kw)
    dk, dv = flash_bwd_dkv_ref(q, k, v, lse, delta, do, block_k=block_k, **kw)
    return dq, dk, dv


# --------------------------------------------------------------- wrappers

def _check_cuda_args(name, q, k, v, *rest):
    for t in (q, k, v) + rest:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: every tensor must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q (B,H,Sq,hd), k/v (B,KV,Skv,hd) expected")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not pair (batch, head dim, H % KV)")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {KERNEL_HEAD_DIMS}")


def _tail(q, k, causal, window, softcap, scale):
    """The C entry points' shared trailing arguments."""
    B, H, Sq, hd = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], hd, int(bool(causal)),
            int(window is not None), int(window if window is not None else 0),
            float(softcap or 0.0), float(_scale(q, scale)),
            build.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              block_q: int = 128):
    """(o, lse).  ``block_q`` tiles the CPU twin; the kernel has its own."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       block_q=block_q)
    _check_cuda_args("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = build.library().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_tail(q, k, causal, window, softcap, scale))
    build.check(err, "repro_flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_bwd_args(name, q, k, v, lse, delta, do):
    _check_cuda_args(name, q, k, v, lse, delta, do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q")
    for t in (lse, delta):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be (B, H, Sq) f32")


def flash_bwd_dq(q, k, v, lse, delta, do, *, causal: bool = True,
                 window: Optional[int] = None, softcap: Optional[float] = None,
                 scale: Optional[float] = None, block_q: int = 128):
    """dq from the forward's residuals and delta = rowsum(do * o)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, lse, delta, do, causal=causal,
                                window=window, softcap=softcap, scale=scale,
                                block_q=block_q)
    _check_bwd_args("flash_bwd_dq", q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    err = build.library().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_tail(q, k, causal, window, softcap, scale))
    build.check(err, "repro_flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, lse, delta, do, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, block_k: int = 128):
    """(dk, dv), summed over each KV head's group of q heads."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, lse, delta, do, causal=causal,
                                 window=window, softcap=softcap, scale=scale,
                                 block_k=block_k)
    _check_bwd_args("flash_bwd_dkv", q, k, v, lse, delta, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.library().repro_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, causal, window, softcap, scale))
    build.check(err, "repro_flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------- autograd

class FlashAttention(torch.autograd.Function):
    """Flash forward and flash backward; residuals exactly (q, k, v, o,
    lse), O(S) per head.  The backward computes delta = rowsum(do * o) in
    torch, as the reference does outside any kernel (ops.py:111)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           softcap=softcap, block_q=block_q)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1)
        block_q, block_k = ctx.blocks
        dq = flash_bwd_dq(q, k, v, lse, delta, do, block_q=block_q,
                          **ctx.opts)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, block_k=block_k,
                               **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              block_q: int = 128, block_k: int = 128):
    """Differentiable flash attention, (B, H, Sq, hd) out in q.dtype."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window, softcap,
                                block_q, block_k)
