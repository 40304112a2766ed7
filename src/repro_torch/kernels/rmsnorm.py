"""RMSNorm as a standalone kernel (port of ``repro.kernels.rmsnorm`` and of
``rmsnorm`` in ``repro.kernels.ops``).

out = x * rsqrt(mean(x^2) + eps) * (1 + scale) over the last dim, in f32,
cast back to x's type.  ``rmsnorm`` launches the hand-written CUDA kernel
(``csrc/rmsnorm.cu``) for CUDA tensors and runs the plain twin
``rmsnorm_ref`` for CPU tensors; the device of the tensors decides, nothing
else.  ``LAUNCHES`` counts kernel launches.

As in the JAX package, no model calls it: the models' norms are
``models.common.rms_norm``, plain tensor code.  It is forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: CUDA kernel launches since import (reset by callers that count a run)
LAUNCHES = 0


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """The plain twin.  x: (..., d); scale: (d,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d) f32 or bf16, contiguous; scale: (d,).  Returns x's
    shape and type."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if not x.is_cuda or scale.device != x.device:
        raise ValueError(f"rmsnorm: x and scale must be on one CUDA device "
                         f"(got {x.device}, {scale.device})")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale is {tuple(scale.shape)}, not ({d},)")
    code = build.dtype_code(x.dtype)
    s32 = scale.float().contiguous()
    out = torch.empty_like(x)
    err = build.library().repro_rmsnorm(
        x.data_ptr(), s32.data_ptr(), out.data_ptr(), x.numel() // max(d, 1),
        d, float(eps), code, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "repro_rmsnorm")
    LAUNCHES += 1
    return out
