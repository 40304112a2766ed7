"""The RWKV6 wkv recurrence on the training path (port of
``repro.kernels.rwkv6_scan`` and of ``rwkv6_scan`` /
``rwkv6_scan_trainable`` in ``repro.kernels.ops``).

Per head, with state S (C x C, key x value), decay w in (0, 1) and bonus
u, token by token:

    o_t = r_t (S + u^T * k_t^T v_t),    S <- w_t^T * S + k_t^T v_t

``rwkv6_scan`` launches the hand-written CUDA kernel
(``csrc/rwkv6_scan.cu``) for CUDA tensors and runs the plain twin
``wkv_chunked`` for CPU tensors; the device of the tensors decides, nothing
else.  ``LAUNCHES`` counts kernel launches.

The twin is the chunked form the kernel computes, on log decays
lw = log(max(w, 1e-38)): within a chunk of T tokens a (T x T) matrix A
whose entries sum r * k * exp(clw_prev[t] - clw[s]) over channels (one exp
of a non-positive difference, so no decay overflows), then the carry-in
from the state and the state update.  It takes the chunks a group at a time
(all of them when they fit ``GROUP_ELEMENTS``: the (T, T, C) decay tensor
of a whole sequence is 1.3 GB per batch row at rwkv6-3b's width) with the
state carried between groups, and returns (out, final_state) like the
reference's oracle ``ref.rwkv6_ref``.

The backward is not a kernel.  The JAX package computes it outside any
Pallas kernel, as ``jax.vjp`` of its plain oracle (``ops._rwkv_bwd``), so
``RWKVScan.backward`` is autograd over the plain twin, recomputed from the
saved (r, k, v, w, u) under ``enable_grad``, even on the card.  It walks the
groups in reverse with the state carried: a cheap pass gives the state
entering each group, and each group is re-run and differentiated on its
own, so only one group's intermediates are alive at a time.  A wkv backward
kernel is later work (ROADMAP.md queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: head sizes and chunk lengths the CUDA kernel is built for
KERNEL_HEAD_SIZES = (32, 64)
KERNEL_CHUNKS = (16, 32, 64)

#: elements of one group's (B, H, n, T, T, C) decay tensor, at most (f32)
GROUP_ELEMENTS = 1 << 26

#: the floor of w before its log, as the reference's wrapper
W_FLOOR = 1e-38

#: CUDA kernel launches since import (reset by callers that count a run)
LAUNCHES = 0


def log_decay(w):
    """lw = log(max(w, 1e-38)) in f32: the kernel's per-step log decay."""
    return torch.log(torch.clamp_min(w.float(), W_FLOOR))


def _chunk_len(S: int, chunk: int) -> int:
    T = min(chunk, S)
    if T <= 0 or S % T:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {T}")
    return T


def _group_chunks(B: int, H: int, T: int, C: int, nc: int) -> int:
    """Chunks per group: as many as keep the decay tensor in budget."""
    return max(1, min(nc, GROUP_ELEMENTS // max(B * H * T * T * C, 1)))


def _carry(k, v, clw, state, every: int = 1):
    """Carry the (C x C) state across n chunks: S <- exp(endw)^T * S +
    (k * exp(endw - clw))^T v.  k, v, clw: (B, H, n, T, C); state
    (B, H, C, C) entering the first chunk.  Returns the states entering
    every ``every``-th chunk and the state after the last."""
    endw = clw[..., -1:, :]
    kv = torch.matmul((k * torch.exp(endw - clw)).transpose(-1, -2), v)
    dec = torch.exp(endw[..., 0, :])
    entering = []
    for j in range(k.shape[2]):
        if j % every == 0:
            entering.append(state)
        state = dec[:, :, j, :, None] * state + kv[:, :, j]
    return entering, state


def _group(r, k, v, lw, u, state):
    """n whole chunks at once.  r, k, v, lw: (B, H, n, T, C) f32; u (H, C);
    state (B, H, C, C) entering the first chunk.  Returns o (B, H, n, T, C)
    and the state after the last chunk."""
    T = r.shape[3]
    clw = torch.cumsum(lw, dim=3)                       # inclusive
    clw_prev = torch.cat([torch.zeros_like(clw[..., :1, :]),
                          clw[..., :-1, :]], dim=3)     # exclusive
    # intra-chunk: the mask goes inside the exp (differences at s >= t are
    # positive and overflow)
    tri = torch.ones((T, T), dtype=torch.bool, device=r.device).tril(-1)
    diff = clw_prev[..., :, None, :] - clw[..., None, :, :]   # (.., T, T, C)
    decay = torch.exp(torch.where(tri[..., None], diff,
                                  torch.full_like(diff, -1e30)))
    A = torch.sum(r[..., :, None, :] * k[..., None, :, :] * decay, dim=-1)
    bonus = torch.sum(r * u[None, :, None, None, :] * k, dim=-1)
    A = A + torch.diag_embed(bonus)
    o = torch.matmul(A, v)
    # inter-chunk: the state entering each chunk, read out through r
    entering, state = _carry(k, v, clw, state)
    o = o + torch.matmul(r * torch.exp(clw_prev), torch.stack(entering, 2))
    return o, state


def _chunked(a, T):
    B, H, S, C = a.shape
    return a.float().reshape(B, H, S // T, T, C)


def wkv_chunked(r, k, v, lw, u, state=None, chunk: int = 64):
    """The plain twin on log decays.  r, k, v, lw: (B, H, S, C); u: (H, C);
    state: (B, H, C, C) or None (zeros).  Returns (out (B, H, S, C) in r's
    dtype, final state (B, H, C, C) f32).  S must be a multiple of
    min(chunk, S)."""
    B, H, S, C = r.shape
    T = _chunk_len(S, chunk)
    nc = S // T
    rr, kk, vv, ll = (_chunked(a, T) for a in (r, k, v, lw))
    uu = u.float()
    st = (torch.zeros((B, H, C, C), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    n = _group_chunks(B, H, T, C, nc)
    outs = []
    for c0 in range(0, nc, n):
        sl = slice(c0, c0 + n)
        o, st = _group(rr[:, :, sl], kk[:, :, sl], vv[:, :, sl],
                       ll[:, :, sl], uu, st)
        outs.append(o)
    out = torch.cat(outs, dim=2).reshape(B, H, S, C).to(r.dtype)
    return out, st


def rwkv6_scan_ref(r, k, v, w, u, state=None, chunk: int = 64):
    """The twin with the reference oracle's signature: decays ``w``, not
    their logs.  Returns (out, final_state)."""
    return wkv_chunked(r, k, v, log_decay(w), u, state, chunk)


# --------------------------------------------------------------- wrapper

def _check_cuda_args(r, k, v, w, u, T: int):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} must be on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} is {t.dtype}; the kernel "
                            f"takes float32")
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_scan: {name} must be contiguous")
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or w.shape != r.shape:
        raise ValueError("rwkv6_scan: r, k, v, w must all be (B, H, S, C)")
    B, H, S, C = r.shape
    if tuple(u.shape) != (H, C):
        raise ValueError(f"rwkv6_scan: u is {tuple(u.shape)}, not ({H}, {C})")
    if C not in KERNEL_HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: head size {C} not in "
                         f"{KERNEL_HEAD_SIZES}")
    if T not in KERNEL_CHUNKS:
        raise ValueError(f"rwkv6_scan: chunk {T} not in {KERNEL_CHUNKS}")


def rwkv6_scan(r, k, v, w, u, *, chunk: int = 64):
    """out (B, H, S, C) in r's dtype.  r, k, v, w: (B, H, S, C) with w the
    decay in (0, 1); u: (H, C).  S must be a multiple of min(chunk, S)."""
    global LAUNCHES
    T = _chunk_len(r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, log_decay(w), u, chunk=T)[0]
    _check_cuda_args(r, k, v, w, u, T)
    lw = log_decay(w)
    out = torch.empty_like(r)
    B, H, S, C = r.shape
    err = build.library().repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), out.data_ptr(), B, H, S, C, T,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "repro_rwkv6_scan")
    LAUNCHES += 1
    return out


# ------------------------------------------------------------- autograd

def _entry_states(k, v, w, T: int, n: int):
    """The state entering each group of n chunks (zeros for the first),
    without the intra-chunk work."""
    B, H, S, C = k.shape
    kk, vv, ll = (_chunked(a, T) for a in (k, v, log_decay(w)))
    zeros = torch.zeros((B, H, C, C), dtype=torch.float32, device=k.device)
    return _carry(kk, vv, torch.cumsum(ll, dim=3), zeros, every=n)[0]


class RWKVScan(torch.autograd.Function):
    """Kernel forward, twin backward (see the module docstring); saves
    exactly (r, k, v, w, u)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return rwkv6_scan(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, do):
        r, k, v, w, u = ctx.saved_tensors
        B, H, S, C = r.shape
        T = _chunk_len(S, ctx.chunk)
        n = _group_chunks(B, H, T, C, S // T)
        with torch.no_grad():
            entering = _entry_states(k, v, w, T, n)
        grads = [torch.empty_like(a) for a in (r, k, v, w)]
        du = torch.zeros_like(u)
        d_state = None
        for g in reversed(range(len(entering))):
            sl = slice(g * n * T, min((g + 1) * n * T, S))
            with torch.enable_grad():
                ins = [a[:, :, sl].detach().requires_grad_()
                       for a in (r, k, v, w)]
                uu = u.detach().requires_grad_()
                s0 = entering[g].detach().requires_grad_(g > 0)
                o, s1 = rwkv6_scan_ref(*ins, uu, state=s0, chunk=T)
                outs, cts = [o], [do[:, :, sl]]
                if d_state is not None:
                    outs.append(s1)
                    cts.append(d_state)
                wrt = ins + [uu] + ([s0] if g > 0 else [])
                got = torch.autograd.grad(outs, wrt, cts)
            for buf, gr in zip(grads, got[:4]):
                buf[:, :, sl] = gr
            du += got[4]
            d_state = got[5] if g > 0 else None
        return (*grads, du, None)


def rwkv6_scan_trainable(r, k, v, w, u, chunk: int = 64):
    """Differentiable wkv: kernel forward (twin on the CPU), twin backward."""
    return RWKVScan.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                          w.contiguous(), u.contiguous(), chunk)
