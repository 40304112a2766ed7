#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero):

  1. build    compile every CUDA kernel of the port from src/repro_torch/csrc
              with nvcc for sm_90a (one nvcc per source, all at once); print
              the seconds.
  2. kernels  hold each kernel against its plain PyTorch twin on the card, in
              f32 and bf16 (max|err| <= 1e-4 * max|ref| in f32,
              <= 2e-2 * max|ref| in bf16: the sums run in another order and
              bf16 operands and outputs round), and time kernel, twin and —
              where one PyTorch call computes the same function — that
              library call, with the L2 cache flushed before each launch:
              the grouped GEMM (forward read at the serving shapes, forward
              and transposed reads at the training shape), paged attention at the
              serving shape, the three flash-attention kernels (a sweep of
              causal / window / softcap / GQA group / head dim at a ragged
              length, then timed at the training shape: 1 x 16 heads x 2048
              x 128, bf16, causal), the wkv scan in f32 (a ragged set of
              grids, head sizes and lengths, decays down to 1e-6 and up to
              0.999, then timed at rwkv6-3b's shape: 1 x 40 heads x 2048 x
              64) and the standalone rmsnorm (f32 and bf16, timed at
              (2048, 2560) bf16; no model calls it, as in the JAX package).
  3. serve    full-width, full-depth qwen2-moe-a2.7b (24 layers, d=2048,
              64 padded experts top-4, 4 shared, vocab 151936, bf16) with
              random weights from a seeded torch.Generator on the card,
              through the paged engine: 4 slots, 16-token pages, 8 requests
              with a 32-token shared prefix and 4-64-token tails, 16 new
              tokens each, T = 0.  The kernels' launch counters are zeroed
              just before and read just after; every request must finish,
              the radix cache must hit, and paged attention must launch
              24 times per decode step.  Then every request's tokens are
              checked against a dense teacher-forced forward (plain PyTorch
              attention over a contiguous KV buffer).
  4. train    the serve phase's weights and pool freed, full-width
              qwen2-moe-a2.7b cut to 4 layers (all 24 with AdamW's f32
              moments need ~184 GB), grouped MoE and flash attention, random
              weights from seed 0, through ``train.driver.train``: AdamW,
              batch 1 x 2048 tokens of the synthetic instruction data, 6
              steps with the stage switch after 2, no checkpoint.  Counters
              zeroed just before, read just after: every kernel of the path
              must launch; every step's loss and grad norm must be finite.
  5. reversible  on one batch of the training shape (1 x 2048) and one of
              8 x 2048, ``Model.loss`` and its grads with save_memory=True
              (activations rebuilt by inversion) and False (all kept): equal
              losses, per-leaf grad cosine >= 0.99, both peaks of
              max_memory_allocated, what is live at each peak (the
              allocator's history, at 1 x 2048), and the per-layer
              reconstruction error of the inversion.
  6. train-rwkv  qwen's weights freed, full-width, full-depth rwkv6-3b
              (32 layers, d=2560, 40 heads x 64, d_ff 8960, vocab 65536,
              bf16; 3.49 B params, ~42 GB with AdamW's f32 moments) with the
              wkv kernel, random weights from seed 0, through
              ``train.driver.train``: AdamW, 1 x 2048 tokens, 6 steps with
              the stage switch after 2, no checkpoint.  Counters zeroed just
              before, read just after: the wkv kernel must launch 3 x 32
              times per step (per layer: the forward, the inversion and the
              backward's re-run); every loss and grad norm must be finite.
              Then phase 5's check on one 1 x 2048 batch at all 32 layers.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit
(nvidia-smi), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks (dense): memory rate and operation rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

SLOTS, PAGE, PREFIX, TAIL_MIN, TAIL_MAX, GEN = 4, 16, 32, 4, 64, 16
N_REQUESTS, BUF_LEN, SEED = 8, 128, 0

# training phase: full width, depth cut to fit AdamW's state on one card
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, STAGE1 = 4, 1, 2048, 6, 2
MIN_GRAD_COSINE = 0.99
# batches of the reversible check: the training shape, where one layer's
# activations (~0.4 GB) are smaller than its parameter grads (~1.2 GB), and
# one where they are larger
REV_BATCHES = (TRAIN_BATCH, 8)

# rwkv6-3b training phase: full width and full depth (params, grads and
# AdamW's moments ~42 GB fit one card)
RWKV_ARCH, RWKV_BATCH, RWKV_SEQ = "rwkv6-3b", 1, 2048
# the kernels the qwen train path launches (phase 4 requires each)
QWEN_TRAIN_KERNELS = ("grouped_gemm", "grouped_gemm_transposed", "flash_fwd",
                      "flash_bwd_dq", "flash_bwd_dkv")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# --------------------------------------------------------------- timing

class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each preceded by
    a write of 256 MB that evicts the 50 MB L2 (the serving path finds its
    weights cold: every layer reads its own)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device=device)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def _bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check(name, out, ref, dtype):
    torch = sys.modules["torch"]
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError(f"{name}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = TOL[dtype] * max(scale, 1e-30)
    print(f"[kernels] {name}: max|err| {err:.3e} (tol {tol:.3e}, "
          f"max|ref| {scale:.3e})", flush=True)
    if not err <= tol:
        raise RuntimeError(f"{name}: max|err| {err} > {tol}")
    return err


# ------------------------------------------------------------- phase 1

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library(verbose=True)
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.1f} s "
          f"(nvcc {build.BUILD_SECONDS:.1f} s)", flush=True)
    return dt


# ------------------------------------------------------------- phase 2

def _routing(torch, T, n_real, k, gen, device):
    """Distinct top-k experts per token among the real (unpadded) ones."""
    scores = torch.rand((T, n_real), generator=gen, device=device)
    return torch.argsort(scores, dim=1)[:, :k]


def _library_grouped_mm(torch, lhs, rhs, plan):
    """``torch._grouped_mm`` over the plan's padded groups, or None with the
    reason when this PyTorch has no such call for these inputs."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    padded = (plan.group_sizes + plan.block_m - 1) // plan.block_m * plan.block_m
    offs = torch.cumsum(padded, 0).to(torch.int32)
    try:
        fn(lhs, rhs, offs=offs)
    except (RuntimeError, TypeError) as e:          # a yardstick, not the port
        return None, f"torch._grouped_mm refused: {str(e).splitlines()[0]}"
    return (lambda: fn(lhs, rhs, offs=offs)), None


def _time_grouped(torch, timer, tag, plan, lhs, rhs, run, rows_real):
    """Time one bf16 read of the grouped GEMM — out = lhs @ rhs[expert] with
    ``rhs`` (E, K, N) as the product reads it (a transposed view for d_lhs) —
    with its twin and ``torch._grouped_mm`` on the same operands, and its
    bound: the used lhs rows, the used experts' weights and the whole
    (m_pad, N) output (the contract, the reference's, writes zeros to the
    dead tiles) moved once; 2 * rows * K * N operations."""
    from repro_torch.kernels.moe.ref import grouped_matmul_ref
    n_used = int(plan.n_used_tiles)
    experts_used = int((plan.group_sizes > 0).sum())
    es = lhs.element_size()
    K, N = rhs.shape[1], rhs.shape[2]
    zero_fill = (plan.m_pad - n_used * plan.block_m) * N * es
    nbytes = (n_used * plan.block_m * K * es + experts_used * K * N * es
              + plan.m_pad * N * es + plan.tile_expert.numel() * 4)
    bound, by = _bound_ms(nbytes, 2.0 * rows_real * K * N, "bfloat16")
    ms = timer(run)
    plain = timer(lambda: grouped_matmul_ref(
        lhs, rhs, plan.tile_expert, block_m=plan.block_m), reps=5)
    lib_fn, why = _library_grouped_mm(torch, lhs, rhs, plan)
    lib = timer(lib_fn) if lib_fn is not None else None
    print(f"[kernels] grouped_gemm {tag} bf16 K={K} N={N}: {ms:.4f} ms, twin "
          f"{plain:.4f} ms, library "
          f"{'%.4f ms' % lib if lib is not None else why}; bound {bound:.4f} "
          f"ms by {by} ({nbytes / 1e6:.1f} MB, {zero_fill / 1e6:.1f} MB of it "
          f"the dead tiles' zeros; {n_used} used tiles of "
          f"{plan.m_pad // plan.block_m}, {experts_used} experts)", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def check_grouped_gemm(torch, timer, cfg, device):
    """The forward read at the serving shapes (decode: one token per slot;
    prefill: the largest suffix bucket); timed for the gate/up weights."""
    from repro_torch.kernels.moe import dispatch as dsp, ops
    from repro_torch.kernels.moe.ref import grouped_matmul_ref
    from repro_torch.models.moe import padded_experts

    E, k = padded_experts(cfg.num_experts), cfg.top_k
    d, f = cfg.d_model, cfg.d_ff_expert
    gen = torch.Generator(device=device).manual_seed(1)
    result = None
    for label, T in (("decode", SLOTS), ("prefill", SLOTS * BUF_LEN)):
        idx = _routing(torch, T, cfg.num_experts, k, gen, device)
        plan = dsp.make_plan(idx, E, ops.KERNEL_BLOCK_M)
        for dt in (torch.float32, torch.bfloat16):
            dn = _dtype_name(dt)
            for K, N in ((d, f), (f, d)):
                x = torch.randn((T, K), generator=gen, device=device).to(dt)
                lhs = dsp.permute(x, plan)
                rhs = (torch.randn((E, K, N), generator=gen, device=device)
                       * K ** -0.5).to(dt)
                run = lambda: ops.grouped_matmul_kernel(        # noqa: E731
                    lhs, rhs, plan.tile_expert, plan.block_m, plan.n_used_tiles)
                out = run()
                ref = grouped_matmul_ref(lhs, rhs, plan.tile_expert,
                                         block_m=plan.block_m)
                torch.cuda.synchronize(device)
                err = _check(f"grouped_gemm {label} {dn} K={K} N={N}",
                             out, ref, dn)
                if dn == "bfloat16" and K == d:
                    stats = _time_grouped(torch, timer, label, plan, lhs, rhs,
                                          run, T * k)
                    if label == "decode":
                        result = {"max_abs_err": err, **stats}
                del rhs, ref
    return result


def _paged_scenario(torch, gen, device, dtype, B, H, KV, hd, n_pages, page,
                    extra_pages):
    """Random decode state as the engine leaves it: per-slot t, a shuffled
    page table mapping the pages holding positions <= t, -1 elsewhere, and
    unmapped pages poisoned with in-range stale positions."""
    kv_len = n_pages * page
    P = B * n_pages + extra_pages
    q = torch.randn((B, H, hd), generator=gen, device=device).to(dtype)
    k = torch.randn((P, page, KV, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((P, page, KV, hd), generator=gen, device=device).to(dtype)
    t = torch.randint(PREFIX + TAIL_MIN, BUF_LEN - 1, (B,), generator=gen,
                      device=device).to(torch.int32)
    phys = torch.randperm(P, generator=gen, device=device).tolist()
    th = t.tolist()
    pt = [[-1] * n_pages for _ in range(B)]
    pos = [[o for o in range(page)] for _ in range(P)]     # stale everywhere
    for b in range(B):
        for j in range(min(-(-(th[b] + 1) // page), n_pages)):
            pp = phys[b * n_pages + j]
            pt[b][j] = pp
            pos[pp] = [j * page + o if j * page + o <= th[b] else -1
                       for o in range(page)]
    return (q, k, v, torch.tensor(pos, dtype=torch.int32, device=device),
            torch.tensor(pt, dtype=torch.int32, device=device), t, kv_len)


def check_paged_attention(torch, timer, cfg, device):
    from repro_torch.kernels import paged_attention as pa

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n_pages = BUF_LEN // PAGE
    gen = torch.Generator(device=device).manual_seed(2)
    result = None
    for dt in (torch.float32, torch.bfloat16):
        dn = _dtype_name(dt)
        for window, cap in ((None, None), (8, None), (None, 30.0), (8, 30.0)):
            args = _paged_scenario(torch, gen, device, dt, SLOTS, H, KV, hd,
                                   n_pages, PAGE, extra_pages=3)
            q, k, v, pos, pt, t, kv_len = args
            kw = dict(kv_len=kv_len, window=window, softcap=cap)
            out = pa.paged_attention(q, k, v, pos, pt, t, **kw)
            ref = pa.paged_attention_ref(q, k, v, pos, pt, t, **kw)
            torch.cuda.synchronize(device)
            err = _check(f"paged_attention {dn} window={window} "
                         f"softcap={cap}", out, ref, dn)
            if dn != "bfloat16" or window is not None or cap is not None:
                continue
            n_valid = sum(int(((pos[p] >= 0) & (pos[p] <= t[b])).sum())
                          for b in range(SLOTS)
                          for p in pt[b].tolist() if p >= 0)
            es = q.element_size()
            nbytes = (q.numel() * es + 2 * n_valid * KV * hd * es
                      + pos.numel() * 4 + pt.numel() * 4 + t.numel() * 4
                      + out.numel() * es)
            bound, by = _bound_ms(nbytes, 4.0 * n_valid * H * hd, dn)
            ms = timer(lambda: pa.paged_attention(q, k, v, pos, pt, t, **kw))
            plain = timer(lambda: pa.paged_attention_ref(q, k, v, pos, pt, t,
                                                         **kw))
            print(f"[kernels] paged_attention decode bf16: {ms:.4f} ms, twin "
                  f"{plain:.4f} ms, library none (no single PyTorch call "
                  f"reads K/V through a page table); bound {bound:.5f} ms by "
                  f"{by} ({nbytes / 1e6:.2f} MB, {n_valid} valid positions)",
                  flush=True)
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": by, "library_ms": None}
    return result


def check_grouped_gemm_train(torch, timer, cfg, device):
    """Both reads of the grouped GEMM at the training shape (2048 tokens x
    top-4): the forward out = x @ W, and the backward's d_lhs = ct @ W^T
    with W read transposed in place; for the gate/up weights (E, d, f) and
    the down weights (E, f, d), f32 and bf16; each read timed in bf16 for
    the gate/up weights.  Returns (forward stats, transposed stats)."""
    from repro_torch.kernels.moe import dispatch as dsp, ops
    from repro_torch.kernels.moe.ref import grouped_matmul_ref
    from repro_torch.models.moe import padded_experts

    E, k = padded_experts(cfg.num_experts), cfg.top_k
    d, f = cfg.d_model, cfg.d_ff_expert
    T = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(4)
    idx = _routing(torch, T, cfg.num_experts, k, gen, device)
    plan = dsp.make_plan(idx, E, ops.KERNEL_BLOCK_M)
    te, bm, nu = plan.tile_expert, plan.block_m, plan.n_used_tiles
    result = {}
    for dt in (torch.float32, torch.bfloat16):
        dn = _dtype_name(dt)
        for K, N in ((d, f), (f, d)):               # weights (E, K, N)
            w = (torch.randn((E, K, N), generator=gen, device=device)
                 * K ** -0.5).to(dt)
            x = dsp.permute(torch.randn((T, K), generator=gen,
                                        device=device).to(dt), plan)
            ct = dsp.permute(torch.randn((T, N), generator=gen,
                                         device=device).to(dt), plan)
            reads = {
                # name: (lhs, rhs as the product reads it, kernel launch)
                "forward": (x, w, lambda: ops.grouped_matmul_kernel(
                    x, w, te, bm, nu)),
                "transposed": (ct, w.transpose(1, 2),
                               lambda: ops.grouped_matmul_kernel(
                                   ct, w, te, bm, nu, trans_rhs=True)),
            }
            for name, (lhs, rhs, run) in reads.items():
                out = run()
                ref = grouped_matmul_ref(lhs, rhs, te, block_m=bm)
                torch.cuda.synchronize(device)
                err = _check(f"grouped_gemm {name} train {dn} W=({K},{N})",
                             out, ref, dn)
                if dn == "bfloat16" and K == d:
                    result[name] = {"max_abs_err": err, **_time_grouped(
                        torch, timer, f"{name} train", plan, lhs, rhs, run,
                        T * k)}
                del out, ref
            del w, x, ct
    return result["forward"], result["transposed"]


FLASH_SWEEP_S = 300      # ragged: not a multiple of the kernels' tiles


def _flash_case(torch, fa, gen, device, dt, B, KV, G, S, hd, kw):
    """One (fwd, dq, dkv) evaluation of kernels and twins on random inputs."""
    r = lambda *s: torch.randn(s, generator=gen, device=device).to(dt)  # noqa: E731
    q, k, v, do = r(B, KV * G, S, hd), r(B, KV, S, hd), r(B, KV, S, hd), \
        r(B, KV * G, S, hd)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    delta = torch.sum(do.float() * ro.float(), dim=-1)
    got = {"flash_fwd": (o,), "flash_bwd_dq": (fa.flash_bwd_dq(
        q, k, v, rlse, delta, do, **kw),),
        "flash_bwd_dkv": fa.flash_bwd_dkv(q, k, v, rlse, delta, do, **kw)}
    want = {"flash_fwd": (ro,), "flash_bwd_dq": (fa.flash_bwd_dq_ref(
        q, k, v, rlse, delta, do, **kw),),
        "flash_bwd_dkv": fa.flash_bwd_dkv_ref(q, k, v, rlse, delta, do, **kw)}
    torch.cuda.synchronize(device)
    lse_err = float((lse - rlse).abs().max())
    return (q, k, v, do, rlse, delta), got, want, lse_err, rlse


def check_flash(torch, timer, cfg, device):
    """The three flash kernels against their twins over causal x window x
    softcap x GQA group x head dim, f32 and bf16, at a ragged length; then
    each timed at the training shape with its twin and its library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(5)
    worst = {}
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        dn = _dtype_name(dt)
        for causal in (True, False):
            for window in (None, 64):
                for cap in (None, 30.0):
                    for G in (1, 2):
                        for hd in (64, 128):
                            kw = dict(causal=causal, window=window,
                                      softcap=cap)
                            _, got, want, lse_err, rlse = _flash_case(
                                torch, fa, gen, device, dt, 1, 2, G,
                                FLASH_SWEEP_S, hd, kw)
                            if not lse_err <= 1e-4 * float(rlse.abs().max()):
                                raise RuntimeError(f"flash_fwd lse {kw} G={G} "
                                                   f"hd={hd} {dn}: {lse_err}")
                            for name in got:
                                for a, b in zip(got[name], want[name]):
                                    e = float((a.float() - b.float()).abs().max())
                                    sc = float(b.float().abs().max())
                                    if not e <= TOL[dn] * max(sc, 1e-30):
                                        raise RuntimeError(
                                            f"{name} {kw} G={G} hd={hd} {dn}: "
                                            f"max|err| {e} > {TOL[dn]} * {sc}")
                                    key = (name, dn)
                                    worst[key] = max(worst.get(key, 0.0),
                                                     e / max(sc, 1e-30))
                            n += 1
    for (name, dn), rel in sorted(worst.items()):
        print(f"[kernels] {name} {dn}: {n // 2} cases at S={FLASH_SWEEP_S} "
              f"(causal x window{{none,64}} x softcap{{none,30}} x G{{1,2}} x "
              f"hd{{64,128}}), worst max|err|/max|ref| {rel:.3e} "
              f"(tol {TOL[dn]:.0e})", flush=True)

    # the training shape
    B, H, S, hd = TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, cfg.head_dim
    KV = cfg.num_kv_heads
    kw = dict(causal=True, window=None, softcap=cfg.logit_softcap)
    (q, k, v, do, rlse, delta), got, want, _, _ = _flash_case(
        torch, fa, gen, device, torch.bfloat16, B, KV, H // KV, S, hd, kw)
    es = q.element_size()
    act = B * H * S * hd * es                         # one (B,H,S,hd) tensor
    kv_b = B * KV * S * hd * es
    row = B * H * S * 4                               # lse / delta
    pairs = S * S / 2                                 # causal: half the tiles
    shapes = {
        # name: (bytes moved, flops, kernel, twin)
        "flash_fwd": (act + 2 * kv_b + act + row, 4.0 * B * H * pairs * hd,
                      lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_attention_fwd_ref(q, k, v, **kw)),
        "flash_bwd_dq": (2 * act + 2 * kv_b + 2 * row + act,
                         6.0 * B * H * pairs * hd,
                         lambda: fa.flash_bwd_dq(q, k, v, rlse, delta, do, **kw),
                         lambda: fa.flash_bwd_dq_ref(q, k, v, rlse, delta, do,
                                                     **kw)),
        "flash_bwd_dkv": (2 * act + 2 * kv_b + 2 * row + 2 * kv_b,
                          8.0 * B * H * pairs * hd,
                          lambda: fa.flash_bwd_dkv(q, k, v, rlse, delta, do,
                                                   **kw),
                          lambda: fa.flash_bwd_dkv_ref(q, k, v, rlse, delta,
                                                       do, **kw)),
    }
    # library yardsticks: PyTorch's fused attention forward, and its
    # backward, which computes dq, dk and dv in one call
    rep = H // KV
    kl, vl = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(q, kl, vl,
                                                           is_causal=True))
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, kl, vl))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_bwd = timer(lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                retain_graph=True))
    del out, qr, kr, vr
    results = {}
    for name, (nbytes, flops, kern, twin) in shapes.items():
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[name], want[name]))
        scale = max(float(b.float().abs().max()) for b in want[name])
        if not err <= TOL["bfloat16"] * scale:
            raise RuntimeError(f"{name} at the training shape: {err}")
        bound, by = _bound_ms(nbytes, flops, "bfloat16")
        ms = timer(kern)
        plain = timer(twin, reps=5)
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        print(f"[kernels] {name} train bf16 (B={B}, H={H}, S={S}, hd={hd}, "
              f"causal): {ms:.4f} ms, twin {plain:.4f} ms, library "
              f"{lib:.4f} ms ({'scaled_dot_product_attention' if name == 'flash_fwd' else 'its backward: dq, dk and dv in one call'}); "
              f"bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); max|err| {err:.3e} at max|ref| "
              f"{scale:.3e}", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": lib}
    return results


# wkv cases: (B, H, S, C, chunk), and decay ranges (w_lo, w_hi)
WKV_CASES = ((1, 1, 64, 64, 64), (2, 3, 128, 32, 16), (3, 5, 320, 64, 32),
             (1, 7, 960, 32, 64), (2, 40, 1024, 64, 32))
WKV_DECAYS = ((1e-6, 1e-6), (0.999, 0.999), (1e-6, 0.999))


def _wkv_inputs(torch, gen, device, B, H, S, C, w_lo=0.01, w_hi=0.99):
    """r, k, v ~ 0.5 N(0, 1), u ~ 0.3 N(0, 1); w log-uniform in
    [w_lo, w_hi]."""
    rn = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    lo, hi = float(torch.log(torch.tensor(w_lo))), float(torch.log(
        torch.tensor(w_hi)))
    w = torch.exp(lo + (hi - lo) * torch.rand((B, H, S, C), generator=gen,
                                              device=device))
    return (0.5 * rn(B, H, S, C), 0.5 * rn(B, H, S, C), 0.5 * rn(B, H, S, C),
            w, 0.3 * rn(H, C))


def _wkv_ops(B, H, S, C, T):
    """f32 operations of the chunked wkv for these shapes: A's causal
    channel sums (sub, two muls, add per channel-pair) and its bonus
    diagonal, A.v over s <= t, the state read-out and update, and the two
    decay scalings; plus the exps (on the SFUs, reported apart)."""
    pairs = T * (T - 1) // 2
    per_chunk = (pairs * C * 4 + T * C * 3 + (T * (T + 1) // 2) * C * 2
                 + 2 * T * C * C + 2 * T * C * C + C * C + T * C * 3)
    n = B * H * (S // T)
    return n * per_chunk, n * (pairs * C + 2 * T * C + C)


def check_wkv(torch, timer, rcfg, device):
    """The wkv kernel against its twin in f32 over WKV_CASES and the decay
    extremes, then timed at rwkv6-3b's training shape."""
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models.ssm import KERNEL_CHUNK, rwkv_dims

    gen = torch.Generator(device=device).manual_seed(6)
    for B, H, S, C, T in WKV_CASES:
        args = _wkv_inputs(torch, gen, device, B, H, S, C)
        out = rw.rwkv6_scan(*args, chunk=T)
        ref = rw.rwkv6_scan_ref(*args, chunk=T)[0]
        torch.cuda.synchronize(device)
        _check(f"rwkv6_scan B={B} H={H} S={S} C={C} T={T}", out, ref,
               "float32")
    for lo, hi in WKV_DECAYS:
        args = _wkv_inputs(torch, gen, device, 1, 8, 512, 64, lo, hi)
        out = rw.rwkv6_scan(*args)
        ref = rw.rwkv6_scan_ref(*args)[0]
        torch.cuda.synchronize(device)
        _check(f"rwkv6_scan decays in [{lo:g}, {hi:g}]", out, ref, "float32")

    H, C = rwkv_dims(rcfg)
    B, S, T = RWKV_BATCH, RWKV_SEQ, KERNEL_CHUNK
    args = _wkv_inputs(torch, gen, device, B, H, S, C)
    out = rw.rwkv6_scan(*args, chunk=T)
    ref = rw.rwkv6_scan_ref(*args, chunk=T)[0]
    torch.cuda.synchronize(device)
    err = _check(f"rwkv6_scan train B={B} H={H} S={S} C={C} T={T}", out, ref,
                 "float32")
    del out, ref
    nbytes = 5 * B * H * S * C * 4 + H * C * 4    # r, k, v, w in; o out; u
    ops, exps = _wkv_ops(B, H, S, C, T)
    bound, by = _bound_ms(nbytes, ops, "float32")
    ms = timer(lambda: rw.rwkv6_scan(*args, chunk=T))
    plain = timer(lambda: rw.rwkv6_scan_ref(*args, chunk=T), reps=5)
    # the backward, autograd over the twin (no kernel; one call per layer
    # and step): its time and what it allocates above its inputs
    ins = [a.detach().requires_grad_() for a in args]
    out = rw.rwkv6_scan_trainable(*ins, chunk=T)
    ct = torch.randn(out.shape, generator=gen, device=device)
    backward = lambda: torch.autograd.grad(out, ins, ct,  # noqa: E731
                                           retain_graph=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    backward()
    torch.cuda.synchronize(device)
    above = torch.cuda.max_memory_allocated(device) - before
    bwd_ms = timer(backward, reps=5)
    del ins, out, ct
    print(f"[kernels] rwkv6_scan backward (autograd over the twin, no "
          f"kernel) at the same shape: {bwd_ms:.4f} ms per call, "
          f"{above / 2**30:.3f} GiB above its inputs", flush=True)
    print(f"[kernels] rwkv6_scan train f32 (B={B}, H={H}, S={S}, C={C}, "
          f"T={T}): {ms:.4f} ms, twin {plain:.4f} ms, library none (no "
          f"PyTorch call computes the wkv recurrence); bound {bound:.4f} ms by "
          f"{by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP f32, and "
          f"{exps / 1e6:.1f} M exps on the SFUs); {B * H} blocks on "
          f"{torch.cuda.get_device_properties(device).multi_processor_count} "
          f"SMs", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


RMSNORM_SHAPES = ((4, 128), (2, 7, 300), (1, 128, 2048), (2048, 2560))


def check_rmsnorm(torch, timer, device):
    """The standalone rmsnorm against its twin in f32 and bf16, timed at
    (2048, 2560) bf16 with ``torch.nn.functional.rms_norm`` as the library
    yardstick (the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device).manual_seed(7)
    result = None
    for dt in (torch.float32, torch.bfloat16):
        dn = _dtype_name(dt)
        for shape in RMSNORM_SHAPES:
            x = torch.randn(shape, generator=gen, device=device).to(dt)
            scale = (0.2 * torch.randn(shape[-1:], generator=gen,
                                       device=device)).to(dt)
            err = _check(f"rmsnorm {dn} {shape}", rn.rmsnorm(x, scale),
                         rn.rmsnorm_ref(x, scale), dn)
            if dn != "bfloat16" or shape != RMSNORM_SHAPES[-1]:
                continue
            rows, d = shape
            nbytes = 2 * rows * d * x.element_size() + d * 4
            bound, by = _bound_ms(nbytes, 5.0 * rows * d, "float32")
            ms = timer(lambda: rn.rmsnorm(x, scale))
            plain = timer(lambda: rn.rmsnorm_ref(x, scale))
            weight = (1.0 + scale.float()).to(dt)
            lib = timer(lambda: F.rms_norm(x, (d,), weight, 1e-6))
            print(f"[kernels] rmsnorm bf16 {shape}: {ms:.4f} ms, twin "
                  f"{plain:.4f} ms, library {lib:.4f} ms "
                  f"(torch.nn.functional.rms_norm); bound {bound:.5f} ms by "
                  f"{by} ({nbytes / 1e6:.1f} MB)", flush=True)
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": by, "library_ms": lib}
    return result


def phase_kernels(cfg, rcfg, device):
    import torch
    timer = Timer(torch, device)
    fwd_train, transposed = check_grouped_gemm_train(torch, timer, cfg,
                                                     device)
    out = {"grouped_gemm": check_grouped_gemm(torch, timer, cfg, device),
           "grouped_gemm_transposed": transposed,
           "paged_attention": check_paged_attention(torch, timer, cfg, device)}
    # the row's headline is the decode shape (PR 11's); the train path
    # launches the same read at 2048 tokens
    out["grouped_gemm"]["train_shape"] = fwd_train
    out.update(check_flash(torch, timer, cfg, device))
    out["rwkv6_scan"] = check_wkv(torch, timer, rcfg, device)
    out["rmsnorm"] = check_rmsnorm(torch, timer, device)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 3

def _prompts(np, vocab):
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(4, vocab, size=PREFIX).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        4, vocab, size=int(rng.integers(TAIL_MIN, TAIL_MAX + 1))).astype(np.int32)])
        for _ in range(N_REQUESTS)]


def _teacher_forced_check(torch, model, params, done, prompts):
    """Re-run each request's prompt plus its generated tokens through the
    dense prefill path (plain attention over a contiguous KV buffer) and
    require every generated token to be the argmax there up to bf16 drift:
    its logit within 5e-2 * max|logit| of the row's maximum.  The two paths
    round bf16 activations in different places through 24 layers, which
    moves logits by about 1e-2 of their scale and can flip near-ties; a
    token read from a wrong page or position lands far outside (a random
    token sits ~0.5 of the scale below the maximum)."""
    worst, same, total = 0.0, 0, 0
    for uid, p in enumerate(prompts):
        gen = done[uid].generated
        seq = torch.tensor(list(p) + gen[:-1], dtype=torch.int64,
                           device=params["embed"].device)[None]
        cache = model.init_cache(params, 1, BUF_LEN)
        h, _ = model.decode_step_hidden(params, cache, seq)
        logits = model.lm_logits(params, h[0, len(p) - 1:]).float()
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"request {uid}: non-finite logits")
        picked = logits.gather(1, torch.tensor(gen, device=logits.device)[:, None])[:, 0]
        top = logits.max(dim=1).values
        gap = float(((top - picked) / logits.abs().max(dim=1).values).max())
        worst = max(worst, gap)
        same += int((logits.argmax(dim=1).cpu() == torch.tensor(gen)).sum())
        total += len(gen)
    print(f"[serve] teacher-forced dense check: {same}/{total} tokens are the "
          f"dense argmax; worst (max-picked)/max|logit| = {worst:.3e}",
          flush=True)
    if worst > 5e-2:
        raise RuntimeError(f"generated tokens disagree with the dense "
                           f"forward: gap {worst}")


def phase_serve(cfg, device):
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine

    model = Model(cfg)
    print(f"[serve] {cfg.name}: {model.num_params():,} params, "
          f"{cfg.num_layers} layers, d={cfg.d_model}, dtype {cfg.dtype}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(SEED),
                        device)
    torch.cuda.synchronize(device)
    print(f"[serve] weights drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    tel = obs.Telemetry(role="serve", config=cfg.name)
    eng = ServingEngine(model, params, slots=SLOTS, buf_len=BUF_LEN,
                        telemetry=tel, page_size=PAGE)
    prompts = _prompts(np, cfg.vocab_size)

    _reset_counts()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=GEN, eos_id=-1,
                           temperature=0.0, seed=uid))
    done = eng.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = _read_counts()

    steps = tel.counter("serve.decode_steps").value
    n_tok = sum(len(r.generated) for r in done.values())
    prefill = tel.histogram("span.serve.prefill_admit")
    window = tel.histogram("span.serve.decode_window")
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.2f} tok/s; {steps} decode steps; prefill "
          f"{prefill.count} calls, {prefill.sum:.3f} s; decode windows "
          f"{window.count} x {eng.drain_every} steps, {window.sum:.3f} s "
          f"({window.sum / max(steps, 1) * 1e3:.2f} ms/step)", flush=True)
    print(f"[serve] prefix hits {tel.counter('serve.prefix_hits').value} "
          f"({tel.counter('serve.prefix_hit_tokens').value} tokens); "
          f"launches {launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
          flush=True)

    if len(done) != N_REQUESTS or any(
            r.rejected or len(r.generated) != GEN for r in done.values()):
        raise RuntimeError("not every request finished with its tokens")
    if tel.counter("serve.prefix_hits").value <= 0:
        raise RuntimeError("the radix prefix cache never hit")
    for name in ("grouped_gemm", "paged_attention"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} kernel never launched on the serve "
                               f"path")
    if launches["paged_attention"] != cfg.num_layers * steps:
        raise RuntimeError(f"paged attention launched "
                           f"{launches['paged_attention']} times, expected "
                           f"{cfg.num_layers} x {steps} decode steps")
    for r in done.values():
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise RuntimeError(f"request {r.uid}: token out of range")
    _teacher_forced_check(torch, model, params, done, prompts)
    return launches


# ------------------------------------------------------------- phase 4

def _train_cfg(cfg):
    return cfg.replace(num_layers=TRAIN_LAYERS, moe_backend="grouped",
                       use_flash_kernel=True)


def _reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels.moe import ops
    ops.LAUNCHES = ops.TRANS_LAUNCHES = pa.LAUNCHES = 0
    rw.LAUNCHES = rn.LAUNCHES = 0
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0


def _read_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels.moe import ops
    return {"grouped_gemm": ops.LAUNCHES,
            "grouped_gemm_transposed": ops.TRANS_LAUNCHES,
            "paged_attention": pa.LAUNCHES, **fa.LAUNCHES,
            "rwkv6_scan": rw.LAUNCHES, "rmsnorm": rn.LAUNCHES}


def _train(tcfg, device, tag, batch, seq, what):
    """``TRAIN_STEPS`` steps of ``tcfg`` through ``train.driver.train`` on
    random weights from seed 0, AdamW, stage 2 from step STAGE1 + 1, no
    checkpoint; the kernel counters zeroed just before and read just after.
    Raises unless every step ran with a finite loss and grad norm.  Returns
    (model, params, data config, launches, steps)."""
    import math
    import torch
    from repro_torch import obs
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train import driver

    model = Model(tcfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    print(f"[{tag}] {tcfg.name} {what}: {model.num_params():,} params, "
          f"{tcfg.num_layers} layers, d={tcfg.d_model}, dtype {tcfg.dtype}, "
          f"batch {batch} x {seq}, {TRAIN_STEPS} steps, stage 2 from step "
          f"{STAGE1 + 1}; memory in use before "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB", flush=True)
    tel = obs.Telemetry()
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=seq,
                    global_batch=batch)
    rc = driver.RunConfig(total_steps=TRAIN_STEPS, stage1_steps=STAGE1,
                          ckpt_dir=None, log_every=TRAIN_STEPS)
    opt = AdamW(lr=1e-4, weight_decay=0.01,
                lr_schedule=cosine_schedule(STAGE1, TRAIN_STEPS))
    _reset_counts()
    t0 = time.perf_counter()
    params, opt_state, losses = driver.train(
        model, opt, dc, rc, device=device, seed=SEED, telemetry=tel,
        log_fn=lambda m: print(f"[{tag}] {m}", flush=True))
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    steps = [e for e in tel.events if e["kind"] == "train_step"]
    for e in steps:
        print(f"[{tag}] step {e['step']} stage {e['stage']}: loss "
              f"{e['loss']:.6f}, grad norm {e['grad_norm']:.6f}, "
              f"{e['step_s']:.3f} s", flush=True)
    steady = [e["step_s"] for e in steps[1:]]
    step_s = sum(steady) / len(steady)
    print(f"[{tag}] {len(steps)} steps in {wall:.2f} s (weights drawn on the "
          f"card included); steps 2-{len(steps)}: {step_s:.3f} s/step, "
          f"{1 / step_s:.3f} steps/s, {batch * seq / step_s:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"[{tag}] launches {launches} ({len(steps)} steps)", flush=True)
    if len(steps) != TRAIN_STEPS:
        raise RuntimeError(f"{len(steps)} train steps ran, not {TRAIN_STEPS}")
    if not all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"])
               for e in steps):
        raise RuntimeError("a non-finite loss or grad norm")
    if tel.counter("train.nonfinite_grad_steps").value:
        raise RuntimeError("the optimizer skipped a non-finite step")
    del opt_state
    return model, params, dc, launches, len(steps)


def phase_train(cfg, device):
    tcfg = _train_cfg(cfg)
    model, params, dc, launches, _ = _train(
        tcfg, device, "train", TRAIN_BATCH, TRAIN_SEQ,
        "cut to 4 layers (full width)")
    for name in QWEN_TRAIN_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"{name} kernel never launched on the train "
                               f"path")
    return model, params, dc, launches


def phase_train_rwkv(rcfg, device):
    """Phase 6: rwkv6-3b at full width and depth, then the reversible check
    at 1 x 2048 (phase 5's, at 32 layers)."""
    import torch
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.train.trainer import to_device_batch

    model, params, dc, launches, n_steps = _train(
        rcfg, device, "train-rwkv", RWKV_BATCH, RWKV_SEQ,
        "at full width and full depth")
    want = 3 * rcfg.num_layers * n_steps
    if launches["rwkv6_scan"] != want:
        raise RuntimeError(f"the wkv kernel launched {launches['rwkv6_scan']} "
                           f"times, expected 3 x {rcfg.num_layers} layers x "
                           f"{n_steps} steps = {want}")
    batch = to_device_batch(next(packed_batches(dc)), device)
    _reversible_check(torch, model, params, batch, device,
                      f"rwkv batch {RWKV_BATCH} x {RWKV_SEQ}", breakdown=True)
    return launches


# ------------------------------------------------------------- phase 5

def _cosine(torch, a, b):
    """cos(a, b) over flat f32 chunks; 1.0 when both are exactly zero."""
    dot = na = nb = 0.0
    fa_, fb_ = a.reshape(-1), b.reshape(-1)
    for lo in range(0, fa_.numel(), 1 << 26):
        x, y = fa_[lo:lo + (1 << 26)].float(), fb_[lo:lo + (1 << 26)].float()
        dot += float((x * y).sum())
        na += float((x * x).sum())
        nb += float((y * y).sum())
    if na == 0.0 and nb == 0.0:
        return 1.0
    return dot / max((na * nb) ** 0.5, 1e-300)


def _reversible_check(torch, model, params, batch, device, label,
                      breakdown):
    from repro_torch.core.reversible import inversion_errors
    from repro_torch.launch.profiling import live_at_peak, memory_history
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train.trainer import value_and_grad

    res = {}
    for sm in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        with (memory_history() if breakdown else contextlib.nullcontext(
                {})) as hist:
            loss, grads = value_and_grad(
                lambda p, b: model.loss(p, b, save_memory=sm), params, batch)
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        if breakdown:
            above, rows = live_at_peak(hist["snapshot"], device.index or 0)
            print(f"[reversible] {label} save_memory={sm}: at the peak, "
                  f"{above / 2**30:.2f} GiB allocated during the call are "
                  f"live; largest groups (count x block, site): " + "; ".join(
                      f"{b / 2**30:.3f} GiB = {c} x {sz / 2**20:.1f} MiB "
                      f"{site}" for b, c, sz, site in rows), flush=True)
        # park the grads on the host so the next mode's peak is its own
        res[sm] = (float(loss), {k: g.to("cpu") for k, g in tree_leaves(grads)},
                   peak, base)
        del grads
        print(f"[reversible] {label} save_memory={sm}: loss {float(loss)!r}; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB ("
              f"{(peak - base) / 2**30:.2f} GiB above the "
              f"{base / 2**30:.2f} GiB of weights and batch)", flush=True)
    (l_rev, g_rev, p_rev, base), (l_all, g_all, p_all, _) = res[True], res[False]
    cos = {k: _cosine(torch, g_rev[k].to(device), g_all[k].to(device))
           for k in g_rev}
    worst = min(cos, key=cos.get)
    print(f"[reversible] {label} {len(cos)} grad leaves; smallest cosine "
          f"{cos[worst]:.6f} at {'/'.join(worst)}; per leaf: " + ", ".join(
              f"{'/'.join(k)} {v:.6f}" for k, v in sorted(cos.items())),
          flush=True)
    print(f"[reversible] {label} peak with stored activations "
          f"{p_all / 2**30:.2f} GiB, reversible {p_rev / 2**30:.2f} GiB: "
          f"{(p_all - p_rev) / 2**30:.2f} GiB saved at "
          f"{model.cfg.num_layers} layers", flush=True)
    s = model.stacks[0]
    x1, x2, ctx = model._embed_streams(params, batch["tokens"])
    errs = inversion_errors(s.fwd, s.inv, params["stacks"][s.name], {}, ctx,
                            x1, x2, s.n)
    for i, (mx, mean, rel) in enumerate(errs):
        print(f"[reversible] {label} layer {i}: reconstruction max|err| "
              f"{mx:.4e}, mean|err| {mean:.4e}, rel {rel:.4e}", flush=True)
    if l_rev != l_all:
        raise RuntimeError(f"{label}: losses differ: {l_rev!r} vs {l_all!r}")
    if not cos[worst] >= MIN_GRAD_COSINE:
        raise RuntimeError(f"{label}: grad cosine {cos[worst]} < "
                           f"{MIN_GRAD_COSINE}")


def phase_reversible(model, params, dc, device):
    import dataclasses
    import torch
    from repro_torch.data.pipeline import packed_batches
    from repro_torch.train.trainer import to_device_batch

    for b in REV_BATCHES:
        dcb = dataclasses.replace(dc, global_batch=b)
        batch = to_device_batch(next(packed_batches(dcb)), device)
        _reversible_check(torch, model, params, batch, device,
                          f"batch {b} x {dc.seq_len}",
                          breakdown=b == REV_BATCHES[0])


# ---------------------------------------------------------------- main

SOURCES = {
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/moe/grouped_gemm.py:36"),
    "grouped_gemm_transposed": ("src/repro_torch/csrc/grouped_gemm.cu",
                                "src/repro/kernels/moe/grouped_gemm.py:36"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:100"),
    "flash_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:64"),
    "flash_bwd_dq": ("src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:195"),
    "flash_bwd_dkv": ("src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:225"),
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:27"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:15"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2-moe-a2.7b").replace(moe_backend="grouped")
    rcfg = get_config(RWKV_ARCH).replace(use_flash_kernel=True)

    t0 = time.perf_counter()

    def done(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_build()
    done("build")
    stats = phase_kernels(cfg, rcfg, device)
    done("kernels")
    by_path = {"serve": phase_serve(cfg, device)}
    done("serve")
    model, params, dc, by_path["train"] = phase_train(cfg, device)
    done("train")
    phase_reversible(model, params, dc, device)
    done("reversible")
    del model, params
    by_path["train-rwkv"] = phase_train_rwkv(rcfg, device)
    done("train-rwkv")

    rows = []
    for name, (src, replaces) in SOURCES.items():
        paths = {p: c[name] for p, c in by_path.items() if c[name]}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": sum(paths.values()),
                     "launches_by_path": paths, **stats[name]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
