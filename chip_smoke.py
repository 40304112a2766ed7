#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero):

  1. build    compile every CUDA kernel of the serving path from
              src/repro_torch/csrc with nvcc for sm_90a; print the seconds.
  2. kernels  hold each kernel against its plain PyTorch twin on the card at
              the serving path's shapes, in f32 and bf16 (max|err| <=
              1e-4 * max|ref| in f32, <= 2e-2 * max|ref| in bf16: the sums
              run in another order and bf16 outputs round), and time kernel,
              twin and — where one PyTorch call computes the same function —
              that library call, with the L2 cache flushed before each launch.
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

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit
(nvidia-smi), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

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


def check_grouped_gemm(torch, timer, cfg, device):
    from repro_torch.kernels.moe import dispatch as dsp, ops
    from repro_torch.kernels.moe.ref import grouped_matmul_ref
    from repro_torch.models.moe import padded_experts

    E, k = padded_experts(cfg.num_experts), cfg.top_k
    d, f = cfg.d_model, cfg.d_ff_expert
    gen = torch.Generator(device=device).manual_seed(1)
    result = None
    # decode: one token per slot; prefill: the largest suffix bucket
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
                out = ops.grouped_matmul(lhs, rhs, plan.tile_expert,
                                         plan.block_m, plan.n_used_tiles)
                ref = grouped_matmul_ref(lhs, rhs, plan.tile_expert,
                                         block_m=plan.block_m)
                torch.cuda.synchronize(device)
                err = _check(f"grouped_gemm {label} {dn} K={K} N={N}",
                             out, ref, dn)
                if dn != "bfloat16" or K != d:
                    del rhs, ref
                    continue
                # time the gate/up projection in the serving dtype
                n_used = int(plan.n_used_tiles)
                rows_real = T * k
                experts_used = int((plan.group_sizes > 0).sum())
                es = lhs.element_size()
                # the whole (m_pad, N) output counts: the function's contract
                # (the reference's) writes zeros to the dead tiles
                zero_fill = (plan.m_pad - n_used * plan.block_m) * N * es
                nbytes = (n_used * plan.block_m * K * es          # used lhs rows
                          + experts_used * K * N * es             # their weights
                          + plan.m_pad * N * es                   # output
                          + plan.tile_expert.numel() * 4)
                bound, by = _bound_ms(nbytes, 2.0 * rows_real * K * N, dn)
                ms = timer(lambda: ops.grouped_matmul(
                    lhs, rhs, plan.tile_expert, plan.block_m, plan.n_used_tiles))
                plain = timer(lambda: grouped_matmul_ref(
                    lhs, rhs, plan.tile_expert, block_m=plan.block_m), reps=5)
                lib_fn, why = _library_grouped_mm(torch, lhs, rhs, plan)
                lib = timer(lib_fn) if lib_fn is not None else None
                print(f"[kernels] grouped_gemm {label} bf16 K={K} N={N}: "
                      f"{ms:.4f} ms, twin {plain:.4f} ms, library "
                      f"{'%.4f ms' % lib if lib is not None else why}; "
                      f"bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
                      f"{zero_fill / 1e6:.1f} MB of it the dead tiles' zeros; "
                      f"{n_used} used tiles of {plan.m_pad // plan.block_m}, "
                      f"{experts_used} experts)", flush=True)
                if label == "decode":
                    result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib}
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


def phase_kernels(cfg, device):
    import torch
    timer = Timer(torch, device)
    gg = check_grouped_gemm(torch, timer, cfg, device)
    pa = check_paged_attention(torch, timer, cfg, device)
    del timer
    torch.cuda.empty_cache()
    return {"grouped_gemm": gg, "paged_attention": pa}


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
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.moe import ops
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

    ops.LAUNCHES = 0
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=GEN, eos_id=-1,
                           temperature=0.0, seed=uid))
    done = eng.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"grouped_gemm": ops.LAUNCHES, "paged_attention": pa.LAUNCHES}

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
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{name} kernel never launched on the main path")
    if launches["paged_attention"] != cfg.num_layers * steps:
        raise RuntimeError(f"paged attention launched "
                           f"{launches['paged_attention']} times, expected "
                           f"{cfg.num_layers} x {steps} decode steps")
    for r in done.values():
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise RuntimeError(f"request {r.uid}: token out of range")
    _teacher_forced_check(torch, model, params, done, prompts)
    return launches


# ---------------------------------------------------------------- main

SOURCES = {
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/moe/grouped_gemm.py:36"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:100"),
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

    phase_build()
    stats = phase_kernels(cfg, device)
    launches = phase_serve(cfg, device)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **stats[name]})
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
