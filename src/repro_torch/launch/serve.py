"""Serving launcher for the port: the paged continuous-batching engine with
on-device sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        [--no-reduced] [--paged] [--device {cuda,cpu}] [--seed S] \
        [--requests 8] [--slots 4] [--gen 32] [--temperature 0.8] \
        [--top-k 40] [--top-p 0.95] [--drain-every 4] [--page-size 16] \
        [--kv-pages N] [--shared-prefix N] [--no-prefix-cache]

The flags are the reference launcher's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; a machine without a GPU needs
``--device cpu``), ``--seed`` (weights are random, drawn from a seeded
``torch.Generator`` on the device) and ``--profile``.  MoE configs run with
``moe_backend="grouped"``, the one MoE backend this port has.  The paged
engine is the only one ported, so ``--paged`` is accepted and is the
default.  The reference's ``--kv-budget-gb`` and ``--telemetry PATH`` are
not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.profiling import maybe_profile, print_profile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight and prompt draws")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length (prompts are mixed 4..this)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--buf-len", type=int, default=0,
                    help="cache buffer (0 -> shared-prefix + prompt-len + gen)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--drain-every", type=int, default=4)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the block-paged KV pool (the only "
                         "engine mode ported, and the default)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="physical KV pages in the pool (0 -> slots * "
                         "pages-per-slot)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the same N-token system prefix")
    ap.add_argument("--lookahead", type=int, default=8)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the workload-mirroring warmup pass")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the timed run with torch.profiler and print "
                         "the N ops with the most self time on the device "
                         "and on the host, and the device's busy share")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import devices, obs
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine

    dev = devices.resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.num_experts and cfg.moe_backend != "grouped":
        cfg = cfg.replace(moe_backend="grouped")
        print("[serve] moe_backend=grouped (the only MoE backend ported)")
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, dev)

    tel = obs.Telemetry(role="serve", config=cfg.name, slots=args.slots,
                        drain_every=args.drain_every, paged=True)
    buf = args.buf_len or (args.shared_prefix + args.prompt_len + args.gen)
    eng = ServingEngine(model, params, slots=args.slots, buf_len=buf,
                        drain_every=args.drain_every, telemetry=tel,
                        lookahead=args.lookahead,
                        page_size=args.page_size,
                        kv_pages=args.kv_pages or None,
                        prefix_cache=args.prefix_cache)

    rng = np.random.default_rng(args.seed)
    lo = 4
    sys_prefix = rng.integers(lo, cfg.vocab_size,
                              size=args.shared_prefix).astype(np.int32)
    prompts = []
    for uid in range(args.requests):
        plen = int(rng.integers(4, max(5, args.prompt_len + 1)))
        tail = rng.integers(lo, cfg.vocab_size, size=plen).astype(np.int32)
        prompts.append(np.concatenate([sys_prefix, tail])
                       if args.shared_prefix else tail)

    if not args.no_warmup:
        # warmup mirrors the workload (same lengths and prefix structure,
        # shifted token values) so the timed run starts with warm kernels
        span = max(cfg.vocab_size - lo, 1)
        for i, p in enumerate(prompts):
            wp = (lo + (p - lo + 1) % span).astype(np.int32)
            eng.submit(Request(uid=1_000_000 + i, prompt=wp,
                               max_new_tokens=2, eos_id=-1,
                               temperature=args.temperature, seed=i))
        eng.run()
        eng.done.clear()

    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.gen,
                           eos_id=-1, temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p, seed=uid))

    with maybe_profile(args.profile, dev) as prof:
        t0 = time.perf_counter()
        done = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    if prof is not None:
        print_profile(prof, args.profile, dt)
    n_tok = sum(len(r.generated) for r in done.values())
    print(f"[serve] {args.arch} on {dev}: {len(done)} requests, {n_tok} "
          f"tokens, {n_tok / dt:.1f} tok/s (slots={args.slots}, "
          f"drain_every={args.drain_every}, "
          f"temperature={args.temperature}, top_k={args.top_k}, "
          f"top_p={args.top_p})")
    print(f"[serve] paged: {eng.kv_pages} pages x {eng.page_size} tok "
          f"(used {eng.page_pool.n_used}, free {eng.page_pool.n_free}), "
          f"prefix hits {tel.counter('serve.prefix_hits').value} "
          f"({tel.counter('serve.prefix_hit_tokens').value} tokens skipped)")
    print(f"[serve] request 0 tokens: {done[0].generated[:12]}")
    return done


if __name__ == "__main__":
    main()
