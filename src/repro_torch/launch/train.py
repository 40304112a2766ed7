"""Training launcher for the port: two-stage reversible full-parameter
fine-tuning.

    PYTHONPATH=src python -m repro_torch.launch.train \
        [--arch {qwen2-moe-a2.7b,rwkv6-3b}] \
        [--reduced] [--layers N] [--device {cuda,cpu}] [--steps 100] [--stage1 20] \
        [--batch 4] [--seq 256] [--lr 1e-3] [--n-micro 1] \
        [--moe-backend grouped] [--use-flash-kernel] [--ckpt-dir DIR] \
        [--ckpt-every N] [--profile N]

The flags are the reference launcher's (``repro.launch.train``) plus
``--device`` (default ``cuda``; a machine without a GPU needs
``--device cpu``), ``--seed`` (weights are random, drawn from a seeded
``torch.Generator`` on the device), ``--layers`` (cut the depth, keep
every width: full-depth qwen2-moe-a2.7b with AdamW's state needs ~184 GB,
more than one card holds; rwkv6-3b, ~42 GB, trains at full depth),
``--ckpt-dir`` (no default: without it the
run writes no checkpoint and resumes from none — a full-width checkpoint
is tens of GB), ``--ckpt-every`` (default: a fifth of the run, as the
reference hard-codes; 0: never) and ``--profile N`` (trace the run with
torch.profiler, as ``launch.serve`` does).  Flags whose paths are not ported yet
raise (ROADMAP.md queue 1): ``--optimizer lomo|galore``, ``--compress``,
``--fused-optimizer``, ``--ep``, ``--layer-groups``/``--delta-rank``,
``--plan``/``--hbm-budget-gb``, ``--telemetry``, ``--audit-every``; so does
the einsum MoE backend, the reference config's default — MoE configs need
``--moe-backend grouped`` (a non-MoE family such as rwkv6-3b needs no MoE
flag).  With ``--use-flash-kernel`` the card runs the CUDA flash-attention
kernels and grouped GEMMs for qwen2-moe-a2.7b, and the CUDA wkv kernel for
rwkv6-3b.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.profiling import maybe_profile, print_profile


def _not_ported(flag: str):
    return NotImplementedError(
        f"{flag}: not ported yet (ROADMAP.md queue 1)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the main stack to this many layers (0: keep)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weight draw")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stage1", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "lomo", "galore"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and checkpoint into this directory "
                         "(default: neither)")
    ap.add_argument("--ckpt-every", type=int, default=None, metavar="N",
                    help="checkpoint every N steps (default steps // 5; "
                         "0: never)")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--fused-optimizer", action="store_true")
    ap.add_argument("--hbm-budget-gb", type=float, default=None)
    ap.add_argument("--plan", action="store_true")
    ap.add_argument("--moe-backend", default=None,
                    choices=["einsum", "grouped"],
                    help="override ModelConfig.moe_backend (only grouped is "
                         "ported)")
    ap.add_argument("--ep", type=int, default=0)
    ap.add_argument("--layer-groups", type=int, default=0)
    ap.add_argument("--delta-rank", type=int, default=0)
    ap.add_argument("--use-flash-kernel", action="store_true",
                    help="the train path's kernels: flash attention, or the "
                         "wkv scan for rwkv6 (CUDA kernels on the card, "
                         "their plain twins on the CPU)")
    ap.add_argument("--audit-every", type=int, default=0, metavar="N")
    ap.add_argument("--telemetry", default=None, metavar="PATH")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the run with torch.profiler and print the N "
                         "ops with the most self time on the device and on "
                         "the host, and the device's busy share")
    args = ap.parse_args(argv)

    unported = [("--optimizer " + args.optimizer, args.optimizer != "adamw"),
                ("--compress", args.compress),
                ("--fused-optimizer", args.fused_optimizer),
                ("--ep", args.ep > 0),
                ("--layer-groups / --delta-rank",
                 args.layer_groups > 0 or args.delta_rank > 0),
                ("--plan / --hbm-budget-gb",
                 args.plan or args.hbm_budget_gb is not None),
                ("--telemetry", args.telemetry is not None),
                ("--audit-every", args.audit_every > 0)]
    for flag, used in unported:
        if used:
            raise _not_ported(flag)

    from repro_torch import devices
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.driver import RunConfig, train

    dev = devices.resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers > 0:
        cfg = cfg.replace(num_layers=args.layers)
    if args.moe_backend is not None:
        cfg = cfg.replace(moe_backend=args.moe_backend)
    if args.use_flash_kernel:
        cfg = cfg.replace(use_flash_kernel=True)
    model = Model(cfg)
    print(f"[train] {cfg.name}: {model.num_params() / 1e6:.1f}M params, "
          f"family={cfg.family}, reversible={cfg.reversible}, device={dev}")

    opt = AdamW(lr=args.lr, weight_decay=0.01,
                lr_schedule=cosine_schedule(10, args.steps))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    if args.ckpt_every and args.ckpt_dir is None:
        ap.error("--ckpt-every N > 0 needs --ckpt-dir")
    every = (max(args.steps // 5, 1) if args.ckpt_every is None
             else args.ckpt_every or args.steps + 1)
    rc = RunConfig(total_steps=args.steps, stage1_steps=args.stage1,
                   ckpt_every=every, ckpt_dir=args.ckpt_dir,
                   log_every=args.log_every, n_micro=args.n_micro)
    with maybe_profile(args.profile, dev) as prof:
        t0 = time.perf_counter()
        _, _, losses = train(model, opt, dc, rc, device=dev, seed=args.seed)
        wall = time.perf_counter() - t0
    if prof is not None:
        print_profile(prof, args.profile, wall)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"[train] done: nothing to do (checkpoint in {args.ckpt_dir} "
              f"already at step >= {args.steps})")
    return losses


if __name__ == "__main__":
    main()
