"""Training driver (port of ``repro.train.driver.train``): two-stage RevFFN
schedule, periodic atomic checkpoints, resume from the latest one, and
per-step / per-window telemetry.

The data pipeline is deterministic in (seed, host, step), so a resumed run
replays exactly the remaining data.  The reference's memory plan, layer
audit, memory watchdog, MFU estimator and ``elastic_remesh`` are not ported
yet: ``train`` raises on a plan, and ``audit_every`` / ``fused_optimizer``
other than their defaults raise too.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import devices, obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import schedule
from repro_torch.data.pipeline import DataConfig, packed_batches
from repro_torch.train.trainer import make_train_step, to_device_batch


@dataclasses.dataclass
class RunConfig:
    total_steps: int = 100
    stage1_steps: int = 20          # adapter warm-up (paper §3.3)
    ckpt_every: int = 20
    # None: no checkpoint is written and none is resumed from
    ckpt_dir: Optional[str] = os.path.join(tempfile.gettempdir(),
                                           "repro_torch_ckpt")
    log_every: int = 10
    n_micro: int = 1
    audit_every: int = 0            # reversible audit: not ported yet
    fused_optimizer: bool = False   # optimizer-in-backward: not ported yet


def _not_ported(what: str):
    return NotImplementedError(f"{what}: not ported yet (ROADMAP.md queue 1)")


def train(model, optimizer, data_cfg: DataConfig, run: RunConfig,
          params=None, log_fn: Callable = print,
          fail_at_step: Optional[int] = None, plan=None, telemetry=None,
          device="cuda", seed: int = 0):
    """Runs (or resumes) a two-stage fine-tune on ``device`` (the card
    unless the CPU is asked for).  ``params`` default to random weights from
    a ``torch.Generator`` seeded with ``seed``.  ``fail_at_step`` simulates
    a preemption (raises) for the resume tests.  ``telemetry`` (a
    ``repro_torch.obs.Telemetry``) receives a ``train_step`` event per step
    (loss, grad norm, step seconds), a ``train_window`` event per
    ``log_every`` steps, the ``train.step`` span and ``train.step_s``
    histogram, and the ``train.nonfinite_grad_steps`` and
    ``train.ckpt_saves`` counters.  Returns (params, opt_state, losses)."""
    if plan is not None:
        raise _not_ported("the memory planner's per-layer policies")
    if run.audit_every:
        raise _not_ported("the reversible audit (audit_every)")
    if run.fused_optimizer:
        raise _not_ported("the fused optimizer-in-backward step")
    dev = devices.resolve(device)
    tel = obs.as_telemetry(telemetry)
    tel.emit("train_start", config=model.cfg.name,
             total_steps=run.total_steps, global_batch=data_cfg.global_batch,
             seq_len=data_cfg.seq_len, n_micro=run.n_micro)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen, dev)
    opt_state = optimizer.init(params)
    start_step = 0

    latest = None if run.ckpt_dir is None else ckpt.latest_step(run.ckpt_dir)
    if latest is not None:
        t_rs = time.perf_counter()
        (params, opt_state), start_step = ckpt.restore(
            run.ckpt_dir, (params, opt_state))
        tel.emit("ckpt_restore", step=start_step,
                 dur_s=time.perf_counter() - t_rs)
        log_fn(f"[driver] resumed from step {start_step}")

    steps = {stage: make_train_step(model, optimizer, n_micro=run.n_micro,
                                    mask_fn=mask)
             for stage, mask in ((1, schedule.stage1_mask),
                                 (2, schedule.stage2_mask))}
    tokens_per_step = data_cfg.global_batch * data_cfg.seq_len
    it = packed_batches(data_cfg, start_step=start_step)
    losses = []
    window_s, window_steps = 0.0, 0

    def emit_window(step):
        sps = window_steps / max(window_s, 1e-9)
        stage = 1 if step < run.stage1_steps else 2
        win = {"step": step + 1, "stage": stage,
               "loss_mean": float(np.mean(losses[-run.log_every:])),
               "steps_per_s": sps, "steps": window_steps,
               "tokens_per_s": sps * tokens_per_step}
        tel.gauge("train.tokens_per_s").set(win["tokens_per_s"])
        tel.emit("train_window", **win)
        log_fn(f"[driver] step {step + 1} stage {stage} "
               f"loss {win['loss_mean']:.4f} ({sps:.2f} steps/s)")

    for step in range(start_step, run.total_steps):
        batch = to_device_batch(next(it), dev)
        stage = 1 if step < run.stage1_steps else 2
        # fenced on the params: the span ends when the update has landed
        with tel.span("train.step", fence=params, observe=False,
                      step=step + 1) as sp:
            params, opt_state, metrics = steps[stage](params, opt_state,
                                                      batch)
        dt = sp["dur_s"]
        loss = metrics["loss"]
        losses.append(loss)
        window_s += dt
        window_steps += 1
        tel.histogram("train.step_s").observe(dt)
        if not metrics["grads_finite"]:
            # the optimizer skipped this update (non-finite global norm):
            # count it so a diverging run is visible instead of frozen
            tel.counter("train.nonfinite_grad_steps").inc()
        tel.emit("train_step", step=step + 1, stage=stage, loss=loss,
                 grad_norm=metrics["grad_norm"], step_s=dt,
                 grads_finite=metrics["grads_finite"])
        if (step + 1) % run.log_every == 0:
            emit_window(step)
            window_s, window_steps = 0.0, 0
        if run.ckpt_dir is not None and (step + 1) % run.ckpt_every == 0:
            t_sv = time.perf_counter()
            ckpt.save(run.ckpt_dir, step + 1, (params, opt_state))
            save_s = time.perf_counter() - t_sv
            tel.counter("train.ckpt_saves").inc()
            tel.histogram("train.ckpt_save_s").observe(save_s)
            tel.emit("ckpt_save", step=step + 1, dur_s=save_s)
        if fail_at_step is not None and step + 1 == fail_at_step:
            raise RuntimeError(f"simulated preemption at step {step + 1}")
    if window_steps and tel.enabled:
        emit_window(run.total_steps - 1)
    return params, opt_state, losses
