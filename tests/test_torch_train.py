"""The port's training path against the JAX package, on the CPU in f32, at
reduced qwen2-moe with the grouped MoE backend:

* ``Model.loss`` and the grad of every param leaf against
  ``jax.value_and_grad(Model.loss)``, flash branch on and off, for the
  three ``save_memory`` modes (S = 128 with 32/64-wide flash blocks, so
  several tiles and dead tiles run; the CE and attention chunked in 64s);
* three ``make_train_step`` steps (AdamW with weight decay and a cosine
  schedule, stage-1 then stage-2 masks), with and without microbatches;
* checkpoints written by either package restore in the other;
* the launcher drops the loss and, without ``--ckpt-dir``, neither writes
  nor resumes a checkpoint; a run resumed after a simulated preemption
  ends where an uninterrupted one does.

Tolerances: loss 1e-5 and grads 1e-5 abs (observed ~1e-8: f32 sums in
another order); params and moments after three steps 1e-5 abs (an update
is lr * m_hat / sqrt(v_hat) ~ 1e-3 per step, so a wrong mask or moment
shows at 1e-3), except attn.bk, whose grad is rounding noise (see the
test).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jckpt  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import driver  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402

TOL = 1e-5
OVER = dict(moe_backend="grouped", flash_block_q=32, flash_block_k=64,
            loss_chunk=64, attn_q_chunk=64)


def _models(flash=True, **over):
    kw = dict(OVER, use_flash_kernel=flash, **over)
    jcfg = jget_config("qwen2-moe-a2.7b", reduced=True).replace(**kw)
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(**kw)
    return JModel(jcfg), Model(cfg)


def _params(jm, seed=0):
    """JAX init with the zero-initialised leaves (norm scales, biases, the
    shared-expert gate) nudged off zero, and its port copy."""
    jp = jm.init(jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(
        lambda a: a if a.any() else
        0.02 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), jp)
    return jp, interop.from_numpy_tree(jax.device_get(jp), "cpu")


def _batch(vocab, B=2, S=128, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(4, vocab, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    return ({"tokens": jnp.asarray(tok), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(tok),
             "loss_mask": torch.from_numpy(mask)})


def _assert_tree_close(tp, jtree, tol=TOL):
    jl = dict(tree_leaves(jax.device_get(jtree)))
    assert sorted(jl) == sorted(p for p, _ in tree_leaves(tp))
    for path, t in tree_leaves(tp):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(jl[path], np.float32),
                                   rtol=0, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("save_memory", [True, "half", False], ids=str)
def test_loss_and_every_grad_match_jax(flash, save_memory):
    jm, tm = _models(flash)
    jp, tp = _params(jm)
    jb, tb = _batch(tm.cfg.vocab_size)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, save_memory=save_memory))(jp)
    tl, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, save_memory=save_memory), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=TOL)
    _assert_tree_close(tg, jg)


def _opts():
    kw = dict(lr=1e-3, weight_decay=0.01)
    return (jadamw.AdamW(lr_schedule=jadamw.cosine_schedule(2, 10), **kw),
            adamw.AdamW(lr_schedule=adamw.cosine_schedule(2, 10), **kw))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_three_train_steps_match_jax(n_micro):
    jm, tm = _models(True, num_layers=2)
    jp, tp = _params(jm, seed=3)
    jopt, topt = _opts()
    jst, tst = jopt.init(jp), topt.init(tp)
    masks = (1, 2, 2)
    jsteps = {s: jax.jit(jmake_train_step(
        jm, jopt, n_micro=n_micro,
        mask_fn=getattr(jschedule, f"stage{s}_mask"))) for s in (1, 2)}
    tsteps = {s: make_train_step(tm, topt, n_micro=n_micro,
                                 mask_fn=getattr(schedule, f"stage{s}_mask"))
              for s in (1, 2)}
    for i, stage in enumerate(masks):
        jb, tb = _batch(tm.cfg.vocab_size, B=4, S=64, seed=10 + i)
        jp, jst, jmet = jsteps[stage](jp, jst, jb)
        tp, tst, tmet = tsteps[stage](tp, tst, tb)
        np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]),
                                   rtol=1e-5)
        assert tmet["step"] == int(jmet["step"]) == i + 1
    # attn.bk's grad is f32 rounding noise around an exact zero (a key bias
    # adds the same q.b_k to every score of a row; softmax cancels it), and
    # Adam's m / sqrt(v) scales noise up to the step size: it is held to
    # lr per step, every other leaf to TOL
    jbk = jp["stacks"]["layers"]["attn"].pop("bk")
    tbk = tp["stacks"]["layers"]["attn"].pop("bk")
    np.testing.assert_allclose(tbk.numpy(), np.asarray(jbk), rtol=0,
                               atol=3 * topt.lr)
    _assert_tree_close(tp, jp)
    _assert_tree_close(tst["m"], jst["m"])
    _assert_tree_close(tst["v"], jst["v"])
    # stage masks: the routers never moved (frozen in both stages)
    _, fresh = _params(jm, seed=3)
    torch.testing.assert_close(tp["stacks"]["layers"]["moe"]["router"],
                               fresh["stacks"]["layers"]["moe"]["router"],
                               rtol=0, atol=0)


def test_train_step_rejects_indivisible_batch_and_unported_options():
    jm, tm = _models(True, num_layers=1)
    _, tp = _params(jm)
    opt = adamw.AdamW()
    step = make_train_step(tm, opt, n_micro=3)
    _, tb = _batch(tm.cfg.vocab_size, B=4, S=64)
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        step(tp, opt.init(tp), tb)
    with pytest.raises(NotImplementedError):
        make_train_step(tm, opt, fused=True)
    with pytest.raises(NotImplementedError):
        make_train_step(tm, opt, compress=lambda g: g)


def test_checkpoints_restore_across_packages(tmp_path):
    jm, tm = _models(True, num_layers=2)
    jp, tp = _params(jm, seed=5)
    jopt, topt = _opts()
    jst = jopt.init(jp)
    jst = dict(jst, step=jnp.asarray(7, jnp.int32),
               m=jax.tree_util.tree_map(lambda a: a + 0.5, jst["m"]))
    # reference -> port
    jckpt.save(str(tmp_path / "j"), 7, (jp, jst))
    like = (tm.init(torch.Generator().manual_seed(1), "cpu"),
            topt.init(tp))
    (rp, rst), step = ckpt.restore(str(tmp_path / "j"), like)
    assert step == 7 and int(rst["step"]) == 7
    _assert_tree_close(rp, jp, 0)
    _assert_tree_close(rst["m"], jst["m"], 0)
    # port -> reference, bf16 leaves included
    tp16 = {k: v for k, v in tp.items()}
    tp16["embed"] = tp["embed"].to(torch.bfloat16)
    ckpt.save(str(tmp_path / "t"), 9, (tp16, rst))
    jlike = (dict(jp, embed=jp["embed"].astype(jnp.bfloat16)), jst)
    (bp, bst), step = jckpt.restore(str(tmp_path / "t"), jlike)
    assert step == 9 and bp["embed"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(bp["embed"]).view(np.uint16),
        tp16["embed"].view(torch.int16).numpy().view(np.uint16))
    _assert_tree_close({k: v for k, v in tp.items() if k != "embed"},
                       {k: v for k, v in bp.items() if k != "embed"}, 0)
    assert int(bst["step"]) == 7
    # a mismatched tree is refused
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path / "j"), (like[0],))


def test_launcher_drops_the_loss(tmp_path):
    from repro_torch.launch import train as launch
    losses = launch.main(["--device", "cpu", "--reduced", "--moe-backend",
                          "grouped", "--use-flash-kernel", "--steps", "12",
                          "--stage1", "4", "--batch", "4", "--seq", "64",
                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0] - 0.5
    for flag in (["--optimizer", "lomo"], ["--compress"], ["--ep", "2"],
                 ["--fused-optimizer"], ["--layer-groups", "2"], ["--plan"],
                 ["--telemetry", "x"], ["--audit-every", "2"]):
        with pytest.raises(NotImplementedError):
            launch.main(["--device", "cpu", "--reduced"] + flag)
    with pytest.raises(NotImplementedError):    # the einsum backend default
        launch.main(["--device", "cpu", "--reduced", "--steps", "1",
                     "--ckpt-dir", str(tmp_path / "e")])


def test_launcher_without_ckpt_dir_neither_writes_nor_resumes(
        tmp_path, monkeypatch):
    import tempfile
    from repro_torch.launch import train as launch
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu", "--reduced", "--moe-backend", "grouped",
            "--steps", "2", "--stage1", "1", "--batch", "2", "--seq", "32"]
    first, second = launch.main(argv), launch.main(argv)
    assert len(first) == 2 and first == second
    assert list(tmp_path.iterdir()) == []
    assert launch.main(argv + ["--ckpt-every", "0"]) == first
    with pytest.raises(SystemExit):
        launch.main(argv + ["--ckpt-every", "1"])


def test_resume_after_preemption_ends_where_an_uninterrupted_run_does(
        tmp_path):
    from repro_torch import obs
    _, tm = _models(True, num_layers=2)
    dc = DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=64, global_batch=2)
    opt = adamw.AdamW(lr=1e-3)

    def run(d, **kw):
        rc = driver.RunConfig(total_steps=4, stage1_steps=2, ckpt_every=2,
                              ckpt_dir=str(d), log_every=2)
        return driver.train(tm, opt, dc, rc, device="cpu", log_fn=lambda s: 0,
                            **kw)

    p_full, _, l_full = run(tmp_path / "a")
    with pytest.raises(RuntimeError, match="preemption"):
        run(tmp_path / "b", fail_at_step=3)
    tel = obs.Telemetry()
    p_res, _, l_res = run(tmp_path / "b", telemetry=tel)
    assert l_res == l_full[2:]
    for (_, a), (_, b) in zip(tree_leaves(p_full), tree_leaves(p_res)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    kinds = [e["kind"] for e in tel.events]
    assert "ckpt_restore" in kinds and kinds.count("train_step") == 2
    assert tel.histogram("train.step_s").count == 2
    assert tel.counter("train.nonfinite_grad_steps").value == 0
    with pytest.raises(NotImplementedError):
        driver.train(tm, opt, dc, dataclasses.replace(
            driver.RunConfig(), fused_optimizer=True), device="cpu")
