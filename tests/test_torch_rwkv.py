"""The port's rwkv6 training path against the JAX package, on the CPU in f32
at reduced size (head size 32, d 128), inputs drawn with numpy from a seed
and weights carried over by ``interop``:

* the wkv twin and the wrapper (its CPU path) against interpret-mode Pallas
  ``ops.rwkv6_scan`` and the sequential oracle ``ref.rwkv6_ref`` at the
  reference sweep's shapes, the strong-decay case, and the final state;
* ``rwkv6_scan_trainable``'s grads for r, k, v, w and u against JAX's
  (Pallas forward, oracle vjp), with one group and with several;
* ``rwkv_time_apply`` / ``rwkv_channel_apply`` on the kernel branch (S = 64)
  and the plain branch (S = 40 in one chunk; S = 100, padded to two chunks
  of 64), state included;
* ``Model.loss`` and every grad leaf against ``jax.value_and_grad`` for the
  kernel branch on/off x save_memory True / "half" / False;
* three train steps against the JAX trainer (stage masks included);
* in bf16, the reversible backward rebuilds every layer's inputs exactly
  (the train path's f64 streams) and matches stored activations;
* the launcher drops the loss; serving raises "not ported yet".

Tolerances: wkv outputs and states 2e-5 abs at |out| ~ 10 against the
oracle (f32 sums in another order: chunked against token by token); the
time mix 1e-5 of its largest entry against the reference's plain branch;
anything read through the reference's interpret-mode Pallas wkv alone,
its own 1e-3 (see the tests); wkv grads 1e-5 of each grad's largest entry
(the same, through a 128-step backward); loss and model grads 1e-5 abs, as
for qwen (observed ~2e-7); moments after three steps 1e-5 abs, params too
except where the first grad is below Adam's eps (see the test).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.core.reversible import inversion_errors  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import make_train_step, value_and_grad  # noqa: E402

OUT_TOL = 2e-5
TOL = 1e-5


def _wkv_inputs(B, H, S, C, seed, w=None):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, H, S, C)).astype(np.float32)
               for _ in range(3))
    if w is None:
        w = (0.01 + 0.98 / (1 + np.exp(-rng.standard_normal((B, H, S, C))))
             ).astype(np.float32)
    else:
        w = np.full((B, H, S, C), w, np.float32)
    u = (0.3 * rng.standard_normal((H, C))).astype(np.float32)
    return r, k, v, w, u


def _close(got, want, tol=OUT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("B,H,S,C,chunk", [
    (1, 2, 64, 64, 16), (2, 3, 128, 64, 32), (1, 1, 256, 64, 64),
    (1, 2, 128, 32, 32)])
def test_wkv_matches_pallas_and_the_oracle(B, H, S, C, chunk):
    a = _wkv_inputs(B, H, S, C, seed=S + C)
    ja = [jnp.asarray(x) for x in a]
    ta = [torch.from_numpy(x) for x in a]
    pallas = jops.rwkv6_scan(*ja, chunk=chunk)
    oracle, state = jref.rwkv6_ref(*ja)
    before = rw.LAUNCHES
    out = rw.rwkv6_scan(*ta, chunk=chunk)
    assert rw.LAUNCHES == before        # CPU tensors: the twin, no kernel
    twin, tstate = rw.rwkv6_scan_ref(*ta, chunk=chunk)
    for got in (out, twin):
        # the reference holds its interpret-mode Pallas kernel to its
        # oracle at 1e-3 (test_kernels.py:95); here the kernel agrees to
        # ~3e-6, but one run in about fifteen saw 7.3e-5 (not reproduced)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-3, atol=1e-3)
        _close(got.numpy(), oracle)
    _close(tstate.numpy(), state)


def test_wkv_strong_decay_is_finite_and_exact():
    """w = 0.01 everywhere: a chunk's log decay sums to -295, so a
    factorised exp(-clw) would overflow f32."""
    a = _wkv_inputs(1, 1, 128, 64, seed=9, w=0.01)
    want, state = jref.rwkv6_ref(*[jnp.asarray(x) for x in a])
    out, tstate = rw.rwkv6_scan_ref(*[torch.from_numpy(x) for x in a])
    assert torch.isfinite(out).all()
    _close(out.numpy(), want)
    _close(tstate.numpy(), state)


def test_wkv_carries_a_given_state():
    a = _wkv_inputs(2, 2, 64, 32, seed=3)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 32, 32)).astype(
        np.float32)
    want, state = jref.rwkv6_ref(*[jnp.asarray(x) for x in a],
                                 state=jnp.asarray(s0))
    out, tstate = rw.rwkv6_scan_ref(*[torch.from_numpy(x) for x in a],
                                    state=torch.from_numpy(s0), chunk=16)
    _close(out.numpy(), want)
    _close(tstate.numpy(), state)


@pytest.mark.parametrize("group_elements", [rw.GROUP_ELEMENTS, 2 * 32 * 32 * 32],
                         ids=["one-group", "four-groups"])
def test_wkv_trainable_grads_match_jax(monkeypatch, group_elements):
    monkeypatch.setattr(rw, "GROUP_ELEMENTS", group_elements)
    a = _wkv_inputs(1, 2, 128, 32, seed=5)
    a[3][:] = 0.05 + 0.9 * (a[3] - 0.01) / 0.98      # w in [0.05, 0.95]

    def grads(scan):
        f = lambda *x: jnp.sum(jnp.square(scan(*x)))           # noqa: E731
        return jax.grad(f, argnums=(0, 1, 2, 3, 4))(
            *[jnp.asarray(x) for x in a])

    ins = [torch.from_numpy(x).requires_grad_() for x in a]
    torch.sum(torch.square(rw.rwkv6_scan_trainable(*ins, chunk=32))).backward()
    # against the oracle's vjp to 1e-5 of each grad's largest entry, and
    # against the reference's trainable wrapper (Pallas forward, oracle
    # backward) to its own 1e-3 (test_kernels.py:203)
    for tol, scan in ((TOL, lambda *x: jref.rwkv6_ref(*x)[0]),
                      (1e-3, jops.rwkv6_scan_trainable)):
        for t, g in zip(ins, grads(scan)):
            g = np.asarray(g)
            err = np.abs(t.grad.numpy() - g).max()
            assert err <= tol * np.abs(g).max(), err


def _layer_params(jm, seed=0):
    """Layer 0's params (zero inits nudged off zero): JAX and port copies."""
    jp = jm.init(jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(
        lambda a: a if a.any() else
        0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), jp)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stacks"]["layers"])
    return jl, interop.from_numpy_tree(jax.device_get(jl), "cpu")


@pytest.mark.parametrize("S", [64, 40, 100],
                         ids=["kernel-branch", "plain-branch", "plain-padded"])
def test_time_and_channel_mix_match_jax(S):
    over = dict(use_flash_kernel=True, num_layers=1)
    jcfg = jget_config("rwkv6-3b", reduced=True).replace(**over)
    cfg = get_config("rwkv6-3b", reduced=True).replace(**over)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(
        np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jlayer, tlayer = _layer_params(JModel(jcfg))
    jt, tt = jlayer["time"], tlayer["time"]
    out = ssm.rwkv_time_apply(tt, cfg, tx).numpy()
    # against the reference's plain branch (its token-by-token scan) to
    # 1e-5 of the largest entry (observed 2.3e-6); its kernel branch, where
    # it runs, to its own Pallas tolerance, 1e-3: that branch forms
    # clw_prev = clw - lw, whose cancellation the per-head group norm
    # magnifies (its two branches differ by 1.2e-5 of the largest entry)
    _close_to_scale(out, jssm.rwkv_time_apply(
        jt, jcfg.replace(use_flash_kernel=False), jx), 1e-5)
    if S % ssm.KERNEL_CHUNK == 0:
        _close_to_scale(out, jssm.rwkv_time_apply(jt, jcfg, jx), 1e-3)
    jc, tc = jlayer["chan"], tlayer["chan"]
    _close(ssm.rwkv_channel_apply(tc, cfg, tx).numpy(),
           jssm.rwkv_channel_apply(jc, jcfg, jx))
    # the plain branch with a carried state and token-shift tail
    H, hd = ssm.rwkv_dims(cfg)
    rng = np.random.default_rng(1)
    s0 = rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jo, js, jlast = jssm.rwkv_time_apply(jt, jcfg, jx, state=jnp.asarray(s0),
                                         last_x=jnp.asarray(last),
                                         return_state=True)
    to, ts, tlast = ssm.rwkv_time_apply(tt, cfg, tx, state=torch.from_numpy(s0),
                                        last_x=torch.from_numpy(last),
                                        return_state=True)
    _close_to_scale(to.numpy(), jo, 1e-5)
    _close_to_scale(ts.numpy(), js, 1e-5)
    _close(tlast.numpy(), jlast, 0)


def _models(flash=True, **over):
    kw = dict(use_flash_kernel=flash, **over)
    return (JModel(jget_config("rwkv6-3b", reduced=True).replace(**kw)),
            Model(get_config("rwkv6-3b", reduced=True).replace(**kw)))


def _params(jm, seed=0):
    """JAX init with the zero-initialised leaves (norm scales, u, the decay
    base and LoRA's second factor, ln) nudged off zero, and its port
    copy."""
    jp = jm.init(jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(
        lambda a: a if a.any() else
        0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), jp)
    return jp, interop.from_numpy_tree(jax.device_get(jp), "cpu")


def _tokens(vocab, B=2, S=64, seed=0):
    tok = np.random.default_rng(seed).integers(4, vocab, size=(B, S)).astype(
        np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


def _assert_tree_close(tp, jtree, tol=TOL):
    jl = dict(tree_leaves(jax.device_get(jtree)))
    assert sorted(jl) == sorted(p for p, _ in tree_leaves(tp))
    for path, t in tree_leaves(tp):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(jl[path], np.float32),
                                   rtol=0, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("flash", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("save_memory", [True, "half", False], ids=str)
def test_loss_and_every_grad_match_jax(flash, save_memory):
    jm, tm = _models(flash, num_layers=2)
    jp, tp = _params(jm)
    jb, tb = _tokens(tm.cfg.vocab_size)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, save_memory=save_memory))(jp)
    tl, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, save_memory=save_memory), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=TOL)
    _assert_tree_close(tg, jg)


def test_three_train_steps_match_jax():
    jm, tm = _models(True, num_layers=2)
    jp, tp = _params(jm, seed=3)
    kw = dict(lr=1e-3, weight_decay=0.01)
    jopt = jadamw.AdamW(lr_schedule=jadamw.cosine_schedule(2, 10), **kw)
    topt = adamw.AdamW(lr_schedule=adamw.cosine_schedule(2, 10), **kw)
    jst, tst = jopt.init(jp), topt.init(tp)
    jsteps = {s: jax.jit(jmake_train_step(
        jm, jopt, mask_fn=getattr(jschedule, f"stage{s}_mask")))
        for s in (1, 2)}
    tsteps = {s: make_train_step(tm, topt,
                                 mask_fn=getattr(schedule, f"stage{s}_mask"))
              for s in (1, 2)}
    _, fresh = _params(jm, seed=3)
    for i, stage in enumerate((1, 2, 2)):
        jb, tb = _tokens(tm.cfg.vocab_size, B=4, S=64, seed=10 + i)
        jp, jst, jmet = jsteps[stage](jp, jst, jb)
        tp, tst, tmet = tsteps[stage](tp, tst, tb)
        np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]),
                                   rtol=1e-5)
        if i == 0:
            # where 0 < |grad| < Adam's eps, the first update
            # g / (|g| + eps) passes the grad's f32 rounding noise (summed in
            # another order) into the param at up to lr: those elements are
            # held to lr per step, every other to TOL
            noisy = {path: (np.abs(np.asarray(m)) < (1 - jopt.b1) * jopt.eps)
                     & (np.asarray(m) != 0)
                     for path, m in tree_leaves(jax.device_get(jst["m"]))}
            # stage 1 trains adapters and stream norms only: the
            # pre-trained time-mix weights (u, decays, mixes) stay put
            t0, f0 = tp["stacks"]["layers"]["time"], fresh["stacks"]["layers"]["time"]
            for name in ("u", "decay_base", "decay_a", "decay_b", "mu", "w_r"):
                torch.testing.assert_close(t0[name], f0[name], rtol=0, atol=0)
            assert not torch.equal(tp["stacks"]["layers"]["attn_ad"]["p_up"],
                                   fresh["stacks"]["layers"]["attn_ad"]["p_up"])
    jl = dict(tree_leaves(jax.device_get(jp)))
    for path, t in tree_leaves(tp):
        diff = np.abs(t.numpy() - np.asarray(jl[path]))
        assert diff[~noisy[path]].max(initial=0) <= TOL, path
        assert diff[noisy[path]].max(initial=0) <= 3 * topt.lr, path
        assert noisy[path].mean() < 1e-2, path      # the exception is rare
    _assert_tree_close(tst["m"], jst["m"])
    _assert_tree_close(tst["v"], jst["v"])


def test_bf16_reversible_backward_rebuilds_inputs_exactly():
    """In bf16 the train path's f64 streams make the inverse exact: every
    layer's inputs are rebuilt bit for bit, and the reversible grads equal
    those of stored activations up to summation order."""
    cfg = get_config("rwkv6-3b", reduced=True).replace(dtype="bfloat16",
                                                       use_flash_kernel=True)
    tm = Model(cfg)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    for _, leaf in tree_leaves(params):              # nudge zero inits
        if not leaf.any():
            leaf.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    _, tb = _tokens(cfg.vocab_size, B=2, S=128, seed=2)
    s = tm.stacks[0]
    x1, x2, ctx = tm._embed_streams(params, tb["tokens"])
    assert x1.dtype == torch.float64
    errs = inversion_errors(s.fwd, s.inv, params["stacks"]["layers"], {},
                            ctx, x1, x2, s.n)
    assert all(e == (0.0, 0.0, 0.0) for e in errs), errs
    runs = [value_and_grad(lambda p, b: tm.loss(p, b, save_memory=sm),
                           params, tb) for sm in (True, False)]
    (l_rev, g_rev), (l_all, g_all) = runs
    assert float(l_rev) == float(l_all)
    for (path, a), (_, b) in zip(tree_leaves(g_rev), tree_leaves(g_all)):
        a, b = a.float(), b.float()
        assert (a - b).abs().max() <= 2e-2 * b.abs().max() + 1e-12, path


def test_param_tree_matches_jax():
    for reduced in (False, True):
        jm = JModel(jget_config("rwkv6-3b", reduced=reduced))
        tm = Model(get_config("rwkv6-3b", reduced=reduced))
        js = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        jl = {p: tuple(a.shape) for p, a in tree_leaves(js)}
        tl = {p: tuple(s.shape) for p, s in tree_leaves(tm.param_specs())}
        assert jl == tl
    assert tm.num_params() == jm.num_params()
    assert Model(get_config("rwkv6-3b")).num_params() == 3_492_661_760


def test_launcher_drops_the_loss_and_serving_is_not_ported():
    from repro_torch.launch import train as launch
    losses = launch.main(["--device", "cpu", "--reduced", "--arch",
                          "rwkv6-3b", "--use-flash-kernel", "--steps", "12",
                          "--stage1", "4", "--batch", "4", "--seq", "64",
                          "--ckpt-every", "0"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0] - 0.5
    tm = Model(get_config("rwkv6-3b", reduced=True))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="dense engine mode"):
        tm.init_cache(params, 1, 16)
    with pytest.raises(NotImplementedError, match="dense engine mode"):
        tm.init_kv_pool(4, 8, "cpu")
