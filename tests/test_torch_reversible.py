"""The port's reversible core against the JAX package, on the CPU in f32:
the coupled block's forward and fixed-point inverse, the reconstruction
metrics, and ``reversible_stack``'s gradients in its three modes (True:
inversion in the backward; "half": saved stream-1 inputs; False: the plain
loop) against the JAX stack's ``jax.vjp``.

Two block families: the reduced qwen2-moe layer (cross-attention F with the
flash branch, grouped-MoE G) built by each package's own ``build_moe``, and
a toy block with a shared tree, whose gradient sums over layers.
Tolerances: 1e-5 abs plus 1e-5 relative (f32 through 4 layers summed in
another order; with unit random cotangents some grads reach ~5, where 1e-5
abs is ~20 f32 ulps); the inverse's fixed point leaves a residual below
1e-5 of the streams at inverse_fp_iters = 5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import reversible as jrev  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import reversible as rev  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402

TOL = 1e-5
MODES = [True, "half", False]
OVER = dict(moe_backend="grouped", use_flash_kernel=True, flash_block_q=32,
            flash_block_k=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _moe_stack(seed=0, B=2, S=64):
    jcfg = jget_config("qwen2-moe-a2.7b", reduced=True).replace(**OVER)
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(**OVER)
    jp = JModel(jcfg).init(jax.random.PRNGKey(seed))
    # nudge the zero-initialised leaves (norm scales, biases, shared gate)
    # off zero so every gradient path carries signal
    jp = jax.tree_util.tree_map(
        lambda a: a if a.any() else
        0.02 * jax.random.normal(jax.random.PRNGKey(7), a.shape), jp)
    stacked = jax.device_get(jp["stacks"]["layers"])
    (jsd,), _ = jmodel.build_moe(jcfg)
    (tsd,), _ = tmodel.build_moe(cfg)
    rng = np.random.default_rng(seed)
    half = cfg.d_model // 2
    x1, x2, c1, c2 = (rng.normal(size=(B, S, half)).astype(np.float32)
                      for _ in range(4))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return jcfg, cfg, jsd, tsd, stacked, (x1, x2, c1, c2), pos


def test_coupled_block_and_inverse_match_jax():
    jcfg, cfg, jsd, tsd, stacked, (x1, x2, _, _), pos = _moe_stack()
    lp_np = jax.tree_util.tree_map(lambda a: a[0], stacked)
    lp = interop.from_numpy_tree(lp_np, "cpu")
    jctx, tctx = {"positions": jnp.asarray(pos)}, {"positions": _t(pos)}
    jy = jsd.fwd(lp_np, {}, jctx, 0, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        ty = tsd.fwd(lp, {}, tctx, 0, _t(x1), _t(x2))
        tx = tsd.inv(lp, {}, tctx, 0, *ty)
        tx2 = tsd.half_inv(lp, {}, tctx, 0, _t(x1), *ty)
    jx = jsd.inv(lp_np, {}, jctx, 0, *jy)
    for got, want in zip(ty + tx, jy + jx):
        _close(got, want)
    _close(tx2, x2)
    got = rev.reconstruction_metrics(tx[0], tx[1], _t(x1), _t(x2))
    # the fixed point really inverts (5 iterations)
    assert float(got[2]) < 1e-5
    want = jrev.reconstruction_metrics(jx[0], jx[1], jnp.asarray(x1),
                                       jnp.asarray(x2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_moe_stack_grads_match_jax(mode):
    jcfg, cfg, jsd, tsd, stacked, (x1, x2, c1, c2), pos = _moe_stack(seed=1)
    n = cfg.num_layers
    japply = jrev.reversible_stack(jsd.fwd, jsd.inv, n, save_memory=mode,
                                   half_inv=jsd.half_inv)
    jctx = {"positions": jnp.asarray(pos)}
    (jy1, jy2), vjp = jax.vjp(lambda p, a, b: japply(p, {}, jctx, a, b),
                              stacked, jnp.asarray(x1), jnp.asarray(x2))
    jdp, jd1, jd2 = vjp((jnp.asarray(c1), jnp.asarray(c2)))

    tapply = rev.reversible_stack(tsd.fwd, tsd.inv, n, save_memory=mode,
                                  half_inv=tsd.half_inv)
    tp = interop.from_numpy_tree(stacked, "cpu")
    leaves = [t.requires_grad_() for _, t in tree_leaves(tp)]
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    y1, y2 = tapply(tp, {}, {"positions": _t(pos)}, a, b)
    _close(y1.detach(), jy1)
    _close(y2.detach(), jy2)
    torch.autograd.backward((y1, y2), (_t(c1), _t(c2)))
    _close(a.grad, jd1)
    _close(b.grad, jd2)
    jl = dict(tree_leaves(jax.device_get(jdp)))
    for (path, _), leaf in zip(tree_leaves(tp), leaves):
        _close(leaf.grad, jl[path])


def _toy(lib):
    """F reads both streams (cross coupling) and a shared bias; G reads y1
    and a shared scale."""
    tanh = jnp.tanh if lib is jnp else torch.tanh

    def F(p, sh, ctx, i, x1, x2):
        return 0.3 * tanh(x1 @ p["a"] + x2 @ p["b"] + sh["bias"])

    def G(p, sh, ctx, i, y1, _=None):
        return tanh(y1 @ p["c"]) * sh["scale"]

    fwd, inv = (jrev if lib is jnp else rev).make_coupled(F, G, fp_iters=12)
    half_inv = lambda p, sh, ctx, i, x1, y1, y2: y2 - G(p, sh, ctx, i, y1)  # noqa: E731
    return fwd, inv, half_inv


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_shared_tree_grads_sum_over_layers(mode):
    rng = np.random.default_rng(3)
    L, B, d = 3, 5, 6
    f = lambda *s: (0.4 * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    stacked = {"a": f(L, d, d), "b": f(L, d, d), "c": f(L, d, d)}
    shared = {"bias": f(d), "scale": f(d)}
    x1, x2, c1, c2 = (f(B, d) for _ in range(4))
    jfwd, jinv, jhalf = _toy(jnp)
    japply = jrev.reversible_stack(jfwd, jinv, L, save_memory=mode,
                                   half_inv=jhalf)
    _, vjp = jax.vjp(lambda p, s, a, b: japply(p, s, {}, a, b),
                     *jax.tree_util.tree_map(jnp.asarray,
                                             (stacked, shared, x1, x2)))
    jgrads = vjp((jnp.asarray(c1), jnp.asarray(c2)))

    tfwd, tinv, thalf = _toy(torch)
    tapply = rev.reversible_stack(tfwd, tinv, L, save_memory=mode,
                                  half_inv=thalf)
    tp = {k: _t(v).requires_grad_() for k, v in stacked.items()}
    ts = {k: _t(v).requires_grad_() for k, v in shared.items()}
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    y1, y2 = tapply(tp, ts, {}, a, b)
    torch.autograd.backward((y1, y2), (_t(c1), _t(c2)))
    jdp, jds, jd1, jd2 = jgrads
    for k in stacked:
        _close(tp[k].grad, jdp[k])
    for k in shared:
        _close(ts[k].grad, jds[k])
    _close(a.grad, jd1)
    _close(b.grad, jd2)


def test_inversion_walk_accumulates_small_errors():
    jcfg, cfg, jsd, tsd, stacked, (x1, x2, _, _), pos = _moe_stack(seed=2)
    tp = interop.from_numpy_tree(stacked, "cpu")
    errs = rev.inversion_errors(tsd.fwd, tsd.inv, tp, {},
                                {"positions": _t(pos)}, _t(x1), _t(x2),
                                cfg.num_layers)
    assert len(errs) == cfg.num_layers
    for max_abs, mean_abs, rel in errs:
        assert 0.0 <= mean_abs <= max_abs and rel < 1e-5


def test_policy_lists_are_not_ported():
    with pytest.raises(NotImplementedError):
        rev.reversible_stack(None, None, 2, save_memory=["store", "remat"])
