"""The port's MoE dispatch, grouped GEMM twin, expert FFN and MoE layer
against the JAX package, on the CPU in f32.

Tolerances: index state must be equal; permute/combine agree to 1e-6 (the
same f32 products summed in another order); the grouped GEMM and MoE layer
to 1e-5 (f32 matmuls of 64-128-deep contractions in another order).
``block_m=16`` is passed on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.kernels.moe import dispatch as jdsp  # noqa: E402
from repro.kernels.moe import ops as jops  # noqa: E402
from repro.kernels.moe.grouped_gemm import grouped_matmul_pallas  # noqa: E402
from repro.kernels.moe.ref import grouped_matmul_ref as jgmm_ref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import spec as jspec  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.moe import dispatch as dsp  # noqa: E402
from repro_torch.kernels.moe import ops  # noqa: E402
from repro_torch.kernels.moe.ref import grouped_matmul_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

BM = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=tol)


def _routing(rng, T, E, k):
    return np.stack([rng.choice(E, size=k, replace=False)
                     for _ in range(T)]).astype(np.int32)


@pytest.mark.parametrize("T,E,k", [(10, 8, 2), (37, 16, 4), (3, 64, 4)])
def test_make_plan_fields_equal_jax(T, E, k):
    idx = _routing(np.random.default_rng(T), T, E, k)
    jp = jdsp.make_plan(jnp.asarray(idx), E, BM)
    tp = dsp.make_plan(_t(idx), E, BM)
    for f in ("order", "dest", "tile_expert", "group_sizes"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert (tp.m_pad, tp.block_m, tp.top_k) == (jp.m_pad, jp.block_m,
                                                jp.top_k)
    padded = -(-np.bincount(idx.ravel(), minlength=E) // BM) * BM
    assert int(tp.n_used_tiles) == padded.sum() // BM
    assert tp.n_used_tiles.dtype == torch.int32


def test_permute_and_combine_match_jax():
    rng = np.random.default_rng(1)
    T, E, k, d = 13, 8, 2, 24
    idx = _routing(rng, T, E, k)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gates = rng.random(size=(T, k)).astype(np.float32)
    jp = jdsp.make_plan(jnp.asarray(idx), E, BM)
    tp = dsp.make_plan(_t(idx), E, BM)
    jxs = jdsp.permute(jnp.asarray(x), jp)
    txs = dsp.permute(_t(x), tp)
    _close(txs, jxs, 1e-6)
    ys = rng.normal(size=(tp.m_pad, d)).astype(np.float32)
    _close(dsp.combine(_t(ys), _t(gates), tp, T),
           jdsp.combine(jnp.asarray(ys), jnp.asarray(gates), jp, T), 1e-6)


def _gmm_inputs(seed, T=20, E=8, k=2, K=32, N=48):
    rng = np.random.default_rng(seed)
    idx = _routing(rng, T, E, k)
    plan = jdsp.make_plan(jnp.asarray(idx), E, BM)
    x = rng.normal(size=(T, K)).astype(np.float32)
    lhs = np.asarray(jdsp.permute(jnp.asarray(x), plan))
    rhs = (rng.normal(size=(E, K, N)) / np.sqrt(K)).astype(np.float32)
    return lhs, rhs, np.asarray(plan.tile_expert)


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_matmul_matches_jax_and_pallas_interpret(seed):
    lhs, rhs, te = _gmm_inputs(seed)
    jref = jgmm_ref(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te),
                    block_m=BM)
    jpal = grouped_matmul_pallas(jnp.asarray(lhs), jnp.asarray(rhs),
                                 jnp.asarray(te), block_m=BM, interpret=True)
    twin = grouped_matmul_ref(_t(lhs), _t(rhs), _t(te), block_m=BM)
    wrapped = ops.grouped_matmul(_t(lhs), _t(rhs), _t(te), BM)   # CPU -> twin
    for ref in (jref, jpal):
        _close(twin, ref, 1e-5)
        _close(wrapped, ref, 1e-5)


def test_grouped_expert_ffn_matches_jax_both_impls():
    rng = np.random.default_rng(4)
    T, E, k, d, f = 17, 8, 2, 32, 24
    idx = _routing(rng, T, E, k)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gates = rng.random(size=(T, k)).astype(np.float32)
    wg, wu = (rng.normal(size=(E, d, f)) / np.sqrt(d) for _ in range(2))
    wd = rng.normal(size=(E, f, d)) / np.sqrt(f)
    args = [x, idx, gates, wg.astype(np.float32), wu.astype(np.float32),
            wd.astype(np.float32)]
    out = ops.grouped_expert_ffn(*map(_t, args), block_m=BM)
    for impl in ("jax", "pallas"):
        ref = jops.grouped_expert_ffn(*map(jnp.asarray, args), block_m=BM,
                                      impl=impl)
        _close(out, ref, 1e-5)


def _moe_setup(seed=0, **over):
    jcfg = jget_config("qwen2-moe-a2.7b", reduced=True).replace(
        moe_backend="grouped", **over)
    jp = jspec.initialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed),
                          jcfg.dtype)
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        moe_backend="grouped", **over)
    tp = interop.from_numpy_tree(jax.device_get(jp), "cpu")
    x = np.random.default_rng(seed).normal(
        size=(2, 7, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, tp, x


def test_moe_apply_grouped_matches_jax_and_oracles():
    jcfg, jp, cfg, tp, x = _moe_setup()
    # give the shared-expert gate a non-zero weight so its path is exercised
    g = np.random.default_rng(9).normal(size=(cfg.d_model, 1)).astype(np.float32)
    jp["shared"]["gate"] = jnp.asarray(g)
    tp["shared"]["gate"] = _t(g)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_apply(tp, cfg, _t(x))
    _close(y, jy, 1e-5)
    _close(aux, jaux, 1e-5)
    _close(y, jmoe.moe_apply_oracle(jp, jcfg, jnp.asarray(x)), 1e-5)
    _close(moe.moe_apply_oracle(tp, cfg, _t(x)), jy, 1e-5)


def test_tied_router_logits_pick_lower_expert_first():
    """Duplicate router columns make probabilities tie exactly; the port
    must pick the same experts, in the same order, as jax.lax.top_k."""
    jcfg, jp, cfg, tp, x = _moe_setup(seed=3)
    r = np.asarray(jp["router"]).copy()
    E = r.shape[1]
    for a, b in ((1, 5), (2, 6), (0, 3), (4, 7)):
        r[:, b % E] = r[:, a % E]
    jp["router"] = jnp.asarray(r)
    tp["router"] = _t(r)
    xf = x.reshape(-1, x.shape[-1])
    _, jg, ji = jmoe._route(jp, jcfg, jnp.asarray(xf))
    _, tg, ti = moe._route(tp, cfg, _t(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-6)
    # ties really occur: the top-2 probabilities are equal on every row
    probs = moe._router_probs(tp, cfg, _t(xf))
    top2 = torch.sort(probs, dim=-1, descending=True).values[:, :2]
    assert bool((top2[:, 0] == top2[:, 1]).all())
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    y, _ = moe.moe_apply(tp, cfg, _t(x))
    _close(y, jy, 1e-5)


def test_cuda_only_arguments_are_checked():
    lhs, rhs, te = _gmm_inputs(0)
    assert ops.default_block_m("cpu") == 16
    assert ops.default_block_m("cuda") == ops.KERNEL_BLOCK_M
    with pytest.raises(ValueError):
        ops._check_cuda_args(_t(lhs), _t(rhs), _t(te), BM,
                             torch.ones(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        moe.moe_apply({}, get_config("qwen2-moe-a2.7b", reduced=True),
                      torch.zeros(1, 1, 128))


# ------------------------------------------------------------- gradients

@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_grouped_matmul_grads_match_jax_vjp(impl):
    """The autograd Function's (d_lhs, d_rhs) against jax.vjp of the
    reference's custom_vjp (d_lhs via the transposed read, d_rhs segment-
    summed), both backends of the reference."""
    lhs, rhs, te = _gmm_inputs(5)
    ct = np.random.default_rng(6).normal(
        size=(lhs.shape[0], rhs.shape[2])).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jops.grouped_matmul(
        a, b, jnp.asarray(te), BM, impl), jnp.asarray(lhs), jnp.asarray(rhs))
    jd_lhs, jd_rhs = vjp(jnp.asarray(ct))
    tl, tr = _t(lhs).requires_grad_(), _t(rhs).requires_grad_()
    out = ops.grouped_matmul(tl, tr, _t(te), BM)
    out.backward(_t(ct))
    _close(tl.grad, jd_lhs, 1e-5)
    _close(tr.grad, jd_rhs, 1e-5)


def test_transposed_read_and_chunked_d_rhs(monkeypatch):
    lhs, rhs, te = _gmm_inputs(7)
    rng = np.random.default_rng(8)
    ct = rng.normal(size=(lhs.shape[0], rhs.shape[2])).astype(np.float32)
    got = ops.grouped_matmul_kernel(_t(ct), _t(rhs), _t(te), BM,
                                    trans_rhs=True)
    want = jgmm_ref(jnp.asarray(ct), jnp.asarray(rhs).transpose(0, 2, 1),
                    jnp.asarray(te), block_m=BM)
    _close(got, want, 1e-5)
    whole = ops.grouped_d_rhs(_t(lhs), _t(ct), _t(te), BM, rhs.shape[0])
    # one tile per chunk: the bounded transient gives the same sums
    monkeypatch.setattr(ops, "D_RHS_CHUNK_BYTES", 1)
    chunked = ops.grouped_d_rhs(_t(lhs), _t(ct), _t(te), BM, rhs.shape[0])
    _close(chunked, whole, 1e-6)


@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_grouped_expert_ffn_grads_match_jax(impl):
    rng = np.random.default_rng(10)
    T, E, k, d, f = 17, 8, 2, 32, 24
    idx = _routing(rng, T, E, k)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gates = rng.random(size=(T, k)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    ct = rng.normal(size=(T, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x_, g_, a, b, c: jops.grouped_expert_ffn(
            x_, jnp.asarray(idx), g_, a, b, c, block_m=BM, impl=impl),
        *map(jnp.asarray, [x, gates] + ws))
    jgrads = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in [x, gates] + ws]
    out = ops.grouped_expert_ffn(leaves[0], _t(idx), *leaves[1:], block_m=BM)
    out.backward(_t(ct))
    for got, want in zip(leaves, jgrads):
        _close(got.grad, want, 1e-5)


def test_moe_apply_grads_match_jax():
    """Router softmax, top-k gate values, dispatch, grouped GEMMs, combine
    and the shared expert all carry gradients; the aux value does not
    enter."""
    jcfg, jp, cfg, tp, x = _moe_setup(seed=11)
    g = np.random.default_rng(12).normal(size=(cfg.d_model, 1)).astype(np.float32)
    jp["shared"]["gate"] = jnp.asarray(g)
    tp["shared"]["gate"] = _t(g)
    ct = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: jmoe.moe_apply(p, jcfg, xx)[0], jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    from repro_torch.models.spec import tree_leaves
    leaves = [t.requires_grad_() for _, t in tree_leaves(tp)]
    tx = _t(x).requires_grad_()
    y, _ = moe.moe_apply(tp, cfg, tx)
    y.backward(_t(ct))
    _close(tx.grad, jgx, 1e-5)
    jl = dict(tree_leaves(jax.device_get(jgp)))
    for (path, t), leaf in zip(tree_leaves(tp), leaves):
        _close(leaf.grad, jl[path], 1e-5)
