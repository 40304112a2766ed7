"""The port's model (param tree, init, prefill and paged decode) against the
JAX package's ``Model``, on the CPU in f32, and the numpy interop.

Prefill through ``decode_step_hidden`` and four paged decode steps through
``decode_step_hidden_paged`` on reduced qwen2-moe (grouped MoE backend,
weights carried over from JAX) agree to 1e-4 abs on h: f32 through two
stacks of attention, MoE and norms, summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import spec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


def _spec_leaves(tree, is_leaf, prefix=()):
    if is_leaf(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, is_leaf, prefix + (k,)))
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_param_tree_matches_jax(reduced):
    jm = JModel(jget_config("qwen2-moe-a2.7b", reduced=reduced))
    tm = Model(get_config("qwen2-moe-a2.7b", reduced=reduced))
    jl = _spec_leaves(jm.param_specs(), jspec.is_spec)
    tl = _spec_leaves(tm.param_specs(), spec.is_spec)
    assert sorted(jl) == sorted(tl)
    for path, js in jl.items():
        ts = tl[path]
        assert (ts.shape, ts.axes, ts.init, ts.dtype, ts.stack_dims) == (
            js.shape, js.axes, js.init, js.dtype, js.stack_dims), path
    assert tm.num_params() == jm.num_params()
    if not reduced:
        assert tm.num_params() == 15_347_755_008


def test_init_kinds_and_shapes():
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = dict(spec.tree_leaves(params))
    specs = dict(spec.tree_leaves(model.param_specs()))
    assert leaves.keys() == specs.keys()
    for path, s in specs.items():
        t = leaves[path]
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32, path
        if s.init == "zeros":
            assert not t.any(), path
        else:
            std = float(t.std())
            want = spec._scale(s)
            assert 0.85 * want < std < 1.15 * want, (path, std, want)
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(leaves[p], dict(spec.tree_leaves(again))[p])
               for p in leaves)


def test_interop_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, size=(4,)).astype(np.int32)}}
    t32 = interop.from_numpy_tree(tree, "cpu")
    back = interop.to_numpy_tree(t32)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    # bf16 from JAX (ml_dtypes) crosses bit for bit, both ways
    jb = jnp.asarray(tree["a"]).astype(jnp.bfloat16)
    tb = interop.from_numpy_tree({"w": jax.device_get(jb)}, "cpu")["w"]
    assert tb.dtype == torch.bfloat16
    bits = interop.to_numpy_tree({"w": tb})["w"]
    np.testing.assert_array_equal(bits, np.asarray(jb).view(np.uint16))
    again = interop.from_numpy_tree({"w": bits}, "cpu")["w"]
    assert torch.equal(again.view(torch.int16), tb.view(torch.int16))
    # a float cast on the way in
    assert interop.from_numpy_tree(tree, "cpu", torch.bfloat16)["a"].dtype \
        == torch.bfloat16


def _paged_from_dense(k, v, pos, page, perm):
    """Pool + page tables holding a dense (L, B, C, ...) prefill cache:
    slot b's logical page j lives at physical page perm[b * n + j]."""
    L, B, C = k.shape[:3]
    n = C // page
    P = len(perm)
    pk = np.zeros((L, P, page) + k.shape[3:], k.dtype)
    pv = np.zeros_like(pk)
    ppos = np.full((L, P, page), -1, np.int32)
    pt = np.full((B, n), -1, np.int32)
    for b in range(B):
        for j in range(n):
            ph = perm[b * n + j]
            pt[b, j] = ph
            sl = slice(j * page, (j + 1) * page)
            pk[:, ph] = k[:, b, sl]
            pv[:, ph] = v[:, b, sl]
            ppos[:, ph] = pos[:, b, sl]
    return {"layers": {"kv": {"k": pk, "v": pv, "pos": ppos}}}, pt


def test_prefill_then_paged_decode_matches_jax():
    jcfg = jget_config("qwen2-moe-a2.7b", reduced=True).replace(
        moe_backend="grouped")
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        moe_backend="grouped")
    tm = Model(cfg)
    params = interop.from_numpy_tree(jax.device_get(jparams), "cpu")

    rng = np.random.default_rng(0)
    B, S, C, page = 3, 11, 32, 8
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    jh, jcache = jm.decode_step_hidden(jparams, jm.init_cache(jparams, B, C),
                                       jnp.asarray(tokens))
    th, tcache = tm.decode_step_hidden(params, tm.init_cache(params, B, C),
                                       torch.from_numpy(tokens).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    jkv = jax.device_get(jcache["layers"]["kv"])
    tkv = tcache["layers"]["kv"]
    np.testing.assert_allclose(tkv["k"].numpy(), jkv["k"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tkv["v"].numpy(), jkv["v"], rtol=0, atol=1e-4)
    # the reference keeps one pos row per (lockstep) batch; the port one per row
    np.testing.assert_array_equal(
        tkv["pos"].numpy(), np.broadcast_to(jkv["pos"][:, None], (
            jkv["pos"].shape[0], B, C)))
    assert tcache["t"].tolist() == [S] * B

    # both engines decode from the same pool, built from the JAX prefill
    jpos = np.broadcast_to(jkv["pos"][:, None], tkv["pos"].shape)
    perm = list(rng.permutation(B * (C // page) + 2))
    pool_np, pt = _paged_from_dense(jkv["k"], jkv["v"], jpos, page, perm)
    jpool = jax.tree_util.tree_map(jnp.asarray, pool_np)
    tpool = interop.from_numpy_tree(pool_np, "cpu")
    t = np.full((B,), S, np.int32)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        wmask = np.array([True, step != 2, True])       # one row skips a write
        jh, jpool = jm.decode_step_hidden_paged(
            jparams, jpool, jnp.asarray(pt), jnp.asarray(t), jnp.asarray(tok),
            jnp.asarray(wmask), kv_len=C)
        th, tpool = tm.decode_step_hidden_paged(
            params, tpool, torch.from_numpy(pt), torch.from_numpy(t),
            torch.from_numpy(tok).long(), torch.from_numpy(wmask), kv_len=C)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-4, err_msg=f"step {step}")
        t = t + 1
    jp = jax.device_get(jpool["layers"]["kv"])
    tp = tpool["layers"]["kv"]
    np.testing.assert_array_equal(tp["pos"].numpy(), jp["pos"])
    np.testing.assert_allclose(tp["k"].numpy(), jp["k"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp["v"].numpy(), jp["v"], rtol=0, atol=1e-4)


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("h2o-danube-1.8b")
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    for over in (dict(sliding_window=16), dict(fold_adapters=True),
                 dict(num_layer_groups=2), dict(expert_parallel=2)):
        with pytest.raises(NotImplementedError):
            Model(cfg.replace(**over))
