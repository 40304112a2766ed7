"""The port's flash attention (plain twins, wrappers and the autograd
Function) against the JAX package, on the CPU in f32.

Each case feeds the same numpy inputs to both: the forward twin against
``flash_attention_fwd_jax`` and against interpret-mode Pallas
``flash_attention(..., return_lse=True)``; the backward twin against
``flash_attention_bwd_jax`` and interpret-mode Pallas
``flash_attention_bwd``; the Function's grads against ``jax.vjp`` of
``flash_attention_trainable(impl="jax")``.  S = 128 with 32-wide blocks,
so several tiles and dead tiles are exercised.  atol 1e-5: f32 sums of
32-128-term products in another order (observed <= 3e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 1e-5
S, BLK = 128, 32

#: (causal, window, softcap, G, hd)
CASES = [(True, None, None, 2, 32), (False, None, None, 1, 64),
         (True, 40, None, 2, 32), (True, None, 30.0, 2, 64),
         (False, 24, 20.0, 2, 32)]


def _ids(c):
    causal, window, cap, G, hd = c
    return f"causal{int(causal)}-w{window}-cap{cap}-G{G}-hd{hd}"


def _inputs(G, hd, seed=0, B=2, KV=2):
    rng = np.random.default_rng(seed)
    H = KV * G
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, H, S, hd), f(B, KV, S, hd), f(B, KV, S, hd), f(B, H, S, hd)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_twin_matches_jax_and_pallas(case):
    causal, window, cap, G, hd = case
    q, k, v, _ = _inputs(G, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), block_q=BLK, **kw)
    jo, jl = jfa.flash_attention_fwd_jax(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block_q=BLK, **kw)
    po, pl = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block_q=BLK, block_k=BLK,
                                 interpret=True, return_lse=True, **kw)
    for ref_o, ref_l in ((jo, jl), (po, pl)):
        _close(o, ref_o)
        _close(lse, ref_l)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_backward_twin_matches_jax_and_pallas(case):
    causal, window, cap, G, hd = case
    q, k, v, do = _inputs(G, hd, seed=1)
    kw = dict(causal=causal, window=window, softcap=cap)
    jo, jl = jfa.flash_attention_fwd_jax(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block_q=BLK, **kw)
    delta = np.sum(do * np.asarray(jo), axis=-1)
    args = (q, k, v, np.asarray(jl), delta, do)
    dq = fa.flash_bwd_dq(*map(_t, args), block_q=BLK, **kw)
    dk, dv = fa.flash_bwd_dkv(*map(_t, args), block_k=BLK, **kw)
    jargs = tuple(map(jnp.asarray, args))
    refs = (jfa.flash_attention_bwd_jax(*jargs, block_q=BLK, block_k=BLK,
                                        **kw),
            jfa.flash_attention_bwd(*jargs, block_q=BLK, block_k=BLK,
                                    interpret=True, **kw))
    for ref in refs:
        for got, want in zip((dq, dk, dv), ref):
            _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_autograd_function_matches_jax_vjp(case):
    causal, window, cap, G, hd = case
    q, k, v, do = _inputs(G, hd, seed=2)
    out, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention_trainable(
            a, b, c, causal, window, cap, BLK, BLK, "jax"),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention_trainable(tq, tk, tv, causal, window, cap, BLK,
                                     BLK)
    _close(o.detach(), out)
    o.backward(_t(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want)


def test_fully_masked_rows_follow_the_reference():
    """window = 0 masks every key: NEG_INF semantics give o = mean(v) and
    lse = -1e30 in the reference; the twin must agree."""
    q, k, v, _ = _inputs(2, 32, seed=3)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=True, window=0,
                          block_q=BLK)
    jo, jl = jfa.flash_attention_fwd_jax(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         window=0, block_q=BLK)
    _close(o, jo)
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jl))
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), 2, axis=1)
    _close(o, np.broadcast_to(mean_v, o.shape))


def test_cpu_tensors_run_the_twins_and_cuda_arguments_are_checked():
    q, k, v, do = _inputs(2, 32, seed=4)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v))
    fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), lse, lse, _t(do))
    assert fa.LAUNCHES == before
    with pytest.raises(ValueError):       # CPU tensors are not the card's
        fa._check_cuda_args("flash_fwd", _t(q), _t(k), _t(v))
