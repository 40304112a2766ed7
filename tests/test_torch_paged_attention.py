"""The port's paged decode attention (the plain twin, which is what the
wrapper runs for CPU tensors) against the JAX package's gather reference
and its Pallas kernel in interpret mode, on the CPU in f32.

Tolerance 1e-5: the same f32 softmax, summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402

from repro_torch.kernels import paged_attention as pa  # noqa: E402


def _scenario(B=3, n_pages=4, page=8, KV=2, G=2, hd=16, extra_pages=3,
              seed=0, poison=True):
    """Random paged decode state (as tests/test_paged_attention.py builds
    it): per-slot t, a shuffled page table with -1 past the mapped prefix,
    positions valid only up to t — and, with ``poison``, unmapped physical
    pages holding stale in-range positions from a previous owner."""
    rng = np.random.default_rng(seed)
    H = KV * G
    kv_len = n_pages * page
    P = B * n_pages + extra_pages
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k_pool = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    v_pool = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    t = rng.integers(1, kv_len, size=B).astype(np.int32)
    phys = rng.permutation(P)
    pt = np.full((B, n_pages), -1, np.int32)
    pos = np.full((P, page), -1, np.int32)
    for b in range(B):
        n_map = -(-int(t[b] + 1) // page)
        for j in range(min(n_map, n_pages)):
            pp = int(phys[b * n_pages + j])
            pt[b, j] = pp
            for o in range(page):
                if j * page + o <= t[b]:
                    pos[pp, o] = j * page + o
    if poison:
        mapped = set(int(x) for x in pt.ravel() if x >= 0)
        for p in range(P):
            if p not in mapped:
                pos[p] = np.arange(page)
    return q, k_pool, v_pool, pos, pt, t, kv_len


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_twin_matches_jax_reference_and_pallas_interpret(window, softcap):
    q, k, v, pos, pt, t, kv_len = _scenario(seed=(window or 0) + 7)
    kw = dict(kv_len=kv_len, window=window, softcap=softcap)
    ref = jpa.paged_attention_jax(*map(jnp.asarray, (q, k, v, pos, pt, t)),
                                  **kw)
    pal = jpa.paged_attention_pallas(*map(jnp.asarray, (q, k, v, pos, pt, t)),
                                     interpret=True, **kw)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, pt, t)]
    twin = pa.paged_attention_ref(*args, **kw)
    wrapped = pa.paged_attention(*args, **kw)              # CPU -> the twin
    for want in (ref, pal):
        np.testing.assert_allclose(twin.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    assert torch.equal(wrapped, twin)


def test_gather_pages_matches_jax():
    q, k, v, pos, pt, t, kv_len = _scenario(B=2, seed=3)
    for kvl in (kv_len, kv_len - 5):
        jk, jv, jpos = jpa.gather_pages(*map(jnp.asarray, (k, v, pos, pt)),
                                        kvl)
        tk, tv, tpos = pa.gather_pages(*map(torch.from_numpy, (k, v, pos, pt)),
                                       kvl)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_stale_positions_and_unmapped_pages_do_not_leak():
    clean = _scenario(seed=11, poison=False)
    dirty = _scenario(seed=11, poison=True)
    outs = []
    for q, k, v, pos, pt, t, kv_len in (clean, dirty):
        args = [torch.from_numpy(a) for a in (q, k, v, pos, pt, t)]
        outs.append(pa.paged_attention_ref(*args, kv_len=kv_len))
    assert torch.equal(outs[0], outs[1])


def test_cuda_argument_checks_raise():
    q, k, v, pos, pt, t, kv_len = _scenario(seed=2)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, pt, t)]
    with pytest.raises(ValueError):            # CPU tensors are not on CUDA
        pa._check_cuda_args(*args)
