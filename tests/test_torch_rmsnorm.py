"""The standalone rmsnorm's twin (``kernels.rmsnorm``, what the wrapper runs
for CPU tensors) against the JAX package's interpret-mode Pallas
``ops.rmsnorm`` and its oracle ``ref.rmsnorm_ref``, at the reference
sweep's shapes in f32 and bf16, inputs drawn with numpy from a seed.

Tolerances: f32 2e-6 of the output's largest entry (rsqrt and the row mean
rounded in another order); bf16 one bf16 ulp of the largest entry (2^-7
relative: the same f32 result can round to either neighbour).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402

from repro_torch.kernels import rmsnorm as rn  # noqa: E402

REL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 300), (1, 128, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_twin_matches_pallas_and_the_oracle(shape, dtype):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    s = (0.2 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jx, js = jnp.asarray(x).astype(dtype), jnp.asarray(s).astype(dtype)
    tdt = getattr(torch, dtype)
    tx, ts = torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(tdt)
    before = rn.LAUNCHES
    out = rn.rmsnorm(tx, ts)
    assert rn.LAUNCHES == before        # CPU tensors: the twin, no kernel
    assert out.dtype == tdt and out.shape == tx.shape
    got = out.float().numpy()
    for want in (jops.rmsnorm(jx, js), jref.rmsnorm_ref(jx, js)):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= REL[dtype] * np.abs(want).max()


def test_rmsnorm_takes_eps():
    x = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32)
    x *= 1e-3                                    # eps now matters
    s = np.zeros(64, np.float32)
    want = np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = rn.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), eps=1e-5)
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
