"""The port's CUDA kernels against their plain twins on the card, at edge
shapes the smoke does not reach (ragged K and N, several query heads per KV
head, small head dims, kv_len off the page grid, ragged sequence lengths,
fully masked rows, wkv chunks and head sizes, decays at the floor and near
1, rmsnorm rows off the 16-byte grid), the reduced engine on the card
against the same engine on the CPU, and the reduced training steps of
qwen2-moe and rwkv6 on the card against the CPU.

Needs a CUDA GPU and nvcc; skipped elsewhere.  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: max|err| <= 1e-4 * max|ref| in f32,
<= 2e-2 * max|ref| in bf16 (other summation order; bf16 outputs round).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.kernels.moe import dispatch as dsp  # noqa: E402
from repro_torch.kernels.moe import ops  # noqa: E402
from repro_torch.kernels.moe.ref import grouped_matmul_ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.kernels import build
    build.library()              # builds with nvcc; raises when it cannot
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= TOL[dtype] * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,K,N", [(33, 5, 2, 40, 200), (4, 64, 4, 128, 64),
                                       (70, 8, 2, 2048, 136)])
def test_grouped_gemm_matches_twin(dev, dtype, T, E, k, K, N):
    g = torch.Generator(device=dev).manual_seed(T + K)
    idx = torch.argsort(torch.rand((T, E), generator=g, device=dev), 1)[:, :k]
    plan = dsp.make_plan(idx, E, ops.KERNEL_BLOCK_M)
    x = torch.randn((T, K), generator=g, device=dev).to(dtype)
    lhs = dsp.permute(x, plan)
    rhs = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(dtype)
    before = ops.LAUNCHES
    out = ops.grouped_matmul(lhs, rhs, plan.tile_expert, plan.block_m,
                             plan.n_used_tiles)
    assert ops.LAUNCHES == before + 1
    ref = grouped_matmul_ref(lhs, rhs, plan.tile_expert, block_m=plan.block_m)
    _assert_close(out, ref, dtype)
    dead = int(plan.n_used_tiles) * plan.block_m
    assert not out[dead:].any()          # the dead tail is exactly zero


def test_grouped_gemm_rejects_what_it_cannot_take(dev):
    lhs = torch.zeros((64, 40), device=dev)
    rhs = torch.zeros((2, 40, 12), device=dev)
    te = torch.zeros((1,), dtype=torch.int32, device=dev)
    nu = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):      # block_m is not the kernel's tile
        ops.grouped_matmul(lhs[:32], rhs, te, 32, nu)
    with pytest.raises(ValueError):      # N not a multiple of 16 bytes / elt
        ops.grouped_matmul(lhs, torch.zeros((2, 40, 10), device=dev), te, 64, nu)
    with pytest.raises(TypeError):
        ops.grouped_matmul(lhs, rhs.to(torch.bfloat16), te, 64, nu)


def _paged(dev, dtype, B, KV, G, hd, page, n_pages, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    H, P = KV * G, B * n_pages + 2
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((P, page, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((P, page, KV, hd), generator=g, device=dev).to(dtype)
    t = rng.integers(1, n_pages * page, size=B).astype(np.int32)
    phys = rng.permutation(P)
    pt = np.full((B, n_pages), -1, np.int32)
    pos = np.tile(np.arange(page, dtype=np.int32), (P, 1))   # stale everywhere
    for b in range(B):
        for j in range(min(-(-int(t[b] + 1) // page), n_pages)):
            pp = int(phys[b * n_pages + j])
            pt[b, j] = pp
            pos[pp] = [j * page + o if j * page + o <= t[b] else -1
                       for o in range(page)]
    as_dev = lambda a: torch.from_numpy(a).to(dev)             # noqa: E731
    return q, k, v, as_dev(pos), as_dev(pt), as_dev(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,page,n_pages,kv_cut", [
    (2, 2, 32, 8, 4, 0), (16, 1, 128, 16, 8, 0), (1, 4, 64, 16, 5, 7),
    (4, 2, 96, 4, 9, 3)])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, 20.0)])
def test_paged_attention_matches_twin(dev, dtype, KV, G, hd, page, n_pages,
                                      kv_cut, window, softcap):
    q, k, v, pos, pt, t = _paged(dev, dtype, 3, KV, G, hd, page, n_pages,
                                 seed=KV * 100 + hd)
    kw = dict(kv_len=n_pages * page - kv_cut, window=window, softcap=softcap)
    before = pa.LAUNCHES
    out = pa.paged_attention(q, k, v, pos, pt, t, **kw)
    assert pa.LAUNCHES == before + 1
    _assert_close(out, pa.paged_attention_ref(q, k, v, pos, pt, t, **kw),
                  dtype)


def test_reduced_engine_on_the_card_matches_the_cpu(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        num_layers=2, moe_backend="grouped")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    pre = rng.integers(4, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(4, cfg.vocab_size, size=n)
                               .astype(np.int32)]) for n in (5, 9, 3, 12)]

    def serve(p):
        eng = ServingEngine(model, p, slots=2, buf_len=48, paged=True,
                            page_size=8)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=6, eos_id=-1))
        return {u: r.generated for u, r in eng.run().items()}

    cpu = serve(params)
    launches = (ops.LAUNCHES, pa.LAUNCHES)
    gpu = serve(_to(params, dev))
    assert ops.LAUNCHES > launches[0] and pa.LAUNCHES > launches[1]
    assert gpu == cpu


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,K,N", [(33, 5, 2, 40, 200), (70, 8, 2, 2048, 136),
                                       (300, 64, 4, 128, 64)])
def test_grouped_gemm_transposed_read_matches_twin(dev, dtype, T, E, k, K, N):
    """d_lhs = ct @ W^T read in place from the forward's (E, K_out, N_in)
    weights, against the twin on an explicit transpose."""
    g = torch.Generator(device=dev).manual_seed(T + N)
    idx = torch.argsort(torch.rand((T, E), generator=g, device=dev), 1)[:, :k]
    plan = dsp.make_plan(idx, E, ops.KERNEL_BLOCK_M)
    x = torch.randn((T, K), generator=g, device=dev).to(dtype)
    lhs = dsp.permute(x, plan)
    w = (torch.randn((E, N, K), generator=g, device=dev) * K ** -0.5).to(dtype)
    before = ops.TRANS_LAUNCHES
    out = ops.grouped_matmul_kernel(lhs, w, plan.tile_expert, plan.block_m,
                                    plan.n_used_tiles, trans_rhs=True)
    assert ops.TRANS_LAUNCHES == before + 1
    ref = grouped_matmul_ref(lhs, w.transpose(1, 2), plan.tile_expert,
                             block_m=plan.block_m)
    _assert_close(out, ref, dtype)


def test_grouped_matmul_backward_on_the_card_matches_the_cpu(dev):
    g = torch.Generator().manual_seed(3)
    T, E, k, K, N = 90, 8, 2, 96, 48
    idx = torch.argsort(torch.rand((T, E), generator=g), 1)[:, :k]
    x = torch.randn((T, K), generator=g)
    w = torch.randn((E, K, N), generator=g) * K ** -0.5
    ct = torch.randn((T, N), generator=g)

    def grads(device):
        plan = dsp.make_plan(idx.to(device), E, ops.KERNEL_BLOCK_M)
        xs = dsp.permute(x.to(device), plan).requires_grad_()
        wd = w.to(device).requires_grad_()
        out = ops.grouped_matmul(xs, wd, plan.tile_expert, plan.block_m,
                                 plan.n_used_tiles)
        rows = plan.dest[torch.argsort(plan.order)]
        out[rows].backward(ct.to(device).repeat_interleave(k, 0))
        return xs.grad.cpu(), wd.grad.cpu()

    for got, want in zip(grads(dev), grads("cpu")):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _flash_inputs(dev, dtype, B, KV, G, Sq, Skv, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    return r(B, KV * G, Sq, hd), r(B, KV, Skv, hd), r(B, KV, Skv, hd), \
        r(B, KV * G, Sq, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,Sq,Skv,hd", [
    (2, 2, 2, 100, 100, 32), (1, 1, 4, 64, 192, 64), (1, 3, 1, 130, 77, 128),
    (1, 2, 2, 256, 256, 128)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None), (True, 24, None),
    (False, 40, 20.0), (True, None, 30.0), (True, 0, None)])
def test_flash_kernels_match_twins(dev, dtype, B, KV, G, Sq, Skv, hd, causal,
                                   window, softcap):
    """Forward (o, lse), dq and dk/dv against the twins; window 0 makes
    every row fully masked (o = mean(v), lse = -1e30, zero grads)."""
    q, k, v, do = _flash_inputs(dev, dtype, B, KV, G, Sq, Skv, hd,
                                seed=Sq * 7 + hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    _assert_close(o, ro, dtype)
    dead = rlse <= -1e29
    assert torch.equal(dead, lse <= -1e29)
    if not dead.all():
        _assert_close(lse[~dead], rlse[~dead], torch.float32)
    delta = torch.sum(do.float() * ro.float(), dim=-1)
    dq = fa.flash_bwd_dq(q, k, v, rlse, delta, do, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, rlse, delta, do, **kw)
    rdq = fa.flash_bwd_dq_ref(q, k, v, rlse, delta, do, **kw)
    rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, rlse, delta, do, **kw)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        _assert_close(got, want, dtype)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_flash_rejects_what_it_cannot_take(dev):
    q, k, v, _ = _flash_inputs(dev, torch.float32, 1, 2, 1, 64, 64, 48, 0)
    with pytest.raises(ValueError):      # head dim 48 is not built
        fa.flash_fwd(q, k, v)
    q, k, v, _ = _flash_inputs(dev, torch.float32, 1, 2, 1, 64, 64, 64, 0)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        fa.flash_fwd(q.transpose(1, 2), k, v)


def test_reduced_train_step_on_the_card_matches_the_cpu(dev):
    """Two steps (stage 1, stage 2) of reduced qwen2-moe in f32 with the
    flash branch and grouped MoE, through the reversible stack, on the card
    (CUDA kernels) and on the CPU (twins): params agree to 1e-4 abs."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import schedule
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        moe_backend="grouped", use_flash_kernel=True, flash_block_q=64,
        flash_block_k=64)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        4, cfg.vocab_size, size=(2, 128)).astype(np.int32)),
        "loss_mask": torch.ones((2, 128))} for _ in range(2)]

    def run(device):
        p = _to(params, device)
        opt = AdamW(lr=1e-3)
        st = opt.init(p)
        losses = []
        for stage, b in zip((1, 2), batches):
            step = make_train_step(model, opt, mask_fn=getattr(
                schedule, f"stage{stage}_mask"))
            p, st, met = step(p, st, _to(b, device))
            losses.append(met["loss"])
        return p, losses

    before = (ops.LAUNCHES, ops.TRANS_LAUNCHES, dict(fa.LAUNCHES))
    gpu, gl = run(dev)
    assert ops.LAUNCHES > before[0] and ops.TRANS_LAUNCHES > before[1]
    assert all(fa.LAUNCHES[n] > before[2][n] for n in fa.LAUNCHES)
    cpu, cl = run("cpu")
    np.testing.assert_allclose(gl, cl, rtol=0, atol=1e-4)
    from repro_torch.models.spec import tree_leaves
    for (path, a), (_, b) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4, path


def _wkv_inputs(dev, B, H, S, C, seed, w_lo=0.01, w_hi=0.99):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)     # noqa: E731
    w = w_lo + (w_hi - w_lo) * torch.rand((B, H, S, C), generator=g,
                                          device=dev)
    return (0.5 * r(B, H, S, C), 0.5 * r(B, H, S, C), 0.5 * r(B, H, S, C), w,
            0.3 * r(H, C))


@pytest.mark.parametrize("B,H,S,C,chunk", [
    (1, 2, 64, 64, 16), (2, 3, 128, 64, 32), (1, 1, 256, 64, 64),
    (1, 2, 128, 32, 32), (3, 5, 192, 32, 64), (2, 4, 48, 64, 16),
    (1, 40, 2048, 64, 64)])
def test_wkv_kernel_matches_twin(dev, B, H, S, C, chunk):
    args = _wkv_inputs(dev, B, H, S, C, seed=S + C)
    before = rw.LAUNCHES
    out = rw.rwkv6_scan(*args, chunk=chunk)
    assert rw.LAUNCHES == before + 1
    _assert_close(out, rw.rwkv6_scan_ref(*args, chunk=chunk)[0],
                  torch.float32)


@pytest.mark.parametrize("w_lo,w_hi", [(1e-6, 1e-6), (0.999, 0.999),
                                       (1e-6, 0.999), (0.0, 1e-30)])
def test_wkv_kernel_at_extreme_decays(dev, w_lo, w_hi):
    """Decays at the floor (w = 0 is clamped to 1e-38: a chunk's log decay
    sums to -5600) and near 1; a factorised exp would overflow here."""
    args = _wkv_inputs(dev, 2, 3, 256, 64, seed=11, w_lo=w_lo, w_hi=w_hi)
    _assert_close(rw.rwkv6_scan(*args), rw.rwkv6_scan_ref(*args)[0],
                  torch.float32)


def test_wkv_rejects_what_it_cannot_take(dev):
    r, k, v, w, u = _wkv_inputs(dev, 1, 2, 64, 64, seed=0)
    with pytest.raises(TypeError):
        rw.rwkv6_scan(r.to(torch.bfloat16), k, v, w, u)
    with pytest.raises(ValueError):      # head size 48 is not built
        rw.rwkv6_scan(*_wkv_inputs(dev, 1, 2, 64, 48, seed=0))
    with pytest.raises(ValueError):      # S not a multiple of the chunk
        rw.rwkv6_scan(*_wkv_inputs(dev, 1, 2, 96, 64, seed=0))
    with pytest.raises(ValueError):      # chunk 8 is not built
        rw.rwkv6_scan(r, k, v, w, u, chunk=8)
    with pytest.raises(ValueError):
        rw.rwkv6_scan(r.transpose(2, 3), k, v, w, u)


def test_wkv_trainable_grads_on_the_card_match_the_cpu(dev):
    args = [a.cpu() for a in _wkv_inputs(dev, 2, 3, 256, 64, seed=4)]
    ct = torch.randn((2, 3, 256, 64), generator=torch.Generator().manual_seed(1))

    def grads(device):
        ins = [a.to(device).requires_grad_() for a in args]
        rw.rwkv6_scan_trainable(*ins).backward(ct.to(device))
        return [a.grad.cpu() for a in ins]

    for got, want in zip(grads(dev), grads("cpu")):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 300), (1, 128, 2048),
                                   (2048, 2560), (3, 5)])
def test_rmsnorm_matches_twin(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    s = (0.2 * torch.randn(shape[-1:], generator=g, device=dev)).to(dtype)
    before = rn.LAUNCHES
    out = rn.rmsnorm(x, s)
    assert rn.LAUNCHES == before + 1 and out.dtype == dtype
    _assert_close(out, rn.rmsnorm_ref(x, s), dtype)


def test_rmsnorm_unaligned_rows_and_rejects(dev):
    """A contiguous view that starts off a 16-byte boundary takes the
    one-element path."""
    flat = torch.randn(1 + 6 * 256, device=dev)
    x = flat[1:].view(6, 256)
    s = torch.randn(256, device=dev) * 0.2
    _assert_close(rn.rmsnorm(x, s), rn.rmsnorm_ref(x, s), torch.float32)
    with pytest.raises(ValueError):
        rn.rmsnorm(x.t(), s)
    with pytest.raises(TypeError):
        rn.rmsnorm(x.half(), s)


def test_reduced_rwkv_train_step_on_the_card_matches_the_cpu(dev):
    """Two steps (stage 1, stage 2) of reduced rwkv6-3b in f32 with the wkv
    kernel, through the reversible stack, on the card and on the CPU:
    params agree to 1e-4 abs."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import schedule
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("rwkv6-3b", reduced=True).replace(use_flash_kernel=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        4, cfg.vocab_size, size=(2, 128)).astype(np.int32))} for _ in range(2)]

    def run(device):
        p = _to(params, device)
        opt = AdamW(lr=1e-3)
        st = opt.init(p)
        losses = []
        for stage, b in zip((1, 2), batches):
            step = make_train_step(model, opt, mask_fn=getattr(
                schedule, f"stage{stage}_mask"))
            p, st, met = step(p, st, _to(b, device))
            losses.append(met["loss"])
        return p, losses

    before = rw.LAUNCHES
    gpu, gl = run(dev)
    # forward, inversion and re-run per layer and step
    assert rw.LAUNCHES - before == 3 * cfg.num_layers * 2
    cpu, cl = run("cpu")
    np.testing.assert_allclose(gl, cl, rtol=0, atol=1e-4)
    for (path, a), (_, b) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        assert (a.cpu() - b).abs().max().item() <= 1e-4, path
