"""The port's paged serving engine against the JAX reference engine, and the
port's sampling properties.

T = 0 serving on the same weights (reduced qwen2-moe, 2 layers, grouped MoE
backend) must give equal tokens and equal radix prefix-hit counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop, obs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(4, vocab, size=16).astype(np.int32)
    tails = [rng.integers(4, vocab, size=n).astype(np.int32)
             for n in (5, 9, 3, 12, 6)]
    return [np.concatenate([sys_prompt, t]) for t in tails]


def test_paged_engine_tokens_equal_jax_reference():
    jcfg = jget_config("qwen2-moe-a2.7b", reduced=True).replace(
        num_layers=2, moe_backend="grouped")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(slots=2, buf_len=48, paged=True, page_size=8, drain_every=3)

    jtel = jobs.Telemetry()
    jeng = JEngine(jmodel, jparams, telemetry=jtel, **kw)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=7, eos_id=-1))
    jdone = {u: r.generated for u, r in jeng.run().items()}

    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        num_layers=2, moe_backend="grouped")
    model = Model(cfg)
    params = interop.from_numpy_tree(jax.device_get(jparams), "cpu")
    tel = obs.Telemetry()
    eng = ServingEngine(model, params, telemetry=tel, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=7, eos_id=-1))
    done = {u: r.generated for u, r in eng.run().items()}

    assert done == jdone
    assert all(len(g) == 7 for g in done.values())
    for name in ("serve.prefix_hits", "serve.prefix_hit_tokens",
                 "serve.prefill_batches", "serve.requests_done"):
        assert tel.counter(name).value == jtel.counter(name).value, name
    assert tel.counter("serve.prefix_hits").value > 0
    assert eng.page_pool.ref == jeng.page_pool.ref


def test_prefix_plus_bucket_past_the_buffer_keeps_every_position():
    """A radix hit of m tokens plus a suffix bucket longer than
    buf_len - m: the prefill workspace grows instead of clamping the write,
    so the slot's pages hold every prompt position (the reference loses
    positions m .. m + 7 here — ROADMAP.md queue 3) and the tokens equal a
    run without the prefix cache."""
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        num_layers=2, moe_backend="grouped")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    pre = rng.integers(4, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(4, cfg.vocab_size, size=n)
                               .astype(np.int32)]) for n in (4, 20)]

    def serve(prefix_cache):
        eng = ServingEngine(model, params, slots=1, buf_len=40, paged=True,
                            page_size=8, prefix_cache=prefix_cache)
        eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4))
        eng.run()
        eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=4))
        eng._admit()
        pages, m = eng._slot_pages[0]
        pos = eng.pool["layers"]["kv"]["pos"][0][pages].flatten()
        held = sorted(int(x) for x in pos if x >= 0)
        eng.run()
        return {u: r.generated for u, r in eng.done.items()}, m, held

    hit, m, held = serve(True)
    assert m == 16
    assert held == list(range(prompts[1].size))
    miss, m0, held0 = serve(False)
    assert m0 == 0 and held0 == held
    assert hit == miss


def test_engine_rejects_what_it_cannot_serve():
    cfg = get_config("qwen2-moe-a2.7b", reduced=True).replace(
        num_layers=1, moe_backend="grouped")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(model, params, slots=2, buf_len=16, paged=True,
                        page_size=8)
    req = eng.submit(Request(uid=0, prompt=np.arange(4, 14, dtype=np.int32),
                             max_new_tokens=8))
    assert req.rejected and req.generated == []
    with pytest.raises(NotImplementedError):
        ServingEngine(model, params, paged=False)


# ------------------------------------------------------------------ sampling

def _logits(seed=0, rows=4, V=64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(rows, V)).astype(np.float32))


def _knobs(rows, temperature=0.9, top_k=0, top_p=1.0):
    return (torch.full((rows,), temperature), torch.full((rows,), top_k,
                                                         dtype=torch.int32),
            torch.full((rows,), top_p))


def test_same_seed_same_stream_whatever_the_slot():
    """A request's token i depends only on (seed, i): the same logits row
    sampled in another slot, beside other requests, gives the same token."""
    logits = _logits()
    seeds = torch.tensor([11, 22, 33, 44])
    idx = torch.tensor([0, 5, 2, 9])
    temp, tk, tp = _knobs(4)
    a = sampling.sample_token(logits, seeds, idx, temp, tk, tp)
    perm = torch.tensor([2, 0, 3, 1])
    b = sampling.sample_token(logits[perm], seeds[perm], idx[perm], temp,
                              tk, tp)
    assert torch.equal(a[perm], b)
    # a different token index (or seed) draws fresh noise somewhere
    many = _logits(1, rows=64)
    s64 = torch.full((64,), 7)
    temp64, tk64, tp64 = _knobs(64, temperature=5.0)
    x0 = sampling.sample_token(many, s64, torch.zeros(64, dtype=torch.int32),
                               temp64, tk64, tp64)
    x1 = sampling.sample_token(many, s64, torch.ones(64, dtype=torch.int32),
                               temp64, tk64, tp64)
    assert not torch.equal(x0, x1)


def test_greedy_cases_are_argmax():
    logits = _logits(2)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    seeds, idx = torch.arange(4), torch.arange(4)
    for temperature, top_k, top_p in ((0.0, 0, 1.0), (0.8, 0, 0.0),
                                      (0.8, 1, 1.0)):
        tok = sampling.sample_token(logits, seeds, idx,
                                    *_knobs(4, temperature, top_k, top_p))
        assert torch.equal(tok, greedy), (temperature, top_k, top_p)


def test_greedy_ties_pick_lowest_index():
    logits = torch.zeros((2, 16))
    logits[0, [3, 9]] = 1.0
    logits[1, [12, 5]] = 2.0
    tok = sampling.sample_token(logits, torch.zeros(2), torch.zeros(2),
                                *_knobs(2, 0.0))
    assert tok.tolist() == [3, 5]


def test_sampled_tokens_stay_in_top_k():
    logits = _logits(4, rows=32, V=128)
    tok = sampling.sample_token(logits, torch.arange(32), torch.arange(32),
                                *_knobs(32, 2.0, 3, 1.0))
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert bool((top3 == tok[:, None].long()).any(dim=-1).all())


def test_gumbel_noise_is_standard_gumbel():
    ids = torch.arange(4096)[None].repeat(8, 1)
    g = sampling.gumbel_noise(torch.arange(8), torch.arange(8), ids)
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.03
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.08
