"""Per-request, per-slot seeded sampling on device (port of
``repro.serving.sampling``).

The engine keeps one sampling row per decode slot in a flat dict of
(slots,)-shaped tensors: temperature / top-k / top-p knobs, the request
seed, the EOS id and token budget, a generated-token counter and an output
ring.  ``sample`` picks the next token for every slot and ``advance`` applies
EOS / max-new-tokens termination, all without a host round-trip.

Semantics (per slot), as in the reference:

  * greedy is the zero-temperature case (argmax, lowest index on ties);
  * otherwise logits are scaled by 1/temperature, restricted to the top-k
    highest (``top_k == 0`` disables) and to the smallest prefix whose mass
    reaches ``top_p`` (the boundary token is kept, the top token always),
    then sampled by Gumbel-max over the surviving set;
  * the noise of token ``i`` of a request depends only on (request seed,
    i, vocab id) — never on slot placement, admission order or drain
    cadence.  ``jax.random`` cannot be reproduced in torch, so the noise is
    a counter-based hash written with integer tensor ops: every value is
    kept in [0, 2^32) and multiplied only by constants below 2^31, so int64
    never wraps and right shifts never see a sign bit.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B              # < 2^31: a product of it and a 32-bit value fits int64
_GOLDEN = 0x1E3779B9


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed, index, vocab_ids):
    """Standard Gumbel noise keyed on (seed, token index, vocab id).

    seed/index: (B,) integer tensors; vocab_ids: (B, V).  Returns (B, V) f32.
    """
    s = seed.to(torch.int64) & _M32
    i = index.to(torch.int64) & _M32
    h = _mix32(s ^ _mix32((i + _GOLDEN) & _M32))                 # (B,)
    x = _mix32(h[:, None] ^ ((vocab_ids.to(torch.int64) * _GOLDEN) & _M32))
    u = ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))   # (0, 1)
    return -torch.log(-torch.log(u))


# ------------------------------------------------------------------ state

def init_state(slots: int, out_len: int, device="cpu") -> dict:
    """Fresh per-slot sampling/termination state."""
    def z(dtype):
        return torch.zeros((slots,), dtype=dtype, device=device)
    return {
        "seed": z(torch.int64),
        "temperature": z(torch.float32),
        "top_k": z(torch.int32),
        "top_p": torch.ones((slots,), dtype=torch.float32, device=device),
        "eos_id": torch.full((slots,), -1, dtype=torch.int32, device=device),
        "max_new": z(torch.int32),
        "gen": z(torch.int32),                      # tokens generated so far
        "active": z(torch.bool),
        "last_tok": z(torch.int32),
        "out": torch.zeros((slots, out_len), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------- sampling

def sample_token(logits, seed, index, temperature, top_k, top_p):
    """One token per row.  logits: (B, V); every knob is a (B,) tensor."""
    V = logits.shape[-1]
    sorted_l, sorted_i = torch.sort(logits.float(), dim=-1, descending=True,
                                    stable=True)
    greedy = sorted_i[:, 0]

    scaled = sorted_l / torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    ar = torch.arange(V, device=logits.device)
    keep = ar[None, :] < k_eff[:, None]
    # keep the token that crosses the top_p boundary (prefix mass < p)
    keep &= (cum - probs) < top_p[:, None]
    keep[:, 0] = True          # top_p -> 0 (or top_k <= 0) degrades to greedy
    masked = torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))
    noise = gumbel_noise(seed, index, sorted_i)
    choice = torch.argmax(masked + noise, dim=-1)
    sampled = sorted_i.gather(1, choice[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


def sample(logits, state):
    """Next token for every slot; token index = the slot's generated count."""
    return sample_token(logits, state["seed"], state["gen"],
                        state["temperature"], state["top_k"], state["top_p"])


# ------------------------------------------------------- termination step

def advance(state, tok):
    """Record ``tok`` for every active slot and apply termination: EOS or the
    token budget flips ``active`` off; inactive slots are frozen."""
    active = state["active"]
    gen = state["gen"]
    done = active & ((tok == state["eos_id"]) | (gen + 1 >= state["max_new"]))
    slots = torch.arange(tok.shape[0], device=tok.device)
    pos = torch.clamp(gen, 0, state["out"].shape[1] - 1).long()
    out = state["out"].clone()
    out[slots, pos] = torch.where(active, tok, state["out"][slots, pos])
    new = dict(state)
    new["out"] = out
    new["gen"] = gen + active.to(gen.dtype)
    new["active"] = active & ~done
    new["last_tok"] = torch.where(active, tok, state["last_tok"])
    return new


def admit_row(state, admit, *, seed, temperature, top_k, top_p, eos_id,
              max_new, first_tok):
    """Overwrite the rows selected by ``admit`` with fresh request parameters
    and the prefill-produced first token, applying the admission-time
    termination check (first token is EOS, or a one-token budget)."""
    def pick(new, old):
        m = admit.reshape((admit.shape[0],) + (1,) * (new.ndim - 1))
        return torch.where(m, new.to(old.dtype), old)

    done0 = (first_tok == eos_id) | (max_new <= 1)
    new = dict(state)
    new["seed"] = pick(seed, state["seed"])
    new["temperature"] = pick(temperature, state["temperature"])
    new["top_k"] = pick(top_k, state["top_k"])
    new["top_p"] = pick(top_p, state["top_p"])
    new["eos_id"] = pick(eos_id, state["eos_id"])
    new["max_new"] = pick(max_new, state["max_new"])
    new["gen"] = pick(torch.ones_like(state["gen"]), state["gen"])
    new["active"] = pick(~done0, state["active"])
    new["last_tok"] = pick(first_tok, state["last_tok"])
    out = state["out"].clone()
    out[:, 0] = torch.where(admit, first_tok.to(out.dtype), out[:, 0])
    new["out"] = out
    return new
