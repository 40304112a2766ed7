"""Synthetic instruction-tuning data pipeline (dolly-15k record schema) —
an own copy of ``repro.data.pipeline`` (numpy only, same draws).

Deterministic synthetic instruction/response pairs with a Zipf token
distribution and structural markers, packed into fixed-length sequences
with response-only loss masks, sharded by (host, step) so a restarted
replica recomputes exactly its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

BOS, EOS, SEP, PAD = 1, 2, 3, 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 512
    global_batch: int = 8
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    mask_instruction: bool = True   # loss on response tokens only (SFT style)


def _sample_doc(rng: np.random.Generator, vocab: int, max_len: int):
    """One synthetic instruction/response record."""
    ilen = int(rng.integers(8, max(9, max_len // 4)))
    rlen = int(rng.integers(16, max(17, max_len // 2)))

    # Zipf-ish over the real token range [4, vocab)
    def toks(n):
        z = rng.zipf(1.3, size=n * 2)
        z = z[z < vocab - 4][:n]
        while z.size < n:
            z = np.concatenate([z, rng.integers(4, vocab, size=n)])[:n]
        return (z + 4).clip(4, vocab - 1).astype(np.int32)
    return toks(ilen), toks(rlen)


def packed_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    """Yields {'tokens': (B,S) int32, 'loss_mask': (B,S) f32} forever.
    Deterministic in (seed, host_id, step): resume == replay."""
    B = cfg.global_batch // cfg.num_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_id)
        tokens = np.full((B, cfg.seq_len), PAD, np.int32)
        mask = np.zeros((B, cfg.seq_len), np.float32)
        for b in range(B):
            pos = 0
            while pos < cfg.seq_len - 8:
                ins, res = _sample_doc(rng, cfg.vocab_size, cfg.seq_len)
                rec = np.concatenate(
                    [[BOS], ins, [SEP], res, [EOS]]).astype(np.int32)
                n = min(rec.size, cfg.seq_len - pos)
                tokens[b, pos:pos + n] = rec[:n]
                rstart = 1 + ins.size + 1      # response begins after SEP
                lo, hi = pos + rstart, pos + n
                if cfg.mask_instruction and hi > lo:
                    mask[b, lo:hi] = 1.0
                elif not cfg.mask_instruction:
                    mask[b, pos:pos + n] = 1.0
                pos += n
        yield {"tokens": tokens, "loss_mask": mask}
        step += 1


def eval_batch(cfg: DataConfig, seed_offset: int = 777) -> Dict:
    """A fixed held-out batch (same generator, disjoint seed stream)."""
    it = packed_batches(dataclasses.replace(cfg, seed=cfg.seed + seed_offset))
    return next(it)
