"""PyTorch + CUDA port of the RevFFN reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and layout so each piece has an obvious counterpart.  It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing from ``repro``.

Slice 1 covers paged serving of qwen2-moe-a2.7b: configs, param specs, the
decode paths of the dense/MoE blocks, the sort-based MoE dispatch with a
hand-written CUDA grouped GEMM, the paged-attention CUDA kernel, sampling,
the paged continuous-batching engine and its launcher.  Slice 2 covers its
two-stage reversible full-parameter training: the train-path attention with
hand-written CUDA flash-attention kernels (forward, dq, dk/dv), the grouped
GEMM's backward, the reversible stack, the chunked loss, the stage masks,
AdamW, the train step, the data pipeline, checkpoints, the driver and its
launcher.  Slice 3 trains rwkv6-3b at full width and depth: the RWKV6 time
and channel mixes as a reversible unit, with a hand-written CUDA wkv scan,
and the standalone rmsnorm kernel (which, as in the JAX package, no model
calls).
"""
