"""rwkv6-3b (Finch) — attention-free, data-dependent decay linear recurrence.

[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536, head_size 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,           # 2560 / 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    coupling="standard",    # attention-free mixer: F reads stream 2 only
)
