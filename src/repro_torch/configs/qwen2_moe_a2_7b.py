"""qwen2-moe-a2.7b — the paper's own base model (Qwen1.5-MoE-A2.7B).

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4, 4 shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,              # shared-expert path width (4 x 1408)
    vocab_size=151936,
    qkv_bias=True,
    num_experts=60,
    top_k=4,
    num_shared_experts=4,
    d_ff_expert=1408,
    moe_period=1,           # every layer is MoE
    rope_theta=1_000_000.0,
    hbm_budget_gb=80.0,     # paper scenario: full-param FT on one 80G device
)
