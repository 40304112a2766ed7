"""Config system: an own copy of ``repro.configs.base`` (ModelConfig,
``get_config``, ``reduce_config``).

Only the architectures this port has reached resolve; every other name in
``ARCHS`` raises ``NotImplementedError`` pointing at ROADMAP.md queue 1.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention variants
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    local_global: bool = False
    local_window: int = 4096
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_backend: str = "einsum"    # "einsum" | "grouped" (only grouped is ported)
    expert_parallel: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_period: int = 0
    rwkv_head_size: int = 0

    # enc-dec
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # VLM
    cross_attn_period: int = 0
    num_image_tokens: int = 1601

    # RevFFN
    reversible: bool = True
    coupling: str = "cross"
    inverse_fp_iters: int = 3
    adapter_dim: Optional[int] = None

    # lean parameterization
    num_layer_groups: int = 0
    delta_rank: int = 0

    # memory planning
    hbm_budget_gb: Optional[float] = None

    # training
    dtype: str = "bfloat16"
    remat_policy: str = "none"
    attn_q_chunk: int = 1024
    loss_chunk: int = 512
    use_flash_kernel: bool = False
    flash_block_q: int = 128
    flash_block_k: int = 128
    fold_adapters: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def stream_dim(self) -> int:
        """Per-stream width of the reversible split (d_model / 2)."""
        assert self.d_model % 2 == 0
        return self.d_model // 2

    def is_moe_layer(self, layer: int) -> bool:
        return self.num_experts > 0 and (layer % self.moe_period == self.moe_period - 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCHS = [
    "h2o-danube-1.8b",
    "mistral-large-123b",
    "gemma2-27b",
    "qwen1.5-110b",
    "qwen2-moe-a2.7b",
    "llama4-scout-17b-a16e",
    "whisper-medium",
    "zamba2-7b",
    "llama-3.2-vision-11b",
    "rwkv6-3b",
]

#: architectures whose config module this port carries
PORTED = {"qwen2-moe-a2.7b": "qwen2_moe_a2_7b", "rwkv6-3b": "rwkv6_3b"}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported yet — the port serves "
            f"{sorted(PORTED)} (ROADMAP.md queue 1, 'Other families')")
    mod = importlib.import_module(f"repro_torch.configs.{PORTED[name]}")
    cfg: ModelConfig = mod.CONFIG
    if reduced:
        cfg = reduce_config(cfg)
    return cfg


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test config: same family/flags, tiny dims. Runs on CPU."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        inverse_fp_iters=5,
    )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 8),
                  top_k=min(cfg.top_k, 2),
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  d_ff_expert=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16)
    if cfg.attn_period:
        kw.update(attn_period=2)
    if cfg.rwkv_head_size:
        kw.update(rwkv_head_size=32, num_heads=4)
    if cfg.num_encoder_layers:
        kw.update(num_encoder_layers=2, encoder_seq_len=16)
    if cfg.cross_attn_period:
        kw.update(cross_attn_period=2, num_image_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    if cfg.local_global:
        kw.update(local_window=32)
    if cfg.num_layer_groups:
        kw.update(num_layer_groups=math.gcd(kw["num_layers"],
                                            cfg.num_layer_groups))
    return cfg.replace(**kw)
