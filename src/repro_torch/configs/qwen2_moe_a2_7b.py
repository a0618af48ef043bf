"""qwen2-moe-a2.7b — MoE 24L, 60 routed experts top-4 + 4 shared.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408),
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
