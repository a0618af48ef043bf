"""grok-1-314b — MoE 64L, 8 experts top-2 [hf:xai-org/grok-1; unverified]."""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff_expert=32768),
    rope_theta=1e4,
    source="hf:xai-org/grok-1; unverified",
)
