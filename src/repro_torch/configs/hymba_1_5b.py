"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf] — SWA for most layers (3 global), meta tokens
omitted (DESIGN.md §9).
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    attn_pattern="15local:1global",
    window=1024,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=128),
    rope_theta=1e4,
    source="arXiv:2411.13676; hf",
)
