"""gemma3-4b — dense 34L, 5:1 local:global sliding window, 128k class.

[hf:google/gemma-3-1b-pt; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    attn_pattern="5local:1global",
    window=1024,
    tie_embeddings=True,
    rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt; unverified",
)
