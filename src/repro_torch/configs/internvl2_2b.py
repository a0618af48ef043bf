"""internvl2-2b — VLM: InternViT frontend (STUB) + InternLM2 backbone.

[arXiv:2404.16821; hf] — ``input_specs()`` supplies precomputed patch
embeddings [B, 256, d_model]; the text backbone is built in full.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend="patch",
    frontend_len=256,
    rope_theta=1e6,
    source="arXiv:2404.16821; hf",
)
