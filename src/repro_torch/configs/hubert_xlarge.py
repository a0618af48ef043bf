"""hubert-xlarge — encoder-only audio backbone (w2v2 arch) [arXiv:2106.07447].

The conv feature-extractor frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame features [B, T, 512].
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    frontend="frames",
    frontend_dim=512,
    mlp_act="gelu",
    rope_theta=1e4,
    source="arXiv:2106.07447; unverified",
)
