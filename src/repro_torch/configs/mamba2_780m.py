"""mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128),
    source="arXiv:2405.21060; unverified",
)
