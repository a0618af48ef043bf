"""qwen1.5-32b — dense 64L MHA-equivalent GQA(kv=40) with QKV bias."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B family; hf",
)
