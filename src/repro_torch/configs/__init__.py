"""Architecture registry: ``get_arch("<id>")`` / ``--arch <id>``.

A copy of ``repro.configs`` (the port imports nothing of the JAX package):
the same ten architectures, ``SHAPES`` and skip rules, field for field.
"""

from __future__ import annotations

from .base import SHAPES, ArchConfig, ShapeConfig, smoke_shape  # noqa: F401
from .gemma3_4b import CONFIG as gemma3_4b
from .grok1_314b import CONFIG as grok_1_314b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .hymba_1_5b import CONFIG as hymba_1_5b
from .internvl2_2b import CONFIG as internvl2_2b
from .mamba2_780m import CONFIG as mamba2_780m
from .qwen1_5_110b import CONFIG as qwen1_5_110b
from .qwen1_5_32b import CONFIG as qwen1_5_32b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .qwen2_moe_a2_7b import CONFIG as qwen2_moe_a2_7b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        qwen1_5_110b,
        qwen1_5_32b,
        gemma3_4b,
        qwen2_0_5b,
        hubert_xlarge,
        grok_1_314b,
        qwen2_moe_a2_7b,
        internvl2_2b,
        hymba_1_5b,
        mamba2_780m,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names() -> list[str]:
    return list(ARCHS)


def skip_reason(arch: ArchConfig, shape_name: str) -> str | None:
    """Assignment skip rules (see DESIGN.md §6)."""
    shape = SHAPES[shape_name]
    if arch.encoder_only and shape.kind == "decode":
        return "encoder-only arch has no autoregressive decode"
    subquadratic = arch.family in ("ssm", "hybrid") or "local" in arch.attn_pattern
    if shape_name == "long_500k" and not subquadratic:
        return "pure full-attention arch; long_500k needs sub-quadratic attention"
    return None
