"""Architecture/config schema for the assigned architecture pool.

Every architecture is a :class:`ArchConfig`; the four assigned input shapes
are :class:`ShapeConfig` entries.  ``reduced()`` produces the CPU-smoke
variant of an architecture (same family/topology, tiny dims).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "einsum"  # einsum (GShard one-hot) | sorted (gather/scatter)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    # attention layout: "global" everywhere, or e.g. "5local:1global"
    attn_pattern: str = "global"
    window: int = 1024
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder_only: bool = False
    frontend: str | None = None  # None | "patch" | "frames"
    frontend_len: int = 256  # patches prepended (vlm)
    frontend_dim: int = 512  # raw frame feature dim (audio)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_act: str = "swiglu"  # swiglu | gelu
    remat: str = "full"  # nothing | dots | full
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table and
        logits shard over the model axis; extra ids are masked to -inf in
        the head (odd vocabs like 50280 otherwise force replicated
        multi-GB logits buffers — see EXPERIMENTS.md §Dry-run)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> list[str]:
        """Per-layer attention kind from ``attn_pattern``."""
        if self.attention_free:
            return ["ssm"] * self.n_layers
        if self.attn_pattern == "global":
            return ["global"] * self.n_layers
        # "<n>local:<m>global" repeating pattern
        parts = self.attn_pattern.split(":")
        cycle: list[str] = []
        for p in parts:
            num = int("".join(ch for ch in p if ch.isdigit()))
            kind = "".join(ch for ch in p if ch.isalpha())
            cycle += [kind] * num
        return [cycle[i % len(cycle)] for i in range(self.n_layers)]

    def params_billions(self) -> float:
        """Rough dense-equivalent parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm":
            attn = 0
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        if self.moe:
            ff = (self.moe.n_experts + self.moe.n_shared) * n_mats * d * (
                self.moe.d_ff_expert or self.d_ff
            )
        elif self.d_ff:
            ff = n_mats * d * self.d_ff
        else:
            ff = 0
        ssm = 0
        if self.ssm:
            d_in = self.ssm.expand * d
            ssm = d * (2 * d_in) + d_in * d  # in/out projections (approx)
        return (emb + self.n_layers * (attn + ff + ssm)) / 1e9

    def active_params_billions(self) -> float:
        """Active (per-token) params — MoE counts only routed top-k."""
        if not self.moe:
            return self.params_billions()
        d = self.d_model
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        full_ff = self.moe.n_experts * n_mats * d * (self.moe.d_ff_expert or self.d_ff)
        act_ff = (self.moe.top_k + self.moe.n_shared) * n_mats * d * (
            self.moe.d_ff_expert or self.d_ff
        )
        return self.params_billions() - self.n_layers * (full_ff - act_ff) / 1e9

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.head_dim else 0,
            window=8,
            frontend_len=4,
            frontend_dim=12,
            remat="nothing",
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=32,
            )
        if self.ssm:
            kw["ssm"] = replace(
                self.ssm, d_state=16, head_dim=16, chunk=8
            )
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return ShapeConfig(f"smoke_{kind}", 32, 2, kind)
