"""Architecture + shape configuration schema.

Every assigned architecture gets one ``<arch>.py`` in this package exporting
``CONFIG``; :func:`repro_torch.configs.get_config` resolves by name. ``reduce()``
produces the family-preserving tiny config used by the CPU smoke tests; the
full configs are exercised only via the dry-run (ShapeDtypeStruct lowering).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture's static hyperparameters (see field comments)."""
    name: str
    family: str                       # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int                    # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # 0 → d_model // num_heads
    qkv_bias: bool = False
    #: fused single QKV projection (default; one analog tile) vs separate
    #: q/k/v sites — §Perf knob: the fused output's q|k|v split crosses
    #: 16-way shard tiles for non-divisible head counts and costs
    #: collective-permutes per layer (EXPERIMENTS.md §Perf iteration 8)
    fused_qkv: bool = True
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu (SwiGLU) | gelu (plain MLP)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- MoE -------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # --- hybrid (jamba) ----------------------------------------------------
    attn_every: int = 0               # one attention layer per k layers (jamba: 8)
    # --- SSM (mamba2 / jamba mamba layers) ---------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    # --- modality frontends (stubs per assignment) --------------------------
    frontend: Optional[str] = None    # None | "vit" | "encodec"
    num_codebooks: int = 0            # musicgen
    vit_tokens: int = 256             # internvl2 patch tokens per image
    vit_dim: int = 1024               # InternViT hidden size
    # --- source ------------------------------------------------------------
    source: str = ""

    @property
    def head_dim(self) -> int:
        """Attention head dim (explicit ``d_head`` or d_model/num_heads)."""
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table and
        LM head shard cleanly over a 16-way model axis (standard framework
        practice; logits are sliced back to ``vocab_size`` in the forward)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        """True for pure-SSM architectures (no attention heads)."""
        return self.num_heads == 0

    @property
    def ssm_heads(self) -> int:
        """Number of SSD heads (d_inner / ssm_headdim)."""
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        """Mamba inner width (ssm_expand * d_model)."""
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' mixer kind of layer ``i``."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == (self.attn_every // 2) \
                else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'dense' | 'moe' FFN kind of layer ``i``."""
        if self.family == "ssm":
            return "none"
        if self.num_experts and (i % self.moe_every) == (self.moe_every - 1):
            return "moe"
        return "dense"

    def reduce(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        pattern = max(self.attn_every, self.moe_every, 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, pattern),
            d_model=64,
            num_heads=0 if self.is_attention_free else 4,
            num_kv_heads=0 if self.is_attention_free else
            min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads
            else 4,
            d_head=16 if not self.is_attention_free else 0,
            d_ff=96 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32,
            vit_tokens=8,
            vit_dim=32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, batch, kind) workload cell of the dry-run grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        """True for single-token decode cells."""
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs for which long_500k runs (sub-quadratic sequence mixing); the 8 pure
#: full-attention archs skip it per the assignment (recorded in DESIGN.md §4).
LONG_CONTEXT_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether a shape cell runs for an arch (long ctx: SSM/hybrid only)."""
    if shape.name == "long_500k":
        return arch.name in LONG_CONTEXT_ARCHS
    return True
