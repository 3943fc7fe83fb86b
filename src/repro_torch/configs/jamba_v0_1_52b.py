"""Jamba-v0.1-52B hybrid Mamba+attn 1:7, MoE 16e top-2 every other layer
[arXiv:2403.19887; hf]. No positional embeddings (rope_theta=0); the paper's
Mamba-1 layers are realized with the SSD (Mamba-2) formulation — see
DESIGN.md §2 hardware-adaptation notes."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    norm="rmsnorm", act="silu", rope_theta=0.0,
    num_experts=16, top_k=2, moe_every=2, attn_every=8,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_groups=1, conv_width=4,
    source="arXiv:2403.19887; hf")
