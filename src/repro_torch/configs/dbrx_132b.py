"""DBRX-132B MoE 16e top-4 [hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=10752, vocab_size=100352,
    norm="layernorm", act="silu", rope_theta=5e5,
    num_experts=16, top_k=4,
    source="hf:databricks/dbrx-base; unverified")
