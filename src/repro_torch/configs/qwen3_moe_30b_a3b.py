"""Qwen3-30B-A3B MoE 128e top-8 fine-grained [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, d_ff=768, vocab_size=151936,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    num_experts=128, top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B; hf")
