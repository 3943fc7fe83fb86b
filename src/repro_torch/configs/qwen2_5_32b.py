"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=27648, vocab_size=152064,
    qkv_bias=True, norm="rmsnorm", act="silu", rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf")
