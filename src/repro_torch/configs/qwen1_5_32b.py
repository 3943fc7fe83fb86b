"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family; hf]. GQA kv=40 == MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=40, d_ff=27392, vocab_size=152064,
    qkv_bias=True, norm="rmsnorm", act="silu", rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B; hf")
