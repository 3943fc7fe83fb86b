"""Llama-3.2-1B-Instruct — the paper's second subject model
[arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    norm="rmsnorm", act="silu", rope_theta=5e5,
    source="arXiv:2407.21783; hf")
