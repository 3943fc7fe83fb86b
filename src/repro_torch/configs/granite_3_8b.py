"""Granite-3.0-8B [hf:ibm-granite/granite-3.0-2b-base family; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=12800, vocab_size=49155,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    source="hf:ibm-granite/granite-3.0-2b-base; hf")
