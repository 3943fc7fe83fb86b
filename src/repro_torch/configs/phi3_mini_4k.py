"""Phi-3-mini-4k-instruct — the paper's primary subject model
[arXiv:2404.14219]. 3.8B dense; MHA (32/32); used by the paper-validation
benchmarks at reduced scale."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-mini-4k", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
    norm="rmsnorm", act="silu", rope_theta=1e4,
    source="arXiv:2404.14219; hf")
