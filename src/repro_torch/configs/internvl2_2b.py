"""InternVL2-2B: InternViT frontend (stub) + InternLM2-1.8B decoder
[arXiv:2404.16821; hf]. input_specs() supplies precomputed patch embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    frontend="vit", vit_tokens=256, vit_dim=1024,
    source="arXiv:2404.16821; hf")
