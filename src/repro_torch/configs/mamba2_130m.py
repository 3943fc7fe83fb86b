"""Mamba2-130M: pure SSM (SSD / state-space duality) [arXiv:2405.21060;
unverified]. Attention-free; tied embeddings (GPT-NeoX vocab)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    norm="rmsnorm", act="silu", tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1, conv_width=4,
    source="arXiv:2405.21060; unverified")
