"""MusicGen-medium: decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284; hf]. EnCodec frontend stubbed (token ids in, per-codebook
embedding sum); 4 parallel LM heads. kv=24 == MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
    norm="layernorm", act="gelu", rope_theta=1e4,
    frontend="encodec", num_codebooks=4,
    source="arXiv:2306.05284; hf")
