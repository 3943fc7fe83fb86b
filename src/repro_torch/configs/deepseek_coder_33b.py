"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]. Llama architecture."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense", num_layers=62, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=19200, vocab_size=32256,
    norm="rmsnorm", act="silu", rope_theta=1e5,
    source="arXiv:2401.14196; hf")
