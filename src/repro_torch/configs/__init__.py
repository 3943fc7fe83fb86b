"""Architecture registry: one module per assigned arch (+ paper's own)."""

from repro_torch.configs.base import (LONG_CONTEXT_ARCHS, SHAPES, ArchConfig,
                                ShapeConfig, shape_applicable)

_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen1.5-32b": "qwen1_5_32b",
    "granite-3-8b": "granite_3_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-2b": "internvl2_2b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-130m": "mamba2_130m",
    # the paper's own subject models (architecture stand-ins at config level)
    "phi-3-mini-4k": "phi3_mini_4k",
    "llama-3.2-1b": "llama3_2_1b",
}

ARCH_NAMES = tuple(k for k in _MODULES if not k.startswith(("phi", "llama")))


def get_config(name: str) -> ArchConfig:
    """Resolve an architecture name to its ``ArchConfig``."""
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "LONG_CONTEXT_ARCHS",
           "ARCH_NAMES", "get_config", "shape_applicable"]
