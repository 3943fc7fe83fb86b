"""Decoder LMs of the port (dense family in this slice)."""

from repro_torch.models.model import AnalogLM, apply, build

__all__ = ["AnalogLM", "apply", "build"]
