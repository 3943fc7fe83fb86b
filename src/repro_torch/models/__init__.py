"""Decoder LMs of the port: every family of the JAX package."""

from repro_torch.models.model import AnalogLM, apply, build, input_specs

__all__ = ["AnalogLM", "apply", "build", "input_specs"]
