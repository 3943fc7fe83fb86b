"""PyTorch / CUDA port of the analog foundation models system for NVIDIA
Hopper (H100). The JAX package ``repro`` is its reference; this package
imports neither JAX nor ``repro``."""
