"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- analog_matmul: fused DAC-quant x MVM + per-column ADC quant
- int4_matmul:   packed-int4 digital deployment matmul
- paged_attention: paged flash-decode over the block-paged KV pool
- paged_prefill:   paged flash-prefill of a query chunk over the same pool

``dispatch`` is the layer ``analog_linear`` routes through when
``AnalogConfig.use_pallas`` is set; ``ref`` holds the plain versions;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use. ``ssd_scan`` of
the JAX package is not ported yet.
"""

from repro_torch.kernels import dispatch, ref

__all__ = ["dispatch", "ref"]
