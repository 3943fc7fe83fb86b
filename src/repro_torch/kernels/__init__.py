"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- analog_matmul: fused DAC-quant x MVM + per-column ADC quant
- int4_matmul:   packed-int4 digital deployment matmul
- paged_attention: paged flash-decode over the block-paged KV pool
- paged_prefill:   paged flash-prefill of a query chunk over the same pool
- ssd_scan:        chunked Mamba-2 SSD scan with incoming and final state

``dispatch`` is the layer ``analog_linear`` routes through when
``AnalogConfig.use_pallas`` is set; ``ref`` holds the plain versions;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use. Every Pallas
kernel of the JAX package has its counterpart here.
"""

from repro_torch.kernels import dispatch, ref

__all__ = ["dispatch", "ref"]
