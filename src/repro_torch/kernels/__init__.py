"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- analog_matmul: fused DAC-quant x MVM + per-column ADC quant
- int4_matmul:   packed-int4 digital deployment matmul

``dispatch`` is the layer ``analog_linear`` routes through when
``AnalogConfig.use_pallas`` is set; ``ref`` holds the plain versions;
``_build`` compiles ``csrc/*.cu`` with nvcc at first use. The paged
attention kernels and ``ssd_scan`` of the JAX package are not ported yet.
"""

from repro_torch.kernels import dispatch, ref

__all__ = ["dispatch", "ref"]
