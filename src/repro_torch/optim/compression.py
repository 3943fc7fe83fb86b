"""Int8 gradient compression with error feedback.

:func:`compress_grads` quantizes each gradient leaf to int8 with a
per-tensor scale, adding back what the previous step's quantization lost;
the optimizer consumes the dequantized values, bit for bit what a receiver
would rebuild from the int8 wire format. The reference's explicit
compressed all-reduce (``psum_compressed``) waits for sharded training
state, the training half of ROADMAP section 1, item 10.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint import flatten_paths, unflatten_paths
from repro_torch.kernels.ref import div


def init_error_state(params: dict) -> dict:
    """Zero error-feedback accumulators shaped like ``params`` (fp32)."""
    return unflatten_paths({k: torch.zeros(v.shape, dtype=torch.float32,
                                           device=v.device)
                            for k, v in flatten_paths(params).items()})


def _quantize_leaf(g: torch.Tensor):
    """int8-quantize one gradient leaf. Returns ``(q, scale)``."""
    scale = div(torch.clamp_min(torch.amax(torch.abs(g)), 1e-12), 127.0)
    q = torch.clamp(torch.round(torch.div(g, scale)), -127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def compress_grads(grads: dict, err_state: dict):
    """Quantize ``grads`` to int8 with error feedback. Returns
    ``(dequantized_grads, new_err_state)``."""
    flat_e = flatten_paths(err_state)
    out_g, out_e = {}, {}
    for path, g in flatten_paths(grads).items():
        g32 = g.float() + flat_e[path]
        q, scale = _quantize_leaf(g32)
        deq = q.float() * scale
        out_g[path], out_e[path] = deq.to(g.dtype), g32 - deq
    return unflatten_paths(out_g), unflatten_paths(out_e)
