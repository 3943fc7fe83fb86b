"""Int8 gradient compression with error feedback.

:func:`compress_grads` quantizes each gradient leaf to int8 with a
per-tensor scale, adding back what the previous step's quantization lost;
the optimizer consumes the dequantized values, bit for bit what a receiver
would rebuild from the int8 wire format. A sharded step compresses the
summed gradient slice by slice (:func:`compress_slices`): each leaf's
scale is the max over its slices, which is the whole leaf's, so the
result is :func:`compress_grads`' bit for bit. :func:`psum_compressed` is
the reference's explicit compressed all-reduce over the data axis, here
over a list of one leaf's per-shard tensors.
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


def _scale(g: torch.Tensor) -> torch.Tensor:
    """A tensor's int8 scale: ``max |g| / 127`` (``max |g|`` at least
    1e-12)."""
    return div(torch.clamp_min(torch.amax(torch.abs(g)), 1e-12), 127.0)


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g / scale`` rounded half to even and clamped to ±127."""
    return torch.clamp(torch.round(torch.div(g, scale)), -127, 127)


@torch.no_grad()
def compress_grads(grads: dict, err_state: dict):
    """Quantize ``grads`` to int8 with error feedback. Returns
    ``(dequantized_grads, new_err_state)``: each leaf is
    :func:`compress_slices` of its one slice."""
    flat_e = flatten_paths(err_state)
    out_g, out_e = {}, {}
    for path, g in flatten_paths(grads).items():
        (out_g[path],), (out_e[path],) = compress_slices([g], [flat_e[path]])
    return unflatten_paths(out_g), unflatten_paths(out_e)


@torch.no_grad()
def compress_slices(gs: list, es: list):
    """:func:`compress_grads` of one leaf given as slices ``gs`` with
    their error-feedback slices ``es``: the scale is the max over the
    slices' scales of ``g + e``, which is the whole leaf's (the scale
    grows with the max), so every slice quantizes as the whole leaf
    would. Returns ``(dequantized slices, new error slices)``."""
    g32 = [g.float() + e for g, e in zip(gs, es)]
    home = g32[0].device
    scale = torch.amax(torch.stack([_scale(x).to(home) for x in g32]))
    out_g, out_e = [], []
    for g, x in zip(gs, g32):
        s = scale.to(x.device)
        deq = _quantize(x, s).to(torch.int8).float() * s
        out_g.append(deq.to(g.dtype))
        out_e.append(x - deq)
    return out_g, out_e


@torch.no_grad()
def psum_compressed(shards: list) -> torch.Tensor:
    """The reference's compressed all-reduce of one leaf over the data
    axis, given its per-shard tensors: each shard's int8 scale, their max
    (``pmax``), each shard quantized with it (half to even, clamped to
    ±127), the int32 sum in shard order (``psum``), times the scale, in
    fp32 on shard 0's device."""
    home = shards[0].device
    scale = torch.amax(torch.stack([_scale(g.float()).to(home)
                                    for g in shards]))
    total = None
    for g in shards:
        q = _quantize(g.float(), scale.to(g.device)).to(torch.int32).to(home)
        total = q if total is None else total + q
    return total.float() * scale
