"""Prefill + autoregressive decode on the contiguous KV cache (the static,
batched serving core).

PyTorch has no ``scan``: :func:`generate` is a Python loop, and every step
stays on the device (no host sync until the caller reads the tokens). The
cache is updated in place (see ``models.layers.attention``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.models import transformer as T
from repro_torch.models.model import apply as model_apply
from repro_torch.serve.sampling import sample_logits


def digital_int4_config(acfg: AnalogConfig) -> AnalogConfig:
    """Serving config of the Table-3 digital deployment: RTN 4-bit weights
    on the packed-int4 kernel, with input and output quantization in the
    digital periphery. Pair with ``core.analog.pack_int4_weights``."""
    return dataclasses.replace(acfg, mode="rtn", use_pallas=True,
                               int4_serve=True)


@torch.no_grad()
def prefill(params, cfg, acfg: AnalogConfig, tokens: torch.Tensor,
            max_len: int, cache_dtype=torch.float32):
    """Run the prompt [B, S] through the model, filling a fresh cache of
    ``max_len``. Returns ``(last_logits [B, V], caches, next_pos)``."""
    caches = T.init_caches(cfg, tokens.shape[0], max_len, cache_dtype,
                           tokens.device)
    logits, _, caches = model_apply(params, cfg, acfg, AnalogCtx(),
                                    {"tokens": tokens}, caches=caches)
    return logits[:, -1], caches, tokens.shape[1]


@torch.no_grad()
def serve_step(params, cfg, acfg: AnalogConfig, token: torch.Tensor,
               caches, pos, seq_mask: torch.Tensor | None = None):
    """One decode step: token [B, 1] → (logits [B, V], caches).

    ``pos`` is the RoPE position: a host int for the contiguous cache, or
    per row ([B, 1] on the device) for the continuous engine's slot
    caches, where row ``b`` decodes at ``written - left pads`` (the cache
    write index lives in the cache itself). ``seq_mask`` [B, 1] marks the
    rows whose slot holds a decoding request; the others leave the cache
    untouched. The caches are written in place.
    """
    logits, _, caches = model_apply(params, cfg, acfg, AnalogCtx(),
                                    {"tokens": token}, caches=caches,
                                    pos_offset=pos, seq_mask=seq_mask)
    return logits[:, 0], caches


@torch.no_grad()
def generate(params, cfg, acfg: AnalogConfig, generator: torch.Generator,
             prompt: torch.Tensor, num_new: int, *, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, greedy_first: int = 0,
             cache_dtype=torch.float32) -> torch.Tensor:
    """Batched ancestral sampling. Returns tokens [B, num_new].

    The first ``greedy_first`` tokens are argmax picks. As in the
    reference's ``scan``, every one of the ``num_new`` steps runs a decode
    forward, the last one included, so a call runs ``1 + num_new``
    forwards.
    """
    max_len = prompt.shape[1] + num_new
    logits, caches, pos = prefill(params, cfg, acfg, prompt, max_len,
                                  cache_dtype=cache_dtype)
    toks = []
    for i in range(num_new):
        if i < greedy_first:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = sample_logits(generator, logits, temperature=temperature,
                                top_k=top_k, top_p=top_p)
        logits, caches = serve_step(params, cfg, acfg, tok[:, None], caches,
                                    pos)
        pos += 1
        toks.append(tok)
    return torch.stack(toks, dim=1)
