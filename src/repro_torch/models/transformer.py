"""Model assembly, dense family: a pre-norm decoder LM.

Parameters keep the reference's layout: the layer stack is scan-stacked,
every leaf of ``params["blocks"]`` carries a leading ``[L]`` axis, and the
embedding and LM head are ``padded_vocab`` wide. PyTorch has no ``scan``,
so :func:`apply_blocks` is a loop over ``l`` that indexes each leaf (a view,
no copy). The moe / ssm / hybrid / vlm / audio families come with a later
slice and are refused here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     init_linear, linear_labels)
from repro_torch.models import layers as L

_PORTED_FAMILIES = ("dense",)


def _require_dense(cfg) -> None:
    """Raise for a family this slice does not port."""
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (this port runs the "
            "dense family; moe, ssm, hybrid, vlm and audio come later)")


def tree_index(tree, i: int):
    """Slice index ``i`` off the leading axis of every tensor leaf."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_stack(trees: list):
    """Stack a list of identically structured trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def init_attn_layer(gen: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> dict:
    """Init one pre-norm attention block (ln1/attn/ln2/ffn)."""
    return {"ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "ffn": L.init_mlp(gen, cfg, dtype, device)}


def attn_layer_labels(p: dict) -> dict:
    """Labels mirroring ``init_attn_layer`` structure."""
    return {"ln1": L.norm_labels(p["ln1"]),
            "attn": L.attention_labels(p["attn"]),
            "ln2": L.norm_labels(p["ln2"]),
            "ffn": L.mlp_labels(p["ffn"])}


def apply_attn_layer(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
                     ctx: AnalogCtx, positions: torch.Tensor, cache=None,
                     seq_mask: torch.Tensor | None = None):
    """One attention block with residuals. Returns (x, stats, cache).
    ``seq_mask`` [B, S] goes to the slot cache layouts (see
    ``layers.attention``)."""
    h, st_a, new_cache = L.attention(
        p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg, acfg, ctx,
        positions, cache, seq_mask)
    x = x + h
    h, st_f = L.mlp(p["ffn"], L.apply_norm(p["ln2"], x, cfg.norm), cfg, acfg,
                    ctx)
    return x + h, {"attn": st_a, "ffn": st_f}, new_cache


# ---------------------------------------------------------------------------
# the layer stack
# ---------------------------------------------------------------------------

def init_blocks(gen: torch.Generator, cfg, dtype=torch.float32,
                device=None) -> dict:
    """Init the layer stack: every leaf stacked to ``[L, ...]``."""
    _require_dense(cfg)
    return tree_stack([init_attn_layer(gen, cfg, dtype, device)
                       for _ in range(cfg.num_layers)])


def blocks_labels(params_blocks: dict, cfg) -> dict:
    """Labels of the stacked blocks (one label set, shared by all layers)."""
    _require_dense(cfg)
    return attn_layer_labels(params_blocks)


def apply_blocks(params_blocks: dict, x: torch.Tensor, cfg,
                 acfg: AnalogConfig, ctx: AnalogCtx, positions: torch.Tensor,
                 caches: dict | None = None,
                 seq_mask: torch.Tensor | None = None):
    """Run the layer stack. Returns ``(x, stats, new_caches)``.

    ``caches`` is :func:`init_caches`' stacked tree, every tensor leaf
    ``[L, ...]``. Each layer writes its slice of the buffers and pools in
    place. The contiguous layout shares one host-int ``pos``; the slot
    layouts carry per-layer cursors ``pos`` [L, B], which come back
    advanced (rows fully masked by ``seq_mask`` [B, S] keep theirs).
    """
    _require_dense(cfg)
    n_layers = next(iter(params_blocks["ln1"].values())).shape[0]
    slots = caches is not None and "start" in caches
    stats, new_pos = [], []
    for i in range(n_layers):
        p_l = tree_index(params_blocks, i)
        cache_l = None
        if caches is not None:
            cache_l = {k: (v if k == "pos" and not slots else v[i])
                       for k, v in caches.items()}
        x, st, nc = apply_attn_layer(p_l, x, cfg, acfg, ctx, positions,
                                     cache_l, seq_mask)
        stats.append(st)
        if slots:
            new_pos.append(nc["pos"])
    new_caches = None
    if caches is not None:
        new_caches = dict(caches)
        new_caches["pos"] = (torch.stack(new_pos) if slots
                             else caches["pos"] + x.shape[1])
    return x, tree_stack(stats), new_caches


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg, dtype=torch.float32, device=None):
    """Returns ``(params, labels)`` with random weights from ``gen``."""
    _require_dense(cfg)
    emb_scale = cfg.d_model ** -0.5
    params: dict[str, Any] = {}
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                      device=device, dtype=torch.float32) * emb_scale
    params["embed"] = {"tokens": emb.to(dtype)}
    params["blocks"] = init_blocks(gen, cfg, dtype, device)
    params["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                        use_bias=False, dtype=dtype,
                                        device=device)
    return params, model_labels(params, cfg)


def model_labels(params: dict, cfg) -> dict:
    """The label tree of a parameter tree (the reference's ``labels`` of
    ``init_model``), e.g. for weights carried across from a checkpoint."""
    labels: dict[str, Any] = {
        "embed": {"tokens": "digital"},
        "blocks": blocks_labels(params["blocks"], cfg),
        "final_norm": L.norm_labels(params["final_norm"])}
    if "lm_head" in params:
        labels["lm_head"] = linear_labels(params["lm_head"])
    return labels


def embed_inputs(params: dict, cfg, inputs: dict):
    """→ (x [B, S, d], positions [B, S]) for token inputs."""
    _require_dense(cfg)
    tokens = inputs["tokens"]
    x = params["embed"]["tokens"][tokens]
    bsz, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(bsz, s)
    return x, positions


def apply_lm_head(params: dict, cfg, acfg: AnalogConfig, ctx: AnalogCtx,
                  x: torch.Tensor):
    """Project hidden states to vocab-sliced fp32 logits. Returns
    ``(logits, stats)``."""
    stats = {}
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["tokens"].T.to(x.dtype))
    else:
        logits, st = analog_linear(params["lm_head"], x, acfg, ctx)
        stats["lm_head"] = st
    return logits[..., :cfg.vocab_size].float(), stats


def forward(params: dict, cfg, acfg: AnalogConfig, ctx: AnalogCtx,
            inputs: dict, caches: dict | None = None,
            pos_offset: Optional[int | torch.Tensor] = None,
            last_only: bool = False,
            seq_mask: torch.Tensor | None = None):
    """Full forward. Returns ``(logits, stats, new_caches)``.

    For decode pass single-token inputs with ``caches`` and ``pos_offset``,
    the RoPE position of the token: a host int for the contiguous cache,
    or per row ([B, 1] on the device) for the continuous engine's slot
    caches, where rows decode at their own positions. ``seq_mask`` [B, S]
    marks real tokens (see :func:`apply_blocks`). ``last_only`` applies the
    LM head to the final position only.
    """
    x, positions = embed_inputs(params, cfg, inputs)
    if pos_offset is not None:
        positions = positions + pos_offset
    x, st_blocks, new_caches = apply_blocks(params["blocks"], x, cfg, acfg,
                                            ctx, positions, caches, seq_mask)
    stats: dict[str, Any] = {"blocks": st_blocks}
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    logits, st = apply_lm_head(params, cfg, acfg, ctx, x)
    stats.update(st)
    return logits, stats, new_caches


def init_caches(cfg, batch: int, max_len: int, dtype=torch.float32,
                device=None, *, per_slot: bool = False, paged: bool = False,
                kv_block_size: int = 16, kv_blocks: int | None = None,
                kv_bits: int = 0) -> dict:
    """Stacked KV caches for :func:`apply_blocks`, every tensor leaf of
    ``layers.init_cache`` with a leading ``[L]`` axis: the contiguous
    ``{"k", "v": [L, B, T, KV, hd], "pos": 0}`` by default, the per-slot
    or paged layout of the continuous engine with ``per_slot`` /
    ``paged`` (every layer shares one logical→physical block mapping, so
    one host-side allocation covers the stack)."""
    _require_dense(cfg)
    one = L.init_cache(cfg, batch, max_len, dtype, device="meta",
                       per_slot=per_slot, paged=paged,
                       kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                       kv_bits=kv_bits)
    out = {}
    for name, leaf in one.items():
        if isinstance(leaf, int):
            out[name] = leaf
        else:
            out[name] = torch.zeros((cfg.num_layers,) + tuple(leaf.shape),
                                    dtype=leaf.dtype, device=device)
    return out


def cache_slot_spec(cfg, paged: bool = False, kv_bits: int = 0):
    """``(axes, kinds)`` of the slot cache tree of :func:`init_caches`.

    ``axes`` gives the slot (request) axis of each leaf, ``-1`` for
    pool-wide leaves with no slot axis (the paged pools, passed through
    whole). ``kinds`` labels each leaf: ``"start"`` (set to the left-pad
    count at admission), ``"pos"`` (the write cursor), ``"state"``
    (zeroed at admission), ``"table"`` / ``"wtable"`` (the slot's read /
    write block-table rows) or ``"pool"`` (shared physical storage,
    untouched at admission). The engine gathers and scatters one slot's
    rows with these, without knowing the layout.
    """
    _require_dense(cfg)
    if paged:
        axes = {"kp": -1, "vp": -1, "tbl": 1, "wtbl": 1, "pos": 1,
                "start": 1}
        kinds = {"kp": "pool", "vp": "pool", "tbl": "table",
                 "wtbl": "wtable", "pos": "pos", "start": "start"}
        if kv_bits == 8:
            axes.update(ks=-1, vs=-1)
            kinds.update(ks="pool", vs="pool")
        return axes, kinds
    return ({"k": 1, "v": 1, "pos": 1, "start": 1},
            {"k": "state", "v": "state", "pos": "pos", "start": "start"})
