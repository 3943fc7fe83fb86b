"""Model assembly, all six families: a pre-norm decoder LM.

Parameters keep the reference's layout: the layer stack is scan-stacked,
every leaf of ``params["blocks"]`` carries a leading ``[L]`` axis, and the
embedding and LM head are ``padded_vocab`` wide. PyTorch has no ``scan``,
so :func:`apply_blocks` is a loop over ``l`` over views of each leaf
(``unbind``: no copy, and in training one stacked gradient per leaf). With
``remat`` each layer runs under ``torch.utils.checkpoint`` (non-reentrant)
and is recomputed in the backward; its training noise is keyed by (key,
layer, site), so the recomputed layer draws the noise its forward drew.
``remat`` True (or ``"dots"``) keeps the outputs of the unbatched matmuls
(``mm``, ``addmm``: the projections) and recomputes the rest, the
reference's ``dots_with_no_batch_dims_saveable`` policy; ``"nothing"``
recomputes everything.

The families' layers:

* dense, vlm and audio: attention + MLP; vlm prepends the ``projector``
  site's image of ``patch_embeds``, audio sums one embedding per codebook
  and its head predicts every codebook (``[..., K, V]`` logits);
* moe (qwen3-moe-30b-a3b, dbrx-132b): attention + a routed MoE FFN
  (``models/moe.py``);
* ssm (mamba2-130m): one Mamba-2 mixer with no FFN;
* hybrid (jamba-v0.1-52b): super-blocks of ``attn_every`` layers, the
  reference's nested layout ``{"attn", "mamba" [attn_every - 1],
  "dense_ffn" [half - 1], "moe_ffn" [half]}`` stacked ``[n_sb]``: one
  attention layer at ``attn_every // 2``, a Mamba-2 mixer elsewhere, each
  mixer followed by its own FFN, MoE at odd positions. Its noise context
  folds the super-block index, then the layer's position in it.

All six families train. The vlm's ``projector`` site runs its training
forward (noise, the STE rules, its input statistics) like every other
site, and the audio family's codebook embeddings and ``[K · V]`` head
train as one table and one site.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import functools

import torch
import torch.utils.checkpoint

from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     init_linear, linear_labels,
                                     scaled_randn)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg) -> None:
    """Raise for a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def tree_index(tree, i: int):
    """Slice index ``i`` off the leading axis of every tensor leaf."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_unbind(tree, n: int) -> list:
    """The ``n`` trees of a stacked tree's leading axis, as views
    (``unbind``, whose backward stacks the per-layer gradients once; a
    tensor-parallel ``Shards`` leaf unbinds every shard)."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def tree_stack(trees: list):
    """Stack a list of identically structured trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _first_leaf(tree):
    """The first tensor leaf of a nested tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _fill(slot, got) -> None:
    """Copy the leaves of ``got`` into ``slot`` but those an init function
    already wrote in place."""
    if isinstance(slot, dict):
        for k in slot:
            _fill(slot[k], got[k])
    elif got.data_ptr() != slot.data_ptr():
        slot.copy_(got)


def stacked_init(n: int, init_one: Callable, gen, device,
                 out: dict | None = None) -> dict:
    """``n`` layers of ``init_one(gen, out, device)`` stacked on a new
    leading axis, drawn in layer order into ``out`` (allocated here when
    None). The stack is allocated once, its shapes from a pass of
    ``init_one`` on the meta device (which draws nothing), and each layer
    is drawn into its slice: ``init_one`` writes its large random leaves
    into the slice it is given and the small ones are copied in, so the
    peak is the stack plus one layer's small leaves, never two copies of
    a leaf."""
    if out is None:
        shapes = init_one(None, None, torch.device("meta"))
        out = _tree_empty(shapes, n, device)
    for i in range(n):
        slot = tree_index(out, i)
        _fill(slot, init_one(gen, slot, device))
    return out


def _tree_empty(shapes, n: int, device):
    """Uninitialised ``[n, ...]`` leaves of ``shapes``' shapes and
    dtypes."""
    if isinstance(shapes, dict):
        return {k: _tree_empty(v, n, device) for k, v in shapes.items()}
    return torch.empty((n,) + tuple(shapes.shape), dtype=shapes.dtype,
                       device=device)


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _ffn_kind(cfg) -> str:
    """The FFN of the family's attention blocks: ``"moe"`` or ``"dense"``
    (hybrid attention layers have a dense one)."""
    return "moe" if cfg.family == "moe" else "dense"


def _init_ffn(gen: torch.Generator, cfg, kind: str, dtype=torch.float32,
              device=None, out: dict | None = None) -> dict:
    """Init the FFN of one block: dense MLP or MoE by ``kind``."""
    if kind == "moe":
        return MoE.init_moe(gen, cfg, dtype, device, out=out)
    return L.init_mlp(gen, cfg, dtype, device, out=out)


def _ffn_labels(p: dict, kind: str) -> dict:
    """Labels for one block FFN, dispatching on ``kind``."""
    return MoE.moe_labels(p) if kind == "moe" else L.mlp_labels(p)


def _apply_ffn(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
               ctx: AnalogCtx, kind: str):
    """Apply one block FFN (dense or MoE). Returns (y, stats)."""
    if kind == "moe":
        return MoE.moe(p, x, cfg, acfg, ctx)
    return L.mlp(p, x, cfg, acfg, ctx)


def init_attn_layer(gen: torch.Generator, cfg, dtype=torch.float32,
                    device=None, ffn_kind: str = "dense",
                    out: dict | None = None) -> dict:
    """Init one pre-norm attention block (ln1/attn/ln2/ffn)."""
    return {"ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "attn": L.init_attention(gen, cfg, dtype, device,
                                     out=L.sub(out, "attn")),
            "ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "ffn": _init_ffn(gen, cfg, ffn_kind, dtype, device,
                             out=L.sub(out, "ffn"))}


def attn_layer_labels(p: dict, ffn_kind: str = "dense") -> dict:
    """Labels mirroring ``init_attn_layer`` structure."""
    return {"ln1": L.norm_labels(p["ln1"]),
            "attn": L.attention_labels(p["attn"]),
            "ln2": L.norm_labels(p["ln2"]),
            "ffn": _ffn_labels(p["ffn"], ffn_kind)}


def apply_attn_layer(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
                     ctx: AnalogCtx, positions: torch.Tensor, cache=None,
                     seq_mask: torch.Tensor | None = None,
                     ffn_kind: str = "dense"):
    """One attention block with residuals. Returns (x, stats, cache).
    ``seq_mask`` [B, S] goes to the slot cache layouts (see
    ``layers.attention``); a MoE FFN routes every column of x, masked ones
    too, as the reference does."""
    h, st_a, new_cache = L.attention(
        p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg, acfg, ctx,
        positions, cache, seq_mask)
    x = x + h
    h, st_f = _apply_ffn(p["ffn"], L.apply_norm(p["ln2"], x, cfg.norm), cfg,
                         acfg, ctx, ffn_kind)
    return x + h, {"attn": st_a, "ffn": st_f}, new_cache


def init_mamba_layer(gen: torch.Generator, cfg, dtype=torch.float32,
                     device=None, out: dict | None = None) -> dict:
    """Init one mamba block: ln1 and the Mamba-2 mixer (no FFN; a hybrid
    super-block keeps its mixers' FFNs apart)."""
    return {"ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "mixer": M.init_mamba(gen, cfg, dtype, device,
                                  out=L.sub(out, "mixer"))}


def mamba_layer_labels(p: dict) -> dict:
    """Labels mirroring ``init_mamba_layer`` structure."""
    return {"ln1": L.norm_labels(p["ln1"]),
            "mixer": M.mamba_labels(p["mixer"])}


def apply_mamba_layer(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
                      ctx: AnalogCtx, cache=None,
                      seq_mask: torch.Tensor | None = None):
    """One mamba block with its residual. Returns (x, stats, cache)."""
    h, st_m, new_cache = M.mamba(
        p["mixer"], L.apply_norm(p["ln1"], x, cfg.norm), cfg, acfg, ctx,
        cache, seq_mask=seq_mask)
    return x + h, {"mixer": st_m}, new_cache


# ---------------------------------------------------------------------------
# the layer stack
# ---------------------------------------------------------------------------

def _init_ffn_block(gen, cfg, kind: str, dtype, device,
                    out: dict | None = None) -> dict:
    """A hybrid mixer's FFN: ``{"ln2", "ffn"}``."""
    return {"ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, device),
            "ffn": _init_ffn(gen, cfg, kind, dtype, device,
                             out=L.sub(out, "ffn"))}


def _init_super_block(gen, cfg, dtype, device, out: dict | None = None
                      ) -> dict:
    """One jamba super-block in the reference's nested layout: its
    attention layer (dense FFN), ``attn_every - 1`` mixers, ``half - 1``
    dense and ``half`` MoE FFNs, each group stacked."""
    half = cfg.attn_every // 2

    def ffns(kind):
        return lambda g, o, d: _init_ffn_block(g, cfg, kind, dtype, d, o)

    return {
        "attn": init_attn_layer(gen, cfg, dtype, device, "dense",
                                out=L.sub(out, "attn")),
        "mamba": stacked_init(
            cfg.attn_every - 1,
            lambda g, o, d: init_mamba_layer(g, cfg, dtype, d, out=o),
            gen, device, out=L.sub(out, "mamba")),
        "dense_ffn": stacked_init(half - 1, ffns("dense"), gen, device,
                                  out=L.sub(out, "dense_ffn")),
        "moe_ffn": stacked_init(half, ffns("moe"), gen, device,
                                out=L.sub(out, "moe_ffn"))}


def init_blocks(gen: torch.Generator, cfg, dtype=torch.float32,
                device=None) -> dict:
    """Init the layer stack, every leaf stacked to ``[L, ...]`` (hybrid:
    ``[n_sb, ...]`` super-blocks, each with its own stacked groups), drawn
    layer by layer into the stack (:func:`stacked_init`)."""
    _check_family(cfg)
    if cfg.family == "hybrid":
        return stacked_init(
            cfg.num_layers // cfg.attn_every,
            lambda g, o, d: _init_super_block(g, cfg, dtype, d, o),
            gen, device)
    if cfg.family == "ssm":
        def one(g, o, d):
            return init_mamba_layer(g, cfg, dtype, d, out=o)
    else:
        def one(g, o, d):
            return init_attn_layer(g, cfg, dtype, d, _ffn_kind(cfg), out=o)
    return stacked_init(cfg.num_layers, one, gen, device)


def blocks_labels(params_blocks: dict, cfg) -> dict:
    """Labels of the stacked blocks (one label set, shared by all layers)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return mamba_layer_labels(params_blocks)
    if cfg.family == "hybrid":
        p = params_blocks
        return {"attn": attn_layer_labels(p["attn"], "dense"),
                "mamba": mamba_layer_labels(p["mamba"]),
                "dense_ffn": {"ln2": L.norm_labels(p["dense_ffn"]["ln2"]),
                              "ffn": _ffn_labels(p["dense_ffn"]["ffn"],
                                                 "dense")},
                "moe_ffn": {"ln2": L.norm_labels(p["moe_ffn"]["ln2"]),
                            "ffn": _ffn_labels(p["moe_ffn"]["ffn"], "moe")}}
    return attn_layer_labels(params_blocks, _ffn_kind(cfg))


def _copy_state(dst: dict, src: dict) -> None:
    """Write a mixer's new ``conv`` / ``ssm`` state into its cache slice."""
    for name in ("conv", "ssm"):
        dst[name].copy_(src[name])


def _hybrid_sb_apply(p_sb: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
                     ctx: AnalogCtx, positions: torch.Tensor,
                     cache_sb: dict | None = None,
                     seq_mask: torch.Tensor | None = None):
    """One jamba super-block: layers ``0 .. attn_every - 1``, attention at
    ``attn_every // 2``, a mixer and its FFN elsewhere (MoE at odd ``j``,
    dense at even), as the reference's ``_hybrid_sb_apply``. Layer ``j``
    gets ``ctx`` with ``j`` folded in. Each mixer's new state is written
    into its slice of ``cache_sb["mamba"]``. Returns ``(x, stats,
    attention cache)``; the stats mirror the super-block's params (attn /
    mamba / dense_ffn / moe_ffn, the groups stacked)."""
    half = cfg.attn_every // 2
    new_attn = None
    st_attn, st_mamba, st_dense, st_moe = None, [], [], []
    m_idx = 0
    for j in range(cfg.attn_every):
        ctx_j = ctx.fold(j)
        if j == half:
            c = None if cache_sb is None else cache_sb["attn"]
            x, st_attn, new_attn = apply_attn_layer(
                p_sb["attn"], x, cfg, acfg, ctx_j, positions, c, seq_mask,
                "dense")
            continue
        c = (None if cache_sb is None
             else tree_index(cache_sb["mamba"], m_idx))
        x, st_m, nc = apply_mamba_layer(tree_index(p_sb["mamba"], m_idx), x,
                                        cfg, acfg, ctx_j, c, seq_mask)
        if nc is not None:
            _copy_state(c, nc)
        st_mamba.append(st_m)
        m_idx += 1
        kind = "moe" if j % 2 == 1 else "dense"
        if kind == "moe":
            fp = tree_index(p_sb["moe_ffn"], j // 2)
        else:
            fp = tree_index(p_sb["dense_ffn"], j // 2 - (1 if j > half
                                                          else 0))
        h, st_f = _apply_ffn(fp["ffn"], L.apply_norm(fp["ln2"], x, cfg.norm),
                             cfg, acfg, ctx_j, kind)
        x = x + h
        (st_moe if kind == "moe" else st_dense).append({"ffn": st_f})
    stats = {"attn": st_attn, "mamba": tree_stack(st_mamba),
             "dense_ffn": tree_stack(st_dense),
             "moe_ffn": tree_stack(st_moe)}
    return x, stats, new_attn


def _layer_cache(caches: dict | None, i: int, slots: bool):
    """Layer (or super-block) ``i``'s view of the stacked caches; the
    contiguous layout's host-int ``pos`` is shared by all layers."""
    if caches is None:
        return None
    return {k: (_layer_cache(v, i, slots) if isinstance(v, dict)
                else v if k == "pos" and not slots else v[i])
            for k, v in caches.items()}


#: the unbatched matmuls whose outputs ``remat=True`` keeps (the
#: reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
#: a projection's product is a dot with no batch dimension, attention's and
#: the experts' are batched)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat=True``: keep the unbatched
    matmuls' outputs, recompute every other op."""
    if op in _SAVED_DOTS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint(fn, *args, remat: bool | str = True):
    """``fn(*args)`` under ``torch.utils.checkpoint`` with the policy of
    ``remat`` (True / ``"dots"``: :func:`_save_dots`; ``"nothing"``: a full
    recompute). No default generator draws inside (the noise has its own
    key), so no RNG state is stashed."""
    kw = {}
    if remat != "nothing":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def apply_blocks(params_blocks: dict, x: torch.Tensor, cfg,
                 acfg: AnalogConfig, ctx: AnalogCtx, positions: torch.Tensor,
                 caches: dict | None = None,
                 seq_mask: torch.Tensor | None = None,
                 remat: bool | str = False):
    """Run the layer stack. Returns ``(x, stats, new_caches)``.

    Layer ``i`` gets ``ctx`` with ``i`` folded into its noise key (the
    reference's ``fold_in(ctx.key, idx)``; hybrid: super-block ``i``, then
    the layer's position in it). ``remat`` (training, no caches)
    checkpoints each layer (hybrid: each super-block, as the reference's
    scan body): its activations are recomputed in the backward instead of
    kept, but for the projections' products under True / ``"dots"``
    (:func:`checkpoint`).

    ``caches`` is :func:`init_caches`' stacked tree, every tensor leaf
    ``[L, ...]`` (hybrid: the nested ``{"attn", "mamba"}`` tree, ``[n_sb,
    ...]`` and ``[n_sb, attn_every - 1, ...]``). Each layer writes its
    slice of the buffers, pools and states in place. The contiguous layout
    shares one host-int ``pos``; the slot layouts carry per-layer cursors
    ``pos`` [L, B], which come back advanced (rows fully masked by
    ``seq_mask`` [B, S] keep theirs). A mamba layer's ``conv`` / ``ssm``
    state has no cursor: each layer's new state is copied into its slice.
    """
    _check_family(cfg)
    fam = cfg.family
    ffn_kind = _ffn_kind(cfg)
    n_layers = _first_leaf(params_blocks).shape[0]
    attn = caches["attn"] if fam == "hybrid" and caches else caches
    slots = attn is not None and "start" in attn
    if remat and caches is not None:
        raise ValueError("remat is for training; a forward with caches "
                         "keeps nothing for a backward")
    layers = tree_unbind(params_blocks, n_layers)
    stats, new_pos = [], []
    for i in range(n_layers):
        p_l, ctx_l = layers[i], ctx.fold(i)
        cache_l = _layer_cache(caches, i, slots)
        if remat:
            def layer(p_l, x, ctx_l=ctx_l):
                if fam == "hybrid":
                    return _hybrid_sb_apply(p_l, x, cfg, acfg, ctx_l,
                                            positions)[:2]
                if fam == "ssm":
                    return apply_mamba_layer(p_l, x, cfg, acfg, ctx_l)[:2]
                return apply_attn_layer(p_l, x, cfg, acfg, ctx_l,
                                        positions, ffn_kind=ffn_kind)[:2]

            x, st = checkpoint(layer, p_l, x, remat=remat)
        elif fam == "hybrid":
            x, st, nc = _hybrid_sb_apply(p_l, x, cfg, acfg, ctx_l, positions,
                                         cache_l, seq_mask)
        elif fam == "ssm":
            x, st, nc = apply_mamba_layer(p_l, x, cfg, acfg, ctx_l, cache_l,
                                          seq_mask)
            if nc is not None:
                _copy_state(cache_l, nc)
        else:
            x, st, nc = apply_attn_layer(p_l, x, cfg, acfg, ctx_l, positions,
                                         cache_l, seq_mask, ffn_kind)
        if slots and fam != "ssm":
            new_pos.append(nc["pos"])
        stats.append(st)
    new_caches = None
    if caches is not None:
        new_caches = dict(caches)
        if fam != "ssm":
            new_attn = dict(attn)
            new_attn["pos"] = (torch.stack(new_pos) if slots
                               else attn["pos"] + x.shape[1])
            if fam == "hybrid":
                new_caches["attn"] = new_attn
            else:
                new_caches = new_attn
    return x, tree_stack(stats), new_caches


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg, dtype=torch.float32, device=None):
    """Returns ``(params, labels)`` with random weights from ``gen``. Every
    leaf is drawn once into its final storage (no second copy of a leaf
    is ever alive: a full-width model fills the card with one copy)."""
    _check_family(cfg)
    emb_scale = cfg.d_model ** -0.5
    params: dict[str, Any] = {}
    if cfg.family == "audio":
        params["embed"] = {"codebooks": scaled_randn(
            gen, (cfg.num_codebooks, cfg.vocab_size, cfg.d_model),
            emb_scale, dtype, device)}
    else:
        params["embed"] = {"tokens": scaled_randn(
            gen, (cfg.padded_vocab, cfg.d_model), emb_scale, dtype, device)}
    if cfg.family == "vlm":
        params["projector"] = init_linear(gen, cfg.vit_dim, cfg.d_model,
                                          use_bias=True, dtype=dtype,
                                          device=device)
    params["blocks"] = init_blocks(gen, cfg, dtype, device)
    params["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, device)
    if cfg.family == "audio":
        params["lm_head"] = init_linear(
            gen, cfg.d_model, cfg.num_codebooks * cfg.vocab_size,
            use_bias=False, dtype=dtype, device=device)
    elif not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                        use_bias=False, dtype=dtype,
                                        device=device)
    return params, model_labels(params, cfg)


def model_labels(params: dict, cfg) -> dict:
    """The label tree of a parameter tree (the reference's ``labels`` of
    ``init_model``), e.g. for weights carried across from a checkpoint."""
    labels: dict[str, Any] = {
        "embed": {k: "digital" for k in params["embed"]},
        "blocks": blocks_labels(params["blocks"], cfg),
        "final_norm": L.norm_labels(params["final_norm"])}
    for site in ("projector", "lm_head"):
        if site in params:
            labels[site] = linear_labels(params[site])
    return labels


def embed_inputs(params: dict, cfg, inputs: dict):
    """→ (x [B, S, d], positions [B, S]). Audio tokens are ``[B, S, K]``,
    one per codebook, and their embeddings are summed; the vlm's patch
    embeddings are prepended in :func:`forward`."""
    _check_family(cfg)
    tokens = inputs["tokens"]
    if cfg.family == "audio":
        if tokens.dim() != 3:
            # the reference fails here too, on broadcasting in the RoPE
            raise ValueError(
                f"the audio family takes tokens [B, S, K] (one id per "
                f"codebook), got shape {tuple(tokens.shape)}")
        emb = params["embed"]["codebooks"]                   # [K, V, d]
        x = emb[0][tokens[..., 0]]
        for k in range(1, cfg.num_codebooks):
            x = x + emb[k][tokens[..., k]]
    else:
        x = params["embed"]["tokens"][tokens]
    bsz, s = tokens.shape[:2]
    positions = torch.arange(s, device=tokens.device)[None].expand(bsz, s)
    return x, positions


def apply_lm_head(params: dict, cfg, acfg: AnalogConfig, ctx: AnalogCtx,
                  x: torch.Tensor):
    """Project hidden states to fp32 logits: vocab-sliced ``[..., V]``, or
    audio's ``[..., K, V]`` (one site of ``K · V`` outputs, not sliced).
    Returns ``(logits, stats)``."""
    stats = {}
    if cfg.tie_embeddings and cfg.family != "audio":
        logits = torch.matmul(x, params["embed"]["tokens"].T.to(x.dtype))
    else:
        logits, st = analog_linear(params["lm_head"], x, acfg,
                                   ctx.site("lm_head"))
        stats["lm_head"] = st
    if cfg.family == "audio":
        return logits.reshape(*x.shape[:-1], cfg.num_codebooks,
                              cfg.vocab_size).float(), stats
    return logits[..., :cfg.vocab_size].float(), stats


def forward(params: dict, cfg, acfg: AnalogConfig, ctx: AnalogCtx,
            inputs: dict, caches: dict | None = None,
            pos_offset: Optional[int | torch.Tensor] = None,
            last_only: bool = False,
            seq_mask: torch.Tensor | None = None,
            remat: bool | str = False, return_hidden: bool = False):
    """Full forward. Returns ``(logits, stats, new_caches)``.

    ``inputs``: ``{"tokens": ...}`` ([B, S], audio [B, S, K]), and for
    vlm optionally ``"patch_embeds"`` [B, vit_tokens, vit_dim], run
    through the ``projector`` site and prepended (the positions then count
    them). For decode pass single-token inputs with ``caches`` and
    ``pos_offset``, the RoPE position of the token: a host int for the
    contiguous cache, or per row ([B, 1] on the device) for the continuous
    engine's slot caches, where rows decode at their own positions.
    ``seq_mask`` [B, S] marks real tokens (see :func:`apply_blocks`).
    ``last_only`` applies the LM head to the final position only. ``remat``
    checkpoints each layer (training). ``return_hidden`` skips the LM head
    and returns the final-norm hidden states in place of the logits (the
    chunked-vocab loss applies :func:`apply_lm_head` per chunk).
    """
    x, positions = embed_inputs(params, cfg, inputs)
    stats: dict[str, Any] = {}
    if cfg.family == "vlm" and "patch_embeds" in inputs:
        pe, st = analog_linear(params["projector"], inputs["patch_embeds"],
                               acfg, ctx.site("projector"))
        stats["projector"] = st
        x = torch.cat([pe.to(x.dtype), x], dim=1)
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    if pos_offset is not None:
        positions = positions + pos_offset
    x, st_blocks, new_caches = apply_blocks(params["blocks"], x, cfg, acfg,
                                            ctx, positions, caches, seq_mask,
                                            remat)
    stats["blocks"] = st_blocks
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return x, stats, new_caches
    logits, st = apply_lm_head(params, cfg, acfg, ctx, x)
    stats.update(st)
    return logits, stats, new_caches


def _stack_meta(tree: dict, lead: tuple, device) -> dict:
    """Zeros ``lead + shape`` for every meta tensor leaf of ``tree`` (ints,
    the contiguous layout's host ``pos``, pass through)."""
    return {k: (v if isinstance(v, int)
                else torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                                 device=device))
            for k, v in tree.items()}


def init_caches(cfg, batch: int, max_len: int, dtype=torch.float32,
                device=None, *, per_slot: bool = False, paged: bool = False,
                kv_block_size: int = 16, kv_blocks: int | None = None,
                kv_bits: int = 0, state_snaps: int = 0) -> dict:
    """Stacked KV caches for :func:`apply_blocks`, every tensor leaf of
    ``layers.init_cache`` with a leading ``[L]`` axis: the contiguous
    ``{"k", "v": [L, B, T, KV, hd], "pos": 0}`` by default, the per-slot
    or paged layout of the continuous engine with ``per_slot`` /
    ``paged`` (every layer shares one logical→physical block mapping, so
    one host-side allocation covers the stack).

    The ssm family keeps a state per row instead of a KV cache:
    ``{"conv": [L, B, W-1, C] at dtype, "ssm": [L, B, H, N, P] fp32}``, the
    same whatever the layout (``max_len`` and the paging options do not
    apply). The hybrid family nests both: ``{"attn": the attention leaves
    [n_sb, ...], "mamba": the state leaves [n_sb, attn_every - 1, ...]}``;
    only its attention leaves are paged. ``state_snaps > 0`` adds the
    prefix cache's ``conv_snap`` / ``ssm_snap`` pools to every mamba cache
    (``mamba2.init_mamba_cache``); the attention-only families ignore
    it."""
    _check_family(cfg)
    attn = mamba = None
    if cfg.family != "ssm":
        attn = L.init_cache(cfg, batch, max_len, dtype, device="meta",
                            per_slot=per_slot, paged=paged,
                            kv_block_size=kv_block_size, kv_blocks=kv_blocks,
                            kv_bits=kv_bits)
    if cfg.family in ("ssm", "hybrid"):
        mamba = M.init_mamba_cache(cfg, batch, dtype, device="meta",
                                   state_snaps=state_snaps)
    if cfg.family == "hybrid":
        n_sb = cfg.num_layers // cfg.attn_every
        return {"attn": _stack_meta(attn, (n_sb,), device),
                "mamba": _stack_meta(mamba, (n_sb, cfg.attn_every - 1),
                                     device)}
    return _stack_meta(attn if mamba is None else mamba, (cfg.num_layers,),
                       device)


def cache_slot_spec(cfg, paged: bool = False, kv_bits: int = 0,
                    state_snaps: bool = False):
    """``(axes, kinds)`` of the slot cache tree of :func:`init_caches`,
    mirroring its structure.

    ``axes`` gives the slot (request) axis of each leaf, ``-1`` for
    pool-wide leaves with no slot axis (the paged pools, passed through
    whole). ``kinds`` labels each leaf: ``"start"`` (set to the left-pad
    count at admission), ``"pos"`` (the write cursor), ``"state"``
    (zeroed at admission, or restored from a snapshot), ``"table"`` /
    ``"wtable"`` (the slot's read / write block-table rows; the write row
    sends shared prefix-hit blocks to the sink) or ``"pool"`` (shared
    physical storage, untouched at admission but for the prefix cache's
    copy-on-write of a partial tail; every pool leaf keeps its block axis
    at position 1, after the stacked layer axis). The engine gathers and
    scatters one slot's rows with these, without knowing the layout. The
    mamba leaves (``conv``, ``ssm``) are per-slot state whatever ``paged``
    says (an attention-free stack has no KV to page); a hybrid stack's
    carry an extra leading per-super-block axis, which shifts their slot
    axis by one.

    ``state_snaps=True`` (the ssm and hybrid prefix cache) adds the
    ``conv_snap`` / ``ssm_snap`` leaves of ``init_caches(state_snaps >
    0)``: kind ``"spool"`` with axis ``-1``, passed through gathers whole
    and written only by the engine's snapshot capture and read by its
    restore, which index them on the sibling ``"state"`` leaf's slot axis.
    """
    _check_family(cfg)
    if paged:
        attn_axes = {"kp": -1, "vp": -1, "tbl": 1, "wtbl": 1, "pos": 1,
                     "start": 1}
        attn_kinds = {"kp": "pool", "vp": "pool", "tbl": "table",
                      "wtbl": "wtable", "pos": "pos", "start": "start"}
        if kv_bits == 8:
            attn_axes.update(ks=-1, vs=-1)
            attn_kinds.update(ks="pool", vs="pool")
    else:
        attn_axes = {"k": 1, "v": 1, "pos": 1, "start": 1}
        attn_kinds = {"k": "state", "v": "state", "pos": "pos",
                      "start": "start"}
    mamba_axes = {"conv": 1, "ssm": 1}
    mamba_kinds = {"conv": "state", "ssm": "state"}
    if state_snaps:
        mamba_axes.update(conv_snap=-1, ssm_snap=-1)
        mamba_kinds.update(conv_snap="spool", ssm_snap="spool")
    if cfg.family == "ssm":
        return mamba_axes, mamba_kinds
    if cfg.family == "hybrid":
        return ({"attn": attn_axes,
                 "mamba": {k: (v + 1 if v >= 0 else v)
                           for k, v in mamba_axes.items()}},
                {"attn": attn_kinds, "mamba": mamba_kinds})
    return attn_axes, attn_kinds
