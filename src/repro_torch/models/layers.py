"""Shared model layers: norms, RoPE, GQA attention, MLPs.

Every projection goes through :func:`repro_torch.core.analog.analog_linear`;
attention itself, norms, activations and residual adds stay in high
precision (the "digital units" of the paper's heterogeneous accelerator).
With ``AnalogConfig.use_pallas`` every projection here runs on the
hand-written kernels through ``kernels.dispatch``.

Blocks return ``(y, stats)``, with ``stats`` mirroring the linear sites of
their params.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     init_linear, linear_labels)
from repro_torch.kernels import dispatch

# ---------------------------------------------------------------------------
# norms (digital)
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype=torch.float32, device=None) -> dict:
    """Init RMSNorm/LayerNorm params (scale, and bias for layernorm)."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_labels(p: dict) -> dict:
    """Clipping/optimizer labels for a norm site (all digital)."""
    return {k: "digital" for k in p}


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """Apply RMSNorm or LayerNorm in fp32, returning the input dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (digital)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply rotary embeddings. x [..., S, H, hd], positions [..., S]."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full_like(expo, theta), expo)
    ang = positions[..., :, None].float() * freqs            # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (digital math, analog projections)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32,
                   device=None) -> dict:
    """Init GQA attention params (fused qkv or split q/k/v analog sites)."""
    hd = cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {}
    if cfg.fused_qkv:
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        p["qkv"] = init_linear(gen, cfg.d_model, qkv_out,
                               use_bias=cfg.qkv_bias, **kw)
    else:
        p["q"] = init_linear(gen, cfg.d_model, cfg.num_heads * hd,
                             use_bias=cfg.qkv_bias, **kw)
        p["k"] = init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                             use_bias=cfg.qkv_bias, **kw)
        p["v"] = init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                             use_bias=cfg.qkv_bias, **kw)
    p["o"] = init_linear(gen, cfg.num_heads * hd, cfg.d_model,
                         use_bias=False, **kw)
    return p


def attention_labels(p: dict) -> dict:
    """Labels for attention params: one linear-site label set per proj."""
    return {k: linear_labels(v) for k, v in p.items()}


def _split_qkv(qkv: torch.Tensor, cfg):
    """Split a fused qkv projection into per-head q, k, v tensors."""
    hd = cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = torch.split(qkv, [nq * hd, nkv * hd, nkv * hd], dim=-1)
    q = q.reshape(*q.shape[:-1], nq, hd)
    k = k.reshape(*k.shape[:-1], nkv, hd)
    v = v.reshape(*v.shape[:-1], nkv, hd)
    return q, k, v


def _gqa_scores_softmax_v(q, k, v, mask, scale):
    """q [B,S,H,hd], k/v [B,T,KV,hd], mask [B,S,T] → [B,S,H,hd] in fp32."""
    nq, nkv = q.shape[-2], k.shape[-2]
    group = nq // nkv
    qg = q.reshape(*q.shape[:-2], nkv, group, q.shape[-1])
    logits = torch.einsum("bsngh,btnh->bnsgt", qg.float(), k.float()) * scale
    logits = torch.where(mask[:, None, :, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnsgt,btnh->bsngh", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)


def _chunked_causal_attention(q, k, v, scale, q_chunk=512, kv_chunk=1024):
    """Flash-style online-softmax causal attention over KV chunks.

    Never materializes the [S, S] score matrix (prompts over 1024 tokens);
    chunks wholly in a query chunk's future are skipped.
    """
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    qg = q.reshape(b, s, nkv, group, hd).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, s, q_chunk):
        q_blk = qg[:, q0:q0 + q_chunk]
        sq = q_blk.shape[1]
        q_pos = torch.arange(q0, q0 + sq, device=q.device)
        m = torch.full((b, nkv, sq, group), -float("inf"), device=q.device)
        l = torch.zeros((b, nkv, sq, group), device=q.device)
        acc = torch.zeros((b, nkv, sq, group, hd), device=q.device)
        for k0 in range(0, t, kv_chunk):
            if k0 > q0 + q_chunk - 1:     # wholly in the future: skipped
                break
            k_blk, v_blk = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            k_pos = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
            logits = torch.einsum("bsngh,btnh->bnsgt", q_blk, k_blk) * scale
            causal = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(causal[None, None, :, None, :], logits,
                                 torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bnsgt,btnh->bnsgh", p, v_blk)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3, 4))   # [b, sq, nkv, group, hd]
    return torch.cat(outs, dim=1).reshape(b, s, nq, hd).to(q.dtype)


def attention(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig,
              ctx: AnalogCtx, positions: torch.Tensor,
              cache: dict | None = None,
              seq_mask: torch.Tensor | None = None):
    """GQA attention block. Returns ``(y, stats, new_cache)``.

    Three cache layouts (see :func:`init_cache`):

    * contiguous (``pos`` a host int): ``{"k", "v": [B, T, KV, hd],
      "pos"}``, one write position shared by the batch. A prefill writes
      the prompt's K/V at the front of the buffers and a decode step one
      token at ``pos``; a decode step attends the whole buffer masked to
      ``j <= pos``.
    * per slot (``pos`` [B] on the device): ``{"k", "v", "pos", "start"}``,
      the continuous engine's layout. Row ``b`` writes its chunk at
      ``pos[b] + arange(S)`` and attends ``start[b] <= j <= pos[b] + i``.
    * paged (``"kp"`` present): ``{"kp", "vp": [P, bs, KV, hd], "tbl",
      "wtbl": [B, NB], "pos", "start": [B]}`` (+ ``"ks"`` / ``"vs"``
      [P, bs, KV] scales for the int8 pool). Logical index ``j`` of row
      ``b`` lives at physical block ``tbl[b, j // bs]``, offset
      ``j % bs``; writes go through ``wtbl``, reads through ``tbl``.
      Decode runs ``paged_flash_decode``, a prefill chunk
      ``paged_flash_prefill`` (``kernels.dispatch``).

    ``seq_mask`` [B, S] (1 = real token) applies to the slot layouts: a
    row whose mask is all zero is cache-transparent, its K/V writes are
    dropped (per slot) or sent to the sink block 0 (paged) and its cursor
    stays. All three update the buffers **in place**; the returned cache
    holds the same buffers and the new cursors.
    """
    hd = cfg.head_dim
    if "qkv" in p:
        qkv, st_qkv = analog_linear(p["qkv"], x, acfg, ctx)
        q, k, v = _split_qkv(qkv, cfg)
        stats_in = {"qkv": st_qkv}
    else:
        q, st_q = analog_linear(p["q"], x, acfg, ctx)
        k, st_k = analog_linear(p["k"], x, acfg, ctx)
        v, st_v = analog_linear(p["v"], x, acfg, ctx)
        q = q.reshape(*q.shape[:-1], cfg.num_heads, hd)
        k = k.reshape(*k.shape[:-1], cfg.num_kv_heads, hd)
        v = v.reshape(*v.shape[:-1], cfg.num_kv_heads, hd)
        stats_in = {"q": st_q, "k": st_k, "v": st_v}
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    s = x.shape[1]

    if cache is not None and "kp" in cache:          # paged slots
        out, new_cache = _paged_slot_attention(cache, q, k, v, scale,
                                               acfg.kv_splits, seq_mask)
    elif cache is not None and "start" in cache:     # per-slot buffers
        out, new_cache = _slot_attention(cache, q, k, v, scale, seq_mask)
    elif cache is not None and s == 1:               # decode step
        pos = cache["pos"]
        k_buf, v_buf = cache["k"], cache["v"]
        k_buf[:, pos:pos + 1] = k.to(k_buf.dtype)
        v_buf[:, pos:pos + 1] = v.to(v_buf.dtype)
        t = k_buf.shape[1]
        mask = (torch.arange(t, device=x.device) <= pos)[None, None, :]
        mask = mask.expand(x.shape[0], 1, t)
        out = _gqa_scores_softmax_v(q, k_buf, v_buf, mask, scale)
        new_cache = {"k": k_buf, "v": v_buf, "pos": pos + 1}
    else:                                            # train / prefill
        if s <= 1024:
            t = k.shape[1]
            mask = (positions[:, :, None]
                    >= torch.arange(t, device=x.device)[None, None, :])
            out = _gqa_scores_softmax_v(q, k, v, mask, scale)
        else:
            out = _chunked_causal_attention(q, k, v, scale)
        if cache is not None:                        # prefill fills the cache
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "pos": cache["pos"] + s}
        else:
            new_cache = None

    out = out.reshape(*x.shape[:-1], cfg.num_heads * cfg.head_dim)
    y, st_o = analog_linear(p["o"], out, acfg, ctx)
    return y, {**stats_in, "o": st_o}, new_cache


def _row_active(seq_mask: torch.Tensor | None, bsz: int,
                device) -> torch.Tensor:
    """Per-row activity flag [B] int32 of the slot layouts: 1 when the
    row's chunk carries at least one real token, 0 when the whole row is
    masked (a slot the current substep must leave untouched)."""
    if seq_mask is None:
        return torch.ones((bsz,), dtype=torch.int32, device=device)
    return (torch.amax(seq_mask, dim=1) > 0).to(torch.int32)


def _slot_attention(cache, q, k, v, scale, seq_mask=None):
    """Per-slot branch of :func:`attention`: scatter the chunk at
    ``pos[b] + arange(S)``, then attend ``start[b] <= j <= pos[b] + i``.

    The reference drops the writes of masked rows with an out-of-range
    index; torch has no dropping scatter, so a masked row writes back the
    values it reads at clamped indices, which leaves its buffer as it was.
    """
    pos, start = cache["pos"], cache["start"]
    k_buf, v_buf = cache["k"], cache["v"]
    bsz, s = q.shape[0], q.shape[1]
    t = k_buf.shape[1]
    dev = q.device
    row_on = _row_active(seq_mask, bsz, dev)
    idx = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    keep = ((row_on[:, None] > 0) & (idx < t))[..., None, None]
    idx_c = torch.clamp_max(idx, t - 1)
    b_idx = torch.arange(bsz, device=dev)[:, None].expand(bsz, s)
    k_buf[b_idx, idx_c] = torch.where(keep, k.to(k_buf.dtype),
                                      k_buf[b_idx, idx_c])
    v_buf[b_idx, idx_c] = torch.where(keep, v.to(v_buf.dtype),
                                      v_buf[b_idx, idx_c])
    j = torch.arange(t, device=dev)[None, None, :]
    mask = (j >= start.long()[:, None, None]) & (j <= idx[:, :, None])
    out = _gqa_scores_softmax_v(q, k_buf, v_buf, mask, scale)
    return out, {"k": k_buf, "v": v_buf, "pos": pos + s * row_on,
                 "start": start}


def _paged_slot_attention(cache, q, k, v, scale, kv_splits=1,
                          seq_mask=None):
    """Paged branch of :func:`attention`: scatter the chunk into the block
    pool through the write table, then score it against each row's live
    blocks in place (decode: ``paged_flash_decode``, a prefill chunk:
    ``paged_flash_prefill``).

    A fully masked row writes to the sink block 0 and keeps its cursor.
    JAX clamps a gather past the table's end where torch raises, so the
    logical block index is clamped explicitly; only masked rows, whose
    block is the sink anyway, can reach past it.
    """
    pos, start, tbl = cache["pos"], cache["start"], cache["tbl"]
    wtbl = cache.get("wtbl", tbl)
    bsz, s = q.shape[0], q.shape[1]
    bs = cache["kp"].shape[1]
    dev = q.device
    row_on = _row_active(seq_mask, bsz, dev)
    idx = pos.long()[:, None] + torch.arange(s, device=dev)[None, :]
    lblk = torch.clamp_max(idx // bs, wtbl.shape[1] - 1)
    blk = torch.gather(wtbl.long(), 1, lblk)
    blk = torch.where(row_on[:, None] > 0, blk, torch.zeros_like(blk))
    off = idx % bs
    new_cache = dict(cache)
    if "ks" in cache:
        kq, ks = quant.kv_quantize(k, 8)
        vq, vs = quant.kv_quantize(v, 8)
        cache["kp"][blk, off] = kq
        cache["vp"][blk, off] = vq
        cache["ks"][blk, off] = ks.to(cache["ks"].dtype)
        cache["vs"][blk, off] = vs.to(cache["vs"].dtype)
    else:
        cache["kp"][blk, off] = k.to(cache["kp"].dtype)
        cache["vp"][blk, off] = v.to(cache["vp"].dtype)
    new_cache["pos"] = pos + s * row_on

    if s == 1:                                    # decode: flash over blocks
        out = dispatch.paged_decode_attention(
            q[:, 0], cache["kp"], cache["vp"], tbl, pos, start, scale,
            k_scale=cache.get("ks"), v_scale=cache.get("vs"),
            num_splits=kv_splits)
        return out[:, None].to(q.dtype), new_cache
    out = dispatch.paged_prefill_attention(
        q, cache["kp"], cache["vp"], tbl, pos, start, scale,
        k_scale=cache.get("ks"), v_scale=cache.get("vs"))
    return out.to(q.dtype), new_cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None, *, per_slot: bool = False, paged: bool = False,
               kv_block_size: int = 16, kv_blocks: int | None = None,
               kv_bits: int = 0) -> dict:
    """Attention KV cache of one layer (the reference's key names).

    * default: the contiguous cache ``{"k", "v": [B, T, KV, hd], "pos": 0}``
      with ``pos`` a host int, so a decode step needs no device sync;
    * ``per_slot``: per-row cursors ``pos`` and left-pad markers ``start``
      [B] int32 on the device;
    * ``paged`` (implies per slot): a pool of ``kv_blocks`` usable blocks
      of ``kv_block_size`` tokens (default: every slot at ``max_len``) plus
      the sink block at physical 0, the read and write block tables
      ``tbl`` / ``wtbl`` [B, ceil(max_len / kv_block_size)], and with
      ``kv_bits=8`` an int8 pool with fp32 per token/head scales
      ``ks`` / ``vs``.
    """
    hd, nkv = cfg.head_dim, cfg.num_kv_heads

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if paged:
        nb = -(-max_len // kv_block_size)
        npool = 1 + (kv_blocks if kv_blocks else batch * nb)
        kv_dtype = torch.int8 if kv_bits == 8 else dtype
        c = {"kp": zeros((npool, kv_block_size, nkv, hd), kv_dtype),
             "vp": zeros((npool, kv_block_size, nkv, hd), kv_dtype),
             "tbl": zeros((batch, nb), torch.int32),
             "wtbl": zeros((batch, nb), torch.int32),
             "pos": zeros((batch,), torch.int32),
             "start": zeros((batch,), torch.int32)}
        if kv_bits == 8:
            c["ks"] = zeros((npool, kv_block_size, nkv), torch.float32)
            c["vs"] = zeros((npool, kv_block_size, nkv), torch.float32)
        return c
    c = {"k": zeros((batch, max_len, nkv, hd), dtype),
         "v": zeros((batch, max_len, nkv, hd), dtype)}
    if per_slot:
        c["pos"] = zeros((batch,), torch.int32)
        c["start"] = zeros((batch,), torch.int32)
    else:
        c["pos"] = 0
    return c


# ---------------------------------------------------------------------------
# MLP (SwiGLU / plain-GELU), analog projections
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg, dtype=torch.float32,
             device=None) -> dict:
    """Init MLP params: SwiGLU (fused gate_up) for silu, plain GELU else."""
    kw = dict(dtype=dtype, device=device)
    if cfg.act == "silu":
        return {"gate_up": init_linear(gen, cfg.d_model, 2 * cfg.d_ff,
                                       use_bias=False, **kw),
                "down": init_linear(gen, cfg.d_ff, cfg.d_model,
                                    use_bias=False, **kw)}
    return {"up": init_linear(gen, cfg.d_model, cfg.d_ff, use_bias=True,
                              **kw),
            "down": init_linear(gen, cfg.d_ff, cfg.d_model, use_bias=True,
                                **kw)}


def mlp_labels(p: dict) -> dict:
    """Labels for MLP params: one linear-site label set per projection."""
    return {k: linear_labels(v) for k, v in p.items()}


def mlp(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig, ctx: AnalogCtx):
    """MLP block over [B, S, d] (analog projections). Returns (y, stats)."""
    if "gate_up" in p:
        gu, st1 = analog_linear(p["gate_up"], x, acfg, ctx)
        gate, up = torch.chunk(gu, 2, dim=-1)
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        y, st2 = analog_linear(p["down"], h, acfg, ctx)
        return y, {"gate_up": st1, "down": st2}
    h, st1 = analog_linear(p["up"], x, acfg, ctx)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    y, st2 = analog_linear(p["down"], h, acfg, ctx)
    return y, {"up": st1, "down": st2}
