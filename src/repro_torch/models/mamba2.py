"""Mamba-2 (SSD) mixer block, the layer of the ssm family (mamba2-130m).

The projections (``in_proj`` / ``out_proj``) are analog sites and run on the
MVM kernels through ``analog_linear``; the causal depthwise conv, the SSD
recurrence and the gated RMSNorm are digital. The SSD of a prompt or a
prefill chunk runs on the hand-written ``ssd_scan`` kernel
(``kernels.dispatch.ssd``), which also folds in the incoming state and
returns the final one; a single decode token runs the plain one-step
recurrence (``kernels.ref.ssd_decode_step``), which is plain tensor code in
the JAX package too.

Parameters keep the reference's names and layout, so weights carry across
through ``checkpoint.params_from_numpy`` unchanged. The reference's
tensor-parallel ``shard_hint`` calls have no counterpart here (tensor
parallelism is a later slice).
"""

from __future__ import annotations

import torch

from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     init_linear, linear_labels)
from repro_torch.kernels import dispatch, ref


def _dims(cfg):
    """Derived mamba dims: (d_inner, heads, groups*state, conv_ch, in_proj)."""
    d_inner = cfg.d_inner
    heads = cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_ch = d_inner + 2 * gn
    d_in_proj = 2 * d_inner + 2 * gn + heads
    return d_inner, heads, gn, conv_ch, d_in_proj


def init_mamba(gen: torch.Generator, cfg, dtype=torch.float32,
               device=None) -> dict:
    """Init one SSD mixer: analog in/out projections + digital scan params."""
    d_inner, heads, _, conv_ch, d_in_proj = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=gen, **f32)
    return {
        "in_proj": init_linear(gen, cfg.d_model, d_in_proj, use_bias=False,
                               dtype=dtype, device=device),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "d_skip": torch.ones((heads,), **f32),
        # softplus^-1(0.01)
        "dt_bias": torch.log(torch.expm1(torch.full((heads,), 0.01, **f32))),
        "gate_norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": init_linear(gen, d_inner, cfg.d_model, use_bias=False,
                                dtype=dtype, device=device),
    }


def mamba_labels(p: dict) -> dict:
    """Labels for mamba params: analog projections, digital scan/conv."""
    lab = {k: "digital" for k in p if k not in ("in_proj", "out_proj")}
    lab["in_proj"] = linear_labels(p["in_proj"])
    lab["out_proj"] = linear_labels(p["out_proj"])
    return lab


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along seq. x [B, S, C], w [W, C].

    Returns (y, new_state) where state holds the trailing W-1 inputs (None
    when W is 1). A Python sum over the taps, as in the reference, so that
    a zeroed input row gives the same bits as in the reference's order.
    """
    width = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i][None, None, :] for i in range(width))
    y = y + b[None, None, :]
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return torch.nn.functional.silu(y.float()).to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``softplus`` switches to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: normalize y * silu(z), then scale."""
    g = y.float() * torch.nn.functional.silu(z.float())
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return (g * scale.float()).to(y.dtype)


def mamba(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig, ctx: AnalogCtx,
          cache: dict | None = None, seq_mask: torch.Tensor | None = None):
    """SSD mixer over x [B, S, d]. Returns (y, stats, new_cache).

    cache: {"conv": [B, W-1, conv_ch], "ssm": [B, H, N, P]} for serving;
    with S > 1 it is the prefill (or a prefill chunk continuing from the
    cached state), with S == 1 a decode step. Without a cache no state is
    kept.

    ``seq_mask`` [B, S] (1 = real token) makes masked positions
    state-transparent, which the continuous engine's left-padded chunked
    prefill and its masked decode rows rely on: masked positions get
    ``dt = 0`` (decay ``exp(dt·a) = 1``, input ``dt·B·x = 0``) and zeroed
    conv inputs (left pads then match a fresh conv's zero padding), and a
    fully masked row keeps its conv tail as it was.
    """
    bsz, s, _ = x.shape
    d_inner, heads, gn, conv_ch, _ = _dims(cfg)
    pdim = cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state

    zxbcdt, st_in = analog_linear(p["in_proj"], x, acfg, ctx)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_ch, heads], dim=-1)

    if seq_mask is not None:
        xbc = xbc * seq_mask[..., None].to(xbc.dtype)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None, :])   # [B,S,H]
    if seq_mask is not None:
        dt = dt * seq_mask[..., None].to(dt.dtype)
    a = -torch.exp(p["a_log"])                                     # [H]
    xh = xs.reshape(bsz, s, heads, pdim)
    bg = b.reshape(bsz, s, g, n)
    cg = c.reshape(bsz, s, g, n)

    # the conv tail is stored at the cache's dtype (a bf16 cache gets a
    # bf16 tail back); width 1 carries no tail and the empty [B, 0, C] leaf
    # passes through. A fully masked row keeps its old tail: the trailing
    # window would otherwise shift zeros into a row this step must leave
    # untouched (its SSM state is already transparent through dt = 0).
    conv_cast = (None if cache is None
                 else cache["conv"] if new_conv is None
                 else new_conv.to(cache["conv"].dtype))
    if cache is not None and seq_mask is not None and new_conv is not None:
        row_on = torch.amax(seq_mask, dim=1) > 0                    # [B]
        conv_cast = torch.where(row_on[:, None, None], conv_cast,
                                cache["conv"])
    if cache is not None and s == 1:                               # decode
        rep = heads // g

        def to_bh(t):
            return torch.repeat_interleave(t[:, 0], rep, dim=1).reshape(
                bsz * heads, -1)

        h, y_t = ref.ssd_decode_step(
            cache["ssm"].reshape(bsz * heads, n, pdim),
            xh[:, 0].reshape(bsz * heads, pdim),
            dt[:, 0].reshape(bsz * heads), a.repeat(bsz),
            to_bh(bg), to_bh(cg))
        y = y_t.reshape(bsz, 1, heads, pdim)
        new_cache = {**cache, "conv": conv_cast,
                     "ssm": h.reshape(bsz, heads, n, pdim)}
    else:
        h0 = (cache["ssm"].reshape(bsz * heads, n, pdim)
              if cache is not None else None)
        y, h_final = _ssd_with_state(xh, dt, a, bg, cg, h0)
        new_cache = ({**cache, "conv": conv_cast,
                      "ssm": h_final.reshape(bsz, heads, n, pdim)}
                     if cache is not None else None)

    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["gate_norm"])
    out, st_out = analog_linear(p["out_proj"], y, acfg, ctx)
    return out, {"in_proj": st_in, "out_proj": st_out}, new_cache


def _ssd_with_state(xh, dt, a, bg, cg, h0=None):
    """Chunked SSD returning (y [B, S, H, P] fp32, final state [B·H, N, P]).

    ``h0`` [B·H, N, P] is an optional incoming state (the continuous
    engine's chunked prefill: chunk k continues from chunk k-1's state). It
    contributes ``C_t · exp(Σ_{i≤t} dt_i·a) · h0`` to each output and decays
    by ``exp(Σ dt·a)`` into the final state. On the card both terms are
    folded into the ``ssd_scan`` kernel; the plain version
    (``kernels.ref.ssd_scan_ref``) adds them after the zero-state scan, as
    the reference does.
    """
    return dispatch.ssd(xh, dt, a, bg, cg, h0)


def init_mamba_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """Serving-time SSM state, slot-major: ``conv`` [B, W-1, C] at
    ``dtype`` and ``ssm`` [B, H, N, P], always fp32. The reference's
    prefix-cache snapshot pools (``state_snaps``) come with prefix caching
    (ROADMAP section 1, item 9)."""
    _, heads, _, conv_ch, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device)}
