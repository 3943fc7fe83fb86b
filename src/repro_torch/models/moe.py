"""Mixture-of-experts FFN with sort-based token dispatch (dropping).

Routing is computed *per sequence*, as in the JAX package's
``models/moe.py`` (group = one sequence), so the dispatch never builds a
``[tokens, E, capacity]`` one-hot tensor: each sequence's token → expert
assignments are argsorted by expert id, each token takes its rank within
its expert, and the kept ones are scattered into that sequence's
``capacity`` slots of its expert's buffer. The reference vmaps this over
the batch and runs each expert's FFN on one sequence's ``[C, d]`` buffer;
here every sequence's slots of an expert are stacked into ``[E, B·C, d]``
rows, so each expert site is one batched launch per forward that reads
each expert's weights once. Each output row depends only on its own row,
the scalar input range and its expert's column bound, so this is the
reference's per-sequence vmap row for row (within the ADC contract, which
lets the mapping differ with M).

The router is a *digital* fp32 linear (routing under analog noise is
catastrophic, and the paper keeps non-MVM ops digital); the expert FFNs
are batched analog sites sharing one input range per site (all experts
see the same token distribution). Capacity is static and the forward has
no host sync and no data-dependent shape, so it can be captured as a CUDA
graph. Dropped tokens are written to one spare row past the kept slots
(the reference's slot ``C``), which is never read back.

Statistics follow the reference: each expert site's input statistics are
taken per (sequence, expert) over that expert's ``C`` slots, empty slots
included, then averaged over the experts and over the sequences; the
router reports the Switch load-balancing loss as ``aux_loss``.

In training the gradients take the forward's paths back: to the tokens
through the dispatch into ``[E, B·C, d]`` (a dropped assignment, written
to the spare row, gets none), to the experts through the two batched
sites' STE rules, and to the router through the combine weights and
through ``aux_loss`` (whose top-1 density carries none, as in the
reference). Every backward op is deterministic: each token's ``k``
copies are taken by an ``expand`` (whose gradient is a sum over them)
and permuted by ``order``, so no scatter adds two gradients into one
row.
"""

from __future__ import annotations

import torch

from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     empty_stats, input_stats, linear_labels,
                                     scaled_randn)


def moe_capacity(seq_len: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity for one routed group (Switch-style)."""
    return max(1, int(seq_len * top_k * capacity_factor / num_experts))


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32,
             device=None, out: dict | None = None) -> dict:
    """Init MoE params: a digital fp32 router [d, E] and the batched
    analog expert sites ``gate_up`` [E, d, 2f] and ``down`` [E, f, d],
    each with one input range. ``out`` receives the expert kernels in
    place (no second copy of an expert leaf)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def batched(din, dout, name):
        kernel = scaled_randn(gen, (e, din, dout), din ** -0.5, dtype,
                              device,
                              None if out is None else out[name]["kernel"])
        return {"kernel": kernel,
                "input_range": torch.full((1,), 3.0, device=device)}

    router = torch.randn((d, e), generator=gen, device=device,
                         dtype=torch.float32) * d ** -0.5
    return {"router": {"kernel": router},
            "gate_up": batched(d, 2 * f, "gate_up"),
            "down": batched(f, d, "down")}


def moe_labels(p: dict) -> dict:
    """Labels for MoE params: digital router, analog expert sites."""
    return {"router": {"kernel": "digital"},
            "gate_up": linear_labels(p["gate_up"]),
            "down": linear_labels(p["down"])}


def _expert_site(p: dict) -> dict:
    """The batched site handed to ``analog_linear``: the kernel, the input
    range and, when ``pack_int4_weights`` attached it, the packed-int4
    carrier (the reference packs per call; both give the same weights).

    A ``"device"`` sub-dict (``core/devices.py``) is left out on purpose:
    the reference builds each expert's site from ``kernel`` and
    ``input_range`` alone (``src/repro/models/moe.py:95-102``), so its
    experts serve pristine weights under the device model, though
    ``attach_device_state`` gives them state that ``health`` and
    ``recalibrate`` count and redraw. The port does the same."""
    site = {"kernel": p["kernel"], "input_range": p["input_range"]}
    if "int4" in p:
        site["int4"] = p["int4"]
    return site


def _site_stats(x: torch.Tensor, p: dict, acfg: AnalogConfig,
                ctx: AnalogCtx, groups: tuple[int, int]) -> dict:
    """A batched site's statistics as the reference's vmaps give them:
    ``x`` [E, B·C, n] taken per (expert, sequence) over its C slots, then
    the mean over experts, then over sequences (zeros where
    ``analog_linear`` collects none)."""
    if not (ctx.collect_stats and acfg.mode in ("analog", "qat", "rtn")):
        return empty_stats()
    e, b = groups
    beta = p["input_range"].reshape(()).float()
    st = input_stats(x.float().reshape(e, b, -1, x.shape[-1]), beta,
                     dims=(2, 3))
    return {k: torch.mean(torch.mean(v, dim=0)) for k, v in st.items()}


def _route(x: torch.Tensor, router: torch.Tensor, cfg, capacity: int):
    """Per-sequence routing of x [B, S, d], in the reference's op order.
    Returns ``(weights, ids [B, S, k], row, order [B, S·k], aux [B])``:
    the renormalised top-k weights and expert ids, each sorted
    assignment's ``row`` of the stacked ``[E·B·C + 1]`` expert buffer (the
    last row takes the dropped ones), the stable argsort ``order`` that
    sorted them, and the load-balancing loss."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = torch.matmul(x.float(), router.float())            # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)                  # [B, S, k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style): E * sum_e f_e * P_e
    first = torch.zeros((b, e), device=x.device).scatter_add_(
        1, ids[..., 0], torch.ones((b, s), device=x.device))
    density = first / s
    aux = e * torch.sum(density * torch.mean(probs, dim=1), dim=-1)

    # ---- sort-based dispatch, per sequence ----------------------------------
    flat_ids = ids.reshape(b, s * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device
                         ).scatter_add_(1, flat_ids,
                                        torch.ones_like(flat_ids))
    offsets = torch.cumsum(counts, dim=-1) - counts              # exclusive
    pos = (torch.arange(s * k, device=x.device)[None]
           - torch.gather(offsets, 1, sorted_ids))               # rank
    seq = torch.arange(b, device=x.device)[:, None]
    row = (sorted_ids * b + seq) * capacity + pos
    row = torch.where(pos < capacity, row,
                      torch.full_like(row, e * b * capacity))    # drop row
    return weights, ids, row, order, aux


def moe(p: dict, x: torch.Tensor, cfg, acfg: AnalogConfig, ctx: AnalogCtx):
    """MoE FFN over x [B, S, d]. Returns ``(y, stats)``, stats with
    ``router.aux_loss``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    capacity = moe_capacity(s, e, k, cfg.capacity_factor)
    weights, _, row, order, aux = _route(x, p["router"]["kernel"], cfg,
                                         capacity)
    # token ``order // k`` of each sorted assignment: its k copies, then a
    # permutation (a gather by ``order // k`` would scatter-add k gradients
    # into each token row in its backward)
    copies = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    src = torch.gather(copies, 1, order[..., None].expand(b, s * k, d))

    # every sequence's capacity slots of an expert, stacked: [E, B·C, d]
    buf = torch.zeros((e * b * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((row.reshape(-1),), src.reshape(-1, d))
    buf_in = buf[:-1].view(e, b * capacity, d)

    # ---- expert FFN: batched analog sites, one launch each -----------------
    gu, _ = analog_linear(_expert_site(p["gate_up"]), buf_in, acfg,
                          ctx.site("gate_up"))
    gate, up = torch.chunk(gu, 2, dim=-1)
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    y_buf, _ = analog_linear(_expert_site(p["down"]), h, acfg,
                             ctx.site("down"))

    # ---- combine: the drop row reads 0; tokens go back through ``order`` ---
    y_rows = torch.cat([y_buf.reshape(-1, d),
                        torch.zeros((1, d), dtype=y_buf.dtype,
                                    device=x.device)])
    y_sorted = y_rows[row]                                       # [B, S·k, d]
    y_flat = torch.empty_like(y_sorted).scatter_(
        1, order[..., None].expand(b, s * k, d), y_sorted)
    y = torch.sum(y_flat.reshape(b, s, k, d)
                  * weights[..., None].to(x.dtype), dim=2)

    stats = {"gate_up": _site_stats(buf_in, p["gate_up"], acfg, ctx,
                                    (e, b)),
             "down": _site_stats(h, p["down"], acfg, ctx, (e, b)),
             "router": {"aux_loss": torch.mean(aux)}}
    return y.to(x.dtype), stats
