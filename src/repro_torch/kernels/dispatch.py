"""Kernel-dispatch layer: routes ``analog_linear``'s MVM onto the
hand-written CUDA kernels when :attr:`AnalogConfig.use_pallas` is set.

Dispatch rules (the reference's ``kernels/dispatch.py``):

* ``analog`` / ``rtn`` modes with output quantization → :func:`analog_mvm`,
  one AIMC tile op (DAC-quant → MVM → per-column ADC-quant) fused in
  ``analog_matmul``. The weight handed in is the effective one (noise-
  perturbed or RTN-dequantized), so the kernel stays deterministic.
* ``rtn`` serving with 4-bit weights (``AnalogConfig.int4_serve``) →
  :func:`int4_mvm_packed`: weights packed two per byte, unpacked on chip;
  input and output quantization stay in the digital periphery.
* Paged attention of the continuous engine → :func:`paged_decode_attention`
  (``paged_flash_decode``) for a decode step and
  :func:`paged_prefill_attention` (``paged_flash_prefill``) for a prefill
  chunk, both scoring the block pool in place.
* The Mamba-2 SSD of the ssm family → :func:`ssd` (``ssd_scan``), the
  JAX package's ``ops.ssd`` with ``mamba2._ssd_with_state``'s incoming
  and final state folded in. The JAX package runs its Pallas kernel only on
  a TPU and only when the chunk divides S (else its chunked jnp path with
  ``chunk = min(128, S)``), so its own engine's 32-token chunks never reach
  the kernel there; the port takes the kernel on the card for every S,
  ragged tails included. The function is the same; the chunking is the
  kernel's own.
* A CPU tensor runs each kernel's plain PyTorch version (the CPU tests); a
  CUDA tensor launches the kernel or raises; a meta tensor gets the
  wrapper's shape-only result (``launch.dryrun``). There is no switch that sends
  a CUDA tensor to the plain version: a caller that wants it calls ``ref``.
* Autograd: :func:`fused_analog_mvm` is a ``torch.autograd.Function`` (the
  reference's ``jax.custom_vjp``): its forward runs ``analog_matmul`` on
  the effective weights; its backward replays the unfused STE chain in
  plain torch, as the JAX package does outside its Pallas kernel (ADC pure
  pass-through, the noise-free weight rule of ``core.analog.noisy_matmul``,
  the clamp-STE / LSQ rule of ``core.quant.input_quantize``), a batched
  expert site's per expert. :func:`ssd` wraps ``ssd_scan`` in an autograd
  rule whose backward differentiates the plain version
  (``ref.ssd_scan_ref``) rebuilt from the saved inputs: the reference's
  gradient is XLA's derivative of that same chunked jnp math, and the
  forward stays on the kernel. The paged kernels have no backward, as in
  the reference. Both rules run on the meta device too (the dry run's
  train step), where the forward is the wrapper's shape-only call.

The MVM kernels take one [M, K] @ [K, N] product, or a batch of E
experts' products in one launch, so ``[B, S, K]`` activations are
flattened here, and a MoE site's ``[E, ..., K]`` activations against
``[E, K, N]`` weights keep their expert axis. Each kernel's library picks
its own tiling for the card from the shape; :func:`select_blocks` reports
it.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _launch, cost, ref
from repro_torch.kernels.analog_matmul import analog_matmul
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.kernels.paged_prefill import paged_flash_prefill
from repro_torch.kernels.ssd_scan import ssd_scan


@contextlib.contextmanager
def whole_site(experts: int, n: int, first_expert: int = 0,
               first_col: int = 0):
    """Run every MVM in the block as part of a site of ``experts`` experts
    and ``n`` output columns, the shard's first expert and column at
    ``first_expert`` / ``first_col``: a tensor-parallel shard
    (``distributed.sharding.parallel_linear``) computes some of the
    site's columns or experts. On the card its launch runs the whole
    site's mapping and K split; on the CPU its plain product runs at the
    whole site's shape (``ref.site_matmul``). Either way each column sums
    K in the whole site's order, and its bits do not depend on how many
    columns the shard computes."""
    token = ref.WHOLE_SITE.set((experts, n, first_expert, first_col))
    try:
        yield
    finally:
        ref.WHOLE_SITE.reset(token)


#: data shards of the running train step (``data_shards``): a process-wide
#: value, not a context variable, because a checkpointed layer's
#: recomputation runs on the autograd engine's thread
_ROW_SHARDS = 1


@contextlib.contextmanager
def data_shards(n: int):
    """Run every ``analog_matmul`` launch in the block as one of ``n``
    equal data shards of a training batch: it plans as the whole batch's
    launch of ``n`` times its rows (``analog_matmul(plan_rows=)``), so each
    row sums K in the whole launch's order where both take the same
    mapping. The CPU's plain product is not affected."""
    global _ROW_SHARDS
    prev, _ROW_SHARDS = _ROW_SHARDS, n
    try:
        yield
    finally:
        _ROW_SHARDS = prev


def _plan_rows(m: int):
    """The rows a launch of ``m`` rows plans as (:func:`data_shards`), or
    None."""
    return None if _ROW_SHARDS == 1 else m * _ROW_SHARDS


def _plan_shape():
    """``(experts, columns)`` of the whole site of a shard's launch, or
    None (:func:`whole_site`)."""
    site = ref.WHOLE_SITE.get()
    return None if site is None else site[:2]


def use_fused(cfg) -> bool:
    """True when ``analog_linear`` should route through the fused tile op:
    ``use_pallas`` on, output quantization on, mode ``analog`` or ``rtn``."""
    return bool(cfg.use_pallas and cfg.output_quant
                and cfg.mode in ("analog", "rtn"))


def select_blocks(m: int, k: int, n: int, *, kernel: str = "analog_matmul",
                  device=None, in_bits: int = 8,
                  experts: int = 1) -> _launch.Plan:
    """The plan ``kernel`` (``"analog_matmul"`` or ``"int4_matmul"``) runs
    for an [M, K] @ [K, N] call on the card (``experts`` of them in one
    launch): the GEMV-shaped decode mapping for M ≤ 8, else the
    tensor-core ``mma`` one (``analog_matmul`` with ``in_bits`` > 12: the
    CUDA-core ``tiled`` one), the split of K over blocks and the scratch.
    The CUDA library computes it (this card's SM count), so it needs the
    card."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    return _launch.plan(kernel, m, k, n, index,
                        in_bits if kernel == "analog_matmul" else None,
                        experts)


def flatten_batch(x: torch.Tensor, experts: int = 0
                  ) -> tuple[torch.Tensor, tuple[int, ...]]:
    """[..., K] → (contiguous [M, K], leading shape); with ``experts`` E,
    [E, ..., K] → (contiguous [E, M, K], leading shape)."""
    lead = tuple(x.shape[:-1])
    if experts:
        return x.reshape(experts, -1, x.shape[-1]).contiguous(), lead
    return x.reshape(-1, x.shape[-1]).contiguous(), lead


def analog_mvm(x: torch.Tensor, w_eff: torch.Tensor, beta: torch.Tensor,
               bound: torch.Tensor | None = None, *,
               lam: float | None = None, in_bits: int = 8, out_bits: int = 8,
               col_off: torch.Tensor | None = None) -> torch.Tensor:
    """Fused DAC-quant → MVM → ADC-quant over any leading batch dims.

    Exactly one of ``bound`` [N] (an explicit ADC bound, as a calibration
    on other weights gives) and ``lam`` (the bound ``lam · β ·
    max|w_eff[:, n]|`` folded into the kernel's pass over ``w_eff``).
    ``col_off`` [N] is the optional per-column pre-ADC offset. A batched
    (MoE) site has ``w_eff`` [E, K, N], ``x`` [E, ..., K] and ``bound`` /
    ``col_off`` [E, N]: one launch for all experts. No autograd rule; see
    :func:`fused_analog_mvm`.
    """
    experts = w_eff.shape[0] if w_eff.dim() == 3 else 0
    x2, lead = flatten_batch(x.float(), experts)
    n = w_eff.shape[-1]
    y = analog_matmul(x2, w_eff.float().contiguous(), beta.float(),
                      None if bound is None else bound.float().contiguous(),
                      None if col_off is None
                      else col_off.float().contiguous(),
                      lam=lam, in_bits=in_bits, out_bits=out_bits,
                      plan_shape=_plan_shape(),
                      plan_rows=_plan_rows(x2.shape[-2]))
    return y.reshape(*lead, n)


class _FusedAnalogMVM(torch.autograd.Function):
    """Fused forward on ``w + w_noise``, unfused STE backward (see
    :func:`fused_analog_mvm`)."""

    @staticmethod
    def forward(ctx, x, w, w_noise, beta, bound, lam, in_bits, out_bits):
        ctx.save_for_backward(x, w, beta)
        ctx.in_bits = in_bits
        w_eff = w if w_noise is None else w + w_noise
        return analog_mvm(x, w_eff, beta, bound, lam=lam, in_bits=in_bits,
                          out_bits=out_bits)

    @staticmethod
    def backward(ctx, g):
        # the reference's _fused_bwd: x_q = input_quantize(x, beta), then
        # noisy_matmul(x_q, w, 0); the ADC passes g through untouched
        from repro_torch.core import quant
        from repro_torch.core.analog import noisy_matmul_grads

        x, w, beta = ctx.saved_tensors
        xf = x.float()
        xq, beta_c = quant.input_quantize_fwd(xf, beta.float(), ctx.in_bits)
        dxq, dw = noisy_matmul_grads(xq, w.float(), g.float())
        dx, dbeta = quant.input_quantize_grads(xf, beta_c, xq, dxq)
        return (dx.to(x.dtype), dw.to(w.dtype), None,
                dbeta.to(beta.dtype).reshape(beta.shape), None, None, None,
                None)


def fused_analog_mvm(x: torch.Tensor, w: torch.Tensor,
                     w_noise: torch.Tensor | None, beta: torch.Tensor,
                     bound: torch.Tensor | None = None, *,
                     lam: float | None = None, in_bits: int = 8,
                     out_bits: int = 8) -> torch.Tensor:
    """Differentiable fused analog MVM: ``analog_matmul`` forward on ``w +
    w_noise`` (``w_noise`` None at eval, which spares a copy of the
    weights) against ``bound`` or the bound folded with ``lam`` (see
    :func:`analog_mvm`); plain-torch STE backward against the noise-free
    ``w`` (the reference's ``_fused_bwd``): ``dx`` masked to ``|x| <=
    beta``, ``dw = x_qᵀ g``, the LSQ ``dbeta``, nothing for the noise or
    the (detached) bound. ``lam`` is refused with a ``w_noise``: the fold
    would take the bound from ``w + w_noise``, where the reference takes
    it from the noise-free ``w``, so training on ``w + w_noise`` passes
    the explicit bound ``ref.adc_bound(w, beta, lam)``. Batched expert
    weights ``[E, K, N]`` (``x`` [E, ..., K], ``bound`` [E, N]) run
    forward as one launch; backward each expert's ``dx`` and ``dw`` on its
    own rows, and ``dbeta`` summed over every expert and row (the
    reference's vmaps over experts and sequences sum the shared range's
    gradient so)."""
    if lam is not None and w_noise is not None:
        raise ValueError("fused_analog_mvm cannot fold the ADC bound from "
                         "noisy weights: pass the bound of the noise-free "
                         "weights (ref.adc_bound(w, beta, lam)) with w_noise")
    if w_noise is not None:
        w_noise = w_noise.detach()
    if bound is not None:
        bound = bound.detach()
    return _FusedAnalogMVM.apply(x, w, w_noise, beta, bound, lam,
                                 int(in_bits), int(out_bits))


def can_use_int4(out_dim: int, weight_bits: int) -> bool:
    """Packing is two nibbles per byte: needs 4-bit weights and even N."""
    return weight_bits == 4 and out_dim % 2 == 0


def int4_mvm_packed(x_q: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``x_q @ dequant(w_packed, scale)`` on the packed-int4 kernel.

    ``x_q`` is already DAC-quantized; ``w_packed`` [K, N//2] holds two int4
    nibbles per byte (``core.analog.pack_int4_weights``); ``scale`` the
    per-column dequant scales [N] (any shape of N elements). A batched
    (MoE) site has ``w_packed`` [E, K, N//2], ``x_q`` [E, ..., K] and
    ``scale`` of E·N elements: one launch for all experts. The caller
    applies output quantization.
    """
    experts = w_packed.shape[0] if w_packed.dim() == 3 else 0
    x2, lead = flatten_batch(x_q.float(), experts)
    n = w_packed.shape[-1] * 2
    y = int4_matmul(x2, w_packed.contiguous(),
                    scale.reshape(tuple(w_packed.shape[:-2]) + (n,))
                    .float().contiguous(), plan_shape=_plan_shape())
    return y.reshape(*lead, n)


def int4_mvm(x_q: torch.Tensor, w_int: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """:func:`int4_mvm_packed` with on-the-fly packing of the int8-carrier
    RTN output ``w_int`` [K, N] or [E, K, N] (N even)."""
    return int4_mvm_packed(x_q, ref.pack_int4(w_int), scale)


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, tbl: torch.Tensor,
                           pos: torch.Tensor, start: torch.Tensor,
                           scale: float, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           num_splits: int = 1) -> torch.Tensor:
    """One paged GQA decode step: q [B, H, hd] against the block pool
    ``kp`` / ``vp`` [P, bs, KV, hd] through ``tbl`` [B, NB]; row ``b``
    attends ``start[b] <= j <= pos[b]``. ``num_splits`` > 1 splits each
    row's block loop over thread blocks (merged in split order)."""
    return paged_flash_decode(q.contiguous(), kp, vp, tbl, pos, start,
                              scale=scale, k_scale=k_scale, v_scale=v_scale,
                              num_splits=num_splits)


def paged_prefill_attention(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, tbl: torch.Tensor,
                            pos: torch.Tensor, start: torch.Tensor,
                            scale: float, *,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """One paged GQA prefill chunk: q [B, S, H, hd] scored in place
    against the block pool; column ``i`` of row ``b`` attends
    ``start[b] <= j <= pos[b] + i``. The chunk's K/V are already in the
    pool."""
    return paged_flash_prefill(q.contiguous(), kp, vp, tbl, pos, start,
                               scale=scale, k_scale=k_scale,
                               v_scale=v_scale)


class _SSD(torch.autograd.Function):
    """``ssd_scan`` forward; backward through the plain version rebuilt
    from the saved inputs (see :func:`ssd`)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        return ssd_scan(x, dt, a, b, c, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        saved = ctx.saved_tensors
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        outs, grads = [], []
        with torch.enable_grad():
            # the forward's work was counted at its call; its rebuild here
            # is not counted again
            y, h = cost.uncounted(lambda: ref.ssd_scan_ref(*ins))
        for out, g in ((y, g_y), (h, g_h)):
            if g is not None:   # the final state: None where no cache reads it
                outs.append(out)
                grads.append(g)
        if not wanted or not outs:
            return (None,) * len(ins)
        got = iter(torch.autograd.grad(outs, wanted, grads,
                                       allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad
                     else None for t in ins)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor,
        h0: torch.Tensor | None = None):
    """Mamba-2 SSD over x [B, S, H, P] with dt [B, S, H], a [H] and gates
    b / c [B, S, G, N], from the state h0 [B·H, N, P] (None: zero).

    Head ``h`` reads group ``h // (H / G)``: the kernel indexes the group
    and reads every input through its strides, so neither the repeat of
    the gates to heads nor the ``(B, H)`` flattening copies is made on the
    card (the plain version makes both, as the JAX package does). Returns
    (y [B, S, H, P] fp32, final state [B·H, N, P] fp32).

    Differentiable: the forward runs ``ssd_scan`` (the kernel on the card,
    the plain version on the CPU, the shape-only call on the meta device)
    and the backward rebuilds ``ref.ssd_scan_ref`` from the saved inputs
    and differentiates it (with the upstream gradients of y and of the
    final state; the masked entries' ``exp`` is clamped there, so their
    backward is 0, not ``inf · 0``). On every device a train step thus
    runs one path, and a cost counter counts it alike.
    """
    heads, g = x.shape[2], b.shape[2]
    if heads % g:
        raise ValueError(f"{heads} SSD heads are not a multiple of {g} "
                         "groups")
    args = (x.float(), dt.float(), a.float().contiguous(), b.float(),
            c.float(), None if h0 is None else h0.float().contiguous())
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args)):
        return ssd_scan(*args)
    return _SSD.apply(*args)
