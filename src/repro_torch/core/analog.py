"""The analog linear layer, the paper's contribution, as a PyTorch op.

``analog_linear`` is the one entry point every projection of every model
goes through. By :attr:`AnalogConfig.mode` it runs:

* ``off``    — plain dense ``y = x @ w + b``;
* ``analog`` — eq. (1) static DAC quant → MVM → eq. (2) per-column ADC
               quant (the AIMC forward);
* ``qat``    — static input quant + 4-bit per-channel weight fake-quant;
* ``di8``    — dynamic per-token input quant + 4-bit weight fake-quant;
* ``rtn``    — round-to-nearest digital deployment (Table 3).

With ``AnalogCtx.training`` it runs the hardware-aware training forward
(paper §3.1, Fig. 2b): ``analog`` draws the eq. (3) weight noise per call
from the context's key and runs DAC quant → MVM on ``w + w_noise`` → ADC
quant against the bound of the noise-free weights, with the reference's
gradients: the clamp-STE / LSQ rules of ``quant.input_quantize``, the
noise-free backward of :func:`noisy_matmul`, and a pure STE through the
ADC. ``qat`` / ``di8`` train through STE fake quantizers; ``rtn`` is
eval-only, as in the reference.

At eval an ``analog`` site that carries a ``"device"`` sub-dict
(``core/devices.py``: per-tile drift, faults and periphery offsets) runs
on ``devices.corrupt_weights``' effective weights and per-column offset,
against the ADC bound of its pristine weights, fused (one
``analog_matmul`` launch with ``col_off``) or unfused; training, like the
reference, and the ``rtn`` / ``qat`` / ``di8`` modes ignore the sub-dict.

A site's kernel may carry a leading expert dimension (``[E, K, N]``, the
MoE's batched experts, with ``x`` ``[E, ..., K]``): every per-channel
range, ADC bound, int4 carrier and training-noise scale is then per
expert, over its own K (the reference's vmap over experts), the fused
kernels take the experts in one launch, and the backward gives each
expert its own ``dw`` while the experts' shared input range sums its
gradient over every expert and row.

Deployment-time programming noise is applied once per model instance by
:func:`perturb_analog_weights`, not inside the forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch

from repro_torch.core import devices as devices_lib
from repro_torch.core import noise as noise_lib
from repro_torch.core import quant
from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    """Static configuration of the analog/quantized execution mode.

    The fields and their meaning are the reference's
    (``repro.core.analog.AnalogConfig``; see ``docs/noise.md``):
    ``mode`` (off | analog | qat | di8 | rtn), DAC ``input_bits``, ADC
    ``output_bits``, ``weight_bits`` of the qat/di8/rtn baselines,
    training-noise ``gamma_weight`` / ``beta_mult`` (eqs. 3/5), the global
    ADC range ``out_bound`` (λ_adc), ``output_quant`` (O8 on/off), clipping
    ``alpha_clip`` (eq. 4), the input-range init and decay rules
    (``kappa_init``, ``init_steps``, ``range_decay``,
    ``input_min_percentage``), ``train_noise``, and the serving knobs
    ``kv_bits`` / ``kv_splits`` of the paged cache.

    ``use_pallas`` keeps its name so configs carry across: here it selects
    the hand-written CUDA kernels (``kernels/csrc``) for the ``analog`` /
    ``rtn`` MVMs, one fused DAC → MVM → ADC tile op, and with
    ``int4_serve`` the packed-int4 kernel for ``rtn`` serving.
    """

    mode: str = "off"                  # off | analog | qat | di8 | rtn
    input_bits: int = 8
    output_bits: int = 8
    weight_bits: int = 4               # qat / di8 / rtn modes
    gamma_weight: float = 0.02         # eq. (3) training-noise magnitude
    beta_mult: float = 0.0             # eq. (5) multiplicative component
    out_bound: float = 12.0            # lambda_adc (global; 12 Phi-3, 14 Llama)
    output_quant: bool = True          # O8 on/off (ablation Table 11)
    alpha_clip: float = 3.0            # eq. (4) clip strength
    kappa_init: float = 15.0           # EMA-init multiplier (15 Phi-3, 18 Llama)
    init_steps: int = 500              # EMA-init phase length
    range_decay: float = 0.01          # input-range decay (AIHWKIT-Lightning)
    input_min_percentage: float = 0.95
    train_noise: bool = True           # noise-injection on/off (ablation C.2)
    use_pallas: bool = False           # hand-written CUDA kernels
    int4_serve: bool = False           # rtn serving: packed-int4 weight kernel
    kv_bits: int = 0                   # paged KV cache: 0 = cache dtype, 8 = int8
    kv_splits: int = 1                 # paged flash-decode split-K factor

    @property
    def is_analog(self) -> bool:
        """True in the paper's AIMC execution mode."""
        return self.mode == "analog"

    @property
    def quantizes_input(self) -> bool:
        """True when the eq. (1) static input quantizer is active."""
        return self.mode in ("analog", "qat")


@dataclasses.dataclass
class AnalogCtx:
    """Per-call context threaded through the model. ``key`` (a
    ``core.noise`` key, None at eval) seeds the training noise: the model
    folds in the layer index and each site's name (:meth:`site`)."""

    key: Optional[tuple] = None
    training: bool = False
    collect_stats: bool = False

    def fold(self, data: int) -> "AnalogCtx":
        """This context with ``data`` (a layer index) folded into its key."""
        if self.key is None:
            return self
        return dataclasses.replace(self, key=noise_lib.fold_in(self.key,
                                                               data))

    def site(self, name: str) -> "AnalogCtx":
        """The context of the analog site ``name`` (its own noise)."""
        return self.fold(noise_lib.site_tag(name))


def empty_stats() -> dict:
    """Zero-valued per-site stats (fixed structure), on the host so that
    no device work is launched for them."""
    return {"x_std": torch.zeros(()), "x_absmax": torch.zeros(()),
            "clip_frac": torch.zeros(())}


_moments = threading.local()


@contextlib.contextmanager
def with_input_means():
    """Inside the block (on this thread) a site's whole-input statistics
    also carry ``x_mean``, which a data-parallel train step needs to
    combine its shards' ``x_std`` into the whole batch's."""
    prev = getattr(_moments, "on", False)
    _moments.on = True
    try:
        yield
    finally:
        _moments.on = prev


@torch.no_grad()
def input_stats(xf: torch.Tensor, beta: torch.Tensor,
                dims=None) -> dict:
    """A site's input statistics over ``dims`` (all of them with None):
    ``x_std`` (population), ``x_absmax`` and ``clip_frac``, the share of
    ``|x| > beta`` (and ``x_mean`` over all of them inside
    :func:`with_input_means`)."""
    clipped = (torch.abs(xf) > beta).float()
    if dims is None:
        out = {"x_std": torch.std(xf, correction=0),
               "x_absmax": torch.amax(torch.abs(xf)),
               "clip_frac": torch.mean(clipped)}
        if getattr(_moments, "on", False):
            out["x_mean"] = torch.mean(xf)
        return out
    return {"x_std": torch.std(xf, dim=dims, correction=0),
            "x_absmax": torch.amax(torch.abs(xf), dim=dims),
            "clip_frac": torch.mean(clipped, dim=dims)}


# ---------------------------------------------------------------------------
# matmul with a noise-free backward (paper: "During the backward pass, the
# noise-free weights are used.")
# ---------------------------------------------------------------------------

def noisy_matmul_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The reference's ``_noisy_matmul_bwd``: ``dx = g wᵀ`` and ``dw = xᵀ
    g`` over the flattened rows, both in fp32 against the noise-free
    ``w``. A batched site (``w`` [E, K, N], ``x`` [E, ..., K]) takes each
    expert's products on its own rows: ``dx[e] = g[e] w[e]ᵀ`` and ``dw[e]
    = x[e]ᵀ g[e]`` over its ``[rows, ·]`` (the reference's vmap over
    experts)."""
    in_dim, out_dim = w.shape[-2], w.shape[-1]
    lead = (w.shape[0],) if w.dim() == 3 else ()
    g32 = g.float().reshape(lead + (-1, out_dim))
    dx = torch.matmul(g32, w.float().transpose(-1, -2))
    dw = torch.matmul(x.float().reshape(lead + (-1, in_dim)).transpose(-1, -2),
                      g32)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


class _NoisyMatmul(torch.autograd.Function):
    """``x @ (w + w_noise)`` forward, ``x @ w`` backward (a batched ``w``
    [E, K, N] takes ``x`` [E, ..., K], each expert its own rows)."""

    @staticmethod
    def forward(ctx, x, w, w_noise):
        ctx.save_for_backward(x, w)
        w_eff = w if w_noise is None else w + w_noise
        if w.dim() == 3:
            y = kref.site_matmul(x.reshape(w.shape[0], -1, x.shape[-1]),
                                 w_eff)
            return y.reshape(x.shape[:-1] + (w.shape[-1],))
        return kref.site_matmul(x, w_eff)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = noisy_matmul_grads(x, w, g)
        return dx, dw, None


def noisy_matmul(x: torch.Tensor, w: torch.Tensor,
                 w_noise: torch.Tensor | None) -> torch.Tensor:
    """``x @ (w + w_noise)`` (``w_noise`` None: zero, and no copy of the
    weights) whose backward differentiates ``x @ w``; the noise gets no
    gradient."""
    return _NoisyMatmul.apply(x, w, w_noise)


# ---------------------------------------------------------------------------
# parameter construction / labeling
# ---------------------------------------------------------------------------

def scaled_randn(gen: torch.Generator | None, shape, scale: float,
                 dtype=torch.float32, device=None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``(randn(shape) * scale).to(dtype)``, drawn in fp32 from ``gen``.
    With ``out`` the result is written there and returned: an fp32 ``out``
    is drawn into directly, with no temporary (``randn(out=)`` draws what
    ``randn`` draws), which is how a stacked parameter tree is filled
    layer by layer without a second copy of a leaf."""
    if out is None:
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    if out.dtype == torch.float32:
        torch.randn(shape, generator=gen, dtype=torch.float32, out=out)
        return out.mul_(scale)
    return out.copy_(scaled_randn(gen, shape, scale, device=out.device))


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                use_bias: bool, dtype=torch.float32,
                scale: float | None = None, device=None,
                out: dict | None = None) -> dict:
    """Initialize one analog-capable linear site: ``kernel`` [in, out],
    ``input_range`` (the eq.-1 DAC range beta, shape (1,)), and ``bias``.
    ``out`` (a site dict of preallocated leaves) receives the kernel in
    place (:func:`scaled_randn`)."""
    if scale is None:
        scale = in_dim ** -0.5
    kernel = scaled_randn(gen, (in_dim, out_dim), scale, dtype, device,
                          None if out is None else out["kernel"])
    p = {"kernel": kernel,
         "input_range": torch.full((1,), 3.0, device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def linear_labels(p: dict) -> dict:
    """Label tree for one linear site (drives clipping/optimizer policy)."""
    lab = {"kernel": "analog_weight", "input_range": "input_range"}
    if "bias" in p:
        lab["bias"] = "digital"
    return lab


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _per_expert(v: torch.Tensor) -> torch.Tensor:
    """A per-column vector for the rows of a site's output: [N] as it is,
    a batched site's [E, N] as [E, 1, N] (each expert's columns, every
    row)."""
    return v.unsqueeze(-2) if v.dim() > 1 else v


def analog_linear(p: dict, x: torch.Tensor, cfg: AnalogConfig,
                  ctx: AnalogCtx) -> tuple[torch.Tensor, dict]:
    """Apply one analog/quantized linear. Returns ``(y, stats)``; with
    ``ctx.collect_stats`` the stats (``x_std``, ``x_absmax``,
    ``clip_frac``, detached, on the input's device) feed the input-range
    rules the train step applies after each update.

    A tensor-parallel site (its kernel a ``distributed.sharding.Shards``)
    runs once per shard on its columns or experts and is gathered
    (``sharding.parallel_linear``); a shard's site dict carries ``cols``
    ``(first column, site width)`` where its device state stayed whole."""
    w = p["kernel"]
    if isinstance(w, sharding.Shards):
        return sharding.parallel_linear(analog_linear, p, x, cfg, ctx)
    in_dtype = x.dtype
    stats = empty_stats()
    if ctx.training and cfg.mode == "rtn":
        raise NotImplementedError(
            "mode 'rtn' is the Table-3 digital deployment: eval/serve only, "
            "as in the reference (no training rules)")

    if cfg.mode == "off":
        y = kref.site_matmul(x, w.to(in_dtype)).to(in_dtype)
        if "bias" in p:
            y = y + p["bias"].to(in_dtype)
        return y, stats

    # ---- input (DAC) side ----------------------------------------------
    fused = dispatch.use_fused(cfg)
    if cfg.mode in ("analog", "qat", "rtn"):
        beta = p["input_range"].reshape(()).float()
        xf = x.float()
        if ctx.collect_stats:
            stats = input_stats(xf, beta)
        # the fused tile op quantizes inside the kernel
        x_q = None if fused else quant.input_quantize(xf, beta,
                                                      cfg.input_bits)
    else:  # di8: dynamic per-token ranges (SpinQuant baseline)
        x_q = quant.dynamic_input_quantize(x.float(), cfg.input_bits)
        beta = None
        fused = False

    # ---- weight side + MVM ------------------------------------------------
    wf = w.float()
    adc_done = False
    col_max = None                 # precomputed per-column absmax (int4 path)
    if cfg.mode == "analog":
        w_noise = None
        if ctx.training and cfg.train_noise and ctx.key is not None:
            # each column's scale over its own K: per expert on [E, K, N]
            with torch.no_grad():
                w_noise = noise_lib.gaussian_weight_noise(
                    noise_lib.key_generator(ctx.key, wf.device), wf,
                    cfg.gamma_weight, cfg.beta_mult, axis=-2)
        dev = p.get("device") if not ctx.training else None
        if dev is not None:
            # per-tile device path (eval and serving only): both paths run
            # on the same corrupted weights and offsets, against the ADC
            # bound of the pristine weights (the ADC range is set at
            # programming time and does not track drift)
            with torch.no_grad():       # kref.adc_bound, its colmax kept
                colmax = kref.abs_max(wf, -2)
                bound = cfg.out_bound * beta * colmax
                w_dev, col_off = devices_lib.corrupt_weights(
                    wf, dev, bound, colmax, cols=p.get("cols"))
            if fused:
                y = dispatch.analog_mvm(xf, w_dev, beta, bound,
                                        in_bits=cfg.input_bits,
                                        out_bits=cfg.output_bits,
                                        col_off=col_off)
            else:
                if x_q is None:
                    x_q = quant.input_quantize(xf, beta, cfg.input_bits)
                y = noisy_matmul(x_q, w_dev, None) + _per_expert(col_off)
                if cfg.output_quant:
                    y = quant.output_quantize(y, _per_expert(bound),
                                              cfg.output_bits)
            adc_done = True
        elif fused and w_noise is None:  # the kernel folds the bound from wf
            y = dispatch.fused_analog_mvm(
                xf, wf, None, beta, lam=cfg.out_bound,
                in_bits=cfg.input_bits, out_bits=cfg.output_bits)
            adc_done = True
        elif fused:  # the bound of the noise-free weights, given
            bound = kref.adc_bound(wf.detach(), beta.detach(),
                                   cfg.out_bound)
            y = dispatch.fused_analog_mvm(
                xf, wf, w_noise, beta, bound,
                in_bits=cfg.input_bits, out_bits=cfg.output_bits)
            adc_done = True
        else:
            y = noisy_matmul(x_q, wf, w_noise)
    elif cfg.mode in ("qat", "di8"):
        w_q = quant.weight_fake_quant(wf, cfg.weight_bits, axis=-2)
        y = kref.site_matmul(x_q, w_q)
    else:  # rtn
        use_int4 = (cfg.use_pallas and cfg.int4_serve
                    and dispatch.can_use_int4(w.shape[-1], cfg.weight_bits))
        if use_int4:
            # DAC/ADC stay in the digital periphery, outside this kernel
            if x_q is None:
                x_q = quant.input_quantize(xf, beta, cfg.input_bits)
            if "int4" in p:   # precomputed once by pack_int4_weights
                y = dispatch.int4_mvm_packed(
                    x_q, p["int4"]["packed"], p["int4"]["scale"])
                col_max = p["int4"]["colmax"]
            else:             # quantize + pack per call
                w_int, scale = quant.rtn_quantize(wf, cfg.weight_bits,
                                                  axis=-2)
                wf = quant.rtn_dequantize(w_int, scale)
                y = dispatch.int4_mvm(x_q, w_int, scale)
        else:
            w_int, scale = quant.rtn_quantize(wf, cfg.weight_bits, axis=-2)
            wf = quant.rtn_dequantize(w_int, scale)
            if fused:  # the kernel folds the ADC bound from wf
                y = dispatch.analog_mvm(xf, wf, beta, lam=cfg.out_bound,
                                        in_bits=cfg.input_bits,
                                        out_bits=cfg.output_bits)
                adc_done = True
            else:
                y = kref.site_matmul(x_q, wf)

    # ---- output (ADC) side -----------------------------------------------
    if (cfg.output_quant and cfg.mode in ("analog", "rtn")
            and beta is not None and not adc_done):
        if col_max is not None:
            bound = cfg.out_bound * beta * col_max
        else:
            bound = kref.adc_bound(wf, beta, cfg.out_bound)
        y = quant.output_quantize(y, _per_expert(bound).detach(),
                                  cfg.output_bits)

    y = y.to(in_dtype)
    if "bias" in p:  # bias added in the digital periphery
        y = y + p["bias"].to(in_dtype)
    return y, stats


# ---------------------------------------------------------------------------
# deployment-time weight transforms
# ---------------------------------------------------------------------------

def _map_sites(params: dict, labels: dict,
               fn: Callable[[torch.Tensor], torch.Tensor]) -> dict:
    """New tree with ``fn`` applied to every ``analog_weight`` leaf (keys
    walked in sorted order, like a JAX pytree); other leaves are shared."""
    out = {}
    for k in sorted(params):
        v, lab = params[k], labels[k]
        if isinstance(v, dict):
            out[k] = _map_sites(v, lab, fn)
        else:
            out[k] = fn(v) if lab == "analog_weight" else v
    return out


def _per_matrix(w: torch.Tensor, fn, inplace: bool = False) -> torch.Tensor:
    """Apply ``fn`` to each [K, N] matrix of a stacked [..., K, N] leaf,
    matrix by matrix into a new leaf (or into ``w`` itself with
    ``inplace``), so the only temporaries are one matrix's."""
    out = w if inplace else torch.empty_like(w)
    src = w.reshape((-1,) + tuple(w.shape[-2:]))
    dst = out.view((-1,) + tuple(w.shape[-2:]))
    for m, o in zip(src, dst):
        o.copy_(fn(m))
    return out


def perturb_analog_weights(params: dict, labels: dict, gen: torch.Generator,
                           model: str, gamma: float = 0.0,
                           inplace: bool = False) -> dict:
    """Simulate one chip programming: perturb every analog weight once
    (``"hw"`` PCM Hermes, ``"gaussian"`` at ``gamma``, or ``"none"``).
    ``inplace`` overwrites the weights of ``params`` (the returned tree
    shares them): the model's one copy, for models whose second copy would
    not fit the card. It runs before ``devices.attach_device_state`` and
    refuses a tree with device state, as the reference does."""
    if model == "none":
        return params
    if devices_lib.has_device_state(params):
        raise ValueError("perturb_analog_weights runs before "
                         "attach_device_state: this tree already carries "
                         "device state")
    return _map_sites(params, labels, lambda w: _per_matrix(
        w, lambda m: noise_lib.apply_eval_noise(gen, m, model, gamma),
        inplace))


def sample_noise_instances(params: dict, labels: dict, gen: torch.Generator,
                           model: str) -> dict:
    """One deployment's unit noise instance per analog weight, zeros at the
    other leaves (see :func:`apply_noise_instances`)."""
    def inst(w):
        if model == "none":
            return torch.zeros_like(w)
        return _per_matrix(
            w, lambda m: noise_lib.sample_noise_instance(gen, m, model))

    return _zero_others(_map_sites(params, labels, inst), labels)


def _zero_others(tree: dict, labels: dict) -> dict:
    """Replace every non-``analog_weight`` leaf by zeros of its shape."""
    return {k: (_zero_others(v, labels[k]) if isinstance(v, dict)
                else v if labels[k] == "analog_weight"
                else torch.zeros_like(v))
            for k, v in tree.items()}


def apply_noise_instances(params: dict, labels: dict, instances: dict,
                          model: str, gamma: float = 0.0) -> dict:
    """Perturb analog weights with a pre-sampled noise instance: ``w + inst``
    for ``"hw"``, ``w + gamma * inst`` for ``"gaussian"``."""
    if model == "none":
        return params
    noise_lib.validate_noise_config(model, gamma)
    scale = gamma if model == "gaussian" else 1.0

    def walk(p, lab, inst):
        return {k: (walk(p[k], lab[k], inst[k]) if isinstance(p[k], dict)
                    else p[k] + scale * inst[k]
                    if lab[k] == "analog_weight" else p[k])
                for k in p}

    return walk(params, labels, instances)


def pack_int4_weights(params: dict, labels: dict | None = None,
                      bits: int = 4) -> dict:
    """Serving-side transform: attach the packed-int4 carriers.

    Every analog linear site with an even output width gets an ``"int4"``
    sub-dict: ``packed`` [.., K, N//2] uint8, ``scale`` [.., N] per-column
    dequant scales, ``colmax`` [.., N] per-column absmax of the dequantized
    weights (so the ADC bound matches the unfused RTN path). With
    ``labels=None`` a site is any dict holding ``kernel`` and
    ``input_range``. Stacked [L, K, N] weights keep their leading dims.
    """
    def pack_site(w):
        # filled matrix by matrix into preallocated carriers
        k, n = w.shape[-2:]
        lead = tuple(w.shape[:-2])
        out = {"packed": torch.empty(lead + (k, n // 2), dtype=torch.uint8,
                                     device=w.device),
               "scale": torch.empty(lead + (n,), device=w.device),
               "colmax": torch.empty(lead + (n,), device=w.device)}
        views = [out[key].view((-1,) + tuple(out[key].shape[len(lead):]))
                 for key in ("packed", "scale", "colmax")]
        for wk, pk, sc, cm in zip(w.reshape(-1, k, n), *views):
            w_int, s = quant.rtn_quantize(wk.float(), bits)
            deq = quant.rtn_dequantize(w_int, s)
            pk.copy_(kref.pack_int4(w_int))
            sc.copy_(s[0])
            cm.copy_(torch.amax(torch.abs(deq), dim=0))
        return out

    def walk(p, lab):
        if not isinstance(p, dict):
            return p
        out = {k: walk(p[k], lab[k] if lab is not None else None) for k in p}
        if lab is not None:
            is_site = (isinstance(lab, dict)
                       and lab.get("kernel") == "analog_weight")
        else:
            is_site = "kernel" in p and "input_range" in p
        if is_site and p["kernel"].shape[-1] % 2 == 0:
            out["int4"] = pack_site(p["kernel"])
        return out

    return walk(params, labels)


def quantize_for_digital(params: dict, labels: dict, bits: int = 4) -> dict:
    """Table-3 path: RTN-quantize every analog weight (dequantized float
    carrier)."""
    def q(w):
        return _per_matrix(w, lambda m: quant.rtn_dequantize(
            *quant.rtn_quantize(m, bits)).to(w.dtype))

    return _map_sites(params, labels, q)
