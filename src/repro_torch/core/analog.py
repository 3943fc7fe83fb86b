"""The analog linear layer, the paper's contribution, as a PyTorch op.

``analog_linear`` is the one entry point every projection of every model
goes through. By :attr:`AnalogConfig.mode` it runs:

* ``off``    — plain dense ``y = x @ w + b``;
* ``analog`` — eq. (1) static DAC quant → MVM → eq. (2) per-column ADC
               quant (the AIMC forward);
* ``qat``    — static input quant + 4-bit per-channel weight fake-quant;
* ``di8``    — dynamic per-token input quant + 4-bit weight fake-quant;
* ``rtn``    — round-to-nearest digital deployment (Table 3).

This port runs the eval/serve forward. The training forward (noise
injection and the STE autograd rules) and the per-tile device state of
``core/devices.py`` come with later slices and are refused here.

Deployment-time programming noise is applied once per model instance by
:func:`perturb_analog_weights`, not inside the forward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core import quant
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
    """Per-call context threaded through the model (``generator`` draws
    training noise; None at eval)."""

    generator: Optional[torch.Generator] = None
    training: bool = False
    collect_stats: bool = False


def empty_stats() -> dict:
    """Zero-valued per-site stats (fixed structure), on the host so that
    no device work is launched for them."""
    return {"x_std": torch.zeros(()), "x_absmax": torch.zeros(()),
            "clip_frac": torch.zeros(())}


# ---------------------------------------------------------------------------
# parameter construction / labeling
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
                use_bias: bool, dtype=torch.float32,
                scale: float | None = None, device=None) -> dict:
    """Initialize one analog-capable linear site: ``kernel`` [in, out],
    ``input_range`` (the eq.-1 DAC range beta, shape (1,)), and ``bias``."""
    if scale is None:
        scale = in_dim ** -0.5
    kernel = torch.randn((in_dim, out_dim), generator=gen, device=device,
                         dtype=torch.float32) * scale
    p = {"kernel": kernel.to(dtype),
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

def analog_linear(p: dict, x: torch.Tensor, cfg: AnalogConfig,
                  ctx: AnalogCtx) -> tuple[torch.Tensor, dict]:
    """Apply one analog/quantized linear at eval. Returns ``(y, stats)``."""
    if ctx.training:
        raise NotImplementedError(
            "the training forward of analog_linear (noise injection and the "
            "STE autograd rules) belongs to the HWA training slice")
    w = p["kernel"]
    in_dtype = x.dtype
    stats = empty_stats()

    if cfg.mode == "off":
        y = torch.matmul(x, w.to(in_dtype)).to(in_dtype)
        if "bias" in p:
            y = y + p["bias"].to(in_dtype)
        return y, stats

    # ---- input (DAC) side ----------------------------------------------
    fused = dispatch.use_fused(cfg)
    if cfg.mode in ("analog", "qat", "rtn"):
        beta = p["input_range"].reshape(()).float()
        xf = x.float()
        if ctx.collect_stats:
            stats = {"x_std": torch.std(xf, correction=0),
                     "x_absmax": torch.amax(torch.abs(xf)),
                     "clip_frac": torch.mean((torch.abs(xf) > beta).float())}
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
        if "device" in p:
            raise NotImplementedError(
                "per-tile device state (core/devices.py: drift, faults, "
                "periphery offsets) is ported with the devices slice")
        if fused:  # the kernel folds the ADC bound from wf
            y = dispatch.fused_analog_mvm(
                xf, wf, None, beta, lam=cfg.out_bound,
                in_bits=cfg.input_bits, out_bits=cfg.output_bits)
            adc_done = True
        else:
            y = torch.matmul(x_q, wf)
    elif cfg.mode in ("qat", "di8"):
        w_q = quant.weight_fake_quant(wf, cfg.weight_bits)
        y = torch.matmul(x_q, w_q)
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
                w_int, scale = quant.rtn_quantize(wf, cfg.weight_bits)
                wf = quant.rtn_dequantize(w_int, scale)
                y = dispatch.int4_mvm(x_q, w_int, scale)
        else:
            w_int, scale = quant.rtn_quantize(wf, cfg.weight_bits)
            wf = quant.rtn_dequantize(w_int, scale)
            if fused:  # the kernel folds the ADC bound from wf
                y = dispatch.analog_mvm(xf, wf, beta, lam=cfg.out_bound,
                                        in_bits=cfg.input_bits,
                                        out_bits=cfg.output_bits)
                adc_done = True
            else:
                y = torch.matmul(x_q, wf)

    # ---- output (ADC) side -----------------------------------------------
    if (cfg.output_quant and cfg.mode in ("analog", "rtn")
            and beta is not None and not adc_done):
        if col_max is not None:
            bound = cfg.out_bound * beta * col_max
        else:
            bound = kref.adc_bound(wf, beta, cfg.out_bound)
        y = quant.output_quantize(y, bound, cfg.output_bits)

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


def _per_matrix(w: torch.Tensor, fn) -> torch.Tensor:
    """Apply ``fn`` to each [K, N] matrix of a stacked [..., K, N] leaf."""
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    return torch.stack([fn(m) for m in flat]).reshape(w.shape)


def perturb_analog_weights(params: dict, labels: dict, gen: torch.Generator,
                           model: str, gamma: float = 0.0) -> dict:
    """Simulate one chip programming: perturb every analog weight once
    (``"hw"`` PCM Hermes, ``"gaussian"`` at ``gamma``, or ``"none"``)."""
    if model == "none":
        return params
    return _map_sites(params, labels, lambda w: _per_matrix(
        w, lambda m: noise_lib.apply_eval_noise(gen, m, model, gamma)))


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
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        packed, scale, colmax = [], [], []
        for wk in flat:
            w_int, s = quant.rtn_quantize(wk.float(), bits)
            deq = quant.rtn_dequantize(w_int, s)
            packed.append(kref.pack_int4(w_int))
            scale.append(s[0])
            colmax.append(torch.amax(torch.abs(deq), dim=0))
        lead = tuple(w.shape[:-2])
        return {"packed": torch.stack(packed).reshape(
                    lead + tuple(packed[0].shape)),
                "scale": torch.stack(scale).reshape(lead + (-1,)),
                "colmax": torch.stack(colmax).reshape(lead + (-1,))}

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
