"""End-to-end training recipes.

* :func:`distill_recipe`: the analog-FM pipeline (Fig. 7): KD training of
  the HWA student (initialised as a copy of the teacher) on pre-generated
  sequences, the teacher's logits as targets. ``acfg.mode="analog"`` is the
  paper's method, ``"qat"`` LLM-QAT (SI8-W4).
* :func:`pretrain_recipe`: plain CE pre-training (toy teachers, the App. A
  comparison).
* :func:`spinquant_ptq`: SpinQuant-lite PTQ, the paper's SI8-W4 / DI8-W4
  baseline: fold a random-Hadamard rotation into the residual stream,
  calibrate static input ranges on a held-out batch; the weights are
  quantized RTN at eval time (no training).

The training recipes run where the parameters live, or on ``device`` when
it is given; given a placed ``mesh`` (``launch.mesh``), under it: the
train step then runs data-parallel over the ZeRO placement of its state
(``train.train_step.make_train_step``), and the recipe returns the
parameters gathered. A resumed run also restores the loader's position
from the checkpoint, so it consumes the batches the interrupted run would
have. The PTQ recipe runs where the parameters live.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rotations as rot
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.data.loader import TokenLoader
from repro_torch.data.synthetic import teacher_logits
from repro_torch.distributed import placement
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import apply as model_apply
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer


def _on(params: dict, device) -> dict:
    """``params`` with every leaf on ``device`` (shared where it is)."""
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def _clone(params: dict) -> dict:
    """A copy of every leaf (the student's initial weights)."""
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in params.items()}


def _device_of(params: dict, device) -> torch.device:
    """``device`` when given, else the device of the embedding (the audio
    family's codebook table)."""
    if device is not None:
        return torch.device(device)
    return next(iter(params["embed"].values())).device


def _run(params, labels, cfg, acfg, tcfg, loader, make_batch, *,
         num_steps, ckpt_dir, seed, mesh=None) -> Trainer:
    """Build the step and the trainer, resume, and fit ``num_steps`` (under
    ``mesh`` with its default rules when given). The trainer holds the
    only references to the initial parameters and state, so each is freed
    once a step has replaced it (at full width the initial moments alone
    are 12 GB)."""
    def lr_sched(step):
        return polynomial_with_warmup(
            step, peak_lr=tcfg.peak_lr, total_steps=tcfg.total_steps,
            warmup_ratio=tcfg.warmup_ratio)

    step_fn = make_train_step(cfg, acfg, tcfg, labels, lr_sched)
    trainer = Trainer(step_fn, params,
                      init_train_state(params, tcfg.grad_compression),
                      ckpt_dir=ckpt_dir, data_state_fn=loader.state,
                      seed=seed, log_every=max(num_steps // 5, 1),
                      ckpt_every=max(num_steps // 2, 1))
    del params
    under = (contextlib.nullcontext() if mesh is None
             else shd.activate(mesh, shd.default_rules(mesh)))
    with under:
        extra = trainer.try_resume()
        if extra and extra.get("data_state"):
            loader.restore(extra["data_state"])
        trainer.fit((make_batch(raw) for raw in loader), num_steps)
    return trainer


def distill_recipe(teacher_params, labels, cfg, tokens: np.ndarray, *,
                   acfg: AnalogConfig, tcfg: TrainConfig,
                   batch_size: int = 8, num_steps: int = 200,
                   ckpt_dir: Optional[str] = None, seed: int = 0,
                   student_params=None, device=None, mesh=None):
    """HWA-train a student (default: a copy of the teacher) by
    distillation on ``tokens`` [N, S] (synthetic or corpus sequences).
    Returns ``(student_params, trainer)``."""
    dev = _device_of(teacher_params, device)
    teacher_params = _on(teacher_params, dev)
    loader = TokenLoader(tokens, batch_size, seed=seed)

    def make_batch(raw):
        inp = torch.as_tensor(raw[:, :-1], dtype=torch.int64, device=dev)
        return {"tokens": inp,
                "labels": torch.as_tensor(raw[:, 1:], dtype=torch.int64,
                                          device=dev),
                "teacher_logits": teacher_logits(teacher_params, cfg, inp)}

    # the student is built in the call, so that only the trainer holds it
    trainer = _run(_on(student_params, dev) if student_params is not None
                   else _clone(teacher_params), labels, cfg, acfg, tcfg,
                   loader, make_batch, num_steps=num_steps,
                   ckpt_dir=ckpt_dir, seed=seed, mesh=mesh)
    return placement.gather_tree(trainer.params), trainer


def pretrain_recipe(params, labels, cfg, tokens: np.ndarray, *,
                    acfg: AnalogConfig = AnalogConfig(mode="off"),
                    tcfg: Optional[TrainConfig] = None,
                    batch_size: int = 8, num_steps: int = 300,
                    ckpt_dir: Optional[str] = None, seed: int = 0,
                    device=None, mesh=None):
    """CE pre-training (teacher construction, App. A comparisons). Returns
    ``(params, trainer)``."""
    tcfg = tcfg or TrainConfig(peak_lr=3e-3, total_steps=num_steps,
                               kd_beta=0.0, ce_weight=1.0)
    dev = _device_of(params, device)
    params = _on(params, dev)
    loader = TokenLoader(tokens, batch_size, seed=seed)

    def make_batch(raw):
        return {"tokens": torch.as_tensor(raw[:, :-1], dtype=torch.int64,
                                          device=dev),
                "labels": torch.as_tensor(raw[:, 1:], dtype=torch.int64,
                                          device=dev)}

    trainer = _run(params, labels, cfg, acfg, tcfg, loader, make_batch,
                   num_steps=num_steps, ckpt_dir=ckpt_dir, seed=seed,
                   mesh=mesh)
    return placement.gather_tree(trainer.params), trainer


# ---------------------------------------------------------------------------
# SpinQuant-lite PTQ
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_input_ranges(params: dict, cfg, tokens: torch.Tensor,
                           scale: float = 1.0) -> dict:
    """Set every ``input_range`` to ``max(scale * max|x|, 1e-6)`` from one
    calibration forward (``analog`` without training noise, the plain
    path), broadcast to the range's shape: the PTQ static-range
    calibration that the paper (§2) notes tends to do worse than trained
    ranges. A stacked ``[L]`` statistic sets the ``[L, 1]`` ranges of its
    layers; a MoE site's statistic is its experts' mean (``models.moe``).
    Returns a new tree; the other leaves are shared."""
    ctx = AnalogCtx(collect_stats=True)
    _, stats, _ = model_apply(params, cfg,
                              AnalogConfig(mode="analog", train_noise=False),
                              ctx, {"tokens": tokens})

    def walk(p, s):
        out = {}
        for k, v in p.items():
            if (k == "input_range" and isinstance(s, dict)
                    and "x_absmax" in s):
                beta = torch.clamp_min(scale * s["x_absmax"].to(v.device),
                                       1e-6)
                out[k] = torch.broadcast_to(beta[..., None], v.shape
                                            ).to(v.dtype).clone()
            elif isinstance(v, dict):
                out[k] = walk(v, s.get(k) if isinstance(s, dict) else None)
            else:
                out[k] = v
        return out

    return walk(params, stats)


_READERS = ("qkv", "q", "k", "v", "gate_up", "up", "in_proj", "lm_head",
            "router")
_WRITERS = ("o", "down", "out_proj", "projector")


def _rotate_residual_stream(params: dict, cfg, gen: torch.Generator | None,
                            *, r: torch.Tensor | None = None):
    """Fold one random-Hadamard rotation ``R`` (``rotations.
    random_hadamard`` from ``gen``, or ``r`` when given) into every
    residual writer and reader. Returns ``(params, R)``.

    Writers (out-side, ``W R``): the embedding rows, attn ``o``, mlp/moe
    ``down``, mamba ``out_proj``, the vlm projector; a writer's bias is
    rotated too. Readers (in-side, ``Rᵀ W``): attn ``qkv``, mlp/moe
    ``gate_up`` / ``up``, mamba ``in_proj``, ``lm_head`` and the routers.
    A site is matched by its kernel's ``d_model``-wide side, over any
    leading (layer, expert) dims. As in the reference, the norm scales are
    not folded here (see :func:`rotations.fold_norm_scales`).
    """
    d = cfg.d_model
    if r is None:
        r = rot.random_hadamard(gen, d, params["embed"]["tokens"].device)

    def site_of(k, v):
        kern = v["kernel"]
        if k in _READERS and kern.shape[-2] == d:
            return rot.fold_rotation_into_linear(v, r, "in")
        if k in _WRITERS and kern.shape[-1] == d:
            return rot.fold_rotation_into_linear(v, r, "out")
        return v

    def walk(node, path=()):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and "kernel" in v:
                site = site_of(k, v)
                out[k] = {kk: (walk(vv, path + (k, kk))
                               if isinstance(vv, dict) else vv)
                          for kk, vv in site.items()}
            elif k in ("tokens", "codebooks") and path == ("embed",):
                with rot.full_fp32():
                    out[k] = (v.float() @ r).to(v.dtype)
            elif isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            else:
                out[k] = v
        return out

    return walk(params), r


def _apply_rot(kern: torch.Tensor, r: torch.Tensor, side: str
               ) -> torch.Tensor:
    """A kernel ``[..., d_in, d_out]`` times a rotation on its input side
    (``Rᵀ W``) or output side (``W R``), over any leading dims, in full
    fp32 (:func:`rotations.fold_rotation_into_linear` on a bare kernel)."""
    return rot.fold_rotation_into_linear({"kernel": kern}, r, side)["kernel"]


def spinquant_ptq(params: dict, cfg, calib_tokens: torch.Tensor,
                  gen: torch.Generator | None, *, rotate: bool = True,
                  r: torch.Tensor | None = None) -> dict:
    """SpinQuant-lite: the rotation (from ``gen``, or ``r``), then the
    static-range calibration on ``calib_tokens``. Returns params to
    evaluate with ``AnalogConfig(mode="qat" | "di8", weight_bits=4)``
    (fake-quant at eval time; no training)."""
    if rotate:
        params, _ = _rotate_residual_stream(params, cfg, gen, r=r)
    return calibrate_input_ranges(params, cfg, calib_tokens)
