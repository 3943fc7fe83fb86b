"""End-to-end training recipes.

* :func:`distill_recipe`: the analog-FM pipeline (Fig. 7): KD training of
  the HWA student (initialised as a copy of the teacher) on pre-generated
  sequences, the teacher's logits as targets. ``acfg.mode="analog"`` is the
  paper's method, ``"qat"`` LLM-QAT (SI8-W4).
* :func:`pretrain_recipe`: plain CE pre-training (toy teachers, the App. A
  comparison).

Both run where the parameters live, or on ``device`` when it is given. A
resumed run also restores the loader's position from the checkpoint, so it
consumes the batches the interrupted run would have. The reference's PTQ
recipe (``calibrate_input_ranges``, ``spinquant_ptq``) comes with
``core/rotations.py`` (ROADMAP section 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.data.loader import TokenLoader
from repro_torch.data.synthetic import teacher_logits
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
    """``device`` when given, else the device of the embedding."""
    if device is not None:
        return torch.device(device)
    return params["embed"]["tokens"].device


def _run(params, labels, cfg, acfg, tcfg, loader, make_batch, *,
         num_steps, ckpt_dir, seed) -> Trainer:
    """Build the step and the trainer, resume, and fit ``num_steps``. The
    trainer holds the only references to the initial parameters and
    state, so each is freed once a step has replaced it (at full width the
    initial moments alone are 12 GB)."""
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
    extra = trainer.try_resume()
    if extra and extra.get("data_state"):
        loader.restore(extra["data_state"])
    trainer.fit((make_batch(raw) for raw in loader), num_steps)
    return trainer


def distill_recipe(teacher_params, labels, cfg, tokens: np.ndarray, *,
                   acfg: AnalogConfig, tcfg: TrainConfig,
                   batch_size: int = 8, num_steps: int = 200,
                   ckpt_dir: Optional[str] = None, seed: int = 0,
                   student_params=None, device=None):
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
                   ckpt_dir=ckpt_dir, seed=seed)
    return trainer.params, trainer


def pretrain_recipe(params, labels, cfg, tokens: np.ndarray, *,
                    acfg: AnalogConfig = AnalogConfig(mode="off"),
                    tcfg: Optional[TrainConfig] = None,
                    batch_size: int = 8, num_steps: int = 300,
                    ckpt_dir: Optional[str] = None, seed: int = 0,
                    device=None):
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
                   num_steps=num_steps, ckpt_dir=ckpt_dir, seed=seed)
    return trainer.params, trainer
