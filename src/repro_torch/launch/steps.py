"""Step builders for the dry run: one (arch × shape × mesh) cell as a step
function, its meta-tensor arguments and their specs.

The counterpart of the JAX package's ``launch/steps.py``. There,
``build_cell`` jits the sharded step and lowers it against
``jax.eval_shape`` stand-ins; here the parameters, the train state and
the inputs are meta tensors (nothing is allocated), each leaf has its spec
under the training rules (``distributed.sharding``: ``zero_spec_tree`` for
the parameters and moments when ``fsdp``), and :meth:`CellPlan.analyze`
runs the step once on the meta device inside the cost counter in place of
``lower()``.

Cell kinds:

* ``train_4k`` → the HWA-KD train step (``train.train_step``) with the
  teacher inside, ``accum_steps`` microbatches, ``remat`` and the
  chunked-vocab loss at 512, the reference's ``TrainConfig`` keywords;
* ``prefill_32k`` → the forward with the last-only LM head filling the
  cache;
* ``decode_32k`` / ``long_500k`` → one token against the statically
  shaped contiguous cache.

The cell's mesh is a mesh by shape, not a placed one, so the step runs
unpartitioned and its count is the whole step's; the specs give each
device's share of the arguments and outputs. The sharded step, and the
gathers and reduce-scatters it reports (``distributed.placement``), run
only on a placed mesh: ``chip_smoke.py`` phase 25 counts them on the
card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import noise as noise_lib
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.distributed import sharding as shd
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.models import input_specs as model_input_specs
from repro_torch.models import transformer as T
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

META = torch.device("meta")


@dataclasses.dataclass
class CellPlan:
    """Everything one cell's dry run needs: the step, its meta arguments,
    their specs and the specs of what it returns."""

    fn: Callable
    args: tuple
    meta: dict
    mesh: Any
    rules: dict
    arg_specs: tuple
    out_specs: Callable         # the step's outputs → their spec tree

    def analyze(self) -> tuple[dict, Any]:
        """Run the step once on the meta device inside the cost counter
        (the reference's ``lower()``). Returns ``(analysis, outputs)``."""
        with shd.activate(self.mesh, self.rules), CostCounter() as cc:
            out = self.fn(*self.args)
        return cc.analyze(), out


def _batch_axes_size(mesh) -> int:
    """Devices along the batch's mesh axes (``data`` and ``pod``)."""
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def _batch_specs(tree) -> Any:
    """Each input leaf on the batch axis (guarded); a host leaf on ()."""
    if isinstance(tree, dict):
        return {k: _batch_specs(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return shd.batch_spec_for(tuple(tree.shape))
    return ()


def _micro_specs(batch: dict) -> dict:
    """A microbatched leaf [A, mb, ...]: the accumulation axis whole, the
    batch axis on ``mb``."""
    return {k: (None,) + shd.batch_spec_for(tuple(v.shape[1:]))
            for k, v in batch.items()}


def build_cell(arch: str, shape_name: str, mesh, *,
               acfg: AnalogConfig = AnalogConfig(mode="analog"),
               accum_steps: int = 4, dtype=torch.bfloat16,
               loss: str = "kd", fsdp: bool = True,
               rules_override: dict | None = None,
               tcfg_overrides: dict | None = None,
               arch_overrides: dict | None = None) -> CellPlan:
    """The step, meta arguments and specs of one grid cell."""
    cfg = get_config(arch)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    shape = SHAPES[shape_name]
    bsz = shape.global_batch
    batch_shardable = bsz % _batch_axes_size(mesh) == 0
    rules = shd.default_rules(mesh, batch_shardable=batch_shardable,
                              seq_shard_kv=not batch_shardable)
    if rules_override:
        rules.update(rules_override)

    with shd.activate(mesh, rules):
        params, labels = T.init_model(None, cfg, dtype, META)
        p_specs = (shd.zero_spec_tree(params) if fsdp
                   else shd.param_spec_tree(params))
        ispecs = model_input_specs(cfg, shape, dtype)

        if shape.kind == "train":
            tkw = dict(total_steps=10_000, accum_steps=accum_steps,
                       kd_beta=1.0 if loss == "kd" else 0.0,
                       ce_weight=0.0 if loss == "kd" else 1.0,
                       remat=True, vocab_chunk=512)
            tkw.update(tcfg_overrides or {})
            tcfg = TrainConfig(**tkw)
            lr_sched = functools.partial(polynomial_with_warmup,
                                         peak_lr=1e-5, total_steps=10_000)
            step = make_train_step(cfg, acfg, tcfg, labels, lr_sched)
            state = init_train_state(params)
            moment_specs = shd.zero_spec_tree(params)
            s_specs = {"step": (), "opt": {"m": moment_specs,
                                           "v": moment_specs,
                                           "count": ()}}
            mb = bsz // accum_steps

            def micro(t):
                return torch.empty((accum_steps, mb) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=META)
            batch = {k: micro(ispecs[k]) for k in
                     ("tokens", "labels", "patch_embeds") if k in ispecs}
            b_specs = _micro_specs(batch)
            key = noise_lib.prng_key(0)
            if loss == "kd":
                args = (params, state, batch, key, params)
                arg_specs = (p_specs, s_specs, b_specs, (), p_specs)
            else:
                args = (params, state, batch, key)
                arg_specs = (p_specs, s_specs, b_specs, ())

            def train_out_specs(out):
                return (p_specs, s_specs, {k: () for k in out[2]})
            return CellPlan(step, args, _meta(cfg, shape, mesh,
                                              "train_step"),
                            mesh, rules, arg_specs, train_out_specs)

        if shape.kind == "prefill":
            def prefill_fn(params, tokens, extra):
                caches = T.init_caches(cfg, bsz, shape.seq_len, dtype, META)
                inputs = {"tokens": tokens, **extra}
                logits, _, caches = T.forward(params, cfg, acfg, AnalogCtx(),
                                              inputs, caches=caches,
                                              last_only=True)
                return logits, caches

            extra = ({"patch_embeds": ispecs["patch_embeds"]}
                     if "patch_embeds" in ispecs else {})
            args = (params, ispecs["tokens"], extra)
            arg_specs = (p_specs, shd.batch_spec_for(
                tuple(ispecs["tokens"].shape)), _batch_specs(extra))

            def prefill_out_specs(out):
                return (shd.batch_spec_for(tuple(out[0].shape)),
                        shd.cache_spec_tree(out[1]))
            return CellPlan(prefill_fn, args, _meta(cfg, shape, mesh,
                                                    "prefill"),
                            mesh, rules, arg_specs, prefill_out_specs)

        def serve_fn(params, token, caches, pos):
            logits, _, caches = T.forward(params, cfg, acfg, AnalogCtx(),
                                          {"tokens": token}, caches=caches,
                                          pos_offset=pos)
            return logits[:, 0], caches

        c_specs = shd.cache_spec_tree(ispecs["caches"])
        args = (params, ispecs["token"], ispecs["caches"], ispecs["pos"])
        arg_specs = (p_specs, shd.batch_spec_for(
            tuple(ispecs["token"].shape)), c_specs, ())

        def serve_out_specs(out):
            return (shd.batch_spec_for(tuple(out[0].shape)),
                    shd.cache_spec_tree(out[1]))
        return CellPlan(serve_fn, args, _meta(cfg, shape, mesh,
                                              "serve_step"),
                        mesh, rules, arg_specs, serve_out_specs)


def device_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree`` under ``specs`` (a tensor leaf's
    shard, nothing for a host leaf)."""
    if isinstance(tree, dict):
        return sum(device_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(device_bytes(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return shd.shard_bytes(tree, specs, mesh)
    return 0


def _meta(cfg, shape, mesh, kind) -> dict:
    """One cell's static record (arch, shape, kind, mesh, family)."""
    return {"arch": cfg.name, "shape": shape.name, "kind": kind,
            "mesh": dict(mesh.shape), "family": cfg.family}
