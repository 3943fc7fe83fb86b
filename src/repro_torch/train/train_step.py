"""The HWA training step (paper Fig. 7, stage 2).

One step:

1. forward in analog mode (eq. 1 input quant, eq. 3 noise, eq. 2 ADC quant)
   under a fresh noise key per step (and per microbatch), collecting each
   site's input statistics;
2. loss = KD(teacher ‖ student) (+ the optional CE mix and MoE aux loss);
3. gradients → optional int8 error-feedback compression → AdamW;
4. the input-range rules: EMA init for the first ``init_steps`` steps, the
   multiplicative decay after (AIHWKIT-Lightning);
5. eq. (4): per-channel clipping of every analog weight.

The step is functional, as the reference's: it takes ``(params, state,
batch, key)`` and returns new trees, leaving its inputs as they were (the
trainer drops an update whose loss is not finite). Its parameters become
leaves that require grad only inside the step. ``key`` is a
``core.noise`` key: the step folds in its step count, each microbatch its
index, each layer its index and each site its name, so noise is a function
of (seed, step, microbatch, layer, site), the same in a layer's
recomputation under ``remat`` and after a resume.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.checkpoint import flatten_paths, unflatten_paths
from repro_torch.core import clipping
from repro_torch.core import noise as noise_lib
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.core.quant import ema_init_update, range_decay_update
from repro_torch.kernels.ref import div
from repro_torch.models import transformer as T
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.distill import ce_loss, kd_loss

#: the teacher's forward: digital, noiseless
_OFF = AnalogConfig(mode="off")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Distillation / pre-training hyperparameters (paper App. B)."""
    peak_lr: float = 1e-4
    total_steps: int = 1000
    warmup_ratio: float = 0.016
    kd_temperature: float = 1.0
    kd_beta: float = 1.0          # KD weight (paper: 1.0, pure distillation)
    ce_weight: float = 0.0        # CE mix (ablation B.4 only)
    aux_loss_weight: float = 0.01  # MoE load balancing
    accum_steps: int = 1
    grad_compression: bool = False
    #: checkpoint every layer (``transformer.checkpoint``): True / ``'dots'``
    #: keeps the projections' products (the reference's default policy),
    #: ``'nothing'`` recomputes everything, False keeps every activation
    remat: bool | str = True
    #: sequence-chunk size of the chunked-vocab loss (0 = off); active only
    #: when vocab >= 4 x the chunk
    vocab_chunk: int = 0
    #: the reference's sharding hints (parameters gathered once per step,
    #: gradients pinned to the ZeRO layout); without a mesh, as here, they
    #: leave the trees as they are, as the reference's do with no mesh
    pregather_params: bool = False
    shard_grads: bool = False
    #: accumulate the loss over microbatches (each checkpointed) and take
    #: one backward, instead of one backward per microbatch
    fused_accum: bool = False
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(params: dict, grad_compression: bool = False) -> dict:
    """A fresh train state: the step count (int32, host), the Adam moments
    and, with compression, the error-feedback state."""
    state = {"step": torch.zeros((), dtype=torch.int32),
             "opt": init_opt_state(params)}
    if grad_compression:
        state["err"] = compression.init_error_state(params)
    return state


def _collect_aux_losses(stats) -> torch.Tensor:
    """The mean of the ``aux_loss`` entries of the stats (MoE load
    balancing), each itself averaged; 0 for a model without them."""
    total, n = torch.zeros(()), 0

    def walk(node):
        nonlocal total, n
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "aux_loss":
                    total, n = total + torch.mean(v), n + 1
                else:
                    walk(v)
    walk(stats)
    return total / max(n, 1)


def _update_input_ranges(params: dict, stats: dict, step: int,
                         acfg: AnalogConfig) -> dict:
    """EMA init, then decay, on every site's ``input_range``, walking the
    parameters and the (layer-stacked) stats in lockstep; floored at
    1e-6."""
    def walk(p, s):
        if not isinstance(p, dict):
            return p
        out = {}
        for k, v in p.items():
            if k == "input_range":
                if s is None or "x_std" not in s:
                    out[k] = v
                    continue
                beta = v.squeeze(-1)
                x_std = s["x_std"].to(beta.device)
                clip_frac = s["clip_frac"].to(beta.device)
                beta = ema_init_update(beta, x_std, step, acfg.kappa_init,
                                       acfg.init_steps)
                beta = range_decay_update(beta, clip_frac, step,
                                          acfg.range_decay,
                                          acfg.input_min_percentage,
                                          acfg.init_steps)
                out[k] = torch.clamp_min(beta, 1e-6)[..., None]
            else:
                out[k] = walk(v, s.get(k) if isinstance(s, dict) else None)
        return out

    with torch.no_grad():
        return walk(params, stats)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Pad dim 1 of ``t`` with ``n`` zeros at the end."""
    pad = [0, 0] * (t.dim() - 2) + [0, n]
    return F.pad(t, pad)


def _align_vlm_labels(cfg, batch: dict):
    """``(labels, mask)`` of a batch, lined up with the vlm's ``[image ‖
    text]`` sequence: with ``patch_embeds`` and labels, ``vit_tokens``
    zero labels and a zero mask are prepended (the mask is all ones over
    the text when the batch has none)."""
    labels, mask = batch.get("labels"), batch.get("mask")
    if "patch_embeds" not in batch or labels is None:
        return labels, mask
    b, dev = labels.shape[0], labels.device
    labels = torch.cat([torch.zeros((b, cfg.vit_tokens), dtype=labels.dtype,
                                    device=dev), labels], dim=1)
    if mask is None:
        mask = torch.ones(batch["labels"].shape[:2], device=dev)
    mask = torch.cat([torch.zeros((b, cfg.vit_tokens), device=dev),
                      mask.float()], dim=1)
    return labels, mask


def make_loss_fn(cfg, acfg: AnalogConfig, tcfg: TrainConfig):
    """The KD / CE loss closure ``(params, batch, key, teacher_params) →
    (loss, (stats, metrics))``, with the chunked-vocab form when
    ``vocab_chunk`` applies. A vlm batch's ``patch_embeds`` go to the
    model (and the teacher) and its labels and mask are lined up with the
    image prefix (:func:`_align_vlm_labels`); an audio batch carries
    tokens and labels ``[B, S, K]``."""

    def loss_fn(params, batch, noise_key, teacher_params=None):
        ctx = AnalogCtx(key=noise_key, training=True, collect_stats=True)
        inputs = {"tokens": batch["tokens"]}
        if "patch_embeds" in batch:
            inputs["patch_embeds"] = batch["patch_embeds"]
        labels, mask = _align_vlm_labels(cfg, batch)
        chunked = (tcfg.vocab_chunk > 0
                   and cfg.vocab_size >= 4 * tcfg.vocab_chunk)
        dev = batch["tokens"].device
        loss = torch.zeros((), device=dev)
        metrics = {}

        if chunked:
            # never materialize [B, S, V]: the LM heads run per sequence
            # chunk, each chunk checkpointed (its logits recomputed in the
            # backward)
            hidden, stats, _ = T.forward(params, cfg, acfg, ctx, inputs,
                                         remat=tcfg.remat,
                                         return_hidden=True)
            t_hidden = None
            if teacher_params is not None and tcfg.kd_beta:
                with torch.no_grad():
                    t_hidden = T.forward(teacher_params, cfg, _OFF,
                                         AnalogCtx(), inputs,
                                         return_hidden=True)[0]
            s = hidden.shape[1]
            ck = min(tcfg.vocab_chunk, s)
            n_chunks = -(-s // ck)
            s_pad = n_chunks * ck
            hidden = _pad_seq(hidden, s_pad - s)
            if t_hidden is not None:
                t_hidden = _pad_seq(t_hidden, s_pad - s)
            if mask is None:
                mask = torch.ones((hidden.shape[0], s), device=dev)
            mask_p = _pad_seq(mask.float(), s_pad - s)
            # audio labels are [B, S, K]: padded on the sequence alone
            labels_p = None if labels is None else _pad_seq(labels,
                                                            s_pad - s)

            def chunk_body(h_c, m_c, th_c, lab_c):
                logits_c, _ = T.apply_lm_head(params, cfg, acfg, ctx, h_c)
                kd_c = torch.zeros((), device=dev)
                if th_c is not None:
                    with torch.no_grad():
                        t_logits_c, _ = T.apply_lm_head(
                            teacher_params, cfg, _OFF, AnalogCtx(), th_c)
                    kd_c = kd_loss(logits_c, t_logits_c,
                                   tcfg.kd_temperature, m_c) * torch.sum(m_c)
                ce_c = torch.zeros((), device=dev)
                if lab_c is not None and tcfg.ce_weight:
                    ce_c = ce_loss(logits_c, lab_c, m_c) * torch.sum(m_c)
                return kd_c, ce_c

            kd_sum = ce_sum = denom = torch.zeros((), device=dev)
            for i in range(n_chunks):
                sl = slice(i * ck, (i + 1) * ck)
                m_c = mask_p[:, sl]
                kd_c, ce_c = torch.utils.checkpoint.checkpoint(
                    chunk_body, hidden[:, sl], m_c,
                    None if t_hidden is None else t_hidden[:, sl],
                    None if labels_p is None else labels_p[:, sl],
                    use_reentrant=False, preserve_rng_state=False)
                kd_sum, ce_sum = kd_sum + kd_c, ce_sum + ce_c
                denom = denom + torch.sum(m_c)
            denom = torch.clamp_min(denom, 1.0)
            if teacher_params is not None and tcfg.kd_beta:
                kd = torch.div(kd_sum, denom)
                loss = loss + tcfg.kd_beta * kd
                metrics["kd"] = kd
            if labels is not None and tcfg.ce_weight:
                ce = torch.div(ce_sum, denom)
                loss = loss + tcfg.ce_weight * ce
                metrics["ce"] = ce
        else:
            logits, stats, _ = T.forward(params, cfg, acfg, ctx, inputs,
                                         remat=tcfg.remat)
            t_logits = batch.get("teacher_logits")
            if t_logits is None and teacher_params is not None:
                with torch.no_grad():
                    t_logits = T.forward(teacher_params, cfg, _OFF,
                                         AnalogCtx(), inputs)[0]
            if tcfg.kd_beta and t_logits is not None:
                kd = kd_loss(logits, t_logits, tcfg.kd_temperature, mask)
                loss = loss + tcfg.kd_beta * kd
                metrics["kd"] = kd
            if tcfg.ce_weight and labels is not None:
                ce = ce_loss(logits, labels, mask)
                loss = loss + tcfg.ce_weight * ce
                metrics["ce"] = ce

        aux = _collect_aux_losses(stats).to(dev)
        loss = loss + tcfg.aux_loss_weight * aux
        metrics["aux"] = aux
        metrics["loss"] = loss
        return loss, (stats, {k: v.detach() for k, v in metrics.items()})
    return loss_fn


def _micro(batch: dict, i: int) -> dict:
    """Microbatch ``i`` of a batch whose leaves lead with the microbatch
    axis."""
    return {k: v[i] for k, v in batch.items()}


def make_train_step(cfg, acfg: AnalogConfig, tcfg: TrainConfig, labels,
                    lr_schedule):
    """Build the train step ``(params, state, batch, key[,
    teacher_params]) → (new_params, new_state, metrics)``.

    ``key`` is a ``core.noise`` key (``noise.prng_key(seed)``); the batch's
    leaves lead with the microbatch axis when ``accum_steps > 1``. Given
    ``teacher_params``, the teacher's forward runs inside the step (the
    reference's production KD path); the unchunked loss takes a batch's
    ``teacher_logits`` in its place where the batch has them.
    ``pregather_params`` and ``shard_grads`` are no-ops: they are
    sharding hints, and training has no mesh (the training half of ROADMAP
    section 1, item 10).
    """
    loss_fn = make_loss_fn(cfg, acfg, tcfg)
    n_acc = tcfg.accum_steps

    def train_step(params, state, batch, key, teacher_params=None):
        step = int(state["step"])
        nkey = noise_lib.fold_in(key, step)
        flat = flatten_paths(params)
        leaves = {p: v.detach().requires_grad_(True)
                  for p, v in flat.items()}
        p_req = unflatten_paths(leaves)

        def grads_of(loss):
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            return [torch.zeros_like(v) if g is None else g
                    for v, g in zip(leaves.values(), gs)]

        if n_acc > 1 and tcfg.fused_accum:
            total = torch.zeros((), device=batch["tokens"].device)
            outs = []
            for i in range(n_acc):
                loss_i, out = torch.utils.checkpoint.checkpoint(
                    loss_fn, p_req, _micro(batch, i),
                    noise_lib.fold_in(nkey, i), teacher_params,
                    use_reentrant=False, preserve_rng_state=False)
                total = total + loss_i
                outs.append(out)
            grads = grads_of(div(total, float(n_acc)))
        elif n_acc > 1:
            grads, outs = None, []
            for i in range(n_acc):
                loss_i, out = loss_fn(p_req, _micro(batch, i),
                                      noise_lib.fold_in(nkey, i),
                                      teacher_params)
                g = grads_of(loss_i)
                grads = g if grads is None else [
                    a + b for a, b in zip(grads, g)]
                outs.append(out)
            grads = [div(g, float(n_acc)) for g in grads]
        else:
            loss_i, out = loss_fn(p_req, batch, nkey, teacher_params)
            grads = grads_of(loss_i)
            outs = [out]
        stats = outs[-1][0]
        metrics = {k: torch.mean(torch.stack([o[1][k] for o in outs]))
                   for k in outs[0][1]}
        grads = unflatten_paths(dict(zip(leaves, grads)))
        del leaves, p_req

        if tcfg.grad_compression:
            grads, new_err = compression.compress_grads(grads, state["err"])
        lr = lr_schedule(step)
        new_params, new_opt, gnorm = adamw_update(
            params, grads, state["opt"], labels, lr, tcfg.adamw)
        del grads
        # the paper's post-step transforms
        new_params = _update_input_ranges(new_params, stats, step, acfg)
        if acfg.is_analog:
            with torch.no_grad():
                new_params = clipping.clip_tree(new_params, labels,
                                                acfg.alpha_clip)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        new_state = dict(state, step=state["step"] + 1, opt=new_opt)
        if tcfg.grad_compression:
            new_state["err"] = new_err
        return new_params, new_state, metrics

    return train_step
