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

Under an active placed mesh the step runs data-parallel over the ZeRO
placement of its state (``distributed.placement``; see
:func:`make_train_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.checkpoint import flatten_paths, unflatten_paths
from repro_torch.core import clipping
from repro_torch.core import noise as noise_lib
from repro_torch.core import analog as analog_mod
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.core.quant import ema_init_update, range_decay_update
from repro_torch.distributed import placement
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import div
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig, global_norm, init_opt_state
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
    #: gradients pinned to the ZeRO layout); under a placed mesh the step
    #: always does both (:func:`make_train_step`), without one there is
    #: nothing to gather or pin, so they change nothing either way
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
    tokens and labels ``[B, S, K]``.

    ``weights``, ``(token weight, row weight)``, make the loss a data
    shard's part of the whole batch's: its KD and CE terms are scaled by
    its share of the masked tokens and its aux term by its share of the
    rows (the metrics stay the shard's own means)."""

    def loss_fn(params, batch, noise_key, teacher_params=None,
                weights=None):
        w_tok, w_row = weights or (None, None)

        def add(loss, beta, term, w):
            term = beta * term
            return loss + (term if w is None else term * w)
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
                loss = add(loss, tcfg.kd_beta, kd, w_tok)
                metrics["kd"] = kd
            if labels is not None and tcfg.ce_weight:
                ce = torch.div(ce_sum, denom)
                loss = add(loss, tcfg.ce_weight, ce, w_tok)
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
                loss = add(loss, tcfg.kd_beta, kd, w_tok)
                metrics["kd"] = kd
            if tcfg.ce_weight and labels is not None:
                ce = ce_loss(logits, labels, mask)
                loss = add(loss, tcfg.ce_weight, ce, w_tok)
                metrics["ce"] = ce

        aux = _collect_aux_losses(stats).to(dev)
        loss = add(loss, tcfg.aux_loss_weight, aux, w_row)
        metrics["aux"] = aux
        metrics["loss"] = loss
        return loss, (stats, {k: v.detach() for k, v in metrics.items()})
    return loss_fn


def _micro(batch: dict, i: int) -> dict:
    """Microbatch ``i`` of a batch whose leaves lead with the microbatch
    axis."""
    return {k: v[i] for k, v in batch.items()}


def _backward(loss_fn, tcfg: TrainConfig, params: dict, batch: dict, nkey,
              teacher_params, weights=None):
    """The gradients of one batch's loss (every microbatch's, as the
    reference's three accumulation forms run them). Returns ``(paths,
    gradients in path order, [(stats, metrics)] per microbatch)``;
    ``weights`` (one pair per microbatch) scale a data shard's loss terms
    (:func:`make_loss_fn`)."""
    n_acc = tcfg.accum_steps
    flat = flatten_paths(params)
    leaves = {p: v.detach().requires_grad_(True) for p, v in flat.items()}
    p_req = unflatten_paths(leaves)
    w = weights or [None] * n_acc

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
                noise_lib.fold_in(nkey, i), teacher_params, w[i],
                use_reentrant=False, preserve_rng_state=False)
            total = total + loss_i
            outs.append(out)
        grads = grads_of(div(total, float(n_acc)))
    elif n_acc > 1:
        grads, outs = None, []
        for i in range(n_acc):
            loss_i, out = loss_fn(p_req, _micro(batch, i),
                                  noise_lib.fold_in(nkey, i),
                                  teacher_params, w[i])
            g = grads_of(loss_i)
            grads = g if grads is None else [
                a + b for a, b in zip(grads, g)]
            outs.append(out)
        grads = [div(g, float(n_acc)) for g in grads]
    else:
        loss_i, out = loss_fn(p_req, batch, nkey, teacher_params, w[0])
        grads = grads_of(loss_i)
        outs = [out]
    return list(leaves), grads, outs


def _mean_metrics(metrics: list) -> dict:
    """Each metric's mean over the microbatches."""
    return {k: torch.mean(torch.stack([m[k] for m in metrics]))
            for k in metrics[0]}


def _post_step(new_params: dict, stats: dict, step: int, acfg, labels):
    """The paper's post-step transforms: the input-range rules, then eq.
    (4)'s clipping of every analog weight."""
    new_params = _update_input_ranges(new_params, stats, step, acfg)
    if acfg.is_analog:
        with torch.no_grad():
            new_params = clipping.clip_tree(new_params, labels,
                                            acfg.alpha_clip)
    return new_params


# ---------------------------------------------------------------------------
# the data-parallel step over a placed mesh
# ---------------------------------------------------------------------------

def _token_count(cfg, batch: dict) -> float:
    """The tokens a shard's KD / CE means divide by: its (vlm-aligned)
    mask's sum, or its rows where it has no mask (every row then counts
    alike)."""
    _, mask = _align_vlm_labels(cfg, batch)
    if mask is None:
        return float(batch["tokens"].shape[0])
    return float(torch.sum(mask.float()))


def _shard_weights(cfg, batches: list) -> list:
    """``(token weight, row weight)`` of each shard's batch: its share of
    the whole batch's masked tokens (the KD and CE means) and of its rows
    (the per-sequence MoE aux loss, the statistics)."""
    toks = [_token_count(cfg, b) for b in batches]
    rows = [float(b["tokens"].shape[0]) for b in batches]
    total_t, total_r = sum(toks), sum(rows)
    return [(t / total_t if total_t else 0.0, r / total_r)
            for t, r in zip(toks, rows)]


def _combine_metrics(metrics: list, weights: list, home) -> dict:
    """One microbatch's metrics from its shards': the weighted loss terms
    summed, ``kd`` / ``ce`` by token weight, ``aux`` by row weight."""
    out = {}
    for k in metrics[0]:
        vals = [m[k].to(home) for m in metrics]
        if k == "loss":
            w = [1.0] * len(vals)
        else:
            w = [wt[1] if k == "aux" else wt[0] for wt in weights]
        total = None
        for v, wi in zip(vals, w):
            total = v * wi if total is None else total + v * wi
        out[k] = total
    return out


@torch.no_grad()
def _combine_site(nodes: list, r: list, home) -> dict:
    """A site's statistics over the whole batch from its shards' (``r``:
    each shard's share of the rows). A site taken over its whole input
    (with ``x_mean``) pools the shards' means and variances into the
    whole input's population ``x_std``, takes the max of ``x_absmax`` and
    the row-weighted mean of ``clip_frac``; a MoE site's statistics are
    means over sequences, so each is the row-weighted mean."""
    get = [{k: v.to(home).double() for k, v in n.items()} for n in nodes]
    wmean = (lambda k: sum(g[k] * ri for g, ri in zip(get, r)))
    if "x_mean" not in get[0]:
        return {k: wmean(k).float() for k in ("x_std", "x_absmax",
                                              "clip_frac")}
    mean = wmean("x_mean")
    var = sum((g["x_std"] ** 2 + (g["x_mean"] - mean) ** 2) * ri
              for g, ri in zip(get, r))
    return {"x_std": torch.sqrt(var).float(),
            "x_absmax": torch.stack([g["x_absmax"] for g in get]
                                    ).amax(0).float(),
            "clip_frac": wmean("clip_frac").float()}


def _combine_stats(stats: list, r: list, home):
    """The whole batch's site statistics from the data shards' (only the
    sites, which the input-range rules read)."""
    first = stats[0]
    if "x_std" in first:
        return _combine_site(stats, r, home)
    return {k: _combine_stats([s[k] for s in stats], r, home)
            for k, v in first.items() if isinstance(v, dict)}


def _take(tree: dict) -> dict:
    """The leaves of ``tree`` by path, taken out of it (``tree`` is left
    empty, so that a leaf is freed as soon as its taker drops it)."""
    flat = flatten_paths(tree)
    tree.clear()
    return flat


def _adamw_slices(label: str, k: dict, cfg: AdamWConfig):
    """AdamW over a leaf's slices (``placement.map_leaf``'s form)."""
    def slices(ps, gs, ms, vs):
        outs = [adamw.leaf_update(*blk, label, k, cfg)
                for blk in zip(ps, gs, ms, vs)]
        return tuple([o[j] for o in outs] for j in range(3))
    return slices


def apply_gradients(params: dict, grads: dict, state: dict, labels: dict,
                    lr, tcfg: TrainConfig, specs=None, mesh=None):
    """Steps 3-4 of :func:`make_train_step` from the summed gradient
    ``grads`` (whole, on the first data shard's device; consumed): its
    norm, its ZeRO slices (compressed with ``grad_compression``, each
    leaf with its whole scale) and AdamW on each slice of ``params`` and
    the moments, placed by ``specs`` on ``mesh`` (with none, each slice is
    the whole leaf). Returns ``(new_params, new_opt, new_err or None,
    grad_norm)``; the norm is the whole gradient's, in sorted path
    order."""
    norm = None if tcfg.grad_compression else global_norm(grads)
    flat_s = None if specs is None else flatten_paths(specs)
    flat_g = placement.reduce_scatter(_take(grads), flat_s, mesh)
    err = None
    if tcfg.grad_compression:
        flat_e = placement.place_tree(flatten_paths(state["err"]), flat_s,
                                      mesh)
        out_e = {}
        for p, g in flat_g.items():
            flat_g[p], out_e[p] = placement.map_leaf(
                compression.compress_slices, g, flat_e[p])
        err = unflatten_paths(out_e)
        norm = global_norm(placement.gather_tree(flat_g))
    opt = state["opt"]
    k = adamw.prepare(norm, opt["count"], lr, tcfg.adamw)
    flat_l = flatten_paths(labels)
    flat_m = placement.place_tree(flatten_paths(opt["m"]), flat_s, mesh)
    flat_v = placement.place_tree(flatten_paths(opt["v"]), flat_s, mesh)
    new_p, new_m, new_v = {}, {}, {}
    for p, x in flatten_paths(params).items():
        new_p[p], new_m[p], new_v[p] = placement.map_leaf(
            _adamw_slices(flat_l[p], k, tcfg.adamw), x, flat_g.pop(p),
            flat_m[p], flat_v[p])
    return (unflatten_paths(new_p),
            {"m": unflatten_paths(new_m), "v": unflatten_paths(new_v),
             "count": k["count"]}, err, norm)


def _step(mesh, loss_fn, cfg, acfg, tcfg, labels, lr_schedule, params,
          state, batch, key, teacher_params):
    """The train step (see :func:`make_train_step`); ``mesh`` None is one
    data shard where the batch lies, with the state whole."""
    step = int(state["step"])
    nkey = noise_lib.fold_in(key, step)
    specs = None if mesh is None else placement.specs_for(params)
    params = placement.place_tree(params, specs, mesh)
    shards = placement.split_batch(batch, mesh,
                                   dim=1 if tcfg.accum_steps > 1 else 0)
    home = shards[0][0]
    n = len(shards)

    # 1. the parameters (and the teacher) gathered once, on every data
    # shard's device
    whole = placement.gather_tree(params, home)
    teacher = (None if teacher_params is None
               else placement.gather_tree(teacher_params, home))
    on = {dev: (placement.to_device(whole, dev),
                placement.to_device(teacher, dev)) for dev, _ in shards}
    del whole, teacher

    # 2.-3. each shard's forward and backward on its own rows, the
    # gradients summed in fp32 in shard order on the first shard's device
    weights = None
    if n > 1:
        micro = ([[_micro(b, i) for _, b in shards]
                  for i in range(tcfg.accum_steps)]
                 if tcfg.accum_steps > 1 else [[b for _, b in shards]])
        weights = [_shard_weights(cfg, mb) for mb in micro]
    means = (analog_mod.with_input_means() if n > 1
             else contextlib.nullcontext())
    acc, outs = None, []
    with means, dispatch.data_shards(n):
        for i, (dev, sb) in enumerate(shards):
            w = None if weights is None else [wm[i] for wm in weights]
            paths, g, out = _backward(loss_fn, tcfg, on[dev][0], sb, nkey,
                                      on[dev][1], w)
            if n > 1:
                g = [x.float().to(home) for x in g]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            outs.append(out)
            del g
    del on
    dtypes = {p: x.dtype for p, x in flatten_paths(params).items()}
    grads = unflatten_paths({p: a.to(dtypes[p]) for p, a in zip(paths, acc)})
    del acc
    if n == 1:
        stats = outs[0][-1][0]
        metrics = _mean_metrics([o[1] for o in outs[0]])
    else:
        rows = [wm[1] for wm in weights[-1]]
        stats = _combine_stats([o[-1][0] for o in outs], rows, home)
        metrics = _mean_metrics([
            _combine_metrics([o[a][1] for o in outs], weights[a], home)
            for a in range(len(weights))])
    del outs

    # the summed gradient scattered to its ZeRO slices; 4. AdamW on each
    lr = lr_schedule(step)
    new_p, new_opt, err, norm = apply_gradients(params, grads, state, labels,
                                                lr, tcfg, specs, mesh)
    new_state = dict(state, step=state["step"] + 1, opt=new_opt)
    if err is not None:
        new_state["err"] = err

    # the post-step transforms on the gathered parameters, placed again
    new_params = placement.gather_tree(new_p, home)
    del new_p
    new_params = _post_step(new_params, stats, step, acfg, labels)
    new_params = placement.place_tree(new_params, specs, mesh)
    metrics = dict(metrics, grad_norm=norm, lr=lr)
    return new_params, new_state, metrics


def make_train_step(cfg, acfg: AnalogConfig, tcfg: TrainConfig, labels,
                    lr_schedule):
    """Build the train step ``(params, state, batch, key[,
    teacher_params]) → (new_params, new_state, metrics)``.

    ``key`` is a ``core.noise`` key (``noise.prng_key(seed)``); the batch's
    leaves lead with the microbatch axis when ``accum_steps > 1``. Given
    ``teacher_params``, the teacher's forward runs inside the step (the
    reference's production KD path); the unchunked loss takes a batch's
    ``teacher_logits`` in its place where the batch has them.

    Under an active placed mesh (``distributed.sharding.activate`` with a
    mesh from ``launch.mesh.place_mesh``) the step is the reference's
    sharded step, with one controller. The parameters, the moments and
    the error-feedback state are placed by ``zero_spec_tree``
    (``distributed.placement``; whole trees are placed on entry) and the
    step:

    1. gathers the parameters (and a placed teacher) once, the
       reference's ``pregather_params``, the port's only mode;
    2. splits the batch over ``("pod", "data")`` by ``batch_spec_for``:
       each data shard runs forward and backward on its own rows on the
       device of mesh position ``(i, 0)``, with the same noise (the noise
       is the weights'), its KD / CE terms weighted by its share of the
       whole batch's masked tokens and its MoE aux term by its share of
       the rows, so the shards' gradients add up to the whole batch's (on
       the card each ``analog_matmul`` launch runs the whole batch's plan,
       ``dispatch.data_shards``);
    3. sums the shards' gradients in fp32 in shard order and scatters the
       sum to the ZeRO slices (``grad_compression`` then quantizes the
       summed gradient slice by slice with each leaf's whole scale;
       ``grad_norm`` is the whole gradient's, in sorted path order);
    4. runs AdamW on each slice, gathers the new parameters and applies
       the input-range rules (on the whole batch's statistics: the
       shards' means and variances pooled into the whole input's
       ``x_std``) and eq. (4) to them, and places them again.

    The model axis shards state only: the products run whole on each data
    shard (tensor-parallel training compute is ROADMAP section 1, item
    10's remaining step). ``pregather_params`` and ``shard_grads`` are
    accepted for the reference's sake and change nothing: gathering once
    is the only mode, and the gradients always leave the step as ZeRO
    slices.

    Without a placed mesh the same body runs as one data shard on the
    batch's device, each slice the whole leaf (placed trees are gathered
    first); a ``(1, 1)`` mesh holds its leaves by reference
    (``placement.place``), so it is that step bit for bit and copies
    nothing.
    """
    loss_fn = make_loss_fn(cfg, acfg, tcfg)

    def train_step(params, state, batch, key, teacher_params=None):
        return _step(placement.active_mesh(), loss_fn, cfg, acfg, tcfg,
                     labels, lr_schedule, params, state, batch, key,
                     teacher_params)

    return train_step
