"""AdamW (paper App. D: beta1 0.9, beta2 0.98, eps 1e-6, weight decay 0.01)
with label-aware decay, written out as tensor code on the parameter tree.

``torch.optim.AdamW`` is not used: it applies the decay to the weights
before the Adam step (``p *= 1 - lr * wd``), where the reference adds ``wd ·
p`` to the step and subtracts ``lr · step``; the two round differently. This
module keeps the reference's op order leaf by leaf (trees are walked in
sorted key order, the order of a JAX pytree), with fp32 moments and an
int32 ``count`` on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import flatten_paths, unflatten_paths
from repro_torch.kernels.ref import rdiv


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters (paper App. B: b2 0.98, decoupled decay)."""
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0


def init_opt_state(params: dict) -> dict:
    """Zero first and second moments shaped like ``params`` (fp32, on each
    leaf's device) and a zero step ``count``."""
    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device)
                for k, v in tree.items()}
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(grads: dict) -> torch.Tensor:
    """Global L2 norm over every leaf (per-leaf sums of squares added in
    sorted path order)."""
    total = 0
    for g in flatten_paths(grads).values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _decays(label: str, p: torch.Tensor) -> bool:
    """Whether a labelled leaf takes weight decay (matrices only)."""
    return label in ("analog_weight", "digital") and p.dim() >= 2


def prepare(norm: torch.Tensor, count: torch.Tensor, lr,
            cfg: AdamWConfig = AdamWConfig()) -> dict:
    """The step's scalars from the global gradient norm and the old
    ``count``: the clipping scale, the new count, the bias corrections and
    the learning rate as an fp32 tensor."""
    scale = torch.clamp_max(rdiv(cfg.max_grad_norm,
                                 torch.clamp_min(norm, 1e-12)), 1.0)
    count = count + 1
    cf = count.float()
    return {"scale": scale, "count": count,
            "b1c": 1.0 - torch.pow(torch.tensor(cfg.b1), cf),
            "b2c": 1.0 - torch.pow(torch.tensor(cfg.b2), cf),
            "lr": torch.as_tensor(lr, dtype=torch.float32)}


@torch.no_grad()
def leaf_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, label: str, k: dict,
                cfg: AdamWConfig = AdamWConfig()):
    """One leaf's AdamW step (or one slice's: every op is elementwise)
    with the scalars ``k`` of :func:`prepare`; ``label`` is the leaf's
    (decay for matrices labelled ``analog_weight`` / ``digital``).
    Returns ``(new_p, m, v)``. The scalars may lie on another device than
    the slice (a sharded step computes them on its first shard's): each is
    moved to the slice's."""
    dev = p.device
    g32 = (g * k["scale"].to(dev, g.dtype)).float()
    del g
    m = torch.mul(m, cfg.b1).add_(torch.mul(g32, 1 - cfg.b1))
    v = torch.mul(v, cfg.b2).add_(torch.mul(g32, 1 - cfg.b2).mul_(g32))
    del g32
    # bias corrections and lr as device tensors: a quotient by a host
    # scalar would be a multiply by its reciprocal on the card
    step = torch.div(m, k["b1c"].to(dev)).div_(
        torch.div(v, k["b2c"].to(dev)).sqrt_().add_(cfg.eps))
    if _decays(label, p):
        step.add_(torch.mul(p.float(), cfg.weight_decay))
    return torch.sub(p.float(), step.mul_(k["lr"].to(dev))).to(p.dtype), m, v


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, labels: dict,
                 lr: torch.Tensor, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step on new tensors. Returns ``(new_params,
    new_opt_state, grad_norm)``.

    ``params`` and ``opt_state`` are left as they were; ``grads`` is
    consumed: each leaf is dropped from its dict once its update is done,
    so that at full width one leaf's gradient, not the tree's, outlives its
    update. The arithmetic is the reference's, op for op (the global-norm
    scale is applied to each leaf as it is used, and products and sums of
    fresh temporaries are taken in place, which rounds the same)."""
    norm = global_norm(grads)
    k = prepare(norm, opt_state["count"], lr, cfg)
    flat_p, flat_l = flatten_paths(params), flatten_paths(labels)
    flat_m, flat_v = flatten_paths(opt_state["m"]), flatten_paths(
        opt_state["v"])
    new_p, new_m, new_v = {}, {}, {}
    for path, p in flat_p.items():
        new_p[path], new_m[path], new_v[path] = leaf_update(
            p, _pop_path(grads, path), flat_m[path], flat_v[path],
            flat_l[path], k, cfg)
    return (unflatten_paths(new_p),
            {"m": unflatten_paths(new_m), "v": unflatten_paths(new_v),
             "count": k["count"]},
            norm)


def _pop_path(tree: dict, path: str) -> torch.Tensor:
    """Remove and return the leaf at ``path`` (``/``-joined) of ``tree``."""
    *parents, last = path.split("/")
    for k in parents:
        tree = tree[k]
    return tree.pop(last)
