"""Noisy evaluation harness (the paper's §3.2 protocol).

Every noisy number in the paper is a mean ± std over 10 random *chip
programmings* (weight perturbations). The harness reproduces that
protocol: perturb the analog weights once per seed, run the task suite,
aggregate.

One seed is one deployment: one sampled noise instance, reused across
every eval batch and task of that seed. Seed ``s`` draws from
``torch.Generator(device).manual_seed(base_seed + 1000 * s)``: the JAX
package's seeds, not its streams. Sweeps that evaluate the same model at
several noise magnitudes (Fig. 3) pass pre-sampled ``instances``, so that
every ``gamma`` point perturbs the *same* simulated chips.

Memory: an instance tree is as large as the model (its other leaves are
zeros), so :func:`deployment_instances` holds ``seeds`` model copies at
once. Where they do not fit (ten seeds of phi-3-mini-4k in fp32 take
about 150 GB), take the per-seed path (``instances=None``), which holds
one perturbed copy at a time, or pin one seed at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.analog import (AnalogConfig, apply_noise_instances,
                                     perturb_analog_weights,
                                     sample_noise_instances)


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Eval-time weight-perturbation spec (model + gaussian magnitude)."""
    model: str = "none"        # none | hw | gaussian
    gamma: float = 0.0         # gaussian magnitude (fraction of channel max)


def _seed_generator(params, seed: int) -> torch.Generator:
    """The generator of one deployment seed, on the params' device (that
    of their first leaf)."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.Generator(device=leaf.device).manual_seed(seed)


def deployment_instances(params, labels, model: str, seeds: int = 1,
                         base_seed: int = 0) -> list:
    """Sample one unit noise-instance tree per deployment seed.

    Uses the same per-seed generators as :func:`evaluate`, so passing the
    result back as ``evaluate(..., instances=...)`` reproduces the same
    simulated chips across every call that shares ``(model, seeds,
    base_seed)``.
    """
    return [sample_noise_instances(
        params, labels, _seed_generator(params, base_seed + 1000 * s), model)
        for s in range(seeds)]


def evaluate(params, labels, cfg, acfg: AnalogConfig,
             tasks: Mapping[str, Callable], noise: NoiseSpec = NoiseSpec(),
             seeds: int = 1, base_seed: int = 0,
             instances: Optional[Sequence] = None) -> dict:
    """Returns {task: {"mean": .., "std": .., "runs": [...]}} (+ "avg").

    ``instances``: optional pre-sampled deployment noise instances (one
    tree per seed, from :func:`deployment_instances`), the sweep-stable
    path: every call perturbs the same chips, scaled by ``noise.gamma``.
    Without it each seed samples its own instance from the seed's
    generator, which is equivalent *within* one call but not pinned
    *across* calls. The forwards run where ``params`` live.
    """
    results = {name: [] for name in tasks}
    n = seeds if noise.model != "none" else 1
    if instances is not None and len(instances) < n:
        raise ValueError(f"need {n} deployment instances, got "
                         f"{len(instances)}")
    for s in range(n):
        if noise.model == "none":
            p = params
        elif instances is not None:
            p = apply_noise_instances(params, labels, instances[s],
                                      noise.model, noise.gamma)
        else:
            p = perturb_analog_weights(
                params, labels, _seed_generator(params, base_seed + 1000 * s),
                noise.model, noise.gamma)
        for name, task in tasks.items():
            results[name].append(task(p, cfg, acfg))
        del p               # one perturbed copy at a time
    out = {name: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                  "runs": v}
           for name, v in results.items()}
    out["avg"] = {"mean": float(np.mean([o["mean"] for o in out.values()])),
                  "std": float(np.mean([o["std"] for o in out.values()]))}
    return out
