"""Serving launcher: batched generation from a deployed model.

The deployment stage of the paper's pipeline (Fig. 2c): construct a model,
optionally apply one simulated chip programming (hw noise) or RTN-quantize
it for digital hardware (unfused, or packed-int4 on the hand-written
kernel), and serve a batch of requests with the static lockstep engine
(``serve.decode.generate`` on the contiguous KV cache).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-1b \\
        --deploy digital_int4 --num-requests 4

Runs on the card; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead (the CPU tests). The continuous-batching engine, the paged
cache and the open-loop front door of the JAX package are not ported yet,
so ``--engine`` offers ``static`` only.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.analog import (AnalogConfig, pack_int4_weights,
                                     perturb_analog_weights)
from repro_torch.core.noise import validate_noise_config
from repro_torch.models import build
from repro_torch.serve.decode import digital_int4_config, generate

DEPLOYS = ("fp", "analog", "analog_hw", "digital_rtn4", "digital_int4")


@dataclasses.dataclass
class Request:
    """One synthetic serving request (prompt token ids and its budget)."""

    uid: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.8
    top_k: int = 50
    seed: int = 0


def deploy_model(args, cfg, params, labels, generator: torch.Generator):
    """Apply the selected deployment transform. Returns ``(params, acfg)``."""
    if args.deploy == "fp":
        return params, AnalogConfig(mode="off")
    if args.deploy == "analog":
        return params, AnalogConfig(mode="analog", train_noise=False)
    if args.deploy == "analog_hw":
        params = perturb_analog_weights(params, labels, generator, "hw")
        print("[serve] applied one simulated PCM chip programming")
        return params, AnalogConfig(mode="analog", train_noise=False)
    if args.deploy == "digital_rtn4":
        print("[serve] RTN-int4 digital deployment (unfused)")
        return params, AnalogConfig(mode="rtn", weight_bits=4)
    # digital_int4: RTN weights served from the packed-int4 CUDA kernel
    params = pack_int4_weights(params, labels)
    print("[serve] RTN-int4 digital deployment (packed-int4 kernel)")
    return params, digital_int4_config(AnalogConfig(weight_bits=4))


def mixed_requests(args, cfg) -> list[Request]:
    """A mixed-length synthetic workload (ragged prompts and budgets), the
    same requests as the reference draws from the same ``--seed``."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.num_requests):
        plen = int(rng.integers(3, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        max_new = int(rng.integers(max(1, args.new_tokens // 4),
                                   args.new_tokens + 1))
        reqs.append(Request(uid=i, prompt=prompt, max_new=max_new,
                            temperature=0.8, top_k=50, seed=args.seed + i))
    return reqs


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's command line (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--deploy", default="fp", choices=DEPLOYS)
    ap.add_argument("--engine", default="static", choices=["static"],
                    help="static = lockstep batched generate on the "
                         "contiguous KV cache (the continuous engine is "
                         "not ported yet)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda raises when no card is present; cpu runs "
                         "the kernels' plain PyTorch versions")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "f32"],
                    help="KV-cache storage precision (bf16 halves cache "
                         "bytes; scores/softmax stay fp32)")
    ap.add_argument("--noise-model", default="none",
                    choices=["none", "hw", "gaussian"],
                    help="extra eval-time weight perturbation on analog "
                         "deployments (gaussian needs --noise-gamma > 0)")
    ap.add_argument("--noise-gamma", type=float, default=0.0)
    return ap.parse_args(argv)


def main(argv=None) -> torch.Tensor:
    """CLI entry point. Returns the generated tokens [num_requests,
    new_tokens] (on the host)."""
    args = parse_args(argv)
    validate_noise_config(args.noise_model, args.noise_gamma)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg, params, labels = build(cfg, gen, device=device)
    params, acfg = deploy_model(args, cfg, params, labels, gen)
    if args.noise_model != "none":
        if acfg.mode == "analog":
            params = perturb_analog_weights(params, labels, gen,
                                            args.noise_model, args.noise_gamma)
            print(f"[serve] applied {args.noise_model} eval noise")
        else:
            print(f"[serve] WARNING: --noise-model {args.noise_model} "
                  f"perturbs analog weights; inert for deploy="
                  f"{args.deploy!r}")
    cache_dtype = torch.bfloat16 if args.cache_dtype == "bf16" else torch.float32

    prompts = torch.randint(0, cfg.vocab_size, (args.num_requests, 4),
                            generator=gen, device=device)
    t0 = time.perf_counter()
    toks = generate(params, cfg, acfg, gen, prompts, args.new_tokens,
                    temperature=0.8, top_k=50, cache_dtype=cache_dtype)
    toks = toks.cpu()                      # waits for the device
    dt = time.perf_counter() - t0
    total = args.num_requests * args.new_tokens
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] static ({where}): {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s); sample: {toks[0, :8].tolist()}")
    return toks


if __name__ == "__main__":
    main()
