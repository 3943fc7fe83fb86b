"""Serving launcher: continuous-batching generation from a deployed model.

The deployment stage of the paper's pipeline (Fig. 2c): construct a model,
optionally apply one simulated chip programming (hw noise) or RTN-quantize
it for digital hardware (unfused, or packed-int4 on the hand-written
kernel), and serve a mixed-length request workload through the
continuous-batching engine (``serve.scheduler``; ``--paged`` puts the KV
cache in the block pool, served by the paged-attention kernels).
``--engine static`` runs the lockstep ``serve.decode.generate`` loop on the
contiguous KV cache instead.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-1b \\
        --deploy analog_hw --paged --num-requests 8

Runs on the card; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead (the CPU tests):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --paged

The prefix cache, speculative decoding, drift, the open-loop front door
and tensor parallelism of the JAX package's launcher are not ported yet.
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
from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                         ServeEngine, required_max_len)

DEPLOYS = ("fp", "analog", "analog_hw", "digital_rtn4", "digital_int4")


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
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = the continuous-batching engine "
                         "(serve.scheduler); static = lockstep batched "
                         "generate on the contiguous KV cache")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda raises when no card is present; cpu runs "
                         "the kernels' plain PyTorch versions")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--step-tokens", type=int, default=0,
                    help="token budget of the fused mixed prefill/decode "
                         "step: one token per decode slot + prefill chunks "
                         "of admitting slots up to the budget (0 = auto: "
                         "num_slots + 2 * prefill_chunk)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "f32"],
                    help="KV-cache storage precision (bf16 halves cache "
                         "bytes; scores/softmax stay fp32)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache: free-list block allocation "
                         "+ the paged flash-decode / flash-prefill kernels")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per physical KV block (paged mode)")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool size in blocks (0 = full slot capacity; "
                         "smaller oversubscribes with admission "
                         "backpressure)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 8],
                    help="8 = int8 KV pool with per-token/head scales "
                         "(implies --paged)")
    ap.add_argument("--noise-model", default="none",
                    choices=["none", "hw", "gaussian"],
                    help="extra eval-time weight perturbation on analog "
                         "deployments (gaussian needs --noise-gamma > 0)")
    ap.add_argument("--noise-gamma", type=float, default=0.0)
    return ap.parse_args(argv)


def main(argv=None):
    """CLI entry point. Returns ``{uid: generated ids}`` from the
    continuous engine, or the static engine's tokens [num_requests,
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
    if args.kv_bits:
        acfg = dataclasses.replace(acfg, kv_bits=args.kv_bits)
        if not args.paged:
            print("[serve] --kv-bits implies the paged pool: enabling "
                  "--paged")
            args.paged = True
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")

    if args.engine == "static":
        if args.paged:
            print("[serve] --paged/--kv-bits are continuous-engine "
                  "options: ignored on the static path")
        prompts = torch.randint(0, cfg.vocab_size, (args.num_requests, 4),
                                generator=gen, device=device)
        t0 = time.perf_counter()
        toks = generate(params, cfg, acfg, gen, prompts, args.new_tokens,
                        temperature=0.8, top_k=50, cache_dtype=cache_dtype)
        toks = toks.cpu()                      # waits for the device
        dt = time.perf_counter() - t0
        total = args.num_requests * args.new_tokens
        print(f"[serve] static ({where}): {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s); sample: {toks[0, :8].tolist()}")
        return toks

    reqs = mixed_requests(args, cfg)
    chunk = args.prefill_chunk
    max_len = max(required_max_len(len(r.prompt), r.max_new, chunk)
                  for r in reqs)
    eng = ServeEngine(params, cfg, acfg, SchedulerConfig(
        num_slots=args.num_slots, max_len=max_len, prefill_chunk=chunk,
        step_tokens=args.step_tokens, cache_dtype=cache_dtype,
        paged=args.paged, kv_block_size=args.kv_block_size,
        kv_blocks=args.kv_blocks))
    t0 = time.perf_counter()
    results = eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    lats = sorted(eng.finished_at[r.uid] - t0 for r in reqs)
    mode = ("paged" + ("-int8" if acfg.kv_bits == 8 else "")
            if eng.pool is not None else "contiguous")
    print(f"[serve] continuous ({where}, {mode} kv, {args.cache_dtype}): "
          f"{total} tokens across {len(reqs)} mixed-length requests in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.decode_steps} decode "
          f"steps, {eng.mixed_steps} fused mixed steps, "
          f"{eng.decode_tokens_during_admission} decode tokens emitted "
          f"during admission, p50 latency "
          f"{lats[len(lats) // 2] * 1e3:.0f}ms; {latency_report(eng)}); "
          f"sample: {results[0][:8].tolist()}")
    return results


def lat_stats(vals) -> str:
    """``p50/p99`` milliseconds, or ``-/-`` when nothing completed."""
    xs = [v for v in vals if v is not None]
    if not xs:
        return "-/-"
    return (f"{np.percentile(xs, 50) * 1e3:.0f}/"
            f"{np.percentile(xs, 99) * 1e3:.0f}ms")


def latency_report(eng: ServeEngine) -> str:
    """TTFT and TPOT percentiles of a finished run (the part of the
    reference's lifecycle report that this port's engine measures)."""
    ttfts, tpots = [], []
    for uid, first in eng.first_token_at.items():
        sub = eng.submit_time.get(uid)
        if sub is not None:
            ttfts.append(first - sub)
        done = eng.finished_at.get(uid)
        n = len(eng.results.get(uid, ()))
        if done is not None and n > 1:
            tpots.append((done - first) / (n - 1))
    return (f"TTFT p50/p99 {lat_stats(ttfts)}, "
            f"TPOT p50/p99 {lat_stats(tpots)}")


if __name__ == "__main__":
    main()
