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

``--arch mamba2-130m`` serves the ssm family: every prefill (chunk) runs
the ``ssd_scan`` kernel and every projection the deployment's MVM kernel.
An attention-free stack has no KV to page, so ``--paged`` is inert there
and the engine says why:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch mamba2-130m

``--arch qwen3-moe-30b-a3b`` (or ``dbrx-132b``) serves the moe family:
each expert site is one launch of the deployment's MVM kernel over all
experts. ``--arch jamba-v0.1-52b`` serves the hybrid family on either
engine (its attention layers on the paged pool with ``--paged``, its
mixers' state per slot). ``--arch internvl2-2b`` (vlm) and
``--arch musicgen-medium`` (audio, 4 codebooks per token) run on the
static engine only, as in the reference; asking for the continuous engine
falls back to the static one and says so:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch musicgen-medium

``--drift-hours H`` serves an analog deployment on an ageing chip: per-tile
device state (``core.devices``: programming gain, drift, periphery
offsets; ``--fault-prob`` adds stuck columns and dead tiles) is attached
after the chip programming, and the continuous engine's clock advances
about ``H`` hours over the run (``H`` over the estimated engine steps per
step). ``--recalibrate`` lets its watchdog reprogram the chip in place,
and the report line ends with the drift telemetry:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --deploy analog_hw --drift-hours 48 --recalibrate \
        --fault-prob 0.01

The continuous engine runs the radix prefix cache by default, as the
reference's does: with ``--paged`` admissions reuse the KV blocks (and,
for the ssm and hybrid families, the state snapshots) of earlier prompts,
retired prompts stay cached, and the report line gives the hit rate, the
prefill tokens skipped and the copy-on-write tail copies.
``--no-prefix-cache`` frees blocks at retirement instead; ``--cache-salt``
roots the cache's keys (deployment, tenancy):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --paged --no-prefix-cache --cache-salt 7

``--speculative`` turns the continuous engine's pure-decode steps into
draft-and-verify windows on the dense and moe families: ``--draft``
proposes ``--draft-k`` tokens a slot (``int4``: the digital int4
deployment of the same weights on the packed-int4 kernel; ``self``: the
target; ``ngram``: host prompt lookup), the target scores the window in one
forward, and exact-match verification keeps the output that of
non-speculative serving. ``--draft-layers N`` keeps the model drafter's
first N blocks. The report line gives the windows and the acceptance:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --paged --speculative --draft ngram

Open-loop modes (``serve.frontend``): ``--qps`` replays the same
workload as arriving traffic (``--arrival poisson``: exponential gaps at
the rate; ``burst``: groups of 4 at the same long-run rate) through the
async front end, with per-request deadlines (``--request-timeout``,
``--ttft-timeout``) and a bounded admission queue (``--max-queue``: an
arrival at a full queue is shed with its reason, never dropped silently);
``--serve`` opens an HTTP/1.1 front door on ``127.0.0.1:--port`` (``POST
/generate`` with a JSON body, ``GET /health`` for the engine's lifecycle
counters) until interrupted. Both run the engine fault-tolerant, and on
the card build the kernels before the arrival clock starts. The report
line gives the outcomes by status, TTFT and TPOT percentiles and the
queue's high-water mark:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --reduced --paged --qps 4 --arrival burst --max-queue 4 \
        --request-timeout 30 --ttft-timeout 5

``--tp N`` serves the continuous engine tensor-parallel in N shards
(``distributed.sharding``: column-parallel weights, ``kv_heads / N`` heads
of the pool per shard, greedy tokens equal to tp = 1 bit for bit), shard
``i`` on card ``i``; with fewer cards, or on the CPU, the engine serves at
tp = 1 and the launcher says why. A sharded model is built and deployed in
host memory (its random weights drawn by the CPU generator from
``--seed``, so they are not the card-built tp = 1 run's), each shard is
copied straight to its card and the replicated leaves to card 0, and the
host copy is dropped once the engine holds the shards: no card holds the
whole model.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import itertools
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import devices
from repro_torch.core.analog import (AnalogConfig, pack_int4_weights,
                                     perturb_analog_weights)
from repro_torch.core.noise import validate_noise_config
from repro_torch.distributed import sharding
from repro_torch.models import build
from repro_torch.serve.decode import digital_int4_config, generate
from repro_torch.serve.frontend import AsyncServeFrontend, ShedError
from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                         ServeEngine, required_max_len)

DEPLOYS = ("fp", "analog", "analog_hw", "digital_rtn4", "digital_int4")


def deploy_model(args, cfg, params, labels, generator: torch.Generator,
                 inplace: bool = False):
    """Apply the selected deployment transform. Returns ``(params, acfg)``.
    ``inplace`` programs the chip into ``params`` itself (``analog_hw``),
    for a model whose second copy would not fit the card."""
    if args.deploy == "fp":
        return params, AnalogConfig(mode="off")
    if args.deploy == "analog":
        return params, AnalogConfig(mode="analog", train_noise=False)
    if args.deploy == "analog_hw":
        params = perturb_analog_weights(params, labels, generator, "hw",
                                        inplace=inplace)
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
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="radix prefix caching on the paged pool: "
                         "admissions reuse content-matching KV blocks "
                         "(ssm / hybrid: state snapshots), retired prompts "
                         "stay LRU-cached (--no-prefix-cache frees blocks "
                         "eagerly)")
    ap.add_argument("--cache-salt", type=int, default=0,
                    help="salt folded into every prefix-cache block key: "
                         "keeps apart entries whose KV would differ for "
                         "reasons outside the token ids (deployment "
                         "config, tenancy)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-and-verify speculative decoding: the "
                         "drafter proposes --draft-k tokens per slot per "
                         "step, the target verifies the whole window in "
                         "one forward; exact-match verification keeps the "
                         "output that of non-speculative decoding "
                         "(attention families only)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative window length (tokens proposed per "
                         "slot per step)")
    ap.add_argument("--draft", default="int4",
                    choices=["int4", "self", "ngram"],
                    help="drafter: int4 = RTN-int4 digital deployment of "
                         "the target weights (packed-int4 kernel), self = "
                         "the target drafts for itself, ngram = host "
                         "prompt lookup (no draft forward)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="truncate the model drafter to its first N blocks "
                         "(0 = full depth; layer-skip self-speculation)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards: column-parallel weights "
                         "and a per-shard KV-head split of the pool; "
                         "greedy decode stays bitwise identical to tp=1")
    ap.add_argument("--noise-model", default="none",
                    choices=["none", "hw", "gaussian"],
                    help="extra eval-time weight perturbation on analog "
                         "deployments (gaussian needs --noise-gamma > 0)")
    ap.add_argument("--noise-gamma", type=float, default=0.0)
    ap.add_argument("--drift-hours", type=float, default=0.0,
                    help="total deployment hours of conductance drift, "
                         "spread (approximately) across the serve run: "
                         "attaches per-tile device state to the analog "
                         "weights and ticks the engine's drift clock each "
                         "worked step")
    ap.add_argument("--recalibrate", action="store_true",
                    help="let the drift watchdog reprogram the analog "
                         "tiles in place when the per-tile scale error "
                         "trips its threshold (needs --drift-hours > 0)")
    ap.add_argument("--fault-prob", type=float, default=0.0,
                    help="per-column stuck-fault and per-tile dead-tile "
                         "probability of the attached device state "
                         "(--drift-hours mode; faults are permanent: "
                         "recalibration never clears them)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop mode: replay the workload as arriving "
                         "traffic at this rate through the async front end "
                         "(0 = closed loop)")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "burst"],
                    help="open-loop arrivals: poisson = exponential gaps "
                         "at --qps, burst = groups of 4 arriving together "
                         "at the same long-run rate")
    ap.add_argument("--request-timeout", type=float, default=0.0,
                    help="end-to-end deadline of each request in seconds "
                         "(0 = none); an overdue request is retired "
                         "timed_out with its partial output")
    ap.add_argument("--ttft-timeout", type=float, default=0.0,
                    help="first-token deadline of each request in seconds "
                         "(0 = none), enforced while queued and during "
                         "prefill")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue of the open-loop modes "
                         "(0 = unbounded); an arrival at a full queue is "
                         "shed with its reason")
    ap.add_argument("--serve", action="store_true",
                    help="open an HTTP/1.1 front door on --port (POST "
                         "/generate, GET /health) and serve until "
                         "interrupted instead of the synthetic workload")
    ap.add_argument("--port", type=int, default=8321,
                    help="TCP port of --serve on 127.0.0.1 (0 = any free "
                         "port)")
    return ap.parse_args(argv)


def arrival_offsets(n: int, qps: float, arrival: str,
                    rng: np.random.Generator) -> np.ndarray:
    """Arrival times (seconds from the start) of ``n`` open-loop requests:
    ``poisson``, exponential gaps at rate ``qps``; ``burst``, groups of 4
    arriving together, the groups spaced so that the long-run rate is still
    ``qps`` (a transient overload of a bounded queue at a sustainable mean
    rate)."""
    if arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / qps, size=n))
    group = 4
    starts = np.arange(n) // group * (group / qps)
    return starts + rng.uniform(0, 1e-3, size=n)


async def open_loop_run(frontend: AsyncServeFrontend, reqs, offsets):
    """Submit each of ``reqs`` at its arrival offset and collect every
    terminal result, the shed ones too. Returns ``(records, wall
    seconds)``, a record a dict of uid, status, ttft, latency, the token
    count and the reason; ``streamed`` holds the tokens the request's
    stream yielded."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    records: list[dict] = []

    async def one(req, at):
        await asyncio.sleep(max(0.0, at - (loop.time() - t0)))
        try:
            h = await frontend.submit(req)
        except ShedError as e:
            records.append(dict(uid=req.uid, status="shed", ttft=None,
                                latency=0.0, tokens=0, reason=str(e),
                                streamed=[]))
            return
        streamed = [t async for t in h.stream()]
        res = await h.result()
        records.append(dict(uid=req.uid, status=res.status, ttft=res.ttft,
                            latency=res.latency, tokens=len(res.tokens),
                            reason=res.reason, streamed=streamed))

    await asyncio.gather(*(one(r, a) for r, a in zip(reqs, offsets)))
    return records, loop.time() - t0


#: the largest request body the front door reads (bytes)
MAX_BODY = 1 << 20


def http_handler(frontend: AsyncServeFrontend, args, vocab: int):
    """The front door's connection handler ``handle(reader, writer)``, one
    HTTP/1.1 request a connection. ``POST /generate`` takes JSON
    ``{"prompt": [ids], "max_new", "temperature", "top_k", "seed",
    "ttft_deadline", "deadline"}`` (defaults from ``args``) and answers 200
    with ``{"uid", "status", "tokens", "reason", "ttft", "latency"}``, 503
    with the engine's reason when the request is shed, 400 on a bad body
    (no JSON, no non-empty ``prompt``, a Content-Length past MAX_BODY);
    ``GET /health`` answers the engine's lifecycle counters; anything else
    404. ``writer`` needs only ``write``, ``drain`` and ``close``."""
    uids = itertools.count()

    async def handle(reader, writer):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        method, path = (head.split(b"\r\n", 1)[0].decode("latin-1").split()
                        + ["", ""])[:2]

        def respond(code, obj):
            payload = json.dumps(obj).encode()
            writer.write(
                f"HTTP/1.1 {code}\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode() + payload)

        eng = frontend.engine
        if method == "GET" and path == "/health":
            respond("200 OK", dict(
                active=eng.num_active, queued=eng.queue_depth,
                submitted=eng.submitted, shed=eng.shed_count,
                timed_out=eng.timeout_count, cancelled=eng.cancel_count,
                step_faults=eng.fault_count,
                queue_high_water=eng.queue_high_water))
        elif method == "POST" and path == "/generate":
            try:
                clen = 0
                for h in head.split(b"\r\n")[1:]:
                    if h.lower().startswith(b"content-length:"):
                        clen = int(h.split(b":", 1)[1])
                if not 0 <= clen <= MAX_BODY:
                    raise ValueError(f"Content-Length {clen} outside "
                                     f"[0, {MAX_BODY}]")
                spec = json.loads(await reader.readexactly(clen) or b"{}")
                prompt = np.asarray(spec["prompt"], np.int32) % vocab
                if prompt.ndim != 1 or not len(prompt):
                    raise ValueError("prompt must be a non-empty list of "
                                     "token ids")
                req = Request(
                    uid=next(uids), prompt=prompt,
                    max_new=int(spec.get("max_new", args.new_tokens)),
                    temperature=float(spec.get("temperature", 0.8)),
                    top_k=int(spec.get("top_k", 50)),
                    seed=int(spec.get("seed", args.seed)),
                    ttft_deadline=float(spec.get("ttft_deadline",
                                                 args.ttft_timeout)),
                    deadline=float(spec.get("deadline",
                                            args.request_timeout)))
            except (KeyError, TypeError, ValueError,
                    asyncio.IncompleteReadError) as e:
                respond("400 Bad Request", dict(error=str(e)))
            else:
                try:
                    h = await frontend.submit(req)
                except ShedError as e:
                    respond("503 Service Unavailable",
                            dict(uid=req.uid, status="shed", reason=str(e)))
                else:
                    res = await h.result()
                    respond("200 OK", dict(
                        uid=res.uid, status=res.status,
                        tokens=[int(t) for t in res.tokens],
                        reason=res.reason, ttft=res.ttft,
                        latency=res.latency))
        else:
            respond("404 Not Found", dict(error=f"no route {path}"))
        await writer.drain()
        writer.close()

    return handle


async def open_http(frontend: AsyncServeFrontend, args,
                    vocab: int) -> asyncio.AbstractServer:
    """Start the front door (:func:`http_handler`) on ``127.0.0.1:
    args.port`` (0: a free port, read off ``server.sockets``)."""
    return await asyncio.start_server(http_handler(frontend, args, vocab),
                                      "127.0.0.1", args.port)


async def http_serve(frontend: AsyncServeFrontend, args, vocab: int):
    """Serve the front door until cancelled (Ctrl-C)."""
    server = await open_http(frontend, args, vocab)
    port = server.sockets[0].getsockname()[1]
    print(f"[serve] HTTP front door on http://127.0.0.1:{port} "
          "(POST /generate, GET /health); Ctrl-C to stop")
    async with server:
        await server.serve_forever()


def prepare_kernels(device: torch.device) -> None:
    """Build and load every kernel library before an open-loop clock
    starts (on the card a first launch would otherwise run ``nvcc`` inside
    a request's deadline); nothing to do on the CPU."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build

    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)


def main(argv=None):
    """CLI entry point. Returns ``{uid: generated ids}`` from the
    continuous engine, its open-loop records with ``--qps`` (None after
    ``--serve``), or the static engine's tokens [num_requests, new_tokens]
    (on the host)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    validate_noise_config(args.noise_model, args.noise_gamma)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    shard_devices = host_built_shards(args, cfg, device)
    home = torch.device("cpu") if shard_devices else device
    gen = torch.Generator(device=home).manual_seed(args.seed)
    cfg, params, labels = build(cfg, gen, device=home)
    params, acfg = deploy_model(args, cfg, params, labels, gen, inplace=True)
    if args.noise_model != "none":
        if acfg.mode == "analog":
            params = perturb_analog_weights(params, labels, gen,
                                            args.noise_model, args.noise_gamma,
                                            inplace=True)
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

    if cfg.family in ("audio", "vlm") and args.engine == "continuous":
        # the continuous engine does not serve multi-codebook / patch-embed
        # families (nor does the reference's): the lockstep path does
        print(f"[serve] family={cfg.family!r}: falling back to the static "
              "engine (continuous batching not wired for it)")
        args.engine = "static"

    if args.engine == "static":
        if args.paged:
            print("[serve] --paged/--kv-bits are continuous-engine "
                  "options: ignored on the static path")
        if args.drift_hours or args.recalibrate:
            print("[serve] --drift-hours/--recalibrate are "
                  "continuous-engine options: ignored on the static path")
        if args.speculative:
            print("[serve] --speculative is a continuous-engine option: "
                  "ignored on the static path")
        if args.qps > 0 or args.serve:
            print("[serve] --qps/--serve are continuous-engine modes: "
                  "ignored on the static path")
        prompts = torch.randint(0, cfg.vocab_size, (args.num_requests, 4),
                                generator=gen, device=device)
        if cfg.family == "audio":          # one token per codebook
            prompts = prompts[..., None].repeat(1, 1, cfg.num_codebooks)
        t0 = time.perf_counter()
        toks = generate(params, cfg, acfg, gen, prompts, args.new_tokens,
                        temperature=0.8, top_k=50, cache_dtype=cache_dtype)
        toks = toks.cpu()                      # waits for the device
        dt = time.perf_counter() - t0
        total = args.num_requests * args.new_tokens
        print(f"[serve] static ({where}): {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s); sample: {toks[0, :8].tolist()}")
        return toks

    open_loop = args.serve or args.qps > 0
    reqs = mixed_requests(args, cfg)
    if open_loop and (args.request_timeout or args.ttft_timeout):
        reqs = [dataclasses.replace(r, deadline=args.request_timeout,
                                    ttft_deadline=args.ttft_timeout)
                for r in reqs]
    chunk = args.prefill_chunk
    max_len = max(required_max_len(len(r.prompt), r.max_new, chunk)
                  for r in reqs)
    params, drift_dt, est_steps = attach_drift(args, params, labels, acfg,
                                               reqs)
    eng = ServeEngine(params, cfg, acfg, SchedulerConfig(
        num_slots=args.num_slots, max_len=max_len, prefill_chunk=chunk,
        step_tokens=args.step_tokens, cache_dtype=cache_dtype,
        paged=args.paged, kv_block_size=args.kv_block_size,
        kv_blocks=args.kv_blocks, prefix_cache=args.prefix_cache,
        cache_salt=args.cache_salt, speculative=args.speculative,
        draft_k=args.draft_k, draft=args.draft,
        draft_layers=args.draft_layers, drift_dt=drift_dt,
        recalibrate=args.recalibrate,
        # the watchdog's cadence scaled to the workload, so that a short
        # run still reads health a few times
        recal_interval=max(1, est_steps // 8) if drift_dt else 25,
        # the open-loop modes bound the queue and survive step faults: a
        # front door degrades, it does not die
        max_queue=args.max_queue if open_loop else 0,
        fault_tolerant=open_loop, tp=args.tp), shard_devices=shard_devices)
    del params         # the engine holds the shards; the host copy goes
    flags = {"drift": "--drift-hours", "tensor_parallel": "--tp"}
    for feature, why in eng.gating_reasons.items():
        flag = flags.get(feature, "--" + feature.replace("_", "-"))
        # --prefix-cache is on by default: its reason is printed only
        # when the flag was given
        if feature != "prefix_cache" or flag in argv:
            print(f"[serve] {flag} is inert for {cfg.name}: {why}")
    if eng.mesh is not None:
        print(f"[serve] tensor parallel: tp={args.tp} over "
              f"{[str(d) for d in eng.mesh.devices]} (column-parallel "
              f"weights, kv_heads/{args.tp} per shard; built in host "
              f"memory, each shard copied to its device)")
    if open_loop:
        prepare_kernels(device)
        return open_loop_main(args, eng, reqs, cfg.vocab_size)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    lats = sorted(eng.finished_at[r.uid] - t0 for r in reqs)
    if eng.pool is not None:
        mode = "paged" + ("-int8" if acfg.kv_bits == 8 else "") + " kv"
    else:
        mode = "contiguous kv"
    if cfg.family == "ssm":
        mode = "per-slot ssm state"
    elif cfg.family == "hybrid":
        mode += " + per-slot ssm state"
    prefix = ""
    if eng.prefix_enabled:
        hit_rate = (eng.prefix_hits / eng.prefix_lookups
                    if eng.prefix_lookups else 0.0)
        idx_pool = eng.pool if eng.pool is not None else eng.state_pool
        snaps = (f", {eng.state_snaps_captured} state snapshots "
                 f"({eng.state_snap_restores} restored)"
                 if eng.state_pool is not None else "")
        prefix = (f", prefix cache: {hit_rate:.0%} hit rate, "
                  f"{eng.prefix_skipped_tokens} prefill tokens skipped, "
                  f"{eng.prefix_cow_copies} copy-on-write tails, "
                  f"{idx_pool.num_cached} blocks retained, "
                  f"{idx_pool.evictions} evictions{snaps}")
    spec = ""
    if eng.spec_enabled:
        spec = (f", speculative ({eng.scfg.draft} drafter, k="
                f"{eng.scfg.draft_k}): {eng.spec_steps} verify windows, "
                f"{eng.spec_acceptance:.0%} draft acceptance")
    drift = ""
    if eng.drift_enabled:
        drift = (f", drift: {eng.drift_hours:.1f}h deployed, "
                 f"tile_err={eng.tile_scale_err:.3f}, {eng.dead_tiles} dead "
                 f"tiles, {eng.stuck_cols} stuck cols, {eng.recal_count} "
                 f"recals ({eng.watchdog_checks} watchdog checks)")
    print(f"[serve] continuous ({where}, {mode}, {args.cache_dtype}): "
          f"{total} tokens across {len(reqs)} mixed-length requests in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, {eng.decode_steps} decode "
          f"steps, {eng.mixed_steps} fused mixed steps, "
          f"{eng.decode_tokens_during_admission} decode tokens emitted "
          f"during admission, p50 latency "
          f"{lats[len(lats) // 2] * 1e3:.0f}ms{prefix}{spec}{drift}; "
          f"{lifecycle_report(eng)}); sample: {results[0][:8].tolist()}")
    return results


def host_built_shards(args, cfg, device) -> list | None:
    """The shard devices of a ``--tp`` engine that will shard (the
    continuous engine on a family it serves, enough devices, heads that
    divide), or None. Such a model is built in host memory and each shard
    copied to its device, so that no card holds the whole model."""
    if (args.tp <= 1 or args.engine != "continuous"
            or cfg.family in ("audio", "vlm")):
        return None
    devs = sharding.available_devices(device)
    if sharding.serve_tp_unsupported(cfg, args.tp, devs) is not None:
        return None
    return devs[:args.tp]


def open_loop_main(args, eng: ServeEngine, reqs, vocab: int):
    """``--serve``: the HTTP front door until interrupted (returns None);
    ``--qps``: the workload as arriving traffic through the async front
    end, every arrival accounted for. Returns the open-loop records."""
    fe = AsyncServeFrontend(eng)
    if args.serve:
        async def door():
            await fe.start()
            try:
                await http_serve(fe, args, vocab)
            finally:
                await fe.stop()

        try:
            asyncio.run(door())
        except KeyboardInterrupt:
            print(f"[serve] shutting down; {lifecycle_report(eng)}")
        return None
    rng = np.random.default_rng(args.seed + 1)
    offsets = arrival_offsets(len(reqs), args.qps, args.arrival, rng)

    async def drive():
        await fe.start()
        try:
            return await open_loop_run(fe, reqs, offsets)
        finally:
            await fe.stop()

    records, wall = asyncio.run(drive())
    by = {}
    for r in records:
        by[r["status"]] = by.get(r["status"], 0) + 1
    total = sum(r["tokens"] for r in records)
    # no silent drop: every arrival reached one terminal status
    if not len(records) == len(reqs) == eng.submitted:
        raise RuntimeError(f"{len(reqs)} arrivals, {len(records)} "
                           f"terminal records, {eng.submitted} submitted")
    print(f"[serve] open-loop ({args.arrival} @ {args.qps:g} qps, "
          f"{len(reqs)} arrivals): {total} tokens in {wall:.2f}s "
          f"({total / wall:.1f} tok/s), outcomes {by}, {fe.steps} engine "
          f"steps; {lifecycle_report(eng)}")
    return records


def attach_drift(args, params, labels, acfg, reqs):
    """``--drift-hours``: per-tile device state on an analog deployment
    (drawn on a CPU generator from ``--seed``, after the chip programming)
    and the clock's hours per engine step. Returns ``(params, drift_dt,
    est_steps)``; a digital deployment is warned about and keeps its
    params, with the clock off. The step count is an estimate (admission
    interleaves with decode); the engine reports the exact hours."""
    est_steps = max(1, sum(r.max_new for r in reqs) // args.num_slots
                    + args.num_requests)
    if args.drift_hours <= 0:
        return params, 0.0, est_steps
    if acfg.mode != "analog":
        print("[serve] WARNING: --drift-hours needs an analog deployment "
              f"(deploy={args.deploy!r} has no crossbar tiles to age): "
              "drift clock inert")
        return params, 0.0, est_steps
    dcfg = devices.DeviceConfig(p_stuck_col=args.fault_prob,
                                p_dead_tile=args.fault_prob)
    seed = int(np.random.SeedSequence([args.seed, 2]).generate_state(1)[0])
    params = devices.attach_device_state(
        params, labels, torch.Generator().manual_seed(seed), dcfg)
    print(f"[serve] per-tile device state attached (~{args.drift_hours:g}h "
          f"drift over ~{est_steps} steps)")
    return params, args.drift_hours / est_steps, est_steps


def lat_stats(vals) -> str:
    """``p50/p99`` milliseconds, or ``-/-`` when nothing completed."""
    xs = [v for v in vals if v is not None]
    if not xs:
        return "-/-"
    return (f"{np.percentile(xs, 50) * 1e3:.0f}/"
            f"{np.percentile(xs, 99) * 1e3:.0f}ms")


def lifecycle_report(eng: ServeEngine) -> str:
    """The lifecycle tail of the report line: TTFT and TPOT percentiles,
    the shed, timed-out, cancelled and step-fault counts and the queue's
    high-water mark."""
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
            f"TPOT p50/p99 {lat_stats(tpots)}, "
            f"{eng.shed_count} shed, {eng.timeout_count} timed out, "
            f"{eng.cancel_count} cancelled, {eng.fault_count} step faults, "
            f"queue high-water {eng.queue_high_water}")

if __name__ == "__main__":
    main()
