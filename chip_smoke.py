#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. setup    -- a card, full fp32 matmuls (no TF32), the five CUDA kernels
               built from ``src/repro_torch/kernels/csrc`` with nvcc.
2. kernels  -- each MVM kernel at llama-3.2-1b's main-path shapes (K -> N of
               the qkv, o, gate_up, down projections and the LM head; M = 4
               for decode, 4 x 32 = 128 for prefill; the continuous
               engine's M = 8 decode and M = 64 chunk) and at mamba2-130m's
               (in_proj 768 -> 3352, out_proj 1536 -> 768; M = 4 and
               4 x 1024), held against its plain PyTorch version on the same
               inputs (analog: at most 1e-4 of the outputs may flip, each
               one ADC level at a near-tie; the folded ADC bound bit for bit
               equal to the explicit one) and timed with CUDA events beside
               the plain version, an fp32 ``torch.matmul`` of the same size
               (yardstick only) and the card's bound for the work (the
               tensor-core bound for the mma mapping, the fp32 one beside
               it); analog_matmul as the main path calls it (bound folded),
               with the explicit bound, the ``adc_bound`` pass the fold
               replaced, and the flip rate with the tensor cores carrying
               the whole K sum (no promotion).
3. analog   -- full-width llama-3.2-1b (16 layers, random weights from a
               seed) deployed ``analog_hw`` with ``use_pallas=True`` serves 4
               prompts of 32 tokens for 16 greedy tokens; every projection
               must have run on ``analog_matmul``. The same model unfused
               (plain torch ops, the reference's default) is the check.
4. int4     -- the same with ``digital_int4`` on ``int4_matmul``, checked
               against ``digital_rtn4`` (unfused).
5. paged    -- both paged-attention kernels at llama-3.2-1b's attention
               shapes (H 32, KV 8, hd 64, block 16): decode for 8 rows at
               live contexts of 128, 512 and 2048 tokens with ragged
               ``start``, 1 and 4 splits; prefill for the engine's 2 compact
               rows x chunk 32 at the same contexts; fp32, bf16 and int8
               pools. Each is held against its plain version and timed
               beside it, beside gather ``kp[tbl]`` + PyTorch's
               ``scaled_dot_product_attention`` (yardstick only) and the
               card's bound, with the kernel's plan (warps of a thread
               block, query tile, lanes of a warp, keys per warp iteration
               and per lane, pool blocks in flight).
6. ssd      -- ``ssd_scan`` at mamba2-130m's shapes (H 24, P 64, N 128,
               G 1; strided views of one projection, as the mixer hands them
               over): the engine's chunk (2 rows x 32 tokens from a nonzero
               state, ragged left pads), the static prompt (4 x 1024) and a
               long prefill (1 x 8192), each held against its plain version
               (y and the final state) and timed beside it and the card's
               bound (the recurrence's work on the TF32 tensor cores; PR
               13's L = 32 fp32 bound beside it), with the kernel's plan
               (chunk length, launches, blocks of each, scratch) and each
               pass's time from ``torch.profiler``; a one-launch scan is
               also held and timed as the three passes.
7. mamba    -- full-width mamba2-130m (24 layers, random weights from a seed)
               on the static engine: 4 prompts of 1024 tokens, 32 greedy
               tokens, for ``fp`` (``ssd_scan`` against the plain SSD on the
               card), ``analog_hw`` + ``use_pallas=True`` (against unfused)
               and ``digital_int4`` (against ``digital_rtn4``); 48 MVM
               launches per forward, 24 ``ssd_scan`` launches per prefill.
8. engine   -- the continuous-batching engine (``serve.scheduler``) at full
               width: llama-3.2-1b on the paged pool, 16 mixed-length
               requests (prompts 32-480 tokens, 16-64 new) through 8 slots,
               chunk 32, for ``analog_hw`` + ``use_pallas=True`` and
               ``digital_int4`` on a bf16 pool and ``analog_hw`` on the int8
               pool; then mamba2-130m with the same requests for
               ``analog_hw`` and ``digital_int4`` (``paged=True``, inert for
               an ssm stack, which the engine records). Every request must
               finish, every block come back, and every projection,
               attention and SSD call run on its kernel. Then one decode
               forward and one chunk forward (2 rows x 32 columns) of the
               engine at its slots' live context, on the host clock and
               on the device (CUDA graphs).
9. reduced  -- reduced llama-3.2-1b and mamba2-130m through the engine on the
               card and on the CPU (plain versions): equal greedy tokens for
               ``fp`` and ``analog_hw`` (llama: paged and per-slot
               contiguous), and a chunk + decode step's logits within 1e-4.
10. cli     -- ``repro_torch.launch.serve.main``, continuous (paged) and
               static, and continuous with ``--arch mamba2-130m``.

It then prints the kernels' JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. It takes no arguments.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama-3.2-1b"
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 32, 16
# (site, K, N, sites per forward) of llama-3.2-1b: 16 layers + the LM head
SITES = [("qkv", 2048, 3072, 16), ("o", 2048, 2048, 16),
         ("gate_up", 2048, 16384, 16), ("down", 8192, 2048, 16),
         ("lm_head", 2048, 128256, 1)]
LAUNCHES_PER_FORWARD = sum(s[3] for s in SITES)            # 65
FORWARDS = 1 + NEW_TOKENS                                  # prefill + decode
M_DECODE, M_PREFILL = BATCH, BATCH * PROMPT_LEN
# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth, the fp32 rate of the CUDA cores and the dense TF32 rate of the
# tensor cores (the mma mapping does two TF32 products per fp32 product)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# the ADC parity contract: at most this share of a shape's outputs may flip
# one level at a near-tie; the share is taken over at least PARITY_OUTPUTS
# outputs (fresh x draws against the shape's weight copies), so that one
# flip among a decode shape's 8192 outputs is not read as a rate
MAX_FLIP_RATE = 1e-4
PARITY_OUTPUTS = 1 << 17
U32 = 2.0 ** -24                                           # fp32 unit round-off
# Fused vs unfused at full width (serve_phase). Site by site on the same
# inputs the two may differ only by one ADC level where the pre-ADC value
# lies within fp32 reassociation error of a rounding tie (site_parity:
# every mismatch is checked). End to end, every later site re-quantizes
# what such a flip moved, so flips cascade through the 16 layers and the
# logits differ by a few percent (relative L2) on random weights; E2E_TOL
# only catches gross faults (unrelated logits give about 1.4).
E2E_TOL = 0.25
# paged attention at llama-3.2-1b's attention shapes (phase 5) and the
# continuous engine's geometry (phase 8)
PAGED_H, PAGED_KV, PAGED_HD, PAGED_BS = 32, 8, 64, 16
PAGED_CONTEXTS = (128, 512, 2048)
DECODE_ROWS, DECODE_SPLITS = 8, (1, 4)
POOL_DTYPES = ("f32", "bf16", "i8")
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_REQUESTS = 8, 32, 16
# the engine's compact prefill width: (slots + 2 chunks - slots) // chunk
PREFILL_ROWS = 2
# the continuous engine's MVM rows: a decode forward over its slots and a
# chunk forward of its compact rows
M_ENGINE_DECODE, M_ENGINE_CHUNK = ENGINE_SLOTS, PREFILL_ROWS * ENGINE_CHUNK
# mamba2-130m, the ssm family: (site, K, N, sites per forward) of its 24
# layers (the tied LM head is a plain matmul, as in the reference), the
# static engine's batch, prompt and new tokens
MAMBA = "mamba2-130m"
MAMBA_SITES = [("in_proj", 768, 3352, 24), ("out_proj", 1536, 768, 24)]
MAMBA_MVM_PER_FORWARD = sum(s[3] for s in MAMBA_SITES)      # 48
MAMBA_PROMPT, MAMBA_NEW = 1024, 32
# decode steps of each timing round of the static engine's step times
MAMBA_STEP_TOKENS = 8
MAMBA_M_PREFILL = BATCH * MAMBA_PROMPT
# ssd_scan cases (phase 6): (name, rows, tokens, incoming state); "chunk"
# is what the continuous engine runs, and the kernels line reports it
SSD_CASES = [("chunk", PREFILL_ROWS, ENGINE_CHUNK, True),
             ("static", BATCH, MAMBA_PROMPT, False),
             ("long", 1, 8192, False)]
SSD_LINE_CASE = "chunk"
# |kernel - plain| <= SSD_TOL * (1 + |plain|) for y and the final state:
# the two differ in the order of their sums, their chunking and the
# kernel's split-TF32 products, which keep about fp32 accuracy (the JAX
# package holds its Pallas kernel to its jnp path at 2e-4)
SSD_TOL = 2e-4
# PR 13's yardstick, kept beside the bound so that phase 6's rows compare
# across kernel designs: the chunked algorithm at L = 32 with C B^T per
# head, at the fp32 rate
SSD_L32_CHUNK = 32
# fp mamba2-130m at full width, ssd_scan against the plain SSD on the card:
# relative L2 of the prefill logits (no quantizer in between to flip)
MAMBA_FP_TOL = 1e-4
# the case of each paged kernel that the kernels line reports: the engine's
# bf16 pool and one split, at a context near the engine's mean
LINE_CASE = {"dtype": "bf16", "context": 512, "splits": 1}
# |kernel - plain| <= PAGED_TOL * (1 + |plain|): both run the same fp32
# online softmax over the same blocks; only the order of the sums inside
# a block differs (and expf's last bit)
PAGED_TOL = 1e-5


class SmokeFailure(RuntimeError):
    """A phase found the port wrong."""


def check(cond: bool, msg: str) -> None:
    """Fail the phase with ``msg`` unless ``cond``."""
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_setup(torch) -> dict:
    """Card present, fp32 matmuls in full fp32, kernels built."""
    from repro_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmul precision is not 'highest'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + (" | ".join(lines) or "(already built)"))
    for name in _build.SOURCES:
        _build.load(name)
    print(f"  built {len(logs)} kernels in {build_s:.1f}s; device "
          f"{torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}"
          f", torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"  {gpu_name_and_power()}")
    return {"build_s": build_s}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def cuda_time_ms(torch, fn, n_args: int, reps: int = 20,
                 rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls, by CUDA
    events; call ``i`` gets argument set ``i % n_args``, so that a caller
    can rotate weight copies whose sum exceeds the 50 MB L2 cache (the main
    path finds its weights cold)."""
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    times = []
    for r in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn((r * reps + i) % n_args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def sleep_ms_per_cycle(torch) -> float:
    """Milliseconds of one cycle of ``torch.cuda._sleep``, the card's spin
    kernel (measured: its clock runs at the card's own rate)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10_000_000


def device_ms(torch, fn, n_args: int, reps: int = 20,
              rounds: int = 5) -> float:
    """Device time per call: CUDA events around ``reps`` calls queued
    behind a spin kernel that holds the card until the host has queued
    them all, so that host dispatch gaps are not in it (a round whose
    queueing outlasted the spin is repeated with a longer spin). Median
    over ``rounds``; arguments rotate as in :func:`cuda_time_ms`."""
    per_cycle = sleep_ms_per_cycle(torch)
    spin_ms = 20.0
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    times = []
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms / per_cycle))
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            fn((len(times) * reps + i) % n_args)
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued_ms > 0.8 * spin_ms:
            check(spin_ms < 2000, "the host cannot queue the calls")
            spin_ms *= 2
            continue
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def graph_ms(torch, fn, reps: int = 5, rounds: int = 3) -> float:
    """Device time of one call of ``fn``: the call captured as a CUDA graph
    (warmed up on a side stream, as capture requires) and replayed back to
    back, so that the card never waits for the host. For calls of
    thousands of small launches, which fill the launch queue behind the
    spin kernel of :func:`device_ms`; the graph's gaps between its
    kernels are in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(torch, lambda i: graph.replay(), 1, reps=reps,
                      rounds=rounds)
    del graph
    return ms


def n_copies(nbytes: int) -> int:
    """Weight copies to rotate so that their sum exceeds L2 four times."""
    return max(1, math.ceil(200e6 / nbytes))


def bound_ms(nbytes: float, flops: float,
             rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time of the work on the card and what sets it: ``flops``
    at ``rate`` against ``nbytes`` at the HBM bandwidth."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mvm_bounds(nbytes: float, m: int, k: int, n: int, mapping: str) -> dict:
    """Both bounds of an [M, K] @ [K, N] launch: the fp32 one (2MKN flops at
    the CUDA cores' rate) and the tensor-core one (2 x 2MKN TF32 flops);
    ``bound_ms`` is the one of the launch's mapping."""
    fp32, fp32_by = bound_ms(nbytes, 2.0 * m * k * n)
    tf32, tf32_by = bound_ms(nbytes, 4.0 * m * k * n, TF32_FLOP_PER_S)
    mma = mapping == "mma"
    return {"bound_ms": tf32 if mma else fp32,
            "bound_by": tf32_by if mma else fp32_by,
            "fp32_bound_ms": fp32, "mma_bound_ms": tf32}


def analog_flips(torch, x, w, beta, bound, off, y_k,
                 strict: bool = True) -> tuple[int, float]:
    """Mismatches of ``y_k`` against the plain version; with ``strict``
    each is checked to be one ADC level at a near-tie of the plain version
    (|frac(y * inv) - 1/2| within the fp32 dot error bound K * 2^-24 *
    (|x_q| . |w|) * inv). Returns their count and the largest absolute
    difference."""
    from repro_torch.kernels import ref

    m, k = x.shape
    y_r = ref.analog_matmul_ref(x, w, beta, bound, off)
    check(bool(torch.isfinite(y_k).all()), "analog_matmul: non-finite")
    qi, qo = 127.0, 127.0
    b = torch.clamp_min(bound, 1e-8)
    x_q = ref.div(beta, qi) * torch.round(
        ref.clip(x, -beta, beta) * ref.rdiv(qi, beta))
    y = x_q @ w
    if off is not None:
        y = y + off
    inv = ref.rdiv(qo, b) * ref.ADC_TIE_BREAK
    v = y * inv
    tie_dist = (v - torch.floor(v) - 0.5).abs()
    err_bound = k * U32 * (x_q.abs() @ w.abs()) * inv
    lsb = ref.div(b, qo).expand_as(y_k)
    diff = (y_k - y_r).abs()
    flips = diff != 0
    n_flip = int(flips.sum())
    if n_flip and strict:
        rel = ((diff[flips] - lsb[flips]).abs() / lsb[flips]).max()
        check(float(rel) < 1e-3,
              f"analog_matmul {m}x{k}x{w.shape[1]}: a mismatch is not one "
              f"ADC level (rel dev {float(rel):.3e})")
        near = tie_dist[flips] <= err_bound[flips]
        check(bool(near.all()),
              f"analog_matmul {m}x{k}x{w.shape[1]}: a mismatch is not a "
              f"near-tie")
    return n_flip, float(diff.max())


def analog_case(torch, gen, m, k, n, with_off: bool) -> dict:
    """One analog_matmul shape: parity against the plain version (flip
    rate over at least PARITY_OUTPUTS outputs, with and without promotion
    on the mma mapping), the folded bound against the explicit one, and
    times."""
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    lam = 14.0
    copies = n_copies(4 * k * n)
    ws = [torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
          for _ in range(copies)]
    x = torch.randn((m, k), generator=gen, device=dev)
    beta = torch.full((1,), 3.0, device=dev)
    bounds = [ref.adc_bound(w, beta, lam) for w in ws]
    offs = [0.1 * b * torch.randn((n,), generator=gen, device=dev)
            if with_off else None for b in bounds]
    plan = dispatch.select_blocks(m, k, n, kernel="analog_matmul")

    # the main path's call folds the bound; it must equal the explicit one
    y_fold = km.analog_matmul(x, ws[0], beta, None, offs[0], lam=lam)
    y_k = km.analog_matmul(x, ws[0], beta, bounds[0], offs[0])
    check(bool(torch.equal(y_fold, y_k)),
          f"analog_matmul {m}x{k}x{n}: the folded ADC bound differs from "
          f"ref.adc_bound's")
    draws = max(1, math.ceil(PARITY_OUTPUTS / (m * n)))
    n_flip = n_flip_np = 0
    max_err = 0.0
    for d in range(draws):
        i = d % copies
        xd = x if d == 0 else torch.randn((m, k), generator=gen, device=dev)
        yd = y_k if d == 0 else km.analog_matmul(xd, ws[i], beta, bounds[i],
                                                 offs[i])
        f, e = analog_flips(torch, xd, ws[i], beta, bounds[i], offs[i], yd)
        n_flip += f
        max_err = max(max_err, e)
        if plan.mapping == "mma":
            n_flip_np += analog_flips(
                torch, xd, ws[i], beta, bounds[i], offs[i],
                km.analog_matmul(xd, ws[i], beta, bounds[i], offs[i],
                                 promote=False), strict=False)[0]
    outputs = draws * m * n
    check(n_flip <= MAX_FLIP_RATE * outputs,
          f"analog_matmul {m}x{k}x{n}: {n_flip} of {outputs} outputs flip "
          f"(rate above {MAX_FLIP_RATE:.0e})")

    def kernel(i):
        return km.analog_matmul(x, ws[i], beta, None, offs[i], lam=lam)

    ms = device_ms(torch, kernel, copies)
    wall = cuda_time_ms(torch, kernel, copies)
    explicit = device_ms(torch, lambda i: km.analog_matmul(
        x, ws[i], beta, bounds[i], offs[i]), copies)
    plain = device_ms(torch, lambda i: ref.analog_matmul_ref(
        x, ws[i], beta, None, offs[i], lam=lam), copies, reps=5, rounds=3)
    mm = device_ms(torch, lambda i: x @ ws[i], copies)
    # the ADC bound pass that analog_linear ran beside every fused call
    # before the kernel folded it
    bound_calc = device_ms(torch, lambda i: ref.adc_bound(ws[i], beta, lam),
                           copies)
    # x, w, beta, col_off read once, the output written once
    nbytes = 4 * (m * k + k * n + 1 + (n if with_off else 0) + m * n)
    return {"M": m, "K": k, "N": n, "col_off": with_off, "ms": ms,
            "explicit_bound_ms": explicit, "wall_ms": wall,
            "plain_ms": plain, "matmul_ms": mm, "adc_bound_ms": bound_calc,
            **mvm_bounds(nbytes, m, k, n, plan.mapping),
            "mapping": plan.mapping, "splits": plan.splits, "flips": n_flip,
            "parity_outputs": outputs, "flip_rate": n_flip / outputs,
            "flip_rate_unpromoted": (n_flip_np / outputs
                                     if plan.mapping == "mma" else None),
            "max_abs_err": max_err}


def int4_case(torch, gen, m, k, n) -> dict:
    """One int4_matmul shape: parity against the plain version, times."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import int4_matmul as k4

    dev = torch.device("cuda")
    copies = n_copies(k * n // 2)
    packs = [ref.pack_int4(torch.randint(-7, 8, (k, n), generator=gen,
                                         device=dev, dtype=torch.int8))
             for _ in range(copies)]
    scales = [(torch.rand((n,), generator=gen, device=dev) + 0.5) * 0.01
              for _ in range(copies)]
    x = torch.randn((m, k), generator=gen, device=dev)
    plan = dispatch.select_blocks(m, k, n, kernel="int4_matmul")

    y_k = k4.int4_matmul(x, packs[0], scales[0])
    y_r = ref.int4_matmul_ref(x, packs[0], scales[0])
    w_deq = ref.unpack_int4(packs[0]).float() * scales[0]
    err_bound = k * U32 * (x.abs() @ w_deq.abs())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y_k).all()), "int4_matmul: non-finite")
    diff = (y_k - y_r).abs()
    check(bool((diff <= err_bound).all()),
          f"int4_matmul {m}x{k}x{n}: outside the fp32 dot error bound "
          f"(max err {float(diff.max()):.3e})")
    err_ratio = float((diff / err_bound).max())
    del w_deq, err_bound

    def kernel(i):
        return k4.int4_matmul(x, packs[i], scales[i])

    ms = device_ms(torch, kernel, copies)
    wall = cuda_time_ms(torch, kernel, copies)
    plain = device_ms(torch, lambda i: ref.int4_matmul_ref(
        x, packs[i], scales[i]), copies, reps=5, rounds=3)
    w_mm = [torch.randn((k, n), generator=gen, device=dev)
            for _ in range(n_copies(4 * k * n))]
    mm = device_ms(torch, lambda i: x @ w_mm[i], len(w_mm))
    nbytes = 4 * m * k + k * n // 2 + 4 * n + 4 * m * n
    return {"M": m, "K": k, "N": n, "ms": ms, "wall_ms": wall,
            "plain_ms": plain, "matmul_ms": mm,
            **mvm_bounds(nbytes, m, k, n, plan.mapping),
            "mapping": plan.mapping, "splits": plan.splits,
            "max_abs_err": float(diff.max()),
            "max_err_over_bound": err_ratio}


def phase_kernels(torch) -> dict:
    """Parity and times of both kernels at every main-path shape of
    llama-3.2-1b (static and continuous engine) and mamba2-130m (each row
    names its ``arch``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"analog_matmul": [], "int4_matmul": []}
    shapes = ([(ARCH, site, k, n, m) for site, k, n, _ in SITES
               for m in (M_DECODE, M_PREFILL, M_ENGINE_DECODE,
                         M_ENGINE_CHUNK)]
              + [(MAMBA, site, k, n, m) for site, k, n, _ in MAMBA_SITES
                 for m in (M_DECODE, MAMBA_M_PREFILL)])
    for arch, site, k, n, m in shapes:
        # the engine's shapes only as the main path runs them (no col_off)
        offs = ((False,) if m in (M_ENGINE_DECODE, M_ENGINE_CHUNK)
                else (False, True))
        for with_off in offs:
            r = analog_case(torch, gen, m, k, n, with_off)
            r["site"], r["arch"] = site, arch
            rows["analog_matmul"].append(r)
            unprom = ("" if r["flip_rate_unpromoted"] is None else
                      f", unpromoted {r['flip_rate_unpromoted']:.2e}")
            print(f"  analog_matmul {site:8s} M={m:4d} {k}->{n} "
                  f"off={int(with_off)} {r['mapping']} x{r['splits']}: "
                  f"{r['ms']:.4f} ms folded (explicit bound "
                  f"{r['explicit_bound_ms']:.4f}, wall {r['wall_ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, matmul {r['matmul_ms']:.4f}; "
                  f"bound {r['bound_ms']:.4f} by {r['bound_by']}, fp32 "
                  f"{r['fp32_bound_ms']:.4f}, mma {r['mma_bound_ms']:.4f}; "
                  f"adc_bound {r['adc_bound_ms']:.4f}), flips {r['flips']} "
                  f"of {r['parity_outputs']} ({r['flip_rate']:.2e}{unprom})")
        r = int4_case(torch, gen, m, k, n)
        r["site"], r["arch"] = site, arch
        rows["int4_matmul"].append(r)
        print(f"  int4_matmul   {site:8s} M={m:4d} {k}->{n} {r['mapping']} "
              f"x{r['splits']}: {r['ms']:.4f} ms (wall {r['wall_ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, matmul {r['matmul_ms']:.4f}; "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']}, fp32 "
              f"{r['fp32_bound_ms']:.4f}, mma {r['mma_bound_ms']:.4f}), "
              f"err/bound {r['max_err_over_bound']:.2e}")
        torch.cuda.empty_cache()
    for name, cases in rows.items():
        for arch, m, tot in forward_totals(cases):
            print(f"  {name} per {arch} forward at M={m}: "
                  + ", ".join(f"{key} {val:.4f}" for key, val in tot.items()))
    return rows


#: analog sites of one forward, by site name (llama's and mamba2-130m's)
PER_SITE = {s[0]: s[3] for s in SITES + MAMBA_SITES}
#: the per-shape times and bounds that forward_totals sums
TOTAL_KEYS = ("ms", "explicit_bound_ms", "plain_ms", "matmul_ms",
              "adc_bound_ms", "bound_ms", "fp32_bound_ms", "mma_bound_ms")


def forward_totals(cases: list) -> list:
    """(arch, M, {key: total over the sites of one forward}) for every
    (arch, M) of phase 2, without col_off (which the main path does not
    use)."""
    out = {}
    for r in cases:
        if r.get("col_off"):
            continue
        tot = out.setdefault((r["arch"], r["M"]), {})
        for key in TOTAL_KEYS:
            if key in r:
                tot[key] = tot.get(key, 0.0) + PER_SITE[r["site"]] * r[key]
    return [(arch, m, tot) for (arch, m), tot in out.items()]


# ---------------------------------------------------------------------------
# phase 5: the paged-attention kernels
# ---------------------------------------------------------------------------

def paged_tables(torch, gen, rows: int, context: int, chunk: int):
    """Block tables and cursors: row ``b`` starts at a ragged ``start[b]``
    (0 to 4 blocks of left pad) and its last query column attends exactly
    ``context`` tokens. Distinct random physical blocks per row; block 0
    is the sink."""
    dev = torch.device("cuda")
    bs = PAGED_BS
    start = torch.randint(0, 4 * bs, (rows,), generator=gen, device=dev)
    pos = start + context - chunk               # first column of the chunk
    nb = -(-(4 * bs + context) // bs)
    npool = 1 + rows * nb
    perm = torch.randperm(npool - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(rows, nb).to(torch.int32).contiguous()
    return (tbl, pos.to(torch.int32).contiguous(),
            start.to(torch.int32).contiguous(), npool)


def paged_pool(torch, gen, npool: int, dtype: str):
    """One random pool ``(kp, vp, k_scale, v_scale)`` of ``dtype``."""
    dev = torch.device("cuda")
    shape = (npool, PAGED_BS, PAGED_KV, PAGED_HD)
    if dtype == "i8":
        return tuple(torch.randint(-127, 128, shape, generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)) + tuple(
            torch.rand(shape[:3], generator=gen, device=dev) * 0.02
            for _ in range(2))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                 for _ in range(2)) + (None, None)


def gather_sdpa(torch, q, kp, vp, ks, vs, tbl, pos, start, scale):
    """The yardstick: gather each row's logical view ``kp[tbl]`` out of the
    pool and run PyTorch's ``scaled_dot_product_attention`` on it with the
    ``start <= j <= pos + i`` mask. q is [B, H, hd] (decode) or
    [B, S, H, hd] (prefill). Never used by the port."""
    F = torch.nn.functional
    decode = q.dim() == 3
    qs = q[:, None] if decode else q                 # [B, S, H, hd]
    b, s, nq, hd = qs.shape
    idx = tbl.long()
    k, v = kp[idx], vp[idx]                          # [B, NB, bs, KV, hd]
    if ks is not None:
        k = k.float() * ks[idx][..., None]
        v = v.float() * vs[idx][..., None]
    t, nkv = k.shape[1] * k.shape[2], k.shape[3]

    def heads(x):      # [B, t, KV, hd] -> [B, H, t, hd], GQA groups by view
        x = x.reshape(b, t, nkv, 1, hd).expand(b, t, nkv, nq // nkv, hd)
        return x.reshape(b, t, nq, hd).transpose(1, 2).float()

    qpos = pos.long()[:, None] + torch.arange(s, device=q.device)[None]
    j = torch.arange(t, device=q.device)
    mask = ((j[None, None] >= start.long()[:, None, None])
            & (j[None, None] <= qpos[..., None]))
    out = F.scaled_dot_product_attention(
        qs.transpose(1, 2).float(), heads(k), heads(v),
        attn_mask=mask[:, None], scale=scale)
    out = out.transpose(1, 2)
    return out[:, 0] if decode else out


def paged_case(torch, gen, kind: str, context: int, dtype: str,
               splits: int) -> dict:
    """One paged kernel case: parity against the plain version (and the
    yardstick against it, loosely), then device times of the kernel, the
    plain version and the yardstick beside the card's bound. Pool copies
    rotate so that the live bytes of all copies exceed the 50 MB L2."""
    from repro_torch.kernels import paged_attention as kd
    from repro_torch.kernels import paged_prefill as kp_
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    decode = kind == "decode"
    rows = DECODE_ROWS if decode else PREFILL_ROWS
    chunk = 1 if decode else ENGINE_CHUNK
    tbl, pos, start, npool = paged_tables(torch, gen, rows, context, chunk)
    elem = {"f32": 4, "bf16": 2, "i8": 1}[dtype]
    live = rows * context                      # tokens the kernel must read
    kv_bytes = live * PAGED_KV * (2 * PAGED_HD * elem
                                  + (8 if dtype == "i8" else 0))
    pools = [paged_pool(torch, gen, npool, dtype)
             for _ in range(n_copies(kv_bytes))]
    qshape = ((rows, PAGED_H, PAGED_HD) if decode
              else (rows, chunk, PAGED_H, PAGED_HD))
    q = torch.randn(qshape, generator=gen, device=dev)
    scale = PAGED_HD ** -0.5

    if decode:
        def kernel(i):
            kp, vp, ks, vs = pools[i]
            return kd.paged_flash_decode(q, kp, vp, tbl, pos, start,
                                         scale=scale, k_scale=ks, v_scale=vs,
                                         num_splits=splits)

        def plain(i):
            kp, vp, ks, vs = pools[i]
            return ref.paged_decode_ref(q, kp, vp, tbl, pos, start, scale,
                                        ks, vs, num_splits=splits)
    else:
        def kernel(i):
            kp, vp, ks, vs = pools[i]
            return kp_.paged_flash_prefill(q, kp, vp, tbl, pos, start,
                                           scale=scale, k_scale=ks,
                                           v_scale=vs)

        def plain(i):
            kp, vp, ks, vs = pools[i]
            return ref.paged_prefill_ref(q, kp, vp, tbl, pos, start, scale,
                                         ks, vs)

    def library(i):
        return gather_sdpa(torch, q, *pools[i], tbl, pos, start, scale)

    # none of the timed calls may make the host wait for the card
    # (device_ms queues them behind a spin kernel)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, want, lib = kernel(0), plain(0), library(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    name = (f"paged {kind} ctx={context} {dtype}"
            + (f" splits={splits}" if decode else ""))
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = (out - want).abs()
    check(bool((err <= PAGED_TOL * (1 + want.abs())).all()),
          f"{name}: differs from the plain version by {float(err.max()):.3e}")
    lib_err = float((lib - want).abs().max())
    check(lib_err < 1e-3, f"{name}: the yardstick computes something else "
          f"({lib_err:.3e})")
    n = len(pools)
    ms = device_ms(torch, kernel, n)
    wall = cuda_time_ms(torch, kernel, n)
    # the plain version launches about 20 kernels per block of the table
    # (over 4000 at context 2048): timed as a graph on one pool copy
    plain_ms = graph_ms(torch, lambda: plain(0), reps=3)
    lib_ms = device_ms(torch, library, n, reps=5, rounds=3)
    # each input read once, the output written once: live K/V (+ scales),
    # q, out, the table rows and cursors
    nbytes = (kv_bytes + 2 * 4 * q.numel() + 4 * (tbl.numel() + 2 * rows))
    cols = torch.arange(chunk, dtype=torch.float64)
    attended = float((context - chunk + 1 + cols).sum()) * rows
    bnd, by = bound_ms(nbytes, 4.0 * PAGED_HD * PAGED_H * attended)
    pool_dtype = pools[0][0].dtype
    plan = (kd.decode_plan(PAGED_H, PAGED_KV, PAGED_HD, PAGED_BS, pool_dtype)
            if decode else kp_.prefill_plan(PAGED_HD, PAGED_BS, pool_dtype))
    del pools
    return {"kind": kind, "context": context, "dtype": dtype,
            "splits": splits, "rows": rows, "chunk": chunk, "ms": ms,
            "wall_ms": wall, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd, "bound_by": by, "copies": n,
            "max_abs_err": float(err.max()), "library_abs_err": lib_err,
            "plan": plan_dict(plan)}


def plan_dict(plan) -> dict:
    """A paged kernel's plan as its design parameters: warps of a thread
    block, query vectors of its tile, the lanes of a warp (tile x key
    lanes x chunk lanes), the keys a warp takes per iteration (one pool
    block) and per lane, and the pool blocks in flight per warp."""
    return {"warps": plan.warps, "tile": plan.tile,
            "lanes": [plan.tile, plan.key_lanes, plan.chunk_lanes],
            "keys_per_warp_iteration": PAGED_BS,
            "keys_per_lane": -(-PAGED_BS // plan.key_lanes),
            "stages": plan.stages}


def phase_paged(torch) -> dict:
    """Parity and times of both paged kernels at every listed case."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {"paged_flash_decode": [], "paged_flash_prefill": []}
    for context in PAGED_CONTEXTS:
        for dtype in POOL_DTYPES:
            cases = [("decode", s) for s in DECODE_SPLITS] + [("prefill", 1)]
            for kind, splits in cases:
                r = paged_case(torch, gen, kind, context, dtype, splits)
                rows[f"paged_flash_{kind}"].append(r)
                pl = r["plan"]
                print(f"  {kind:7s} ctx={context:4d} {dtype:4s} "
                      f"splits={splits}: {r['ms']:.4f} ms (wall "
                      f"{r['wall_ms']:.4f}, plain {r['plain_ms']:.4f}, "
                      f"gather+sdpa {r['library_ms']:.4f}, bound "
                      f"{r['bound_ms']:.4f} by {r['bound_by']}), max err "
                      f"{r['max_abs_err']:.2e}; {pl['warps']} warps, tile "
                      f"{pl['tile']}, lanes {'x'.join(map(str, pl['lanes']))}"
                      f", {pl['keys_per_warp_iteration']} keys per warp "
                      f"iteration ({pl['keys_per_lane']} a lane), "
                      f"{pl['stages']} stages")
                torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6: the ssd_scan kernel
# ---------------------------------------------------------------------------

def ssd_inputs(torch, gen, cfg, rows: int, tokens: int, with_h0: bool,
               pads=None):
    """One scan's inputs at ``cfg``'s widths, laid out as the mixer hands
    them to the kernel: x, b and c are strided views of one
    ``[rows, tokens, conv_ch]`` projection, dt is ``softplus`` of a random
    pre-activation plus the reference's initial bias. ``pads[r]`` left
    positions of row ``r`` are masked (dt = 0, x = b = c = 0), as a
    left-padded prompt chunk is."""
    dev = torch.device("cuda")
    heads, pdim = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    d_inner = heads * pdim
    xbc = torch.nn.functional.silu(torch.randn(
        (rows, tokens, d_inner + 2 * g * n), generator=gen, device=dev))
    dt = torch.nn.functional.softplus(
        torch.randn((rows, tokens, heads), generator=gen, device=dev)
        + math.log(math.expm1(0.01)))
    if pads is not None:
        live = (torch.arange(tokens, device=dev)[None]
                >= torch.as_tensor(pads, device=dev)[:, None]).float()
        xbc = xbc * live[..., None]
        dt = dt * live[..., None]
    a = -torch.linspace(1.0, 16.0, heads, device=dev)
    h0 = (torch.randn((rows * heads, n, pdim), generator=gen, device=dev)
          if with_h0 else None)
    x = xbc[..., :d_inner].reshape(rows, tokens, heads, pdim)
    b = xbc[..., d_inner:d_inner + g * n].reshape(rows, tokens, g, n)
    c = xbc[..., d_inner + g * n:].reshape(rows, tokens, g, n)
    return x, dt, a, b, c, h0


def ssd_case(torch, gen, cfg, name: str, rows: int, tokens: int,
             with_h0: bool) -> dict:
    """One ssd_scan case: parity against the plain version (y and the final
    state), then device times of both beside the card's bound, and each
    device pass's time from the profiler. A scan the plan runs in one
    launch is also run and timed as the three passes. Input copies rotate
    so that their bytes exceed the 50 MB L2."""
    from repro_torch.kernels import _launch, ref
    from repro_torch.kernels import ssd_scan as ks

    heads, pdim = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    pads = ([11] + [0] * (rows - 1)) if with_h0 else None
    in_bytes = 4 * (rows * tokens * (heads * pdim + heads + 2 * g * n)
                    + (rows * heads * n * pdim if with_h0 else 0))
    sets = [ssd_inputs(torch, gen, cfg, rows, tokens, with_h0, pads)
            for _ in range(n_copies(in_bytes))]
    plan = _launch.ssd_plan(rows, tokens, heads, pdim, n, g)

    def kernel(i):
        return ks.ssd_scan(*sets[i])

    torch.cuda.set_sync_debug_mode("error")
    try:
        (y, h), (y_r, h_r) = kernel(0), ref.ssd_scan_ref(*sets[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    errs = []
    for what, out, want in (("y", y, y_r), ("state", h, h_r)):
        check(bool(torch.isfinite(out).all()), f"ssd {name}: non-finite "
              f"{what}")
        err = (out - want).abs()
        check(bool((err <= SSD_TOL * (1 + want.abs())).all()),
              f"ssd {name}: {what} differs from the plain version by "
              f"{float(err.max()):.3e}")
        errs.append(float(err.max()))
    passes_ms = None
    if plan.launches == 1:
        for out, want in zip(ks.ssd_scan(*sets[0], passes=True), (y_r, h_r)):
            err = (out - want).abs()
            check(bool((err <= SSD_TOL * (1 + want.abs())).all()),
                  f"ssd {name}: the three passes differ from the plain "
                  f"version by {float(err.max()):.3e}")
            errs.append(float(err.max()))
        passes_ms = device_ms(
            torch, lambda i: ks.ssd_scan(*sets[i], passes=True), len(sets))
    ms = device_ms(torch, kernel, len(sets))
    wall = cuda_time_ms(torch, kernel, len(sets))
    pass_us = ssd_pass_us(torch, kernel, len(sets))
    # the plain version runs a loop over chunks: timed as a graph
    plain_ms = graph_ms(torch, lambda: ref.ssd_scan_ref(*sets[0]), reps=3)
    # each input read once (b / c per group), y and the state written once.
    # The least work of the function is the recurrence's C h and state
    # update, 2 N P FMAs per token and head (a chunked form adds L (P + N G
    # / H)), two operations per FMA; the kernel runs its products as split
    # TF32 on the tensor cores, three TF32 products per fp32 product
    nbytes = in_bytes + 4 * (heads + rows * tokens * heads * pdim
                             + rows * heads * n * pdim)
    flops = 2.0 * rows * tokens * heads * 2 * n * pdim
    bnd, by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    l32_flops = 2.0 * rows * tokens * heads * (
        SSD_L32_CHUNK * (n + pdim) + 2 * n * pdim)
    l32_bnd, l32_by = bound_ms(nbytes, l32_flops)
    del sets
    return {"case": name, "rows": rows, "tokens": tokens, "h0": with_h0,
            "plan": {"chunk": plan.chunk, "launches": plan.launches,
                     "blocks": list(plan.blocks),
                     "scratch_mb": plan.scratch / 1e6},
            "ms": ms, "wall_ms": wall, "passes_ms": passes_ms,
            "pass_us": pass_us,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "l32_bound_ms": l32_bnd, "l32_bound_by": l32_by,
            "gflop": flops / 1e9, "l32_gflop": l32_flops / 1e9,
            "mbytes": nbytes / 1e6,
            "max_abs_err": max(errs), "y_abs_err": errs[0],
            "state_abs_err": errs[1]}


def ssd_pass_us(torch, fn, n_args: int, reps: int = 10) -> dict:
    """Device µs per call of each ``ssd_*_kernel`` that ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls after 3 warm-up calls;
    arguments rotate as in :func:`cuda_time_ms`."""
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i % n_args)
        torch.cuda.synchronize()
    return {ev.key.split("ssd_")[1].split("_kernel")[0]:
            ev.device_time * ev.count / reps
            for ev in prof.key_averages() if "ssd_" in ev.key}


def phase_ssd(torch) -> list:
    """Parity and times of ssd_scan at mamba2-130m's shapes."""
    from repro_torch.configs import get_config

    cfg = get_config(MAMBA)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for name, b, s, with_h0 in SSD_CASES:
        r = ssd_case(torch, gen, cfg, name, b, s, with_h0)
        rows.append(r)
        passes = ("" if r["passes_ms"] is None else
                  f", as the three passes {r['passes_ms']:.4f} ms")
        print(f"  ssd_scan {name:6s} {b} x {s:4d} h0={int(with_h0)}: "
              f"{r['ms']:.4f} ms (wall {r['wall_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}: 3 x {r['gflop']:.3f} GFLOP on TF32, "
              f"{r['mbytes']:.1f} MB; PR 13's L = 32 fp32 bound "
              f"{r['l32_bound_ms']:.4f} by {r['l32_bound_by']}: "
              f"{r['l32_gflop']:.3f} GFLOP){passes}, max err y "
              f"{r['y_abs_err']:.2e} state {r['state_abs_err']:.2e}; plan L "
              f"{r['plan']['chunk']}, {r['plan']['launches']} launches, "
              f"blocks {r['plan']['blocks']}, scratch "
              f"{r['plan']['scratch_mb']:.1f} MB; device us per pass "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["pass_us"].items()))
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 7: mamba2-130m on the static engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_ssd():
    """Inside the block ``dispatch.ssd`` runs the plain SSD version on the
    card in place of the kernel: the full-width check of the kernel path
    (the port itself never hands a CUDA tensor to a plain version)."""
    from repro_torch.kernels import dispatch, ref

    real = dispatch.ssd_scan
    dispatch.ssd_scan = ref.ssd_scan_ref
    try:
        yield
    finally:
        dispatch.ssd_scan = real


def mamba_static_phase(torch, cfg, params, labels, deploy: str) -> dict:
    """Serve full-width mamba2-130m under ``deploy`` on the static engine
    and check it: ``fp`` against the plain SSD version on the card,
    ``analog_hw`` (fused) against unfused, ``digital_int4`` against
    ``digital_rtn4``. Every projection must run on the deployment's MVM
    kernel and every layer of the prefill on ``ssd_scan``."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serve.decode import generate, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    p, acfg = deploy_model(_deploy_args(deploy), cfg, params, labels, gen)
    base_p, base_acfg, mvm = p, acfg, None
    if deploy == "analog_hw":
        acfg = dataclasses.replace(acfg, use_pallas=True)
        base_acfg, mvm = dataclasses.replace(acfg, use_pallas=False), \
            "analog_matmul"
    elif deploy == "digital_int4":
        base_p, base_acfg = deploy_model(_deploy_args("digital_rtn4"), cfg,
                                         params, labels, gen)
        mvm = "int4_matmul"
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, MAMBA_PROMPT),
                           generator=gen, device=dev)
    counters = _counters()
    torch.cuda.synchronize()
    for m in counters.values():
        m.launches = 0
    t0 = time.perf_counter()
    toks = generate(p, cfg, acfg, gen, prompt, MAMBA_NEW,
                    greedy_first=MAMBA_NEW)
    toks_host = toks.cpu()
    gen_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in counters.items()}
    want = {"ssd_scan": cfg.num_layers}               # the prefill forward
    if mvm is not None:
        want[mvm] = mvm_sites(cfg) * (1 + MAMBA_NEW)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"mamba {deploy}: {name} launched {n} "
              f"times, expected {want.get(name, 0)}")
    check(tuple(toks_host.shape) == (BATCH, MAMBA_NEW)
          and int(toks_host.min()) >= 0
          and int(toks_host.max()) < cfg.vocab_size,
          f"mamba {deploy}: bad tokens {toks_host}")

    lf, _, _ = prefill(p, cfg, acfg, prompt, MAMBA_PROMPT + 1)
    with (plain_ssd() if deploy == "fp" else contextlib.nullcontext()):
        lb, _, _ = prefill(base_p, cfg, base_acfg, prompt, MAMBA_PROMPT + 1)
        base_toks = generate(base_p, cfg, base_acfg, gen, prompt, MAMBA_NEW,
                             greedy_first=MAMBA_NEW).cpu()
    check(bool(torch.isfinite(lf).all()), f"mamba {deploy}: non-finite "
          f"logits")
    rel_l2 = float(torch.linalg.vector_norm(lf - lb)
                   / torch.linalg.vector_norm(lb))
    res = {"deploy": deploy, "launches": launches, "generate_s": gen_s,
           "tokens_per_s": BATCH * MAMBA_NEW / gen_s, "rel_l2": rel_l2,
           "max_logit_diff": float((lf - lb).abs().max()),
           "greedy_agree": int((toks_host == base_toks).sum()),
           "first_token_agree": int((toks_host[:, 0]
                                     == base_toks[:, 0]).sum())}
    if deploy == "fp":
        what = "plain SSD"
        check(rel_l2 < MAMBA_FP_TOL, f"mamba fp: ssd_scan vs the plain SSD "
              f"logits rel L2 {rel_l2:.3e} >= {MAMBA_FP_TOL}")
    else:
        what = "unfused" if deploy == "analog_hw" else "digital_rtn4"
        n_sites, n_el, n_flip = site_parity(
            torch, cfg, p, acfg, base_p, base_acfg, prompt,
            sites=mvm_sites(cfg))
        res.update(sites=n_sites, site_elements=n_el, site_flips=n_flip)
        check(rel_l2 < E2E_TOL, f"mamba {deploy}: fused vs {what} logits "
              f"rel L2 {rel_l2:.3e} >= {E2E_TOL}")
    res.update(step_times(torch, cfg, p, acfg, prompt, MAMBA_STEP_TOKENS))
    print(f"  mamba {deploy}: launches {launches}, generate {gen_s:.2f}s; vs "
          f"{what}: " + (f"{res['site_flips']} of {res['site_elements']} site "
                         f"outputs one ADC level apart at near-ties; "
                         if "sites" in res else "")
          + f"max |dlogit| {res['max_logit_diff']:.3e}, rel L2 {rel_l2:.3e}, "
          f"greedy tokens agree {res['greedy_agree']}/{BATCH * MAMBA_NEW}; "
          f"prefill {res['prefill_ms']:.2f} ms, decode "
          f"{res['decode_ms']:.2f} ms/step, on the device "
          f"{res['decode_device_ms']:.2f} ms (busy {res['device_busy']:.3f})")
    del p, base_p
    torch.cuda.empty_cache()
    return res


def phase_mamba_static(torch) -> dict:
    """Full-width mamba2-130m (random weights from a seed) on the static
    engine under fp, analog_hw and digital_int4."""
    from repro_torch.models import build

    dev = torch.device("cuda")
    cfg, params, labels = build(MAMBA, torch.Generator(
        device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    check(cfg.num_layers == 24 and cfg.d_model == 768
          and cfg.ssm_heads == 24 and cfg.padded_vocab == 50432
          and mvm_sites(cfg) == MAMBA_MVM_PER_FORWARD,
          f"unexpected config {cfg}")
    print(f"  {MAMBA}: {n_params / 1e6:.1f}M params")
    out = {"params": n_params}
    for deploy in ("fp", "analog_hw", "digital_int4"):
        out[deploy] = mamba_static_phase(torch, cfg, params, labels, deploy)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the continuous engine at full width
# ---------------------------------------------------------------------------

def engine_requests(cfg, n: int, seed: int):
    """``n`` mixed-length requests: prompts of 32-480 tokens, 16-64 new,
    sampled as the CLI samples (temperature 0.8, top-k 50)."""
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(32, 481))
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(
                np.int32), max_new=int(rng.integers(16, 65)),
            temperature=0.8, top_k=50, seed=seed + i))
    return reqs


def _counters():
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import int4_matmul as k4
    from repro_torch.kernels import paged_attention as kd
    from repro_torch.kernels import paged_prefill as kp_
    from repro_torch.kernels import ssd_scan as ks
    return {"analog_matmul": km, "int4_matmul": k4,
            "paged_flash_decode": kd, "paged_flash_prefill": kp_,
            "ssd_scan": ks}


def mvm_sites(cfg) -> int:
    """Analog sites of one forward: in_proj and out_proj of every mamba
    layer (the tied LM head is a plain matmul); qkv, o, gate_up and down of
    every attention layer, and the LM head unless tied."""
    if cfg.family == "ssm":
        return 2 * cfg.num_layers
    return 4 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)


def engine_phase(torch, cfg, params, labels, deploy: str,
                 kv_bits: int) -> dict:
    """Serve the mixed workload at full width with ``paged=True`` under
    ``deploy``; check that every request finished, every block came back
    (an ssm stack has no pool and must say why) and every call ran on its
    kernel; measure tokens/s and the device busy share of a decode
    step."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serve.scheduler import (SchedulerConfig, ServeEngine,
                                             required_max_len)

    gen = torch.Generator(device="cuda").manual_seed(7)
    p, acfg = deploy_model(_deploy_args(deploy), cfg, params, labels, gen)
    mvm = "analog_matmul"
    if deploy == "analog_hw":
        acfg = dataclasses.replace(acfg, use_pallas=True)
    else:
        mvm = "int4_matmul"
    acfg = dataclasses.replace(acfg, kv_bits=kv_bits)
    reqs = engine_requests(cfg, ENGINE_REQUESTS, seed=0)
    max_len = max(required_max_len(len(r.prompt), r.max_new, ENGINE_CHUNK)
                  for r in reqs)
    scfg = SchedulerConfig(num_slots=ENGINE_SLOTS, max_len=max_len,
                           prefill_chunk=ENGINE_CHUNK,
                           cache_dtype=torch.bfloat16, paged=True,
                           kv_block_size=PAGED_BS)
    eng = ServeEngine(p, cfg, acfg, scfg)
    counters = _counters()
    torch.cuda.synchronize()
    for m in counters.values():
        m.launches = 0
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in counters.items()}
    tag = f"{cfg.name} {deploy} kv_bits={kv_bits}"
    total = sum(len(v) for v in results.values())
    check(sorted(results) == [r.uid for r in reqs], f"{tag}: lost requests")
    for r in reqs:
        out = results[r.uid]
        check(eng.status[r.uid] == "finished" and len(out) == r.max_new
              and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"{tag}: request {r.uid} ended {eng.status[r.uid]} with "
              f"{len(out)}/{r.max_new} tokens")
    pool = eng.pool
    ssm = cfg.family == "ssm"
    if ssm:
        check(pool is None and "paged" in eng.gating_reasons,
              f"{tag}: paged on an ssm stack is not inert and explained")
    else:
        check(pool.num_live == 0 and pool.num_free == pool.num_blocks,
              f"{tag}: blocks not returned ({pool.num_live} live, "
              f"{pool.num_free}/{pool.num_blocks} free)")
    layers, forwards = cfg.num_layers, eng.decode_steps + eng.prefill_forwards
    want = {mvm: mvm_sites(cfg) * forwards}
    if ssm:
        want["ssd_scan"] = layers * eng.prefill_forwards
    else:
        want.update(paged_flash_decode=layers * eng.decode_steps,
                    paged_flash_prefill=layers * eng.prefill_forwards)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{tag}: {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    res = {"deploy": deploy, "kv_bits": kv_bits, "run_s": run_s,
           "tokens": total, "tokens_per_s": total / run_s,
           "decode_steps": eng.decode_steps, "mixed_steps": eng.mixed_steps,
           "prefill_forwards": eng.prefill_forwards,
           "decode_tokens_during_admission":
               eng.decode_tokens_during_admission,
           "phase_s": dict(eng.phase_time), "launches": launches,
           "gating_reasons": dict(eng.gating_reasons)}
    res.update(engine_busy(torch, cfg, p, acfg, scfg))
    print(f"  {tag}: {total} tokens of {len(reqs)} requests in {run_s:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s), {eng.decode_steps} decode "
          f"forwards, {eng.prefill_forwards} chunk forwards "
          f"({eng.mixed_steps} fused with decode), launches {launches}; "
          f"decode step {res['decode_step_ms']:.2f} ms host, "
          f"{res['decode_device_ms']:.2f} ms device (busy "
          f"{res['device_busy']:.3f}); chunk forward "
          f"{res['chunk_forward_ms']:.2f} ms host, "
          f"{res['chunk_device_ms']:.2f} ms device by "
          f"{res['chunk_timing']} (busy {res['chunk_busy']:.3f}, context "
          f"{res['chunk_context']:.0f})")
    del eng, p
    torch.cuda.empty_cache()
    return res


def engine_busy(torch, cfg, params, acfg, scfg) -> dict:
    """Device busy share of the engine's decode step: 8 greedy requests of
    256-token prompts are admitted and prefilled, then decode blocks run
    (host clock per decode forward, synchronized); the same step over the
    same slots is captured as a CUDA graph and replayed back to back, so
    the card never waits for the host (the graph's own gaps between its
    kernels are inside, so the share is an upper bound)."""
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.scheduler import Request, ServeEngine

    eng = ServeEngine(params, cfg, acfg, scfg)
    rng = np.random.default_rng(11)
    for i in range(ENGINE_SLOTS):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 256).astype(np.int32), max_new=96,
            temperature=0.0))
    while any(s is None or s.prefilling for s in eng.slots):
        eng.step()
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / (eng.decode_steps - steps0)
    check(all(s is not None for s in eng.slots), "busy: a slot retired")
    eng._refresh_device_state()
    d = eng._dev

    def step():
        logits, _ = serve_step(params, cfg, acfg, d["toks"][:, None],
                               eng.caches, d["off"][:, None],
                               seq_mask=d["active"][:, None])
        return torch.argmax(logits, dim=-1)

    dev_ms = graph_ms(torch, step, reps=10)
    res = {"decode_step_ms": host_ms, "decode_device_ms": dev_ms,
           "device_busy": dev_ms / host_ms}
    res.update(chunk_busy(torch, eng, cfg, params, acfg))
    del eng
    return res


def chunk_busy(torch, eng, cfg, params, acfg) -> dict:
    """Host and device time of one chunk forward of the engine (the
    forward of its mixed steps): slots 0 and 1 as the 2 compact rows of
    ``ENGINE_CHUNK`` columns at their live context, as ``_mixed_dispatch``
    runs it (the chunk's K/V land in the slots' own blocks; the cursors
    are not advanced). Host clock per synchronized call; the device time
    by a CUDA graph as for the decode step if one call makes the host
    wait nowhere (checked with the sync debug mode), else by CUDA events
    around back-to-back calls, and ``chunk_timing`` says where it
    waited."""
    from repro_torch.core.analog import AnalogCtx
    from repro_torch.models.model import apply as model_apply

    dev = eng.device
    idx = torch.arange(PREFILL_ROWS, device=dev)
    sub = eng._gather_rows(idx)
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_ROWS, ENGINE_CHUNK),
                         generator=gen, device=dev)
    off = eng._dev["off"][:PREFILL_ROWS, None]
    mask = torch.ones((PREFILL_ROWS, ENGINE_CHUNK), device=dev)

    def chunk():
        logits, _, _ = model_apply(params, cfg, acfg, AnalogCtx(),
                                   {"tokens": toks}, caches=sub,
                                   pos_offset=off, seq_mask=mask,
                                   last_only=True)
        return logits

    chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        chunk()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk()
        timing = "graph"
    except RuntimeError as e:
        timing = f"events (the host waits: {str(e).splitlines()[0]})"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if timing == "graph":
        dev_ms = graph_ms(torch, chunk, reps=5)
    else:
        dev_ms = cuda_time_ms(torch, lambda i: chunk(), 1, reps=5, rounds=3)
    context = float((eng._dev["off"][:PREFILL_ROWS].float()
                     + ENGINE_CHUNK).mean())
    return {"chunk_forward_ms": host_ms, "chunk_device_ms": dev_ms,
            "chunk_busy": dev_ms / host_ms, "chunk_timing": timing,
            "chunk_context": context}


def phase_engine(torch, arch: str = ARCH) -> dict:
    """A full-width model (random weights from a seed) through the
    continuous engine: llama-3.2-1b with analog_hw and digital_int4 on a
    bf16 pool and analog_hw on the int8 pool; mamba2-130m with analog_hw
    and digital_int4 (its per-slot state in bf16 / fp32)."""
    from repro_torch.models import build

    dev = torch.device("cuda")
    cfg, params, labels = build(arch, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    runs = ((("analog_hw", 0), ("digital_int4", 0)) if cfg.family == "ssm"
            else (("analog_hw", 0), ("digital_int4", 0), ("analog_hw", 8)))
    out = {}
    for deploy, kv_bits in runs:
        key = deploy if cfg.family == "ssm" else f"{deploy}/kv{kv_bits or 16}"
        out[key] = engine_phase(torch, cfg, params, labels, deploy, kv_bits)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the reduced engines, card against CPU
# ---------------------------------------------------------------------------

def reduced_engine_check(torch) -> dict:
    """Reduced llama-3.2-1b through the continuous engine on the card (the
    kernels) and on the CPU (their plain versions), same weights: greedy
    tokens must be equal for ``fp`` and ``analog_hw`` (fused), paged and
    per-slot contiguous. One paged chunk forward and one decode step must
    give the CPU's logits within 1e-4 (as phase 3's reduced check)."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig, AnalogCtx
    from repro_torch.core.analog import perturb_analog_weights
    from repro_torch.models import apply, build
    from repro_torch.models import transformer as T
    from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                             ServeEngine)

    cfg = get_config(ARCH).reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    hw = perturb_analog_weights(params, labels,
                                torch.Generator().manual_seed(1), "hw")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 21))).astype(np.int32),
        max_new=int(rng.integers(4, 13)), temperature=0.0)
        for i in range(6)]
    out = {}
    cuda = torch.device("cuda")
    for deploy, p, acfg in (
            ("fp", params, AnalogConfig(mode="off")),
            ("analog_hw", hw, AnalogConfig(mode="analog", train_noise=False,
                                           use_pallas=True))):
        pc = _to(p, cuda)
        for paged in (True, False):
            scfg = SchedulerConfig(num_slots=3, max_len=40, prefill_chunk=8,
                                   paged=paged, kv_block_size=8)
            host = ServeEngine(p, cfg, acfg, scfg).run(list(reqs))
            card = ServeEngine(pc, cfg, acfg, scfg).run(list(reqs))
            bad = [r.uid for r in reqs
                   if not np.array_equal(host[r.uid], card[r.uid])]
            out[f"{deploy}/{'paged' if paged else 'contiguous'}"] = bad
            check(not bad, f"reduced {deploy} paged={paged}: greedy tokens "
                  f"differ for requests {bad}")
        # logits of one paged chunk forward and one decode step
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
        errs = []
        for where, q in (("cpu", p), ("cuda", pc)):
            caches = T.init_caches(cfg, 2, 24, device=where, per_slot=True,
                                   paged=True, kv_block_size=8)
            caches["tbl"][:] = torch.tensor([[1, 2, 3], [4, 5, 6]],
                                            dtype=torch.int32)
            caches["wtbl"][:] = caches["tbl"]
            caches["start"][:] = torch.tensor([3, 0], dtype=torch.int32)
            mask = torch.ones((2, 8), device=where)
            mask[0, :3] = 0                      # row 0: 3 left pads
            off = torch.tensor([[-3], [0]], device=where)
            t = toks.to(where)
            l1, _, caches = apply(q, cfg, acfg, AnalogCtx(), {"tokens": t},
                                  caches=caches, pos_offset=off,
                                  seq_mask=mask)
            l2, _, _ = apply(q, cfg, acfg, AnalogCtx(),
                             {"tokens": t[:, -1:]}, caches=caches,
                             pos_offset=off + 8,
                             seq_mask=torch.ones((2, 1), device=where))
            errs.append((l1.cpu(), l2.cpu()))
        d1 = float((errs[0][0] - errs[1][0]).abs().max())
        d2 = float((errs[0][1] - errs[1][1]).abs().max())
        out[f"{deploy}/logit_err"] = max(d1, d2)
        check(max(d1, d2) < 1e-4, f"reduced {deploy}: card vs cpu paged "
              f"logits differ by {max(d1, d2):.3e}")
    print(f"  reduced {ARCH} engine, card vs cpu: greedy tokens equal for "
          f"fp and analog_hw, paged and contiguous; max |dlogit| of a paged "
          f"chunk + decode step: fp {out['fp/logit_err']:.2e}, analog_hw "
          f"{out['analog_hw/logit_err']:.2e}")
    return out


def reduced_mamba_check(torch) -> dict:
    """Reduced mamba2-130m through the continuous engine on the card (the
    kernels) and on the CPU (their plain versions), same weights: greedy
    tokens must be equal for ``fp`` and ``analog_hw`` (fused). Two chunks
    of a left-padded prompt (the second from the first one's state) and a
    decode step must give the CPU's logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import (AnalogConfig, AnalogCtx,
                                         perturb_analog_weights)
    from repro_torch.models import apply, build
    from repro_torch.models import transformer as T
    from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                             ServeEngine)

    cfg = get_config(MAMBA).reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    hw = perturb_analog_weights(params, labels,
                                torch.Generator().manual_seed(1), "hw")
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 21))).astype(np.int32),
        max_new=int(rng.integers(4, 13)), temperature=0.0)
        for i in range(6)]
    out = {}
    cuda = torch.device("cuda")
    scfg = SchedulerConfig(num_slots=3, max_len=40, prefill_chunk=8,
                           paged=True)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 17)))
    for deploy, p, acfg in (
            ("fp", params, AnalogConfig(mode="off")),
            ("analog_hw", hw, AnalogConfig(mode="analog", train_noise=False,
                                           use_pallas=True))):
        pc = _to(p, cuda)
        host = ServeEngine(p, cfg, acfg, scfg).run(list(reqs))
        card = ServeEngine(pc, cfg, acfg, scfg).run(list(reqs))
        bad = [r.uid for r in reqs
               if not np.array_equal(host[r.uid], card[r.uid])]
        out[deploy] = bad
        check(not bad, f"reduced {MAMBA} {deploy}: greedy tokens differ for "
              f"requests {bad}")
        logits = []
        for where, q in (("cpu", p), ("cuda", pc)):
            caches = T.init_caches(cfg, 2, 24, device=where, per_slot=True)
            mask = torch.ones((2, 16), device=where)
            mask[0, :5] = 0                      # row 0: 5 left pads
            t = toks.to(where)
            got = []
            for j in range(2):
                lj, _, caches = apply(q, cfg, acfg, AnalogCtx(),
                                      {"tokens": t[:, 8 * j:8 * j + 8]},
                                      caches=caches,
                                      seq_mask=mask[:, 8 * j:8 * j + 8])
                got.append(lj.cpu())
            ld, _, _ = apply(q, cfg, acfg, AnalogCtx(), {"tokens": t[:, 16:]},
                             caches=caches,
                             seq_mask=torch.ones((2, 1), device=where))
            logits.append(got + [ld.cpu()])
        err = max(float((u - v).abs().max())
                  for u, v in zip(logits[0], logits[1]))
        out[f"{deploy}/logit_err"] = err
        check(err < 1e-4, f"reduced {MAMBA} {deploy}: card vs cpu logits "
              f"differ by {err:.3e}")
    print(f"  reduced {MAMBA} engine, card vs cpu: greedy tokens equal for fp "
          f"and analog_hw; max |dlogit| of two chunks + a decode step: fp "
          f"{out['fp/logit_err']:.2e}, analog_hw "
          f"{out['analog_hw/logit_err']:.2e}")
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4, and the CLI (phase 10)
# ---------------------------------------------------------------------------

def _deploy_args(deploy: str):
    return argparse.Namespace(deploy=deploy)


def serve_phase(torch, deploy: str, base: str) -> dict:
    """Serve full-width llama-3.2-1b under ``deploy`` on the kernels and
    check it against the unfused ``base`` deployment of the same weights."""
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import int4_matmul as k4
    from repro_torch.launch.serve import deploy_model
    from repro_torch.models import build
    from repro_torch.serve.decode import generate, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg, params, labels = build(ARCH, gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    check(cfg.num_layers == 16 and cfg.d_model == 2048
          and cfg.padded_vocab == 128256, f"unexpected config {cfg}")
    fused_p, fused_acfg = deploy_model(_deploy_args(deploy), cfg, params,
                                       labels, gen)
    if deploy == "analog_hw":
        fused_acfg = dataclasses.replace(fused_acfg, use_pallas=True)
        base_p = fused_p                  # same programmed (noisy) weights
        base_acfg = dataclasses.replace(fused_acfg, use_pallas=False)
        counter, other = km, k4
    else:
        base_p, base_acfg = deploy_model(_deploy_args(base), cfg, params,
                                         labels, gen)
        counter, other = k4, km
    del params
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device=dev)

    torch.cuda.synchronize()
    km.launches = k4.launches = 0
    t0 = time.perf_counter()
    toks = generate(fused_p, cfg, fused_acfg, gen, prompt, NEW_TOKENS,
                    greedy_first=NEW_TOKENS)
    toks_host = toks.cpu()
    gen_s = time.perf_counter() - t0
    launched, other_launched = counter.launches, other.launches
    want = LAUNCHES_PER_FORWARD * FORWARDS
    check(launched == want, f"{deploy}: {counter.__name__} launched "
          f"{launched} times, expected {want}")
    check(other_launched == 0, f"{deploy}: the other kernel launched "
          f"{other_launched} times")
    check(tuple(toks_host.shape) == (BATCH, NEW_TOKENS)
          and int(toks_host.min()) >= 0
          and int(toks_host.max()) < cfg.vocab_size,
          f"{deploy}: bad tokens {toks_host}")

    lf, _, _ = prefill(fused_p, cfg, fused_acfg, prompt, PROMPT_LEN + 1)
    lb, _, _ = prefill(base_p, cfg, base_acfg, prompt, PROMPT_LEN + 1)
    base_toks = generate(base_p, cfg, base_acfg, gen, prompt, NEW_TOKENS,
                         greedy_first=NEW_TOKENS).cpu()
    check(bool(torch.isfinite(lf).all()), f"{deploy}: non-finite logits")
    rel_l2 = float(torch.linalg.vector_norm(lf - lb)
                   / torch.linalg.vector_norm(lb))
    n_sites, n_el, n_flip = site_parity(torch, cfg, fused_p, fused_acfg,
                                        base_p, base_acfg, prompt)
    agree = int((toks_host == base_toks).sum())
    first_agree = int((toks_host[:, 0] == base_toks[:, 0]).sum())
    res = {"deploy": deploy, "params": n_params, "launches": launched,
           "generate_s": gen_s,
           "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
           "max_logit_diff": float((lf - lb).abs().max()),
           "logit_scale": float(lb.abs().max()), "rel_l2": rel_l2,
           "sites": n_sites, "site_elements": n_el, "site_flips": n_flip,
           "greedy_agree": agree, "first_token_agree": first_agree}
    print(f"  {deploy}: {n_params / 1e9:.3f}B params, {launched} launches, "
          f"generate {gen_s:.2f}s; vs {base}: {n_sites} sites on the same "
          f"inputs, {n_flip} of {n_el} outputs one ADC level apart at "
          f"near-ties ({n_flip / n_el:.2e}); end to end max |dlogit| "
          f"{res['max_logit_diff']:.3e} (|logit| <= "
          f"{res['logit_scale']:.3e}), rel L2 {rel_l2:.3e}, greedy tokens "
          f"agree {agree}/{BATCH * NEW_TOKENS}, first {first_agree}/{BATCH}")
    check(rel_l2 < E2E_TOL, f"{deploy}: fused vs unfused logits rel L2 "
          f"{rel_l2:.3e} >= {E2E_TOL}")
    res.update(step_times(torch, cfg, fused_p, fused_acfg, prompt))
    res["unfused"] = step_times(torch, cfg, base_p, base_acfg, prompt)
    print(f"  {deploy} on the kernels: prefill {res['prefill_ms']:.2f} ms, "
          f"decode {res['decode_ms']:.2f} ms/step, of it on the device "
          f"{res['decode_device_ms']:.2f} ms (busy "
          f"{res['device_busy']:.3f}); unfused {base}: prefill "
          f"{res['unfused']['prefill_ms']:.2f} ms, decode "
          f"{res['unfused']['decode_ms']:.2f} ms/step, on the device "
          f"{res['unfused']['decode_device_ms']:.2f} ms (busy "
          f"{res['unfused']['device_busy']:.3f})")
    del fused_p, base_p
    torch.cuda.empty_cache()
    return res


def step_times(torch, cfg, params, acfg, prompt,
               new_tokens: int = NEW_TOKENS) -> dict:
    """Host-clock time of one prefill and of a greedy decode step
    (synchronized, after the main-path run warmed everything up; median of
    3 rounds), and the device time of one decode step: the step captured
    as a CUDA graph and replayed back to back, so that the card never
    waits for the host (launching a graph takes far less than running it;
    the graph's short gaps between its kernels are in the time). Its share
    of the host-clock step is ``device_busy``."""
    from repro_torch.serve.decode import prefill, serve_step

    pre, dec = [], []
    for _ in range(3):                     # median of 3 rounds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, pos = prefill(params, cfg, acfg, prompt,
                                      prompt.shape[1] + new_tokens)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, dim=-1)
        t0 = time.perf_counter()
        for i in range(new_tokens):
            logits, caches = serve_step(params, cfg, acfg, tok[:, None],
                                        caches, pos + i)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3 / new_tokens)
    out = {"prefill_ms": sorted(pre)[1], "decode_ms": sorted(dec)[1]}

    # one decode step at position pos as a graph (each replay rewrites the
    # same cache row); warmed up on a side stream, as capture requires
    tok = tok[:, None]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            serve_step(params, cfg, acfg, tok, caches, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        serve_step(params, cfg, acfg, tok, caches, pos)
    out["decode_device_ms"] = cuda_time_ms(torch, lambda i: graph.replay(),
                                           1, reps=10, rounds=3)
    out["device_busy"] = out["decode_device_ms"] / out["decode_ms"]
    del graph
    return out


def site_parity(torch, cfg, params_a, acfg_a, params_b, acfg_b, tokens,
                sites: int = LAUNCHES_PER_FORWARD):
    """Every analog site of one prefill, fused (a) against unfused (b) on
    the same input: the input path b's own forward gave that site. Every
    mismatch must be exactly one ADC level at a near-tie of path b's
    pre-ADC value, ``|frac(y * inv) - 1/2| <= K * 2^-24 * (|x_q| . |w|) *
    inv``, as in the kernel phase. Returns (sites, elements, flips)."""
    from repro_torch.core import analog as A
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import prefill

    real = A.analog_linear
    calls = {"a": [], "b": []}

    def recorder(tag):
        def spy(p, x, acfg, ctx):
            calls[tag].append((p, x))
            return real(p, x, acfg, ctx)
        return spy

    for tag, params, acfg in (("a", params_a, acfg_a),
                              ("b", params_b, acfg_b)):
        L.analog_linear = M.analog_linear = T.analog_linear = recorder(tag)
        try:
            prefill(params, cfg, acfg, tokens, tokens.shape[1])
        finally:
            L.analog_linear = M.analog_linear = T.analog_linear = real
    check(len(calls["a"]) == len(calls["b"]) == sites,
          f"site count {len(calls['a'])}, {len(calls['b'])}")
    qo = ref.qmax(acfg_b.output_bits)
    ctx = A.AnalogCtx()
    elements = flips = 0
    with torch.no_grad():
        for i, ((pa, _), (pb, x)) in enumerate(zip(calls["a"], calls["b"])):
            ya, _ = real(pa, x, acfg_a, ctx)
            yb, _ = real(pb, x, acfg_b, ctx)
            w = pb["kernel"].float()
            if acfg_b.mode == "rtn":
                w = quant.rtn_dequantize(*quant.rtn_quantize(
                    w, acfg_b.weight_bits))
            beta = pb["input_range"].reshape(()).float()
            x_q = quant.input_quantize(x.float().reshape(-1, w.shape[0]),
                                       beta, acfg_b.input_bits)
            b = torch.clamp_min(ref.adc_bound(w, beta, acfg_b.out_bound),
                                1e-8)
            inv = ref.rdiv(qo, b) * ref.ADC_TIE_BREAK
            v = (x_q @ w) * inv
            err = w.shape[0] * U32 * (x_q.abs() @ w.abs()) * inv
            diff = (ya - yb).reshape(v.shape).abs()
            lsb = ref.div(b, qo).expand_as(diff)
            bad = diff != 0
            n_bad = int(bad.sum())
            elements += diff.numel()
            flips += n_bad
            if n_bad:
                level = ((diff[bad] - lsb[bad]).abs() / lsb[bad]).max()
                tie = (v[bad] - torch.floor(v[bad]) - 0.5).abs()
                check(float(level) < 1e-3 and bool((tie <= err[bad]).all()),
                      f"site {i}: a fused/unfused mismatch is not one ADC "
                      f"level at a near-tie")
    return len(calls["b"]), elements, flips


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def small_reference_check(torch) -> dict:
    """Reduced llama on the kernels against the same weights on the CPU,
    where every kernel runs its plain version: logits within 1e-4 and
    equal greedy tokens (K <= 192 here, far from the flip regime)."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig, pack_int4_weights
    from repro_torch.models import build
    from repro_torch.serve.decode import digital_int4_config, generate, prefill

    cfg = get_config(ARCH).reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (3, 8),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for name, acfg, p in [
            ("analog", AnalogConfig(mode="analog", use_pallas=True), params),
            ("int4", digital_int4_config(AnalogConfig()),
             pack_int4_weights(params, labels))]:
        pc = _to(p, torch.device("cuda"))
        lc, _, _ = prefill(pc, cfg, acfg, prompt.cuda(), 9)
        lh, _, _ = prefill(p, cfg, acfg, prompt, 9)
        err = float((lc.cpu() - lh).abs().max())
        tc = generate(pc, cfg, acfg, None, prompt.cuda(), 6,
                      greedy_first=6).cpu()
        th = generate(p, cfg, acfg, None, prompt, 6, greedy_first=6)
        check(err < 1e-4, f"small {name}: cuda vs cpu logits differ by "
              f"{err:.3e}")
        check(torch.equal(tc, th), f"small {name}: greedy tokens differ")
        out[name] = err
    print(f"  reduced {ARCH}, cuda kernels vs cpu plain versions: max "
          f"|dlogit| {out}, greedy tokens equal")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_cli(torch) -> dict:
    """The serving CLI in-process on the card: the continuous engine on
    the paged pool (the default engine) and the static engine."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    res = serve.main(["--arch", ARCH, "--deploy", "digital_int4",
                      "--num-requests", "4", "--paged"])
    cont_s = time.perf_counter() - t0
    check(sorted(res) == [0, 1, 2, 3] and all(len(v) for v in res.values()),
          f"cli continuous: results {res}")
    t0 = time.perf_counter()
    toks = serve.main(["--arch", ARCH, "--deploy", "digital_int4",
                       "--num-requests", "4", "--engine", "static"])
    static_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (4, 32), f"cli: tokens {tuple(toks.shape)}")
    counters = _counters()
    for m in counters.values():
        m.launches = 0
    t0 = time.perf_counter()
    res = serve.main(["--arch", MAMBA, "--deploy", "digital_int4",
                      "--num-requests", "4", "--paged"])
    mamba_s = time.perf_counter() - t0
    check(sorted(res) == [0, 1, 2, 3] and all(len(v) for v in res.values()),
          f"cli {MAMBA}: results {res}")
    check(counters["ssd_scan"].launches > 0
          and counters["int4_matmul"].launches > 0,
          f"cli {MAMBA}: the kernels did not run")
    return {"continuous_s": cont_s, "static_s": static_s,
            "mamba_continuous_s": mamba_s}


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------

#: the run whose launch count each kernel's entry reports: llama-3.2-1b's
#: static engine (phases 3 and 4) or continuous engine analog_hw run on the
#: bf16 pool (phase 8), or mamba2-130m's continuous analog_hw run (phase 8)
LINE_PATHS = {"analog_matmul": "static/analog_hw",
              "int4_matmul": "static/digital_int4",
              "paged_flash_decode": "continuous/analog_hw/kv16",
              "paged_flash_prefill": "continuous/analog_hw/kv16",
              "ssd_scan": f"continuous/{MAMBA}/analog_hw"}

PAGED_META = {
    "paged_flash_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:169"),
    "paged_flash_prefill": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                            "src/repro/kernels/paged_prefill.py:193")}


def kernels_line(rows: dict, launches: dict, paged_rows: dict,
                 paged_launches: dict, ssd_rows: list,
                 ssd_launches: int) -> dict:
    """One entry per kernel.

    ``analog_matmul`` / ``int4_matmul``: ``ms``, ``plain_ms``,
    ``bound_ms`` and the yardstick ``matmul_ms`` are totals over the
    launches of one static-engine run (1 prefill forward at M = 128 + 16
    decode forwards at M = 4, 65 sites each), summed from the per-shape
    times of phase 2 (without col_off, which the main path does not use);
    ``bound_ms`` sums each launch's bound (the tensor-core one on the mma
    mapping), ``fp32_bound_ms`` the fp32 bound of every launch. For
    ``analog_matmul`` ``ms`` and ``plain_ms`` are the main path's call, the
    ADC bound folded in; ``explicit_bound_ms`` is the kernel with the bound
    given and ``adc_bound_ms`` the bound pass that the fold replaced.
    ``wall_ms`` is the same total by CUDA events around back-to-back calls,
    host dispatch gaps included. ``launches`` is that run's count.

    ``paged_flash_decode`` / ``paged_flash_prefill``: the times are per
    launch at the phase-5 case named in ``case`` (the engine's bf16 pool,
    one split, context 512); ``library_ms`` is gather ``kp[tbl]`` +
    ``scaled_dot_product_attention`` on the same inputs; ``max_abs_err``
    is the largest over all phase-5 cases; ``launches`` is the count of
    the continuous engine's ``analog_hw`` run (phase 8).

    ``ssd_scan``: the times are per launch at the phase-6 case named in
    ``case`` (the engine's chunk, ``SSD_LINE_CASE``); ``max_abs_err`` is the
    largest over all phase-6 cases, y and final state; ``bound_ms`` is the
    recurrence's work (2 N P FMAs per token and head) as split TF32 on the
    tensor cores against the bytes (phase 6's rows keep PR 13's L = 32
    fp32 bound beside it as ``l32_bound_ms``); ``library_ms`` is
    null (no single PyTorch call computes an SSD scan); ``launches`` is the
    count of mamba2-130m's continuous ``analog_hw`` run (phase 8).

    Each entry's ``path`` names the run its ``launches`` come from
    (``LINE_PATHS``); the continuous runs' counts of every kernel are in
    the phase-6 results."""
    meta = {
        "analog_matmul": ("src/repro_torch/kernels/csrc/analog_matmul.cu",
                          "src/repro/kernels/analog_matmul.py:157"),
        "int4_matmul": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                        "src/repro/kernels/int4_matmul.py:78")}
    out = []
    for name, (src, replaces) in meta.items():
        shapes = [r for r in rows[name] if not r.get("col_off")
                  and r.get("arch", ARCH) == ARCH
                  and r["M"] in (M_DECODE, M_PREFILL)]
        keys = ("ms", "wall_ms", "plain_ms", "matmul_ms", "bound_ms",
                "fp32_bound_ms", "explicit_bound_ms", "adc_bound_ms")
        tot = {"bytes_ms": 0.0, "ops_ms": 0.0}
        for r in shapes:
            reps = PER_SITE[r["site"]] * (NEW_TOKENS if r["M"] == M_DECODE
                                          else 1)
            for key in keys:
                if key in r:
                    tot[key] = tot.get(key, 0.0) + reps * r[key]
            tot["bytes_ms" if r["bound_by"] == "bytes" else "ops_ms"] += (
                reps * r["bound_ms"])
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": LINE_PATHS[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": None, "matmul_ms": tot["matmul_ms"],
            "fp32_bound_ms": tot.get("fp32_bound_ms"),
            "wall_ms": tot["wall_ms"], "parity": "ok"}
        if name == "analog_matmul":
            entry.update(explicit_bound_ms=tot.get("explicit_bound_ms"),
                         adc_bound_ms=tot.get("adc_bound_ms"))
        out.append(entry)
    for name, (src, replaces) in PAGED_META.items():
        cases = paged_rows[name]
        r = next(c for c in cases
                 if c["dtype"] == LINE_CASE["dtype"]
                 and c["context"] == LINE_CASE["context"]
                 and c["splits"] == LINE_CASE["splits"])
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": LINE_PATHS[name],
            "launches": paged_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "wall_ms": r["wall_ms"],
            "case": {k: r[k] for k in ("rows", "chunk", "context", "dtype",
                                       "splits")},
            "plan": r.get("plan"), "parity": "ok"})
    r = next(c for c in ssd_rows if c["case"] == SSD_LINE_CASE)
    out.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:92",
        "path": LINE_PATHS["ssd_scan"], "launches": ssd_launches,
        "max_abs_err": max(c["max_abs_err"] for c in ssd_rows),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "wall_ms": r["wall_ms"],
        "case": {k: r[k] for k in ("case", "rows", "tokens", "h0")},
        "plan": r.get("plan"), "parity": "ok"})
    return {"kernels": out}


def main() -> int:
    """Run the phases; returns the exit code."""
    try:
        import torch
        import repro_torch  # noqa: F401  (the port must be beside us)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    results = {}

    def phase(title: str) -> None:
        print(f"{title} (at {time.perf_counter() - t_start:.1f}s)")

    try:
        phase("[1/10] setup")
        results["setup"] = phase_setup(torch)
        phase("[2/10] MVM kernels at llama-3.2-1b and mamba2-130m main-path "
              "shapes")
        rows = phase_kernels(torch)
        phase("[3/10] static engine, llama-3.2-1b, analog_hw serving, "
              "use_pallas=True")
        results["small"] = small_reference_check(torch)
        results["analog"] = serve_phase(torch, "analog_hw", "analog_hw")
        phase("[4/10] static engine, llama-3.2-1b, digital_int4 serving")
        results["int4"] = serve_phase(torch, "digital_int4", "digital_rtn4")
        phase("[5/10] paged-attention kernels at llama-3.2-1b attention "
              "shapes")
        paged_rows = phase_paged(torch)
        phase("[6/10] ssd_scan at mamba2-130m shapes")
        ssd_rows = phase_ssd(torch)
        phase("[7/10] static engine, mamba2-130m: fp, analog_hw, "
              "digital_int4")
        results["mamba_static"] = phase_mamba_static(torch)
        phase("[8/10] continuous engine at full width: llama-3.2-1b on the "
              "paged pool, mamba2-130m")
        results["engine"] = phase_engine(torch)
        results["engine_mamba"] = phase_engine(torch, MAMBA)
        phase("[9/10] reduced continuous engines, card against cpu")
        results["reduced_engine"] = reduced_engine_check(torch)
        results["reduced_mamba"] = reduced_mamba_check(torch)
        phase("[10/10] serving CLI")
        results["cli"] = phase_cli(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    line = kernels_line(
        rows, {"analog_matmul": results["analog"]["launches"],
               "int4_matmul": results["int4"]["launches"]},
        paged_rows, {name: results["engine"][LINE_PATHS[name].split(
            "/", 1)[1]]["launches"][name] for name in PAGED_META},
        ssd_rows, results["engine_mamba"]["analog_hw"]["launches"][
            "ssd_scan"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"results": results, "shapes": rows, "paged": paged_rows,
         "ssd": ssd_rows, **line}, indent=1))
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
