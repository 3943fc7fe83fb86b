#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. setup    -- a card, full fp32 matmuls (no TF32), the five CUDA kernels
               built from ``src/repro_torch/kernels/csrc`` with nvcc.
2. kernels  -- each MVM kernel at llama-3.2-1b's main-path shapes (K -> N of
               the qkv, o, gate_up, down projections and the LM head; M = 4
               for decode, 4 x 32 = 128 for prefill; the continuous
               engine's M = 8 decode and M = 64 chunk; each with and
               without ``col_off``, which phase 19's device model adds to
               every launch), at phi-3-mini-4k's
               (3072 -> 9216, 3072 -> 3072, 3072 -> 16384, 8192 -> 3072,
               3072 -> 32256; M = 4, 128 and the eval forward's 64 x 64 =
               4096) and at mamba2-130m's (in_proj 768 -> 3352, out_proj
               1536 -> 768; M = 4 and 4 x 1024), at the training forwards
               of llama, mamba2-130m and the 1-layer qwen3-moe (M = 4 x
               256 = 1024, on noisy weights against the bound of the
               noise-free ones), at qwen3-moe-30b-a3b's 2-D
               sites (2048 -> 2560, 2048 -> 2048, 2048 -> 152064; M = 4,
               128, 8, 64) and its batched expert sites (gate_up 2048 ->
               1536, down 768 -> 2048, all 128 experts in one launch, at 4
               and 8 rows per expert, and at the training forward's 80 on
               noisy weights; timed beside ``torch.bmm``), at
               jamba-v0.1-52b's (qkv 4096 -> 6144, o 4096 -> 4096, gate_up
               4096 -> 28672, down 14336 -> 4096, the mixers' in_proj 4096
               -> 16544 and out_proj 8192 -> 4096, the head 4096 -> 65536;
               M = 4, 128, 8, 64; its 16-expert gate_up and down at 4, 20,
               8 and 10 rows per expert), internvl2-2b's (M = 4 and 4 x
               (256 + 32), its projector 1024 -> 2048 at 4 x 256) and
               musicgen-medium's (M = 4, 128; its head 1536 -> 8192), held
               against its plain
               PyTorch version on the same
               inputs (analog: at most 1e-4 of the outputs may flip, each
               one ADC level at a near-tie; the folded ADC bound bit for bit
               equal to the explicit one) and timed with CUDA events beside
               the plain version, an fp32 ``torch.matmul`` of the same size
               (yardstick only) and the card's bound for the work (the
               tensor-core bound for the mma mapping, the fp32 one beside
               it); analog_matmul as the main path calls it (bound folded),
               with the explicit bound, the ``adc_bound`` pass the fold
               replaced, and the flip rate with the tensor cores carrying
               the whole K sum (no promotion). Phase 21's rows too:
               llama-3.2-1b's verify windows (M = 16, 24, 40), the chunk
               forward's LM head on the last position (M = 2), and the int4
               drafter's prompt prefills (int4_matmul at each padded prompt
               of phase 21's workload, its head at M = 1; parity and the
               kernel's time). 10 calls x 3 rounds a timing (3 x 3 at the
               eval's largest shapes).
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
               pools; the same at phi-3-mini-4k's (MHA, H 32, KV 32, hd 96),
               qwen3-moe-30b-a3b's (GQA group 8, H 32, KV 4, hd 64) and
               jamba-v0.1-52b's (GQA group 4, H 32, KV 8, hd 128) at
               context 512. Each is held against its plain version and
               timed beside it, beside gather ``kp[tbl]`` + PyTorch's
               ``scaled_dot_product_attention`` (yardstick only) and the
               card's bound, with the kernel's plan (warps of a thread
               block, query tile, lanes of a warp, keys per warp iteration
               and per lane, pool blocks in flight). Then
               ``paged_flash_prefill`` at phase 21's verify windows (S = 2,
               3, 5 columns over 8 rows, cursors odd and crossing a block)
               at llama-3.2-1b's and qwen3-moe-30b-a3b's heads on the three
               pools, against the plain version, and the verify seam
               (each column against ``paged_flash_decode`` at its cursor:
               largest difference, bitwise columns; reported, not gated).
6. ssd      -- ``ssd_scan`` at mamba2-130m's shapes (H 24, P 64, N 128,
               G 1; strided views of one projection, as the mixer hands them
               over): the engine's chunk (2 rows x 32 tokens from a nonzero
               state, ragged left pads), the static prompt (4 x 1024), a
               long prefill (1 x 8192) and the training scan (4 x 256),
               each held against its plain version
               (y and the final state) and timed beside it and the card's
               bound (the recurrence's work on the TF32 tensor cores; PR
               13's L = 32 fp32 bound beside it), with the kernel's plan
               (chunk length, launches, blocks of each, scratch) and each
               pass's time from ``torch.profiler``; a one-launch scan is
               also held and timed as the three passes. The same at
               jamba-v0.1-52b's heads (H 128, P 64, N 16, G 1: the engine's
               chunk and a 4 x 1024 prefill, both from a state).
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
               attention and SSD call run on its kernel. The engine
               replays its steps as CUDA graphs (``serve/graphs.py``);
               llama's ``analog_hw`` run on the bf16 pool runs first with
               the bodies eager (``_eager``), then graphed: tokens bit for
               bit, every counter and launch equal, tokens/s, TTFT, TPOT,
               host ms a step, peak GB and the graphs captured of both;
               so do 4 requests sampled at top-k 50 and top-p 0.9. Then
               one decode step of the engine (graphed and eager, host
               clock), one decode forward and one chunk forward (2 rows x
               32 columns) at its slots' live context, on the host clock
               and on the device (CUDA graphs).
9. reduced  -- reduced llama-3.2-1b and mamba2-130m through the engine on the
               card and on the CPU (plain versions): equal greedy tokens for
               ``fp`` and ``analog_hw`` (llama: paged and per-slot
               contiguous), and a chunk + decode step's logits within 1e-4.
10. cli     -- ``repro_torch.launch.serve.main``, continuous (paged) and
               static, and continuous with ``--arch mamba2-130m``.
11. phi-3   -- phases 3 and 4 for full-width phi-3-mini-4k (d 3072, 8 of
               its 32 layers, random from a seed; phases 12, 13 and 15 run
               it at the same depth):
               ``analog_hw`` + ``use_pallas=True`` against unfused,
               ``digital_int4`` against ``digital_rtn4``, under the same
               gates.
12. eval    -- the paper's §3.2 noisy-eval protocol (``eval.harness``) at
               full width for llama-3.2-1b and phi-3-mini-4k, random
               weights, ``analog_hw`` on ``analog_matmul``:
               ``evaluate(..., NoiseSpec("hw"), seeds=10)`` on markov_next
               (64 x 64 tokens) and induction_copy by the per-seed path
               (ten instance trees would not fit), printing each seed's
               seconds, scored tokens/s, launches and peak memory; its
               first two seeds again (the same chips must give equal logits
               bits and runs); ``digital_int4`` with no noise on
               ``int4_matmul``; a two-point gaussian gamma sweep on pinned
               instances, one seed at a time (both points must perturb the
               same chip). The scores of random weights gate nothing. Then
               the reduced models' eval on the card against the CPU with
               the same instance trees (3 hw seeds): equal scores per task
               and seed, and no site input apart before a site output is.
13. best-of-n -- ``serve.engine.sample_candidates`` at full width, both
               models, ``analog_hw`` on the continuous engine's paged pool
               (8 slots): 8 mod_add prompts x 8 candidates, fork-aware on
               the prefix cache (leaders, then the forks on their prompt
               blocks), then ``best_of_n_accuracy`` at n = 1, 4, 8;
               candidates/s, and every projection and attention call on
               its kernel; then the same with ``prefix_cache=False`` and
               the same generator seed: equal answers, candidates/s.
14. train   -- HWA distillation (paper Fig. 2b): ``distill_recipe`` trains
               full-width llama-3.2-1b at 4 of its 16 layers (student a
               copy of the random teacher) for 4 steps of batch 4 x 256 Markov tokens,
               ``analog`` on ``analog_matmul`` (w + w_noise against the
               noise-free bound), KD at temperature 2, remat on. Gates:
               (i) at each llama site at M = 1024 the fused Function's
               forward against its plain version and its dx, dw, dbeta
               against the unfused chain's autograd; (ii) after every step
               each input range follows the EMA rule of its site's
               recorded x_std and every analog weight lies within
               alpha * std (eq. 4); (iii) saved at step 2 and resumed in a
               fresh Trainer, the run equals the uninterrupted one bit for
               bit; (iv) finite losses; (v) the reduced llama trains on
               the card as on the CPU (losses, and upstream gradients
               wherever no ADC flip reaches). It prints the step time,
               training tokens/s, peak GB, the device time of the kernel
               against cuBLAS and the rest, by stage.
15. ptq     -- SpinQuant-lite PTQ, the paper's SI8-W4 / DI8-W4 baseline,
               at full width for llama-3.2-1b (a Hadamard rotation) and
               phi-3-mini-4k (d 3072: the QR path), random weights:
               ``fold_norm_scales``, then ``spinquant_ptq`` (the rotation
               folded into every residual writer and reader, the static
               ranges calibrated on 16 x 64 tokens). Gates: R R^T = I
               within 1e-5, the ``off`` log-softmax of the rotated model
               within 3e-3 of the unrotated one on 2 x 64 tokens, every
               calibrated range equal to its site's x_absmax from the
               calibration forward. Then the noisy eval on phase 12's
               tasks: SI8-W4 (``qat``, plain path), SI8-W4 under hw noise
               (10 seeds), DI8-W4, ``analog_hw`` (10 seeds, on
               ``analog_matmul``) and ``digital_int4`` (``int4_matmul``),
               with seconds per seed, peak GB and launches; the reduced
               PTQ on the card against the CPU (ranges, greedy tokens).
16. moe     -- qwen3-moe-30b-a3b (d 2048, 128 experts, top-8) at full
               width and 3 of its 48 layers (9.8 GB of fp32 weights; the
               script's time limit):
               phases 3 and 4 (static engine, ``analog_hw`` fused against
               unfused and ``digital_int4`` against ``digital_rtn4``; every
               site, each batched expert site one launch of all 128
               experts, held on the same inputs; the logits' distance only
               reported, since a flip may move a token to another expert)
               and phase 8 (continuous engine, bf16 paged pool, both
               deployments); the expert launches' rows must be phase 2's.
               Each row's first greedy token that differs fused against
               unfused is tied to its origin, an ADC flip at a near-tie
               with equal inputs, routes moving only after it, or the
               phase fails. Then reduced qwen3-moe and dbrx on the card
               against the CPU: routing ids (near-ties counted), every site
               on the card's inputs within the ADC contract, greedy tokens.
17. families -- jamba-v0.1-52b (hybrid: d 4096, 16 experts top-2, Mamba-2
               mixers of 128 heads with N 16, GQA 32 / 8 at hd 128) at full
               width and one super-block of its four (8 of 32 layers, 13.3
               B fp32 parameters, 53 GB: built, programmed and packed into
               its one copy), phases 3 and 4 on the static engine (33 MVM
               launches per forward, 7 ``ssd_scan`` per prefill, the token
               attribution of phase 16) and phase 8's continuous engine
               under ``analog_hw`` (33 MVM launches per forward, 7 scans
               per chunk forward, 1 paged decode or prefill); then
               internvl2-2b (vlm: 256 random patch embeddings through the
               projector ahead of each prompt) and musicgen-medium (audio:
               4 codebooks a token, a 4 x 2048 head) at full width (6 of
               24 and 8 of 48 layers) on the static engine, both
               deployments; each run's peak memory.
               Then the three reduced models on the card against the CPU,
               as phase 16's.

18. train families -- HWA distillation (phase 14's recipe, gates and
               times) of mamba2-130m at full width and depth (24 layers,
               ``analog_matmul`` and ``ssd_scan``, the SSD's backward
               through its autograd rule) and qwen3-moe-30b-a3b at full
               width and 1 of its 48 layers (both expert sites one batched
               launch each, 80 rows per expert; the router trained through
               the combine weights and the aux loss). Gates: (i) the
               batched expert site's dx, dw and dbeta at E 128 x 80 rows
               against float64, and the SSD rule's gradients at 4 x 256
               against the float64 recurrence; (ii)-(iv) after every step
               as phase 14, each step's launches counted (forward, remat,
               teacher), the aux loss finite and the router's gradient
               finite and nonzero; (v) reduced mamba2-130m, qwen3-moe,
               dbrx and jamba trained on the card against the CPU (site
               inputs and gradients by the causal rule, routes moved only
               at near-ties or after a site output apart, losses). Then
               internvl2-2b (6 of 24 layers, 256 patch embeddings a row
               through the ``projector`` site, 4 x (256 + 256) rows) and
               musicgen-medium (8 of 48 layers, tokens [4, 256, 4]) at
               full width: gates (ii)-(iv) on 4 steps, each step's
               launches, then 3 steps timed and one under the profiler
               (ms a step, training tokens/s, peak GB, the device split);
               and both reduced, trained on the card against the CPU, as
               gate (v).

19. devices -- the per-tile device model (``core.devices``: programming
               gain, drift, periphery offsets, stuck columns, dead tiles)
               on full-width llama-3.2-1b: (a) the static engine as phase
               3 on a 48 h old chip (offsets 0.01, 1 % stuck columns and
               dead tiles), fused against unfused under phase 3's gates,
               every one of the 65 launches per forward with ``col_off``;
               (b) phase 8's 16 requests on the bf16 pool with the drift
               clock spanning about 200 h and the watchdog on: at least
               one recalibration, each lowering the tile scale error,
               ``nu`` / ``dead`` / ``stuck`` and every leaf's storage
               kept, no request, slot or block evicted, graphed against
               the same run eager from the same chip state, bit for bit
               (tokens, counters, launches, recalibrations), then phase
               8's decode and chunk forward times on that chip; (c) the
               8-slot decode forward as a CUDA graph replayed after an
               ``advance`` and after a ``recalibrate``, equal to the eager
               forward bit for bit; (d) reduced llama-3.2-1b, mamba2-130m,
               qwen3-moe-30b-a3b and jamba-v0.1-52b on the engine with
               drift and recalibration, card against CPU on the same chip
               (one seed, a CPU generator) under phase 16's causal rule.

20. prefix  -- the radix prefix cache (on by default in every engine
               above): 12 greedy requests in 4 groups, each group sharing
               a 256-token system prompt, each request its own suffix of
               32-224 tokens and 12-28 new tokens, through phase 8's
               geometry (8 slots, chunk 32, block 16; the pool sized to
               keep every prompt block). 12 requests for 8 slots, so that
               the prime pass admits each group's third request after its
               group-mates' prefills have registered the system prompt's
               blocks (live sharing). (a) full-width llama-3.2-1b at 4
               of its 16 layers,
               ``analog_hw`` + ``use_pallas=True``: cold (no cache), then
               one engine with the cache that serves the workload twice
               (prime, warm under new uids), on the bf16 pool and on the
               int8 pool; (b) full-width mamba2-130m at 8 of its 24
               layers, ``analog_hw``, the
               same three runs on the state-snapshot pool (``paged=True``,
               inert for KV; the pool at its auto size, 8 x 34 snapshots).
               Gates: prime and warm tokens equal cold bit for bit; the
               prime pass hits on the requests admitted after the first
               eight (llama skipping prompt tokens, mamba restoring
               snapshots); the warm pass hits on every request, llama skipping each padded
               prompt but its last chunk, mamba restoring at least 8
               snapshots and launching fewer ``ssd_scan`` than cold;
               blocks and snapshots conserved; no indexed block or
               snapshot rewritten and no cache leaf replaced; every
               projection, attention, prefill and scan call on its kernel,
               as the engine's counters say. It prints tokens/s, chunk
               forwards and mean TTFT of each run and the pools' GB. (c)
               reduced llama, mamba2-130m, qwen3-moe and jamba with the
               cache, card against CPU: a partial tail (block 48, chunk
               32, a 64-token prompt; copied on write where the family
               takes tails), eviction under an undersized pool, and
               fork-aware ``sample_candidates`` against the independent
               path.

21. spec    -- speculative decoding on the first 8 requests of phase
               20's workload (2 a group) and its geometry (k = 4), each
               engine's prefix cache primed by the first prompt of each
               group: (a) phase 20's full-width llama-3.2-1b at 4
               of its 16 layers, ``fp``
               non-speculative and with the ngram, self and int4 drafters,
               ``analog_hw`` + ``use_pallas=True`` non-speculative and with
               the ngram and int4 drafters, each of these two first eager,
               then graphed: bit for bit, every counter and launch equal
               (the self drafter's near-tie check reads the drafter's
               logits on the host inside each window, so its run is
               eager, as are the recorded re-runs). Gates: every request's
               tokens equal the non-speculative run's bit for bit, or, re-run
               with its forwards recorded (the re-run must give the run's
               tokens), its first differing token is explained: ``fp`` at
               a top-2 near-tie of the logits, ``analog_hw`` by phase 16's
               causal rule (the first differing site output of the row has
               inputs within SITE_INPUT_TOL and differs only by ADC levels
               at near-ties); the self drafter accepts at least 0.99 of its
               proposals in ``fp``, each rejection at a near-tie; every
               kernel launched as the engine's counters say, every MVM
               launch at a shape phase 2 held; no ``RewindError``, blocks
               conserved, no indexed block rewritten, no cache leaf
               replaced. It prints tokens/s, acceptance, windows, tokens a
               row and window and forwards by kind of each run, and the
               ``[8, 5]`` verify forward's and the int4 draft forward's host
               and device ms (graph replay). (b) reduced llama,
               qwen3-moe (no-drop capacity), mamba2-130m and jamba in mode
               off, paged at block 4 and contiguous, card against CPU:
               ngram, self, int4, an all-reject ``draft_fn`` and a stop
               token inside a window give equal tokens and spec counters,
               equal to non-speculative; mamba2 and jamba gated.

22. lifecycle -- the request lifecycle and the async front end on
               full-width llama-3.2-1b, ``analog_hw`` + ``use_pallas=True``,
               the bf16 pool in phase 8's geometry: (a) phase 8's 16
               requests, greedy, closed loop, then through
               ``AsyncServeFrontend`` open-loop (``launch.serve.
               open_loop_run``): Poisson arrivals at 2 requests/s, and
               bursts of 4 at 8 requests/s into a queue of 4 with a 2 s
               TTFT deadline. Gates: every arrival one terminal status and
               ``submitted`` the arrivals; streamed tokens equal each
               result; every request's tokens (a timed-out one's partial
               output) equal the closed loop's bit for bit, or, replayed
               with its forwards recorded, part by phase 16's causal rule;
               blocks conserved, no cache leaf replaced, every kernel
               launched as the engine's counters say. (b) with the ngram
               and the int4 drafters (k = 4): a cancel between
               ``step_begin`` and ``step_commit`` of a speculative window
               deferred past the commit, no ``RewindError``; a chaos fault
               at the third dispatch errors the in-flight requests, the
               reset keeps every leaf's storage (all zero after it), and a
               probe served before the fault and after it gives the same
               tokens. (c) the HTTP front door on an ephemeral loopback
               port: 503 at a full queue, 200 with the engine's tokens,
               ``GET /health`` equal to the engine's counters. It prints
               tokens/s, TTFT and TPOT p50/p99, outcomes, the queue's
               high-water mark and the front end's steps of each run.
23. tp      -- tensor-parallel serving on the one card, the shards of
               every column-parallel weight and of the KV pool sharing
               cuda:0 (``ServeEngine(shard_devices=...)``): (a) every
               llama site at M = 8 and 64 split 2 and 4 ways, each shard's
               launch on the whole site's plan equal to the whole launch's
               columns bit for bit (both MVM kernels; the whole launches
               are phase 2's); (b) full-width llama-3.2-1b at 2 of its 16
               layers on phase 21's 8 greedy requests and bf16 pool: fp,
               digital_int4 and analog_hw (``use_pallas=True``) at tp 1, 2
               and 4 -- analog_hw and digital_int4 bit for bit, fp equal
               or parting only at a top-2 near-tie; every kernel launched
               tp times as often as at tp 1; tokens/s, TPOT, a decode
               step's host and device ms, peak GB; tp 3 gated (32 heads
               do not divide) and serving tp 1's tokens; (c)
               qwen3-moe-30b-a3b (3 layers, expert-parallel: 64 experts a
               shard) and mamba2-130m (4 layers; its scan replicated)
               analog_hw at tp 2, bit for bit; (d) qwen2.5-32b at full
               width and 2 of its 64 layers, analog_hw at tp 2 and 4 fed
               from host memory (each shard copied to the card, no
               unsharded copy beside the shards), tokens equal to tp 1's.
               Depths cut from 4 and 8 layers to keep the script near
               600 s.
24. cost    -- the cost counter (``launch/cost_analysis.py``) and the dry
               run against the card: (i) full-width llama-3.2-1b's 4 x 32
               prefill and one decode forward under analog_hw and
               digital_int4, the continuous engine's decode step and 32-
               column chunk step on the bf16 pool, and a mamba2-130m
               prefill, each counted once on the card and once on the meta
               device -- FLOPs, bytes and every kernel entry equal; (ii)
               each kernel's counted calls equal its launches; (iii) one
               meta launch of each kernel counts the (FLOPs, bytes) its
               phase fed ``bound_ms`` (``repro_torch.kernels.cost``; the
               paged kernels at tables their rows fill); (iv) the dry
               run's parameter bytes of llama in fp32 on a one-card host
               mesh against the allocator's growth over the build, within
               512 B a leaf; (v) the counted peak bytes against
               ``max_memory_allocated`` for the prefill and phase 14's
               train step (PEAK_REL / PEAK_ABS); (vi) the train step's and
               phase 8's graphed decode step's counted FLOPs beside their
               ms; (vii) the ``train_4k`` cell of every ARCH_NAMES arch on
               the single production mesh: per-device argument bytes, and
               for a fixed list of four (VII_FLOP_ARCHS) the FLOPs at one
               layer pattern.
25. sharded -- sharded training state on the one card: phase 14's HWA
               step (full-width llama-3.2-1b at 2 layers, the teacher
               inside) for 3 steps unsharded and on placed meshes 1 x 1,
               2 x 1, 4 x 1 and 2 x 2 (data x model), every position on
               cuda:0. Gates: (i) 1 x 1 bit for bit the unsharded step;
               (ii) the others, each step from the unsharded run's state
               before it, within SHARD_TOL; (iii) a reshard 4 -> 2
               value-exact and the next step bit for bit the step from the
               gathered state placed afresh; (iv) ``psum_compressed`` on
               the card equal to the CPU's. Also each run's launches (data
               shards x the unsharded count), its collectives' counted
               bytes against what the placement moves, the largest
               position's state bytes, peak GB and ms a step; a
               free-running data-2 run's drift and the DAC / ADC codes
               that move at its step 2; the training launcher on the host
               mesh. One card shows parity and placement, not memory.

It then prints the kernels' JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. It takes no arguments.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import gc
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
# continuous engine's geometry (phase 8): heads, kv heads, head dim, block
PAGED_H, PAGED_KV, PAGED_HD, PAGED_BS = 32, 8, 64, 16
LLAMA_PAGED = (PAGED_H, PAGED_KV, PAGED_HD, PAGED_BS)
PAGED_CONTEXTS = (128, 512, 2048)
DECODE_ROWS, DECODE_SPLITS = 8, (1, 4)
POOL_DTYPES = ("f32", "bf16", "i8")
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_REQUESTS = 8, 32, 16
# phase 8's sampled top-p requests held graphed against eager
SAMPLED_AB = 4
# the engine's compact prefill width: (slots + 2 chunks - slots) // chunk
PREFILL_ROWS = 2
# the continuous engine's MVM rows: a decode forward over its slots and a
# chunk forward of its compact rows
M_ENGINE_DECODE, M_ENGINE_CHUNK = ENGINE_SLOTS, PREFILL_ROWS * ENGINE_CHUNK
# phi-3-mini-4k, the paper's primary subject model: (site, K, N, sites per
# forward) of its layers and the LM head (padded_vocab 32256); MHA at
# head dim 96 on the paged kernels (phase 5, at one context); the eval
# forward's rows, 64 sequences of 64 tokens (phase 12)
PHI3 = "phi-3-mini-4k"
# phi-3-mini-4k runs PHI3_LAYERS of its 32 layers (so that the script
# keeps inside its time limit; every shape is its own)
PHI3_LAYERS = 8
PHI3_SITES = [("qkv", 3072, 9216, PHI3_LAYERS), ("o", 3072, 3072, PHI3_LAYERS),
              ("gate_up", 3072, 16384, PHI3_LAYERS),
              ("down", 8192, 3072, PHI3_LAYERS), ("lm_head", 3072, 32256, 1)]
PHI3_PAGED = (32, 32, 96, 16)
PHI3_PAGED_CONTEXT = 512
# the eval forwards' rows (phase 12): markov_next's 64 sequences of 64
# tokens and induction_copy's 64 of 25 (a ragged last 128-row tile)
M_EVAL, M_INDUCTION = 64 * 64, 64 * 25
# the noisy-eval protocol (phase 12): seeds of the per-seed hw path; the
# first of them run again (the same chips must give the same bits); the
# pinned gaussian sweep's gamma points and seeds; the reduced card-vs-CPU
# eval's seeds
EVAL_SEEDS, EVAL_REPEAT = 10, 2
SWEEP_GAMMAS, SWEEP_SEEDS = (0.02, 0.04), 2
REDUCED_EVAL_SEEDS = 3
# card against CPU on the same instances: before any site output differs
# (an ADC near-tie flip), a site's input may differ only by the fp32
# rounding of the digital ops in between (norms, attention, residual
# adds): |dx| <= SITE_INPUT_TOL * (1 + |x|)
SITE_INPUT_TOL = 1e-4
# the positions of each eval task's logits [B, S, V] that its score reads
# (markov_next skips 4 tokens of context, induction_copy reads the second
# copy of its 12-token pattern), and their number in one seed at the
# default sizes (64 sequences each)
SCORED = {"markov_next": slice(4, None), "induction_copy": slice(13, 24)}
SCORED_PER_SEED = 64 * (64 - 4) + 64 * 11
# best-of-n (phase 13): mod_add prompts, candidates per prompt, the n of
# the accuracy curve, tokens per candidate, the modulus (SEP is token mod)
BON_PROMPTS, BON_N, BON_NS, BON_MAX_NEW, BON_MOD = 8, 8, (1, 4, 8), 4, 23
# best-of-n's MVM rows: a decode forward over the engine's 8 slots and a
# chunk forward of its compact rows, 2 x BestOfNConfig's prefill_chunk 8
M_BON_DECODE, M_BON_CHUNK = ENGINE_SLOTS, 2 * 8
# HWA distillation (phase 14): llama-3.2-1b at full width, batch x sequence
# of the training forward, steps (the first a warm-up), the step at which
# the resume check saves, the training-noise gamma (eq. 3; AnalogConfig's
# default); the training forward's MVM rows (phase 2 holds the kernel there
# on noisy weights)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_RESUME_AT = 4, 256, 4, 2
# llama-3.2-1b trains at TRAIN_LAYERS of its 16 layers (cut so that the
# script keeps inside its time limit: the resume check writes and reads
# the params and both moments, 12 bytes a parameter; the embedding and the
# untied head stay whole)
TRAIN_LAYERS = 4
M_TRAIN = TRAIN_BATCH * TRAIN_SEQ
TRAIN_GAMMA = 0.02
NOISY_RUNS = {(ARCH, M_TRAIN)}
# gate (i): the fused Function's dx and dw on the card against the unfused
# chain's rules in float64, each element within DOT_ERR_LAMBDA times the
# fp32 rounding bound of its k-term dot, sqrt(k) * 2^-24 * (|A|·|B|); dbeta,
# one fp32 sum over M * K terms, within DBETA_TOL * (1 + sum |terms|)
DOT_ERR_LAMBDA = 1.0
DBETA_TOL = 1e-5
# gate (v): the reduced llama's training on the card against the CPU
# (train_noise off): rows x tokens, steps; each site's upstream gradient
# at a row that no ADC flip reached agrees within REDUCED_GRAD_TOL of the
# tensor's largest magnitude (fp32 sums in another order through the
# backward), and each step's loss within REDUCED_LOSS_TOL * (1 + |loss|)
REDUCED_TRAIN_SHAPE, REDUCED_TRAIN_STEPS = (4, 32), 3
REDUCED_GRAD_TOL = 1e-4
REDUCED_LOSS_TOL = 1e-4
# mamba2-130m, the ssm family: (site, K, N, sites per forward) of its 24
# layers (the tied LM head is a plain matmul, as in the reference), the
# static engine's batch, prompt and new tokens
MAMBA = "mamba2-130m"
MAMBA_SITES = [("in_proj", 768, 3352, 24), ("out_proj", 1536, 768, 24)]
MAMBA_MVM_PER_FORWARD = sum(s[3] for s in MAMBA_SITES)      # 48
MAMBA_PROMPT, MAMBA_NEW = 1024, 32
# decode steps of each host-clock round of the static engine's step times
# (step_times): few, so that the script keeps inside its time limit; the
# device times come from CUDA graphs and do not depend on it
STEP_TIME_TOKENS = 4
MAMBA_M_PREFILL = BATCH * MAMBA_PROMPT
# ssd_scan cases (phase 6): (name, rows, tokens, incoming state); "chunk"
# is what the continuous engine runs, and the kernels line reports it
SSD_CASES = [("chunk", PREFILL_ROWS, ENGINE_CHUNK, True),
             ("static", BATCH, MAMBA_PROMPT, False),
             ("long", 1, 8192, False),
             ("train", TRAIN_BATCH, TRAIN_SEQ, False)]
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
# qwen3-moe-30b-a3b, the moe family (phases 2, 5 and 16): full width (d
# 2048, 128 experts, top-8, expert d_ff 768, padded vocab 152064) at
# MOE_LAYERS of its 48 layers (the expert weights take 2.42 GB of fp32 a
# layer). Its attention follows the repo's config, 32 / 4 heads of
# d / H = 64 without QK-norm, not the published head_dim 128 (a q
# projection 4096 wide) with QK-norm. Its 2-D sites (site, K, N, sites per
# forward), its paged-attention heads (a GQA group of 8 at hd 64) at one
# context, and its
# batched expert sites, one launch of all 128 experts each, at the rows per
# expert that its forwards give them: a sequence routes S * 8 assignments
# into max(1, int(S * 8 * 1.25 / 128)) slots per expert, so the static
# prefill (4 x 32) has 8 rows, the static decode (4 x 1) 4, the engine's
# decode (8 slots) 8 and its chunk (2 x 32) 4
MOE = "qwen3-moe-30b-a3b"
MOE_LAYERS = 3
MOE_EXPERTS = 128
MOE_DENSE_SITES = [("qkv", 2048, 2560, MOE_LAYERS),
                   ("o", 2048, 2048, MOE_LAYERS),
                   ("lm_head", 2048, 152064, 1)]
MOE_SITES = [("gate_up", 2048, 1536, MOE_LAYERS),
             ("down", 768, 2048, MOE_LAYERS)]
MOE_ROWS = {"static prefill": 8, "static decode": 4, "engine decode": 8,
            "engine chunk": 4}
MOE_PAGED = (32, 4, 64, PAGED_BS)
MOE_PAGED_CONTEXT = 512
# the reduced moe models of phase 16's card-against-CPU check (rmsnorm and
# layernorm); a routing id may differ only where the CPU's k-th and
# (k+1)-th router probabilities lie within ROUTE_TIE of each other
MOE_REDUCED = (MOE, "dbrx-132b")
ROUTE_TIE = 1e-5
# SpinQuant-lite PTQ (phase 15), llama-3.2-1b (d 2048: a Hadamard
# rotation) and phi-3-mini-4k (d 3072: the QR path): the calibration batch,
# the FP-invariance batch and its bar (the reference test's), the
# orthogonality bar (largest element of R R^T - I); the reduced PTQ's
# calibrated ranges card against CPU within PTQ_RANGE_TOL * (1 + |cpu|),
# the fp32 reduction bound of a max over site inputs that the two reach
# through differently ordered sums
PTQ_CALIB = (16, 64)
PTQ_INV_TOKENS = (2, 64)
PTQ_INV_TOL = 3e-3
PTQ_ORTHO_TOL = 1e-5
PTQ_RANGE_TOL = 1e-5
# jamba-v0.1-52b, the hybrid family (phases 2, 5, 6 and 17): full width (d
# 4096, attention 32 / 8 heads of hd 128 with rope_theta 0, Mamba-2 mixers
# of 128 heads of P 64 with N 16 and one group, FFNs of d_ff 14336, MoE of
# 16 experts top-2 at odd layers, padded vocab 65536) at one super-block of
# its four: 8 of 32 layers, 13.3 B fp32 parameters (53 GB; the 4 MoE FFNs
# 45 GB), where a second copy of a leaf does not fit the card. Its 2-D
# sites (site, K, N, sites per forward), its batched expert sites (16
# experts, one launch each) and the rows per expert its forwards give them
# (a sequence of S tokens routes 2 S assignments into max(1, int(S * 2 *
# 1.25 / 16)) slots per expert: static prefill 4 x 5, static decode 4 x 1,
# the engine's decode 8 x 1 and chunk 2 x 5), its paged-attention heads (a
# GQA group of 4 at hd 128) and its mixers per prefill or chunk forward
JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
JAMBA_SITES = [("qkv", 4096, 6144, 1), ("o", 4096, 4096, 1),
               ("gate_up", 4096, 28672, 4), ("down", 14336, 4096, 4),
               ("in_proj", 4096, 16544, 7), ("out_proj", 8192, 4096, 7),
               ("lm_head", 4096, 65536, 1)]
JAMBA_EXPERTS = 16
JAMBA_EXPERT_SITES = [("gate_up", 4096, 28672, 4), ("down", 14336, 4096, 4)]
JAMBA_ROWS = {"static prefill": 20, "static decode": 4, "engine decode": 8,
              "engine chunk": 10}
JAMBA_PAGED = (32, 8, 128, PAGED_BS)
JAMBA_PAGED_CONTEXT = 512
JAMBA_MVM_PER_FORWARD = sum(s[3] for s in JAMBA_SITES + JAMBA_EXPERT_SITES)
JAMBA_MIXERS = 7
# ssd_scan at jamba's heads (phase 6): the engine's chunk from a state and
# a long prefill from a state
JAMBA_SSD_CASES = [("jamba chunk", PREFILL_ROWS, ENGINE_CHUNK, True),
                   ("jamba prefill", BATCH, 1024, True)]
# internvl2-2b, the vlm family (phase 17): full width (d 2048, 16 / 8 heads
# of hd 128, padded vocab 92672) at INTERNVL_LAYERS of its 24 layers, with
# the projector site of its 256 patch embeddings of width 1024, which the
# static prefill prepends to the prompt: 4 x (256 + 32) rows, the
# projector's 4 x 256
INTERNVL = "internvl2-2b"
INTERNVL_LAYERS = 6
INTERNVL_SITES = [("qkv", 2048, 4096, INTERNVL_LAYERS),
                  ("o", 2048, 2048, INTERNVL_LAYERS),
                  ("gate_up", 2048, 16384, INTERNVL_LAYERS),
                  ("down", 8192, 2048, INTERNVL_LAYERS),
                  ("lm_head", 2048, 92672, 1)]
INTERNVL_PROJECTOR = [("projector", 1024, 2048, 1)]
VIT_TOKENS, VIT_DIM = 256, 1024
M_VLM_PREFILL, M_PROJECTOR = BATCH * (VIT_TOKENS + PROMPT_LEN), BATCH * 256
# musicgen-medium, the audio family (phase 17): full width (d 1536, MHA 24
# heads, LayerNorm and GELU, 4 codebooks of 2048 codes summed at the input
# and predicted by one head of 4 x 2048) at MUSICGEN_LAYERS of its 48
# layers (both cut in depth so that the script keeps inside its time limit)
MUSICGEN = "musicgen-medium"
MUSICGEN_LAYERS = 8
MUSICGEN_SITES = [("qkv", 1536, 4608, MUSICGEN_LAYERS),
                  ("o", 1536, 1536, MUSICGEN_LAYERS),
                  ("up", 1536, 6144, MUSICGEN_LAYERS),
                  ("down", 6144, 1536, MUSICGEN_LAYERS),
                  ("lm_head", 1536, 8192, 1)]
FAMILY_ARCHS = (JAMBA, INTERNVL, MUSICGEN)
# HWA distillation of the ssm and moe families (phase 18), as phase 14's:
# mamba2-130m at full width and depth (24 layers) and qwen3-moe-30b-a3b at
# full width and MOE_TRAIN_LAYERS of its 48 layers (1.236 B fp32
# parameters: the student, the teacher, the gradients and two moments
# peak at 44 GB; two layers would not fit the card); the training
# forward's rows per expert: max(1, int(256 * 8 * 1.25 / 128)) = 20
# capacity slots per sequence, 4 sequences
TRAIN_FAMILY_ARCHS = (MAMBA, MOE)
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_ROWS = TRAIN_BATCH * max(
    1, int(TRAIN_SEQ * 8 * 1.25 / MOE_EXPERTS))                   # 80
# phase 2's label for the training forward of the 1-layer qwen3-moe (its
# sites' launches per forward differ from the 6-layer serving model's)
MOE_TRAIN = f"{MOE}/train"
MOE_TRAIN_DENSE_SITES = [(s, k, n, 1) for s, k, n, _ in MOE_DENSE_SITES]
MOE_TRAIN_SITES = [(s, k, n, MOE_TRAIN_LAYERS) for s, k, n, _ in MOE_SITES]
NOISY_RUNS |= {(MAMBA, M_TRAIN), (MOE_TRAIN, M_TRAIN)}
# gate (i) of phase 18, the SSD autograd rule at mamba2-130m's training
# scan (4 x 256 from a zero state): each gradient (x, dt, a, b, c) of the
# kernel forward + plain-version backward within SSD_GRAD_TOL of that
# gradient's largest magnitude of the sequential recurrence's autograd in
# float64 (the plain version's fp32 sums against exact ones)
SSD_GRAD_TOL = 1e-4
# gate (v) of phase 18: the reduced models trained on the card against
# the CPU (every family that trains but the dense one, which phase 14
# holds)
REDUCED_TRAIN_ARCHS = (MAMBA, MOE, "dbrx-132b", JAMBA)
# phase 18 also distils the vlm and audio families at full width with the
# kernels (TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS checked steps, then
# FAMILY_TIMED_STEPS unchecked and timed): internvl2-2b at INTERNVL_LAYERS
# with VIT_TOKENS patch embeddings a row (its stack and LM head at
# TRAIN_BATCH x (VIT_TOKENS + TRAIN_SEQ) rows, the projector at TRAIN_BATCH
# x VIT_TOKENS, K 1024), musicgen-medium at MUSICGEN_LAYERS (tokens [B, S,
# 4]); phase 2's labels for their training launches (on noisy weights)
VLM_AUDIO_TRAIN = (INTERNVL, MUSICGEN)
FAMILY_TIMED_STEPS = 2
# gate (v)'s one exception, for the arch whose card run showed it: reduced
# musicgen-medium's third step parted card against CPU by 6.2e-4 at two
# ADC near-ties (PERF.md). There, and only there, a later step's
# losses may part if (a) the card's parameters and Adam state before that
# step are the CPU's: per leaf, |card - cpu| over |cpu's update since the
# start| (parameters) or over |cpu| (moments), in L2 norm, within
# TRAIN_STATE_TOL, the step counts equal (Adam's near-sign updates of
# near-zero gradients part element by element, so an elementwise bound
# would hold nothing); and (b) that step's forward from the CPU's
# parameters, run on both sides, shows a site output apart (the causal
# rule) and holds the loss on the rows nothing reached. Every other arch
# holds every step's loss within REDUCED_LOSS_TOL; every arch prints the
# state readings before each step
LATER_TIE_ARCHS = (MUSICGEN,)
TRAIN_STATE_TOL = 1e-2
INTERNVL_TRAIN, MUSICGEN_TRAIN = f"{INTERNVL}/train", f"{MUSICGEN}/train"
M_VLM_TRAIN = TRAIN_BATCH * (VIT_TOKENS + TRAIN_SEQ)             # 2048
M_PROJECTOR_TRAIN = TRAIN_BATCH * VIT_TOKENS                     # 1024
NOISY_RUNS |= {(INTERNVL_TRAIN, M_VLM_TRAIN),
               (INTERNVL_TRAIN, M_PROJECTOR_TRAIN),
               (MUSICGEN_TRAIN, M_TRAIN)}


# phase 19, the per-tile device model: DeviceConfig's defaults plus
# periphery offsets, stuck columns and dead tiles, drawn from DEVICE_SEED;
# the static engine's chip age (hours); the hours the continuous engine's
# clock spans and its watchdog; the reduced models held card against CPU
DEVICE_FAULTS = dict(sigma_offset=0.01, p_stuck_col=0.01, p_dead_tile=0.01)
DEVICE_SEED = 5
DEVICE_AGE_H = 48.0
DEVICE_ENGINE_H = 200.0
DEVICE_RECAL = dict(recal_interval=8, recal_threshold=0.15)
DEVICE_REDUCED = (ARCH, MAMBA, MOE, JAMBA)

# phase 20: the radix prefix cache and the state-snapshot pool. 4 groups of
# 3 greedy requests; a group shares a 256-token system prompt, each request
# adds its own suffix of 32-224 tokens (a multiple of the chunk, so a
# group's prompts share their left-pad count and with it their chain keys)
# and asks for 12-28 new tokens (cut from 4 requests a group and 16-64 new
# tokens, then 16-40, so that the script keeps inside its time limit). 12
# requests for the 8 slots: the last 4 are admitted while their
# group-mates' blocks are live, so the prime pass hits on them
PREFIX_GROUPS, PREFIX_PER_GROUP, PREFIX_SYSTEM = 4, 3, 256
PREFIX_SUFFIX_CHUNKS = (1, 7)
PREFIX_NEW = (12, 28)
PREFIX_WARM_UID = 1000
# phases 20 and 21 run llama-3.2-1b and mamba2-130m at full width and these
# depths of their 16 and 24 layers, so that the script keeps inside its
# time limit (their engines are bound by the host's work per layer)
PREFIX_LAYERS = {ARCH: 4, MAMBA: 8}
PREFIX_REDUCED = (ARCH, MAMBA, MOE, JAMBA)
# phase 23, tensor parallelism on one card (every shard on cuda:0):
# full-width llama-3.2-1b at TP_LAYERS[ARCH] of its layers at each of
# TP_DEGREES; qwen3-moe-30b-a3b (MOE_LAYERS) and mamba2-130m
# (TP_LAYERS[MAMBA]) at tp 2; qwen2.5-32b at full width and QWEN32_LAYERS
# of its 64 layers at QWEN32_DEGREES; fp greedy tokens may part between
# degrees only where the tp = 1 logits' top-2 gap is within TP_FP_TIE of
# their scale (cuBLAS picks its products by shape)
TP_DEGREES = (1, 2, 4)
TP_LAYERS = {ARCH: 2, MAMBA: 4}
QWEN32, QWEN32_LAYERS, QWEN32_DEGREES = "qwen2.5-32b", 2, (1, 2, 4)
TP_FP_TIE = 1e-3
#: the engine counters each phase-20 run reads as deltas
PREFIX_COUNTERS = ("decode_steps", "prefill_forwards", "prefill_chunks",
                   "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                   "prefix_skipped_tokens", "prefix_cow_copies",
                   "state_snaps_captured", "state_snap_restores")

# phase 21: speculative decoding on the continuous engine, the first
# SPEC_PER_GROUP requests of each group of phase 20's workload
# (spec_requests) in its geometry with draft_k = SPEC_K: the fp deployment
# non-speculative and with each drafter, analog_hw (use_pallas=True) with
# the ngram and int4 drafters; the self drafter in fp must accept at least
# SPEC_SELF_ACCEPT of its proposals. A verify window runs 8 slots x (k + 1)
# columns, k in 1, 2, 4 as the window's clipping gives it (k = 0 is a
# decode step): the MVM rows M_VERIFY and the prefill kernel's chunks
# SPEC_CHUNKS (phase 5 holds it there at odd cursors that cross a block,
# at llama's and qwen3-moe's heads). The reduced models are held card
# against CPU in mode off, paged at block 4 and contiguous.
SPEC_K = 4
SPEC_PER_GROUP = 2
SPEC_FP_DRAFTS = ("ngram", "self", "int4")
SPEC_HW_DRAFTS = ("ngram", "int4")
SPEC_SELF_ACCEPT = 0.99
SPEC_WINDOWS = (1, 2, SPEC_K)
M_VERIFY = tuple(ENGINE_SLOTS * (k + 1) for k in SPEC_WINDOWS)
SPEC_CHUNKS = tuple(k + 1 for k in SPEC_WINDOWS)
SPEC_PAGED = ((ARCH, LLAMA_PAGED), (MOE, MOE_PAGED))
SPEC_REDUCED = (ARCH, MOE, MAMBA, JAMBA)
#: the engine counters each phase-21 run reads as deltas
SPEC_COUNTERS = PREFIX_COUNTERS + ("mixed_steps", "spec_steps",
                                   "spec_proposed", "spec_accepted",
                                   "draft_forwards")


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


_SLEEP_MS_PER_CYCLE: list = []


def sleep_ms_per_cycle(torch) -> float:
    """Milliseconds of one cycle of ``torch.cuda._sleep``, the card's spin
    kernel (measured once a process: its clock runs at the card's own
    rate)."""
    if _SLEEP_MS_PER_CYCLE:
        return _SLEEP_MS_PER_CYCLE[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    _SLEEP_MS_PER_CYCLE.append(start.elapsed_time(end) / 10_000_000)
    return _SLEEP_MS_PER_CYCLE[0]


#: the first spin of :func:`device_ms` (ms), doubled where the host's
#: queueing of a round outlasts it (a 20 ms start spent about 100 s of
#: phase 2 spinning: about 1700 timings x 3 rounds)
SPIN_MS = 4.0


def device_ms(torch, fn, n_args: int, reps: int = 20,
              rounds: int = 5) -> float:
    """Device time per call: CUDA events around ``reps`` calls queued
    behind a spin kernel that holds the card until the host has queued
    them all, so that host dispatch gaps are not in it (a round whose
    queueing outlasted the spin is repeated with a longer spin). Median
    over ``rounds``; arguments rotate as in :func:`cuda_time_ms`."""
    per_cycle = sleep_ms_per_cycle(torch)
    spin_ms = SPIN_MS
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


def timing_reps(m: int, k: int, n: int) -> dict:
    """Calls per round and rounds of a phase-2 timing: fewer for the eval
    forward's largest shapes, whose calls take milliseconds each (cut
    from 20 x 5 and 5 x 3 to keep the script inside its time limit; the
    parity checks do not depend on them)."""
    return dict(reps=10, rounds=3) if m * k * n < 5e10 else dict(reps=3,
                                                                  rounds=3)


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


def mvm_bounds(work: tuple, mapping: str) -> dict:
    """Both bounds of an MVM launch from its ``(flops, bytes)``
    (``repro_torch.kernels.cost``, what the cost counter counts): the fp32
    one (the flops at the CUDA cores' rate) and the tensor-core one (twice
    the flops at the TF32 rate: two TF32 products per fp32 product);
    ``bound_ms`` is the one of the launch's mapping. The work is kept in
    the row (``flops``, ``bytes``) for phase 24."""
    flops, nbytes = work
    fp32, fp32_by = bound_ms(nbytes, flops)
    tf32, tf32_by = bound_ms(nbytes, 2.0 * flops, TF32_FLOP_PER_S)
    mma = mapping == "mma"
    return {"bound_ms": tf32 if mma else fp32,
            "bound_by": tf32_by if mma else fp32_by,
            "fp32_bound_ms": fp32, "mma_bound_ms": tf32,
            "flops": flops, "bytes": nbytes}


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


def analog_case(torch, gen, m, k, n, with_off: bool,
                noisy: bool = False) -> dict:
    """One analog_matmul shape: parity against the plain version (flip
    rate over at least PARITY_OUTPUTS outputs, with and without promotion
    on the mma mapping), the folded bound against the explicit one, the
    share of outputs clipped at the ADC, and times. ``noisy``: the training
    forward's call, on ``w + gamma · colmax · tau`` against the explicit
    bound of the noise-free ``w`` (no fold: the main path gives the
    bound)."""
    from repro_torch.core.noise import gaussian_weight_noise
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    lam = 14.0
    copies = n_copies(4 * k * n)
    ws = [torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
          for _ in range(copies)]
    x = torch.randn((m, k), generator=gen, device=dev)
    beta = torch.full((1,), 3.0, device=dev)
    bounds = [ref.adc_bound(w, beta, lam) for w in ws]
    if noisy:
        ws = [w + gaussian_weight_noise(gen, w, TRAIN_GAMMA) for w in ws]
    offs = [0.1 * b * torch.randn((n,), generator=gen, device=dev)
            if with_off else None for b in bounds]
    plan = dispatch.select_blocks(m, k, n, kernel="analog_matmul")

    y_k = km.analog_matmul(x, ws[0], beta, bounds[0], offs[0])
    if not noisy:
        # the main path's call folds the bound; it must equal the explicit
        y_fold = km.analog_matmul(x, ws[0], beta, None, offs[0], lam=lam)
        check(bool(torch.equal(y_fold, y_k)),
              f"analog_matmul {m}x{k}x{n}: the folded ADC bound differs "
              f"from ref.adc_bound's")
    clipped = float((y_k.abs() >= bounds[0]).float().mean())
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
        if noisy:
            return km.analog_matmul(x, ws[i], beta, bounds[i], offs[i])
        return km.analog_matmul(x, ws[i], beta, None, offs[i], lam=lam)

    reps = timing_reps(m, k, n)
    ms = device_ms(torch, kernel, copies, **reps)
    wall = cuda_time_ms(torch, kernel, copies, **reps)
    explicit = device_ms(torch, lambda i: km.analog_matmul(
        x, ws[i], beta, bounds[i], offs[i]), copies, **reps)
    plain = device_ms(torch, lambda i: ref.analog_matmul_ref(
        x, ws[i], beta, bounds[i] if noisy else None, offs[i],
        lam=None if noisy else lam), copies, reps=5, rounds=3)
    mm = device_ms(torch, lambda i: x @ ws[i], copies, **reps)
    # the ADC bound pass that analog_linear ran beside every fused call
    # before the kernel folded it
    bound_calc = device_ms(torch, lambda i: ref.adc_bound(ws[i], beta, lam),
                           copies, **reps)
    # x, w, beta, the explicit bound (noisy) and col_off read once, the
    # output written once
    work = kcost.analog_matmul(1, m, k, n, bound=noisy, col_off=with_off)
    return {"M": m, "K": k, "N": n, "col_off": with_off, "noisy": noisy,
            "adc_clipped": clipped, "ms": ms,
            "explicit_bound_ms": explicit, "wall_ms": wall,
            "plain_ms": plain, "matmul_ms": mm, "adc_bound_ms": bound_calc,
            **mvm_bounds(work, plan.mapping),
            "mapping": plan.mapping, "splits": plan.splits, "flips": n_flip,
            "parity_outputs": outputs, "flip_rate": n_flip / outputs,
            "flip_rate_unpromoted": (n_flip_np / outputs
                                     if plan.mapping == "mma" else None),
            "max_abs_err": max_err}


def int4_case(torch, gen, m, k, n, timed: bool = True) -> dict:
    """One int4_matmul shape: parity against the plain version, times
    (without ``timed`` the kernel's device time alone)."""
    from repro_torch.kernels import cost as kcost
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

    reps = timing_reps(m, k, n)
    ms = device_ms(torch, kernel, copies, **reps)
    work = kcost.int4_matmul(1, m, k, n)
    if not timed:
        return {"M": m, "K": k, "N": n, "ms": ms,
                **mvm_bounds(work, plan.mapping),
                "mapping": plan.mapping, "splits": plan.splits,
                "max_abs_err": float(diff.max()),
                "max_err_over_bound": err_ratio}
    wall = cuda_time_ms(torch, kernel, copies, **reps)
    plain = device_ms(torch, lambda i: ref.int4_matmul_ref(
        x, packs[i], scales[i]), copies, reps=5, rounds=3)
    w_mm = [torch.randn((k, n), generator=gen, device=dev)
            for _ in range(n_copies(4 * k * n))]
    mm = device_ms(torch, lambda i: x @ w_mm[i], len(w_mm), **reps)
    return {"M": m, "K": k, "N": n, "ms": ms, "wall_ms": wall,
            "plain_ms": plain, "matmul_ms": mm,
            **mvm_bounds(work, plan.mapping),
            "mapping": plan.mapping, "splits": plan.splits,
            "max_abs_err": float(diff.max()),
            "max_err_over_bound": err_ratio}


def moe_case(torch, gen, kernel: str, e: int, m: int, k: int, n: int,
             arch: str, noisy: bool = False) -> dict:
    """One batched expert shape of ``kernel``: ``e`` experts' [M, K] @
    [K, N] in one launch, as a MoE site runs it. Each expert's slice is
    held against the plain version of its own product (analog: near-tie
    flips only, at most MAX_FLIP_RATE of the e * M * N >= PARITY_OUTPUTS
    outputs, and the bound folded per expert equal to the explicit [E, N]
    one bit for bit; int4: the fp32 dot bound), then timed beside the
    batched plain version, ``torch.bmm`` of the same fp32 sizes (the
    yardstick, ``matmul_ms``) and the bound of the work: the expert
    weights' bytes (each input read once, the output written once) against
    2 E M K N flops. ``noisy`` (analog): the training forward's call, on
    ``w + gamma · colmax_e · tau`` (each expert's own column scale)
    against the explicit [E, N] bound of the noise-free ``w``."""
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import int4_matmul as k4

    dev = torch.device("cuda")
    x = torch.randn((e, m, k), generator=gen, device=dev)
    plan = dispatch.select_blocks(m, k, n, kernel=kernel, experts=e)
    check(e * m * n >= PARITY_OUTPUTS, "moe case: too few outputs")
    w_mm = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
    if kernel == "analog_matmul":
        from repro_torch.core.noise import gaussian_weight_noise

        lam = 14.0
        beta = torch.full((1,), 3.0, device=dev)
        bound = ref.adc_bound(w_mm, beta, lam)
        w = w_mm + gaussian_weight_noise(gen, w_mm, TRAIN_GAMMA,
                                         axis=-2) if noisy else w_mm

        def call(i):
            if noisy:
                return km.analog_matmul(x, w, beta, bound)
            return km.analog_matmul(x, w, beta, None, lam=lam)

        y = call(0)
        check(noisy or bool(torch.equal(y, km.analog_matmul(x, w, beta,
                                                            bound))),
              f"batched analog_matmul {e}x{m}x{k}x{n}: the folded bound "
              f"differs from ref.adc_bound's")
        n_flip, max_err = 0, 0.0
        for i in range(e):
            f, err = analog_flips(torch, x[i], w[i], beta, bound[i], None,
                                  y[i])
            n_flip += f
            max_err = max(max_err, err)
        check(n_flip <= MAX_FLIP_RATE * e * m * n,
              f"batched analog_matmul {e}x{m}x{k}x{n}: {n_flip} flips")
        extra = {"flips": n_flip, "flip_rate": n_flip / (e * m * n)}
        work = kcost.analog_matmul(e, m, k, n, bound=noisy, col_off=False)

        def plain(i):
            if noisy:
                return ref.analog_matmul_ref(x, w, beta, bound)
            return ref.analog_matmul_ref(x, w, beta, lam=lam)
    else:
        w_int = torch.randint(-7, 8, (e, k, n), generator=gen, device=dev,
                              dtype=torch.int8)
        packed = ref.pack_int4(w_int)
        scale = (torch.rand((e, n), generator=gen, device=dev) + 0.5) * 0.01
        del w_int

        def call(i):
            return k4.int4_matmul(x, packed, scale)

        y = call(0)
        y_ref = ref.int4_matmul_ref(x, packed, scale)
        w_deq = ref.unpack_int4(packed).float() * scale[:, None, :]
        err_bound = k * U32 * torch.bmm(x.abs(), w_deq.abs())
        del w_deq
        diff = (y - y_ref).abs()
        check(bool(torch.isfinite(y).all()) and bool(
            (diff <= err_bound).all()), f"batched int4_matmul "
            f"{e}x{m}x{k}x{n}: outside the fp32 dot error bound")
        max_err = float(diff.max())
        extra = {"max_err_over_bound": float((diff / err_bound).max())}
        del y_ref, err_bound, diff
        work = kcost.int4_matmul(e, m, k, n)

        def plain(i):
            return ref.int4_matmul_ref(x, packed, scale)
    ms = device_ms(torch, call, 1)
    wall = cuda_time_ms(torch, call, 1)
    plain_ms = device_ms(torch, plain, 1, reps=5, rounds=3)
    bmm = device_ms(torch, lambda i: torch.bmm(x, w_mm), 1)
    del w_mm
    return {"E": e, "M": m, "K": k, "N": n, "arch": arch, "col_off": False,
            "noisy": noisy, "ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
            "matmul_ms": bmm, "library": "torch.bmm",
            **mvm_bounds(work, plan.mapping),
            "mapping": plan.mapping, "splits": plan.splits,
            "max_abs_err": max_err, **extra}


#: phase 2's MVM rows, (arch, sites, M, static, int4): the rows of each
#: model's static engine (also held with col_off), continuous engine, eval
#: forwards (analog_hw and digital_int4), best-of-n engine (analog_hw
#: only) and the training forwards of llama, mamba2-130m and the 1-layer
#: qwen3-moe (on noisy weights, NOISY_RUNS); qwen3-moe-30b-a3b's 2-D sites
#: at its engines' rows (its batched expert sites are MOE_SITES at
#: MOE_ROWS, and at MOE_TRAIN_ROWS in training)
MVM_RUNS = ([(ARCH, SITES, m, True, True) for m in (M_DECODE, M_PREFILL)]
            + [(ARCH, SITES, m, True, True) for m in (
                M_ENGINE_DECODE, M_ENGINE_CHUNK)]
            + [(ARCH, SITES, m, False, True) for m in (M_EVAL,
                                                       M_INDUCTION)]
            + [(ARCH, SITES, M_BON_CHUNK, False, False)]
            + [(ARCH, SITES, m, False, False) for m in M_VERIFY
               if m != M_BON_CHUNK]
            + [(ARCH, SITES, M_TRAIN, False, False)]
            + [(PHI3, PHI3_SITES, m, True, True) for m in (M_DECODE,
                                                           M_PREFILL)]
            + [(PHI3, PHI3_SITES, m, False, True) for m in (M_EVAL,
                                                            M_INDUCTION)]
            + [(PHI3, PHI3_SITES, m, False, False) for m in (M_BON_DECODE,
                                                             M_BON_CHUNK)]
            + [(MAMBA, MAMBA_SITES, m, True, True) for m in (
                M_DECODE, MAMBA_M_PREFILL)]
            + [(MAMBA, MAMBA_SITES, m, False, True) for m in (
                M_ENGINE_DECODE, M_ENGINE_CHUNK)]
            + [(MAMBA, MAMBA_SITES, M_TRAIN, False, False)]
            + [(MOE, MOE_DENSE_SITES, m, False, True) for m in (
                M_DECODE, M_PREFILL, M_ENGINE_DECODE, M_ENGINE_CHUNK)]
            + [(MOE_TRAIN, MOE_TRAIN_DENSE_SITES, M_TRAIN, False, False)]
            + [(JAMBA, JAMBA_SITES, m, False, True) for m in (
                M_DECODE, M_PREFILL)]
            + [(JAMBA, JAMBA_SITES, m, False, False) for m in (
                M_ENGINE_DECODE, M_ENGINE_CHUNK)]
            + [(INTERNVL, INTERNVL_SITES, m, False, True) for m in (
                M_DECODE, M_VLM_PREFILL)]
            + [(INTERNVL, INTERNVL_PROJECTOR, M_PROJECTOR, False, True)]
            + [(MUSICGEN, MUSICGEN_SITES, m, False, True) for m in (
                M_DECODE, M_PREFILL)]
            + [(INTERNVL_TRAIN, INTERNVL_SITES, M_VLM_TRAIN, False, False),
               (INTERNVL_TRAIN, INTERNVL_PROJECTOR, M_PROJECTOR_TRAIN, False,
                False),
               (MUSICGEN_TRAIN, MUSICGEN_SITES, M_TRAIN, False, False)])


def draft_prefill_rows() -> list:
    """The rows of the int4 drafter's prompt prefills in phase 21: one
    whole padded prompt of its workload (:func:`spec_requests`) each (``int4_matmul`` only;
    phase 2 holds the kernel there), its LM head on the last position
    alone."""
    from repro_torch.serve.scheduler import padded_prompt_len

    return sorted({padded_prompt_len(len(r.prompt), ENGINE_CHUNK)
                   for r in spec_requests(model_config(ARCH))})


#: the LM head of a chunk forward and of the drafter's prompt prefill runs
#: on the last position of each row only (``last_only``): analog_matmul at
#: the chunk forward's PREFILL_ROWS rows, int4_matmul at 1 row
HEAD_ROWS = [("analog_matmul", PREFILL_ROWS), ("int4_matmul", 1)]


#: the batched expert sites of phase 2: (arch, experts, sites, the rows per
#: expert that its forwards give them, the rows that digital_int4 runs,
#: whether the launch is the training forward's on noisy weights)
EXPERT_RUNS = [
    (MOE, MOE_EXPERTS, MOE_SITES, sorted(set(MOE_ROWS.values())),
     sorted(set(MOE_ROWS.values())), False),
    (MOE_TRAIN, MOE_EXPERTS, MOE_TRAIN_SITES, [MOE_TRAIN_ROWS], [], True),
    (JAMBA, JAMBA_EXPERTS, JAMBA_EXPERT_SITES,
     sorted(set(JAMBA_ROWS.values())),
     [JAMBA_ROWS["static decode"], JAMBA_ROWS["static prefill"]], False)]


def phase_kernels(torch) -> dict:
    """Parity and times of both kernels at every main-path shape (each
    row names its ``arch``): the static engine of every model, the
    continuous engine of llama-3.2-1b, mamba2-130m and qwen3-moe-30b-a3b,
    and the eval forwards of both tasks and best-of-n's engine of
    llama-3.2-1b and phi-3-mini-4k; qwen3-moe-30b-a3b's batched expert
    sites at every row count its forwards give them (``moe_case``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"analog_matmul": [], "int4_matmul": []}
    shapes = [(arch, site, k, n, m, stat, int4)
              for arch, sites, m, stat, int4 in MVM_RUNS
              for site, k, n, _ in sites]
    for arch, site, k, n, m, stat, int4 in shapes:
        for with_off in ((False, True) if stat else (False,)):
            r = analog_case(torch, gen, m, k, n, with_off,
                            noisy=(arch, m) in NOISY_RUNS)
            r["site"], r["arch"] = site, arch
            rows["analog_matmul"].append(r)
            unprom = ("" if r["flip_rate_unpromoted"] is None else
                      f", unpromoted {r['flip_rate_unpromoted']:.2e}")
            print(f"  analog_matmul {arch} {site:8s} M={m:4d} {k}->{n} "
                  f"off={int(with_off)} {r['mapping']} x{r['splits']}"
                  + (" noisy: " if r["noisy"] else ": ") +
                  f"{r['ms']:.4f} ms "
                  + ("given bound" if r["noisy"] else "folded") +
                  f" (explicit bound "
                  f"{r['explicit_bound_ms']:.4f}, wall {r['wall_ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, matmul {r['matmul_ms']:.4f}; "
                  f"bound {r['bound_ms']:.4f} by {r['bound_by']}, fp32 "
                  f"{r['fp32_bound_ms']:.4f}, mma {r['mma_bound_ms']:.4f}; "
                  f"adc_bound {r['adc_bound_ms']:.4f}), flips {r['flips']} "
                  f"of {r['parity_outputs']} ({r['flip_rate']:.2e}{unprom}),"
                  f" clipped at the ADC {r['adc_clipped']:.2e}")
        if int4:
            r = int4_case(torch, gen, m, k, n)
            r["site"], r["arch"] = site, arch
            rows["int4_matmul"].append(r)
            print(f"  int4_matmul   {arch} {site:8s} M={m:4d} {k}->{n} "
                  f"{r['mapping']} x{r['splits']}: {r['ms']:.4f} ms (wall "
                  f"{r['wall_ms']:.4f}, plain {r['plain_ms']:.4f}, matmul "
                  f"{r['matmul_ms']:.4f}; bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, fp32 {r['fp32_bound_ms']:.4f}, mma "
                  f"{r['mma_bound_ms']:.4f}), err/bound "
                  f"{r['max_err_over_bound']:.2e}")
        torch.cuda.empty_cache()
    # the int4 drafter's prompt prefills (phase 21) and the LM head's rows
    # under last_only: parity and the kernel's time
    head = [s for s in SITES if s[0] == "lm_head"]
    runs = [(m, site) for m in draft_prefill_rows() for site in SITES
            if site[0] != "lm_head"]
    for kernel, m in HEAD_ROWS:
        site, k, n, _ = head[0]
        if kernel == "analog_matmul":
            r = analog_case(torch, gen, m, k, n, False)
            r["site"], r["arch"], r["partial"] = site, ARCH, True
            rows["analog_matmul"].append(r)
            print(f"  analog_matmul {ARCH} {site:8s} M={m:4d} {k}->{n} "
                  f"last position, {r['mapping']} x{r['splits']}: "
                  f"{r['ms']:.4f} ms, flips {r['flips']} of "
                  f"{r['parity_outputs']}")
        else:
            runs.append((m, head[0]))
    for m, (site, k, n, _) in runs:
        r = int4_case(torch, gen, m, k, n, timed=False)
        r["site"], r["arch"], r["partial"] = site, ARCH, True
        rows["int4_matmul"].append(r)
        print(f"  int4_matmul   {ARCH} {site:8s} M={m:4d} {k}->{n} "
              f"draft prefill, {r['mapping']} x{r['splits']}: "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}), err/bound {r['max_err_over_bound']:.2e}")
    torch.cuda.empty_cache()
    for arch, e, sites, m_rows, int4_rows, noisy in EXPERT_RUNS:
        for site, k, n, _ in sites:
            for m in m_rows:
                kernels = ("analog_matmul",) + (
                    ("int4_matmul",) if m in int4_rows else ())
                for kernel in kernels:
                    r = moe_case(torch, gen, kernel, e, m, k, n, arch, noisy)
                    r["site"] = site
                    rows[kernel].append(r)
                    print(f"  {kernel} {arch} {site} E={e} M={m} {k}->{n} "
                          f"one launch{' noisy' if noisy else ''}, "
                          f"{r['mapping']} x{r['splits']}: "
                          f"{r['ms']:.4f} ms (wall {r['wall_ms']:.4f}, plain "
                          f"{r['plain_ms']:.4f}, torch.bmm "
                          f"{r['matmul_ms']:.4f}; bound {r['bound_ms']:.4f} "
                          f"by {r['bound_by']}), "
                          + (f"flips {r['flips']} of {e * m * n}"
                             if "flips" in r else
                             f"err/bound {r['max_err_over_bound']:.2e}"))
                torch.cuda.empty_cache()
    for name, cases in rows.items():
        for arch, m, tot in forward_totals(cases):
            print(f"  {name} per {arch} forward at M={m}: "
                  + ", ".join(f"{key} {val:.4f}" for key, val in tot.items()))
    return rows


#: analog sites of one forward, by (arch, site name, batched experts)
PER_SITE = {(arch, s[0], experts): s[3]
            for arch, sites, experts in (
                (ARCH, SITES, False), (PHI3, PHI3_SITES, False),
                (MAMBA, MAMBA_SITES, False), (MOE, MOE_DENSE_SITES, False),
                (MOE, MOE_SITES, True),
                (MOE_TRAIN, MOE_TRAIN_DENSE_SITES, False),
                (MOE_TRAIN, MOE_TRAIN_SITES, True),
                (JAMBA, JAMBA_SITES, False), (JAMBA, JAMBA_EXPERT_SITES, True),
                (INTERNVL, INTERNVL_SITES + INTERNVL_PROJECTOR, False),
                (MUSICGEN, MUSICGEN_SITES, False),
                (INTERNVL_TRAIN, INTERNVL_SITES + INTERNVL_PROJECTOR, False),
                (MUSICGEN_TRAIN, MUSICGEN_SITES, False))
            for s in sites}
#: the per-shape times and bounds that forward_totals sums
TOTAL_KEYS = ("ms", "explicit_bound_ms", "plain_ms", "matmul_ms",
              "adc_bound_ms", "bound_ms", "fp32_bound_ms", "mma_bound_ms")


def forward_totals(cases: list) -> list:
    """(arch, M, {key: total over the sites of one forward}) for every
    (arch, M) of phase 2, without col_off (which only phase 19's ageing
    chip adds) and without the rows of part of a forward (phase 21's
    drafter prefills and LM heads on the last position)."""
    out = {}
    for r in cases:
        if r.get("col_off") or r.get("partial"):
            continue
        tot = out.setdefault((r["arch"], r["M"]), {})
        for key in TOTAL_KEYS:
            if key in r:
                tot[key] = tot.get(key, 0.0) + PER_SITE[
                    r["arch"], r["site"], "E" in r] * r[key]
    return [(arch, m, tot) for (arch, m), tot in out.items()]


# ---------------------------------------------------------------------------
# phase 5: the paged-attention kernels
# ---------------------------------------------------------------------------

def paged_tables(torch, gen, rows: int, context: int, chunk: int,
                 bs: int = PAGED_BS):
    """Block tables and cursors: row ``b`` starts at a ragged ``start[b]``
    (0 to 4 blocks of left pad) and its last query column attends exactly
    ``context`` tokens. Distinct random physical blocks per row; block 0
    is the sink."""
    dev = torch.device("cuda")
    start = torch.randint(0, 4 * bs, (rows,), generator=gen, device=dev)
    pos = start + context - chunk               # first column of the chunk
    nb = -(-(4 * bs + context) // bs)
    npool = 1 + rows * nb
    perm = torch.randperm(npool - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(rows, nb).to(torch.int32).contiguous()
    return (tbl, pos.to(torch.int32).contiguous(),
            start.to(torch.int32).contiguous(), npool)


def paged_pool(torch, gen, npool: int, dtype: str, heads=LLAMA_PAGED):
    """One random pool ``(kp, vp, k_scale, v_scale)`` of ``dtype`` at
    ``heads`` = (H, KV, hd, block)."""
    dev = torch.device("cuda")
    _, nkv, hd, bs = heads
    shape = (npool, bs, nkv, hd)
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


def paged_work(torch, q, kp, tbl, pos, start) -> tuple[float, int]:
    """``(flops, bytes)`` of a paged kernel call on these inputs by
    ``repro_torch.kernels.cost.paged_attention``: the pool tokens each
    row's live range ``start .. pos + S - 1`` holds, and the keys each of
    its S columns attends (column ``i``: ``start .. pos + i``). Reads the
    cursors (a host sync)."""
    from repro_torch.kernels import cost as kcost

    return kcost.paged_work(q, kp, tbl, pos.cpu(), start.cpu())


def paged_case(torch, gen, kind: str, context: int, dtype: str,
               splits: int, heads=LLAMA_PAGED) -> dict:
    """One paged kernel case at ``heads`` = (H, KV, hd, block): parity
    against the plain version (and the yardstick against it, loosely),
    then device times of the kernel, the plain version and the yardstick
    beside the card's bound. Pool copies rotate so that the live bytes of
    all copies exceed the 50 MB L2."""
    from repro_torch.kernels import paged_attention as kd
    from repro_torch.kernels import paged_prefill as kp_
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    nq, nkv, hd, bs = heads
    decode = kind == "decode"
    rows = DECODE_ROWS if decode else PREFILL_ROWS
    chunk = 1 if decode else ENGINE_CHUNK
    tbl, pos, start, npool = paged_tables(torch, gen, rows, context, chunk,
                                          bs)
    elem = {"f32": 4, "bf16": 2, "i8": 1}[dtype]
    live = rows * context                      # tokens the kernel must read
    kv_bytes = live * nkv * (2 * hd * elem + (8 if dtype == "i8" else 0))
    pools = [paged_pool(torch, gen, npool, dtype, heads)
             for _ in range(n_copies(kv_bytes))]
    qshape = (rows, nq, hd) if decode else (rows, chunk, nq, hd)
    q = torch.randn(qshape, generator=gen, device=dev)
    scale = hd ** -0.5

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
    name = (f"paged {kind} H{nq} KV{nkv} hd{hd} ctx={context} {dtype}"
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
    # each input read once, the output written once: the live K/V (+
    # scales), q, out, the table rows and cursors; the keys each column
    # attends (repro_torch.kernels.cost, which the cost counter also uses)
    flops, nbytes = paged_work(torch, q, pools[0][0], tbl, pos, start)
    bnd, by = bound_ms(nbytes, flops)
    pool_dtype = pools[0][0].dtype
    plan = (kd.decode_plan(nq, nkv, hd, bs, pool_dtype)
            if decode else kp_.prefill_plan(hd, bs, pool_dtype))
    del pools
    return {"kind": kind, "heads": list(heads), "context": context,
            "dtype": dtype,
            "splits": splits, "rows": rows, "chunk": chunk, "ms": ms,
            "wall_ms": wall, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd, "bound_by": by, "copies": n,
            "flops": flops, "bytes": nbytes,
            "max_abs_err": float(err.max()), "library_abs_err": lib_err,
            "plan": plan_dict(plan, bs)}


def verify_case(torch, gen, s: int, dtype: str, heads) -> dict:
    """``paged_flash_prefill`` at a verify window of ``s`` columns over the
    engine's 8 slots at ``heads`` = (H, KV, hd, block): every row's cursor
    odd, and its window crossing a block boundary (``pos = 16 j - 1``, at
    contexts of 320 to 656). Held against the plain version at PAGED_TOL
    (the gate), then the verify seam, reported and not gated: each column
    against ``paged_flash_decode`` at cursor ``pos + i`` (one split, the
    decode steps the window replaces), its largest difference and whether
    it is bitwise. The kernel's device time on one pool (warm L2)."""
    from repro_torch.kernels import paged_attention as kd
    from repro_torch.kernels import paged_prefill as kp_
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    nq, nkv, hd, bs = heads
    rows = DECODE_ROWS
    start = torch.randint(0, 4 * bs, (rows,), generator=gen, device=dev)
    pos = bs * (20 + 3 * torch.arange(rows, device=dev)) - 1
    nb = -(-int(pos.max() + s) // bs)
    npool = 1 + rows * nb
    perm = torch.randperm(npool - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(rows, nb).to(torch.int32).contiguous()
    pos, start = (t.to(torch.int32).contiguous() for t in (pos, start))
    kp, vp, ks, vs = paged_pool(torch, gen, npool, dtype, heads)
    q = torch.randn((rows, s, nq, hd), generator=gen, device=dev)
    scale = hd ** -0.5
    out = kp_.paged_flash_prefill(q, kp, vp, tbl, pos, start, scale=scale,
                                  k_scale=ks, v_scale=vs)
    want = ref.paged_prefill_ref(q, kp, vp, tbl, pos, start, scale, ks, vs)
    torch.cuda.synchronize()
    name = f"verify S={s} H{nq} KV{nkv} hd{hd} {dtype}"
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = (out - want).abs()
    check(bool((err <= PAGED_TOL * (1 + want.abs())).all()),
          f"{name}: differs from the plain version by {float(err.max()):.3e}")
    seam, bitwise = 0.0, 0
    for i in range(s):
        dec = kd.paged_flash_decode(q[:, i].contiguous(), kp, vp, tbl,
                                    pos + i, start, scale=scale, k_scale=ks,
                                    v_scale=vs, num_splits=1)
        seam = max(seam, float((out[:, i] - dec).abs().max()))
        bitwise += bool(torch.equal(out[:, i], dec))
    ms = device_ms(torch, lambda i: kp_.paged_flash_prefill(
        q, kp, vp, tbl, pos, start, scale=scale, k_scale=ks, v_scale=vs), 1)
    return {"kind": "verify", "heads": list(heads), "dtype": dtype,
            "chunk": s, "rows": rows, "ms": ms,
            "max_abs_err": float(err.max()), "seam_max_abs": seam,
            "seam_bitwise_columns": bitwise}


def plan_dict(plan, bs: int) -> dict:
    """A paged kernel's plan as its design parameters: warps of a thread
    block, query vectors of its tile, the lanes of a warp (tile x key
    lanes x chunk lanes), the keys a warp takes per iteration (one pool
    block) and per lane, and the pool blocks in flight per warp."""
    return {"warps": plan.warps, "tile": plan.tile,
            "lanes": [plan.tile, plan.key_lanes, plan.chunk_lanes],
            "keys_per_warp_iteration": bs,
            "keys_per_lane": -(-bs // plan.key_lanes),
            "stages": plan.stages}


def phase_paged(torch) -> dict:
    """Parity and times of both paged kernels at every listed case:
    llama-3.2-1b's heads at every context, phi-3-mini-4k's (MHA, hd 96),
    qwen3-moe-30b-a3b's (GQA group 8, hd 64) and jamba-v0.1-52b's (GQA
    group 4, hd 128) at one context, each with every pool dtype (the fp32
    pool is the best-of-n engine's)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {"paged_flash_decode": [], "paged_flash_prefill": []}
    cases = ([(ARCH, LLAMA_PAGED, c) for c in PAGED_CONTEXTS]
             + [(PHI3, PHI3_PAGED, PHI3_PAGED_CONTEXT),
                (MOE, MOE_PAGED, MOE_PAGED_CONTEXT),
                (JAMBA, JAMBA_PAGED, JAMBA_PAGED_CONTEXT)])
    for arch, heads, context in cases:
        for dtype in POOL_DTYPES:
            kinds = [("decode", s) for s in DECODE_SPLITS] + [("prefill", 1)]
            for kind, splits in kinds:
                r = paged_case(torch, gen, kind, context, dtype, splits,
                               heads)
                r["arch"] = arch
                rows[f"paged_flash_{kind}"].append(r)
                pl = r["plan"]
                print(f"  {kind:7s} {arch} H{heads[0]} KV{heads[1]} "
                      f"hd{heads[2]} ctx={context:4d} {dtype:4s} "
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
    # the verify windows of phase 21 (chunks of 2, 3 and 5 columns)
    for arch, heads in SPEC_PAGED:
        for dtype in POOL_DTYPES:
            for s in SPEC_CHUNKS:
                r = verify_case(torch, gen, s, dtype, heads)
                r["arch"] = arch
                rows["paged_flash_prefill"].append(r)
                print(f"  verify  {arch} H{heads[0]} KV{heads[1]} "
                      f"hd{heads[2]} S={s} {dtype:4s} odd cursors across a "
                      f"block: {r['ms']:.4f} ms (warm L2), max err "
                      f"{r['max_abs_err']:.2e}; seam against {s} decode "
                      f"steps: max |d| {r['seam_max_abs']:.2e}, "
                      f"{r['seam_bitwise_columns']} of {s} columns bitwise")
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
    from repro_torch.kernels import cost as kcost
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
    # / H)), two operations per FMA (repro_torch.kernels.cost.ssd_scan_least,
    # whose bytes are the cost counter's); the kernel runs its products as
    # split TF32 on the tensor cores, three TF32 products per fp32 product
    flops, nbytes = kcost.ssd_scan_least(rows, tokens, heads, pdim, n, g,
                                         with_h0)
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
            "mbytes": nbytes / 1e6, "flops": flops, "bytes": nbytes,
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
    """Parity and times of ssd_scan at mamba2-130m's shapes and at
    jamba-v0.1-52b's heads (128 of P 64, N 16)."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    runs = ([(MAMBA, c) for c in SSD_CASES]
            + [(JAMBA, c) for c in JAMBA_SSD_CASES])
    for arch, (name, b, s, with_h0) in runs:
        cfg = get_config(arch)
        r = ssd_case(torch, gen, cfg, name, b, s, with_h0)
        r["arch"] = arch
        rows.append(r)
        passes = ("" if r["passes_ms"] is None else
                  f", as the three passes {r['passes_ms']:.4f} ms")
        print(f"  ssd_scan {arch} H{cfg.ssm_heads} N{cfg.ssm_state} "
              f"{name:6s} {b} x {s:4d} h0={int(with_h0)}: "
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
    res.update(step_times(torch, cfg, p, acfg, prompt, STEP_TIME_TOKENS))
    print(f"  mamba {deploy}: launches {launches}, generate {gen_s:.2f}s; vs "
          f"{what}: " + (f"{res['site_flips']} of {res['site_elements']} site "
                         f"outputs one ADC level apart at near-ties; "
                         if "sites" in res else "")
          + f"max |dlogit| {res['max_logit_diff']:.3e}, rel L2 {rel_l2:.3e}, "
          f"greedy tokens agree {res['greedy_agree']}/{BATCH * MAMBA_NEW}; "
          f"prefill {res['prefill_ms']:.2f} ms ({res['prefill_device_ms']:.2f}"
          f" on the device), decode {res['decode_ms']:.2f} ms/step, on the "
          f"device {res['decode_device_ms']:.2f} ms (busy "
          f"{res['device_busy']:.3f})")
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
    every attention layer, and the LM head unless tied; a hybrid mixer's
    two and its FFN's two (a MoE FFN's expert sites one launch each). The
    vlm's projector runs only in a prefill with patch embeddings."""
    if cfg.family == "ssm":
        return 2 * cfg.num_layers
    return 4 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)


def attn_layers(cfg) -> int:
    """Attention layers of the stack (one per hybrid super-block)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def mixer_layers(cfg) -> int:
    """Mamba-2 mixers of the stack: one ``ssd_scan`` launch each per
    prefill or chunk forward."""
    return cfg.num_layers - attn_layers(cfg)


def moe_layers(cfg) -> int:
    """Routed MoE FFNs of the stack."""
    if cfg.family == "moe":
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // 2
    return 0


#: the engine counters a graphed run must share with an eager one
AB_COUNTERS = ("decode_steps", "mixed_steps", "prefill_forwards",
               "prefill_chunks", "decode_tokens_during_admission",
               "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
               "prefix_skipped_tokens", "spec_steps", "spec_proposed",
               "spec_accepted", "draft_forwards", "recal_count",
               "watchdog_checks", "drift_hours")


def engine_run(torch, eng, reqs, eager: bool = False) -> dict:
    """Serve ``reqs`` on ``eng`` (its step bodies eagerly with ``eager``,
    else as its captured CUDA graphs), every launch count and the peak
    memory set to 0 just before: the results, seconds, peak GB, launches,
    ``analog_matmul`` calls by ``col_off``, recalibrations, the
    :data:`AB_COUNTERS`, mean TTFT and TPOT, host ms per decode forward of
    a decode block and per fused step (the steps that captured a graph
    included), and the graphs' telemetry."""
    eng._eager = eager
    with_off, recals = {}, []
    counters = _counters()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():
        m.launches = 0
    t0 = time.perf_counter()
    with col_off_counted(with_off), recal_recorded(recals):
        results = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ttft = [eng.first_token_at[r.uid] - eng.submit_time[r.uid] for r in reqs]
    tpot = [(eng.finished_at[r.uid] - eng.first_token_at[r.uid])
            / max(1, len(results[r.uid]) - 1) for r in reqs]
    blocks = eng.decode_steps - eng.mixed_steps - eng.spec_steps
    sg = eng.step_graphs
    return {"results": results, "run_s": run_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {n: m.launches for n, m in counters.items()},
            "with_off": with_off, "recals": recals,
            "counters": {k: getattr(eng, k) for k in AB_COUNTERS},
            "ttft_ms": 1e3 * float(np.mean(ttft)),
            "tpot_ms": 1e3 * float(np.mean(tpot)),
            "decode_forward_host_ms": (1e3 * eng.phase_time["decode"]
                                       / max(1, blocks)),
            "mixed_step_host_ms": (1e3 * eng.phase_time["mixed"]
                                   / max(1, eng.mixed_steps)),
            "graphs": ({"captured": sg.captures, "replays": sg.replays,
                        "capture_s": sg.capture_s,
                        "keys": [list(k) for k in sg.keys()]}
                       if sg is not None and not eager else None)}


def engine_ab(torch, runs: dict, tag: str) -> dict:
    """Gate an eager and a graphed run of one workload (:func:`engine_run`):
    tokens bit for bit, every counter, launch and recalibration record
    equal; print tokens/s, TTFT, TPOT, host ms a step and peak GB side by
    side and the graphs captured. Returns the side-by-side numbers."""
    e, g = runs["eager"], runs["graphed"]
    bad = [u for u in e["results"]
           if not np.array_equal(e["results"][u], g["results"].get(u))]
    check(not bad and sorted(e["results"]) == sorted(g["results"]),
          f"{tag}: graphed tokens differ from eager for requests {bad}")
    for key in ("counters", "launches", "with_off", "recals"):
        check(e[key] == g[key], f"{tag}: graphed {key} {g[key]}, eager "
              f"{e[key]}")
    total = sum(len(v) for v in g["results"].values())
    out = {}
    for name, r in runs.items():
        out[name] = {k: r[k] for k in ("run_s", "peak_gb", "ttft_ms",
                                       "tpot_ms", "decode_forward_host_ms",
                                       "mixed_step_host_ms")}
        out[name]["tokens_per_s"] = total / r["run_s"]
    out["graphs"] = g["graphs"]
    print(f"  {tag}, eager / graphed: " + ", ".join(
        f"{k} {out['eager'][k]:.2f} / {out['graphed'][k]:.2f}" for k in (
            "tokens_per_s", "ttft_ms", "tpot_ms", "decode_forward_host_ms",
            "mixed_step_host_ms", "peak_gb"))
          + f"; tokens, counters and launches equal bit for bit; "
          f"{g['graphs']['captured']} graphs captured in "
          f"{g['graphs']['capture_s']:.2f} s, {g['graphs']['replays']} "
          "replays")
    return out


def engine_phase(torch, cfg, params, labels, deploy: str,
                 kv_bits: int, inplace: bool = False,
                 chip: bool = False, ab: bool = False) -> dict:
    """Serve the mixed workload at full width with ``paged=True`` under
    ``deploy``; check that every request finished, every block came back
    (an ssm stack has no pool and must say why) and every call ran on its
    kernel; measure tokens/s, the peak memory and the device busy share
    of a decode step. ``inplace`` deploys into ``params`` itself (a model
    whose second copy does not fit the card). ``chip`` (``analog_hw``)
    serves on an ageing chip (:func:`attach_chip`) with the drift clock
    spanning about DEVICE_ENGINE_H hours and the watchdog on
    (DEVICE_RECAL): it must reprogram at least once, each time lowering
    the tile scale error, keep ``nu`` / ``dead`` / ``stuck`` bit for bit
    and every leaf's storage, and evict nothing; every non-expert
    launch carries ``col_off``; the busy and graph checks then run
    (:func:`devices_graph_check`). The engine replays its step graphs;
    with ``ab`` the workload first runs on an engine whose bodies run
    eagerly, which the graphed run must equal bit for bit
    (:func:`engine_ab`; on the chip, from the same state: the drift clock
    writes the device leaves, which are restored in between)."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serve.scheduler import (SchedulerConfig, ServeEngine,
                                             required_max_len)

    gen = torch.Generator(device="cuda").manual_seed(7)
    p, acfg = deploy_model(_deploy_args(deploy), cfg, params, labels, gen,
                           inplace=inplace)
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
    run_scfg = scfg
    if chip:
        check(deploy == "analog_hw", f"{deploy}: the device model is analog")
        p = attach_chip(torch, p, labels, 0.0)
        # the CLI's estimate of the run's engine steps
        steps = (sum(r.max_new for r in reqs) // ENGINE_SLOTS + len(reqs))
        run_scfg = dataclasses.replace(
            scfg, drift_dt=DEVICE_ENGINE_H / steps, recalibrate=True,
            **DEVICE_RECAL)
        leaves = chip_leaves(p)
        kept = {k: v.clone() for k, v in leaves.items()
                if k.rsplit("/", 1)[1] in ("nu", "dead", "stuck")}
        ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    tag = f"{cfg.name} {deploy} kv_bits={kv_bits}"
    runs = {}
    if ab:
        state = ({k: v.clone() for k, v in chip_leaves(p).items()} if chip
                 else {})
        runs["eager"] = engine_run(torch, ServeEngine(p, cfg, acfg,
                                                      run_scfg), reqs,
                                   eager=True)
        for k, v in chip_leaves(p).items():
            v.copy_(state[k])
        del state
        torch.cuda.empty_cache()
    eng = ServeEngine(p, cfg, acfg, run_scfg)
    runs["graphed"] = run = engine_run(torch, eng, reqs)
    results, run_s, peak_gb = run["results"], run["run_s"], run["peak_gb"]
    launches, with_off, recals = (run["launches"], run["with_off"],
                                  run["recals"])
    total = sum(len(v) for v in results.values())
    check(sorted(results) == [r.uid for r in reqs], f"{tag}: lost requests")
    for r in reqs:
        out = results[r.uid]
        check(eng.status[r.uid] == "finished" and len(out) == r.max_new
              and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"{tag}: request {r.uid} ended {eng.status[r.uid]} with "
              f"{len(out)}/{r.max_new} tokens")
    ssm = cfg.family == "ssm"
    if ssm:
        check(eng.pool is None and "paged" in eng.gating_reasons,
              f"{tag}: paged on an ssm stack is not inert and explained")
    # the prefix cache (on by default) retains released prompt blocks and
    # snapshots: every one is live, free or cached, and none stays live
    for pool in (eng.pool, eng.state_pool):
        if pool is not None:
            check(pool.num_live == 0
                  and pool.num_free + pool.num_cached == pool.num_blocks,
                  f"{tag}: blocks not returned ({pool.num_live} live, "
                  f"{pool.num_free} free, {pool.num_cached} cached of "
                  f"{pool.num_blocks})")
    forwards = eng.decode_steps + eng.prefill_forwards
    want = {mvm: mvm_sites(cfg) * forwards,
            "ssd_scan": mixer_layers(cfg) * eng.prefill_forwards,
            "paged_flash_decode": attn_layers(cfg) * eng.decode_steps,
            "paged_flash_prefill": attn_layers(cfg) * eng.prefill_forwards}
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{tag}: {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    drift = {}
    if chip:
        tag += " on an ageing chip"
        experts = 2 * moe_layers(cfg) * forwards
        expect = {"col_off": want[mvm] - experts, "plain": experts}
        check(with_off == {k: v for k, v in expect.items() if v},
              f"{tag}: analog_matmul calls {with_off}, expected {expect}")
        check(eng.recal_count >= 1 and len(recals) == eng.recal_count,
              f"{tag}: {eng.recal_count} recalibrations, "
              f"{len(recals)} recorded")
        check(all(after < before for before, after in recals),
              f"{tag}: a recalibration did not lower the tile scale error "
              f"{recals}")
        leaves = chip_leaves(p)
        check({k: v.data_ptr() for k, v in leaves.items()} == ptrs,
              f"{tag}: a device leaf was replaced, not written")
        check(all(torch.equal(leaves[k], v) for k, v in kept.items()),
              f"{tag}: nu, dead or stuck changed across recalibrations")
        drift = {"drift_hours": eng.drift_hours,
                 "watchdog_checks": eng.watchdog_checks,
                 "recal_count": eng.recal_count,
                 "recal_s": eng.recal_time,
                 "tile_scale_err": [list(r) for r in recals],
                 "dead_tiles": eng.dead_tiles,
                 "stuck_cols": eng.stuck_cols,
                 "col_off_launches": with_off.get("col_off", 0)}
    res = {"deploy": deploy, "kv_bits": kv_bits, "run_s": run_s, **drift,
           "peak_gb": peak_gb,
           "tokens": total, "tokens_per_s": total / run_s,
           "decode_steps": eng.decode_steps, "mixed_steps": eng.mixed_steps,
           "prefill_forwards": eng.prefill_forwards,
           "decode_tokens_during_admission":
               eng.decode_tokens_during_admission,
           "phase_s": dict(eng.phase_time), "launches": launches,
           "gating_reasons": dict(eng.gating_reasons),
           "graphs": run["graphs"]}
    if ab:
        res["ab"] = engine_ab(torch, runs, tag)
        if not chip:
            res["ab_sampled"] = sampled_ab(torch, cfg, p, acfg, scfg)
    res.update(engine_busy(torch, cfg, p, acfg, scfg))
    if chip:
        res["graph"] = devices_graph_check(torch, cfg, p, acfg, scfg)
        print(f"  {tag}: {eng.drift_hours:.1f} h deployed, "
              f"{eng.watchdog_checks} watchdog checks, {eng.recal_count} "
              f"recalibrations in {eng.recal_time:.3f} s (tile scale error "
              + ", ".join(f"{a:.4f} -> {b:.4f}" for a, b in recals)
              + f"; {eng.tile_scale_err:.4f} at the end), {eng.dead_tiles} "
              f"dead tiles, {eng.stuck_cols} stuck columns; no request, "
              f"slot or block evicted; nu, dead, stuck and every leaf's "
              f"storage kept; {with_off} analog_matmul calls by col_off")
    print(f"  {tag}: {total} tokens of {len(reqs)} requests in {run_s:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s, peak {peak_gb:.2f} GB), "
          f"{eng.decode_steps} decode "
          f"forwards, {eng.prefill_forwards} chunk forwards "
          f"({eng.mixed_steps} fused with decode), launches {launches}; "
          f"{run['graphs']['captured']} step graphs captured in "
          f"{run['graphs']['capture_s']:.2f} s, {run['graphs']['replays']} "
          f"replays; decode step {res['decode_step_ms']:.2f} ms host "
          f"({res['decode_step_eager_ms']:.2f} eager), "
          f"{res['decode_device_ms']:.2f} ms device (busy "
          f"{res['device_busy']:.3f}); chunk forward "
          f"{res['chunk_forward_ms']:.2f} ms host, "
          f"{res['chunk_device_ms']:.2f} ms device by "
          f"{res['chunk_timing']} (busy {res['chunk_busy']:.3f}, context "
          f"{res['chunk_context']:.0f})")
    del eng, p
    torch.cuda.empty_cache()
    return res


def sampled_ab(torch, cfg, p, acfg, scfg) -> dict:
    """SAMPLED_AB requests sampled at temperature 0.8, top-k 50 and top-p
    0.9 (prompts and budgets of :func:`engine_requests`, another seed)
    through an eager and a graphed engine: :func:`engine_ab`'s gates."""
    from repro_torch.serve.scheduler import ServeEngine

    reqs = [dataclasses.replace(r, top_p=0.9)
            for r in engine_requests(cfg, SAMPLED_AB, seed=1)]
    runs = {name: engine_run(torch, ServeEngine(p, cfg, acfg, scfg), reqs,
                             eager=name == "eager")
            for name in ("eager", "graphed")}
    return engine_ab(torch, runs, f"{cfg.name} {SAMPLED_AB} sampled "
                     "requests (top-k 50, top-p 0.9)")


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
    eng.step()                      # the decode block's graph is captured
    host = {}
    for mode in ("graphed", "eager"):
        eng._eager = mode == "eager"
        steps0 = eng.decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        host[mode] = ((time.perf_counter() - t0) * 1e3
                      / (eng.decode_steps - steps0))
    host_ms = host["graphed"]
    check(all(s is not None for s in eng.slots), "busy: a slot retired")
    eng._refresh_device_state()
    d = eng._dev

    def step():
        logits, _ = serve_step(params, cfg, acfg, d["toks"][:, None],
                               eng.caches, d["off"][:, None],
                               seq_mask=d["active"][:, None])
        return torch.argmax(logits, dim=-1)

    dev_ms = graph_ms(torch, step, reps=10)
    # one decode call's work at the table's capacity and at the keys the
    # replayed step's cursors reach (phase 24's rate divides the second)
    from repro_torch.kernels import cost as kcost
    c = eng.caches
    paged = None
    if isinstance(c, dict) and "kp" in c:
        q = torch.empty((ENGINE_SLOTS, cfg.num_heads, cfg.head_dim),
                        device="meta")
        paged = {"capacity": kcost.paged_work(q, c["kp"][0], c["tbl"][0]),
                 "attended": kcost.paged_work(q, c["kp"][0], c["tbl"][0],
                                              c["pos"][0].cpu(),
                                              c["start"][0].cpu())}
    res = {"decode_step_ms": host_ms, "decode_device_ms": dev_ms,
           "device_busy": dev_ms / host_ms,
           "decode_step_eager_ms": host["eager"], "decode_paged": paged}
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
        # llama's analog_hw run on the bf16 pool: eager against graphed
        out[key] = engine_phase(torch, cfg, params, labels, deploy, kv_bits,
                                ab=key == "analog_hw/kv16")
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


#: (layers, d_model, padded_vocab) each full-width model must have
FULL_WIDTH = {ARCH: (16, 2048, 128256), PHI3: (PHI3_LAYERS, 3072, 32256),
              MOE: (MOE_LAYERS, 2048, 152064),
              JAMBA: (JAMBA_LAYERS, 4096, 65536),
              INTERNVL: (INTERNVL_LAYERS, 2048, 92672),
              MUSICGEN: (MUSICGEN_LAYERS, 1536, 2048)}


def model_config(arch: str):
    """``arch``'s published config; qwen3-moe-30b-a3b cut to MOE_LAYERS of
    its 48 layers and jamba-v0.1-52b to one super-block (JAMBA_LAYERS) of
    its four (at full depth their fp32 weights do not fit the card);
    phi-3-mini-4k, internvl2-2b and musicgen-medium cut to PHI3_LAYERS,
    INTERNVL_LAYERS and MUSICGEN_LAYERS (the script's time limit)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = {MOE: MOE_LAYERS, JAMBA: JAMBA_LAYERS, PHI3: PHI3_LAYERS,
             INTERNVL: INTERNVL_LAYERS, MUSICGEN: MUSICGEN_LAYERS}
    if arch in depth:
        cfg = dataclasses.replace(cfg, num_layers=depth[arch])
    return cfg


def model_prompt(torch, cfg, gen, rows: int, tokens: int):
    """A random prompt of ``cfg``'s family and its extra inputs: tokens
    [rows, tokens] (audio: [rows, tokens, codebooks]) and, for the vlm,
    ``patch_embeds`` [rows, vit_tokens, vit_dim] (None otherwise)."""
    dev = gen.device
    shape = (rows, tokens) + ((cfg.num_codebooks,) if cfg.family == "audio"
                              else ())
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=dev)
    extra = None
    if cfg.family == "vlm":
        extra = {"patch_embeds": torch.randn(
            (rows, cfg.vit_tokens, cfg.vit_dim), generator=gen, device=dev)}
    return prompt, extra


def prefix_len(cfg, extra) -> int:
    """Cache positions ahead of the prompt (the vlm's patch tokens)."""
    return cfg.vit_tokens if extra is not None else 0


def full_width(torch, arch: str, seed: int = 0, layers: int | None = None):
    """``arch`` at full width (and depth, but for ``model_config``'s cut,
    or ``layers`` of its layers when given) on the card, random weights
    from ``seed``: ``(cfg, params, labels)``."""
    from repro_torch.models import build

    dev = torch.device("cuda")
    cfg = model_config(arch)
    want = FULL_WIDTH[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        want = (layers,) + want[1:]
    cfg, params, labels = build(cfg, torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    check((cfg.num_layers, cfg.d_model, cfg.padded_vocab) == want,
          f"unexpected config {cfg}")
    return cfg, params, labels


def serve_phase(torch, deploy: str, base: str, arch: str = ARCH,
                chip: bool = False) -> dict:
    """Serve full-width ``arch`` under ``deploy`` on the kernels and check
    it against the unfused ``base`` deployment of the same weights: site
    by site on the same inputs (the ADC contract), and end to end (the
    logits' relative L2 within E2E_TOL). The model is built from the seed
    for this deployment alone and deployed in place (one copy of the
    weights is alive; the unfused ``digital_rtn4`` adds only one layer's
    quantized leaf at a time). Every kernel's launches are counted; a
    model with experts has each greedy token that differs between the two
    runs attributed (:func:`token_attribution`). The peak memory of the
    whole phase is reported. ``chip`` (``analog_hw``) serves the
    programmed weights on an ageing, faulty chip (:func:`attach_chip`,
    DEVICE_AGE_H old): every non-expert site's launch must carry
    ``col_off``; the unfused steps are not timed."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.models import build
    from repro_torch.serve.decode import generate, prefill

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg, params, labels = build(model_config(arch), gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    check((cfg.num_layers, cfg.d_model, cfg.padded_vocab)
          == FULL_WIDTH[arch], f"unexpected config {cfg}")
    fused_p, fused_acfg = deploy_model(_deploy_args(deploy), cfg, params,
                                       labels, gen, inplace=True)
    mvm = "analog_matmul"
    if deploy == "analog_hw":
        fused_acfg = dataclasses.replace(fused_acfg, use_pallas=True)
        base_p = fused_p                  # same programmed (noisy) weights
        base_acfg = dataclasses.replace(fused_acfg, use_pallas=False)
    else:
        base_p, base_acfg = deploy_model(_deploy_args(base), cfg, params,
                                         labels, gen)
        mvm = "int4_matmul"
    del params
    if chip:
        check(deploy == "analog_hw", f"{deploy}: the device model is analog")
        fused_p = base_p = attach_chip(torch, fused_p, labels, DEVICE_AGE_H)
        deploy = f"{deploy}+devices"
    prompt, extra = model_prompt(torch, cfg, gen, BATCH, PROMPT_LEN)
    pre = prefix_len(cfg, extra)
    projector = 1 if extra is not None else 0

    zero_counts(torch)
    with_off = {}
    t0 = time.perf_counter()
    with col_off_counted(with_off):
        toks = generate(fused_p, cfg, fused_acfg, gen, prompt, NEW_TOKENS,
                        greedy_first=NEW_TOKENS, extra_inputs=extra)
        toks_host = toks.cpu()
    gen_s = time.perf_counter() - t0
    kernel_launches = launch_counts()
    launched = kernel_launches.get(mvm, 0)
    want = {mvm: mvm_sites(cfg) * FORWARDS + projector}
    if chip:
        experts = 2 * moe_layers(cfg) * FORWARDS     # the expert sites'
        expect = {"col_off": want[mvm] - experts, "plain": experts}
        check(with_off == {k: v for k, v in expect.items() if v},
              f"{arch} {deploy}: analog_matmul calls {with_off}, expected "
              f"{expect}: every non-expert site's with col_off")
    if mixer_layers(cfg):
        want["ssd_scan"] = mixer_layers(cfg)              # the prefill
    for name in _counters():
        got = kernel_launches.get(name, 0)
        check(got == want.get(name, 0), f"{arch} {deploy}: {name} launched "
              f"{got} times, expected {want.get(name, 0)}")
    shape = (BATCH, NEW_TOKENS) + ((cfg.num_codebooks,)
                                   if cfg.family == "audio" else ())
    check(tuple(toks_host.shape) == shape
          and int(toks_host.min()) >= 0
          and int(toks_host.max()) < cfg.vocab_size,
          f"{deploy}: bad tokens {toks_host}")

    max_len = pre + PROMPT_LEN + 1
    lf, _, _ = prefill(fused_p, cfg, fused_acfg, prompt, max_len, extra)
    lb, _, _ = prefill(base_p, cfg, base_acfg, prompt, max_len, extra)
    base_toks = generate(base_p, cfg, base_acfg, gen, prompt, NEW_TOKENS,
                         greedy_first=NEW_TOKENS, extra_inputs=extra).cpu()
    check(bool(torch.isfinite(lf).all()), f"{deploy}: non-finite logits")
    rel_l2 = float(torch.linalg.vector_norm(lf - lb)
                   / torch.linalg.vector_norm(lb))
    n_sites, n_el, n_flip = site_parity(torch, cfg, fused_p, fused_acfg,
                                        base_p, base_acfg, prompt,
                                        sites=mvm_sites(cfg) + projector,
                                        extra=extra)
    agree = int((toks_host == base_toks).sum())
    first_agree = int((toks_host[:, 0] == base_toks[:, 0]).sum())
    res = {"arch": arch, "deploy": deploy, "params": n_params,
           "launches": launched, "kernel_launches": kernel_launches,
           "col_off_launches": with_off.get("col_off", 0),
           "generate_s": gen_s,
           "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
           "max_logit_diff": float((lf - lb).abs().max()),
           "logit_scale": float(lb.abs().max()), "rel_l2": rel_l2,
           "sites": n_sites, "site_elements": n_el, "site_flips": n_flip,
           "greedy_agree": agree, "first_token_agree": first_agree}
    print(f"  {arch} {deploy}: {n_params / 1e9:.3f}B params, launches "
          f"{kernel_launches}, "
          f"generate {gen_s:.2f}s; vs {base}: {n_sites} sites on the same "
          f"inputs, {n_flip} of {n_el} outputs one ADC level apart at "
          f"near-ties ({n_flip / n_el:.2e}); end to end max |dlogit| "
          f"{res['max_logit_diff']:.3e} (|logit| <= "
          f"{res['logit_scale']:.3e}), rel L2 {rel_l2:.3e}, greedy tokens "
          f"agree {agree}/{toks_host.numel()}, first "
          f"{first_agree}/{toks_host[:, 0].numel()}")
    check(rel_l2 < E2E_TOL, f"{deploy}: fused vs unfused logits rel L2 "
          f"{rel_l2:.3e} >= {E2E_TOL}")
    if cfg.num_experts:
        res["attribution"] = token_attribution(
            torch, cfg, fused_p, fused_acfg, base_p, base_acfg, prompt,
            toks_host, f"{arch} {deploy}")
    res.update(step_times(torch, cfg, fused_p, fused_acfg, prompt,
                          extra=extra))
    if arch not in FAMILY_ARCHS and not chip:
        # phase 17 times the fused steps only: jamba's unfused digital_rtn4
        # steps quantize a 7.5 GB expert leaf per site call, which a
        # captured graph would keep, and the unfused times of the others
        # are yardsticks the script's time budget leaves out (phase 19's
        # too)
        res["unfused"] = step_times(torch, cfg, base_p, base_acfg, prompt,
                                    extra=extra)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    unf = res.get("unfused")
    print(f"  {arch} {deploy} on the kernels: {launched // FORWARDS} "
          f"launches per forward; prefill {res['prefill_ms']:.2f} ms "
          f"({res['prefill_device_ms']:.2f} on the device), "
          f"decode {res['decode_ms']:.2f} ms/step, of it on the device "
          f"{res['decode_device_ms']:.2f} ms (busy "
          f"{res['device_busy']:.3f}); peak {res['peak_gb']:.2f} GB"
          + ("" if unf is None else
             f"; unfused {base}: prefill {unf['prefill_ms']:.2f} ms "
             f"({unf['prefill_device_ms']:.2f} on the device), decode "
             f"{unf['decode_ms']:.2f} ms/step, on the device "
             f"{unf['decode_device_ms']:.2f} ms (busy "
             f"{unf['device_busy']:.3f})"))
    del fused_p, base_p
    torch.cuda.empty_cache()
    return res


def token_attribution(torch, cfg, pa, acfg_a, pb, acfg_b, prompt,
                      toks_a, what: str) -> dict:
    """Tie each row's first greedy token that differs between the fused
    (a) and unfused (b) runs to its cause, or fail. Both runs are repeated
    with every analog site call and every MoE routing recorded (the fused
    run must give its tokens again). Up to that token the two runs fed the
    row the same tokens, and a row's computation reads only its own row,
    so the first site output of the row that differs, in call order over
    the forwards up to that token, must have equal inputs in both runs and
    differ only by ADC levels at near-ties of the unfused pre-ADC value
    (``adc_mismatches``): that flip is the origin. A route of the row may
    move only after it (its router input moved with it), and then only
    where the unfused run's k-th and (k+1)-th router probabilities lie
    within twice the two runs' probability shift, so it is counted with
    its gap. A differing token with no differing site output before it, a
    site that parts with unequal inputs, or a route that moved before the
    origin fails the phase."""
    from repro_torch.serve.decode import generate

    logs = {}
    for tag, p, acfg in (("a", pa, acfg_a), ("b", pb, acfg_b)):
        sites, routes = [], []
        with sites_recorded(sites), routes_recorded(torch, routes, sites):
            toks = generate(p, cfg, acfg, None, prompt, NEW_TOKENS,
                            greedy_first=NEW_TOKENS).cpu()
        logs[tag] = (toks, sites, routes)
    check(torch.equal(logs["a"][0], toks_a), f"{what}: the fused run gave "
          f"other tokens when repeated")
    n_sites, n_routed = mvm_sites(cfg), moe_layers(cfg)
    for tag in "ab":
        check(len(logs[tag][1]) == n_sites * FORWARDS
              and len(logs[tag][2]) == n_routed * FORWARDS,
              f"{what}: {len(logs[tag][1])} sites, {len(logs[tag][2])} "
              f"routings recorded")
    bsz = prompt.shape[0]
    ta, tb = logs["a"][0], logs["b"][0]
    rows, moved_routes, max_gap_share = [], 0, 0.0
    for b in range(bsz):
        diff = (ta[b] != tb[b]).reshape(NEW_TOKENS, -1).any(-1)
        if not bool(diff.any()):
            continue
        t = int(torch.nonzero(diff)[0])
        origin = None
        for i in range(n_sites * (t + 1)):
            (p, xa, ya), (_, xb, yb) = logs["a"][1][i], logs["b"][1][i]
            expert = p["kernel"].dim() > 2
            c = ya.shape[1] // bsz if expert else 0

            def row(v):
                return v[:, b * c:(b + 1) * c] if expert else v[b]

            if torch.equal(row(ya), row(yb)):
                continue
            check(torch.equal(row(xa), row(xb)), f"{what}: row {b}, site "
                  f"{i % n_sites} of forward {i // n_sites}: its inputs "
                  f"differ before any site output of the row did")
            flips = adc_mismatches(torch, p, row(xb), row(ya), row(yb),
                                   acfg_b, f"{what}: row {b} origin")
            origin = {"forward": i // n_sites, "site": i % n_sites,
                      "flips": flips, "call": i}
            break
        check(origin is not None, f"{what}: row {b}'s token {t} differs "
              f"with no site output of the row apart before it")
        n_moved = 0
        for j in range(n_routed * (t + 1)):
            (ids_a, pr_a, _), (ids_b, pr_b, call) = (logs["a"][2][j],
                                                     logs["b"][2][j])
            moved = (ids_a[b].sort(-1).values
                     != ids_b[b].sort(-1).values).any(-1)
            if not bool(moved.any()):
                continue
            check(call > origin["call"], f"{what}: row {b}: a route moved "
                  f"before any site output of the row did")
            top = pr_b[b].sort(-1, descending=True).values
            k = cfg.top_k
            gap = (top[..., k - 1] - top[..., k])[moved]
            shift = (pr_a[b] - pr_b[b]).abs().amax(-1)[moved]
            max_gap_share = max(max_gap_share,
                                float((gap / shift.clamp_min(1e-30)).max()))
            n_moved += int(moved.sum())
        moved_routes += n_moved
        rows.append({"row": b, "token": t, **origin, "routes_moved": n_moved})
    res = {"differing_rows": rows, "routes_moved": moved_routes,
           "max_gap_over_shift": max_gap_share}
    print(f"  {what}: {len(rows)} of {bsz} rows part; each first differing "
          f"token follows an ADC near-tie flip ("
          + ", ".join(f"row {r['row']} token {r['token']}: forward "
                      f"{r['forward']} site {r['site']}, {r['flips']} flips, "
                      f"{r['routes_moved']} routes moved" for r in rows)
          + f"); every moved route after its row's origin (largest "
          f"k-th to (k+1)-th gap over the probability shift "
          f"{max_gap_share:.3f})")
    return res


def step_times(torch, cfg, params, acfg, prompt,
               new_tokens: int = STEP_TIME_TOKENS, extra=None) -> dict:
    """Host-clock time of one prefill and of a greedy decode step
    (synchronized, after the main-path run warmed everything up; median of
    3 rounds), and the device time of one decode step and of one prefill:
    each captured as a CUDA graph and replayed back to back, so that the
    card never waits for the host (launching a graph takes far less than
    running it; the graph's short gaps between its kernels are in the
    time). The decode step's share of the host-clock step is
    ``device_busy``. ``extra`` goes to the prefill (the vlm's patch
    embeddings)."""
    from repro_torch.serve.decode import prefill, serve_step

    max_len = prefix_len(cfg, extra) + prompt.shape[1] + new_tokens
    pre, dec = [], []
    for _ in range(3):                     # median of 3 rounds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, pos = prefill(params, cfg, acfg, prompt, max_len,
                                      extra)
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
    out["prefill_device_ms"] = graph_ms(torch, lambda: prefill(
        params, cfg, acfg, prompt, max_len, extra))
    return out


def site_parity(torch, cfg, params_a, acfg_a, params_b, acfg_b, tokens,
                sites: int = LAUNCHES_PER_FORWARD, extra=None):
    """Every analog site of one prefill, fused (a) against unfused (b) on
    the same input: the input path b's own forward gave that site. Every
    mismatch must be exactly one ADC level at a near-tie of path b's
    pre-ADC value, ``|frac(y * inv) - 1/2| <= K * 2^-24 * (|x_q| . |w|) *
    inv``, as in the kernel phase. Returns (sites, elements, flips)."""
    from repro_torch.core import analog as A
    from repro_torch.serve.decode import prefill

    calls = {"a": [], "b": []}
    for tag, params, acfg in (("a", params_a, acfg_a),
                              ("b", params_b, acfg_b)):
        with sites_recorded(calls[tag]):
            prefill(params, cfg, acfg, tokens,
                    prefix_len(cfg, extra) + tokens.shape[1], extra)
    check(len(calls["a"]) == len(calls["b"]) == sites,
          f"site count {len(calls['a'])}, {len(calls['b'])}")
    ctx = A.AnalogCtx()
    elements = flips = 0
    with torch.no_grad():
        for i, ((pa, _, _), (pb, x, _)) in enumerate(zip(calls["a"],
                                                          calls["b"])):
            ya, _ = A.analog_linear(pa, x, acfg_a, ctx)
            yb, _ = A.analog_linear(pb, x, acfg_b, ctx)
            elements += ya.numel()
            flips += adc_mismatches(torch, pb, x, ya, yb, acfg_b,
                                    f"site {i}: a fused/unfused")
    return len(calls["b"]), elements, flips


@contextlib.contextmanager
def sites_recorded(log: list):
    """Inside the block every analog site call of the models appends ``(p,
    x, y)`` (its params, input and output) to ``log``."""
    def spy(p, x, acfg, ctx):
        y, stats = real(p, x, acfg, ctx)
        log.append((p, x, y))
        return y, stats

    with sites_replaced(spy) as real:
        yield


@contextlib.contextmanager
def logits_recorded(torch, log: list, keep: int | None = None):
    """Inside the block every eval-task forward's logits must be finite,
    and the first ``keep`` of them (all with None) are appended to
    ``log``."""
    from repro_torch.eval import tasks

    real = tasks.model_apply

    def spy(*a, **k):
        out = real(*a, **k)
        check(bool(torch.isfinite(out[0]).all()), "eval: non-finite logits")
        if keep is None or len(log) < keep:
            log.append(out[0].clone())
        return out

    tasks.model_apply = spy
    try:
        yield
    finally:
        tasks.model_apply = real


def adc_mismatches(torch, p, x, ya, yb, acfg, what: str) -> int:
    """Elements where two outputs ``ya``, ``yb`` of the analog site ``p``
    on the same input ``x`` differ. Each must be exactly one ADC level at a
    near-tie of the pre-ADC value of ``acfg``'s unfused path, ``|frac(y *
    inv) - 1/2| <= K * 2^-24 * (|x_q| . |w|) * inv``. A batched (MoE)
    site, kernel [E, K, N] and x [E, ..., K], is held expert by expert. A
    site with per-tile device state (``analog``) is held on its corrupted
    weights and column offsets against the bound of its pristine weights,
    as ``analog_linear`` runs it (the offset's own rounding added to the
    tie's reach). Returns their count."""
    from repro_torch.core import devices, quant
    from repro_torch.kernels import ref

    if p["kernel"].dim() > 2:      # expert by expert: one [K, N] at a time
        k = p["kernel"].shape[-2]
        xs = x.reshape(p["kernel"].shape[0], -1, k)
        ya = ya.reshape(xs.shape[:2] + (-1,))
        yb = yb.reshape(ya.shape)
        return sum(adc_mismatches(
            torch, {"kernel": p["kernel"][e], "input_range":
                    p["input_range"]}, xs[e], ya[e], yb[e], acfg, what)
            for e in range(xs.shape[0]))
    qo = ref.qmax(acfg.output_bits)
    w = p["kernel"].float()
    if acfg.mode == "rtn":
        w = quant.rtn_dequantize(*quant.rtn_quantize(w, acfg.weight_bits,
                                                     axis=-2))
    beta = p["input_range"].reshape(()).float()
    k = w.shape[-2]
    x_q = quant.input_quantize(
        x.float().reshape(*w.shape[:-2], -1, k), beta, acfg.input_bits)
    bound = ref.adc_bound(w, beta, acfg.out_bound)
    b = torch.clamp_min(bound, 1e-8)
    if b.dim() > 1:
        b = b.unsqueeze(-2)
    off = torch.zeros(())
    if "device" in p and acfg.mode == "analog":
        w, off = devices.corrupt_weights(w, p["device"], bound)
    inv = ref.rdiv(qo, b) * ref.ADC_TIE_BREAK
    v = (x_q @ w + off) * inv
    err = (k * U32 * (x_q.abs() @ w.abs()) + U32 * off.abs()) * inv
    diff = (ya - yb).reshape(v.shape).abs()
    lsb = ref.div(b, qo).expand_as(diff)
    bad = diff != 0
    n_bad = int(bad.sum())
    if n_bad:
        level = ((diff[bad] - lsb[bad]).abs() / lsb[bad]).max()
        tie = (v[bad] - torch.floor(v[bad]) - 0.5).abs()
        check(float(level) < 1e-3 and bool((tie <= err[bad]).all()),
              f"{what} mismatch is not one ADC level at a near-tie")
    return n_bad


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
# phase 12: the noisy-eval protocol (paper §3.2) at full width, and the
# reduced eval on the card against the CPU
# ---------------------------------------------------------------------------

def eval_tasks(cfg) -> dict:
    """The paper suite's stand-ins at their default sizes: ``markov_next``
    (64 x 64 tokens of a Markov corpus over the model's vocabulary) and
    ``induction_copy`` (64 x 25)."""
    from repro_torch.data.corpus import MarkovCorpus
    from repro_torch.eval import tasks

    return {"markov_next": tasks.markov_next(MarkovCorpus(cfg.vocab_size,
                                                          seed=0)),
            "induction_copy": tasks.induction_copy(cfg.vocab_size)}


class SeedLog:
    """Wraps an eval task suite (``tasks``) for one ``evaluate`` call:
    per seed (one call of every task), the seconds since the previous seed
    ended (the perturbation included), each kernel's launches and the peak
    device memory. Inside :meth:`recording` every task forward's logits
    must be finite, and those of the first ``keep`` seeds are kept."""

    def __init__(self, torch, tasks: dict, keep: int = 0):
        self.torch, self.keep = torch, keep
        self.names = list(tasks)
        self.tasks = {n: self._wrap(f) for n, f in tasks.items()}
        self.seeds: list[dict] = []
        self.logits: list = []
        self.calls = 0

    def _wrap(self, fn):
        def task(p, cfg, acfg):
            out = fn(p, cfg, acfg)
            self.calls += 1
            if self.calls % len(self.names) == 0:
                self._end_seed()
            return out
        return task

    def start(self) -> None:
        """Zero the launch counts and the memory peak; start the clock."""
        zero_counts(self.torch)
        self.torch.cuda.reset_peak_memory_stats()
        self._last = {n: 0 for n in _counters()}
        self._t = time.perf_counter()

    def _end_seed(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = {n: m.launches for n, m in _counters().items()}
        self.seeds.append({
            "s": now - self._t,
            "launches": {n: counts[n] - self._last[n] for n in counts
                         if counts[n] != self._last[n]},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        torch.cuda.reset_peak_memory_stats()
        self._last, self._t = counts, time.perf_counter()

    def recording(self):
        """Check and keep the task forwards' logits inside the block."""
        return logits_recorded(self.torch, self.logits,
                               keep=self.keep * len(self.names))


def launch_counts() -> dict:
    """The kernels' launch counts since they were last set to 0 (only the
    kernels that launched)."""
    return {n: m.launches for n, m in _counters().items() if m.launches}


def zero_counts(torch) -> None:
    """Set every kernel's launch count to 0 once the card is idle."""
    torch.cuda.synchronize()
    for m in _counters().values():
        m.launches = 0


def check_runs(res: dict, names, n: int, what: str) -> None:
    """``evaluate``'s results: ``n`` runs per task, each a share."""
    for name in names:
        runs = res[name]["runs"]
        check(len(runs) == n and all(0.0 <= r <= 1.0 for r in runs),
              f"{what}: {name} runs {runs}")


def phase_eval(torch, arch: str) -> dict:
    """The §3.2 protocol at full width on the card, random weights from a
    seed (so the scores check nothing: they are printed as what they are,
    and every gate is one of the protocol's own invariants):

    * ``evaluate(..., NoiseSpec("hw"), seeds=10)`` by the per-seed path
      (one perturbed copy at a time: ten instance trees would not fit),
      ``analog_hw`` on ``analog_matmul``; per seed its seconds, scored
      tokens per second, launches and peak memory;
    * the first seeds again: the same chips give equal bits (the task
      forwards' logits) and equal runs;
    * the Table-3 ``digital_int4`` deployment, no noise, on
      ``int4_matmul``;
    * a two-point gaussian gamma sweep on pinned instances, each seed's
      instance sampled and applied alone: both gamma points perturb the
      same chip (the perturbation at the second point is the first one
      scaled, leaf by leaf on the probes), and the seeds' chips differ.
    """
    from repro_torch.core.analog import AnalogConfig, pack_int4_weights
    from repro_torch.eval.harness import NoiseSpec, evaluate
    from repro_torch.serve.decode import digital_int4_config

    cfg, params, labels = full_width(torch, arch)
    sites = mvm_sites(cfg)
    tasks = eval_tasks(cfg)
    names = list(tasks)
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    out = {"arch": arch, "seeds": EVAL_SEEDS}

    log = SeedLog(torch, tasks, keep=EVAL_REPEAT)
    with log.recording():
        log.start()
        t0 = time.perf_counter()
        res = evaluate(params, labels, cfg, acfg, log.tasks,
                       NoiseSpec("hw"), seeds=EVAL_SEEDS)
        hw_s = time.perf_counter() - t0
    launches = launch_counts()
    check(launches == {"analog_matmul": sites * len(tasks) * EVAL_SEEDS},
          f"{arch} eval hw: launches {launches}")
    rows = sorted(t.shape[0] * t.shape[1] for t in log.logits[:len(tasks)])
    check(rows == sorted((M_EVAL, M_INDUCTION)),
          f"{arch} eval: forwards of {rows} rows, phase 2 holds the MVM "
          f"kernels at {M_EVAL} and {M_INDUCTION}")
    check_runs(res, names, EVAL_SEEDS, f"{arch} eval hw")
    for i, sd in enumerate(log.seeds):
        sd["scored_tokens_per_s"] = SCORED_PER_SEED / sd["s"]
        print(f"  {arch} hw seed {i}: {sd['s']:.3f} s, "
              f"{sd['scored_tokens_per_s']:.0f} scored tokens/s, launches "
              f"{sd['launches']}, peak {sd['peak_gb']:.2f} GB; "
              + ", ".join(f"{n} {res[n]['runs'][i]:.4f}" for n in names))
    out["hw"] = {"results": res, "s": hw_s, "per_seed": log.seeds,
                 "launches": launches}

    again = SeedLog(torch, tasks, keep=EVAL_REPEAT)
    with again.recording():
        again.start()
        res2 = evaluate(params, labels, cfg, acfg, again.tasks,
                        NoiseSpec("hw"), seeds=EVAL_REPEAT)
    check(len(again.logits) == len(log.logits) == EVAL_REPEAT * len(tasks)
          and all(torch.equal(a, b)
                  for a, b in zip(log.logits, again.logits)),
          f"{arch} eval hw: the same chips twice give other logits")
    check(all(res2[n]["runs"] == res[n]["runs"][:EVAL_REPEAT]
              for n in names), f"{arch} eval hw: the same chips twice "
          f"give other runs")
    del log, again

    p4 = pack_int4_weights(params, labels)
    zero_counts(torch)
    t0 = time.perf_counter()
    res4 = evaluate(p4, labels, cfg, digital_int4_config(
        AnalogConfig(weight_bits=4)), tasks)
    torch.cuda.synchronize()
    int4_s = time.perf_counter() - t0
    launches4 = launch_counts()
    check(launches4 == {"int4_matmul": sites * len(tasks)},
          f"{arch} eval digital_int4: launches {launches4}")
    check_runs(res4, names, 1, f"{arch} eval digital_int4")
    out["digital_int4"] = {"results": res4, "s": int4_s,
                           "launches": launches4}
    del p4
    torch.cuda.empty_cache()

    out["gaussian"] = eval_sweep(torch, cfg, params, labels, acfg, tasks)
    print(f"  {arch} hw over {EVAL_SEEDS} seeds in {hw_s:.2f} s: "
          + "; ".join(f"{n} {res[n]['mean']:.4f} +- {res[n]['std']:.4f}"
                      for n in names)
          + f" (random weights); the same {EVAL_REPEAT} chips twice: equal "
          f"logits bits and runs; digital_int4: "
          + "; ".join(f"{n} {res4[n]['mean']:.4f}" for n in names)
          + f" in {int4_s:.2f} s, launches {launches4}; gaussian sweep "
          + "; ".join(f"gamma {g}: " + ", ".join(
              f"{n} {r[n]['mean']:.4f}" for n in names)
              for g, r in out["gaussian"]["results"].items()))
    del params
    torch.cuda.empty_cache()
    return out


def eval_sweep(torch, cfg, params, labels, acfg, tasks) -> dict:
    """The gamma sweep of Fig. 3 on pinned instances, one seed at a time:
    seed ``s``'s instance (``deployment_instances`` at ``base_seed = 1000
    s``, the chip ``evaluate`` would draw for seed ``s``) is sampled,
    evaluated at every gamma, and dropped. Both gamma points must perturb
    the same chip: on the probe leaves the second perturbation equals
    the first one scaled by the gamma ratio, within the rounding of the
    two weight sums."""
    from repro_torch.eval.harness import (NoiseSpec, deployment_instances,
                                          evaluate)

    arch = cfg.name
    names = list(tasks)
    probes = {"down[0]": lambda t: t["blocks"]["ffn"]["down"]["kernel"][0],
              "lm_head": lambda t: t["lm_head"]["kernel"]}
    runs = {g: {n: [] for n in names} for g in SWEEP_GAMMAS}
    firsts = []
    zero_counts(torch)
    t0 = time.perf_counter()
    for s in range(SWEEP_SEEDS):
        inst = deployment_instances(params, labels, "gaussian", seeds=1,
                                    base_seed=1000 * s)
        deltas = {}
        for g in SWEEP_GAMMAS:
            seen = {}

            def first(p, cfg_, acfg_, _seen=seen):
                _seen.update({k: f(p) - f(params) for k, f in probes.items()})
                return tasks[names[0]](p, cfg_, acfg_)

            r = evaluate(params, labels, cfg, acfg,
                         {names[0]: first, **{n: tasks[n] for n in names[1:]}},
                         NoiseSpec("gaussian", g), seeds=1, instances=inst)
            for n in names:
                runs[g][n] += r[n]["runs"]
            deltas[g] = seen
        g1, g2 = SWEEP_GAMMAS
        for k, f in probes.items():
            d1, d2, w = deltas[g1][k], deltas[g2][k], f(params)
            # d = fl(fl(w + g inst) - w) is g inst within 2^-24 (|w| + 3
            # |d|) or so; the bound takes twice that
            tol = 2.0 ** -21 * (w.abs() * (1 + g2 / g1) + 3 * d2.abs())
            check(bool((d1 != 0).any()) and bool(
                ((d2 - (g2 / g1) * d1).abs() <= tol).all()),
                f"{arch} gamma sweep seed {s}: the gamma points do not "
                f"perturb the same chip ({k})")
        firsts.append(deltas[g1]["lm_head"])
        del inst, deltas
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    check(not torch.equal(firsts[0], firsts[1]),
          f"{arch} gamma sweep: seeds 0 and 1 perturb the same chip")
    launches = launch_counts()
    check(launches == {"analog_matmul": mvm_sites(cfg) * len(tasks)
                       * SWEEP_SEEDS * len(SWEEP_GAMMAS)},
          f"{arch} gamma sweep: launches {launches}")
    results = {g: {n: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                       "runs": v} for n, v in rg.items()}
               for g, rg in runs.items()}
    return {"results": results, "s": sweep_s, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def reduced_eval_check(torch, arch: str) -> dict:
    """The reduced model's eval on the card (the kernels) against the CPU
    (their plain versions), ``hw`` noise over 3 seeds: each seed's instance
    tree is sampled once on the CPU and copied, so both sides add the same
    tensors. Per task and seed the scores must be equal. Every analog site
    of every task forward is compared: a site's input may differ beyond
    ``SITE_INPUT_TOL`` (the digital ops in between) only at a (row,
    position) that an earlier site's output apart (an ADC near-tie flip)
    can reach, the same row at that position or after it; and on the
    CPU's inputs the card's site outputs may differ from the CPU's only by
    one ADC level at near-ties. Where an argmax differs, the CPU's top-2
    margin there is printed."""
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import quant
    from repro_torch.eval.harness import (NoiseSpec, deployment_instances,
                                          evaluate)
    from repro_torch.models import build

    cfg = get_config(arch).reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    insts = deployment_instances(params, labels, "hw",
                                 seeds=REDUCED_EVAL_SEEDS)
    cuda = torch.device("cuda")
    tasks = eval_tasks(cfg)
    names = list(tasks)
    acfg = A.AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    rec = {}
    res = {}
    for side, p, inst in (("cpu", params, insts),
                          ("cuda", _to(params, cuda),
                           [_to(t, cuda) for t in insts])):
        sites, logits = [], []
        with logits_recorded(torch, logits), sites_recorded(sites):
            res[side] = evaluate(p, labels, cfg, acfg, tasks,
                                 NoiseSpec("hw"), seeds=REDUCED_EVAL_SEEDS,
                                 instances=inst)
        rec[side] = (sites, [t.cpu() for t in logits])
    n_sites = mvm_sites(cfg)
    (sites_c, logits_c), (sites_g, logits_g) = rec["cpu"], rec["cuda"]
    check(len(logits_c) == len(logits_g) == REDUCED_EVAL_SEEDS * len(names)
          and len(sites_c) == len(sites_g) == n_sites * len(logits_c),
          f"reduced {arch} eval: {len(sites_c)} / {len(sites_g)} site calls")
    ctx = A.AnalogCtx()
    rows = []
    for f, (lc, lg) in enumerate(zip(logits_c, logits_g)):
        seed, name = divmod(f, len(names))
        name = names[name]
        first_apart, max_dx, dac_apart = None, 0.0, 0
        same_flips = elements = 0
        # the forward is causal and its rows independent: a site output
        # apart at (row, position) can move later sites' inputs at that
        # row's position and after it, nowhere else
        reach = torch.zeros(lc.shape[:2], dtype=torch.bool)
        for i in range(n_sites):
            pc, xc, yc = sites_c[f * n_sites + i]
            pg, xg, yg = sites_g[f * n_sites + i]
            xg, yg = xg.cpu(), yg.cpu()
            dx = (xg - xc).abs()
            apart = (dx > SITE_INPUT_TOL * (1 + xc.abs())).reshape(
                reach.shape + (-1,)).any(-1)
            if bool(apart.any()):
                beta = pc["input_range"].reshape(()).float()
                dac = int((quant.input_quantize(xg, beta, acfg.input_bits)
                           != quant.input_quantize(xc, beta,
                                                   acfg.input_bits)).sum())
                if first_apart is None:
                    first_apart, max_dx, dac_apart = i, float(dx.max()), dac
                check(bool(reach[apart].all()),
                      f"reduced {arch} eval, seed {seed}, {name}: site {i}'s "
                      f"input differs where no site output did before (max "
                      f"|dx| {float(dx.max()):.3e}, {dac} DAC codes apart)")
            with torch.no_grad():
                y_same = A.analog_linear(pg, xc.to(cuda), acfg, ctx)[0].cpu()
            same_flips += adc_mismatches(
                torch, pc, xc, y_same, yc, acfg,
                f"reduced {arch} eval, site {i}: a card/cpu")
            elements += yc.numel()
            out_apart = ((yg - yc).abs() > 1e-5 * (1 + yc.abs())).reshape(
                reach.shape + (-1,)).any(-1)
            reach |= torch.cummax(out_apart.int(), dim=1).values.bool()
        sl = SCORED[name]
        a_c, a_g = lc[:, sl].argmax(-1), lg[:, sl].argmax(-1)
        moved = a_c != a_g
        top2 = torch.topk(lc[:, sl], 2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1])[moved]
        run_c = res["cpu"][name]["runs"][seed]
        run_g = res["cuda"][name]["runs"][seed]
        row = {"seed": seed, "task": name, "score_cpu": run_c,
               "score_card": run_g, "argmax_apart": int(moved.sum()),
               "scored": moved.numel(),
               "cpu_top2_margins": [float(m) for m in margins],
               "max_dlogit": float((lc - lg).abs().max()),
               "same_input_flips": same_flips, "site_outputs": elements,
               "first_input_apart": first_apart, "max_dx": max_dx,
               "dac_codes_apart": dac_apart}
        rows.append(row)
        print(f"  reduced {arch}, hw chip {seed}, {name}: score cpu "
              f"{run_c:.4f} / card {run_g:.4f}; argmax apart at "
              f"{row['argmax_apart']} of {row['scored']} scored positions"
              + (f" (CPU top-2 margins there "
                 + ", ".join(f"{m:.2e}" for m in row["cpu_top2_margins"])
                 + ")" if row["argmax_apart"] else "")
              + f", max |dlogit| {row['max_dlogit']:.2e}; on the CPU's "
              f"inputs {same_flips} of {elements} site outputs one ADC "
              f"level apart at near-ties; "
              + ("no site input apart" if first_apart is None else
                 f"first site input apart: {first_apart}, only where an "
                 f"earlier site output apart reaches (max |dx| "
                 f"{max_dx:.2e}, {dac_apart} DAC codes apart)"))
        check(run_c == run_g, f"reduced {arch} eval, seed {seed}, {name}: "
              f"score {run_g} on the card, {run_c} on the cpu")
    return {"rows": rows, "cpu": res["cpu"], "cuda": res["cuda"]}


# ---------------------------------------------------------------------------
# phase 13: best-of-n test-time scaling (paper §4.4) at full width
# ---------------------------------------------------------------------------

def phase_best_of_n(torch, arch: str) -> dict:
    """``sample_candidates`` on the continuous engine's paged pool (8
    slots; the pool dtype is the engine's default, fp32, as in the JAX
    package's harness), ``arch`` at full width under ``analog_hw`` on the
    kernels: 8 ``mod_add`` prompts x 8 candidates of up to 4 tokens (SEP
    stops one), fork-aware on the prefix cache (the default), then
    ``best_of_n_accuracy`` at n = 1, 4, 8 with the noisy-oracle PRM. Every
    candidate must finish and no block stay live; every projection and
    attention call must run on its kernel. Then the same candidates with
    ``prefix_cache=False`` and the same generator seed: equal answers."""
    from repro_torch.core.analog import AnalogConfig, perturb_analog_weights
    from repro_torch.eval.tasks import make_mod_add_data, mod_add_extraction
    from repro_torch.serve import engine as E
    from repro_torch.serve.prm import NoisyOraclePRM

    cfg, params, labels = full_width(torch, arch)
    dev = torch.device("cuda")
    p = perturb_analog_weights(params, labels, torch.Generator(
        device=dev).manual_seed(1), "hw")
    del params
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    prompts, correct = make_mod_add_data(cfg.vocab_size, num=BON_PROMPTS,
                                         mod=BON_MOD)
    bcfg = E.BestOfNConfig(temperature=0.8, top_k=50, max_new=BON_MAX_NEW,
                           stop_tokens=(BON_MOD,), num_slots=ENGINE_SLOTS,
                           kv_block_size=PAGED_BS)
    engines = []
    real = E.ServeEngine

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    def candidates(b):
        E.ServeEngine = Recorded
        try:
            zero_counts(torch)
            t0 = time.perf_counter()
            answers = E.sample_candidates(
                p, cfg, acfg, torch.Generator(device=dev).manual_seed(3),
                prompts, BON_N, b, extract=mod_add_extraction(BON_MOD))
            torch.cuda.synchronize()
            return answers, time.perf_counter() - t0
        finally:
            E.ServeEngine = real

    answers, run_s = candidates(bcfg)
    launches = launch_counts()
    check(len(engines) == 1, f"best-of-n {arch}: {len(engines)} engines")
    eng = engines[0]
    check(eng.prefix_enabled and eng.prefix_lookups == BON_PROMPTS * BON_N,
          f"best-of-n {arch}: not fork-aware on the prefix cache")
    rows = (eng.scfg.num_slots, eng.prefill_batch * eng.scfg.prefill_chunk)
    check(rows == (M_BON_DECODE, M_BON_CHUNK),
          f"best-of-n {arch}: forwards of {rows} rows, phase 2 holds the MVM "
          f"kernels at {(M_BON_DECODE, M_BON_CHUNK)}")
    num = BON_PROMPTS * BON_N
    tokens = sum(len(v) for v in eng.results.values())
    check(sorted(eng.results) == list(range(num))
          and all(eng.status[u] == "finished" for u in range(num)),
          f"best-of-n {arch}: not every candidate finished")
    check(eng.pool is not None and eng.pool.num_live == 0
          and eng.pool.num_free + eng.pool.num_cached == eng.pool.num_blocks,
          f"best-of-n {arch}: blocks not returned")
    check(answers.shape == (BON_PROMPTS, BON_N) and answers.min() >= 0
          and answers.max() < cfg.vocab_size,
          f"best-of-n {arch}: answers {answers}")
    layers = cfg.num_layers
    want = {"analog_matmul": mvm_sites(cfg) * (eng.decode_steps
                                              + eng.prefill_forwards),
            "paged_flash_decode": layers * eng.decode_steps,
            "paged_flash_prefill": layers * eng.prefill_forwards}
    check(launches == want, f"best-of-n {arch}: launches {launches}, "
          f"expected {want}")
    acc = E.best_of_n_accuracy(answers, correct, NoisyOraclePRM(0.75, seed=0),
                               list(BON_NS))
    indep, indep_s = candidates(dataclasses.replace(bcfg,
                                                    prefix_cache=False))
    check(np.array_equal(answers, indep), f"best-of-n {arch}: fork-aware "
          f"answers {answers.tolist()} against independent "
          f"{indep.tolist()}")
    res = {"arch": arch, "candidates": num, "tokens": tokens, "run_s": run_s,
           "candidates_per_s": num / run_s, "tokens_per_s": tokens / run_s,
           "independent_s": indep_s,
           "independent_candidates_per_s": num / indep_s,
           "independent_prefill_forwards": engines[-1].prefill_forwards,
           "decode_steps": eng.decode_steps,
           "prefill_forwards": eng.prefill_forwards,
           "prefix_hits": eng.prefix_hits,
           "prefix_skipped_tokens": eng.prefix_skipped_tokens,
           "prefix_cow_copies": eng.prefix_cow_copies, "launches": launches,
           "accuracy": acc, "answers": answers.tolist()}
    print(f"  {arch} best-of-{BON_N}: {num} candidates ({tokens} tokens) of "
          f"{BON_PROMPTS} mod_add prompts in {run_s:.2f} s fork-aware "
          f"({res['candidates_per_s']:.1f} candidates/s, "
          f"{res['tokens_per_s']:.1f} tokens/s; independent "
          f"{res['independent_candidates_per_s']:.1f} candidates/s, equal "
          f"answers), {eng.decode_steps} decode forwards, "
          f"{eng.prefill_forwards} chunk forwards (independent "
          f"{res['independent_prefill_forwards']}), prefix hits "
          f"{eng.prefix_hits}, {eng.prefix_skipped_tokens} tokens skipped, "
          f"{eng.prefix_cow_copies} tail copies, launches "
          f"{launches}; accuracy (random weights) "
          + "; ".join(f"{s}: " + ", ".join(
              f"n={n} {v['mean']:.3f}" for n, v in by_n.items())
              for s, by_n in acc.items()))
    del eng, engines, p
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 14: HWA distillation (paper Fig. 2b) at full width
# ---------------------------------------------------------------------------

def train_configs():
    """The phase's AnalogConfig and TrainConfig (remat on)."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.train.train_step import TrainConfig

    return (AnalogConfig(mode="analog", use_pallas=True, out_bound=14.0,
                         kappa_init=18.0, gamma_weight=TRAIN_GAMMA),
            TrainConfig(kd_temperature=2.0, total_steps=100))


def within_dot_error(torch, a, ref, scale, k: int) -> float:
    """max |a - ref| over the fp32 dot error scale ``sqrt(k) * 2^-24 *
    scale`` (``scale`` = |A|·|B| of the product, ``k`` its length; the
    probabilistic bound on the rounding of a k-term fp32 dot); fails above
    ``DOT_ERR_LAMBDA``."""
    r = float(((a - ref).abs() / (k ** 0.5 * U32 * scale)).max())
    check(r <= DOT_ERR_LAMBDA, f"{r:.3e} of the fp32 dot error bound")
    return r


def training_site_gradients(torch) -> list:
    """Gate (i): at each llama site shape at M = M_TRAIN, the fused
    Function on ``w + w_noise`` against the noise-free bound, on the card.
    Its forward is held against the kernel's plain version (the ADC
    contract; this is the Function's own launch, where phase 2 calls the
    kernel's wrapper). Its dx, dw and dbeta are held against the unfused
    chain's gradient rules written out here in float64 (the reference's
    ``_fused_bwd``: dx = g wᵀ where ``|x| <= beta`` and 0 outside, dw =
    x_qᵀ g, dbeta = sum(where(inside, (x_q - x) / beta, sign(x)) · g wᵀ)),
    with x_q the DAC codes of the kernel's plain version."""
    from repro_torch.core.noise import gaussian_weight_noise
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for site, k, n, _ in SITES:
        x = torch.randn((M_TRAIN, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        beta = torch.tensor(3.0, device=dev)
        noise = gaussian_weight_noise(gen, w, TRAIN_GAMMA)
        bound = ref.adc_bound(w, beta, 14.0)
        g = torch.randn((M_TRAIN, n), generator=gen, device=dev)
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, beta))
        y = dispatch.fused_analog_mvm(xl, wl, noise, bl, bound)
        flips, err = analog_flips(torch, x, w + noise, beta.reshape(1),
                                  bound, None, y.detach())
        y.backward(g)
        dx, dw, db = xl.grad, wl.grad, bl.grad
        del y, xl, wl, bl, noise
        inside = x.abs() <= beta
        x_q = ref.div(beta, 127.0) * torch.round(
            ref.clip(x, -beta, beta) * ref.rdiv(127.0, beta))
        x64, xq64, b64 = x.double(), x_q.double(), beta.double()
        gw = g.double() @ w.double().T
        dx_r = torch.where(inside, gw, torch.zeros_like(gw))
        dw_r = xq64.T @ g.double()
        terms = torch.where(inside, (xq64 - x64) / b64, torch.sign(x64)) * gw
        db_r, terms = terms.sum(), terms.abs().sum()
        check(not bool(dx[~inside].any()),
              f"train {site}: dx is not 0 outside the clamp")
        r_dx = within_dot_error(torch, dx.double(), dx_r,
                                g.abs() @ w.abs().T, n)
        r_dw = within_dot_error(torch, dw.double(), dw_r,
                                x_q.abs().T @ g.abs(), M_TRAIN)
        d_db = float((db.double() - db_r).abs())
        check(d_db <= DBETA_TOL * (1 + float(terms)),
              f"train {site}: dbeta {float(db):.6e} against {float(db_r):.6e}")
        outputs = M_TRAIN * n
        check(flips <= MAX_FLIP_RATE * outputs,
              f"train {site}: {flips} of {outputs} outputs flip")
        rows.append({"site": site, "K": k, "N": n, "flips": flips,
                     "outputs": outputs, "max_abs_err": err,
                     "dx_rel": r_dx, "dw_rel": r_dw, "dbeta_abs": d_db,
                     "dbeta": float(db_r), "dbeta_terms": float(terms)})
        print(f"  gate (i) {site:8s} M={M_TRAIN} {k}->{n}: forward flips "
              f"{flips} of {outputs}; against float64: dx {r_dx:.2e}, dw "
              f"{r_dw:.2e} of the fp32 dot bound; dbeta {float(db):.6e} vs "
              f"{float(db_r):.6e} (|d| {d_db:.2e}, sum of |terms| "
              f"{float(terms):.3e})")
        del x, w, g, gw, dx, dw, dx_r, dw_r, x64, xq64, x_q, inside, terms
        torch.cuda.empty_cache()
    return rows


def site_modules():
    """The model modules whose analog sites a spy replaces: layers,
    mamba2, moe and transformer each bind ``analog_linear``."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    return (L, M, MoE, T)


@contextlib.contextmanager
def sites_replaced(spy):
    """Inside the block every analog site of the models calls ``spy``."""
    from repro_torch.core import analog as A

    mods = site_modules()
    for mod in mods:
        mod.analog_linear = spy
    try:
        yield A.analog_linear
    finally:
        for mod in mods:
            mod.analog_linear = A.analog_linear


def site_input_stats(torch, p, x, rows: int):
    """(x_std, clip_frac) of a site's forward input as its statistics take
    them: over the whole input, or for a batched (expert) site per
    (expert, sequence) over that sequence's C capacity slots, then the mean
    over the experts and over the ``rows`` sequences (the reference's
    vmaps; ``models/moe.py``)."""
    beta = p["input_range"].reshape(()).float()
    xf = x.float()
    if p["kernel"].dim() == 3:
        xr = xf.reshape(p["kernel"].shape[0], rows, -1, xf.shape[-1])
        std = torch.mean(torch.mean(
            torch.std(xr, dim=(2, 3), correction=0), dim=0))
        frac = torch.mean(torch.mean(torch.mean(
            (xr.abs() > beta).float(), dim=(2, 3)), dim=0))
        return std, frac
    return (torch.std(xf, correction=0),
            torch.mean((xf.abs() > beta).float()))


@contextlib.contextmanager
def training_checked(torch, acfg, log: dict):
    """Gate (ii) on every step of the training run inside the block: after
    the update every ``input_range`` equals ``ema_init_update`` (then the
    decay rule) of the post-AdamW range with the ``x_std`` of that site's
    forward input, recorded at the site (expert sites: per expert and
    sequence, then averaged; equal bit for bit when remat recomputes the
    site), and every analog weight lies within ``alpha_clip`` standard
    deviations of its channel (an expert's channels over its own K). Also
    each step's kernel launches (``log["step_launches"]``) and, where the
    model routes, each router gradient, which must be finite and nonzero
    (``log["router_grad"]``: its largest magnitude)."""
    from repro_torch.checkpoint import flatten_paths
    from repro_torch.core import clipping
    from repro_torch.core.quant import ema_init_update, range_decay_update
    from repro_torch.train import recipes
    from repro_torch.train import train_step as ts

    cur = {}
    site_std = {}
    real_ranges = ts._update_input_ranges
    real_clip, real_make = clipping.clip_tree, recipes.make_train_step
    real_adam = ts.apply_gradients

    def site(p, x, cfg, ctx):
        if ctx.training:
            with torch.no_grad():
                std, frac = site_input_stats(torch, p, x, TRAIN_BATCH)
            ptr = p["input_range"].data_ptr()
            if ptr in site_std:   # the layer's recomputation under remat
                check(bool(torch.equal(site_std[ptr][0], std)),
                      "a recomputed site's input differs from its forward's")
                log["recomputed_sites"] += 1
            else:
                site_std[ptr] = (std, frac)
        return real_site(p, x, cfg, ctx)

    def ranges(params, stats, step, acfg_):
        out = real_ranges(params, stats, step, acfg_)
        old = flatten_paths(cur["params"])
        new_in, new_out = flatten_paths(params), flatten_paths(out)
        n = 0
        for path, v in new_out.items():
            if not path.endswith("input_range"):
                continue
            node = stats
            for part in path.split("/")[:-1]:
                node = node[part]
            stacked = old[path].dim() == 2          # [L, 1] or (1,)
            for i in range(old[path].shape[0] if stacked else 1):
                ptr = (old[path][i] if stacked else old[path]).data_ptr()
                check(ptr in site_std, f"{path}[{i}]: no forward recorded")
                std, frac = site_std[ptr]
                x_std = node["x_std"][i] if stacked else node["x_std"]
                check(bool(torch.equal(x_std, std)),
                      f"{path}[{i}]: x_std is not its site's")
                beta = new_in[path][i] if stacked else new_in[path]
                want = ema_init_update(beta.squeeze(-1), std, step,
                                       acfg.kappa_init, acfg.init_steps)
                want = range_decay_update(want, frac, step, acfg.range_decay,
                                          acfg.input_min_percentage,
                                          acfg.init_steps)
                got = v[i] if stacked else v
                check(bool(torch.equal(got.squeeze(-1),
                                       torch.clamp_min(want, 1e-6))),
                      f"{path}[{i}]: the range rule was not applied")
                n += 1
        log["ranges_checked"].append(n)
        return out

    def clip(params, labels, alpha):
        out = real_clip(params, labels, alpha)
        lab, flat_out = flatten_paths(labels), flatten_paths(out)
        worst, clipped, total = 0.0, 0, 0
        for path, w in flatten_paths(params).items():
            if lab[path] != "analog_weight":
                continue
            wo = flat_out[path]
            # zeta as clip_weight takes it (the std over axis -2 of the
            # whole leaf), compared matrix by matrix: no model-sized
            # temporaries
            zeta = (alpha * torch.std(w.float(), dim=-2, keepdim=True,
                                      correction=0)).to(w.dtype)
            shape = (-1,) + tuple(w.shape[-2:])
            for wl, wol, zl in zip(w.reshape(shape), wo.reshape(shape),
                                   zeta.reshape((-1, 1, w.shape[-1]))):
                worst = max(worst, float((wol.abs() / zl).max()))
                clipped += int((wl.abs() > zl).sum())
            total += w.numel()
        check(worst <= 1.0, f"a weight lies {worst:.6f} zeta out (eq. 4)")
        log["clip"].append({"max_over_zeta": worst,
                            "clipped_share": clipped / total})
        return out

    def adam(params, grads, *a, **k):
        worst = None
        for path, g in flatten_paths(grads).items():
            if "router" in path:
                m = float(g.abs().max())
                check(math.isfinite(m) and m > 0,
                      f"{path}: the router's gradient is {m}")
                worst = m if worst is None else min(worst, m)
        if worst is not None:
            log["router_grad"].append(worst)
        return real_adam(params, grads, *a, **k)

    def make(*a, **k):
        step_fn = real_make(*a, **k)

        def wrapped(params, state, batch, key, teacher_params=None):
            cur["params"] = params
            site_std.clear()
            before = launch_counts()
            out = step_fn(params, state, batch, key, teacher_params)
            after = launch_counts()
            log["step_launches"].append(
                {n: after[n] - before.get(n, 0) for n in after
                 if after[n] != before.get(n, 0)})
            return out
        return wrapped

    log.update(recomputed_sites=0, ranges_checked=[], clip=[],
               step_launches=[], router_grad=[])
    ts._update_input_ranges = ranges
    ts.apply_gradients = adam
    clipping.clip_tree = clip
    recipes.make_train_step = make
    try:
        with sites_replaced(site) as real_site:
            yield
    finally:
        ts._update_input_ranges = real_ranges
        ts.apply_gradients = real_adam
        clipping.clip_tree = real_clip
        recipes.make_train_step = real_make


def train_lr(tcfg):
    """The recipes' learning-rate schedule for ``tcfg``."""
    from repro_torch.optim.schedule import polynomial_with_warmup

    return lambda s: polynomial_with_warmup(
        s, peak_lr=tcfg.peak_lr, total_steps=tcfg.total_steps,
        warmup_ratio=tcfg.warmup_ratio)


def train_step_profile(torch, cfg, acfg, tcfg, labels, params, state,
                       batch) -> dict:
    """One more step from ``params`` / ``state``, built with marks between
    its stages (forward and loss, backward, AdamW, range rules and eq. 4),
    under ``torch.profiler``: device ms per stage (CUDA events), the peak
    allocated GB of each stage, and the device ms of the ``analog_matmul``
    kernels (the training forward and its recomputation), of the
    ``ssd_scan`` kernels (the same), of the cuBLAS matmuls (the backward's
    dx / dw, the attention products, the teacher, the SSD's plain-version
    backward) and of the rest, with its largest kernels."""
    from repro_torch.core import clipping
    from repro_torch.train import train_step as ts

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, torch.cuda.max_memory_allocated()))

    real_loss, real_adam = ts.make_loss_fn, ts.apply_gradients
    real_clip = clipping.clip_tree

    def make_loss(*a, **k):
        fn = real_loss(*a, **k)

        def loss(*aa, **kk):
            out = fn(*aa, **kk)
            mark("forward and loss")
            return out
        return loss

    def adam(*a, **k):
        mark("backward")
        out = real_adam(*a, **k)
        mark("AdamW")
        return out

    def clip(*a, **k):
        out = real_clip(*a, **k)
        mark("range rules and eq. 4")
        return out

    ts.make_loss_fn, ts.apply_gradients = make_loss, adam
    clipping.clip_tree = clip
    try:
        step = ts.make_train_step(cfg, acfg, tcfg, labels, train_lr(tcfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mark("start")
            out = step(params, state, batch, noise_key())
            del out
            torch.cuda.synchronize()
    finally:
        ts.make_loss_fn, ts.apply_gradients = real_loss, real_adam
        clipping.clip_tree = real_clip
    stages = {name: {"ms": a.elapsed_time(b), "peak_gb": peak / 1e9}
              for (_, a, _), (name, b, peak) in zip(marks, marks[1:])}
    res = {"analog_matmul_ms": 0.0, "ssd_scan_ms": 0.0, "matmul_ms": 0.0,
           "other_ms": 0.0}
    other = []
    for ev in prof.key_averages():
        ms = ev.device_time * ev.count / 1e3
        if ms <= 0:
            continue
        key = ev.key.lower()
        if "analog_" in key:
            res["analog_matmul_ms"] += ms
        elif "ssd_" in key:
            res["ssd_scan_ms"] += ms
        elif "gemm" in key or "sm90_xmma" in key or "cutlass" in key:
            res["matmul_ms"] += ms
        else:
            res["other_ms"] += ms
            other.append((ev.key.replace("void at::native::", "")[:90], ms))
    res["device_ms"] = sum(res.values())
    res["top_other"] = sorted(other, key=lambda t: -t[1])[:5]
    res["stages"] = stages
    return res


def noise_key():
    """The noise key of the phase's trainers (``Trainer(seed=0)``)."""
    from repro_torch.core.noise import prng_key

    return prng_key(0)


def train_model(torch, arch: str):
    """``arch`` for HWA training on the card, random weights from seed 0:
    mamba2-130m at full width and depth, llama-3.2-1b at full width and
    TRAIN_LAYERS of its 16 layers, qwen3-moe at full width and
    MOE_TRAIN_LAYERS of its 48 layers. ``(cfg, params, labels)``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(arch)
    layers = {ARCH: TRAIN_LAYERS, MOE: MOE_TRAIN_LAYERS,
              INTERNVL: INTERNVL_LAYERS, MUSICGEN: MUSICGEN_LAYERS}
    if arch in layers:
        cfg = dataclasses.replace(cfg, num_layers=layers[arch])
    dev = torch.device("cuda")
    cfg, params, labels = build(cfg, torch.Generator(
        device=dev).manual_seed(0), device=dev)
    want = {ARCH: (TRAIN_LAYERS, 2048), MAMBA: (24, 768),
            MOE: (MOE_TRAIN_LAYERS, 2048), INTERNVL: (INTERNVL_LAYERS, 2048),
            MUSICGEN: (MUSICGEN_LAYERS, 1536)}[arch]
    check((cfg.num_layers, cfg.d_model) == want, f"unexpected config {cfg}")
    return cfg, params, labels


def projector(cfg) -> int:
    """The vlm's projector site: one launch of a forward with patch
    embeddings (a training batch always has them)."""
    return 1 if cfg.family == "vlm" else 0


def train_step_launches(cfg) -> dict:
    """Kernel launches of one training step with remat: every analog site
    of the forward, and again every site of the stack in its
    recomputation (the untied LM head and the vlm's projector run once);
    each mixer's
    ``ssd_scan`` in the forward and its recomputation (the backward
    differentiates the plain version and launches nothing)."""
    head = 0 if cfg.tie_embeddings else 1
    out = {"analog_matmul": 2 * mvm_sites(cfg) - head + projector(cfg)}
    if mixer_layers(cfg):
        out["ssd_scan"] = 2 * mixer_layers(cfg)
    return out


def train_run(torch, arch: str) -> dict:
    """``distill_recipe`` at full width on the card (``train_model``,
    student a copy of the teacher, tokens from the Markov corpus) on the
    kernels, with gates (ii)–(iv): eq. 4 and the range rules after every
    step, each step's launches, a bit-exact resume, finite losses (and,
    where the model routes, its aux loss and the router's gradient). Then
    one more step under the profiler."""
    import shutil

    import repro_torch.train.recipes as recipes
    from repro_torch.checkpoint import flatten_paths
    from repro_torch.data.corpus import MarkovCorpus
    from repro_torch.data.loader import TokenLoader
    from repro_torch.data.synthetic import teacher_logits
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    acfg, tcfg = train_configs()
    cfg, params, labels = train_model(torch, arch)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = MarkovCorpus(cfg.vocab_size, seed=0).sample(
        TRAIN_BATCH * (TRAIN_STEPS + 1), TRAIN_SEQ + 1)
    log, rows_seen = {}, set()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch)
    with training_checked(torch, acfg, log), expert_rows(rows_seen):
        _, trainer = recipes.distill_recipe(
            params, labels, cfg, tokens, acfg=acfg, tcfg=tcfg,
            batch_size=TRAIN_BATCH, num_steps=TRAIN_STEPS, seed=0)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(rows_seen == ({MOE_TRAIN_ROWS} if moe_layers(cfg) else set()),
          f"train {arch}: expert launches of {sorted(rows_seen)} rows, "
          f"phase 2 holds the kernel at {MOE_TRAIN_ROWS}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    check(len(hist) == TRAIN_STEPS and trainer.skipped_steps == 0
          and all(math.isfinite(h["loss"]) for h in hist),
          f"train {arch}: losses {[h['loss'] for h in hist]}")   # gate (iv)
    check(log["ranges_checked"] == [mvm_sites(cfg)] * TRAIN_STEPS
          and len(log["clip"]) == TRAIN_STEPS,
          f"train {arch}: ranges checked {log['ranges_checked']}")
    per_step = train_step_launches(cfg)
    check(log["step_launches"] == [per_step] * TRAIN_STEPS,
          f"train {arch}: launches per step {log['step_launches']}, "
          f"expected {per_step}")
    # the teacher's logits of each batch: a digital forward, its mixers'
    # scans on the kernel
    teacher = {"ssd_scan": mixer_layers(cfg)} if mixer_layers(cfg) else {}
    check(launches == {k: TRAIN_STEPS * (per_step.get(k, 0)
                                         + teacher.get(k, 0))
                       for k in per_step},
          f"train {arch}: launches {launches}")
    routed = moe_layers(cfg) > 0
    if routed:
        check(all(math.isfinite(h["aux"]) and h["aux"] > 0 for h in hist)
              and len(log["router_grad"]) == TRAIN_STEPS,
              f"train {arch}: aux {[h['aux'] for h in hist]}, router "
              f"gradients {log['router_grad']}")
    for i, h in enumerate(hist):
        print(f"  train {arch} step {i}{' (warm-up)' if i == 0 else ''}, "
              f"gates (ii) checked in it: {1e3 * h['dt']:.1f} ms, loss "
              f"{h['loss']:.6f} (kd {h['kd']:.6f}"
              + (f", aux {h['aux']:.6f}, router grad max "
                 f"{log['router_grad'][i]:.3e}" if routed else "")
              + f"), grad norm {h['grad_norm']:.4f}, lr {h['lr']:.2e}; "
              f"weights clipped {log['clip'][i]['clipped_share']:.2e}")
    print(f"  train {arch} ({n_params / 1e9:.3f}B params), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: peak {peak_gb:.2f} GB, launches "
          f"{launches} ({per_step} per step, teacher {teacher} per batch; "
          f"remat recomputed {log['recomputed_sites']} site calls)")

    # one more step of the same trainer under the profiler
    loader = TokenLoader(tokens, TRAIN_BATCH, seed=0)
    dev = torch.device("cuda")

    def make_batch(raw):
        inp = torch.as_tensor(raw[:, :-1], dtype=torch.int64, device=dev)
        return {"tokens": inp,
                "labels": torch.as_tensor(raw[:, 1:], dtype=torch.int64,
                                          device=dev),
                "teacher_logits": teacher_logits(params, cfg, inp)}

    prof = train_step_profile(torch, cfg, acfg, tcfg, labels, trainer.params,
                              trainer.state, make_batch(next(iter(loader))))

    # gate (iii): save at TRAIN_RESUME_AT, restore in a fresh trainer, step
    # on; the uninterrupted run's leaves are kept on the card (a copy on
    # the host took longer than the checkpoint's write and read together)
    whole = {k: v.clone() for k, v in flatten_paths(
        {"params": trainer.params, "opt": trainer.state["opt"]}).items()}
    del trainer
    torch.cuda.empty_cache()
    step_fn = ts.make_train_step(cfg, acfg, tcfg, labels, train_lr(tcfg))
    ckpt_dir = ROOT / "scratch_chip" / f"train_ckpt_{arch}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        loader = TokenLoader(tokens, TRAIN_BATCH, seed=0)
        first = Trainer(step_fn, params, ts.init_train_state(params),
                        ckpt_dir=str(ckpt_dir), ckpt_every=0, log_every=0,
                        data_state_fn=loader.state, seed=0)
        first.fit((make_batch(r) for r in loader), TRAIN_RESUME_AT)
        first.params = first.state = None
        torch.cuda.empty_cache()
        t_save = time.perf_counter()
        loader = TokenLoader(tokens, TRAIN_BATCH, seed=0)
        second = Trainer(step_fn, params, ts.init_train_state(params),
                         ckpt_dir=str(ckpt_dir), ckpt_every=0, log_every=0,
                         data_state_fn=loader.state, seed=0)
        extra = second.try_resume()
        t_restore = time.perf_counter()
        loader.restore(extra["data_state"])
        second.ckpt_dir = None
        second.fit((make_batch(r) for r in loader),
                   TRAIN_STEPS - TRAIN_RESUME_AT)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the step time on the host clock (synchronized by the loss read) from
    # the resume check's steps, which run no gate (ii) checks; all warm
    dts = [h["dt"] for h in first.history + second.history]
    step_ms = 1e3 * sum(dts) / len(dts)
    print(f"  train {arch}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"{step_ms:.1f} ms per step (mean of {len(dts)}: "
          + ", ".join(f"{1e3 * d:.1f}" for d in dts)
          + f"), {M_TRAIN / step_ms * 1e3:.0f} training tokens/s")
    print(f"  train {arch} step on the device (torch.profiler): "
          f"analog_matmul {prof['analog_matmul_ms']:.2f} ms (forward + "
          f"remat), ssd_scan {prof['ssd_scan_ms']:.2f} ms (the same), cuBLAS "
          f"matmuls {prof['matmul_ms']:.2f} ms (the plain-torch backward's "
          f"dx / dw and SSD products, attention, teacher), other "
          f"{prof['other_ms']:.2f} ms; {prof['device_ms']:.2f} ms of the "
          f"{step_ms:.1f} ms step; largest other: " + ", ".join(
              f"{name} {ms:.2f}" for name, ms in prof["top_other"]))
    print(f"  train {arch} step by stage (CUDA events; peak allocated): "
          + ", ".join(f"{name} {st['ms']:.1f} ms ({st['peak_gb']:.2f} GB)"
                      for name, st in prof["stages"].items()))
    resumed = flatten_paths({"params": second.params,
                             "opt": second.state["opt"]})
    apart = [k for k, v in resumed.items() if not torch.equal(v, whole[k])]
    check(not apart, f"train {arch} resume: {len(apart)} leaves differ, "
          f"e.g. {apart[:3]}")                                 # gate (iii)
    print(f"  gate (iii) {arch}: saved at step {TRAIN_RESUME_AT}, restored "
          f"in a fresh Trainer and stepped to {TRAIN_STEPS}: "
          f"{len(resumed)} leaves (params, m, v, count) equal the "
          f"uninterrupted run's bit for bit (save {t_save - t0:.1f} s incl. "
          f"{TRAIN_RESUME_AT} steps, restore {t_restore - t_save:.1f} s)")
    del first, second, whole, resumed, params
    torch.cuda.empty_cache()
    return {"params": n_params, "steps": hist, "step_ms": step_ms,
            "tokens_per_s": M_TRAIN / step_ms * 1e3, "peak_gb": peak_gb,
            "launches": launches, "launches_per_step": per_step,
            "profile": prof, "clip": log["clip"],
            "router_grad": log["router_grad"],
            "recomputed_sites": log["recomputed_sites"],
            "resume": {"save_s": t_save - t0,
                       "restore_s": t_restore - t_save}}


def phase_train(torch) -> dict:
    """HWA distillation of llama-3.2-1b at full width on ``analog_matmul``
    (``train_run``), with gates (i)–(v): the training sites' gradients,
    eq. 4 and the range rules after every step, a bit-exact resume,
    finite losses, and the reduced model on the card against the CPU."""
    out = {"gate_i": training_site_gradients(torch)}
    out.update(train_run(torch, ARCH))
    out["reduced"] = reduced_train_check(torch, ARCH)
    return out


# ---------------------------------------------------------------------------
# phase 18: HWA distillation of the ssm and moe families at full width
# ---------------------------------------------------------------------------

def expert_site_gradients(torch) -> list:
    """Gate (i) of phase 18 at qwen3-moe's batched expert sites (all 128
    experts, MOE_TRAIN_ROWS rows each): the fused Function on ``w +
    w_noise`` (each expert's own noise scale) against the noise-free [E,
    N] bound, on the card. Its forward is held expert by expert against
    the kernel's plain version (the ADC contract); its dx, each expert's
    dw and the shared dbeta against the unfused chain's rules written out
    in float64 per expert (dx[e] = g[e] w[e]ᵀ inside the clamp and 0
    outside, dw[e] = x_q[e]ᵀ g[e], dbeta = the LSQ sum over every expert
    and row)."""
    from repro_torch.core.noise import gaussian_weight_noise
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    e, m = MOE_EXPERTS, MOE_TRAIN_ROWS
    rows = []
    for site, k, n, _ in MOE_SITES:
        x = torch.randn((e, m, k), generator=gen, device=dev)
        w = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
        beta = torch.tensor(3.0, device=dev)
        noise = gaussian_weight_noise(gen, w, TRAIN_GAMMA, axis=-2)
        bound = ref.adc_bound(w, beta, 14.0)                    # [E, N]
        g = torch.randn((e, m, n), generator=gen, device=dev)
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, beta))
        y = dispatch.fused_analog_mvm(xl, wl, noise, bl, bound)
        flips, err = 0, 0.0
        for i in range(e):
            f, d = analog_flips(torch, x[i], w[i] + noise[i],
                                beta.reshape(1), bound[i], None,
                                y[i].detach())
            flips, err = flips + f, max(err, d)
        y.backward(g)
        dx, dw, db = xl.grad, wl.grad, bl.grad
        del y, xl, wl, bl, noise
        inside = x.abs() <= beta
        x_q = ref.div(beta, 127.0) * torch.round(
            ref.clip(x, -beta, beta) * ref.rdiv(127.0, beta))
        x64, xq64, b64 = x.double(), x_q.double(), beta.double()
        gw = g.double() @ w.double().transpose(-1, -2)
        dx_r = torch.where(inside, gw, torch.zeros_like(gw))
        dw_r = xq64.transpose(-1, -2) @ g.double()
        terms = torch.where(inside, (xq64 - x64) / b64, torch.sign(x64)) * gw
        db_r, terms = terms.sum(), terms.abs().sum()
        check(not bool(dx[~inside].any()),
              f"train expert {site}: dx is not 0 outside the clamp")
        r_dx = within_dot_error(torch, dx.double(), dx_r,
                                g.abs() @ w.abs().transpose(-1, -2), n)
        r_dw = within_dot_error(torch, dw.double(), dw_r,
                                x_q.abs().transpose(-1, -2) @ g.abs(), m)
        d_db = float((db.double() - db_r).abs())
        check(d_db <= DBETA_TOL * (1 + float(terms)),
              f"train expert {site}: dbeta {float(db):.6e} against "
              f"{float(db_r):.6e}")
        outputs = e * m * n
        check(flips <= MAX_FLIP_RATE * outputs,
              f"train expert {site}: {flips} of {outputs} outputs flip")
        rows.append({"site": site, "E": e, "M": m, "K": k, "N": n,
                     "flips": flips, "outputs": outputs,
                     "max_abs_err": err, "dx_rel": r_dx, "dw_rel": r_dw,
                     "dbeta_abs": d_db, "dbeta": float(db_r),
                     "dbeta_terms": float(terms)})
        print(f"  gate (i) expert {site:8s} E={e} M={m} {k}->{n}: forward "
              f"flips {flips} of {outputs}; against float64: dx {r_dx:.2e}, "
              f"dw {r_dw:.2e} of the fp32 dot bound; dbeta {float(db):.6e} "
              f"vs {float(db_r):.6e} (|d| {d_db:.2e}, sum of |terms| "
              f"{float(terms):.3e})")
        del x, w, g, gw, dx, dw, dx_r, dw_r, x64, xq64, x_q, inside, terms
        torch.cuda.empty_cache()
    return rows


def ssd_sequential64(torch, x, dt, a, b, c):
    """The SSD recurrence, token by token, in the inputs' dtype (float64
    here): ``h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_tᵀ``, ``y_t = c_t
    h_t`` from a zero state, head ``h`` reading group ``h // (H / G)``.
    x [B, S, H, P], dt [B, S, H], a [H], b / c [B, S, G, N] → y [B, S, H,
    P]."""
    bsz, s, heads, pdim = x.shape
    rep = heads // b.shape[2]
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)
    h = torch.zeros((bsz, heads, b.shape[3], pdim), dtype=x.dtype,
                    device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                            # [B, H]
        h = (decay[..., None, None] * h
             + (dt[:, t, :, None] * bh[:, t])[..., None] * x[:, t, :, None])
        ys.append(torch.einsum("zhn,zhnp->zhp", ch[:, t], h))
    return torch.stack(ys, dim=1)


def ssd_gradients(torch) -> dict:
    """Gate (i) of phase 18 at mamba2-130m's training scan (TRAIN_BATCH x
    TRAIN_SEQ, H 24, P 64, N 128, zero state; x, b and c strided views of
    one projection, as the mixer hands them over): ``dispatch.ssd``'s
    autograd rule launches ``ssd_scan`` once and nothing in its backward;
    its gradients of x, dt, a, b and c, from a random upstream gradient of
    y (no cache reads the final state), each within SSD_GRAD_TOL of that
    gradient's largest magnitude of the sequential recurrence's autograd
    in float64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ssd_scan as ks

    cfg = get_config(MAMBA)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(180)
    heads, pdim = cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    d_inner = heads * pdim
    bsz, s = TRAIN_BATCH, TRAIN_SEQ
    xbc0 = torch.nn.functional.silu(torch.randn(
        (bsz, s, d_inner + 2 * g * n), generator=gen, device=dev))
    dt0 = torch.nn.functional.softplus(
        torch.randn((bsz, s, heads), generator=gen, device=dev)
        + math.log(math.expm1(0.01)))
    a0 = -torch.linspace(1.0, 16.0, heads, device=dev)
    gy = torch.randn((bsz, s, heads, pdim), generator=gen, device=dev)

    def split(xbc):
        return (xbc[..., :d_inner].reshape(bsz, s, heads, pdim),
                xbc[..., d_inner:d_inner + g * n].reshape(bsz, s, g, n),
                xbc[..., d_inner + g * n:].reshape(bsz, s, g, n))

    grads = {}
    for name, dtype in (("card", torch.float32), ("f64", torch.float64)):
        xbc, dt, a = (t.to(dtype).clone().requires_grad_()
                      for t in (xbc0, dt0, a0))
        x, b, c = split(xbc)
        if name == "card":
            before = ks.launches
            y, _ = dispatch.ssd(x, dt, a, b, c)
            check(ks.launches == before + 1, "train ssd: the forward did "
                  "not launch ssd_scan once")
            y.backward(gy)
            torch.cuda.synchronize()
            check(ks.launches == before + 1, "train ssd: the backward "
                  "launched ssd_scan")
        else:
            ssd_sequential64(torch, x, dt, a, b, c).backward(gy.double())
        gx, gb, gc = split(xbc.grad)
        grads[name] = {"x": gx, "dt": dt.grad, "a": a.grad, "b": gb,
                       "c": gc}
    rel = {}
    for k, want in grads["f64"].items():
        got = grads["card"][k]
        check(bool(torch.isfinite(got).all()), f"train ssd: d{k} is not "
              f"finite")
        rel[k] = float((got.double() - want).abs().max()
                       / want.abs().max().clamp_min(1e-300))
        check(rel[k] <= SSD_GRAD_TOL, f"train ssd: d{k} is {rel[k]:.2e} of "
              f"its largest magnitude from float64")
    worst = max(rel, key=rel.get)
    print(f"  gate (i) ssd_scan {MAMBA} {bsz} x {s} H{heads} N{n}: one "
          f"launch forward, none backward; gradients against the float64 "
          f"recurrence (max |d| over max |grad|): "
          + ", ".join(f"d{k} {v:.2e}" for k, v in rel.items())
          + f"; worst d{worst}")
    return {"rel": rel, "worst": worst}


def family_tokens(cfg, rows: int, seq: int, seed: int) -> np.ndarray:
    """``rows`` corpus sequences of ``seq + 1`` tokens from the Markov
    corpus of ``seed``; the audio family's ``[rows, seq + 1, K]``, codebook
    ``k`` from the corpus of ``seed + k``."""
    from repro_torch.data.corpus import MarkovCorpus

    if cfg.family != "audio":
        return MarkovCorpus(cfg.vocab_size, seed=seed).sample(rows, seq + 1)
    return np.stack([MarkovCorpus(cfg.vocab_size, seed=seed + k).sample(
        rows, seq + 1) for k in range(cfg.num_codebooks)], axis=-1)


def family_batch(torch, cfg, raw, gen, teacher, device) -> dict:
    """A distillation batch of corpus rows ``raw`` on ``device``: tokens,
    labels, the vlm's ``patch_embeds`` [B, vit_tokens, vit_dim] (normal,
    from ``gen``) and the teacher's logits over the model's sequence (the
    vlm's image prefix included; audio ``[B, S, K, V]``)."""
    from repro_torch.data.synthetic import teacher_logits

    raw = torch.as_tensor(np.asarray(raw), dtype=torch.int64, device=device)
    batch = {"tokens": raw[:, :-1], "labels": raw[:, 1:]}
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.randn(
            (raw.shape[0], cfg.vit_tokens, cfg.vit_dim), generator=gen,
            device=gen.device).to(device)
    batch.update(extra)
    batch["teacher_logits"] = teacher_logits(teacher, cfg, batch["tokens"],
                                             extra)
    return batch


def train_family_run(torch, arch: str) -> dict:
    """HWA distillation of the vlm or audio family at full width on the
    kernels (``train_model``; the student a copy of the teacher; batches
    from :func:`family_batch`, the vlm's with VIT_TOKENS patch embeddings a
    row): TRAIN_STEPS steps under gate (ii) (the range rules and eq. 4
    after every step, the projector's range among them) with each step's
    launches counted, then FAMILY_TIMED_STEPS steps timed on the host
    clock, then one step under the profiler (the device split)."""
    import repro_torch.train.recipes as recipes
    from repro_torch.data.loader import TokenLoader

    acfg, tcfg = train_configs()
    cfg, params, labels = train_model(torch, arch)
    n_params = sum(t.numel() for t in _leaves(params))
    dev = torch.device("cuda")
    tokens = family_tokens(cfg, TRAIN_BATCH * (TRAIN_STEPS
                                               + FAMILY_TIMED_STEPS + 1),
                           TRAIN_SEQ, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    loader = TokenLoader(tokens, TRAIN_BATCH, seed=0)

    def make_batch(raw):
        return family_batch(torch, cfg, raw, gen, params, dev)

    log = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(torch)
    with training_checked(torch, acfg, log):
        trainer = recipes._run(recipes._clone(params), labels, cfg, acfg,
                               tcfg, loader, make_batch,
                               num_steps=TRAIN_STEPS, ckpt_dir=None, seed=0)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = list(trainer.history)
    check(len(hist) == TRAIN_STEPS and trainer.skipped_steps == 0
          and all(math.isfinite(h["loss"]) for h in hist),
          f"train {arch}: losses {[h['loss'] for h in hist]}")   # gate (iv)
    sites = mvm_sites(cfg) + projector(cfg)
    check(log["ranges_checked"] == [sites] * TRAIN_STEPS
          and len(log["clip"]) == TRAIN_STEPS,
          f"train {arch}: ranges checked {log['ranges_checked']}")
    per_step = train_step_launches(cfg)
    check(log["step_launches"] == [per_step] * TRAIN_STEPS,
          f"train {arch}: launches per step {log['step_launches']}, "
          f"expected {per_step}")
    # the teacher's logits come from a digital forward: no launches
    check(launches == {k: TRAIN_STEPS * v for k, v in per_step.items()},
          f"train {arch}: launches {launches}")
    for i, h in enumerate(hist):
        print(f"  train {arch} step {i}{' (warm-up)' if i == 0 else ''}, "
              f"gates (ii) checked in it: {1e3 * h['dt']:.1f} ms, loss "
              f"{h['loss']:.6f} (kd {h['kd']:.6f}), grad norm "
              f"{h['grad_norm']:.4f}, lr {h['lr']:.2e}; weights clipped "
              f"{log['clip'][i]['clipped_share']:.2e}")
    batches = (make_batch(raw) for raw in loader)
    trainer.fit(batches, FAMILY_TIMED_STEPS)
    timed = trainer.history[TRAIN_STEPS:]
    check(len(timed) == FAMILY_TIMED_STEPS
          and all(math.isfinite(h["loss"]) for h in timed),
          f"train {arch}: timed steps {timed}")
    dts = [h["dt"] for h in timed]
    step_ms = 1e3 * sum(dts) / len(dts)
    rows = TRAIN_BATCH * (TRAIN_SEQ + VIT_TOKENS * projector(cfg))
    prof = train_step_profile(torch, cfg, acfg, tcfg, labels, trainer.params,
                              trainer.state, next(batches))
    print(f"  train {arch} ({n_params / 1e9:.3f}B params), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}"
          + (f" + {VIT_TOKENS} patch embeddings" if projector(cfg)
             else f" x {cfg.num_codebooks} codebooks") +
          f": {step_ms:.1f} ms per step (mean of {len(dts)}: "
          + ", ".join(f"{1e3 * d:.1f}" for d in dts)
          + f"), {M_TRAIN / step_ms * 1e3:.0f} training tokens/s "
          f"({rows} rows a step), peak {peak_gb:.2f} GB, launches "
          f"{launches} ({per_step} per step)")
    print(f"  train {arch} step on the device (torch.profiler): "
          f"analog_matmul {prof['analog_matmul_ms']:.2f} ms (forward + "
          f"remat), cuBLAS matmuls {prof['matmul_ms']:.2f} ms, other "
          f"{prof['other_ms']:.2f} ms; {prof['device_ms']:.2f} ms of the "
          f"{step_ms:.1f} ms step; largest other: " + ", ".join(
              f"{name} {ms:.2f}" for name, ms in prof["top_other"]))
    print(f"  train {arch} step by stage (CUDA events; peak allocated): "
          + ", ".join(f"{name} {st['ms']:.1f} ms ({st['peak_gb']:.2f} GB)"
                      for name, st in prof["stages"].items()))
    del trainer, params, batches
    torch.cuda.empty_cache()
    return {"params": n_params, "steps": hist, "timed": timed,
            "step_ms": step_ms, "tokens_per_s": M_TRAIN / step_ms * 1e3,
            "rows_per_step": rows, "peak_gb": peak_gb, "launches": launches,
            "launches_per_step": per_step, "profile": prof,
            "clip": log["clip"]}


def phase_train_families(torch) -> dict:
    """HWA distillation of mamba2-130m and qwen3-moe-30b-a3b at full width
    (``train_run``: gates (ii)–(iv) and the launch counts of every step)
    after gate (i) at their new shapes (the batched expert site's STE
    backward at E 128 and MOE_TRAIN_ROWS rows, the SSD autograd rule at
    the training scan); internvl2-2b and musicgen-medium at full width
    (:func:`train_family_run`); then gate (v), the reduced mamba2-130m,
    qwen3-moe-30b-a3b, dbrx-132b, jamba-v0.1-52b, internvl2-2b and
    musicgen-medium trained on the card against the CPU."""
    out = {"gate_i": {"experts": expert_site_gradients(torch),
                      "ssd": ssd_gradients(torch)}}
    for arch in TRAIN_FAMILY_ARCHS:
        out[arch] = train_run(torch, arch)
    for arch in VLM_AUDIO_TRAIN:
        out[arch] = train_family_run(torch, arch)
    out["reduced"] = {arch: reduced_train_check(torch, arch)
                      for arch in REDUCED_TRAIN_ARCHS + VLM_AUDIO_TRAIN}
    return out


def _by_row(t, p, rows: int, seq: int):
    """A site tensor's elements by (row, position) of the batch: [rows,
    seq, -1] for a 2-D site (the vlm's projector, whose positions are the
    first of the sequence, padded with zeros); for a batched (expert) site, whose [E, B·C,
    ·] rows are each sequence's capacity slots, [rows, E · C · ·]: its
    elements by row only (``seq`` unused)."""
    if p["kernel"].dim() == 3:
        e = p["kernel"].shape[0]
        return t.reshape(e, rows, -1).transpose(0, 1).reshape(rows, -1)
    t = t.reshape(rows, -1, t.shape[-1])
    if t.shape[1] < seq:     # the vlm's projector: the image prefix
        out = t.new_zeros((rows, seq, t.shape[-1]))
        out[:, :t.shape[1]] = t
        return out
    return t


def _rows_masked(g, p, clean):
    """``g`` with the rows that ``clean`` [rows] rules out zeroed."""
    if p["kernel"].dim() == 3:
        e = p["kernel"].shape[0]
        mask = clean.to(g.dtype).reshape(1, -1, 1)
        return (g.reshape(e, clean.numel(), -1) * mask).reshape(g.shape)
    return g * clean.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)


def row_losses(torch, cfg, tcfg, logits, batch, routes: list):
    """Each row's share of a step's loss, so that the loss is their mean:
    ``kd_beta`` times the row's KD and ``ce_weight`` times its CE from
    ``logits`` (the LM head site's output, padded vocab; audio's ``K · V``
    columns as ``[K, V]``; the vlm's labels and mask lined up with its
    image prefix, as the loss lines them up), and
    ``aux_loss_weight`` times the mean over the routed layers of the row's
    Switch loss, ``E · sum_e density_e · mean_s probs_e`` (``routes``:
    ``routes_recorded``'s ids and probabilities)."""
    from repro_torch.train.distill import ce_loss, kd_loss
    from repro_torch.train.train_step import _align_vlm_labels

    if cfg.family == "audio":       # the head's K x V columns
        lg = logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                            cfg.vocab_size).float()
    else:
        lg = logits[..., :cfg.vocab_size].float()
    labels, mask = _align_vlm_labels(cfg, batch)
    e = cfg.num_experts
    out = []
    for r in range(lg.shape[0]):
        m = None if mask is None else mask[r:r + 1]
        share = (tcfg.kd_beta * kd_loss(
            lg[r:r + 1], batch["teacher_logits"][r:r + 1],
            tcfg.kd_temperature, m)
            + tcfg.ce_weight * ce_loss(lg[r:r + 1], labels[r:r + 1], m))
        if routes:
            aux = []
            for ids, probs, _ in routes:
                density = torch.bincount(ids[r, :, 0], minlength=e).float()
                aux.append(e * torch.sum(density / ids.shape[1]
                                         * torch.mean(probs[r], dim=0)))
            share = share + tcfg.aux_loss_weight * torch.mean(
                torch.stack(aux))
        out.append(share)
    return torch.stack(out)


def train_forward_parity(torch, arch: str, cfg, acfg, tcfg, params: dict,
                         batch: dict, rows: int, seq: int) -> dict:
    """Gate (v)'s comparison of one loss function call (and its backward)
    from the same ``params`` (on the CPU) on both sides: every analog
    site's input, output and upstream gradient, and every MoE routing,
    recorded; the causal rule (see :func:`reduced_train_check`), the
    upstream gradients and the replayed site backwards on the rows nothing
    reached, every gradient leaf when nothing was. Returns the records by
    side (``rec``: calls, routes, gradient leaves), each side's loss, the
    reach and the numbers gate (v) prints."""
    from repro_torch.checkpoint import flatten_paths, unflatten_paths
    from repro_torch.core import analog as A
    from repro_torch.kernels import ref
    from repro_torch.train import train_step as ts

    cuda = torch.device("cuda")
    rec, loss_at = {}, {}
    for side, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        p = _to(params, dev)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in flatten_paths(p).items()}
        calls, routes = [], []

        def spy(pp, x, cfg_, ctx):
            y, st = real(pp, x, cfg_, ctx)
            entry = [x.detach().cpu(), y.detach().cpu(), None,
                     {k: v.detach().cpu().clone()
                      for k, v in flatten_paths(pp).items()}, ctx]
            y.register_hook(lambda g, e=entry: e.__setitem__(2, g.cpu()))
            calls.append(entry)
            return y, st

        with sites_replaced(spy) as real, routes_recorded(
                torch, routes, calls):
            loss, _ = ts.make_loss_fn(cfg, acfg, dataclasses.replace(
                tcfg, remat=False))(unflatten_paths(leaves),
                                    _to(batch, dev), (0,))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        rec[side] = (calls, routes,
                     {k: g.cpu() for k, g in zip(leaves, grads)})
        loss_at[side] = float(loss.detach())
    (calls_c, routes_c, grads_c), (calls_g, routes_g, grads_g) = (
        rec["cpu"], rec["cuda"])
    check(len(calls_c) == len(calls_g) == mvm_sites(cfg) + projector(cfg),
          f"reduced train {arch}: {len(calls_c)} / {len(calls_g)} site "
          f"calls")
    check(len(routes_c) == len(routes_g) == moe_layers(cfg),
          f"reduced train {arch}: {len(routes_g)} routed layers")
    reach = torch.zeros((rows, seq), dtype=torch.bool)
    out_flips = moved = 0
    pending = list(zip(routes_c, routes_g))
    k = cfg.top_k
    for i, ((xc, yc, _, pc, _), (xg, yg, *_)) in enumerate(
            zip(calls_c, calls_g)):
        while pending and pending[0][0][2] <= i:   # routes made before it
            (ids_c, probs, _), (ids_g, _, _) = pending.pop(0)
            diff = (ids_c.sort(-1).values != ids_g.sort(-1).values).any(-1)
            if bool(diff.any()):
                # where nothing reached the token, only a near-tie may move
                # its route; a reached token's router input differs
                top = probs.sort(-1, descending=True).values
                gap = (top[..., k - 1] - top[..., k])[diff & ~reach]
                check(bool((gap <= ROUTE_TIE).all()), f"reduced train "
                      f"{arch}: a routing id moved away from a near-tie "
                      f"where no site output apart reached it")
                moved += int(diff.sum())
                reach |= diff.any(-1, keepdim=True)
        apart = _by_row((xg - xc).abs() > SITE_INPUT_TOL * (1 + xc.abs()),
                        pc, rows, seq).any(-1)
        o_apart = _by_row((yg - yc).abs() > 1e-5 * (1 + yc.abs()), pc, rows,
                          seq).any(-1)
        if apart.dim() == 1:                        # a batched site: by row
            check(bool(reach[apart].any(-1).all()), f"reduced train {arch}: "
                  f"site {i}'s input differs in a row nothing reached")
            out_flips += int(o_apart.sum())
            reach |= o_apart[:, None]
        else:
            check(bool(reach[apart].all()), f"reduced train {arch}: site "
                  f"{i}'s input differs where no site output did before")
            out_flips += int(o_apart.sum())
            reach |= torch.cummax(o_apart.int(), dim=1).values.bool()
    clean = ~reach.any(dim=1)
    worst = 0.0
    for i, ((_, _, gc, pc, _), (_, _, gg, *_)) in enumerate(zip(calls_c,
                                                                calls_g)):
        check(gc is not None and gg is not None,
              f"reduced train {arch}: site {i} got no gradient")
        gc, gg = (_by_row(t, pc, rows, seq)[clean] for t in (gc, gg))
        if gc.numel():
            r = float((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30))
            worst = max(worst, r)
    check(worst <= REDUCED_GRAD_TOL,
          f"reduced train {arch}: an upstream gradient is {worst:.2e} apart")
    check(bool(clean.any()), f"reduced train {arch}: every row was reached "
          f"by a flip or a route, so no site gradient can be compared")
    site_worst = site_dbeta = 0.0
    for i, (call_c, call_g) in enumerate(zip(calls_c, calls_g)):
        ga = {}
        for side, (x, _, g, pp, ctx), dev in (("cpu", call_c, "cpu"),
                                             ("cuda", call_g, cuda)):
            g = _rows_masked(g, pp, clean)
            leaves = {kk: v.detach().to(dev).requires_grad_()
                      for kk, v in pp.items()}
            xl = x.detach().to(dev).requires_grad_()
            y, _ = A.analog_linear(unflatten_paths(leaves), xl, acfg, ctx)
            gs = torch.autograd.grad(y, [xl, *leaves.values()], g.to(dev),
                                     allow_unused=True)
            ga[side] = {kk: t.cpu() for kk, t in zip(["x", *leaves], gs)
                        if t is not None}
        check(set(ga["cpu"]) == set(ga["cuda"]) >= {"x", "kernel",
                                                    "input_range"},
              f"reduced train {arch}: site {i} gradients "
              f"{sorted(ga['cuda'])}")
        for kk, gc in ga["cpu"].items():
            d = float((ga["cuda"][kk] - gc).abs().max())
            if kk == "input_range":   # one sum: scaled by its |terms|
                x, _, g, pp, _ = call_c
                g = _rows_masked(g, pp, clean)
                w = pp["kernel"]
                lead = (w.shape[0],) if w.dim() == 3 else ()
                x = x.reshape(lead + (-1, w.shape[-2]))
                g = g.reshape(lead + (-1, w.shape[-1]))
                beta = pp["input_range"].reshape(())
                x_q = ref.div(beta, 127.0) * torch.round(
                    ref.clip(x, -beta, beta) * ref.rdiv(127.0, beta))
                terms = (torch.where(x.abs() <= beta, (x_q - x) / beta,
                                     torch.sign(x))
                         * (g @ w.transpose(-1, -2))).abs().sum()
                r = d / max(float(terms), 1e-30)
                site_dbeta = max(site_dbeta, r)
            else:
                r = d / max(float(gc.abs().max()), 1e-30)
                site_worst = max(site_worst, r)
            check(r <= REDUCED_GRAD_TOL, f"reduced train {arch}: site {i}'s "
                  f"replayed d{kk} is {r:.2e} apart")
    leaf_worst = None
    if not reach.any():
        leaf_worst = max(float((grads_g[kk] - g).abs().max()
                               / g.abs().max().clamp_min(1e-30))
                         for kk, g in grads_c.items())
        check(leaf_worst <= REDUCED_GRAD_TOL,
              f"reduced train {arch}: a gradient leaf is {leaf_worst:.2e} "
              f"apart")
    return {"rec": rec, "loss": loss_at, "reach": reach, "clean": clean,
            "out_flips": out_flips, "moved": moved, "worst": worst,
            "site_worst": site_worst, "site_dbeta": site_dbeta,
            "leaf_worst": leaf_worst}


def reduced_train_check(torch, arch: str) -> dict:
    """Gate (v): the reduced ``arch`` trains on the card (the kernels) and
    on the CPU (their plain versions) from the same weights and batches,
    ``train_noise`` off. First step: every analog site's input and output
    are recorded, and its upstream gradient, and every MoE routing; a
    site input may differ beyond ``SITE_INPUT_TOL`` only where an earlier
    site output apart (an ADC near-tie flip) reaches
    (``reduced_eval_check``'s causal rule: the rest of the row; a batched
    expert site's slots are a row's, so there the whole row), and a
    routing id may differ only where the CPU's k-th and (k+1)-th router
    probabilities lie within ROUTE_TIE or where an earlier site output
    apart reached it; its row then counts as reached (the capacity ranks
    of the row's later tokens move with it).
    At every row nothing reached, each site's upstream gradient agrees
    within ``REDUCED_GRAD_TOL`` of its largest magnitude (every gradient
    leaf too when nothing was reached). Each site's backward is then
    replayed on both sides from its recorded input, parameters and
    upstream gradient, with the reached rows of that gradient zeroed: its
    dx and dw (the card's products) agree within ``REDUCED_GRAD_TOL`` of
    their largest magnitude and its dbeta within ``REDUCED_GRAD_TOL`` of
    its sum of |terms| (:func:`train_forward_parity`). Then
    ``REDUCED_TRAIN_STEPS`` steps of the train step (remat on): losses
    within ``REDUCED_LOSS_TOL``; where a route moved, the first step's
    loss row by row on the unreached rows (``row_losses``), since the
    reached rows train other experts and the later steps start from
    parameters they moved apart (reported). Before every step the card's
    parameters and Adam state are read against the CPU's
    (:func:`train_state_apart`); for ``LATER_TIE_ARCHS`` alone a later
    step whose losses part is held by that reading (within
    ``TRAIN_STATE_TOL``) and by its forward from the CPU's parameters on
    both sides, as the first step's (a site output apart must explain it
    under the causal rule; the loss is held on the rows nothing
    reached)."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import build
    from repro_torch.train import train_step as ts

    cfg = get_config(arch).reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    rows, seq = REDUCED_TRAIN_SHAPE
    toks = family_tokens(cfg, rows * REDUCED_TRAIN_STEPS, seq, 1)
    gen = torch.Generator().manual_seed(1)
    batches = [family_batch(torch, cfg, toks[rows * i:rows * (i + 1)], gen,
                            params, torch.device("cpu"))
               for i in range(REDUCED_TRAIN_STEPS)]
    seq += cfg.vit_tokens * projector(cfg)       # the model's positions
    acfg = AnalogConfig(mode="analog", use_pallas=True, train_noise=False,
                        out_bound=14.0, kappa_init=18.0)
    tcfg = ts.TrainConfig(kd_temperature=2.0, ce_weight=0.5, peak_lr=1e-3,
                          total_steps=10)
    step = ts.make_train_step(cfg, acfg, tcfg, labels, train_lr(tcfg))
    losses, before = {}, {}
    for side, dev in (("cpu", torch.device("cpu")),
                      ("cuda", torch.device("cuda"))):
        p = _to(params, dev)
        state = ts.init_train_state(p)
        losses[side], before[side] = [], []
        for b in batches:
            before[side].append((p, state))   # the step is functional
            p, state, m = step(p, state, _to(b, dev), (0,))
            losses[side].append(float(m["loss"]))
    states = [train_state_apart(torch, arch, before, params, i)
              for i in range(1, REDUCED_TRAIN_STEPS)]
    fwd = train_forward_parity(torch, arch, cfg, acfg, tcfg, params,
                               batches[0], rows, seq)
    rec, clean, moved = fwd["rec"], fwd["clean"], fwd["moved"]
    print(f"  gate (v) reduced {arch}, {rows} x {seq}: {fwd['out_flips']} "
          f"site output positions apart (ADC near-ties)"
          + (f", {moved} routing ids moved at near-ties" if moe_layers(cfg)
             else "")
          + f", {int(clean.sum())} of {rows} rows unreached; upstream "
          f"gradients within {fwd['worst']:.2e} of their max there; "
          f"replayed on those rows, site dx and dw within "
          f"{fwd['site_worst']:.2e} of their max, dbeta within "
          f"{fwd['site_dbeta']:.2e} of its sum of |terms|"
          + ("" if fwd["leaf_worst"] is None else
             f", every gradient leaf within {fwd['leaf_worst']:.2e}")
          + f"; losses card {losses['cuda']} / cpu {losses['cpu']}; "
          "card state against the cpu's before steps "
          + ", ".join(f"{i + 1}: parameters {st['params']:.2e}, moments "
                      f"{st['moments']:.2e}" for i, st in enumerate(states)))
    row_rel = None
    later = []
    if moved:
        # the reached rows train on other experts: the first step's loss
        # is held row by row where nothing reached; the later steps start
        # from parameters those rows moved apart
        row_rel = rows_held(torch, arch, cfg, tcfg, fwd, batches[0],
                            {side: v[0] for side, v in losses.items()})
        print(f"  gate (v) reduced {arch}: a route moved, so the first "
              f"step's loss is held on the {int(clean.sum())} unreached "
              f"rows (within {row_rel:.2e}); later steps' losses card - "
              f"cpu: " + ", ".join(f"{a - b:.3e}" for a, b in zip(
                  losses["cuda"][1:], losses["cpu"][1:])))
    else:
        for i, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
            if abs(a - b) <= REDUCED_LOSS_TOL * (1 + abs(b)):
                continue
            check(i > 0 and arch in LATER_TIE_ARCHS, f"reduced train "
                  f"{arch}: losses card {losses['cuda']}, cpu "
                  f"{losses['cpu']}")
            st = states[i - 1]
            check(max(st["params"], st["moments"]) <= TRAIN_STATE_TOL,
                  f"reduced train {arch}: before step {i} the card's state "
                  f"is apart from the cpu's (parameters {st['params']:.2e}, "
                  f"moments {st['moments']:.2e})")
            lat = train_forward_parity(torch, arch, cfg, acfg, tcfg,
                                       before["cpu"][i][0], batches[i], rows,
                                       seq)
            check(bool(lat["reach"].any()) and not lat["moved"],
                  f"reduced train {arch}: step {i}'s losses part (card "
                  f"{a}, cpu {b}) with no site output apart")
            rel = rows_held(torch, arch, cfg, tcfg, lat, batches[i],
                            lat["loss"])
            later.append({"step": i, "apart": a - b, "state": st,
                          "site_output_positions_apart": lat["out_flips"],
                          "rows_unreached": int(lat["clean"].sum()),
                          "row_loss_rel": rel})
            print(f"  gate (v) reduced {arch} step {i}: losses part by "
                  f"{a - b:.3e}; the card's state before it within "
                  f"{st['params']:.2e} (parameters) and {st['moments']:.2e} "
                  f"(moments) of the cpu's; from the cpu's parameters before "
                  f"it, {lat['out_flips']} site output positions apart (ADC "
                  f"near-ties), {int(lat['clean'].sum())} of {rows} rows "
                  f"unreached, their losses within {rel:.2e}, upstream "
                  f"gradients within {lat['worst']:.2e}, site dx and dw "
                  f"within {lat['site_worst']:.2e}")
    return {"site_output_positions_apart": fwd["out_flips"],
            "routes_moved": moved, "row_loss_rel": row_rel,
            "rows_unreached": int(clean.sum()), "grad_rel": fwd["worst"],
            "site_grad_rel": fwd["site_worst"],
            "site_dbeta_rel": fwd["site_dbeta"],
            "leaf_grad_rel": fwd["leaf_worst"], "losses": losses,
            "states": states, "later_steps": later}


def train_state_apart(torch, arch: str, before: dict, params: dict,
                      i: int) -> dict:
    """The card's parameters and Adam state before step ``i`` against the
    CPU's (``before[side][i]``, from the same ``params``): the step counts
    equal, and the largest per-leaf L2 ratio |card - cpu| / |cpu - params|
    over the parameters (the CPU's update since the start) and |card -
    cpu| / |cpu| over the moments (0 where both sides are equal)."""
    from repro_torch.checkpoint import flatten_paths

    (pc, sc), (pg, sg) = before["cpu"][i], before["cuda"][i]
    check(int(sc["step"]) == int(sg["step"]) and int(sc["opt"]["count"])
          == int(sg["opt"]["count"]), f"reduced train {arch}: step counts "
          f"apart before step {i}")
    init = flatten_paths(params)
    out = {}
    for group, c, g in (("params", pc, pg),
                        ("moments", {"m": sc["opt"]["m"], "v": sc["opt"]["v"]},
                         {"m": sg["opt"]["m"], "v": sg["opt"]["v"]})):
        fc, fg = flatten_paths(c), flatten_paths(g)
        worst = 0.0
        for k, vc in fc.items():
            vc = vc.detach().float()
            d = float(torch.linalg.vector_norm(
                fg[k].detach().cpu().float() - vc))
            if d == 0.0:
                continue
            base = vc - init[k].float() if group == "params" else vc
            n = float(torch.linalg.vector_norm(base))
            worst = max(worst, d / n if n > 0 else float("inf"))
        out[group] = worst
    return out


def rows_held(torch, arch: str, cfg, tcfg, fwd: dict, batch: dict,
              loss: dict) -> float:
    """A compared loss call's loss row by row (``row_losses`` from its
    recorded logits and routes): on each side the rows' shares add up to
    that side's ``loss``, and on the rows nothing reached the card's share
    is within ``REDUCED_LOSS_TOL`` of the CPU's. Returns the largest
    relative difference there."""
    shares = {}
    for side, (calls, routes, _) in fwd["rec"].items():
        shares[side] = row_losses(torch, cfg, tcfg, calls[-1][1], batch,
                                  routes)
        check(abs(float(shares[side].mean().detach()) - loss[side])
              <= REDUCED_LOSS_TOL * (1 + abs(loss[side])),
              f"reduced train {arch}: the rows' losses do not add up "
              f"to the {side} step's loss")
    clean = fwd["clean"]
    want = shares["cpu"][clean]
    rel = float(((shares["cuda"][clean] - want).abs()
                 / (1 + want.abs())).max())
    check(rel <= REDUCED_LOSS_TOL, f"reduced train {arch}: an unreached "
          f"row's loss is {rel:.2e} apart")
    return rel


# ---------------------------------------------------------------------------
# phase 15: the SpinQuant-lite PTQ baseline at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def calibration_recorded(log: list):
    """Inside the block every forward of ``train.recipes`` (the
    calibration forward of ``calibrate_input_ranges``) appends its stats
    tree to ``log``."""
    from repro_torch.train import recipes

    real = recipes.model_apply

    def spy(*a, **k):
        out = real(*a, **k)
        log.append(out[1])
        return out

    recipes.model_apply = spy
    try:
        yield
    finally:
        recipes.model_apply = real


def calibrated_sites(torch, params: dict, stats: dict) -> int:
    """Every ``input_range`` of ``params`` must equal ``max(x_absmax,
    1e-6)`` of its site in ``stats`` (the calibration forward's), broadcast
    to its shape, bit for bit. Returns the number of range leaves held."""
    n = 0
    for k, v in params.items():
        sub = stats.get(k) if isinstance(stats, dict) else None
        if k == "input_range":
            check(isinstance(stats, dict) and "x_absmax" in stats,
                  "ptq: an input range without a calibration statistic")
            want = torch.clamp_min(stats["x_absmax"].to(v.device), 1e-6)
            check(bool(torch.equal(v, torch.broadcast_to(
                want[..., None], v.shape))), "ptq: a calibrated input range "
                "is not its site's x_absmax from the calibration forward")
            n += 1
        elif isinstance(v, dict):
            n += calibrated_sites(torch, v, sub)
    return n


def ptq_eval(torch, cfg, params, labels, tasks, name, acfg, noise,
             seeds: int, want: dict) -> dict:
    """One deployment of the PTQ model through ``evaluate`` on the
    phase-12 tasks: per seed its seconds, launches and peak; each kernel's
    launches must be ``want`` per seed (kernel name: launches of a seed),
    and each task ``seeds`` runs, each a share."""
    from repro_torch.eval.harness import evaluate

    log = SeedLog(torch, tasks)
    with log.recording():
        log.start()
        t0 = time.perf_counter()
        res = evaluate(params, labels, cfg, acfg, log.tasks, noise,
                       seeds=seeds)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = launch_counts()
    n = seeds if noise.model != "none" else 1
    check(launches == {k: v * n for k, v in want.items()},
          f"{cfg.name} ptq {name}: launches {launches}")
    check_runs(res, list(tasks), n, f"{cfg.name} ptq {name}")
    per = [sd["s"] for sd in log.seeds]
    out = {"results": res, "s": total_s, "per_seed": log.seeds,
           "launches": launches,
           "peak_gb": max(sd["peak_gb"] for sd in log.seeds)}
    print(f"  {cfg.name} ptq {name}: {n} seed(s) in {total_s:.2f} s ("
          f"{min(per):.3f}-{max(per):.3f} s a seed), peak "
          f"{out['peak_gb']:.2f} GB, launches {launches}; "
          + "; ".join(f"{t} {res[t]['mean']:.4f}" for t in tasks)
          + " (random weights)")
    return out


def phase_ptq(torch, arch: str) -> dict:
    """SpinQuant-lite PTQ (the paper's SI8-W4 / DI8-W4 baseline) at full
    width, random weights from a seed: ``fold_norm_scales``, a random
    rotation (Hadamard at d 2048, the QR path at d 3072), then
    ``spinquant_ptq`` (the rotation folded into every residual writer and
    reader, and the static ranges calibrated on a 16 x 64 batch). Gates:
    R Rᵀ = I within PTQ_ORTHO_TOL, the rotated model's ``off`` log-softmax
    within PTQ_INV_TOL of the unrotated one on 2 x 64 tokens, every
    calibrated range equal to its site's x_absmax from the calibration
    forward. Then the noisy-eval protocol on the phase-12 tasks: SI8-W4
    (``qat``, W4, no output quantization, the plain path, as the JAX
    package runs it), SI8-W4 under the hw noise over 10 seeds, DI8-W4,
    ``analog_hw`` over 10 seeds on ``analog_matmul`` and ``digital_int4``
    on ``int4_matmul``; gated on the protocol's invariants, not on the
    scores of random weights."""
    from repro_torch.core import rotations as rot
    from repro_torch.core.analog import (AnalogConfig, AnalogCtx,
                                         pack_int4_weights)
    from repro_torch.eval.harness import NoiseSpec
    from repro_torch.models import apply
    from repro_torch.serve.decode import digital_int4_config
    from repro_torch.train import recipes

    dev = torch.device("cuda")
    cfg, params, labels = full_width(torch, arch)
    sites = mvm_sites(cfg)
    gen = torch.Generator(device=dev).manual_seed(20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    folded = rot.fold_norm_scales(params, cfg)
    del params
    r = rot.random_hadamard(gen, cfg.d_model)
    with rot.full_fp32():
        ortho = float((r @ r.T - torch.eye(cfg.d_model, device=dev)
                       ).abs().max())
    check(ortho <= PTQ_ORTHO_TOL, f"{arch} ptq: |R R^T - I| = {ortho:.3e}")
    calib = torch.randint(0, cfg.vocab_size, PTQ_CALIB, generator=gen,
                          device=dev)
    stats = []
    with calibration_recorded(stats):
        ptq = recipes.spinquant_ptq(folded, cfg, calib, None, r=r)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(stats) == 1, f"{arch} ptq: {len(stats)} calibration forwards")
    n_ranges = calibrated_sites(torch, ptq, stats[0])
    check(n_ranges == len({ARCH: SITES, PHI3: PHI3_SITES}[arch]),
          f"{arch} ptq: {n_ranges} calibrated range leaves")
    toks = torch.randint(0, cfg.vocab_size, PTQ_INV_TOKENS, generator=gen,
                         device=dev)
    off = AnalogConfig(mode="off")
    with torch.no_grad():
        a, _, _ = apply(folded, cfg, off, AnalogCtx(), {"tokens": toks})
        b, _, _ = apply(ptq, cfg, off, AnalogCtx(), {"tokens": toks})
        inv = float((torch.log_softmax(a, -1) - torch.log_softmax(b, -1)
                     ).abs().max())
    check(inv <= PTQ_INV_TOL, f"{arch} ptq: the rotated model's log-softmax "
          f"is {inv:.3e} from the unrotated one")
    del folded, a, b
    torch.cuda.empty_cache()
    kind = "QR" if cfg.d_model & (cfg.d_model - 1) else "Hadamard"
    print(f"  {arch} ptq: fold + rotate ({kind}, "
          f"max |R R^T - I| {ortho:.2e}) + calibrate on "
          f"{PTQ_CALIB[0]} x {PTQ_CALIB[1]} tokens in {ptq_s:.2f} s (peak "
          f"{ptq_peak:.2f} GB); {n_ranges} range leaves equal their "
          f"calibration x_absmax; off-mode log-softmax rotated vs not "
          f"{inv:.2e}")
    out = {"arch": arch, "ptq_s": ptq_s, "ptq_peak_gb": ptq_peak,
           "ortho": ortho, "invariance": inv, "ranges": n_ranges}
    tasks = eval_tasks(cfg)
    n_tasks = len(tasks)
    si8 = AnalogConfig(mode="qat", weight_bits=4, output_quant=False)
    runs = [("si8_w4", si8, NoiseSpec(), {}),
            ("si8_w4_hw", si8, NoiseSpec("hw"), {}),
            ("di8_w4", AnalogConfig(mode="di8", weight_bits=4), NoiseSpec(),
             {}),
            ("analog_hw", AnalogConfig(mode="analog", train_noise=False,
                                       use_pallas=True), NoiseSpec("hw"),
             {"analog_matmul": sites * n_tasks})]
    for name, acfg, noise, want in runs:
        out[name] = ptq_eval(torch, cfg, ptq, labels, tasks, name, acfg,
                             noise, EVAL_SEEDS, want)
    p4 = pack_int4_weights(ptq, labels)
    del ptq
    torch.cuda.empty_cache()
    out["digital_int4"] = ptq_eval(
        torch, cfg, p4, labels, tasks, "digital_int4",
        digital_int4_config(AnalogConfig(weight_bits=4)), NoiseSpec(), 1,
        {"int4_matmul": sites * n_tasks})
    del p4
    torch.cuda.empty_cache()
    return out


def reduced_ptq_check(torch) -> dict:
    """The reduced llama-3.2-1b's PTQ on the card against the CPU, the same
    weights (norm scales made non-trivial), rotation and calibration
    tokens: every calibrated range within PTQ_RANGE_TOL * (1 + |cpu|), and
    the same greedy tokens under SI8-W4 and DI8-W4."""
    from repro_torch.configs import get_config
    from repro_torch.core import rotations as rot
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import build
    from repro_torch.serve.decode import generate
    from repro_torch.train import recipes

    cfg, params, _ = build(get_config(ARCH).reduce(), 0, device="cpu")
    gen = torch.Generator().manual_seed(5)

    def scales(node):
        return {k: (scales(v) if isinstance(v, dict) else
                    v * (1.0 + 0.3 * torch.randn(v.shape, generator=gen))
                    if k == "scale" else v) for k, v in node.items()}

    folded = rot.fold_norm_scales(scales(params), cfg)
    r = rot.random_hadamard(gen, cfg.d_model)
    calib = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    cuda = torch.device("cuda")
    host = recipes.spinquant_ptq(folded, cfg, calib, None, r=r)
    card = recipes.spinquant_ptq(_to(folded, cuda), cfg, calib.to(cuda),
                                 None, r=r.to(cuda))
    worst = 0.0

    def ranges(h, c):
        nonlocal worst
        for k, v in h.items():
            if isinstance(v, dict):
                ranges(v, c[k])
            elif k == "input_range":
                d = (c[k].cpu() - v).abs() / (1 + v.abs())
                worst = max(worst, float(d.max()))

    ranges(host, card)
    check(worst <= PTQ_RANGE_TOL, f"reduced ptq: calibrated ranges card vs "
          f"cpu {worst:.3e} (relative)")
    prompt = torch.randint(0, cfg.vocab_size, (3, 8), generator=gen)
    for mode in ("qat", "di8"):
        acfg = AnalogConfig(mode=mode, weight_bits=4,
                            output_quant=mode != "qat")
        th = generate(host, cfg, acfg, None, prompt, 6, greedy_first=6)
        tc = generate(card, cfg, acfg, None, prompt.to(cuda), 6,
                      greedy_first=6).cpu()
        check(torch.equal(th, tc), f"reduced ptq {mode}: greedy tokens "
              f"differ card vs cpu")
    print(f"  reduced {ARCH} ptq, card vs cpu: calibrated ranges within "
          f"{worst:.2e} (relative), greedy tokens equal under SI8-W4 and "
          f"DI8-W4")
    return {"range_err": worst}


# ---------------------------------------------------------------------------
# phase 16: qwen3-moe-30b-a3b at full width, reduced depth
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def expert_rows(seen: set):
    """Inside the block the row count of every batched (expert) MVM launch
    is added to ``seen``."""
    from repro_torch.kernels import dispatch

    real = dispatch.analog_matmul, dispatch.int4_matmul

    def wrap(fn):
        def call(x, *a, **k):
            if x.dim() == 3:
                seen.add(int(x.shape[1]))
            return fn(x, *a, **k)
        return call

    dispatch.analog_matmul, dispatch.int4_matmul = map(wrap, real)
    try:
        yield
    finally:
        dispatch.analog_matmul, dispatch.int4_matmul = real


@contextlib.contextmanager
def routes_recorded(torch, log: list, sites: list | None = None):
    """Inside the block every MoE layer's routing appends ``(ids [B, S,
    k], router probabilities [B, S, E])``, on the host, to ``log``; with
    ``sites`` (a ``sites_recorded`` log) also the number of site calls
    made before it."""
    from repro_torch.models import moe as MoE

    real = MoE._route

    def spy(x, router, cfg, capacity):
        out = real(x, router, cfg, capacity)
        probs = torch.softmax(torch.matmul(x.float(), router.float()), -1)
        log.append((out[1].cpu(), probs.cpu())
                   + (() if sites is None else (len(sites),)))
        return out

    MoE._route = spy
    try:
        yield
    finally:
        MoE._route = real


def phase_moe(torch) -> dict:
    """qwen3-moe-30b-a3b at full width and MOE_LAYERS layers (random
    weights from a seed): the static engine under ``analog_hw``
    (``use_pallas=True``, against unfused) and ``digital_int4`` (against
    ``digital_rtn4``), as phases 3 and 4 (every site, experts included,
    held to the ADC contract on the same inputs); the continuous engine on
    the bf16 paged pool under both, as phase 8. Every expert site is one
    launch per forward, at the rows phase 2 holds (MOE_ROWS)."""
    out = {}
    seen = {}
    for key, deploy, base in (("analog", "analog_hw", "analog_hw"),
                              ("int4", "digital_int4", "digital_rtn4")):
        seen[f"static/{deploy}"] = rows = set()
        with expert_rows(rows):
            out[key] = serve_phase(torch, deploy, base, MOE)
    cfg, params, labels = full_width(torch, MOE)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, PAGED_BS)
    check(heads == MOE_PAGED, f"{MOE}: the engine's paged heads {heads}, "
          f"phase 5 holds the kernels at {MOE_PAGED}")
    out["params"] = sum(t.numel() for t in _leaves(params))
    out["engine"] = {}
    for deploy in ("analog_hw", "digital_int4"):
        seen[f"continuous/{deploy}"] = rows = set()
        with expert_rows(rows):
            out["engine"][f"{deploy}/kv16"] = engine_phase(
                torch, cfg, params, labels, deploy, 0)
    del params
    torch.cuda.empty_cache()
    static = {MOE_ROWS["static prefill"], MOE_ROWS["static decode"]}
    engine = {MOE_ROWS["engine decode"], MOE_ROWS["engine chunk"]}
    for path, rows in seen.items():
        want = static if path.startswith("static") else engine
        check(rows == want, f"{MOE} {path}: expert launches of {sorted(rows)}"
              f" rows, phase 2 holds the kernels at {sorted(want)}")
    out["expert_rows"] = {k: sorted(v) for k, v in seen.items()}
    print(f"  {MOE}: {out['params'] / 1e9:.3f}B params at {MOE_LAYERS} of 48 "
          f"layers; expert launches' rows {out['expert_rows']}")
    return out


def reduced_card_check(torch, arch: str) -> dict:
    """The reduced ``arch`` on the card (the kernels) against the CPU
    (their plain versions), the same hw-perturbed weights and prompt,
    ``analog_hw`` fused and ``digital_int4``: each MoE layer's routing ids
    equal but for tokens whose k-th and (k+1)-th router probabilities on
    the CPU lie within ROUTE_TIE (counted); every analog site of the
    card's prefill, experts included, replayed on the CPU from its
    recorded input within the ADC contract; and, where no route moved, the
    same greedy tokens. Any family: a vlm's prompt carries patch
    embeddings, an audio prompt one token per codebook, and a model
    without experts routes nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import (AnalogConfig, AnalogCtx,
                                         analog_linear, pack_int4_weights,
                                         perturb_analog_weights)
    from repro_torch.models import build
    from repro_torch.serve.decode import digital_int4_config, generate, prefill

    cfg, params, labels = build(get_config(arch).reduce(), 0, device="cpu")
    hw = perturb_analog_weights(params, labels,
                                torch.Generator().manual_seed(1), "hw")
    prompt, extra = model_prompt(torch, cfg, torch.Generator().manual_seed(2),
                                 3, 12)
    pre = prefix_len(cfg, extra)
    out = {}
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    extra_c = None if extra is None else _to(extra, cuda)
    for deploy, p, acfg in (
            ("analog_hw", hw, AnalogConfig(mode="analog", train_noise=False,
                                           use_pallas=True)),
            ("digital_int4", pack_int4_weights(params, labels),
             digital_int4_config(AnalogConfig(weight_bits=4)))):
        pc = _to(p, cuda)
        routes = {"cpu": [], "cuda": []}
        calls = []
        for where, q, dev, ex in (("cpu", p, cpu, extra),
                                  ("cuda", pc, cuda, extra_c)):
            with routes_recorded(torch, routes[where]), (
                    sites_recorded(calls) if where == "cuda"
                    else contextlib.nullcontext()):
                prefill(q, cfg, acfg, prompt.to(dev),
                        pre + prompt.shape[1], ex)
        check(len(routes["cpu"]) == len(routes["cuda"]) == moe_layers(cfg),
              f"reduced {arch}: {len(routes['cuda'])} routed layers")
        moved = 0
        k = cfg.top_k
        for (ids_h, probs), (ids_c, _) in zip(routes["cpu"], routes["cuda"]):
            diff = (ids_h.sort(-1).values != ids_c.sort(-1).values).any(-1)
            if bool(diff.any()):
                top = probs.sort(-1, descending=True).values
                gap = (top[..., k - 1] - top[..., k])[diff]
                check(bool((gap <= ROUTE_TIE).all()), f"reduced {arch} "
                      f"{deploy}: a routing id moved away from a near-tie")
            moved += int(diff.sum())
        flips = elements = 0
        with torch.no_grad():
            for q, x, y in calls:
                qh = _to(q, cpu)
                yh, _ = analog_linear(qh, x.cpu(), acfg, AnalogCtx())
                elements += yh.numel()
                if acfg.mode == "analog":
                    flips += adc_mismatches(torch, qh, x.cpu(), y.cpu(), yh,
                                            acfg, f"reduced {arch} site")
                else:
                    check(bool(((y.cpu() - yh).abs() <= 1e-4 * (
                        1 + yh.abs())).all()), f"reduced {arch} "
                          f"digital_int4: a site apart")
        want_sites = mvm_sites(cfg) + (1 if extra is not None else 0)
        check(len(calls) == want_sites, f"reduced {arch}: {len(calls)} "
              f"sites recorded, expected {want_sites}")
        th = generate(p, cfg, acfg, None, prompt, 6, greedy_first=6,
                      extra_inputs=extra)
        tc = generate(pc, cfg, acfg, None, prompt.to(cuda), 6,
                      greedy_first=6, extra_inputs=extra_c).cpu()
        equal = bool(torch.equal(th, tc))
        check(equal or moved > 0, f"reduced {arch} {deploy}: greedy tokens "
              f"differ card vs cpu with no route moved")
        out[deploy] = {"routes_moved": moved, "site_flips": flips,
                       "site_elements": elements, "tokens_equal": equal}
        print(f"  reduced {arch} {deploy}, card vs cpu: "
              + (f"routing ids equal but {moved} near-tie tokens of "
                 f"{moe_layers(cfg)} x {prompt.shape[0] * prompt.shape[1]}; "
                 if moe_layers(cfg) else "")
              + f"{len(calls)} sites on the card's inputs, "
              f"{flips} of {elements} outputs one ADC level apart at "
              f"near-ties; greedy tokens "
              f"{'equal' if equal else 'differ (a route moved)'}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the hybrid, vlm and audio families at full width
# ---------------------------------------------------------------------------

def phase_families(torch) -> dict:
    """jamba-v0.1-52b at full width and one super-block (random weights
    from a seed, built and deployed once per run: one copy of its 53 GB
    fits the card, a second does not): the static engine under
    ``analog_hw`` (fused against unfused) and ``digital_int4`` (against
    ``digital_rtn4``), as phases 3 and 4, every forward 33 MVM launches
    (each expert site one launch of all 16 experts) and every prefill 7
    ``ssd_scan`` launches; the continuous engine on the bf16 paged pool
    under ``analog_hw``, as phase 8, every decode forward 33 MVM launches
    and 1 paged decode, every chunk forward 33, 7 scans and 1 paged
    prefill. The expert launches' rows and the engine's attention heads
    must be those phases 2 and 5 hold. Then internvl2-2b (256 random patch
    embeddings ahead of each prompt) and musicgen-medium (4 codebooks) at
    full width on the static engine under both deployments."""
    out = {}
    seen = {}
    for arch in FAMILY_ARCHS:
        for key, deploy, base in (("analog", "analog_hw", "analog_hw"),
                                  ("int4", "digital_int4", "digital_rtn4")):
            seen[f"static/{arch}/{deploy}"] = rows = set()
            with expert_rows(rows):
                out[f"{arch}/{key}"] = serve_phase(torch, deploy, base, arch)
            torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, labels = full_width(torch, JAMBA)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, PAGED_BS)
    check(heads == JAMBA_PAGED, f"{JAMBA}: the engine's paged heads "
          f"{heads}, phase 5 holds the kernels at {JAMBA_PAGED}")
    check(mvm_sites(cfg) == JAMBA_MVM_PER_FORWARD
          and mixer_layers(cfg) == JAMBA_MIXERS and attn_layers(cfg) == 1,
          f"{JAMBA}: {mvm_sites(cfg)} sites, {mixer_layers(cfg)} mixers")
    seen[f"continuous/{JAMBA}/analog_hw"] = rows = set()
    with expert_rows(rows):
        out["engine"] = engine_phase(torch, cfg, params, labels, "analog_hw",
                                     0, inplace=True)
    out["engine"]["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    static = {JAMBA_ROWS["static prefill"], JAMBA_ROWS["static decode"]}
    engine = {JAMBA_ROWS["engine decode"], JAMBA_ROWS["engine chunk"]}
    for path, rows in seen.items():
        want = (set() if JAMBA not in path
                else static if path.startswith("static") else engine)
        check(rows == want, f"{path}: expert launches of {sorted(rows)} "
              f"rows, phase 2 holds the kernels at {sorted(want)}")
    out["expert_rows"] = {k: sorted(v) for k, v in seen.items() if v}
    print(f"  {JAMBA}: expert launches' rows {out['expert_rows']}; peaks "
          + ", ".join(f"{k} {v['peak_gb']:.2f} GB" for k, v in out.items()
                      if isinstance(v, dict) and "peak_gb" in v))
    return out


# ---------------------------------------------------------------------------
# phase 19: the per-tile device model
# ---------------------------------------------------------------------------

def attach_chip(torch, params: dict, labels: dict, age_h: float) -> dict:
    """``params`` with per-tile device state (``DeviceConfig`` defaults and
    DEVICE_FAULTS, drawn on a CPU generator from DEVICE_SEED, so the same
    chip on the card and on the CPU) aged ``age_h`` hours."""
    from repro_torch.core import devices

    chip = devices.attach_device_state(
        params, labels, torch.Generator().manual_seed(DEVICE_SEED),
        devices.DeviceConfig(**DEVICE_FAULTS))
    return devices.advance(chip, age_h)


def chip_leaves(params: dict, prefix: str = "") -> dict:
    """Every device-state leaf of ``params`` by its path."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(chip_leaves(v, f"{prefix}{k}/"))
        elif "/device/" in f"/{prefix}":
            out[prefix + k] = v
    return out


@contextlib.contextmanager
def col_off_counted(seen: dict):
    """Inside the block every ``analog_matmul`` call adds one to
    ``seen["col_off"]`` when it carries a column offset, else to
    ``seen["plain"]``; a replayed engine step graph adds what its capture
    counted (``serve.graphs.counting``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.serve import graphs

    real = dispatch.analog_matmul

    def call(x, w, beta, bound=None, col_off=None, **k):
        key = "plain" if col_off is None else "col_off"
        seen[key] = seen.get(key, 0) + 1
        return real(x, w, beta, bound, col_off, **k)

    dispatch.analog_matmul = call
    try:
        with graphs.counting(seen):
            yield
    finally:
        dispatch.analog_matmul = real


@contextlib.contextmanager
def recal_recorded(log: list):
    """Inside the block every recalibration appends the mean tile scale
    error before and after it to ``log``."""
    from repro_torch.core import devices

    real = devices.recalibrate

    def spy(params, gen):
        before = devices.health(params)["mean_scale_err"]
        out = real(params, gen)
        log.append((before, devices.health(params)["mean_scale_err"]))
        return out

    devices.recalibrate = spy
    try:
        yield
    finally:
        devices.recalibrate = real


def devices_graph_check(torch, cfg, params, acfg, scfg) -> dict:
    """The engine's 8-slot decode forward on an ageing chip, captured as a
    CUDA graph once, then replayed as is, after an ``advance`` and after a
    ``recalibrate``: each replay's logits equal the eager forward's at the
    same state bit for bit (the clock and the recalibration write into the
    leaves the graph reads)."""
    from repro_torch.core import devices
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.scheduler import Request, ServeEngine

    eng = ServeEngine(params, cfg, acfg, scfg)
    rng = np.random.default_rng(17)
    for i in range(ENGINE_SLOTS):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 64).astype(np.int32), max_new=32,
            temperature=0.0))
    while any(s is None or s.prefilling for s in eng.slots):
        eng.step()
    eng._refresh_device_state()
    d = eng._dev

    def step():
        return serve_step(params, cfg, acfg, d["toks"][:, None], eng.caches,
                          d["off"][:, None], seq_mask=d["active"][:, None])[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    res = {}
    for tick in ("captured", "advance", "recalibrate"):
        if tick == "advance":
            devices.advance(params, 24.0)
        elif tick == "recalibrate":
            devices.recalibrate(params, torch.Generator().manual_seed(3))
        graph.replay()
        replayed = out.clone()
        eager = step()
        check(torch.equal(replayed, eager), f"devices graph: the replay "
              f"after {tick} differs from the eager forward")
        res[tick] = float(replayed.abs().max())
    del graph, eng
    print("  8-slot decode forward on an ageing chip as a CUDA graph: replay "
          "equals the eager forward bit for bit as captured, after a 24 h "
          "advance and after a recalibration")
    return res


@contextlib.contextmanager
def device_sites_recorded(log: list):
    """:func:`sites_recorded` with each call's device clock and calibration
    (``t``, ``t_prog``, ``gain``, ``off``) copied at the call, since the
    engine moves them in place afterwards."""
    def spy(p, x, acfg, ctx):
        y, stats = real(p, x, acfg, ctx)
        snap = None
        if "device" in p:
            snap = {k: p["device"][k].clone()
                    for k in ("t", "t_prog", "gain", "off")}
        log.append((p, x, y, snap))
        return y, stats

    with sites_replaced(spy) as real:
        yield


def reduced_devices_check(torch, arch: str) -> dict:
    """The reduced ``arch`` served by the continuous engine on an ageing
    chip, on the card (the kernels) and on the CPU (their plain versions):
    the same hw-programmed weights, the same chip (:func:`attach_chip`:
    one seed on a CPU generator) and greedy requests, the drift clock on
    and the watchdog tripping. Gates, phase 16's causal rule: the same
    schedule, health reads and recalibrations on both; every site call of
    the card replayed on the CPU from its input and its device state at
    that call within the ADC contract; up to the first site output that
    differs between the runs (the origin) every site input within
    SITE_INPUT_TOL; a routing id moved only at a router near-tie or after
    the origin; a differing token only after an origin."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import (AnalogConfig, AnalogCtx,
                                         analog_linear,
                                         perturb_analog_weights)
    from repro_torch.models import build
    from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                             ServeEngine, required_max_len)

    cfg, params, labels = build(get_config(arch).reduce(), 0, device="cpu")
    hw = perturb_analog_weights(params, labels,
                                torch.Generator().manual_seed(1), "hw")
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 5 + 3 * i
                                               ).astype(np.int32),
                    max_new=8, temperature=0.0) for i in range(4)]
    scfg = SchedulerConfig(
        num_slots=2, prefill_chunk=8, paged=cfg.family != "ssm",
        kv_block_size=4, drift_dt=DEVICE_ENGINE_H / 16, recalibrate=True,
        recal_interval=4, recal_threshold=0.1,
        max_len=max(required_max_len(len(r.prompt), r.max_new, 8)
                    for r in reqs))
    runs = {}
    for where in ("cpu", "cuda"):
        chip = attach_chip(torch, hw, labels, 0.0)
        if where == "cuda":
            chip = _to(chip, torch.device("cuda"))
        calls, routes = [], []
        eng = ServeEngine(chip, cfg, acfg, scfg)
        # every site call is recorded in Python: eager step bodies
        eng._eager = True
        with device_sites_recorded(calls), routes_recorded(torch, routes,
                                                            calls):
            out = eng.run(reqs)
        runs[where] = (out, calls, routes, eng)
    (out_h, calls_h, routes_h, eng_h), (out_c, calls_c, routes_c, eng_c) = (
        runs["cpu"], runs["cuda"])
    what = f"reduced {arch} on an ageing chip"
    sched = ("decode_steps", "prefill_forwards", "watchdog_checks",
             "recal_count", "drift_hours")
    check(all(getattr(eng_h, k) == getattr(eng_c, k) for k in sched)
          and eng_c.recal_count >= 1 and len(calls_h) == len(calls_c)
          and len(routes_h) == len(routes_c),
          f"{what}: card and cpu ran other schedules: "
          + str({k: (getattr(eng_h, k), getattr(eng_c, k)) for k in sched}))
    cpu = torch.device("cpu")
    flips = elements = 0
    origin = None
    with torch.no_grad():
        for i, ((p, x, y, snap), (_, xh, yh_run, _)) in enumerate(
                zip(calls_c, calls_h)):
            q = _to(p, cpu)
            if snap is not None:
                q["device"].update(_to(snap, cpu))
            xc = x.cpu()
            yh, _ = analog_linear(q, xc, acfg, AnalogCtx())
            elements += yh.numel()
            flips += adc_mismatches(torch, q, xc, y.cpu(), yh, acfg,
                                    f"{what}: site call {i}")
            if origin is None:
                check(bool(((xc - xh).abs()
                            <= SITE_INPUT_TOL * (1 + xh.abs())).all()),
                      f"{what}: site call {i}'s input apart before any "
                      f"site output was")
                if not torch.equal(y.cpu(), yh_run):
                    origin = i
    moved = 0
    k = cfg.top_k
    for (ids_h, probs, n_h), (ids_c, _, _) in zip(routes_h, routes_c):
        diff = (ids_h.sort(-1).values != ids_c.sort(-1).values).any(-1)
        if bool(diff.any()):
            top = probs.sort(-1, descending=True).values
            gap = (top[..., k - 1] - top[..., k])[diff]
            check(bool((gap <= ROUTE_TIE).all())
                  or (origin is not None and n_h > origin),
                  f"{what}: a routing id moved away from a near-tie before "
                  f"any site output apart")
            moved += int(diff.sum())
    equal = all(np.array_equal(out_h[r.uid], out_c[r.uid]) for r in reqs)
    check(equal or origin is not None, f"{what}: greedy tokens differ card "
          f"vs cpu with no site output apart")
    check(all(len(out_c[r.uid]) == r.max_new for r in reqs),
          f"{what}: a request did not complete")
    res = {"recal_count": eng_c.recal_count,
           "watchdog_checks": eng_c.watchdog_checks,
           "site_calls": len(calls_c), "site_flips": flips,
           "site_elements": elements, "origin": origin,
           "routes_moved": moved, "tokens_equal": equal}
    print(f"  {what}, card vs cpu: {eng_c.drift_hours:.0f} h, "
          f"{eng_c.watchdog_checks} watchdog checks and {eng_c.recal_count} "
          f"recalibrations on both; {len(calls_c)} site calls on the card's "
          f"inputs, {flips} of {elements} outputs one ADC level apart at "
          f"near-ties; first site output apart "
          f"{'none' if origin is None else f'at call {origin}'}, "
          f"{moved} routing ids moved; greedy tokens "
          f"{'equal' if equal else 'differ after it'}")
    return res


def phase_devices(torch, static_pristine: dict,
                  engine_pristine: dict) -> dict:
    """Phase 19: full-width llama-3.2-1b on an ageing, faulty chip. (a) The
    static engine, ``analog_hw`` fused against unfused on a DEVICE_AGE_H
    old chip (phase 3's gates; 65 launches per forward, each with
    ``col_off``). (b) Phase 8's 16 requests on the bf16 pool with the
    drift clock spanning about DEVICE_ENGINE_H hours and the watchdog
    reprogramming in place; then its decode and chunk forward times with
    device state, beside phase 8's without it. (c) The 8-slot decode
    forward's CUDA graph replayed after a tick and after a recalibration.
    (d) The reduced dense, ssm, moe and hybrid models on the engine with
    drift and recalibration, card against cpu. The times are printed
    beside phases 3's and 8's on the pristine chip
    (``static_pristine``, ``engine_pristine``)."""
    out = {"static": serve_phase(torch, "analog_hw", "analog_hw", chip=True)}
    cfg, params, labels = full_width(torch, ARCH)
    out["engine"] = engine_phase(torch, cfg, params, labels, "analog_hw", 0,
                                 inplace=True, chip=True, ab=True)
    del params
    torch.cuda.empty_cache()
    for what, aged, pristine, keys in (
            ("static engine", out["static"], static_pristine,
             ("tokens_per_s", "prefill_ms", "prefill_device_ms", "decode_ms",
              "decode_device_ms", "device_busy", "peak_gb")),
            ("continuous engine", out["engine"], engine_pristine,
             ("tokens_per_s", "decode_step_ms", "decode_device_ms",
              "chunk_forward_ms", "chunk_device_ms", "device_busy",
              "chunk_busy", "peak_gb"))):
        print(f"  {ARCH} {what}, ageing chip (pristine): "
              + ", ".join(f"{k} {aged[k]:.3f} ({pristine[k]:.3f})"
                          for k in keys))
    out["reduced"] = {arch: reduced_devices_check(torch, arch)
                      for arch in DEVICE_REDUCED}
    return out


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------

#: the run whose times each kernel's entry reports: llama-3.2-1b's static
#: engine (phases 3 and 4) or continuous engine analog_hw run on the bf16
#: pool (phase 8), or mamba2-130m's continuous analog_hw run (phase 8)

# ---------------------------------------------------------------------------
# phase 20: the radix prefix cache, the state-snapshot pool, fork-aware
# best-of-n
# ---------------------------------------------------------------------------

def prefix_requests(cfg) -> list:
    """Phase 20's workload: PREFIX_GROUPS system prompts (from a seed),
    PREFIX_PER_GROUP requests each, interleaved across the groups so that
    later requests of a group can hit the blocks of earlier ones."""
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(20)
    systems = [rng.integers(0, cfg.vocab_size, PREFIX_SYSTEM)
               for _ in range(PREFIX_GROUPS)]
    reqs = []
    for j in range(PREFIX_PER_GROUP):
        for g in range(PREFIX_GROUPS):
            lo, hi = PREFIX_SUFFIX_CHUNKS
            suffix = rng.integers(0, cfg.vocab_size, ENGINE_CHUNK * int(
                rng.integers(lo, hi + 1)))
            reqs.append(Request(
                uid=len(reqs), prompt=np.concatenate([systems[g], suffix])
                .astype(np.int32), max_new=int(rng.integers(
                    PREFIX_NEW[0], PREFIX_NEW[1] + 1)), temperature=0.0))
    return reqs


def spec_requests(cfg) -> list:
    """Phase 21's workload (and phase 22's speculative one): the first
    SPEC_PER_GROUP requests of each group of phase 20's, the same prompts
    and budgets."""
    return prefix_requests(cfg)[:PREFIX_GROUPS * SPEC_PER_GROUP]


def leaf_ptrs(eng) -> dict:
    """The storage pointer of every cache leaf the prefix cache writes (all
    but the ``pos`` cursors, which each decode step returns anew)."""
    from repro_torch.serve.scheduler import _walk

    return {i: leaf.data_ptr() for i, (leaf, kind) in enumerate(
        _walk(eng.caches, eng._kinds)) if kind != "pos"}


def indexed_rows(torch, index: dict, leaves: list):
    """``(key -> slot, slots, [(leaf, axis, its rows of those slots)])``
    of a pool's index now."""
    slots = sorted(set(index.values()))
    rows = [(leaf, ax, leaf.index_select(ax, torch.as_tensor(
        slots, device=leaf.device)).clone()) for leaf, ax in leaves]
    return dict(index), slots, rows


def rows_kept(torch, index: dict, kept) -> bool:
    """Every slot still indexed under the key it had when ``kept`` was
    taken holds the same bytes (an evicted slot may be reused)."""
    before, slots, rows = kept
    same = sorted({s for k, s in before.items() if index.get(k) == s})
    for leaf, ax, old in rows:
        pos = torch.as_tensor([slots.index(s) for s in same],
                              device=leaf.device)
        idx = torch.as_tensor(same, device=leaf.device)
        if not torch.equal(leaf.index_select(ax, idx),
                           old.index_select(ax, pos)):
            return False
    return True


def cache_leaves(eng, kind: str) -> list:
    """``(leaf, axis)`` of every cache leaf of ``kind``: "pool", the paged
    KV pools, by their block axis 1; "spool", the snapshot pools, by their
    snapshot axis (the sibling state leaf's slot axis)."""
    from repro_torch.serve.scheduler import _walk

    if kind == "spool":
        return [(snap, ax) for _, snap, ax in eng._snapshot_leaves()]
    return [(leaf, 1) for leaf, k in _walk(eng.caches, eng._kinds)
            if k == kind]


def prefix_run(torch, eng, reqs, tag: str, mvm: str) -> dict:
    """Serve ``reqs`` on ``eng`` (every launch count set to 0 right before,
    read right after): every request must finish with its budget, and each
    kernel must have launched as the engine's counters say."""
    cfg = eng.cfg
    before = {k: getattr(eng, k) for k in PREFIX_COUNTERS}
    zero_counts(torch)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    d = {k: getattr(eng, k) - before[k] for k in PREFIX_COUNTERS}
    for r in reqs:
        out = results[r.uid]
        check(eng.status[r.uid] == "finished" and len(out) == r.max_new
              and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"{tag}: request {r.uid} ended {eng.status[r.uid]} with "
              f"{len(out)}/{r.max_new} tokens")
    want = {mvm: mvm_sites(cfg) * (d["decode_steps"]
                                   + d["prefill_forwards"]),
            "ssd_scan": mixer_layers(cfg) * d["prefill_forwards"],
            "paged_flash_decode": attn_layers(cfg) * d["decode_steps"],
            "paged_flash_prefill": attn_layers(cfg) * d["prefill_forwards"]}
    want = {k: v for k, v in want.items() if v}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    tokens = sum(r.max_new for r in reqs)
    ttft = [eng.first_token_at[r.uid] - eng.submit_time[r.uid]
            for r in reqs]
    res = {"run_s": run_s, "tokens": tokens, "tokens_per_s": tokens / run_s,
           "ttft_ms": 1e3 * float(np.mean(ttft)), "launches": launches,
           **d, "out": {r.uid: results[r.uid] for r in reqs}}
    print(f"  {tag}: {tokens} tokens in {run_s:.2f} s ("
          f"{res['tokens_per_s']:.1f} tok/s), {d['decode_steps']} decode / "
          f"{d['prefill_forwards']} chunk forwards ({d['prefill_chunks']} "
          f"chunks), mean TTFT {res['ttft_ms']:.1f} ms; prefix hits "
          f"{d['prefix_hits']}/{d['prefix_lookups']}, "
          f"{d['prefix_skipped_tokens']} prefill tokens skipped, "
          f"{d['prefix_cow_copies']} tail copies, snapshots "
          f"{d['state_snaps_captured']} captured / "
          f"{d['state_snap_restores']} restored; launches {launches}")
    return res


def same_tokens(a: dict, b: dict, shift: int, what: str) -> None:
    """Every request's tokens in ``a`` (uids + ``shift``) equal ``b``'s."""
    bad = [u for u in b if not np.array_equal(a[u + shift], b[u])]
    check(not bad, f"{what}: greedy tokens differ for requests {bad}")


def prefix_engine(torch, cfg, p, acfg, tag: str, mvm: str) -> dict:
    """Phase 20 (a) / (b) for one model and deployment: cold (no cache),
    then prime and warm on one engine with the cache. Gates: prime and
    warm tokens equal cold bit for bit; the prime pass hits on every
    request admitted after the first ENGINE_SLOTS (blocks or snapshots
    its group-mates registered); the warm pass hits on every request, a KV family skipping each padded prompt but its last chunk;
    the pools conserved; no indexed block or snapshot rewritten; every
    cache leaf kept (the cache writes in place); each kernel launched as
    the engine's counters say."""
    from repro_torch.serve.scheduler import (SchedulerConfig, ServeEngine,
                                             padded_prompt_len,
                                             required_max_len)

    reqs = prefix_requests(cfg)
    max_len = max(required_max_len(len(r.prompt), r.max_new, ENGINE_CHUNK)
                  for r in reqs)
    # room for every prompt block beside the slots' worst case, so the
    # warm pass finds the whole workload cached
    prompt_blocks = sum(-(-padded_prompt_len(len(r.prompt), ENGINE_CHUNK)
                          // PAGED_BS) for r in reqs)
    width = -(-max_len // PAGED_BS)
    scfg = SchedulerConfig(num_slots=ENGINE_SLOTS, max_len=max_len,
                           prefill_chunk=ENGINE_CHUNK,
                           cache_dtype=torch.bfloat16, paged=True,
                           kv_block_size=PAGED_BS,
                           kv_blocks=ENGINE_SLOTS * width + prompt_blocks,
                           prefix_cache=False)
    eng = ServeEngine(p, cfg, acfg, scfg)
    cold = prefix_run(torch, eng, reqs, f"{tag} cold", mvm)
    del eng
    eng = ServeEngine(p, cfg, acfg, dataclasses.replace(scfg,
                                                        prefix_cache=True))
    check(eng.prefix_enabled, f"{tag}: prefix cache off")
    ptrs = leaf_ptrs(eng)
    prime = prefix_run(torch, eng, reqs, f"{tag} prime", mvm)
    kept = [(pool, indexed_rows(torch, pool._index, cache_leaves(eng, kind)))
            for pool, kind in ((eng.pool, "pool"), (eng.state_pool, "spool"))
            if pool is not None]
    warm_reqs = [dataclasses.replace(r, uid=r.uid + PREFIX_WARM_UID)
                 for r in reqs]
    warm = prefix_run(torch, eng, warm_reqs, f"{tag} warm", mvm)
    same_tokens(prime["out"], cold["out"], 0, f"{tag}: prime against cold")
    same_tokens(warm["out"], cold["out"], PREFIX_WARM_UID,
                f"{tag}: warm against cold")
    n = len(reqs)
    # live sharing: the requests past the first ENGINE_SLOTS are admitted
    # after their group-mates' prefills registered the system prompt
    late = n - ENGINE_SLOTS
    check(late > 0 and prime["prefix_hits"] >= late
          and prime["prefix_skipped_tokens"] >= late * PREFIX_SYSTEM
          and (eng.pool is not None or prime["state_snap_restores"] >= late),
          f"{tag}: the prime pass hit {prime['prefix_hits']} of "
          f"{prime['prefix_lookups']} requests, skipped "
          f"{prime['prefix_skipped_tokens']} prompt tokens, restored "
          f"{prime['state_snap_restores']} snapshots (at least {late} "
          f"requests admitted after the first {ENGINE_SLOTS} must hit)")
    check(warm["prefix_lookups"] == warm["prefix_hits"] == n,
          f"{tag}: the warm pass hit {warm['prefix_hits']} of "
          f"{warm['prefix_lookups']} requests")
    skip = sum(padded_prompt_len(len(r.prompt), ENGINE_CHUNK) - ENGINE_CHUNK
               for r in reqs)
    if eng.pool is not None:
        check(warm["prefix_skipped_tokens"] == skip,
              f"{tag}: warm skipped {warm['prefix_skipped_tokens']} of "
              f"{skip} prompt tokens")
    else:
        check(warm["state_snap_restores"] >= n
              and warm["launches"]["ssd_scan"] < cold["launches"]["ssd_scan"],
              f"{tag}: {warm['state_snap_restores']} snapshot restores, "
              f"ssd_scan {warm['launches']['ssd_scan']} warm against "
              f"{cold['launches']['ssd_scan']} cold")
    check(all(rows_kept(torch, pool._index, k) for pool, k in kept),
          f"{tag}: an indexed block or snapshot was rewritten")
    check(leaf_ptrs(eng) == ptrs,
          f"{tag}: a cache leaf was replaced, not written")
    pools = {}
    for name, pool in (("kv", eng.pool), ("snapshots", eng.state_pool)):
        if pool is None:
            continue
        check(pool.num_live == 0
              and pool.num_free + pool.num_cached == pool.num_blocks,
              f"{tag}: {name} pool not conserved ({pool.num_live} live, "
              f"{pool.num_free} free, {pool.num_cached} cached of "
              f"{pool.num_blocks})")
        pools[name] = {"blocks": pool.num_blocks, "cached": pool.num_cached,
                       "evictions": pool.evictions}
    snap_gb = sum(leaf.numel() * leaf.element_size()
                  for leaf, _ in cache_leaves(eng, "spool")) / 1e9
    pool_gb = sum(leaf.numel() * leaf.element_size()
                  for leaf, _ in cache_leaves(eng, "pool")) / 1e9
    print(f"  {tag}: prime and warm equal cold bit for bit; prime hit "
          f"{prime['prefix_hits']}/{n} ({prime['prefix_skipped_tokens']} "
          f"prompt tokens skipped), warm hit {n}/{n}; chunk forwards {cold['prefill_forwards']} cold, "
          f"{warm['prefill_forwards']} warm; mean TTFT "
          f"{cold['ttft_ms']:.1f} -> {warm['ttft_ms']:.1f} ms; tokens/s "
          f"{cold['tokens_per_s']:.1f} / {prime['tokens_per_s']:.1f} / "
          f"{warm['tokens_per_s']:.1f} (cold / prime / warm); KV pool "
          f"{pool_gb:.2f} GB, snapshot pool {snap_gb:.2f} GB; pools {pools}")
    out = {"pools": pools, "snapshot_gb": snap_gb, "kv_pool_gb": pool_gb,
           "tokens": {u: v.tolist() for u, v in cold["out"].items()}}
    for name, r in (("cold", cold), ("prime", prime), ("warm", warm)):
        out[name] = {k: v for k, v in r.items() if k != "out"}
    del eng
    torch.cuda.empty_cache()
    return out


def reduced_prefix_check(torch, arch: str) -> dict:
    """Phase 20 (c): the reduced ``arch`` (analog_hw, fused) with the cache
    on, on the card (the kernels) and on the CPU (their plain versions),
    the same weights. Each case gives equal greedy tokens on both and warm
    equal to cold: a partial tail (block 48, chunk 32, a 64-token prompt:
    one full block and a 16-token tail, copied on write where the family
    has KV and takes tails), eviction under an undersized pool (KV, or the
    snapshot pool on an ssm stack), and fork-aware ``sample_candidates``
    against the independent path (sampled, on each device; greedy, card
    against CPU). The fork case runs a model with experts at the no-drop
    capacity of the reference's fork test: its independent path serves the
    contiguous cache, and with capacity drops the contiguous and paged
    layouts may route a token apart, fork or no fork."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig, perturb_analog_weights
    from repro_torch.models import build
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                             ServeEngine)

    cfg, params, labels = build(get_config(arch).reduce(), 0, device="cpu")
    hw = perturb_analog_weights(params, labels,
                                torch.Generator().manual_seed(1), "hw")
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    devs = {"cpu": hw, "cuda": _to(hw, torch.device("cuda"))}
    rng = np.random.default_rng(21)
    kv = cfg.family != "ssm"

    def serve(scfg, runs):
        out = {}
        for where, p in devs.items():
            eng = ServeEngine(p, cfg, acfg, scfg)
            res = {}
            for reqs in runs:
                res.update(eng.run(reqs))
            out[where] = (res, eng)
        bad = [u for u in out["cpu"][0]
               if not np.array_equal(out["cpu"][0][u], out["cuda"][0][u])]
        check(not bad, f"reduced {arch} prefix: card and cpu differ for "
              f"requests {bad}")
        return out["cuda"]

    res = {}
    # (1) the partial tail
    p64 = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    geo = dict(num_slots=2, max_len=72, prefill_chunk=32, paged=True,
               kv_block_size=48)
    first = [Request(uid=0, prompt=p64, max_new=6, temperature=0.0)]
    again = [Request(uid=1, prompt=p64, max_new=6, temperature=0.0)]
    cold, _ = serve(SchedulerConfig(prefix_cache=False, **geo), [first])
    warm, eng = serve(SchedulerConfig(**geo), [first, again])
    check(np.array_equal(warm[0], cold[0]) and np.array_equal(warm[1],
                                                              cold[0]),
          f"reduced {arch} tail: warm differs from cold")
    cow = cfg.family in ("dense", "moe")
    check(eng.prefix_cow_copies == (1 if cow else 0)
          and eng.prefix_skipped_tokens == (32 if cow else 0),
          f"reduced {arch} tail: {eng.prefix_cow_copies} copies, "
          f"{eng.prefix_skipped_tokens} tokens skipped")
    res["tail"] = {"cow_copies": eng.prefix_cow_copies,
                   "skipped": eng.prefix_skipped_tokens}
    # (2) eviction under pressure: 3 blocks a request, 2 slots, 7 blocks
    # (or 3 snapshot slots), so retained prompts must be evicted
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, 16).astype(np.int32), max_new=4,
        temperature=0.0) for i in range(5)]
    geo = dict(num_slots=2, max_len=24, prefill_chunk=8, paged=True,
               kv_block_size=8)
    roomy, _ = serve(SchedulerConfig(prefix_cache=False, **geo), [reqs])
    tight = (dict(kv_blocks=7) if kv else dict(state_snapshots=3))
    got, eng = serve(SchedulerConfig(**geo, **tight), [reqs])
    pool = eng.pool if kv else eng.state_pool
    check(all(np.array_equal(got[u], roomy[u]) for u in roomy)
          and pool.evictions > 0 and pool.num_live == 0
          and pool.num_free + pool.num_cached == pool.num_blocks,
          f"reduced {arch} eviction: {pool.evictions} evictions, tokens "
          f"or blocks apart")
    res["evictions"] = pool.evictions
    # (3) fork-aware best-of-n: sampled fork == independent on each device,
    # greedy fork card == cpu
    prompts = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    fork = E.BestOfNConfig(temperature=0.9, top_k=13, max_new=3,
                           num_slots=4, prefill_chunk=4, kv_block_size=4)
    indep = dataclasses.replace(fork, paged=False, prefix_cache=False)
    greedy = {}
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    for where, p in devs.items():
        a, b = (E.sample_candidates(p, cfg, acfg,
                                    torch.Generator().manual_seed(5),
                                    prompts, 3, c) for c in (fork, indep))
        check(np.array_equal(a, b), f"reduced {arch} best-of-n on {where}: "
              f"fork {a.tolist()} against independent {b.tolist()}")
        greedy[where] = E.sample_candidates(
            p, cfg, acfg, torch.Generator().manual_seed(5), prompts, 3,
            dataclasses.replace(fork, greedy_first=fork.max_new))
    check(np.array_equal(greedy["cpu"], greedy["cuda"]),
          f"reduced {arch} greedy best-of-n: card and cpu differ")
    print(f"  reduced {arch} prefix cache, card against cpu: equal tokens, "
          f"warm equal cold; tail case {res['tail']}; {res['evictions']} "
          f"evictions under pressure; fork-aware best-of-n equal to the "
          f"independent path on both")
    return res


def phase_prefix(torch) -> dict:
    """Phase 20: (a) full-width llama-3.2-1b at PREFIX_LAYERS of its
    layers, analog_hw on the kernels, on the bf16 pool (cold / prime /
    warm) and the int8 pool; (b) full-width mamba2-130m at PREFIX_LAYERS
    of its layers, analog_hw, on the snapshot pool (``paged=True``, inert
    for KV); (c) the reduced models, card against CPU."""
    from repro_torch.launch.serve import deploy_model

    from repro_torch.models import build

    dev = torch.device("cuda")
    print(f"  phase 20's numbers on {gpu_name_and_power()}")
    out = {}
    for arch in (ARCH, MAMBA):
        cfg, params, labels = (
            full_width(torch, arch, layers=PREFIX_LAYERS[arch])
            if arch == ARCH else build(dataclasses.replace(
                model_config(arch), num_layers=PREFIX_LAYERS[arch]),
                torch.Generator(device=dev).manual_seed(0), device=dev))
        gen = torch.Generator(device="cuda").manual_seed(7)
        p, acfg = deploy_model(_deploy_args("analog_hw"), cfg, params,
                               labels, gen, inplace=True)
        acfg = dataclasses.replace(acfg, use_pallas=True)
        pools = (0, 8) if arch == ARCH else (0,)
        for kv_bits in pools:
            key = f"{arch}/kv{kv_bits or 16}" if arch == ARCH else arch
            out[key] = prefix_engine(
                torch, cfg, p, dataclasses.replace(acfg, kv_bits=kv_bits),
                f"{cfg.name} analog_hw"
                + (f" kv_bits={kv_bits}" if arch == ARCH else ""),
                "analog_matmul")
        del p, params
        torch.cuda.empty_cache()
    out["reduced"] = {arch: reduced_prefix_check(torch, arch)
                      for arch in PREFIX_REDUCED}
    return out

# ---------------------------------------------------------------------------
# phase 21: speculative decoding
# ---------------------------------------------------------------------------

#: uid offset of the requests that prime a phase-21 engine's prefix cache
SPEC_PRIME_UID = 2000


@contextlib.contextmanager
def mvm_rows(seen: dict):
    """Inside the block the shape ``(M, K, N)`` of every 2-D MVM launch is
    added to ``seen[kernel name]``."""
    from repro_torch.kernels import dispatch

    names = ("analog_matmul", "int4_matmul")
    real = {n: getattr(dispatch, n) for n in names}

    def wrap(name):
        def call(x, w, *a, **k):
            if x.dim() == 2:
                n = w.shape[-1] * (2 if name == "int4_matmul" else 1)
                seen.setdefault(name, set()).add(
                    (int(x.shape[0]), int(x.shape[1]), int(n)))
            return real[name](x, w, *a, **k)
        return call

    for n in names:
        setattr(dispatch, n, wrap(n))
    try:
        yield
    finally:
        for n in names:
            setattr(dispatch, n, real[n])


@contextlib.contextmanager
def spec_recorded(torch, eng, log: list, sites: bool):
    """Inside the block every target forward of ``eng`` that scores
    generated tokens (a decode step, a mixed step's decode substep, a
    verify window; not a prompt chunk and not the drafter) appends a
    record to ``log``: each row's uid (None: not decoding), its first
    position ``off`` and its mask [B, S], and the logits [B, S, V]
    (without ``sites``) or every analog site call's ``(p, x, y)``
    (with)."""
    from repro_torch.core import analog as A
    from repro_torch.serve import decode as D
    from repro_torch.serve import scheduler as S

    reals = {D: D.model_apply, S: S.model_apply}
    cur = {"rec": None}
    real_site = A.analog_linear

    def make(real):
        def spy(params, cfg, acfg, ctx, inputs, **kw):
            if (params is not eng.params or kw.get("last_only")
                    or kw.get("caches") is eng.draft_caches):
                return real(params, cfg, acfg, ctx, inputs, **kw)
            rec = {"uids": [s.req.uid if s is not None and not s.prefilling
                            else None for s in eng.slots],
                   "off": kw["pos_offset"].reshape(-1).clone(),
                   "mask": kw["seq_mask"].clone(), "sites": []}
            cur["rec"] = rec if sites else None
            try:
                out = real(params, cfg, acfg, ctx, inputs, **kw)
            finally:
                cur["rec"] = None
            if not sites:
                rec["logits"] = out[0].clone()
            log.append(rec)
            return out
        return spy

    def site_spy(p, x, acfg, ctx):
        y, st = real_site(p, x, acfg, ctx)
        if cur["rec"] is not None:
            cur["rec"]["sites"].append((p, x.detach().clone(),
                                        y.detach().clone()))
        return y, st

    for mod, real in reals.items():
        mod.model_apply = make(real)
    try:
        if sites:
            with sites_replaced(site_spy):
                yield
        else:
            yield
    finally:
        for mod, real in reals.items():
            mod.model_apply = real


def spec_positions(log: list) -> dict:
    """``(uid, position) -> (record, row, column)`` of the last recorded
    forward that scored the position (a window's rejected columns are
    scored again by a later one; its kept columns never are)."""
    out = {}
    for i, rec in enumerate(log):
        off = rec["off"].tolist()
        mask = rec["mask"].cpu()
        for b, uid in enumerate(rec["uids"]):
            if uid is None:
                continue
            for c in range(mask.shape[1]):
                if mask[b, c] > 0:
                    out[uid, int(off[b]) + c] = (i, b, c)
    return out


def spec_logit_tie(torch, req, t: int, base: tuple, spec: tuple,
                   what: str) -> dict:
    """The fp rule for a request whose token ``t`` parts: at the position
    that produced it, the two runs' logits differ by at most fp32 rounding
    (``SITE_INPUT_TOL * (1 + |logit|)``), and the non-speculative top-2
    gap is at most twice their largest difference."""
    q = len(req.prompt) - 1 + t
    where = []
    for log, pos in (base, spec):
        check(t >= 1 and (req.uid, q) in pos, f"{what}: request {req.uid} "
              f"parts at token {t}, which no recorded forward scored")
        i, b, c = pos[req.uid, q]
        where.append(log[i]["logits"][b, c].float())
    lb, ls = where
    d = (ls - lb).abs()
    check(bool((d <= SITE_INPUT_TOL * (1 + lb.abs())).all()),
          f"{what}: request {req.uid} token {t}: logits differ by "
          f"{float(d.max()):.3e}, beyond fp32 rounding")
    top = torch.topk(lb, 2).values
    gap = float(top[0] - top[1])
    check(gap <= 2 * float(d.max()), f"{what}: request {req.uid} token {t} "
          f"parts with a top-2 gap {gap:.3e} above twice the runs' "
          f"difference {float(d.max()):.3e}")
    return {"uid": req.uid, "token": t, "top2_gap": gap,
            "max_dlogit": float(d.max())}


@contextlib.contextmanager
def spec_self_ties(torch, ties: list):
    """Inside the block every rejected proposal of a model drafter must be
    a near-tie: for a row whose window accepts ``i < k`` drafts, the
    drafter's logits of step ``i`` (the draw ``d_{i+1}``) and the window's
    column ``i`` (the same input token at the same position) differ by at
    most fp32 rounding, ``SITE_INPUT_TOL * (1 + |logit|)``, and the
    window's top-2 gap there is at most twice their largest difference
    (greedy rows). Each rejection's gap and difference go to ``ties``.
    The check reads the drafter's logits on the host inside the window, so
    the engines run their step bodies eagerly in the block."""
    from repro_torch.serve import scheduler as S

    real_fwd, real_verify = (S.ServeEngine._draft_forward,
                             S.ServeEngine._verify_body)
    real_sv, real_run = S.speculative_verify, S.ServeEngine._run_body
    state = {"draft": [], "rows": None}

    def fwd(self, toks, off, active):
        logits = real_fwd(self, toks, off, active)
        state["draft"].append(logits)
        return logits

    def verify(self, k, key):
        state["rows"] = [b for b, s in enumerate(self.slots)
                         if s is not None and not s.prefilling]
        try:
            return real_verify(self, k, key)
        finally:
            state["draft"], state["rows"] = [], None

    def run_eager(self, key, body):
        body()

    def sv(logits, drafts, *a, **k):
        target, n_acc = real_sv(logits, drafts, *a, **k)
        kk = drafts.shape[0]
        if state["rows"] is not None and kk:
            steps = state["draft"][-(kk + 1):]
            acc = n_acc.cpu()
            for b in state["rows"]:
                i = int(acc[b])
                if i == kk:
                    continue
                ld, lv = steps[i][b].float(), logits[b, i].float()
                d = (ld - lv).abs()
                gap = torch.topk(lv, 2).values
                gap = float(gap[0] - gap[1])
                check(bool((d <= SITE_INPUT_TOL * (1 + lv.abs())).all())
                      and gap <= 2 * float(d.max()), f"a rejected proposal "
                      f"is no near-tie: top-2 gap {gap:.3e}, logits apart by "
                      f"{float(d.max()):.3e}")
                ties.append({"top2_gap": gap, "max_dlogit": float(d.max())})
        return target, n_acc

    S.ServeEngine._draft_forward, S.ServeEngine._verify_body = fwd, verify
    S.speculative_verify, S.ServeEngine._run_body = sv, run_eager
    try:
        yield
    finally:
        S.ServeEngine._draft_forward = real_fwd
        S.ServeEngine._verify_body = real_verify
        S.speculative_verify, S.ServeEngine._run_body = real_sv, real_run


def spec_site_flips(torch, p, xa, xb, ya, yb, acfg, what: str) -> int:
    """:func:`adc_mismatches` for inputs that may differ by fp32 rounding:
    each mismatch of ``ya`` against ``yb`` must be one ADC level at a
    near-tie of ``xb``'s pre-ADC value, the tie's reach the fp32 dot error
    bound plus what the two inputs' DAC codes move it,
    ``|x_qa - x_qb| . |w|``. Returns their count."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref

    qo = ref.qmax(acfg.output_bits)
    w = p["kernel"].float()
    beta = p["input_range"].reshape(()).float()
    k = w.shape[-2]
    qa, qb = (quant.input_quantize(v.float().reshape(-1, k), beta,
                                   acfg.input_bits) for v in (xa, xb))
    b = torch.clamp_min(ref.adc_bound(w, beta, acfg.out_bound), 1e-8)
    inv = ref.rdiv(qo, b) * ref.ADC_TIE_BREAK
    v = (qb @ w) * inv
    reach = (k * U32 * (qb.abs() @ w.abs()) + (qa - qb).abs() @ w.abs()) * inv
    diff = (ya - yb).reshape(v.shape).abs()
    lsb = ref.div(b, qo).expand_as(diff)
    bad = diff != 0
    n_bad = int(bad.sum())
    if n_bad:
        level = ((diff[bad] - lsb[bad]).abs() / lsb[bad]).max()
        tie = (v[bad] - torch.floor(v[bad]) - 0.5).abs()
        check(float(level) < 1e-3 and bool((tie <= reach[bad]).all()),
              f"{what} mismatch is not one ADC level at a near-tie")
    return n_bad


def spec_site_origin(torch, cfg, acfg, req, t: int, base: tuple,
                     spec: tuple, what: str) -> dict:
    """The analog_hw rule (phase 16's causal rule across the two runs) for
    a request whose token ``t`` parts: walking its generated positions up
    to the one that produced ``t``, site by site in call order, the first
    site output of the row that differs must have inputs within
    SITE_INPUT_TOL (the verify window scores attention on the prefill
    kernel, a decode step on the decode kernel) and differ only by ADC
    levels at near-ties (:func:`spec_site_flips`)."""
    n_sites = mvm_sites(cfg)
    plen = len(req.prompt)
    check(t >= 1, f"{what}: request {req.uid} parts at its first token, "
          f"which both runs score in the same prompt chunk")
    for q in range(plen, plen + t):
        recs = []
        for log, pos in (spec, base):
            check((req.uid, q) in pos, f"{what}: request {req.uid} position "
                  f"{q} not recorded")
            i, b, c = pos[req.uid, q]
            rec = log[i]
            check(len(rec["sites"]) == n_sites, f"{what}: "
                  f"{len(rec['sites'])} site calls recorded in a forward")
            recs.append((rec, b, c))
        for s in range(n_sites):
            rows = []
            for rec, b, c in recs:
                p, x, y = rec["sites"][s]
                bsz, cols = rec["mask"].shape
                rows.append((p, x.reshape(bsz, cols, -1)[b, c],
                             y.reshape(bsz, cols, -1)[b, c]))
            (p, xa, ya), (_, xb, yb) = rows
            if torch.equal(ya, yb):
                continue
            dx = (xa - xb).abs()
            check(bool((dx <= SITE_INPUT_TOL * (1 + xb.abs())).all()),
                  f"{what}: request {req.uid} position {q} site {s}: its "
                  f"inputs differ by {float(dx.max()):.3e} before any site "
                  f"output of the row did")
            flips = spec_site_flips(torch, p, xa, xb, ya, yb, acfg,
                                    f"{what}: request {req.uid} origin")
            return {"uid": req.uid, "token": t, "position": q, "site": s,
                    "flips": flips, "max_dx": float(dx.max())}
    check(False, f"{what}: request {req.uid}'s token {t} differs with no "
          f"site output of the row apart before it")


def spec_scfg(torch, reqs, draft):
    """Phase 20's engine with the prefix cache on and, for a ``draft``,
    speculative windows of SPEC_K proposals."""
    from repro_torch.serve.scheduler import (SchedulerConfig,
                                             padded_prompt_len,
                                             required_max_len)

    max_len = max(required_max_len(len(r.prompt), r.max_new, ENGINE_CHUNK)
                  for r in reqs)
    prompt_blocks = sum(-(-padded_prompt_len(len(r.prompt), ENGINE_CHUNK)
                          // PAGED_BS) for r in reqs)
    return SchedulerConfig(
        num_slots=ENGINE_SLOTS, max_len=max_len, prefill_chunk=ENGINE_CHUNK,
        cache_dtype=torch.bfloat16, paged=True, kv_block_size=PAGED_BS,
        kv_blocks=ENGINE_SLOTS * -(-max_len // PAGED_BS) + prompt_blocks,
        speculative=draft is not None, draft=draft or "int4",
        draft_k=SPEC_K)


def spec_pass(torch, eng, reqs, tag: str, mvm, seen: dict) -> dict:
    """Serve ``reqs`` on ``eng`` (every launch count set to 0 right before,
    read right after): each request finishes with its budget, and each
    kernel launched as the engine's counters say: the target's MVM kernel
    at every site of its decode steps, windows and chunks, the int4
    drafter's at every site of the drafter's forwards, the decode kernel
    at every decode step that is no window, the prefill kernel at every
    chunk forward and window."""
    from repro_torch.serve.kv_pool import RewindError

    cfg = eng.cfg
    before = {k: getattr(eng, k) for k in SPEC_COUNTERS}
    rows = {"rows": 0}
    real_commit = eng._spec_commit

    def commit(p):
        if p["k"]:
            rows["rows"] += len(p["decode_rows"])
        real_commit(p)

    eng._spec_commit = commit
    zero_counts(torch)
    t0 = time.perf_counter()
    try:
        with mvm_rows(seen):
            results = eng.run(reqs)
        torch.cuda.synchronize()
    except RewindError as e:
        check(False, f"{tag}: {e}")
    finally:
        eng._spec_commit = real_commit
    run_s = time.perf_counter() - t0
    launches = engine_launches(torch, eng, before, tag, mvm)
    d = {k: getattr(eng, k) - before[k] for k in SPEC_COUNTERS}
    for r in reqs:
        out = results[r.uid]
        check(eng.status[r.uid] == "finished" and len(out) == r.max_new
              and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"{tag}: request {r.uid} ended {eng.status[r.uid]} with "
              f"{len(out)}/{r.max_new} tokens")
    tokens = sum(r.max_new for r in reqs)
    windows = d["spec_steps"]
    res = {"run_s": run_s, "tokens": tokens, "tokens_per_s": tokens / run_s,
           "launches": launches, **d,
           "acceptance": d["spec_accepted"] / max(1, d["spec_proposed"]),
           "tokens_per_row_window": ((d["spec_accepted"] + rows["rows"])
                                     / max(1, rows["rows"])),
           "forwards": {"draft": d["draft_forwards"], "verify": windows,
                        "decode": d["decode_steps"] - windows,
                        "chunk": d["prefill_forwards"]},
           "out": {r.uid: results[r.uid] for r in reqs}}
    return res


def spec_ab(eager: dict, graphed: dict, reqs, tag: str) -> None:
    """A phase-21 run graphed against the same run eager: every request's
    tokens bit for bit, and every counter and launch equal."""
    for r in reqs:
        check(np.array_equal(eager["out"][r.uid], graphed["out"][r.uid]),
              f"{tag}: graphed tokens of request {r.uid} differ from eager")
    for key in ("launches", "forwards", "prime") + SPEC_COUNTERS:
        a, b = eager[key], graphed[key]
        if key == "prime":
            a, b = ({k: v for k, v in x.items() if k in SPEC_COUNTERS
                     or k == "launches"} for x in (a, b))
        check(a == b, f"{tag}: graphed {key} {b}, eager {a}")
    print(f"  {tag}: graphed equal to eager bit for bit (tokens, counters, "
          f"launches); tokens/s {eager['tokens_per_s']:.1f} eager, "
          f"{graphed['tokens_per_s']:.1f} graphed; "
          f"{graphed['graphs']['captured']} graphs captured in "
          f"{graphed['graphs']['capture_s']:.2f} s")


def spec_leaders(reqs) -> list:
    """The priming pass of a phase-21 engine: the workload's first request
    of each group, asking for its first token only (its prompt is indexed
    at the flip; the first token is sampled in the prompt's last chunk,
    so no window runs)."""
    return [dataclasses.replace(r, uid=r.uid + SPEC_PRIME_UID, max_new=1)
            for r in reqs[:PREFIX_GROUPS]]


def spec_engine(torch, cfg, p, acfg, reqs, draft, mvm, tag: str,
                seen: dict, eager: bool = False) -> dict:
    """One phase-21 run: an engine (``draft`` None: not speculative) whose
    prefix cache is primed (:func:`spec_leaders`), then the workload; its
    step bodies as graphs, or eagerly with ``eager``.
    Gates: the primed first tokens equal the workload's, every request
    hits, the pool conserved, no indexed block rewritten, no cache leaf
    replaced (phase 20's), no ``RewindError``."""
    from repro_torch.serve.scheduler import ServeEngine

    eng = ServeEngine(p, cfg, acfg, spec_scfg(torch, reqs, draft))
    eng._eager = eager
    check(eng.spec_enabled == (draft is not None), f"{tag}: spec_enabled "
          f"{eng.spec_enabled}")
    ptrs = leaf_ptrs(eng)
    prime = spec_pass(torch, eng, spec_leaders(reqs), f"{tag} prime", mvm,
                      seen)
    kept = indexed_rows(torch, eng.pool._index, cache_leaves(eng, "pool"))
    run = spec_pass(torch, eng, reqs, tag, mvm, seen)
    same_tokens(prime["out"], {r.uid: run["out"][r.uid][:1]
                               for r in reqs[:PREFIX_GROUPS]},
                SPEC_PRIME_UID, f"{tag}: the priming pass against the "
                "workload")
    check(run["prefix_hits"] == len(reqs), f"{tag}: {run['prefix_hits']} "
          f"of {len(reqs)} requests hit the primed cache")
    check(rows_kept(torch, eng.pool._index, kept),
          f"{tag}: an indexed block was rewritten")
    check(leaf_ptrs(eng) == ptrs, f"{tag}: a cache leaf was replaced")
    pool_conserved(eng, tag)
    if draft == "int4":
        check(eng.draft_acfg.int4_serve and eng.draft_acfg.kv_bits == 0,
              f"{tag}: the drafter is not the packed int4 deployment")
    f = run["forwards"]
    print(f"  {tag}: {run['tokens']} tokens in {run['run_s']:.2f} s "
          f"({run['tokens_per_s']:.1f} tok/s); "
          + (f"acceptance {run['acceptance']:.4f}, {run['spec_steps']} "
             f"verify windows, {run['tokens_per_row_window']:.2f} tokens a "
             f"row and window; " if draft else "")
          + f"forwards: {f['draft']} draft, {f['verify']} verify, "
          f"{f['decode']} decode, {f['chunk']} chunk; launches "
          f"{run['launches']}")
    run["graphs"] = (None if eager else
                     {"captured": eng.step_graphs.captures,
                      "capture_s": eng.step_graphs.capture_s,
                      "keys": [list(k) for k in eng.step_graphs.keys()]})
    del eng
    torch.cuda.empty_cache()
    return {"prime": {k: v for k, v in prime.items() if k != "out"}, **run}


def spec_record(torch, cfg, p, acfg, reqs, draft, need: dict, want: dict,
                sites: bool, what: str) -> list:
    """The recorded re-run of a phase-21 run (primed as it was), stepped
    until each request of ``need`` has its first ``need[uid]`` tokens;
    every request's tokens so far must be a prefix of ``want`` (the run's
    own). Returns the log of :func:`spec_recorded`. Its forwards are
    recorded in Python, so its step bodies run eagerly (``_eager``); the
    run's own tokens were the graphed engine's."""
    from repro_torch.serve.scheduler import ServeEngine

    eng = ServeEngine(p, cfg, acfg, spec_scfg(torch, reqs, draft))
    eng._eager = True
    eng.run(spec_leaders(reqs))
    log = []

    def tokens(uid):
        if uid in eng.results:
            return eng.results[uid]
        s = next((s for s in eng.slots if s is not None
                  and s.req.uid == uid), None)
        return np.asarray(s.out if s else [], np.int32)

    with spec_recorded(torch, eng, log, sites):
        for r in reqs:
            eng.submit(r)
        while (eng.queue or any(s is not None for s in eng.slots)) and any(
                len(tokens(u)) < n for u, n in need.items()):
            eng.step()
    for r in reqs:
        got = tokens(r.uid)
        check(np.array_equal(got, want[r.uid][:len(got)]), f"{what}: the "
              f"recorded re-run gave request {r.uid} other tokens")
    del eng
    return log


def spec_forward_ms(torch, fn) -> dict:
    """Host ms of one synchronized call of ``fn`` (median of 3) and its
    device ms: a CUDA graph replayed back to back when one call makes the
    host wait nowhere (the sync debug mode), else CUDA events around
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        timing = "graph"
    except RuntimeError as e:
        timing = f"events (the host waits: {str(e).splitlines()[0]})"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dev = (graph_ms(torch, fn, reps=5) if timing == "graph" else
           cuda_time_ms(torch, lambda i: fn(), 1, reps=5, rounds=3))
    host_ms = sorted(host)[1]
    return {"host_ms": host_ms, "device_ms": dev, "busy": dev / host_ms,
            "timing": timing}


def spec_forward_times(torch, cfg, p, acfg) -> dict:
    """The verify forward ``[8, SPEC_K + 1]`` and the int4 drafter's decode
    forward ``[8, 1]`` of an int4-drafting engine over 8 prefilled slots
    (256-token prompts, as phase 8's decode step): host and device ms."""
    from repro_torch.core.analog import AnalogCtx
    from repro_torch.serve import scheduler as S
    from repro_torch.serve.decode import serve_step

    # a budget no slot spends before the last prompt is in
    budget = 96 + ENGINE_SLOTS * 256 // (PREFILL_ROWS * ENGINE_CHUNK)
    reqs = [S.Request(uid=i, prompt=np.random.default_rng(11 + i).integers(
        0, cfg.vocab_size, 256).astype(np.int32), max_new=budget,
        temperature=0.0) for i in range(ENGINE_SLOTS)]
    eng = S.ServeEngine(p, cfg, acfg, spec_scfg(torch, reqs, "int4"))
    for r in reqs:
        eng.submit(r)
    while any(s is None or s.prefilling for s in eng.slots):
        eng.step()
    eng._refresh_device_state()
    d = eng._dev
    window = torch.cat([d["toks"][:, None]] * (SPEC_K + 1), dim=1)
    mask = d["active"][:, None].expand(ENGINE_SLOTS, SPEC_K + 1).contiguous()

    def verify():
        logits, _, _ = S.model_apply(p, cfg, acfg, AnalogCtx(),
                                     {"tokens": window}, caches=eng.caches,
                                     pos_offset=d["off"][:, None],
                                     seq_mask=mask)
        return logits

    def draft():
        logits, _ = serve_step(eng.draft_params, eng.draft_cfg,
                               eng.draft_acfg, d["toks"][:, None],
                               eng.draft_caches, d["off"][:, None],
                               seq_mask=d["active"][:, None])
        return logits

    out = {"verify": spec_forward_ms(torch, verify),
           "draft": spec_forward_ms(torch, draft)}
    del eng
    return out


def spec_parity(torch, cfg, p, acfg, reqs, base: dict, specs: dict,
                what: str) -> dict:
    """Every request's tokens of each speculative run in ``specs`` (by
    drafter) against the non-speculative tokens ``base``, bit for bit.
    Where requests part, the runs are re-run recorded
    (:func:`spec_record`, the non-speculative one once, each as far as
    its parting tokens) and each first differing token is tied to its
    origin: fp by :func:`spec_logit_tie`, analog_hw by
    :func:`spec_site_origin`."""
    parted = {}
    for draft, run in specs.items():
        parted[draft] = {}
        for r in reqs:
            a, b = run["out"][r.uid], base[r.uid]
            if not np.array_equal(a, b):
                parted[draft][r.uid] = int(np.nonzero(a != b)[0][0])
    sites = acfg.mode != "off"
    need = collections.Counter()
    for pd in parted.values():
        for u, t in pd.items():
            need[u] = max(need[u], t + 1)
    base_log = (spec_record(torch, cfg, p, acfg, reqs, None, need, base,
                            sites, f"{what} non-speculative")
                if need else None)
    res = {}
    for draft, pd in parted.items():
        tag = f"{what} {draft} drafter"
        res[draft] = {"equal": len(reqs) - len(pd), "requests": len(reqs),
                      "parted": []}
        if pd:
            spec_log = spec_record(torch, cfg, p, acfg, reqs, draft,
                                   {u: t + 1 for u, t in pd.items()},
                                   specs[draft]["out"], sites, tag)
            bp, sp = spec_positions(base_log), spec_positions(spec_log)
            for r in reqs:
                if r.uid not in pd:
                    continue
                t = pd[r.uid]
                res[draft]["parted"].append(
                    spec_logit_tie(torch, r, t, (base_log, bp),
                                   (spec_log, sp), tag) if not sites else
                    spec_site_origin(torch, cfg, acfg, r, t, (base_log, bp),
                                     (spec_log, sp), tag))
            del spec_log
            torch.cuda.empty_cache()
        print(f"  {tag}: {res[draft]['equal']} of {len(reqs)} requests equal "
              f"non-speculative bit for bit" + (
                  "" if not pd else "; the others part at near-ties: "
                  + "; ".join(", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                        else f"{k} {v}" for k, v in x.items())
                              for x in res[draft]["parted"])))
    return res


def reduced_spec_check(torch, arch: str) -> dict:
    """Phase 21 (b): the reduced ``arch`` (mode off; moe at the no-drop
    capacity) on the card and on the CPU, the same weights, paged at block
    4 and contiguous: the ngram, self and int4 drafters, an all-reject
    ``draft_fn`` and a stop token inside a window. Tokens and the three
    spec counters equal the CPU's, and equal non-speculative tokens; the
    ssm and hybrid families are gated with the reason and serve as
    before."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.models import build
    from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                             ServeEngine)

    cfg = get_config(arch).reduce()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    cfg, params, _ = build(cfg, 0, device="cpu")
    acfg = AnalogConfig(mode="off")
    devs = {"cpu": params, "cuda": _to(params, torch.device("cuda"))}
    rng = np.random.default_rng(21)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new=10, temperature=0.0) for i, n in enumerate(
            (5, 9, 14))]
    spec = cfg.family in ("dense", "moe")
    out = {}
    for paged in (True, False):
        geo = dict(num_slots=3, max_len=48, prefill_chunk=4, paged=paged,
                   kv_block_size=4, draft_k=SPEC_K)
        base = ServeEngine(params, cfg, acfg, SchedulerConfig(**geo)).run(
            list(reqs))
        # the stop token: the third token of the first request
        stop = (int(base[0][2]),)
        cases = {"ngram": {}, "self": {}, "int4": {}, "reject": {},
                 "stop": {}} if spec else {"ngram": {}}
        for case in cases:
            draft = case if case in ("ngram", "self", "int4") else "self"
            run = ([dataclasses.replace(reqs[0], stop_tokens=stop)]
                   + reqs[1:]) if case == "stop" else reqs
            got = {}
            for where, p in devs.items():
                fn = None
                if case == "reject":
                    def fn(ctx, k, ref=base):
                        uid = next(r.uid for r in reqs if np.array_equal(
                            ctx[:len(r.prompt)], r.prompt))
                        n = len(ctx) - len(reqs[uid].prompt)
                        return (ref[uid][n:n + k] + 1) % cfg.vocab_size
                eng = ServeEngine(p, cfg, acfg, SchedulerConfig(
                    speculative=True, draft=draft, **geo), draft_fn=fn)
                toks = eng.run([dataclasses.replace(r) for r in run])
                got[where] = (toks, tuple(getattr(eng, k) for k in (
                    "spec_steps", "spec_proposed", "spec_accepted")), eng)
            (tc, cc, eng), (tg, cg, _) = got["cpu"], got["cuda"]
            tag = (f"reduced {arch} {'paged' if paged else 'contiguous'} "
                   f"{case}")
            check(all(np.array_equal(tc[u], tg[u]) for u in tc),
                  f"{tag}: card and cpu tokens differ")
            check(cc == cg, f"{tag}: spec counters {cg} on the card, {cc} "
                  f"on the cpu")
            want = base if case != "stop" else {
                **base, 0: base[0][:list(base[0]).index(stop[0]) + 1]}
            check(all(np.array_equal(tc[u], want[u]) for u in want),
                  f"{tag}: speculative tokens differ from non-speculative")
            if spec:
                check(cc[0] > 0, f"{tag}: no window ran")
                check(case != "reject" or cc[2] == 0,
                      f"{tag}: {cc[2]} proposals accepted")
            else:
                check(cc[0] == 0 and "speculative" in eng.gating_reasons,
                      f"{tag}: not gated")
            cases[case] = dict(zip(("spec_steps", "spec_proposed",
                                    "spec_accepted"), cc))
        out["paged" if paged else "contiguous"] = cases
    print(f"  reduced {arch} speculative, card against cpu (mode off): "
          + ("equal tokens and spec counters, equal to non-speculative: "
             + "; ".join(f"{lay} " + ", ".join(
                 f"{c} {v['spec_accepted']}/{v['spec_proposed']}"
                 for c, v in cs.items()) for lay, cs in out.items())
             if spec else "gated (" + eng.gating_reasons["speculative"][:48]
             + "...), equal tokens"))
    return out


def phase_speculative(torch, rows: dict | None = None,
                      base_hw: dict | None = None) -> dict:
    """Phase 21: (a) full-width llama-3.2-1b at PREFIX_LAYERS of its layers
    (phase 20's model) on :func:`spec_requests`
    (phase 20's first 8 requests) in phase 20's geometry, its prefix cache
    primed: fp non-speculative and with the
    ngram, self and int4 drafters; analog_hw (``use_pallas=True``)
    non-speculative (its tokens equal to ``base_hw``, phase 20's of the
    same engine, when given) and with the ngram and int4 drafters. Gates:
    equal tokens bit for bit, or each parting request explained at a
    near-tie (:func:`spec_parity`); the self drafter accepts at least
    SPEC_SELF_ACCEPT of its proposals in fp, each rejection at a near-tie
    of the drafter's logits against the window's (:func:`spec_self_ties`);
    the kernels launched as the counters say; no ``RewindError``, the pool
    conserved. Every MVM launch's rows must be among phase 2's (``rows``,
    when given). The verify and draft forwards' host and device ms. (b)
    the reduced models, card against CPU (:func:`reduced_spec_check`)."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.launch.serve import deploy_model

    print(f"  phase 21's numbers on {gpu_name_and_power()}")
    cfg, params, labels = full_width(torch, ARCH, layers=PREFIX_LAYERS[ARCH])
    reqs = spec_requests(cfg)
    seen, out = {}, {}

    t0 = time.perf_counter()
    seconds = out["seconds"] = {}

    def deployment(deploy, p, acfg, mvm, drafts, earlier):
        runs = {}
        run = spec_engine(torch, cfg, p, acfg, reqs, None, mvm,
                          f"{cfg.name} {deploy} non-speculative", seen)
        base = run.pop("out")
        out[f"{deploy}/base"] = run
        if earlier is not None:
            same_tokens(earlier, base, 0, f"{deploy}: phase 20's tokens "
                        f"against the non-speculative run")
        for draft in drafts:
            ties = []
            if deploy == "analog_hw":
                # the eager engine first; the graphed run must equal it
                eager = spec_engine(torch, cfg, p, acfg, reqs, draft, mvm,
                                    f"{cfg.name} {deploy} {draft} drafter "
                                    "eager", seen, eager=True)
            with (spec_self_ties(torch, ties) if draft == "self"
                  else contextlib.nullcontext()):
                runs[draft] = spec_engine(torch, cfg, p, acfg, reqs, draft,
                                          mvm, f"{cfg.name} {deploy} "
                                          f"{draft} drafter", seen)
            if deploy == "analog_hw":
                spec_ab(eager, runs[draft], reqs,
                        f"{cfg.name} {deploy} {draft} drafter")
                out[f"{deploy}/{draft}/eager"] = {
                    k: v for k, v in eager.items() if k != "out"}
            if draft == "self":
                acc = runs[draft]["acceptance"]
                check(acc >= SPEC_SELF_ACCEPT, f"{deploy} self: the drafter "
                      f"accepted {acc:.4f} of its proposals")
                runs[draft]["rejections_at_ties"] = ties
        seconds[f"{deploy} runs"] = time.perf_counter() - t0
        parity = spec_parity(torch, cfg, p, acfg, reqs, base, runs,
                             f"{cfg.name} {deploy}")
        seconds[f"{deploy} parity"] = time.perf_counter() - t0
        for draft, run in runs.items():
            run.pop("out")
            out[f"{deploy}/{draft}"] = {**run, "parity": parity[draft]}

    deployment("fp", params, AnalogConfig(mode="off"), None, SPEC_FP_DRAFTS,
               None)
    gen = torch.Generator(device="cuda").manual_seed(7)
    p, acfg = deploy_model(_deploy_args("analog_hw"), cfg, params, labels,
                           gen, inplace=True)
    acfg = dataclasses.replace(acfg, use_pallas=True)
    deployment("analog_hw", p, acfg, "analog_matmul", SPEC_HW_DRAFTS,
               base_hw)
    for deploy in ("fp", "analog_hw"):
        base = out[f"{deploy}/base"]
        for draft in (SPEC_FP_DRAFTS if deploy == "fp" else SPEC_HW_DRAFTS):
            r = out[f"{deploy}/{draft}"]
            r["tokens_per_s_over_base"] = (r["tokens_per_s"]
                                           / base["tokens_per_s"])
    out["times"] = spec_forward_times(torch, cfg, p, acfg)
    seconds["forward times"] = time.perf_counter() - t0
    t = out["times"]
    print(f"  {cfg.name} analog_hw: verify forward [{ENGINE_SLOTS}, "
          f"{SPEC_K + 1}] {t['verify']['host_ms']:.2f} ms host, "
          f"{t['verify']['device_ms']:.2f} ms device ({t['verify']['timing']}"
          f"); int4 draft forward [{ENGINE_SLOTS}, 1] "
          f"{t['draft']['host_ms']:.2f} ms host, {t['draft']['device_ms']:.2f}"
          f" ms device ({t['draft']['timing']})")
    out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    if rows is not None:
        for name, shapes in seen.items():
            have = {(r["M"], r["K"], r["N"]) for r in rows[name]
                    if r.get("arch", ARCH) == ARCH and "E" not in r}
            check(shapes <= have, f"phase 21: {name} launched at (M, K, N) "
                  f"{sorted(shapes - have)} that phase 2 did not hold")
    del p, params
    torch.cuda.empty_cache()
    out["reduced"] = {arch: reduced_spec_check(torch, arch)
                      for arch in SPEC_REDUCED}
    seconds["reduced"] = time.perf_counter() - t0
    print("  phase 21 seconds since its start: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


# ---------------------------------------------------------------------------
# phase 22: the request lifecycle and the async front end
# ---------------------------------------------------------------------------

#: (a)'s open-loop runs: (name, arrival process, long-run requests/s, the
#: bounded queue (0: none), the TTFT deadline in seconds (0: none))
LIFECYCLE_RUNS = (("poisson", "poisson", 2.0, 0, 0.0),
                  ("burst", "burst", 8.0, 4, 2.0))
#: (b)'s drafters, its requests' and its probe's budgets, and the dispatch
#: (counted from the workload's start) at which the chaos hook raises
LIFECYCLE_DRAFTS = ("ngram", "int4")
LIFECYCLE_SPEC_NEW, LIFECYCLE_PROBE_NEW, LIFECYCLE_FAULT_AT = 8, 4, 3
LIFECYCLE_PROBE_UID = 3000


def lifecycle_requests(cfg) -> list:
    """Phase 8's 16 requests (prompts of 32-480 tokens, 16-64 new), greedy."""
    return [dataclasses.replace(r, temperature=0.0, top_k=0)
            for r in engine_requests(cfg, ENGINE_REQUESTS, seed=0)]


def lifecycle_scfg(torch, reqs, **kw):
    """Phase 8's geometry (8 slots, chunk 32, block 16, the bf16 pool),
    fault-tolerant as the launcher's open-loop modes run it."""
    from repro_torch.serve.scheduler import SchedulerConfig, required_max_len

    max_len = max(required_max_len(len(r.prompt), r.max_new, ENGINE_CHUNK)
                  for r in reqs)
    return SchedulerConfig(num_slots=ENGINE_SLOTS, max_len=max_len,
                           prefill_chunk=ENGINE_CHUNK,
                           cache_dtype=torch.bfloat16, paged=True,
                           kv_block_size=PAGED_BS, fault_tolerant=True, **kw)


#: the engine's forward counters that :func:`engine_launches` reads
LIFECYCLE_COUNTERS = ("decode_steps", "prefill_forwards", "spec_steps",
                      "draft_forwards")


def engine_counters(eng) -> dict:
    """The engine's forward counters that :func:`engine_launches` reads."""
    return {k: getattr(eng, k) for k in LIFECYCLE_COUNTERS}


def engine_launches(torch, eng, before: dict, tag: str,
                    mvm: str | None = "analog_matmul") -> dict:
    """The kernels' launches since they were set to 0, held against the
    engine's counters since ``before``: the target's MVM kernel ``mvm``
    (None: an fp target launches none) at every site of its decode steps,
    windows and chunks, the int4 drafter's at every site of its forwards,
    the decode kernel at every decode step that is no window, the prefill
    kernel at every chunk forward and window."""
    torch.cuda.synchronize()
    launches = launch_counts()
    d = {k: getattr(eng, k) - before[k] for k in LIFECYCLE_COUNTERS}
    cfg = eng.cfg
    want = collections.Counter()
    if mvm:
        want[mvm] += mvm_sites(cfg) * (d["decode_steps"]
                                       + d["prefill_forwards"])
    if eng.draft_acfg is not None and eng.draft_acfg.int4_serve:
        want["int4_matmul"] += mvm_sites(eng.draft_cfg) * d["draft_forwards"]
    want["paged_flash_decode"] += attn_layers(cfg) * (d["decode_steps"]
                                                      - d["spec_steps"])
    want["paged_flash_prefill"] += attn_layers(cfg) * (
        d["prefill_forwards"] + d["spec_steps"])
    want = {k: v for k, v in want.items() if v}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    return launches


def pool_conserved(eng, tag: str) -> None:
    """No block live, no window open, every block free, cached or live and
    the refcounts those of the owners."""
    pool = eng.pool
    check(pool.num_live == 0 and not pool._window
          and pool.num_free + pool.num_cached + pool.num_live
          == pool.num_blocks
          and sum(pool._ref.values()) == sum(len(v) for v in
                                             pool._owned.values()),
          f"{tag}: pool not conserved ({pool.num_live} live, "
          f"{pool.num_free} free, {pool.num_cached} cached of "
          f"{pool.num_blocks})")


@contextlib.contextmanager
def lifecycle_logged(eng, log: list):
    """Inside the block every ``try_submit``, ``step_begin`` and
    ``step_commit`` of ``eng`` is logged in order: ``("submit", req)``,
    ``("begin", uids that timed out in it, whether it dispatched)``,
    ``("commit",)``; the order the front end's two threads called them in
    (one at a time)."""
    real = {n: getattr(eng, n) for n in ("try_submit", "step_begin",
                                         "step_commit")}

    def try_submit(req):
        log.append(("submit", req))
        return real["try_submit"](req)

    def step_begin():
        before = {u for u, s in eng.status.items() if s == "timed_out"}
        pending = real["step_begin"]()
        log.append(("begin", sorted(u for u, s in eng.status.items()
                                    if s == "timed_out" and u not in before),
                    pending is not None))
        return pending

    def step_commit(pending):
        log.append(("commit",))
        return real["step_commit"](pending)

    eng.try_submit, eng.step_begin = try_submit, step_begin
    eng.step_commit = step_commit
    try:
        yield
    finally:
        for n in real:
            delattr(eng, n)


def lifecycle_replay(torch, eng, log: list, want: dict, rec: list,
                     what: str) -> None:
    """Replay an open-loop run's logged calls (:func:`lifecycle_logged`) on
    ``eng``, a fresh engine of the run's config, with its forwards recorded
    (:func:`spec_recorded` with sites) into ``rec``: the same submits, the
    logged timeouts forced at their step (the replay's own clock times
    nothing out: deadlines are dropped), the same steps. The replay must
    give every request the run's tokens."""
    pending = None
    with spec_recorded(torch, eng, rec, True):
        for e in log:
            if e[0] == "submit":
                eng.try_submit(dataclasses.replace(e[1], ttft_deadline=0.0,
                                                   deadline=0.0))
            elif e[0] == "begin":
                for u in e[1]:
                    eng.cancel(u, status="timed_out")
                pending = eng.step_begin()
                check((pending is not None) == e[2], f"{what}: the replay "
                      "dispatched where the run did not, or the reverse")
            else:
                eng.step_commit(pending)
    for uid, toks in want.items():
        check(np.array_equal(eng.results.get(uid), toks), f"{what}: the "
              f"replay gave request {uid} other tokens")


def lifecycle_parity(torch, cfg, p, acfg, reqs, base: dict, out: dict,
                     log: list, scfg, what: str) -> dict:
    """Every request's tokens of an open-loop run (``out``; a timed-out
    one's partial output) against the closed-loop tokens ``base``: equal
    bit for bit, or a prefix of them. Where one parts, both runs are
    replayed with their forwards recorded (the closed loop by ``run``, the
    open loop by :func:`lifecycle_replay`) and its first differing token
    is tied to its origin by phase 16's causal rule
    (:func:`spec_site_origin`)."""
    from repro_torch.serve.scheduler import ServeEngine

    parted = {}
    for r in reqs:
        a = out.get(r.uid)
        if a is None or not len(a):
            continue
        b = base[r.uid][:len(a)]
        if not np.array_equal(a, b):
            parted[r.uid] = int(np.nonzero(a != b)[0][0])
    res = {"equal": len([r for r in reqs if len(out.get(r.uid, ()))])
           - len(parted), "parted": []}
    if parted:
        base_log, open_log = [], []
        # recorded re-runs record their forwards in Python: eager bodies
        eng = ServeEngine(p, cfg, acfg, lifecycle_scfg(torch, reqs))
        eng._eager = True
        with spec_recorded(torch, eng, base_log, True):
            got = eng.run(reqs)
        for r in reqs:
            check(np.array_equal(got[r.uid], base[r.uid]), f"{what}: the "
                  f"recorded closed-loop re-run gave request {r.uid} other "
                  "tokens")
        del eng
        eng = ServeEngine(p, cfg, acfg, scfg)
        eng._eager = True
        lifecycle_replay(torch, eng, log, out, open_log, what)
        bp, op = spec_positions(base_log), spec_positions(open_log)
        for r in reqs:
            if r.uid in parted:
                res["parted"].append(spec_site_origin(
                    torch, cfg, acfg, r, parted[r.uid], (base_log, bp),
                    (open_log, op), what))
        del base_log, open_log
        torch.cuda.empty_cache()
    return res


def latency_ms(vals) -> dict:
    """p50 and p99 of seconds ``vals`` in ms (None where none is given)."""
    xs = [v for v in vals if v is not None]
    if not xs:
        return {"p50": None, "p99": None}
    return {"p50": float(np.percentile(xs, 50)) * 1e3,
            "p99": float(np.percentile(xs, 99)) * 1e3}


def ms_pair(d: dict) -> str:
    """``p50 / p99`` of :func:`latency_ms` for a report line."""
    return " / ".join("-" if d[k] is None else f"{d[k]:.1f}"
                      for k in ("p50", "p99"))


def lifecycle_open_loop(torch, cfg, p, acfg, reqs, base: dict, name: str,
                        arrival: str, qps: float, max_queue: int,
                        ttft: float) -> dict:
    """One open-loop run of (a) through ``AsyncServeFrontend``
    (``launch.serve.open_loop_run``): every arrival reaches exactly one
    terminal status and the books balance; streamed tokens equal each
    result; every request's tokens equal the closed loop's or part by the
    causal rule (:func:`lifecycle_parity`); blocks conserved, no cache leaf
    replaced, the kernels launched as the engine's counters say."""
    from repro_torch.launch.serve import arrival_offsets, open_loop_run
    from repro_torch.serve.frontend import AsyncServeFrontend
    from repro_torch.serve.scheduler import TERMINAL, ServeEngine

    tag = f"{cfg.name} open-loop {name} ({arrival} @ {qps:g} requests/s"
    tag += (f", max_queue {max_queue}" if max_queue else "") + (
        f", TTFT deadline {ttft:g} s)" if ttft else ")")
    scfg = lifecycle_scfg(torch, reqs, max_queue=max_queue)
    eng = ServeEngine(p, cfg, acfg, scfg)
    ptrs = leaf_ptrs(eng)
    run_reqs = [dataclasses.replace(r, ttft_deadline=ttft) for r in reqs]
    offsets = arrival_offsets(len(reqs), qps, arrival,
                              np.random.default_rng(1))
    fe = AsyncServeFrontend(eng)
    log = []

    async def drive():
        await fe.start()
        try:
            return await open_loop_run(fe, run_reqs, offsets)
        finally:
            await fe.stop()

    before = engine_counters(eng)
    zero_counts(torch)
    with lifecycle_logged(eng, log):
        records, wall = asyncio.run(drive())
    launches = engine_launches(torch, eng, before, tag)
    check(sorted(r["uid"] for r in records) == [r.uid for r in reqs]
          and eng.submitted == len(reqs)
          and all(eng.status[r.uid] in TERMINAL for r in reqs),
          f"{tag}: {len(records)} terminal records of {len(reqs)} arrivals, "
          f"{eng.submitted} submitted")
    by = collections.Counter(eng.status[r.uid] for r in reqs)
    check(by.get("errored", 0) == 0 and eng.fault_count == 0,
          f"{tag}: faults {eng.step_faults}")
    for rec in records:
        got = eng.results[rec["uid"]]
        check(rec["status"] == eng.status[rec["uid"]]
              and rec["streamed"] == [int(t) for t in got]
              and rec["tokens"] == len(got),
              f"{tag}: request {rec['uid']}'s stream or result is not the "
              "engine's")
    for r in reqs:
        if eng.status[r.uid] == "finished":
            check(len(eng.results[r.uid]) == r.max_new, f"{tag}: request "
                  f"{r.uid} finished with {len(eng.results[r.uid])} tokens")
    pool_conserved(eng, tag)
    check(leaf_ptrs(eng) == ptrs, f"{tag}: a cache leaf was replaced")
    out = dict(eng.results)
    parity = lifecycle_parity(torch, cfg, p, acfg, reqs, base, out, log,
                              scfg, tag)
    tokens = sum(len(eng.results[r.uid]) for r in reqs)
    # TTFT over the requests that got a first token; a request retired
    # without one (timed out, errored) counts at its time to retirement, a
    # lower bound of its TTFT, in ttft_all_ms (over every admitted arrival)
    ttfts = [r["ttft"] for r in records]
    no_token = [r["latency"] for r in records
                if r["status"] != "shed" and r["ttft"] is None]
    tpots = [(eng.finished_at[r.uid] - eng.first_token_at[r.uid])
             / (len(eng.results[r.uid]) - 1) for r in reqs
             if eng.status[r.uid] == "finished"
             and len(eng.results[r.uid]) > 1]
    res = {"arrival": arrival, "qps": qps, "max_queue": max_queue,
           "ttft_deadline_s": ttft, "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "outcomes": dict(by),
           "ttft_ms": latency_ms(ttfts), "tpot_ms": latency_ms(tpots),
           "ttft_n": len([t for t in ttfts if t is not None]),
           "ttft_all_ms": latency_ms(
               [t for t in ttfts if t is not None] + no_token),
           "no_token": len(no_token),
           "no_token_min_ms": min(no_token) * 1e3 if no_token else None,
           "queue_high_water": eng.queue_high_water,
           "frontend_steps": fe.steps, "launches": launches,
           "shed_count": eng.shed_count, "timeout_count": eng.timeout_count,
           "parity": parity}
    print(f"  {tag}: {tokens} tokens in {wall:.2f} s ({tokens / wall:.1f} "
          f"tok/s), outcomes {dict(by)}, TTFT p50/p99 "
          f"{ms_pair(res['ttft_ms'])} ms over the {res['ttft_n']} requests "
          f"with a first token (over all {res['ttft_n'] + len(no_token)} "
          f"admitted, the {len(no_token)} retired without one at their "
          f"time to retirement, a lower bound: at least "
          f"{ms_pair(res['ttft_all_ms'])} ms), TPOT p50/p99 "
          f"{ms_pair(res['tpot_ms'])} ms over the finished, queue high-water "
          f"{eng.queue_high_water}, {fe.steps} front-end steps; {parity['equal']} requests' tokens equal the closed "
          f"loop's bit for bit, {len(parity['parted'])} part at near-ties "
          f"{parity['parted']}; launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return res


def engine_leaves(eng) -> list:
    """Every cache leaf of ``eng`` and of its drafter."""
    from repro_torch.serve.scheduler import _walk

    out = [leaf for (leaf,) in _walk(eng.caches)]
    if eng.draft_caches is not None:
        out += [leaf for (leaf,) in _walk(eng.draft_caches)]
    return out


def lifecycle_spec(torch, cfg, p, acfg, draft: str) -> dict:
    """(b) with ``draft`` (k = SPEC_K) on one fault-tolerant engine over
    phase 21's eight requests (budget LIFECYCLE_SPEC_NEW): a probe
    served alone; a cancel between ``step_begin`` and ``step_commit`` of a
    speculative window, deferred past the commit (the slot live and in the
    pool's rewind window until then), with no ``RewindError`` and the pool
    conserved; a chaos fault at the LIFECYCLE_FAULT_AT-th dispatch of the
    next four requests, every one of them then ``errored`` with the fault's
    reason, every cache leaf (the drafter's too) keeping its storage and
    zeroed; the probe again under a new uid, equal bit for bit. The
    kernels launched as the engine's counters say."""
    from repro_torch.serve.kv_pool import RewindError
    from repro_torch.serve.scheduler import Request, ServeEngine

    tag = f"{cfg.name} lifecycle, {draft} drafter"
    reqs = [dataclasses.replace(r, max_new=LIFECYCLE_SPEC_NEW)
            for r in spec_requests(cfg)]
    probe = Request(uid=LIFECYCLE_PROBE_UID, prompt=reqs[0].prompt,
                    max_new=LIFECYCLE_PROBE_NEW, temperature=0.0)
    state = {"armed": False, "seen": 0, "ptrs": None}

    def chaos(point):
        if point != "dispatch" or not state["armed"]:
            return
        state["seen"] += 1
        if state["seen"] == LIFECYCLE_FAULT_AT:
            state["ptrs"] = [leaf.data_ptr() for leaf in engine_leaves(eng)]
            raise RuntimeError("chaos: injected dispatch fault")

    scfg = dataclasses.replace(spec_scfg(torch, reqs, draft),
                               fault_tolerant=True)
    eng = ServeEngine(p, cfg, acfg, scfg, chaos_hook=chaos)
    check(eng.spec_enabled and eng._tolerant, f"{tag}: not speculative")
    before = engine_counters(eng)
    zero_counts(torch)
    t0 = time.perf_counter()
    try:
        first = eng.run([probe])[probe.uid].copy()
        for r in reqs[:4]:
            eng.submit(r)
        pending = None
        while pending is None or pending["op"] != "spec":
            if pending is not None:
                eng.step_commit(pending)
            check(eng.queue or eng.num_active, f"{tag}: no window opened")
            pending = eng.step_begin()
        row = pending["decode_rows"][0]
        uid = eng.slots[row].req.uid
        check(eng.pool.in_window(uid), f"{tag}: request {uid} is not in the "
              "open window")
        check(eng.cancel(uid) and eng.status[uid] == "decode"
              and eng.slots[row] is not None and eng.pool.in_window(uid),
              f"{tag}: the cancel mid-window was not deferred")
        eng.step_commit(pending)
        check(eng.status[uid] in ("cancelled", "finished")
              and not eng.pool.in_window(uid), f"{tag}: the deferred cancel "
              f"left request {uid} {eng.status[uid]}")
        cancelled = eng.status[uid]
        eng.run()
        pool_conserved(eng, f"{tag} after the cancel")
        check(all(eng.status[r.uid] == "finished" for r in reqs[:4]
                  if r.uid != uid), f"{tag}: a request did not finish")
        state["armed"] = True
        eng.run(reqs[4:])
    except RewindError as e:
        check(False, f"{tag}: {e}")
    check(eng.fault_count == 1 and state["ptrs"] is not None,
          f"{tag}: {eng.fault_count} faults")
    errored = [r.uid for r in reqs[4:] if eng.status[r.uid] == "errored"]
    check(errored == [r.uid for r in reqs[4:]]
          and all("chaos: injected dispatch fault" in eng.errors[u]
                  for u in errored), f"{tag}: the in-flight requests ended "
          f"{[eng.status[r.uid] for r in reqs[4:]]}")
    leaves = engine_leaves(eng)
    check([leaf.data_ptr() for leaf in leaves] == state["ptrs"],
          f"{tag}: the fault reset replaced a cache leaf")
    check(not any(bool(leaf.any()) for leaf in leaves),
          f"{tag}: the fault reset left a cache leaf nonzero")
    pool_conserved(eng, f"{tag} after the fault")
    again = eng.run([dataclasses.replace(probe, uid=probe.uid + 1)])[
        probe.uid + 1]
    check(np.array_equal(again, first), f"{tag}: the probe after the fault "
          f"gave {again.tolist()}, before it {first.tolist()}")
    run_s = time.perf_counter() - t0
    launches = engine_launches(torch, eng, before, tag)
    res = {"run_s": run_s, "cancel_status": cancelled,
           "errored": len(errored), "fault": eng.step_faults[0],
           "spec_steps": eng.spec_steps, "launches": launches,
           "probe": first.tolist()}
    print(f"  {tag}: a cancel mid-window deferred to the commit (ended "
          f"{cancelled}); a fault at dispatch {LIFECYCLE_FAULT_AT} errored "
          f"{len(errored)} requests; the reset kept every leaf's storage "
          f"({len(leaves)} leaves, all zero); the probe equal before and "
          f"after; {run_s:.2f} s, {eng.spec_steps} windows, launches "
          f"{launches}")
    del eng
    torch.cuda.empty_cache()
    return res


async def http_exchange(port: int, method: str, path: str, body=None):
    """One HTTP/1.1 request to the front door on ``127.0.0.1:port``:
    ``(status code, JSON body)``."""
    raw = json.dumps(body).encode() if body is not None else b""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(raw)}\r\n\r\n".encode() + raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, payload = data.split(b"\r\n\r\n", 1)
    return int(head.split()[1]), json.loads(payload)


def lifecycle_http(torch, cfg, p, acfg, reqs) -> dict:
    """(c) the HTTP front door (``launch.serve.open_http``) on an ephemeral
    loopback port over an engine of (a)'s burst config: four requests fill
    the queue before the front end starts, so the POST it applies first is
    answered 503 with the reason; a second POST 200 with the engine's
    tokens; ``GET /health`` equal to the engine's counters once idle; then
    the door stops."""
    from repro_torch.launch.serve import open_http
    from repro_torch.serve.frontend import AsyncServeFrontend
    from repro_torch.serve.scheduler import ServeEngine

    tag = f"{cfg.name} HTTP front door"
    eng = ServeEngine(p, cfg, acfg, lifecycle_scfg(torch, reqs, max_queue=4))
    fe = AsyncServeFrontend(eng)
    args = argparse.Namespace(new_tokens=8, seed=0, ttft_timeout=0.0,
                              request_timeout=0.0, port=0)
    post = {"prompt": [int(t) for t in reqs[0].prompt[:32]], "max_new": 8,
            "temperature": 0.0}

    async def door():
        server = await open_http(fe, args, cfg.vocab_size)
        port = server.sockets[0].getsockname()[1]
        for i, r in enumerate(reqs[1:5]):
            check(eng.try_submit(dataclasses.replace(
                r, uid=10_000 + i, prompt=r.prompt[:32], max_new=8)) is None,
                f"{tag}: a filler was shed")
        shed = asyncio.ensure_future(http_exchange(port, "POST", "/generate",
                                                   post))
        t = time.perf_counter()
        while fe._commands.empty():
            check(time.perf_counter() - t < 30, f"{tag}: the POST never "
                  "reached the front end")
            await asyncio.sleep(0.005)
        await fe.start()
        try:
            out = {"shed": await shed,
                   "ok": await http_exchange(port, "POST", "/generate",
                                             post)}
            while eng.num_active or eng.queue_depth:
                await asyncio.sleep(0.01)
            out["health"] = await http_exchange(port, "GET", "/health")
        finally:
            server.close()
            await server.wait_closed()
            await fe.stop()
        return out

    before = engine_counters(eng)
    zero_counts(torch)
    out = asyncio.run(door())
    launches = engine_launches(torch, eng, before, tag)
    code, body = out["shed"]
    check(code == 503 and body["status"] == "shed"
          and "queue full" in body["reason"], f"{tag}: {code} {body}")
    code, ok = out["ok"]
    check(code == 200 and ok["status"] == "finished"
          and ok["tokens"] == [int(t) for t in eng.results[ok["uid"]]]
          and len(ok["tokens"]) == 8, f"{tag}: {code} {ok}")
    code, health = out["health"]
    want = dict(active=eng.num_active, queued=eng.queue_depth,
                submitted=eng.submitted, shed=eng.shed_count,
                timed_out=eng.timeout_count, cancelled=eng.cancel_count,
                step_faults=eng.fault_count,
                queue_high_water=eng.queue_high_water)
    check(code == 200 and health == want, f"{tag}: /health {health}, the "
          f"engine's {want}")
    pool_conserved(eng, tag)
    print(f"  {tag}: 503 at a full queue ({body['reason']}), 200 with the "
          f"engine's {len(ok['tokens'])} tokens (TTFT {ok['ttft'] * 1e3:.1f}"
          f" ms), /health {health}; launches {launches}")
    del eng
    return {"health": health, "ttft_s": ok["ttft"], "launches": launches}


def phase_lifecycle(torch, phase8_tokens_per_s: float | None = None) -> dict:
    """Phase 22 on full-width llama-3.2-1b, ``analog_hw`` with
    ``use_pallas=True`` (phase 8's model and deployment): (a) phase 8's
    16 requests, greedy, closed loop on the bf16 pool in phase 8's geometry,
    then through the async front end open-loop (:data:`LIFECYCLE_RUNS`,
    :func:`lifecycle_open_loop`); (b) a cancel mid speculative window, a
    chaos fault and the in-place reset with the ngram and int4 drafters
    (:func:`lifecycle_spec`); (c) the HTTP front door
    (:func:`lifecycle_http`). Returns every run's numbers; ``runs`` holds
    the launches of each main-path run."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.serve.scheduler import ServeEngine

    print(f"  phase 22's numbers on {gpu_name_and_power()}")
    t0 = time.perf_counter()
    seconds = {}
    cfg, params, labels = full_width(torch, ARCH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    p, acfg = deploy_model(_deploy_args("analog_hw"), cfg, params, labels,
                           gen, inplace=True)
    acfg = dataclasses.replace(acfg, use_pallas=True)
    reqs = lifecycle_requests(cfg)
    seconds["model"] = time.perf_counter() - t0

    eng = ServeEngine(p, cfg, acfg, lifecycle_scfg(torch, reqs))
    before = engine_counters(eng)
    zero_counts(torch)
    t = time.perf_counter()
    base = {u: v.copy() for u, v in eng.run(reqs).items()}
    torch.cuda.synchronize()
    closed_s = time.perf_counter() - t
    tag = f"{cfg.name} closed loop (greedy)"
    closed = {"run_s": closed_s,
              "tokens": sum(len(v) for v in base.values()),
              "launches": engine_launches(torch, eng, before, tag)}
    closed["tokens_per_s"] = closed["tokens"] / closed_s
    check(all(eng.status[r.uid] == "finished"
              and len(base[r.uid]) == r.max_new for r in reqs),
          f"{tag}: a request did not finish")
    pool_conserved(eng, tag)
    del eng
    print(f"  {tag}: {closed['tokens']} tokens in {closed_s:.2f} s "
          f"({closed['tokens_per_s']:.1f} tok/s); phase 8's sampled run "
          f"{phase8_tokens_per_s} tok/s")
    seconds["closed"] = time.perf_counter() - t0
    runs = {"closed": closed}
    for name, arrival, qps, max_queue, ttft in LIFECYCLE_RUNS:
        runs[name] = lifecycle_open_loop(torch, cfg, p, acfg, reqs, base,
                                         name, arrival, qps, max_queue,
                                         ttft)
        runs[name]["tokens_per_s_over_closed"] = (
            runs[name]["tokens_per_s"] / closed["tokens_per_s"])
        seconds[name] = time.perf_counter() - t0
    for draft in LIFECYCLE_DRAFTS:
        runs[f"spec_{draft}"] = lifecycle_spec(torch, cfg, p, acfg, draft)
        seconds[f"spec_{draft}"] = time.perf_counter() - t0
    runs["http"] = lifecycle_http(torch, cfg, p, acfg, reqs)
    seconds["http"] = time.perf_counter() - t0
    del p, params
    torch.cuda.empty_cache()
    print(f"  phase 22: front-end tokens/s against the closed loop's "
          + ", ".join(f"{k} {runs[k]['tokens_per_s_over_closed']:.3f}"
                      for k, *_ in LIFECYCLE_RUNS)
          + f" (phase 8's sampled closed loop {phase8_tokens_per_s} tok/s); "
          "seconds since its start: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; on {gpu_name_and_power()}")
    return {"runs": runs, "seconds": seconds,
            "phase8_tokens_per_s": phase8_tokens_per_s}



# ---------------------------------------------------------------------------
# phase 23: tensor parallelism on one card
# ---------------------------------------------------------------------------

#: the engine counters that every tp of one workload must share
TP_COUNTERS = ("decode_steps", "mixed_steps", "prefill_forwards",
               "prefill_chunks", "prefix_hits", "prefix_skipped_tokens")


def tp_shard_plans(torch) -> dict:
    """Each shard's MVM launch runs its whole site's plan: llama's sites at
    the engine's decode and chunk rows, split over 2 and 4 shards, each
    shard launched with ``plan_shape`` = the whole site's; the shards'
    columns joined equal the whole launch bit for bit (``analog_matmul``
    with the folded bound, ``int4_matmul``). The whole launches are those
    phase 2 holds against the plain versions. Also reported: how many
    outputs differ when a shard plans its own shape instead (the split of
    K its own width gives)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.analog_matmul import analog_matmul
    from repro_torch.kernels.int4_matmul import int4_matmul

    gen = torch.Generator(device="cuda").manual_seed(23)
    dev = torch.device("cuda")
    beta = torch.full((1,), 3.0, device=dev)
    out = []
    for site, k, n, _ in SITES:
        for m in (M_ENGINE_DECODE, M_ENGINE_CHUNK):
            x = torch.randn((m, k), generator=gen, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            w_int, scale = _rtn4(torch, w)
            packed = ref.pack_int4(w_int)
            whole = analog_matmul(x, w, beta, lam=14.0)
            whole4 = int4_matmul(x, packed, scale.reshape(n))
            row = {"site": site, "M": m, "K": k, "N": n}
            for tp in TP_DEGREES[1:]:
                cols = n // tp
                own = apart = apart4 = own4 = 0
                for i in range(tp):
                    c = slice(i * cols, (i + 1) * cols)
                    ws = w[:, c].contiguous()
                    ys = analog_matmul(x, ws, beta, lam=14.0,
                                       plan_shape=(1, n))
                    apart += int((ys != whole[:, c]).sum())
                    own += int((analog_matmul(x, ws, beta, lam=14.0)
                                != whole[:, c]).sum())
                    pc = slice(i * cols // 2, (i + 1) * cols // 2)
                    ps = packed[:, pc].contiguous()
                    ss = scale.reshape(n)[c].contiguous()
                    apart4 += int((int4_matmul(x, ps, ss, plan_shape=(1, n))
                                   != whole4[:, c]).sum())
                    own4 += int((int4_matmul(x, ps, ss) != whole4[:, c])
                                .sum())
                check(apart == 0 and apart4 == 0, f"tp {site} M={m} tp={tp}: "
                      f"{apart} analog_matmul / {apart4} int4_matmul outputs "
                      "of the shards part from the whole launch's")
                row[f"tp{tp}"] = {"own_plan_apart": own,
                                  "own_plan_apart_int4": own4}
            out.append(row)
            print(f"  shard plans {site:8s} M={m:3d} {k}->{n}: shards of "
                  f"{TP_DEGREES[1:]} on the whole site's plan equal the whole launch bit "
                  "for bit (analog_matmul, int4_matmul); on their own plans "
                  + ", ".join(f"tp {tp}: {row[f'tp{tp}']['own_plan_apart']}"
                              f" / {row[f'tp{tp}']['own_plan_apart_int4']}"
                              for tp in TP_DEGREES[1:])
                  + f" of {m * n} outputs apart")
    return {"sites": out}


def _rtn4(torch, w):
    """Per-column RTN int4 of ``w`` [K, N]: ``(w_int, scale [1, N])``."""
    from repro_torch.core import quant

    return quant.rtn_quantize(w, 4, axis=-2)


def tp_decode_ms(torch, eng, cfg) -> dict:
    """Host and device ms of one decode forward of ``eng``: ENGINE_SLOTS
    greedy requests of 64-token prompts (fewer where the engine's
    ``max_len`` is shorter) admitted and prefilled, three
    graphed decode steps on the host clock (synchronized), then the same
    step over the same slots captured as a CUDA graph and replayed back to
    back (its device time)."""
    from repro_torch.serve.decode import serve_step
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(23)
    plen = min(64, eng.scfg.max_len - 24 - eng.scfg.prefill_chunk)
    for i in range(ENGINE_SLOTS):
        eng.submit(Request(uid=9000 + i, prompt=rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32), max_new=24,
            temperature=0.0))
    while any(s is None or s.prefilling for s in eng.slots):
        eng.step()
    eng.step()
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(
        1, eng.decode_steps - steps0)
    eng._refresh_device_state()
    d = eng._dev

    def step():
        logits, _ = serve_step(eng.params, cfg, eng.acfg,
                               d["toks"][:, None], eng.caches,
                               d["off"][:, None],
                               seq_mask=d["active"][:, None])
        return torch.argmax(logits, dim=-1)

    dev_ms = graph_ms(torch, step, reps=5)
    eng.run()
    return {"decode_host_ms": host_ms, "decode_device_ms": dev_ms}


def tp_fp_tie(torch, cfg, params, req, tokens, t: int) -> dict:
    """The fp rule for a request whose greedy token ``t`` parts between two
    tensor-parallel degrees: the tp = 1 model's logits at that position
    (a forward of the prompt and the first ``t`` tokens) have a top-2 gap
    within TP_FP_TIE of their scale (cuBLAS picks its products by shape,
    and a shard's shape is another)."""
    from repro_torch.core.analog import AnalogConfig, AnalogCtx
    from repro_torch.models.model import apply as model_apply

    seq = np.concatenate([req.prompt, np.asarray(tokens[:t], np.int32)])
    toks = torch.as_tensor(seq[None], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        logits, _, _ = model_apply(params, cfg, AnalogConfig(mode="off"),
                                   AnalogCtx(), {"tokens": toks},
                                   last_only=True)
    top = torch.topk(logits[0, -1].float(), 2).values
    gap = float(top[0] - top[1])
    check(gap <= TP_FP_TIE * (1 + abs(float(top[0]))), f"fp tp: request "
          f"{req.uid} parts at token {t} with a top-2 gap {gap:.3e}")
    return {"uid": req.uid, "token": t, "top2_gap": gap}


def tp_engine(torch, cfg, p, acfg, scfg, reqs, tp: int, what: str,
              timed: bool = False) -> dict:
    """``reqs`` through a ``tp``-way engine whose shards share cuda:0
    (graphed: the captures take every shard's launches), every count set
    to 0 just before (:func:`engine_run`); with ``timed``, the decode
    forward's host and device ms after (:func:`tp_decode_ms`)."""
    from repro_torch.distributed import sharding
    from repro_torch.serve.scheduler import ServeEngine

    dev = torch.device("cuda", 0)
    eng = ServeEngine(p, cfg, acfg, dataclasses.replace(scfg, tp=tp),
                      shard_devices=[dev] * tp if tp > 1 else None)
    if tp > 1 and "tensor_parallel" not in eng.gating_reasons:
        check(eng.mesh is not None and eng.mesh.tp == tp
              and (eng.step_graphs is not None or eng.device.type != "cuda"),
              f"{what}: tp={tp} did not shard on one card")
        leaves = [v for v in _leaves_any(eng.params)
                  if isinstance(v, sharding.Shards)]
        check(leaves and all(len(v.parts) == tp for v in leaves),
              f"{what}: tp={tp}: {len(leaves)} sharded leaves")
    run = engine_run(torch, eng, reqs)
    total = sum(len(v) for v in run["results"].values())
    res = {"tokens": {int(u): np.asarray(v).tolist()
                      for u, v in run["results"].items()},
           "tokens_per_s": total / run["run_s"], "run_s": run["run_s"],
           "peak_gb": run["peak_gb"], "launches": run["launches"],
           "counters": {k: getattr(eng, k) for k in TP_COUNTERS},
           "gating": dict(eng.gating_reasons),
           "graphs": run["graphs"]["captured"] if run["graphs"] else 0,
           "tpot_ms": run["tpot_ms"], "ttft_ms": run["ttft_ms"]}
    if timed:
        res.update(tp_decode_ms(torch, eng, cfg))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _leaves_any(tree):
    """Every leaf of a nested dict, tensors and shards alike."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_any(v)
    else:
        yield tree


def tp_compare(torch, cfg, p, runs: dict, reqs, what: str,
               exact: bool) -> dict:
    """Every tp's run of one workload against tp = 1's: tokens bit for bit
    (``exact``; else a parting request only at a top-2 near-tie of the tp =
    1 logits, :func:`tp_fp_tie`), the engine's counters equal, and each
    kernel's launches ``tp`` times tp = 1's (every site and every
    attention layer runs once per shard; the Mamba-2 scan, replicated,
    as often as at tp = 1)."""
    base = runs[1]
    out = {}
    for tp, r in runs.items():
        if tp == 1:
            continue
        parted = [u for u in base["tokens"]
                  if r["tokens"][u] != base["tokens"][u]]
        check(r["counters"] == base["counters"] or parted,
              f"{what} tp={tp}: counters {r['counters']}, tp=1 "
              f"{base['counters']}")
        ties = []
        if parted:
            check(not exact, f"{what} tp={tp}: requests {parted} part from "
                  "tp=1's tokens")
            for u in parted:
                a, b = r["tokens"][u], base["tokens"][u]
                t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                req = next(q for q in reqs if q.uid == u)
                ties.append(tp_fp_tie(torch, cfg, p, req, b, t))
        else:
            want = {k: v * (1 if k == "ssd_scan" else tp)
                    for k, v in base["launches"].items() if v}
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == want, f"{what} tp={tp}: launches {got}, expected "
                  f"tp x tp=1's {want}")
        out[tp] = {"equal": len(reqs) - len(parted), "ties": ties}
    return out


def tp_print(what: str, runs: dict, cmp: dict) -> None:
    for tp, r in runs.items():
        eq = ("" if tp == 1 else
              f"; {cmp[tp]['equal']} of {len(r['tokens'])} requests equal "
              "tp=1 bit for bit" + ("" if not cmp[tp]["ties"] else
                                    f", the others at near-ties "
                                    f"{cmp[tp]['ties']}"))
        timing = ("" if "decode_host_ms" not in r else
                  f", decode step host {r['decode_host_ms']:.2f} ms, device "
                  f"{r['decode_device_ms']:.2f} ms")
        print(f"  {what} tp={tp}: {r['tokens_per_s']:.1f} tokens/s, TPOT "
              f"{r['tpot_ms']:.2f} ms, peak {r['peak_gb']:.2f} GB, launches "
              f"{r['launches']}, {r['graphs']} graphs captured"
              + timing + eq)


def phase_tp(torch) -> dict:
    """Phase 23: tensor parallelism on the one card, the shards of every
    column-parallel weight and of the pool sharing cuda:0. (a) Each
    shard's launch runs the whole site's plan (:func:`tp_shard_plans`).
    (b) Full-width llama-3.2-1b at TP_LAYERS of its layers on phase 21's 8
    greedy requests and its geometry (bf16 pool, prefix cache on):
    analog_hw and digital_int4 at tp 1, 2 and 4 bit for bit, fp equal or
    parting only at a top-2 near-tie; every kernel launched tp times as
    often; tokens/s, the decode step's host and device ms, peak GB. (c)
    qwen3-moe-30b-a3b (MOE_LAYERS) and mamba2-130m (TP_LAYERS) analog_hw at
    tp 2. (d) qwen2.5-32b at full width, QWEN32_LAYERS of its 64 layers,
    fed to the sharded engines from host memory,
    analog_hw at tp 2 and 4 equal to tp 1 (the reference's big-config
    smoke, on the kernels). (e) llama at tp 3: gated (32 heads do not
    divide), serving tp = 1's tokens."""
    from repro_torch.launch.serve import deploy_model
    from repro_torch.models import build
    from repro_torch.serve.scheduler import Request, SchedulerConfig

    print(f"  phase 23's numbers on {gpu_name_and_power()}")
    dev = torch.device("cuda")
    out = {"shard_plans": tp_shard_plans(torch)}

    def deployed(cfg, params, labels, deploy, seed=7):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        p, acfg = deploy_model(_deploy_args(deploy), cfg, params, labels,
                               gen, inplace=True)
        if deploy == "analog_hw":
            acfg = dataclasses.replace(acfg, use_pallas=True)
        return p, acfg

    # (b) llama-3.2-1b: fp first, then digital_int4 (carriers beside the
    # weights), then analog_hw (programmed into the weights in place)
    cfg, params, labels = full_width(torch, ARCH, layers=TP_LAYERS[ARCH])
    reqs = spec_requests(cfg)
    scfg = spec_scfg(torch, reqs, None)
    for deploy in ("fp", "digital_int4", "analog_hw"):
        p, acfg = deployed(cfg, params, labels, deploy)
        what = f"{cfg.name} {deploy}"
        runs = {tp: tp_engine(torch, cfg, p, acfg, scfg, reqs, tp, what,
                              timed=deploy == "analog_hw")
                for tp in TP_DEGREES}
        cmp = tp_compare(torch, cfg, params, runs, reqs, what,
                         exact=deploy != "fp")
        tp_print(what, runs, cmp)
        out[f"{ARCH}/{deploy}"] = {"runs": runs, "compare": cmp}
        if deploy == "analog_hw":
            gated = tp_engine(torch, cfg, p, acfg, scfg, reqs, 3,
                              f"{what} tp=3")
            reason = gated["gating"].get("tensor_parallel", "")
            check("divisible" in reason and gated["tokens"]
                  == runs[1]["tokens"], f"{what} tp=3: gating {reason!r}, "
                  "tokens apart from tp=1's")
            print(f"  {what} tp=3: gated ({reason}); serves tp=1's tokens "
                  "bit for bit")
            out[f"{ARCH}/tp3"] = {"reason": reason,
                                  "launches": gated["launches"]}
        del p
    del params
    torch.cuda.empty_cache()

    # (c) qwen3-moe and mamba2-130m at tp 2
    for arch in (MOE, MAMBA):
        if arch == MOE:
            cfg, params, labels = full_width(torch, MOE)
        else:
            cfg, params, labels = build(dataclasses.replace(
                model_config(arch), num_layers=TP_LAYERS[arch]),
                torch.Generator(device=dev).manual_seed(0), device=dev)
        p, acfg = deployed(cfg, params, labels, "analog_hw")
        reqs = spec_requests(cfg)
        scfg = spec_scfg(torch, reqs, None)
        what = f"{cfg.name} analog_hw"
        runs = {tp: tp_engine(torch, cfg, p, acfg, scfg, reqs, tp, what)
                for tp in (1, 2)}
        cmp = tp_compare(torch, cfg, p, runs, reqs, what, exact=True)
        tp_print(what, runs, cmp)
        out[f"{arch}/analog_hw"] = {"runs": runs, "compare": cmp}
        del p, params
        torch.cuda.empty_cache()

    # (d) qwen2.5-32b at full width, QWEN32_LAYERS layers, deployed on the
    # card and handed to the sharded engines in host memory, as
    # ``launch/serve.py --tp`` hands them a model: each shard is copied to
    # the card, so their peak holds no unsharded copy beside the shards;
    # tp = 1 serves the same weights moved back to the card, last
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(QWEN32), num_layers=QWEN32_LAYERS)
    cfg, params, labels = build(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
    check((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff)
          == (5120, 40, 8, 27648), f"unexpected config {cfg}")
    n_params = sum(t.numel() for t in _leaves(params))
    p, acfg = deployed(cfg, params, labels, "analog_hw")
    host = _to(p, torch.device("cpu"))
    del p, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(32)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 16 + 8 * i)
                    .astype(np.int32), max_new=8, temperature=0.0)
            for i in range(4)]
    scfg = SchedulerConfig(num_slots=4, max_len=64, prefill_chunk=16,
                           cache_dtype=torch.bfloat16, paged=True,
                           kv_block_size=PAGED_BS)
    what = f"{cfg.name} analog_hw"
    runs = {tp: tp_engine(torch, cfg, host, acfg, scfg, reqs, tp, what)
            for tp in QWEN32_DEGREES if tp > 1}
    p = _to(host, dev)
    del host
    runs = dict(sorted({**runs, 1: tp_engine(torch, cfg, p, acfg, scfg,
                                             reqs, 1, what)}.items()))
    cmp = tp_compare(torch, cfg, p, runs, reqs, what, exact=True)
    tp_print(what, runs, cmp)
    print(f"  {what}: tp > 1 from host memory (each shard copied to the "
          f"card), tp = 1 from the card; {n_params / 1e9:.3f}B params, "
          f"{4 * n_params / 1e9:.2f} GB in fp32")
    out[f"{QWEN32}/analog_hw"] = {"runs": runs, "compare": cmp,
                                  "params": n_params}
    del p
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 24: the cost counter and the meta-device dry run
# ---------------------------------------------------------------------------

#: gate (v): the counter's peak of live tensor bytes on the meta device
#: against the card's peak growth over the same run
#: (``max_memory_allocated`` after ``reset_peak_memory_stats``, less what
#: was allocated before): within PEAK_REL of the card's, or within
#: PEAK_ABS (PERF.md section 6: the prediction made before the first run)
PEAK_REL, PEAK_ABS = 0.15, 256 << 20
#: gate (iv): the caching allocator rounds each block up to 512 bytes
ALLOC_ROUND = 512
#: gate (iii)'s paged cases: rows, table blocks, the prefill's columns
COST_PAGED = (2, 8, 4)
#: (vii): the archs whose train step's FLOPs are counted, a fixed list
#: sized to the phase's 45 s: the dense, moe, ssm and audio families (the
#: step runs on the meta device at one layer pattern, 1.4 to 7 s an arch on
#: the CPU of an H100 host, most of it in torch's meta kernels). jamba's
#: super-block (15 s) and internvl2 are left out; their counts are held
#: against XLA's by the CPU tests and run in the dry-run grid
VII_FLOP_ARCHS = ("granite-3-8b", "qwen3-moe-30b-a3b", "mamba2-130m",
                  "musicgen-medium")


def to_meta(torch, tree):
    """``tree`` with every tensor as a meta tensor of its shape, strides
    and dtype (ints and other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: to_meta(torch, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tree.stride(),
                                   dtype=tree.dtype, device="meta")
    return tree


def counted(torch, fn, card: bool) -> tuple[dict, dict, float]:
    """``fn()`` inside a cost counter: ``(analysis, launches, peak)``. On
    the card the kernels' launch counts over the run and the growth of the
    allocator's peak over what was allocated before; on the meta device
    ``{}`` and the counter's ``peak_bytes``."""
    from repro_torch.launch.cost_analysis import CostCounter

    if card:
        zero_counts(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with CostCounter() as cc:
        out = fn()
    del out
    a = cc.analyze()
    if not card:
        return a, {}, float(a["peak_bytes"])
    torch.cuda.synchronize()
    return a, launch_counts(), float(torch.cuda.max_memory_allocated()
                                     - base)


def cost_pair(torch, what: str, make) -> dict:
    """Gates (i) and (ii) for one run: ``make(device)`` gives the run's
    thunk on ``device``; it runs once on the card and once on the meta
    device, each inside the counter. FLOPs, bytes and every kernel entry
    must be equal, and each kernel's counted calls equal its launches."""
    a_card, launched, peak_card = counted(torch, make(torch.device("cuda")),
                                          True)
    a_meta, _, peak_meta = counted(torch, make(torch.device("meta")), False)
    for key in ("flops", "hbm_bytes", "kernels"):
        check(a_card[key] == a_meta[key],
              f"cost {what}: {key} on the card {a_card[key]} differs from "
              f"the meta run's {a_meta[key]}")
    calls = {n: k["calls"] for n, k in a_card["kernels"].items()}
    check(calls == launched, f"cost {what}: counted calls {calls}, "
          f"launches {launched}")
    print(f"  cost {what}: {a_card['flops']:.6e} FLOP, "
          f"{a_card['hbm_bytes']:.6e} B on the card and on meta; calls = "
          f"launches {launched}; peak {peak_meta / 2**20:.1f} MiB counted, "
          f"{peak_card / 2**20:.1f} MiB on the card")
    return {"flops": a_card["flops"], "hbm_bytes": a_card["hbm_bytes"],
            "kernels": a_card["kernels"], "launches": launched,
            "peak_bytes": peak_meta, "card_peak_bytes": peak_card}


def peak_gate(what: str, r: dict) -> None:
    """Gate (v): the counted peak within the predicted tolerance of the
    card's."""
    meta, card = r["peak_bytes"], r["card_peak_bytes"]
    tol = max(PEAK_REL * card, PEAK_ABS)
    print(f"  cost {what}: peak_bytes {meta:.0f} against the card's "
          f"max_memory_allocated growth {card:.0f} ({meta / card:.3f}x; "
          f"tolerance {tol:.0f} B)")
    check(abs(meta - card) <= tol, f"cost {what}: the counted peak "
          f"{meta:.0f} B is outside {tol:.0f} B of the card's {card:.0f}")


def llama_forwards(torch, cfg, params, acfg, what: str) -> dict:
    """Gates (i) and (ii) on llama-3.2-1b's static-engine forwards: a 4 x
    32 prefill into a fresh contiguous cache and one decode forward."""
    from repro_torch.core.analog import AnalogCtx
    from repro_torch.models import transformer as T

    max_len = PROMPT_LEN + NEW_TOKENS

    def prefill(dev):
        p = params if dev.type != "meta" else to_meta(torch, params)
        tokens = torch.zeros((BATCH, PROMPT_LEN), dtype=torch.long,
                             device=dev)

        def run():
            with torch.no_grad():
                caches = T.init_caches(cfg, BATCH, max_len, torch.float32,
                                       dev)
                return T.forward(p, cfg, acfg, AnalogCtx(),
                                 {"tokens": tokens}, caches=caches)[0]
        return run

    def decode(dev):
        p = params if dev.type != "meta" else to_meta(torch, params)
        caches = T.init_caches(cfg, BATCH, max_len, torch.float32, dev)
        caches["pos"] = PROMPT_LEN
        token = torch.zeros((BATCH, 1), dtype=torch.long, device=dev)

        def run():
            with torch.no_grad():
                return T.forward(p, cfg, acfg, AnalogCtx(), {"tokens": token},
                                 caches=caches, pos_offset=PROMPT_LEN)[0]
        return run

    return {"prefill": cost_pair(torch, f"{what} prefill {BATCH}x"
                                 f"{PROMPT_LEN}", prefill),
            "decode": cost_pair(torch, f"{what} decode", decode)}


def engine_forwards(torch, cfg, params, acfg, max_len: int) -> dict:
    """Gates (i) and (ii) on the continuous engine's forwards on the paged
    bf16 pool: a decode step of its ENGINE_SLOTS rows and a chunk step of
    ENGINE_CHUNK columns (the rows' tables and cursors as a fresh pool
    has them)."""
    from repro_torch.core.analog import AnalogCtx
    from repro_torch.models import transformer as T

    def step(cols):
        def make(dev):
            p = params if dev.type != "meta" else to_meta(torch, params)
            caches = T.init_caches(cfg, ENGINE_SLOTS, max_len,
                                   torch.bfloat16, dev, paged=True,
                                   kv_block_size=PAGED_BS)
            tokens = torch.zeros((ENGINE_SLOTS, cols), dtype=torch.long,
                                 device=dev)
            off = torch.zeros((ENGINE_SLOTS, 1), dtype=torch.int32,
                              device=dev)
            mask = torch.ones((ENGINE_SLOTS, cols), device=dev)

            def run():
                with torch.no_grad():
                    return T.forward(p, cfg, acfg, AnalogCtx(),
                                     {"tokens": tokens}, caches=caches,
                                     pos_offset=off, seq_mask=mask,
                                     last_only=cols > 1)[0]
            return run
        return make

    return {"decode": cost_pair(torch, "engine decode step", step(1)),
            "chunk": cost_pair(torch, f"engine chunk step of "
                               f"{ENGINE_CHUNK}", step(ENGINE_CHUNK))}


def per_launch(torch, name: str, call) -> tuple[float, int]:
    """The counted ``(flops, bytes)`` of one meta call of kernel
    ``name``."""
    a, _, _ = counted(torch, call, False)
    k = a["kernels"][name]
    check(k["calls"] == 1, f"cost {name}: {k['calls']} calls counted")
    return k["flops"], k["bytes"]


def bound_inputs_check(torch, rows: dict, ssd_rows: list) -> dict:
    """Gate (iii): one counted launch of each kernel on the meta device
    equals the ``(flops, bytes)`` its phase fed ``bound_ms`` for the same
    shape: phase 2's MVM rows (2-D and batched experts), phase 6's scans
    (the counter's chunked FLOPs and the bound's least FLOPs each by the
    package's formula, the bytes one number), and, for the paged kernels,
    whose bound counts the keys the cursors reach, a decode and a
    four-column prefill whose rows stop short of their tables' ends: the
    meta call counts the tables' capacity, the same call on CPU copies
    (its cursors readable) the attended work, which must equal
    ``paged_work`` on the card's inputs, as phase 5 feeds its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import analog_matmul as km
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import int4_matmul as k4
    from repro_torch.kernels import paged_attention as kd
    from repro_torch.kernels import paged_prefill as kp_
    from repro_torch.kernels import ssd_scan as ks

    meta = torch.device("meta")

    def mt(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    checked = {}

    def same(name, what, got, want):
        check(got == want, f"cost {name} {what}: counted {got}, the bound "
              f"took {want}")
        checked[f"{name} {what}"] = list(got)

    for name in ("analog_matmul", "int4_matmul"):
        picks = [next(r for r in rows[name] if "E" not in r)]
        picks += [r for r in rows[name] if "E" in r][:1]
        for r in picks:
            e = r.get("E", 1)
            m, k, n = r["M"], r["K"], r["N"]
            lead = (e,) if "E" in r else ()
            x = mt(*lead, m, k)
            if name == "analog_matmul":
                bound = mt(*lead, n) if r.get("noisy") else None
                off = mt(*lead, n) if r.get("col_off") else None
                got = per_launch(torch, name, lambda: km.analog_matmul(
                    x, mt(*lead, k, n), mt(1), bound, off,
                    lam=None if bound is not None else 14.0))
            else:
                got = per_launch(torch, name, lambda: k4.int4_matmul(
                    x, mt(*lead, k, n // 2, dtype=torch.uint8),
                    mt(*lead, n)))
            same(name, f"E{e} M{m} K{k} N{n}", got,
                 (r["flops"], r["bytes"]))
    for r in ssd_rows[:2]:
        cfg = get_config(r["arch"])
        b, s = r["rows"], r["tokens"]
        heads, pdim = cfg.ssm_heads, cfg.ssm_headdim
        g, n = cfg.ssm_groups, cfg.ssm_state
        got = per_launch(torch, "ssd_scan", lambda: ks.ssd_scan(
            mt(b, s, heads, pdim), mt(b, s, heads), mt(heads),
            mt(b, s, g, n), mt(b, s, g, n),
            mt(b * heads, n, pdim) if r["h0"] else None))
        # the counter counts the JAX package's chunked products (XLA's
        # count), the bound the recurrence's least work: the bytes are one
        # number, the FLOPs each the package's formula for this shape
        shape = (b, s, heads, pdim, n, g, r["h0"])
        same("ssd_scan", f"{b}x{s} h0={int(r['h0'])}",
             (kcost.ssd_scan(*shape)[0], got[1],
              kcost.ssd_scan_least(*shape)[0]),
             (got[0], r["bytes"], r["flops"]))
    dev = torch.device("cuda")
    nq, nkv, hd, bs = LLAMA_PAGED
    nrows, nb, cols = COST_PAGED
    tbl = (1 + torch.arange(nrows * nb, dtype=torch.int32, device=dev)
           ).reshape(nrows, nb)
    # row 0 up to the last block's first half, row 1 from 3 to mid-table
    pos = torch.tensor([nb * bs - bs // 2 - cols, nb * bs // 2],
                       dtype=torch.int32, device=dev)
    start = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    kp = torch.zeros((1 + nrows * nb, bs, nkv, hd), dtype=torch.bfloat16,
                     device=dev)
    for name, q in (("paged_flash_decode", torch.zeros((nrows, nq, hd),
                                                       device=dev)),
                    ("paged_flash_prefill", torch.zeros(
                        (nrows, cols, nq, hd), device=dev))):
        fn = kd.paged_flash_decode if q.dim() == 3 else kp_.paged_flash_prefill
        ins = (q, kp, kp, tbl, pos, start)
        metas = [to_meta(torch, t) for t in ins]
        a_meta, _, _ = counted(torch, lambda: fn(*metas, scale=hd ** -0.5),
                               False)
        cpus = [t.cpu() for t in ins]
        a_cpu, _, _ = counted(torch, lambda: fn(*cpus, scale=hd ** -0.5),
                              False)
        k_meta, k_cpu = a_meta["kernels"][name], a_cpu["kernels"][name]
        check(k_meta["calls"] == k_cpu["calls"] == 1,
              f"cost {name}: {k_meta['calls']} / {k_cpu['calls']} calls")
        check(k_meta["attended_flops"] is None,
              f"cost {name}: the meta call reported attended work")
        what = f"{nrows} rows, {nb} blocks"
        same(name, f"{what}, capacity",
             (k_meta["flops"], k_meta["bytes"], k_cpu["flops"],
              k_cpu["bytes"]), kcost.paged_work(q, kp, tbl) * 2)
        same(name, f"{what}, attended",
             (k_cpu["attended_flops"], k_cpu["attended_bytes"]),
             paged_work(torch, q, kp, tbl, pos, start))
    print(f"  cost (iii): {len(checked)} counted launches equal the bound's "
          "inputs: " + "; ".join(checked))
    return checked


def alloc_check(torch) -> tuple:
    """Gate (iv): the dry run's parameter bytes of full-width llama-3.2-1b
    in fp32 on a one-card host mesh against the allocator's growth across
    the real build, within ALLOC_ROUND bytes a leaf."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, device_bytes

    mesh = make_host_mesh(1, devices=1)
    plan = build_cell(ARCH, "prefill_32k", mesh, dtype=torch.float32)
    dry = device_bytes(plan.args[0], plan.arg_specs[0], mesh)
    leaves = sum(1 for _ in _leaves(plan.args[0]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cfg, params, labels = full_width(torch, ARCH)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    print(f"  cost (iv): the dry run's parameter bytes {dry} against the "
          f"allocator's growth {grown} over the build ({leaves} leaves, "
          f"{grown - dry} B apart, at most {ALLOC_ROUND * leaves} allowed)")
    check(0 <= grown - dry <= ALLOC_ROUND * leaves,
          f"cost (iv): dry run {dry} B, allocator {grown} B")
    return {"dry_run_bytes": dry, "allocated_bytes": grown,
            "leaves": leaves}, (cfg, params, labels)


def train_cost(torch) -> dict:
    """Phase 14's training step (llama-3.2-1b at TRAIN_LAYERS layers, batch
    TRAIN_BATCH x TRAIN_SEQ, the teacher inside) on the card and on the
    meta device, each in the counter: gate (v)'s peak, and (vi)'s rate
    from a timed step outside the counter."""
    from repro_torch.core import noise as noise_lib
    from repro_torch.train import train_step as ts

    acfg, tcfg = train_configs()
    cfg, params, labels = train_model(torch, ARCH)
    step = ts.make_train_step(cfg, acfg, tcfg, labels, train_lr(tcfg))
    key = noise_lib.prng_key(0)

    def make(dev):
        p = params if dev.type != "meta" else to_meta(torch, params)
        state = ts.init_train_state(p)
        tokens = torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.long,
                             device=dev)
        batch = {"tokens": tokens, "labels": tokens}
        return lambda: step(p, state, batch, key, p)

    a_card, launched, peak_card = counted(torch, make(torch.device("cuda")),
                                          True)
    a_meta, _, peak_meta = counted(torch, make(torch.device("meta")), False)
    calls = {n: k["calls"] for n, k in a_card["kernels"].items()}
    check(calls == launched, f"cost train: counted calls {calls}, "
          f"launches {launched}")
    run = make(torch.device("cuda"))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 2
    res = {"flops": a_meta["flops"], "card_flops": a_card["flops"],
           "hbm_bytes": a_meta["hbm_bytes"], "kernels": a_meta["kernels"],
           "peak_bytes": peak_meta, "card_peak_bytes": peak_card,
           "step_ms": ms, "tflop_per_s": a_meta["flops"] / ms / 1e9}
    print(f"  cost train step ({ARCH}, {TRAIN_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): {a_meta['flops']:.6e} FLOP counted "
          f"on meta ({a_card['flops']:.6e} on the card), {ms:.2f} ms a step "
          f"on the card: {res['tflop_per_s']:.2f} TFLOP/s; calls = launches "
          f"{launched}")
    del params
    return res


def decode_block_cost(torch, phase8: dict) -> tuple:
    """(vi): the counted FLOPs of phase 8's graphed decode step (llama
    analog_hw on the engine's bf16 pool, ENGINE_SLOTS rows at the engine's
    max_len), on the meta device, beside its measured device time."""
    from repro_torch.core.analog import AnalogConfig, AnalogCtx
    from repro_torch.models import transformer as T
    from repro_torch.serve.scheduler import required_max_len

    cfg = model_config(ARCH)
    params, _ = T.init_model(None, cfg, torch.float32, torch.device("meta"))
    reqs = engine_requests(cfg, ENGINE_REQUESTS, seed=0)
    max_len = max(required_max_len(len(r.prompt), r.max_new, ENGINE_CHUNK)
                  for r in reqs)
    meta = torch.device("meta")
    caches = T.init_caches(cfg, ENGINE_SLOTS, max_len, torch.bfloat16, meta,
                           paged=True, kv_block_size=PAGED_BS)
    acfg = AnalogConfig(mode="analog", use_pallas=True)
    token = torch.empty((ENGINE_SLOTS, 1), dtype=torch.long, device=meta)
    off = torch.empty((ENGINE_SLOTS, 1), dtype=torch.int32, device=meta)
    a, _, _ = counted(torch, lambda: T.forward(
        params, cfg, acfg, AnalogCtx(), {"tokens": token}, caches=caches,
        pos_offset=off, seq_mask=torch.empty((ENGINE_SLOTS, 1),
                                             device=meta))[0], False)
    ms = phase8["decode_device_ms"]
    # the meta count holds the paged calls at their tables' capacity; the
    # rate divides the work of phase 8's replayed step, whose cursors
    # (read there) reach fewer keys
    k = a["kernels"]["paged_flash_decode"]
    attended = (a["flops"] - k["flops"]
                + k["calls"] * phase8["decode_paged"]["attended"][0])
    res = {"flops": attended, "capacity_flops": a["flops"],
           "kernels": a["kernels"], "device_ms": ms,
           "tflop_per_s": attended / ms / 1e9, "max_len": max_len}
    print(f"  cost decode step ({ARCH} analog_hw, {ENGINE_SLOTS} slots, "
          f"max_len {max_len}, graphed): {attended:.6e} FLOP attended "
          f"({a['flops']:.6e} counted on meta at the tables' capacity), "
          f"{ms:.4f} ms on the device (phase 8): "
          f"{res['tflop_per_s']:.3f} TFLOP/s")
    return res, max_len


def dryrun_train_cells(torch) -> dict:
    """(vii): the ``train_4k`` cell of every ARCH_NAMES arch on the single
    production mesh, on the meta device: per-device argument bytes at full
    depth from the cell's specs, and for the VII_FLOP_ARCHS the counted
    FLOPs of the step at one layer pattern (one layer, or a hybrid's
    super-block) with the seconds of that meta run."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, device_bytes

    mesh = make_production_mesh()
    out = {}
    for arch in ARCH_NAMES:
        plan = build_cell(arch, "train_4k", mesh)
        arg = device_bytes(plan.args, plan.arg_specs, mesh)
        cfg = get_config(arch)
        depth = max(cfg.attn_every, cfg.moe_every, 1)
        res = {"argument_bytes_per_device": arg}
        what = ""
        if arch in VII_FLOP_ARCHS:
            t0 = time.perf_counter()
            cut = build_cell(arch, "train_4k", mesh,
                             arch_overrides={"num_layers": depth})
            flops = cut.analyze()[0]["flops"]
            res.update(flops_layers=depth, flops=flops,
                       meta_s=time.perf_counter() - t0)
            what = (f"; {flops:.4e} FLOP at {depth} layer(s) "
                    f"({res['meta_s']:.1f} s on meta)")
        out[arch] = res
        print(f"  dry run {arch} train_4k single: "
              f"{arg / 2**30:.3f} GiB of arguments per device{what}")
    return out


def phase_cost(torch, rows: dict, ssd_rows: list, phase8: dict) -> dict:
    """Phase 24: the cost counter against the card, and the dry run."""
    import dataclasses as dc

    from repro_torch.launch.serve import deploy_model

    t0 = time.perf_counter()
    print(f"  {gpu_name_and_power()}")
    alloc, (cfg, params, labels) = alloc_check(torch)
    out = {"alloc": alloc}
    gen = torch.Generator(device="cuda").manual_seed(0)
    p_hw, acfg_hw = deploy_model(_deploy_args("analog_hw"), cfg, params,
                                 labels, gen, inplace=True)
    acfg_hw = dc.replace(acfg_hw, use_pallas=True)
    out["analog_hw"] = llama_forwards(torch, cfg, p_hw, acfg_hw, "analog_hw")
    check(out["analog_hw"]["prefill"]["launches"]
          == {"analog_matmul": LAUNCHES_PER_FORWARD},
          f"cost: the prefill launched {out['analog_hw']['prefill']}")
    peak_gate(f"{ARCH} analog_hw prefill", out["analog_hw"]["prefill"])
    p_i4, acfg_i4 = deploy_model(_deploy_args("digital_int4"), cfg, p_hw,
                                 labels, gen)
    out["digital_int4"] = llama_forwards(torch, cfg, p_i4, acfg_i4,
                                         "digital_int4")
    del p_i4
    block, max_len = decode_block_cost(torch, phase8)
    out["engine"] = engine_forwards(torch, cfg, p_hw, acfg_hw, max_len)
    del p_hw, params
    torch.cuda.empty_cache()

    from repro_torch.core.analog import AnalogConfig, AnalogCtx
    from repro_torch.models import build
    from repro_torch.models import transformer as T

    mcfg, mparams, _ = build(MAMBA, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")

    def mamba_prefill(dev):
        p = mparams if dev.type != "meta" else to_meta(torch, mparams)
        tokens = torch.zeros((BATCH, PROMPT_LEN), dtype=torch.long,
                             device=dev)

        def run():
            with torch.no_grad():
                caches = T.init_caches(mcfg, BATCH, PROMPT_LEN,
                                       torch.float32, dev)
                return T.forward(p, mcfg, AnalogConfig(mode="off"),
                                 AnalogCtx(), {"tokens": tokens},
                                 caches=caches)[0]
        return run

    out["mamba_prefill"] = cost_pair(torch, f"{MAMBA} prefill {BATCH}x"
                                     f"{PROMPT_LEN}", mamba_prefill)
    del mparams
    torch.cuda.empty_cache()
    out["bounds"] = bound_inputs_check(torch, rows, ssd_rows)
    out["train"] = train_cost(torch)
    peak_gate(f"{ARCH} train step", out["train"])
    out["decode_block"] = block
    torch.cuda.empty_cache()
    out["dryrun"] = dryrun_train_cells(torch)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 25: sharded training state on one card
# ---------------------------------------------------------------------------

# llama-3.2-1b at full width and SHARD_LAYERS of its 16 layers, phase 14's
# batch, SHARD_STEPS steps on each mesh (data x model; every position on
# the one card), against the unsharded step
SHARD_LAYERS = 2
SHARD_STEPS = 3
SHARD_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))
# gate (ii): tests/test_torch_sharded_train.py's rule, B·S·u: each gradient
# element is a sum over the batch's tokens, which a sharded step adds in
# another order (u = 2^-24); parameters (every input_range among them: the
# EMA init sets it from the pooled x_std, a few u from the whole batch's),
# losses and the gradient norm within SHARD_TOL · (1 + |x|), each moment
# leaf within 2 · SHARD_TOL of its scale, K times that for an input
# range's moments, whose gradient sums K times the terms (sharded_apart).
# Each step starts from the unsharded run's state before it, so both sides
# take the same inputs. A free-running data-2 run goes on from its own
# state; it prints how far that drifts from the unsharded run's
# (sharded_drift), not gated, and how many of step 2's DAC and ADC codes
# differ between the two runs' parameters (sharded_code_moves)
SHARD_TOL = TRAIN_BATCH * TRAIN_SEQ * 2.0 ** -24
# gate (iv): psum_compressed over this many shards of a [K, N] leaf
PSUM_SHARDS, PSUM_SHAPE = 4, (2048, 2048)


def sharded_apart(torch, got, want) -> dict:
    """Gate (ii)'s worst errors of a gathered ``(params, state)`` against
    the unsharded one, and the leaf of each: ``"params"``, max |a - b| /
    (1 + |b|); ``"moments"``, per leaf max |Δv| / max |v| and max |Δm| over
    (1 - b1) max sqrt(v̂) (v̂ = v / (1 - b2^t): the RMS gradient, the size
    of one step's part of m, which may itself cancel across steps). An
    ``input_range``'s gradient sums over every element of its site's
    input, K times the tokens, so its moments' errors are divided by K
    (its value's are not)."""
    from repro_torch.checkpoint import flatten_paths
    from repro_torch.optim.adamw import AdamWConfig

    ad = AdamWConfig()
    out = {"params": (0.0, None), "moments": (0.0, None)}
    (p, s), (p0, s0) = got, want
    fp, f0 = flatten_paths(p), flatten_paths(p0)

    def terms(k):
        if not k.endswith("input_range"):
            return 1
        return f0[k[:-len("input_range")] + "kernel"].shape[-2]
    for k, v in f0.items():
        e = float(((fp[k] - v).abs() / (1 + v.abs())).max())
        if e > out["params"][0]:
            out["params"] = (e, k)
    t = int(s0["opt"]["count"])
    fm, fv = flatten_paths(s["opt"]["m"]), flatten_paths(s["opt"]["v"])
    for k, v in flatten_paths(s0["opt"]["v"]).items():
        m = flatten_paths(s0["opt"]["m"])[k]
        rms = float(torch.sqrt(v.abs().max() / (1 - ad.b2 ** t)))
        for name, a, b, scale in (
                (f"m:{k}", fm[k], m, (1 - ad.b1) * rms),
                (f"v:{k}", fv[k], v, float(v.abs().max()))):
            e = float((a - b).abs().max()) / max(scale, 1e-30) / terms(k)
            if e > out["moments"][0]:
                out["moments"] = (e, name)
    return out


def sharded_equal(torch, a, b) -> list:
    """The leaves of two gathered trees that differ (bit for bit)."""
    from repro_torch.checkpoint import flatten_paths

    fa = flatten_paths(a)
    return [k for k, v in flatten_paths(b).items()
            if not torch.equal(fa[k], v)]


def sharded_drift(torch, got, want, init) -> dict:
    """A free-running sharded run's state against the unsharded run's
    (``train_state_apart``'s rule): the largest per-leaf L2 ratio |a - b| /
    |b - init| over the parameters (the unsharded update since the start)
    and |a - b| / |b| over the moments."""
    from repro_torch.checkpoint import flatten_paths

    (p, s), (p0, s0) = got, want
    f_init = flatten_paths(init)
    out = {}
    for group, a_tree, b_tree in (
            ("params", p, p0),
            ("moments", {"m": s["opt"]["m"], "v": s["opt"]["v"]},
             {"m": s0["opt"]["m"], "v": s0["opt"]["v"]})):
        fa, worst = flatten_paths(a_tree), (0.0, None)
        for k, b in flatten_paths(b_tree).items():
            d = float(torch.linalg.vector_norm(fa[k] - b))
            if d == 0.0:
                continue
            ref = b - f_init[k] if group == "params" else b
            n = float(torch.linalg.vector_norm(ref))
            if (d / n if n > 0 else float("inf")) > worst[0]:
                worst = (d / n if n > 0 else float("inf"), k)
        out[group] = worst
    return out


def sharded_run(torch, cfg, params, labels, teacher, batch, mesh, base,
                forced: bool = True):
    """SHARD_STEPS steps of phase 14's train step (teacher inside) under
    ``mesh`` (None: unsharded), the teacher placed by its ZeRO specs. The
    first is a warm-up, the second timed on the host clock, the last run
    in the cost counter (its all-gather and reduce-scatter bytes). Where
    ``base`` (the unsharded run's steps) is given, each step is held
    against it: ``forced``, each step starts from the unsharded run's
    state before it (placed on the mesh outside the timer), so both sides
    take the same inputs and only the gradient sum's order parts them
    (``sharded_apart``); otherwise the run goes on from its own state and
    the drift is read (``sharded_drift``). Returns the run's record, its
    final ``(params, state)`` and, for the unsharded run, every step's
    ``(params, state, metrics)`` (for a free-running one, the first
    step's ``(params, metrics)``, gathered)."""
    from repro_torch.distributed import placement
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.train import train_step as ts

    acfg, tcfg = train_configs()
    step = ts.make_train_step(cfg, acfg, tcfg, labels, train_lr(tcfg))
    key = noise_key()
    under = (contextlib.nullcontext() if mesh is None
             else shd.activate(mesh, shd.default_rules(mesh)))
    p, st = params, ts.init_train_state(params)
    steps, ms, coll = [], None, {}
    zero_counts(torch)
    torch.cuda.reset_peak_memory_stats()
    with under:
        t_ = teacher if mesh is None else placement.place_by(teacher, mesh)
        for i in range(SHARD_STEPS):
            if forced and base is not None and i > 0:
                p = placement.place_by(base[i - 1][0], mesh)
                st = placement.place_by(base[i - 1][1], mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == SHARD_STEPS - 1:
                with CostCounter() as cc:
                    p, st, m = step(p, st, batch, key, t_)
                coll = cc.analyze()["collective_bytes"]
            else:
                p, st, m = step(p, st, batch, key, t_)
            torch.cuda.synchronize()
            if i == 1:
                ms = (time.perf_counter() - t0) * 1e3
            m = {k: float(v) for k, v in m.items()}
            steps.append(m)
            if base is not None:
                got = (placement.gather_tree(p), placement.gather_tree(st))
                steps[-1]["apart"] = (
                    sharded_apart(torch, got, base[i][:2]) if forced
                    else sharded_drift(torch, got, base[i][:2], params))
                if not forced and i == 0:
                    steps[-1]["tree"] = (got[0],)
                del got
            elif mesh is None:
                steps[-1]["tree"] = (p, st)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # what the counted step's collectives must move: the split
        # parameter leaves gathered at its start and after AdamW, the
        # teacher's once; their gradients' slices scattered
        split = [x for x in placement._leaves(p)
                 if isinstance(x, placement.Placed) and len(x.blocks()) > 1]
        want = {"all-gather": 3.0 * sum(x.numel() * x.element_size()
                                        for x in split),
                "reduce-scatter": float(sum(
                    x.parts[0].numel() * x.element_size() for x in split))}
        held = {"p": p, "m": st["opt"]["m"], "v": st["opt"]["v"], "t": t_}
        state_bytes = (placement.position_bytes(held) if mesh
                       else [placement.tree_bytes(held)])
    rec = {"steps": [{k: v for k, v in s.items() if k != "tree"}
                     for s in steps], "ms": ms, "launches": launches,
           "peak_gb": peak_gb, "collective_bytes": dict(coll),
           "collective_want": want,
           "largest_state_bytes": max(state_bytes)}
    return rec, (p, st), [s.pop("tree") + (s,) for s in steps
                          if "tree" in s]


def sharded_code_moves(torch, cfg, p_a, p_b, batch) -> dict:
    """Step 2's forward (the whole batch, step 2's noise, no remat) from
    two runs' parameters after step 1: how many DAC codes (eq. 1's
    ``round(clip(x) · Q / beta)``) and ADC codes (eq. 2's, read back from
    each site's output over its bound) differ between them, of how many.
    A token position is reached once a code moved there or, through
    attention, at an earlier position of its sequence at an earlier site;
    codes that move where nothing reached (first moves) can only have
    lain at a rounding tie: for them, the largest distance of a DAC
    value from its tie beside the largest DAC input change there (code
    units), and the largest ADC move in levels where no DAC code of the
    site moved."""
    from repro_torch.core import noise as noise_lib
    from repro_torch.kernels import ref as kref
    from repro_torch.train import train_step as ts

    acfg, tcfg = train_configs()
    loss_fn = ts.make_loss_fn(cfg, acfg, dataclasses.replace(tcfg,
                                                             remat=False))
    q_in, q_out = kref.qmax(acfg.input_bits), kref.qmax(acfg.output_bits)
    sides = []
    for params in (p_a, p_b):
        calls = []

        def spy(pp, x, cfg_, ctx):
            y, st = real(pp, x, cfg_, ctx)
            beta = torch.clamp_min(pp["input_range"].reshape(()).float(),
                                   1e-8)
            v = torch.clamp(x.float(), -beta, beta) * kref.rdiv(q_in, beta)
            bound = kref.adc_bound(pp["kernel"], beta, acfg.out_bound)
            calls.append((v, torch.round(y.float() * kref.rdiv(
                q_out, bound)).to(torch.int16)))
            return y, st

        with torch.no_grad(), sites_replaced(spy) as real:
            loss_fn(params, batch, noise_lib.fold_in(noise_key(), 1))
        sides.append(calls)
    check(len(sides[0]) == len(sides[1]) == mvm_sites(cfg),
          f"sharded codes: {len(sides[0])} / {len(sides[1])} site calls")
    out = {"dac_moved": 0, "dac_total": 0, "adc_moved": 0, "adc_total": 0,
           "dac_first": 0, "adc_first": 0, "first_tie_distance": 0.0,
           "first_input_change": 0.0, "first_adc_levels": 0}
    reach = torch.zeros(batch["tokens"].shape[:2], dtype=torch.bool,
                        device=batch["tokens"].device)
    for (va, ya), (vb, yb) in zip(*sides):
        dac = torch.round(va) != torch.round(vb)
        adc = ya != yb
        out["dac_moved"] += int(dac.sum())
        out["adc_moved"] += int(adc.sum())
        out["dac_total"] += va.numel()
        out["adc_total"] += ya.numel()
        clean = ~reach
        if bool(clean.any()):
            out["first_input_change"] = max(out["first_input_change"], float(
                (va - vb).abs()[clean].max()))
        first = dac & clean[..., None]
        out["dac_first"] += int(first.sum())
        if bool(first.any()):
            out["first_tie_distance"] = max(out["first_tie_distance"], float(
                (va[first] - torch.floor(va[first]) - 0.5).abs().max()))
        first = adc & (clean & ~dac.any(-1))[..., None]
        out["adc_first"] += int(first.sum())
        if bool(first.any()):
            out["first_adc_levels"] = max(out["first_adc_levels"], int(
                (ya[first].int() - yb[first].int()).abs().max()))
        moved = dac.any(-1) | adc.any(-1)
        reach |= torch.cummax(moved.int(), dim=1).values.bool()
    return out


def clone_tree(tree):
    """A copy of every tensor leaf of a nested dict."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def psum_card_check(torch) -> dict:
    """Gate (iv): ``psum_compressed`` over PSUM_SHARDS shards (the second
    all zeros) on the card equals the CPU's bit for bit."""
    from repro_torch.optim.compression import psum_compressed

    gen = torch.Generator().manual_seed(25)
    shards = [torch.randn(PSUM_SHAPE, generator=gen) * 10.0 ** (i - 2)
              for i in range(PSUM_SHARDS)]
    shards[1].zero_()
    cpu = psum_compressed(shards)
    card = psum_compressed([s.cuda() for s in shards]).cpu()
    diff = int((card != cpu).sum())
    check(diff == 0, f"sharded: psum_compressed on the card parts from the "
          f"CPU's at {diff} of {cpu.numel()} elements")      # gate (iv)
    print(f"  gate (iv): psum_compressed over {PSUM_SHARDS} shards of "
          f"{list(PSUM_SHAPE)} (one all zeros) on the card equals the CPU's "
          f"bit for bit")
    return {"elements": cpu.numel()}


def sharded_launcher(torch) -> dict:
    """The training launcher as a user runs it (``python -m
    repro_torch.launch.train --reduced``, 2 pre-training and 2
    distillation steps): the host mesh over the visible cards, data =
    their count, its state placed there."""
    from repro_torch.checkpoint import flatten_paths
    from repro_torch.distributed import placement
    from repro_torch.launch import train as train_cli

    zero_counts(torch)
    t0 = time.perf_counter()
    trainer = train_cli.main(["--reduced", "--steps", "2",
                              "--pretrain-steps", "2", "--batch", "4",
                              "--seq", "32"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    leaf = flatten_paths(trainer.params)["embed/tokens"]
    n = torch.cuda.device_count()
    check(int(trainer.state["step"]) == 2
          and isinstance(leaf, placement.Placed)
          and leaf.mesh.shape == {"data": n, "model": 1}
          and math.isfinite(trainer.history[-1]["kd"]),
          f"sharded launcher: step {int(trainer.state['step'])}, mesh "
          f"{getattr(leaf, 'mesh', None)}")
    print(f"  launcher (python -m repro_torch.launch.train --reduced, 2 + 2 "
          f"steps): host mesh {leaf.mesh.shape} over the {n} visible "
          f"card(s) in {secs:.1f} s, final KD loss "
          f"{trainer.history[-1]['kd']:.4f}")
    return {"s": secs, "launches": launch_counts()}


def phase_sharded(torch) -> dict:
    """Phase 25: phase 14's HWA step (llama-3.2-1b at full width,
    SHARD_LAYERS layers, batch TRAIN_BATCH x TRAIN_SEQ, the teacher inside)
    over placed meshes whose positions all sit on the one card, with gates
    (i) (1, 1) bit for bit the unsharded step, (ii) data 2, 4 and (2, 2)
    each step within SHARD_TOL of the unsharded step from the same state
    (a free-running data-2 run's drift is printed), (iii) a reshard
    4 → 2 value-exact and the step after it bit-exact against the
    gathered state placed afresh, (iv) ``psum_compressed`` card = CPU;
    each run's launches (data shards x the unsharded count) and the
    collectives' bytes, against what the placement moves; the free run's
    moved DAC / ADC codes at step 2; the training launcher on the host
    mesh."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import MarkovCorpus
    from repro_torch.distributed import elastic, placement
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh, place_mesh
    from repro_torch.models import build
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    print(f"  {gpu_name_and_power()}; every mesh position on this one "
          f"card: the runs show parity and placement, not a memory saving")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_config(ARCH), num_layers=SHARD_LAYERS)
    cfg, params, labels = build(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
    check((cfg.num_layers, cfg.d_model) == (SHARD_LAYERS, 2048),
          f"sharded: unexpected config {cfg}")
    teacher = clone_tree(params)     # distill_recipe's: the student's copy
    raw = MarkovCorpus(cfg.vocab_size, seed=0).sample(TRAIN_BATCH,
                                                      TRAIN_SEQ + 1)
    batch = {"tokens": torch.as_tensor(raw[:, :-1], dtype=torch.int64,
                                       device=dev),
             "labels": torch.as_tensor(raw[:, 1:], dtype=torch.int64,
                                       device=dev)}
    per_step = train_step_launches(cfg)["analog_matmul"]
    whole = placement.tree_bytes(params)
    out = {}
    base_rec, _, base = sharded_run(torch, cfg, params, labels, teacher,
                                    batch, None, None)
    out["unsharded"] = base_rec
    ms0 = base_rec["ms"]
    print(f"  unsharded: {ms0:.1f} ms a step, {base_rec['launches']} "
          f"launches in {SHARD_STEPS} steps, peak {base_rec['peak_gb']:.2f} "
          f"GB; state (params, moments, teacher) "
          f"{base_rec['largest_state_bytes'] / 1e9:.3f} GB")
    for shape in SHARD_MESHES:
        mesh = place_mesh(Mesh(("data", "model"), shape),
                          [dev] * (shape[0] * shape[1]))
        name = "x".join(map(str, shape))
        rec, final, _ = sharded_run(torch, cfg, params, labels, teacher,
                                    batch, mesh, base)
        out[name] = rec
        n = shape[0]
        check(rec["launches"] == {"analog_matmul":
                                  n * per_step * SHARD_STEPS},
              f"sharded {name}: launches {rec['launches']}, expected "
              f"{n} x {per_step} a step")
        worst = {k: max(s["apart"][k][0] for s in rec["steps"])
                 for k in ("params", "moments")}
        loss_err = max(abs(s["loss"] - b["loss"]) / (1 + abs(b["loss"]))
                       for s, b in zip(rec["steps"], base_rec["steps"]))
        gn_err = max(abs(s["grad_norm"] - b["grad_norm"])
                     / (1 + abs(b["grad_norm"]))
                     for s, b in zip(rec["steps"], base_rec["steps"]))
        rec["worst"] = dict(worst, loss=loss_err, grad_norm=gn_err)
        if shape == (1, 1):                                    # gate (i)
            check(all(v == 0.0 for v in rec["worst"].values()),
                  f"sharded 1x1: apart from the unsharded step "
                  f"{rec['worst']} ({rec['steps'][-1]['apart']})")
        else:                                                  # gate (ii)
            check(worst["params"] <= SHARD_TOL and loss_err <= SHARD_TOL
                  and gn_err <= SHARD_TOL
                  and worst["moments"] <= 2 * SHARD_TOL,
                  f"sharded {name}: {rec['worst']} against {SHARD_TOL:.3e} "
                  f"({[s['apart'] for s in rec['steps']]})")
        ag = rec["collective_bytes"].get("all-gather", 0)
        rs = rec["collective_bytes"].get("reduce-scatter", 0)
        check({"all-gather": ag, "reduce-scatter": rs}
              == rec["collective_want"],
              f"sharded {name}: counted {rec['collective_bytes']}, the "
              f"placement moves {rec['collective_want']}")
        print(f"  {name}: {rec['ms']:.1f} ms a step ({rec['ms'] / ms0:.2f}x "
              f"unsharded), analog_matmul {rec['launches']['analog_matmul']} "
              f"launches ({n} data shards x {per_step} a step x "
              f"{SHARD_STEPS}), peak {rec['peak_gb']:.2f} GB; largest "
              f"position's state {rec['largest_state_bytes'] / 1e9:.3f} GB "
              f"of {base_rec['largest_state_bytes'] / 1e9:.3f} GB unsharded "
              f"(params {whole / 1e9:.3f} GB); counted in step "
              f"{SHARD_STEPS}: all-gather {ag} B, reduce-scatter {rs} B; "
              f"apart from unsharded: params {worst['params']:.3e}, moments "
              f"{worst['moments']:.3e}, loss {loss_err:.3e}, grad norm "
              f"{gn_err:.3e} ({'bit for bit' if shape == (1, 1) else f'gate {SHARD_TOL:.3e}'})")
        if shape == (4, 1):                                    # gate (iii)
            m2 = place_mesh(Mesh(("data", "model"), (2, 1)), [dev] * 2)
            tree = {"params": final[0], "state": final[1]}
            t0 = time.perf_counter()
            moved = elastic.reshard(tree, m2)
            reshard_s = time.perf_counter() - t0
            whole_t = placement.gather_tree(tree)
            apart = sharded_equal(torch, placement.gather_tree(moved),
                                  whole_t)
            check(not apart, f"sharded reshard 4 -> 2: {apart[:3]} differ")
            fresh = placement.place_by(whole_t, m2)
            del tree, final, whole_t
            acfg, tcfg = train_configs()
            step = ts.make_train_step(cfg, acfg, tcfg, labels,
                                      train_lr(tcfg))
            outs = []
            with shd.activate(m2, shd.default_rules(m2)):
                t_ = placement.place_by(teacher, m2)
                for t in (moved, fresh):
                    np_, ns, nm = step(t["params"], t["state"], batch,
                                       noise_key(), t_)
                    outs.append(placement.gather_tree(
                        {"params": np_, "opt": ns["opt"],
                         "loss": nm["loss"]}))
                    del np_, ns
            del moved, fresh, t_
            apart = sharded_equal(torch, outs[0], outs[1])
            check(not apart, f"sharded resumed step: {apart[:3]} differ")
            out["reshard"] = {"s": reshard_s}
            print(f"  gate (iii): reshard 4 -> 2 in {reshard_s:.2f} s, every "
                  f"leaf equal; the next step on data 2 equals the step from "
                  f"the gathered state placed afresh, bit for bit")
            del outs
        final = None
        torch.cuda.empty_cache()
    m2 = place_mesh(Mesh(("data", "model"), (2, 1)), [dev] * 2)
    rec, _, first = sharded_run(torch, cfg, params, labels, teacher, batch,
                                m2, base, forced=False)
    out["2x1/free"] = rec
    rec["codes"] = sharded_code_moves(torch, cfg, base[0][0], first[0][0],
                                      batch)
    del first
    print(f"  2x1 free-running {SHARD_STEPS} steps (not gated): loss "
          + ", ".join(f"{s_['loss']:.6f}" for s_ in rec["steps"])
          + " (unsharded " + ", ".join(f"{b['loss']:.6f}"
                                       for b in base_rec["steps"])
          + "); state apart per leaf in L2 after each step, params over "
          "the unsharded update / moments: " + "; ".join(
              f"{s_['apart']['params'][0]:.3e} ({s_['apart']['params'][1]})"
              f" / {s_['apart']['moments'][0]:.3e} "
              f"({s_['apart']['moments'][1]})" for s_ in rec["steps"]))
    c = rec["codes"]
    print(f"  2x1 free-running step 2's forward from each run's parameters "
          f"after step 1 (whole batch, step 2's noise): DAC codes moved "
          f"{c['dac_moved']} of {c['dac_total']}, ADC codes "
          f"{c['adc_moved']} of {c['adc_total']}; where nothing had reached "
          f"the position: {c['dac_first']} DAC codes, each within "
          f"{c['first_tie_distance']:.3e} of its rounding tie (DAC inputs "
          f"there changed by at most {c['first_input_change']:.3e} code "
          f"units), and {c['adc_first']} ADC codes, by at most "
          f"{c['first_adc_levels']} level, at positions whose DAC codes "
          f"all held")
    del base, params, teacher
    torch.cuda.empty_cache()
    out["launcher"] = sharded_launcher(torch)
    out["psum"] = psum_card_check(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


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


def line_launches(results: dict) -> dict:
    """Each kernel's launches on every main-path run that drove it, by
    path: the static engines (phases 3, 4, 7, 11, 16 and 17), the
    continuous engines (phases 8, 16 and 17), the noisy evals (phase 12),
    best-of-n
    (phase 13), the HWA distillation runs (phases 14 and 18: the student's
    forward and its remat recomputation, and the teacher's forward that
    gives each batch its logits) and the PTQ model's evals on the kernels
    (phase 15), and the ageing chip's static and continuous runs (phase
    19, every launch with ``col_off``), and phase 20's cold, prime and
    warm runs of the prefix cache, and phase 21's priming and measured
    runs of each deployment and drafter, and phase 22's closed-loop run,
    open-loop runs, speculative lifecycle runs (each drafter's probes,
    cancel and fault) and HTTP run, and phase 23's tensor-parallel runs
    (each degree's, the gated tp = 3 one too), and phase 25's training runs
    (unsharded and on each mesh). Each count was read right after
    its run, with every count set to 0 right before it. Not counted: the
    kernel comparisons (phases 2, 5, 6 and the gates (i) of 14 and 18),
    the reduced checks against the CPU (phases 9, 12, 14, 15, 16, 17, 18,
    19, 20 and 21), phase 13's independent best-of-n run (the check of the
    fork-aware one), phase 21's recorded re-runs and forward timings,
    phase 19's graph check, the timing replays and
    the fused-against-unfused checks after each run (site parity, the
    token attribution), phase 22's recorded replays (only where a request
    parts), the CLI (phase 10), the training phases' profiled steps
    and resume checks, phase 23's shard-plan checks and decode
    timings, and phase 25's steps after a reshard."""
    out = {name: {} for name in LINE_PATHS}

    def add(path: str, launches: dict) -> None:
        for name, n in launches.items():
            if n:
                out[name][path] = n

    add("static/analog_hw", {"analog_matmul": results["analog"]["launches"]})
    add("static/digital_int4", {"int4_matmul": results["int4"]["launches"]})
    add(f"static/{PHI3}/analog_hw",
        {"analog_matmul": results["phi3_analog"]["launches"]})
    add(f"static/{PHI3}/digital_int4",
        {"int4_matmul": results["phi3_int4"]["launches"]})
    for deploy in ("fp", "analog_hw", "digital_int4"):
        add(f"static/{MAMBA}/{deploy}",
            results["mamba_static"][deploy]["launches"])
    for key, r in results["engine"].items():
        add(f"continuous/{key}", r["launches"])
    for key, r in results["engine_mamba"].items():
        add(f"continuous/{MAMBA}/{key}", r["launches"])
    for arch in (ARCH, PHI3):
        ev = results["eval"][arch]
        for deploy in ("hw", "digital_int4", "gaussian"):
            add(f"eval/{arch}/{deploy}", ev[deploy]["launches"])
        add(f"best_of_n/{arch}/analog_hw",
            results["best_of_n"][arch]["launches"])
    add(f"train/{ARCH}/analog", results["train"]["launches"])
    for arch in TRAIN_FAMILY_ARCHS:
        add(f"train/{arch}/analog",
            results["train_families"][arch]["launches"])
    for arch in (ARCH, PHI3):
        for deploy in ("analog_hw", "digital_int4"):
            add(f"ptq/{arch}/{deploy}",
                results["ptq"][arch][deploy]["launches"])
    moe = results["moe"]
    add(f"static/{MOE}/analog_hw", {"analog_matmul":
                                    moe["analog"]["launches"]})
    add(f"static/{MOE}/digital_int4", {"int4_matmul":
                                       moe["int4"]["launches"]})
    for key, r in moe["engine"].items():
        add(f"continuous/{MOE}/{key}", r["launches"])
    fam = results["families"]
    for arch in FAMILY_ARCHS:
        for key, deploy in (("analog", "analog_hw"), ("int4",
                                                      "digital_int4")):
            add(f"static/{arch}/{deploy}",
                fam[f"{arch}/{key}"]["kernel_launches"])
    add(f"continuous/{JAMBA}/analog_hw/kv16", fam["engine"]["launches"])
    dev = results["devices"]
    add("devices/static/analog_hw", {"analog_matmul":
                                     dev["static"]["launches"]})
    add("devices/continuous/analog_hw/kv16", dev["engine"]["launches"])
    for key, r in results["prefix"].items():
        if key == "reduced":
            continue
        for run in ("cold", "prime", "warm"):
            add(f"prefix/{key}/{run}", r[run]["launches"])
    for key, r in results["speculative"].items():
        if key in ("times", "shapes", "reduced", "phase_s", "seconds"):
            continue
        add(f"speculative/{key}/prime", r["prime"]["launches"])
        add(f"speculative/{key}", r["launches"])
    for key, r in results["lifecycle"]["runs"].items():
        add(f"lifecycle/{key}", r["launches"])
    for key, r in results["tp"].items():
        if key in ("shard_plans", "phase_s"):
            continue
        if key.endswith("/tp3"):
            add(f"tp/{key}", r["launches"])
            continue
        for tp, run in r["runs"].items():
            add(f"tp/{key}/tp{tp}", run["launches"])
    for arch in VLM_AUDIO_TRAIN:
        add(f"train/{arch}/analog",
            results["train_families"][arch]["launches"])
    for key, r in results["sharded"].items():
        if key not in ("reshard", "psum", "phase_s"):
            add(f"sharded/{ARCH}/{key}", r["launches"])
    return out


def kernels_line(rows: dict, paged_rows: dict, ssd_rows: list,
                 launches: dict) -> dict:
    """One entry per kernel.

    ``launches`` is the sum of ``launches_by_path``, the kernel's count on
    each main-path run that drove it (:func:`line_launches`). The times
    describe one run only, the one that ``path`` names, so they sum fewer
    launches than ``launches`` counts:

    ``analog_matmul`` / ``int4_matmul``: ``ms``, ``plain_ms``,
    ``bound_ms`` and the yardstick ``matmul_ms`` are totals over the
    launches of one llama-3.2-1b static-engine run (1 prefill forward at M
    = 128 + 16 decode forwards at M = 4, 65 sites each), summed from the
    per-shape times of phase 2 without col_off (that run carries none; the
    devices paths of phase 19 carry it on every launch); ``bound_ms``
    sums each launch's bound (the tensor-core one on the mma mapping),
    ``fp32_bound_ms`` the fp32 bound of every launch. For
    ``analog_matmul`` ``ms`` and ``plain_ms`` are the main path's call, the
    ADC bound folded in; ``explicit_bound_ms`` is the kernel with the bound
    given and ``adc_bound_ms`` the bound pass that the fold replaced.
    ``wall_ms`` is the same total by CUDA events around back-to-back calls,
    host dispatch gaps included.

    ``paged_flash_decode`` / ``paged_flash_prefill``: the times are per
    launch at the phase-5 case named in ``case`` (llama-3.2-1b's heads, the
    engine's bf16 pool, one split, context 512); ``library_ms`` is gather
    ``kp[tbl]`` + ``scaled_dot_product_attention`` on the same inputs;
    ``max_abs_err`` is the largest over all phase-5 cases.

    ``ssd_scan``: the times are per launch at the phase-6 case named in
    ``case`` (the engine's chunk, ``SSD_LINE_CASE``); ``max_abs_err`` is the
    largest over all phase-6 cases, y and final state; ``bound_ms`` is the
    recurrence's work (2 N P FMAs per token and head,
    ``repro_torch.kernels.cost.ssd_scan_least``) as split TF32 on the
    tensor cores against the bytes (phase 6's rows keep PR 13's L = 32
    fp32 bound beside it as ``l32_bound_ms``); ``library_ms`` is
    null (no single PyTorch call computes an SSD scan)."""

    def counts(name):
        return {"launches": sum(launches[name].values()),
                "launches_by_path": dict(launches[name])}

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
            reps = PER_SITE[ARCH, r["site"], False] * (
                NEW_TOKENS if r["M"] == M_DECODE else 1)
            for key in keys:
                if key in r:
                    tot[key] = tot.get(key, 0.0) + reps * r[key]
            tot["bytes_ms" if r["bound_by"] == "bytes" else "ops_ms"] += (
                reps * r["bound_ms"])
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": LINE_PATHS[name],
            **counts(name),
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
                 if c.get("arch", ARCH) == ARCH
                 and c["dtype"] == LINE_CASE["dtype"]
                 and c.get("context") == LINE_CASE["context"]
                 and c.get("splits") == LINE_CASE["splits"])
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": LINE_PATHS[name],
            **counts(name),
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
        "path": LINE_PATHS["ssd_scan"], **counts("ssd_scan"),
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
        phase("[1/25] setup")
        results["setup"] = phase_setup(torch)
        phase("[2/25] MVM kernels at llama-3.2-1b, phi-3-mini-4k, "
              "mamba2-130m, qwen3-moe-30b-a3b, jamba-v0.1-52b, internvl2-2b "
              "and musicgen-medium main-path shapes")
        rows = phase_kernels(torch)
        phase("[3/25] static engine, llama-3.2-1b, analog_hw serving, "
              "use_pallas=True")
        results["small"] = small_reference_check(torch)
        results["analog"] = serve_phase(torch, "analog_hw", "analog_hw")
        phase("[4/25] static engine, llama-3.2-1b, digital_int4 serving")
        results["int4"] = serve_phase(torch, "digital_int4", "digital_rtn4")
        phase("[5/25] paged-attention kernels at llama-3.2-1b, "
              "phi-3-mini-4k, qwen3-moe-30b-a3b and jamba-v0.1-52b "
              "attention shapes")
        paged_rows = phase_paged(torch)
        phase("[6/25] ssd_scan at mamba2-130m and jamba-v0.1-52b shapes")
        ssd_rows = phase_ssd(torch)
        phase("[7/25] static engine, mamba2-130m: fp, analog_hw, "
              "digital_int4")
        results["mamba_static"] = phase_mamba_static(torch)
        phase("[8/25] continuous engine at full width: llama-3.2-1b on the "
              "paged pool, mamba2-130m")
        results["engine"] = phase_engine(torch)
        results["engine_mamba"] = phase_engine(torch, MAMBA)
        phase("[9/25] reduced continuous engines, card against cpu")
        results["reduced_engine"] = reduced_engine_check(torch)
        results["reduced_mamba"] = reduced_mamba_check(torch)
        phase("[10/25] serving CLI")
        results["cli"] = phase_cli(torch)
        phase("[11/25] static engine, phi-3-mini-4k at full width: "
              "analog_hw (use_pallas=True), digital_int4")
        results["phi3_analog"] = serve_phase(torch, "analog_hw", "analog_hw",
                                             PHI3)
        results["phi3_int4"] = serve_phase(torch, "digital_int4",
                                           "digital_rtn4", PHI3)
        phase("[12/25] noisy eval (10 seeds) at full width: llama-3.2-1b, "
              "phi-3-mini-4k; reduced eval, card against cpu")
        results["eval"] = {arch: phase_eval(torch, arch)
                           for arch in (ARCH, PHI3)}
        results["reduced_eval"] = {arch: reduced_eval_check(torch, arch)
                                   for arch in (ARCH, PHI3)}
        phase("[13/25] best-of-n at full width: llama-3.2-1b, "
              "phi-3-mini-4k")
        results["best_of_n"] = {arch: phase_best_of_n(torch, arch)
                                for arch in (ARCH, PHI3)}
        phase("[14/25] HWA distillation at full width, llama-3.2-1b; "
              "reduced training, card against cpu")
        results["train"] = phase_train(torch)
        phase("[15/25] SpinQuant-lite PTQ at full width: llama-3.2-1b, "
              "phi-3-mini-4k; reduced PTQ, card against cpu")
        results["ptq"] = {arch: phase_ptq(torch, arch)
                          for arch in (ARCH, PHI3)}
        results["reduced_ptq"] = reduced_ptq_check(torch)
        phase(f"[16/25] {MOE} at full width, {MOE_LAYERS} layers: static "
              "and continuous engines; reduced moe models, card against "
              "cpu")
        results["moe"] = phase_moe(torch)
        results["reduced_moe"] = {arch: reduced_card_check(torch, arch)
                                  for arch in MOE_REDUCED}
        phase(f"[17/25] {JAMBA} at full width, one super-block: static and "
              f"continuous engines; {INTERNVL} and {MUSICGEN} at full width "
              "on the static engine; reduced models, card against cpu")
        results["families"] = phase_families(torch)
        results["reduced_families"] = {arch: reduced_card_check(torch, arch)
                                       for arch in FAMILY_ARCHS}
        phase(f"[18/25] HWA distillation at full width, {MAMBA}, {MOE} "
              f"({MOE_TRAIN_LAYERS} layer), {INTERNVL} ({INTERNVL_LAYERS} "
              f"layers) and {MUSICGEN} ({MUSICGEN_LAYERS}); reduced ssm, moe, "
              "hybrid, vlm and audio training, card against cpu")
        results["train_families"] = phase_train_families(torch)
        phase(f"[19/25] devices: full-width {ARCH} on an ageing chip "
              "(static and continuous engines, the drift clock, the "
              "watchdog, CUDA graphs); reduced families, card against cpu")
        results["devices"] = phase_devices(
            torch, results["analog"], results["engine"]["analog_hw/kv16"])
        phase(f"[20/25] prefix cache: full-width {ARCH} at "
              f"{PREFIX_LAYERS[ARCH]} layers (bf16 and int8 "
              f"pools) and {MAMBA} (state snapshots) cold, prime and warm; "
              "reduced models, card against cpu")
        results["prefix"] = phase_prefix(torch)
        phase(f"[21/25] speculative decoding: full-width {ARCH} at "
              f"{PREFIX_LAYERS[ARCH]} layers (fp with "
              "the ngram, self and int4 drafters; analog_hw with ngram and "
              "int4) on phase 20's first 8 requests; reduced models, card "
              "against cpu")
        t21 = time.perf_counter()
        base_hw = {int(u): np.asarray(v, np.int32) for u, v in
                   results["prefix"][f"{ARCH}/kv16"]["tokens"].items()}
        results["speculative"] = phase_speculative(torch, rows, base_hw)
        results["speculative"]["phase_s"] = time.perf_counter() - t21
        phase(f"[22/25] lifecycle: full-width {ARCH} through the async "
              "front end open-loop (poisson, bursts with a bounded queue and "
              "TTFT deadlines), a cancel mid speculative window and a chaos "
              "fault (ngram and int4 drafters), the HTTP front door")
        t22 = time.perf_counter()
        results["lifecycle"] = phase_lifecycle(
            torch, results["engine"]["analog_hw/kv16"]["tokens_per_s"])
        results["lifecycle"]["phase_s"] = time.perf_counter() - t22
        phase(f"[23/25] tensor parallelism on one card: full-width {ARCH} "
              f"at {TP_LAYERS[ARCH]} layers (fp, digital_int4, analog_hw at "
              f"tp {TP_DEGREES}; tp 3 gated), {MOE} and {MAMBA} at tp 2, "
              f"{QWEN32} at {QWEN32_LAYERS} layers at tp {QWEN32_DEGREES}")
        t23 = time.perf_counter()
        results["tp"] = phase_tp(torch)
        results["tp"]["phase_s"] = time.perf_counter() - t23
        phase(f"[24/25] cost counter and dry run: {ARCH} analog_hw and "
              f"digital_int4 forwards, the engine's decode and chunk steps "
              f"and a {MAMBA} prefill counted on the card and on the meta "
              f"device; bound inputs, allocator bytes, peak bytes, rates; "
              f"the train_4k dry run")
        results["cost"] = phase_cost(
            torch, rows, ssd_rows, results["engine"]["analog_hw/kv16"])
        phase(f"[25/25] sharded training state on one card: full-width "
              f"{ARCH} at {SHARD_LAYERS} layers, {SHARD_STEPS} steps on "
              f"meshes {' '.join('x'.join(map(str, m)) for m in SHARD_MESHES)}"
              f" against the unsharded step; reshard 4 -> 2; the "
              f"launcher; psum_compressed card against cpu")
        results["sharded"] = phase_sharded(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    line = kernels_line(rows, paged_rows, ssd_rows, line_launches(results))
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
