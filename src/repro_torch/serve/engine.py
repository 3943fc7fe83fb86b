"""Best-of-n test-time compute scaling harness (paper §4.4).

``sample_candidates`` generates n candidate answers per prompt with
temperature sampling on the continuous-batching :class:`ServeEngine`
(every (prompt, candidate) pair is one request; slots recycle as
candidates finish, so candidates of mixed progress never pad each other),
and ``best_of_n_accuracy`` scores them with a PRM and applies the three
selection strategies: the Fig. 4 / Table 15 pipeline.

Best-of-n is the shared-prefix workload: the n candidates of a prompt
prefill the same tokens before they part at the first sampled one. On the
paged engine's radix prefix cache the harness is *fork-aware*: it submits
one leader per prompt, steps until the leaders' prompt blocks (and, on an
ssm or hybrid stack, their state snapshots) are in the index, then forks
the other n − 1 candidates, whose admissions map onto the leader's blocks
and re-run only the last chunk. Each candidate keeps its own sampling
state, and serving is deterministic, so the fork path gives the
independent-requests path's answers bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.serve.decode import digital_int4_config
from repro_torch.serve.prm import NoisyOraclePRM, select_answer
from repro_torch.serve.scheduler import (Request, SchedulerConfig,
                                         ServeEngine, padded_prompt_len,
                                         required_max_len)


@dataclasses.dataclass(frozen=True)
class BestOfNConfig:
    """Candidate-generation settings for the §4.4 best-of-n harness.

    Attributes:
        temperature: Sampling temperature for candidate diversity (paper
            App. F samples every MATH-500 candidate).
        top_k: Keep only the k most likely tokens per step (0 = off).
        top_p: Nucleus sampling mass (1.0 = off), as in App. F.
        max_new: Tokens generated per candidate; beyond 1, the answer is
            extracted by the ``extract`` hook of :func:`sample_candidates`.
        greedy_first: Decode this many initial tokens greedily before
            sampling (the RGS/SGS generation strategies, App. B.1).
        stop_tokens: Per-candidate stop ids: generation ends early when
            one is sampled (answer terminator for multi-token tasks).
        num_slots: In-flight candidate capacity of the serving engine.
        prefill_chunk: Admission prefill granularity of the engine.
        int4_serve: Serve RTN weights on the packed-int4 kernel (the
            Table 3 digital deployment, ``digital_int4_config``).
        paged: Serve candidates from the block-paged KV pool
            (attention-free stacks keep their per-slot state instead).
        prefix_cache: Fork-aware candidate generation on the radix prefix
            cache: one leader per prompt, the other n − 1 forked at the
            shared prefix. The answers are bitwise those of independent
            requests; off runs every candidate as one.
        kv_block_size: Physical KV block granularity of the paged pool.
        speculative: Draft-and-verify decoding of every candidate
            (``SchedulerConfig.speculative``): exact-match verification
            keeps each candidate's tokens, and so the answers, those of
            non-speculative serving, greedy and sampled alike. The dense
            and moe families speculate; ssm and hybrid stacks decode as
            before, with the reason in the engine's ``gating_reasons``.
        draft_k: Proposals a slot per verify window.
        draft: The drafter: ``"int4"`` (the digital int4 deployment of the
            same weights on the packed kernel), ``"self"`` (the target
            itself) or ``"ngram"`` (host prompt lookup, no draft
            forward).
        drift_dt: Deployment hours of conductance drift per engine step,
            passed to the engine (``SchedulerConfig.drift_dt``): the
            clock runs on params with per-tile device state and is inert,
            with its reason in the engine's ``gating_reasons``, on
            params without.
        recalibrate: Let the engine's drift watchdog reprogram the chip
            in place (``SchedulerConfig.recalibrate``).
    """

    temperature: float = 0.8
    top_k: int = 0
    top_p: float = 1.0
    max_new: int = 1
    greedy_first: int = 0
    stop_tokens: tuple = ()
    num_slots: int = 32
    prefill_chunk: int = 8
    int4_serve: bool = False
    paged: bool = True
    prefix_cache: bool = True
    kv_block_size: int = 16
    speculative: bool = False
    draft_k: int = 4
    draft: str = "int4"
    drift_dt: float = 0.0
    recalibrate: bool = False


def sample_candidates(params, cfg, acfg: AnalogConfig,
                      generator: torch.Generator, prompts: np.ndarray,
                      n: int, bcfg: BestOfNConfig = BestOfNConfig(),
                      extract: Optional[Callable[[np.ndarray], int]] = None,
                      ) -> np.ndarray:
    """Generate and extract n candidate answers per prompt.

    Runs ``num_prompts * n`` requests through the continuous-batching
    engine where ``params`` live. Each candidate's sampling seed is drawn
    from ``generator`` (the JAX package draws them from its key: the same
    role, not the same numbers). ``extract`` reduces each generated token
    sequence to a scalar answer id, a task-level hook (see
    ``eval.tasks``); the default keeps the first generated token.

    With the prefix cache on (``bcfg.paged`` and ``bcfg.prefix_cache``, any
    family) generation is fork-aware (see the module docstring); the
    answers are bitwise those of the independent path.

    → answers [num_prompts, n] int array.
    """
    if bcfg.int4_serve:
        acfg = digital_int4_config(acfg)
    if extract is None:
        extract = lambda toks: int(toks[0])   # noqa: E731
    num = len(prompts)
    seeds = torch.randint(0, np.iinfo(np.int32).max, (num * n,),
                          generator=generator,
                          device=generator.device).cpu().numpy()
    plen = int(np.shape(prompts)[1])
    max_len = required_max_len(plen, bcfg.max_new, bcfg.prefill_chunk)
    bs = bcfg.kv_block_size
    # room beyond the slots' capacity so that every prompt's blocks stay
    # cached across the run (a leader may retire before its forks are
    # admitted); only prompt blocks are retained, so size by the padded
    # prompt, as the JAX package does
    prompt_blocks = -(-padded_prompt_len(plen, bcfg.prefill_chunk) // bs)
    kv_blocks = (bcfg.num_slots * -(-max_len // bs)
                 + num * (prompt_blocks + 1)) if bcfg.paged else 0
    # the same room in the ssm / hybrid snapshot pool: every prompt's
    # boundary snapshots must outlive the leader-to-fork gap
    state_snaps = ((bcfg.num_slots + num) * prompt_blocks
                   if bcfg.paged and bcfg.prefix_cache else 0)
    scfg = SchedulerConfig(
        num_slots=bcfg.num_slots, max_len=max_len,
        prefill_chunk=bcfg.prefill_chunk, paged=bcfg.paged,
        prefix_cache=bcfg.prefix_cache, kv_block_size=bs,
        kv_blocks=kv_blocks, state_snapshots=state_snaps,
        speculative=bcfg.speculative, draft_k=bcfg.draft_k,
        draft=bcfg.draft, drift_dt=bcfg.drift_dt,
        recalibrate=bcfg.recalibrate)
    eng = ServeEngine(params, cfg, acfg, scfg)
    reqs = [Request(uid=i, prompt=np.asarray(prompts[i // n], np.int32),
                    max_new=bcfg.max_new, temperature=bcfg.temperature,
                    top_k=bcfg.top_k, top_p=bcfg.top_p,
                    greedy_first=bcfg.greedy_first,
                    stop_tokens=tuple(bcfg.stop_tokens), seed=int(seeds[i]))
            for i in range(num * n)]
    if eng.prefix_enabled and n > 1:
        # leaders first (one candidate per prompt), stepped until every
        # leader's prompt is prefilled and indexed...
        for p in range(num):
            eng.submit(reqs[p * n])
        while eng.queue or any(s is not None and s.prefilling
                               for s in eng.slots):
            eng.step()
        # ...then the siblings, whose admissions map onto the leaders'
        # prompt blocks (live or retained) and skip to the last chunk
        for p in range(num):
            for i in range(1, n):
                eng.submit(reqs[p * n + i])
        outs = eng.run()
    else:
        outs = eng.run(reqs)
    return np.array([[extract(outs[p * n + i]) for i in range(n)]
                     for p in range(num)])


def best_of_n_accuracy(answers: np.ndarray, correct: np.ndarray,
                       prm: NoisyOraclePRM, ns: list[int],
                       strategies=("prm_greedy", "prm_voting", "voting"),
                       repeats: int = 5, seed: int = 0) -> dict:
    """Accuracy vs n curves for each strategy (subsampling the n candidates).

    ``answers`` [P, N_max]; for each n, draw ``repeats`` random subsets.
    """
    rng = np.random.default_rng(seed)
    out = {s: {} for s in strategies}
    num_p, n_max = answers.shape
    for n in ns:
        accs = {s: [] for s in strategies}
        for _ in range(repeats):
            idx = rng.choice(n_max, size=n, replace=False)
            sub = answers[:, idx]
            rewards = np.stack([prm.score(sub[p], correct[p])
                                for p in range(num_p)])
            for s in strategies:
                picked = np.array([select_answer(sub[p], rewards[p], s)
                                   for p in range(num_p)])
                accs[s].append(float(np.mean(picked == correct)))
        for s in strategies:
            out[s][n] = {"mean": float(np.mean(accs[s])),
                         "std": float(np.std(accs[s]))}
    return out
