"""Request-level continuous-batching serving engine (in-flight batching).

The static ``serve.decode.generate`` loop pads every prompt to the batch
maximum and decodes until the slowest request finishes. This engine serves
mixed-length traffic instead:

* **Slot-based in-flight batching** — the engine owns ``num_slots`` cache
  slots (rows of ``models.transformer.init_caches(per_slot=True)``). A
  finished request releases its slot at once and a waiting request is
  admitted mid-decode; the decode step keeps one static shape
  ``[num_slots, 1]`` whichever slots are live (the others are masked and
  leave the cache untouched).
* **Fused chunked prefill** — an admitted prompt is left-padded to a
  multiple of ``prefill_chunk`` and its chunks ride on the decode batch:
  each engine step spends one token per decode-phase slot and fills the
  rest of its token budget (``SchedulerConfig.step_tokens``) with chunks
  of admitting slots, gathered into one ``[prefill_batch, chunk]``
  forward and scattered back. The first token of a finished prompt is
  sampled inside that step.
* **Multi-step decode** — with no admission pending, up to
  ``decode_block`` decode-and-sample steps run back to back on the device
  with one host read of the sampled tokens at the end.
* **Block-paged KV cache** (``SchedulerConfig.paged``) — a pool of
  fixed-size physical blocks (``serve.kv_pool``: allocated at admission,
  released at retirement, FIFO backpressure when undersized). Decode runs
  the hand-written ``paged_flash_decode`` kernel and a prefill chunk
  ``paged_flash_prefill``, both scoring the pool in place and reading only
  each row's live blocks. ``AnalogConfig.kv_bits = 8`` stores the pool as
  int8 with per token/head scales.
* **Radix prefix caching** (``SchedulerConfig.prefix_cache``, on by
  default, every family; it needs ``paged=True``) -- admission matches the
  padded prompt against the pool's content-addressed block index
  (``KVPool.match_prefix``) and maps the slot's block-table row onto the
  shared physical blocks. The slot's ``pos`` cursor starts past the hit,
  rounded down to a chunk boundary, and the last chunk always runs, so the
  first-token logits exist. A chunk that overlaps the hit re-scores the
  shared blocks but never rewrites them: the slot's write table sends
  those writes to the sink block. A matched partial tail is copied on
  write into a fresh private block (one in-place copy per pool leaf). A
  prompt's full blocks and its partial tail are indexed when its prefill
  completes, and retirement keeps zero-ref indexed blocks in an LRU,
  evicted only under allocation pressure. Serving is deterministic and
  every layer row-independent, and a skip keeps the chunk grid, so warm
  greedy decode equals cold bit for bit.
* **State snapshots** (ssm and hybrid) -- an SSM state summarizes its
  whole prefix, so a skip needs the state at the skip point: prefill
  copies the slot's ``conv`` / ``ssm`` rows into a content-addressed
  snapshot pool (``kv_pool.StateSnapshotPool``, the ``*_snap`` cache
  leaves) at every chunk boundary that is also a block boundary, indexed
  under the KV blocks' chain keys and registered at the prefill-to-decode
  flip. A warm admission copies the deepest matching snapshot into the
  slot's state rows and starts its cursor there. A hybrid stack skips to
  the snapshot only as far as the KV hit reaches (it takes no partial
  tail); a pure ssm stack runs the snapshot pool without a KV pool.
* **ssm stacks** (mamba2-130m) keep a per-slot recurrent state (``conv``
  tail, ``ssm`` state) instead of a KV cache: every chunk forward runs the
  hand-written ``ssd_scan`` kernel from the slot's state, every decode
  step the one-token recurrence. ``paged=True`` allocates no KV pool there
  and records why in ``gating_reasons``, as the reference does; it still
  turns on the prefix cache's snapshot pool.
* **moe stacks** (qwen3-moe-30b-a3b, dbrx-132b) share the dense KV
  layouts; their routing is per row (one sequence is one routed group),
  and every column of a chunk, left pads too, competes for its row's
  expert capacity, as in the reference.
* **hybrid stacks** (jamba-v0.1-52b) nest both: the attention leaves of
  every super-block (contiguous per slot, or paged on the pool) and the
  per-slot state of its mixers. The engine walks the nested cache tree
  with ``models.transformer.cache_slot_spec``. The vlm and audio families
  are served by the static engine only, as in the reference: this engine
  refuses them.
* **Speculative decoding** (``SchedulerConfig.speculative``, the dense and
  moe families) -- a pure-decode step becomes a draft-and-verify window: a
  drafter (``SchedulerConfig.draft``: the digital int4 deployment of the
  same weights on the packed-int4 kernel, the target itself, or host-side
  prompt lookup) proposes ``draft_k`` tokens a slot, and one ``[num_slots,
  k+1]`` forward scores all ``k+1`` positions at each row's own cursor (on
  the paged pool through ``paged_flash_prefill``). Verification is exact
  match (``sampling.speculative_verify``): each column draws the token the
  non-speculative loop would draw at that count, so the emitted tokens are
  the non-speculative ones for greedy and sampled rows alike. Rejected
  positions roll back as a ``pos`` rewind, in place, checked against the
  pool's rewind floor (``KVPool.check_rewind``: never into shared or
  frozen blocks). A model drafter keeps a contiguous per-slot cache of its
  own, prefilled with the whole padded prompt at the prefill-to-decode
  flip and advanced by the decode token of every mixed step, and rewound
  by the same ``delta`` as the target. ssm and hybrid stacks decode as
  before and ``gating_reasons["speculative"]`` says why: a cursor rewind
  cannot roll back a recurrent state. The drift clock ticks once per
  engine step, so with ``drift_dt > 0`` a speculative run ages the chip on
  another step grid than a non-speculative one.
* **Per-request sampling and stop conditions** — temperature, top-k,
  top-p and ``greedy_first`` ride along as per-row tensors
  (``sampling.sample_logits_batched``). Randomness is counter-based: the
  noise of a request's ``n``-th token comes from a generator seeded by
  ``(seed, n)`` alone (``sampling.request_uniforms``), and every layer is
  row-independent, so a request draws the same tokens solo or mid-batch
  (the admission-parity contract). The draws are not the JAX package's:
  only greedy output is compared with it.
* **Drift clock and watchdog** (``SchedulerConfig.drift_dt``,
  ``recalibrate``) — on params with per-tile device state
  (``core.devices.attach_device_state``) every worked engine step (a
  decode block is one) advances the chip's deployment clock by
  ``drift_dt`` hours, in place, so the step's leaves, and any CUDA graph
  over them, age with it; an idle iteration does not tick. Every
  ``recal_interval`` worked steps the watchdog reads per-tile health on
  the host, and with ``recalibrate=True`` it reprograms the chip in place
  (``core.devices.recalibrate``: fresh gain and offset instances, the
  clock's calibration point moved to now) when the mean ``|tile scale -
  1|`` over live tiles exceeds ``recal_threshold``. Recalibration evicts
  nothing: no KV block, slot or request. Its generator is seeded from
  ``0x5ECA1`` and the recalibration count, so a run gives the same bits
  twice.

* **Request lifecycle** -- every request moves through ``queued ->
  prefill -> decode`` to exactly one terminal status: ``finished``,
  ``cancelled``, ``timed_out``, ``shed`` or ``errored``, each but the
  first with its reason in ``errors``. ``try_submit`` sheds at a full
  bounded queue (``SchedulerConfig.max_queue``) or where ``submit`` would
  refuse the request; ``cancel`` works at every stage and keeps the
  partial output; ``Request.ttft_deadline`` / ``deadline`` retire overdue
  requests at step boundaries. The step is split in two: ``step_begin``
  enforces deadlines, admits and dispatches the step's device work with no
  host read, ``step_commit`` reads it back and does the host bookkeeping.
  A cancel that lands between the two is deferred to the commit (the
  cancel-vs-rewind ordering contract of ``serve.kv_pool``). A
  fault-tolerant engine (``SchedulerConfig.fault_tolerant`` or a
  ``chaos_hook``) turns an exception raised in a step into ``errored``
  results for the in-flight requests, resets the caches in place and the
  host pools anew, and keeps serving the queue; an allocator fault at
  admission sheds the queue head only, and a bad health read skips that
  watchdog check. A CUDA error that makes the reset itself fail
  propagates: a device-side fault poisons the CUDA context for good.
  ``events`` logs ``("token", uid, tok)`` and ``("done", uid, status)``
  for the async front end (``serve.frontend``).

* **Steps as CUDA graphs** (``serve.graphs``, the counterpart of the
  reference's jitted steps) -- each step kind is a body over static
  buffers: a decode block of ``k`` steps, the fused mixed step (with the
  model drafter's catch-up), a verify window, the model drafter's ``k +
  1`` steps with their window. Before the step the host writes what
  varies into those buffers in place (the per-slot state, the greedy mask,
  the noise of every sampled draw from ``request_uniforms``, the chunk's
  tokens, masks, offsets and rows, the drafts, the window's counters); a
  body makes no host read and no upload and writes its outputs into
  static buffers. On the card the engine captures each body's key at its
  first use and replays it inside ``step_begin``; on the CPU it runs the
  same bodies eagerly.

Cursors (``pos``, ``start``) live on the device; the engine keeps host
mirrors and reads the device once per engine step, for the sampled tokens.
Every device write of the prefix cache (the copy-on-write block copy, the
snapshot capture and restore, the table rows) and the fault reset goes
into the existing leaves in place, so CUDA graphs captured over them stay
valid. Every device write the engine makes, from whichever thread calls
it, is issued on the one stream the engine was built on.

**Tensor parallelism** (``SchedulerConfig.tp > 1``) serves the model in
``tp`` shards (``distributed.sharding``, the reference's serve rules): every
column-parallel weight and the KV pool (on its KV heads, every shard holding
``KV / tp`` heads of every physical block) are split, each sharded site
runs one launch per shard on its own columns, experts or heads, and the
shards are gathered, never summed, so tp-way greedy decode equals tp = 1
bit for bit. The host side is single: one engine makes every admission,
prefix-index, window, deadline, cancel and recovery decision once, and the
block tables, refcounts, radix index and snapshot pools stay
shard-agnostic; every copy-on-write block copy and every reset writes every
shard in place. Shard ``i`` sits on card ``i`` by default;
``ServeEngine(shard_devices=...)`` places them explicitly, several on one
device (the CPU tests; ``chip_smoke.py`` on one card). The drafter's
weights and caches shard too. With the shards on the engine's card the
step graphs capture every shard's launches; with shards on several cards
the bodies run eagerly. A tp the config or runtime cannot take (heads or
KV heads that do not divide, too few devices) is recorded in
``gating_reasons["tensor_parallel"]`` and the engine serves at tp = 1.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import devices
from repro_torch.core.analog import (AnalogConfig, AnalogCtx,
                                     pack_int4_weights)
from repro_torch.distributed import sharding
from repro_torch.models import transformer as T
from repro_torch.models.model import apply as model_apply
from repro_torch.serve import graphs
from repro_torch.serve.decode import digital_int4_config, serve_step
from repro_torch.serve.kv_pool import SINK_BLOCK, KVPool, StateSnapshotPool
from repro_torch.serve.sampling import (request_uniforms,
                                        sample_logits_batched,
                                        speculative_verify)


def padded_prompt_len(plen: int, chunk: int) -> int:
    """Prompt length after left-padding to a multiple of ``chunk``: the one
    source of admission geometry (capacity checks, admission, the
    ``max_len`` a caller sizes)."""
    return max(chunk, -(-plen // chunk) * chunk)


def required_max_len(plen: int, max_new: int, chunk: int) -> int:
    """Least ``SchedulerConfig.max_len`` for a (prompt, budget) pair."""
    return padded_prompt_len(plen, chunk) + max_new


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    ``stop_tokens``: sampling any of these ends the request (the stop token
    is kept). ``greedy_first``: how many first tokens are argmax picks
    before temperature sampling. ``seed`` seeds the request's own noise,
    so its tokens do not depend on its batch-mates. ``ttft_deadline`` /
    ``deadline`` (seconds from submission, 0 = none): a request with no
    token yet past either one, or one past ``deadline`` mid-decode, is
    retired ``timed_out`` at the next step boundary with its partial
    output.
    """

    uid: int
    prompt: np.ndarray                 # [len] int32 token ids
    max_new: int = 16
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    greedy_first: int = 0
    stop_tokens: tuple = ()
    seed: int = 0
    ttft_deadline: float = 0.0
    deadline: float = 0.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static engine geometry.

    ``num_slots``: in-flight request capacity (decode batch rows).
    ``max_len``: per-slot cache length; a request needs ``padded prompt +
    max_new <= max_len``. ``prefill_chunk``: admission prefill granularity.
    ``decode_block``: with no admission in flight, up to this many decode
    steps per engine step (clipped to the smallest remaining budget and
    to powers of two).

    ``step_tokens``: the token budget of the fused mixed step (0 = auto:
    ``num_slots + 2 * prefill_chunk``). While a slot is mid-prefill each
    step spends one token per decode-phase slot and runs
    ``clip((step_tokens - n_decode) // prefill_chunk, 1, min(n_admitting,
    prefill_batch))`` chunks of admitting slots, oldest first: at least
    one chunk per step, so prefill never starves, and one token per
    decode slot, so decode never does. ``prefill_batch`` =
    ``max(1, (budget - num_slots) // prefill_chunk)`` capped at
    ``num_slots`` is the compact width of the chunk forward.

    ``paged=True`` replaces the per-slot ``max_len`` KV buffers with the
    block pool: ``kv_blocks`` blocks of ``kv_block_size`` tokens (0 = every
    slot at ``max_len``). The pool dtype is ``cache_dtype`` unless
    ``AnalogConfig.kv_bits == 8``.

    ``prefix_cache`` (default on; it needs ``paged=True``, every family)
    runs the radix prefix cache: admission reuses content-matching blocks,
    retirement keeps released prompt blocks in an LRU. The dense and moe
    families share KV blocks; ssm and hybrid stacks also (ssm: only) run
    the content-addressed state-snapshot pool, of ``state_snapshots``
    slots (0 = ``num_slots * ceil(max_len / kv_block_size)``). Greedy
    decode is bitwise the same with it and without it. ``cache_salt``
    roots every chain key, keeping apart entries whose KV would differ for
    reasons outside the token ids (deployment, tenancy).

    ``speculative=True`` turns pure-decode steps into draft-and-verify
    windows on the dense and moe families (see the module docstring); the
    output is the non-speculative output. ``draft`` picks the drafter:
    ``"int4"`` (the digital int4 deployment of the same weights,
    ``decode.digital_int4_config`` with ``weight_bits=4``, its packed
    carriers built once), ``"self"`` (the target's own deployment:
    acceptance 1 but for near-ties) or ``"ngram"`` (host prompt lookup,
    no draft forward). ``draft_k`` is the window's proposals a slot, clipped
    so that no row writes past its budget; ``draft_layers > 0`` keeps the
    model drafter's first n blocks. On the ssm and hybrid families it is
    inert and ``gating_reasons["speculative"]`` says why; mixed steps stay
    non-speculative.

    ``drift_dt > 0`` runs the deployment clock (hours per worked step)
    on params with per-tile device state, and ``recalibrate=True`` the
    watchdog: every ``recal_interval`` worked steps a health read, and a
    reprogramming when the mean tile scale error exceeds
    ``recal_threshold`` (see the module docstring). Without device state
    the clock is inert and ``gating_reasons["drift"]`` says why; without a
    running clock so is the watchdog (``gating_reasons["recalibrate"]``).

    ``max_queue > 0`` bounds the admission queue: ``try_submit`` sheds a
    request that arrives at a full queue. ``fault_tolerant=True`` (implied
    by a ``chaos_hook``) survives a fault raised in a step (see the module
    docstring). ``tp > 1`` serves tensor-parallel over ``tp`` shards (see
    the module docstring), or at tp = 1 with
    ``gating_reasons["tensor_parallel"]`` where it cannot.
    """

    num_slots: int = 4
    max_len: int = 96
    prefill_chunk: int = 16
    decode_block: int = 8
    step_tokens: int = 0
    cache_dtype: torch.dtype = torch.float32
    paged: bool = False
    kv_block_size: int = 16
    kv_blocks: int = 0
    prefix_cache: bool = True
    cache_salt: int = 0
    state_snapshots: int = 0
    speculative: bool = False
    draft_k: int = 4
    draft: str = "int4"
    draft_layers: int = 0
    drift_dt: float = 0.0
    recalibrate: bool = False
    recal_interval: int = 25
    recal_threshold: float = 0.1
    max_queue: int = 0
    fault_tolerant: bool = False
    tp: int = 1


#: the terminal statuses of the request lifecycle
TERMINAL = ("finished", "cancelled", "timed_out", "shed", "errored")

#: ``ServeEngine._inflight`` while ``step_begin`` dispatches
_DISPATCHING: dict = {"op": None}


#: why ``SchedulerConfig.paged`` is inert on an ssm stack (the reference's
#: reason: the prefix cache runs on the snapshot pool alone there)
_SSM_NOT_PAGED = ("attention-free ssm stacks have no KV to page (per-slot "
                  "state is O(1)); prefix caching still runs via the "
                  "state-snapshot pool")

#: why ``SchedulerConfig.prefix_cache`` is inert without the paged pool
_PREFIX_NOT_PAGED = ("prefix caching needs the paged engine "
                     "(SchedulerConfig.paged=True): content-addressed reuse "
                     "is keyed on KV-block-aligned prefixes")


#: why ``SchedulerConfig.speculative`` is inert on the ssm and hybrid
#: families (the reference's reason)
_SPEC_RECURRENT = ("speculative rollback is a pos-cursor rewind, which only "
                   "rolls back attention KV; ssm/hybrid recurrent state is "
                   "cumulative and has no per-position cursor: these "
                   "families decode non-speculatively")


def _ngram_propose(ctx: np.ndarray, k: int, max_n: int = 3) -> np.ndarray:
    """Prompt-lookup drafting: the continuation of the most recent earlier
    occurrence of the context's longest matching suffix n-gram (n =
    ``max_n`` down to 1), else the last token repeated. Host numpy over the
    request's context; exact-match verification makes any proposal safe."""
    ctx = np.asarray(ctx, np.int32)
    n_ctx = len(ctx)
    if n_ctx == 0:
        return np.zeros(k, np.int32)
    out = np.full(k, int(ctx[-1]), np.int32)
    for n in range(min(max_n, n_ctx - 1), 0, -1):
        pat = ctx[n_ctx - n:]
        for j in range(n_ctx - n - 1, -1, -1):
            if np.array_equal(ctx[j:j + n], pat):
                cont = ctx[j + n:j + n + k]
                out[:len(cont)] = cont
                return out
    return out


def _slice_layers(tree, n: int):
    """The first ``n`` layers of a stacked block tree (views)."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _map_leaves(fn, tree: dict, *others: dict) -> dict:
    """``fn(leaf, *other leaves)`` over a nested cache tree and the trees
    that mirror it (``cache_slot_spec``'s axes and kinds)."""
    return {k: (_map_leaves(fn, v, *(o[k] for o in others))
                if isinstance(v, dict) else fn(v, *(o[k] for o in others)))
            for k, v in tree.items()}


def _keep_leaves(tree: dict, new: dict) -> None:
    """Write every leaf of ``new`` that is not the same tensor as its
    counterpart in ``tree`` into that counterpart, in place (a forward
    returns the slot layouts' ``pos`` cursors anew; every other leaf it
    writes in place), so that the engine's cache leaves never change."""
    for k, v in new.items():
        if isinstance(v, dict):
            _keep_leaves(tree[k], v)
        elif v is not tree[k]:
            tree[k].copy_(v)


def _walk(tree: dict, *others: dict):
    """The leaves of a nested cache tree, each with the leaves of the
    mirroring trees at its path, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, *(o[k] for o in others))
        else:
            yield (v,) + tuple(o[k] for o in others)


class _Slot:
    """Host-side bookkeeping of one in-flight request."""

    def __init__(self, req: Request, toks: np.ndarray, mask: np.ndarray,
                 npad: int, chunk: int, seq: int, skip: int = 0):
        """The left-padded prompt ``toks`` / ``mask`` split into
        ``chunk``-sized pieces, the first ``skip // chunk`` of which a
        prefix-cache hit already covers; ``seq`` is the admission order."""
        self.req = req
        self.out: list[int] = []
        self.count = 0                 # tokens sampled so far
        self.toks = toks
        self.mask = mask               # 1 = real token
        self.npad = npad               # left-pad count
        self.nchunks = len(toks) // chunk
        self.chunk = skip // chunk     # next prefill chunk to run
        self.seq = seq
        # the prefix cache: the slot's physical block row, its chain keys
        # and how many leading blocks came from the index (shared, never
        # registered again); the (key, snapshot slot) pairs captured in
        # this prefill and the depth (in blocks) of the restored snapshot
        self.blocks: list[int] = []
        self.keys: list = []
        self.hit_full = 0
        self.snaps: list[tuple] = []
        self.hit_snap = 0

    @property
    def prefilling(self) -> bool:
        """True while prompt chunks remain to be streamed in."""
        return self.chunk < self.nchunks


class ServeEngine:
    """Continuous-batching engine over a slot cache.

    Usage::

        eng = ServeEngine(params, cfg, acfg, SchedulerConfig(num_slots=8))
        results = eng.run([Request(uid=0, prompt=np.array([1, 2, 3]))])
        results[0]                     # np.ndarray of generated ids

    ``submit`` / ``step`` expose the loop (e.g. to admit requests
    mid-decode); ``try_submit``, ``cancel``, ``step_begin`` /
    ``step_commit``, ``queue_depth`` and ``drain_events`` the request
    lifecycle (see the module docstring), whose telemetry is
    ``submitted``, ``shed_count``, ``timeout_count``, ``cancel_count``,
    ``fault_count``, ``health_faults``, ``step_faults`` and
    ``queue_high_water`` (the reference's names). The engine runs where
    ``params`` live: on the card the
    paged layout runs the paged-attention kernels and an ssm stack the
    ``ssd_scan`` kernel, on the CPU their plain versions. A requested
    option that cannot run on the model's family is recorded in
    ``gating_reasons`` (the reference's field). The drift clock and its
    watchdog report ``drift_hours``, ``recal_count``, ``recal_time``,
    ``watchdog_checks``, ``tile_scale_err``, ``dead_tiles`` and
    ``stuck_cols``, the prefix cache ``prefix_lookups``, ``prefix_hits``,
    ``prefix_hit_tokens``, ``prefix_skipped_tokens``,
    ``prefix_cow_copies``, ``state_snaps_captured`` and
    ``state_snap_restores``, speculative decoding ``spec_steps``,
    ``spec_proposed`` and ``spec_accepted`` (the reference's names) and
    ``draft_forwards`` (the model drafter's forwards: window steps,
    catch-ups and prompt prefills). ``mesh`` is the tensor-parallel
    ``distributed.sharding.ServeMesh``, None at tp = 1.
    """

    def __init__(self, params, cfg, acfg: AnalogConfig,
                 scfg: SchedulerConfig = SchedulerConfig(), *,
                 draft_params=None, draft_cfg=None, draft_acfg=None,
                 draft_fn=None, chaos_hook=None, shard_devices=None):
        """Allocate the slot caches (and the block pool when paged) and the
        host-side request state.

        The ``draft_*`` keywords replace ``scfg.draft``'s model drafter by
        an explicit (params, cfg, acfg) triple, each defaulting to the
        target's (a separately trained small drafter, say), and
        ``draft_fn(context, k) -> [<= k] ids`` replaces model drafting by
        a host callable over the request's prompt and generated tokens.
        ``chaos_hook(point)`` is called at the fault-injection points
        ``"alloc"`` (admission), ``"dispatch"`` (each step's dispatch) and
        ``"health"`` (the watchdog's read); an exception it raises is a
        fault, and installing one makes the engine fault-tolerant.
        ``shard_devices`` (``scfg.tp`` devices, which may repeat) places
        the shards of a tensor-parallel engine; by default shard ``i`` sits
        on card ``i``, and an engine on the CPU, one device, gates tp > 1
        unless it is given them. A sharded engine serves on shard 0's
        device: ``params`` may lie in host memory, each shard is then
        copied straight to its device and the replicated leaves to shard
        0's, and the engine keeps no unsharded copy of a sharded weight
        (the caller drops its own, as ``launch/serve.py`` does)."""
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"continuous batching is not wired for family="
                f"{cfg.family!r} (multi-codebook tokens / patch-embed "
                "prefill), as in the reference: serve it with the static "
                "engine (serve.decode.generate)")
        self.cfg, self.acfg, self.scfg = cfg, acfg, scfg
        self.device = params["embed"]["tokens"].device
        # a requested feature that cannot run on this family is recorded
        # with its reason (the launcher prints these), never dropped quietly
        self.gating_reasons: dict[str, str] = {}
        # tensor parallelism: the mesh, or None at tp = 1 (also where tp
        # is gated); the weights shard before the drafter is built from them
        self.mesh: Optional[sharding.ServeMesh] = None
        if scfg.tp > 1:
            if shard_devices is not None and len(shard_devices) != scfg.tp:
                raise ValueError(f"shard_devices has {len(shard_devices)} "
                                 f"devices for tp={scfg.tp}")
            avail = (shard_devices if shard_devices is not None
                     else sharding.available_devices(self.device))
            reason = sharding.serve_tp_unsupported(cfg, scfg.tp, avail)
            if reason is not None:
                self.gating_reasons["tensor_parallel"] = reason
            else:
                self.mesh = sharding.serve_mesh(scfg.tp, avail[:scfg.tp])
                # the engine serves from shard 0's device, wherever the
                # params were built (host memory, for a model larger than
                # one card)
                self.device = self.mesh.devices[0]
        self.params = (params if self.mesh is None
                       else sharding.shard_params_for_serve(self.mesh,
                                                            params))
        # every device write goes onto the stream the engine was built on,
        # whichever thread makes it (the current stream is thread-local)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        b = scfg.num_slots
        # attention-free ssm stacks have no KV to page: no pool, and the
        # per-slot state layout either way
        paged = scfg.paged and cfg.family != "ssm"
        if scfg.paged and not paged:
            self.gating_reasons["paged"] = _SSM_NOT_PAGED
        # the prefix cache, every family: dense, moe and hybrid share KV
        # blocks; ssm and hybrid also snapshot their state at block
        # boundaries, so a hit is a (KV blocks, state snapshot) pair
        self._prefix = scfg.prefix_cache and scfg.paged
        if scfg.prefix_cache and not self._prefix:
            self.gating_reasons["prefix_cache"] = _PREFIX_NOT_PAGED
        # the drift clock ages per-tile device state: over pristine
        # weights it would advance nothing, and the watchdog needs it
        self._drift = scfg.drift_dt > 0 and devices.has_device_state(params)
        if scfg.drift_dt > 0 and not self._drift:
            self.gating_reasons["drift"] = (
                "drift_dt > 0 but params carry no per-tile device state "
                "(core.devices.attach_device_state): the deployment clock "
                "would advance nothing")
        self._recal = bool(scfg.recalibrate) and self._drift
        if scfg.recalibrate and not self._recal:
            self.gating_reasons["recalibrate"] = (
                "recalibration needs an active drift clock (drift_dt > 0 "
                "and per-tile device state attached to the params)")
        if self._recal and scfg.recal_interval < 1:
            raise ValueError("recal_interval must be >= 1")
        self._init_drafter(scfg, params, draft_params, draft_cfg,
                           draft_acfg, draft_fn)
        self.pool: Optional[KVPool] = None
        kv_bits = acfg.kv_bits if paged else 0
        if paged:
            n_pool = scfg.kv_blocks or b * self.caches_tbl_width
            self.pool = KVPool(n_pool, scfg.kv_block_size,
                               salt=scfg.cache_salt)
        self.state_pool: Optional[StateSnapshotPool] = None
        state_snaps = 0
        if self._prefix and cfg.family in ("ssm", "hybrid"):
            state_snaps = (scfg.state_snapshots
                           or b * self.caches_tbl_width)
            self.state_pool = StateSnapshotPool(
                state_snaps, scfg.kv_block_size, salt=scfg.cache_salt)
        self._paged = paged
        self.caches = T.init_caches(cfg, b, scfg.max_len, scfg.cache_dtype,
                                    self.device, per_slot=True, paged=paged,
                                    kv_block_size=scfg.kv_block_size,
                                    kv_blocks=scfg.kv_blocks or None,
                                    kv_bits=kv_bits, state_snaps=state_snaps)
        if self.mesh is not None:
            self.caches = sharding.shard_caches_for_serve(self.mesh,
                                                          self.caches)
        self._axes, self._kinds = T.cache_slot_spec(
            cfg, paged=paged, kv_bits=kv_bits, state_snaps=state_snaps > 0)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Optional[_Slot]] = [None] * b
        self.results: dict[int, np.ndarray] = {}
        self.finished_at: dict[int, float] = {}
        # the request lifecycle: each uid's status (queued -> prefill ->
        # decode -> one of TERMINAL), the reason of every terminal status
        # but finished, submission and first-token times (deadlines, TTFT)
        self.status: dict[int, str] = {}
        self.errors: dict[int, str] = {}
        self.submit_time: dict[int, float] = {}
        self.first_token_at: dict[int, float] = {}
        #: ("token", uid, tok) per sampled token and ("done", uid, status)
        #: per terminal transition, drained by the async front end
        self.events: collections.deque[tuple] = collections.deque()
        # lifecycle telemetry (the launcher's report)
        self.submitted = 0
        self.shed_count = 0
        self.timeout_count = 0
        self.cancel_count = 0
        self.fault_count = 0
        self.health_faults = 0
        self.step_faults: list[str] = []
        self.queue_high_water = 0
        self.chaos_hook = chaos_hook
        self._tolerant = bool(scfg.fault_tolerant) or chaos_hook is not None
        # the step between step_begin and step_commit; a cancel of a
        # slotted request in that span waits for the commit
        self._inflight: Optional[dict] = None
        self._deferred_cancels: list[tuple[int, str, Optional[str]]] = []
        # telemetry the CLI's report reads: decode forwards (pure decode
        # steps plus the decode substep of mixed steps), steps that fused
        # both phases, chunk forwards, decode tokens emitted while a
        # prompt was streaming in, wall time per step kind
        self.decode_steps = 0
        self.mixed_steps = 0
        self.prefill_forwards = 0
        self.prefill_chunks = 0
        self.decode_tokens_during_admission = 0
        self.phase_time = {"decode": 0.0, "mixed": 0.0, "prefill": 0.0}
        #: (decode tokens, prefill tokens) per step, bounded
        self.step_token_log: collections.deque[tuple[int, int]] = (
            collections.deque(maxlen=4096))
        # the prefix cache: admissions looked up and hit, the padded prompt
        # positions the cache covered and those the prefill never ran,
        # copy-on-write tail copies, state snapshots captured and restored
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_skipped_tokens = 0
        self.prefix_cow_copies = 0
        self.state_snaps_captured = 0
        self.state_snap_restores = 0
        # speculative decoding: windows dispatched (k >= 1), drafts
        # proposed and accepted, the model drafter's forwards
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.draft_forwards = 0
        # the drift clock and watchdog: deployment hours, health reads,
        # in-place reprogrammings and their host time; tile_scale_err is
        # the latest read (mean |scale - 1| over live tiles), dead_tiles
        # and stuck_cols the permanent faults
        self.drift_hours = 0.0
        self.recal_count = 0
        self.recal_time = 0.0
        self.watchdog_checks = 0
        self.tile_scale_err = 0.0
        self.dead_tiles = 0
        self.stuck_cols = 0
        self._steps_since_check = 0
        if self._drift:
            self._read_health()
        self._admit_seq = 0
        # host mirrors of the per-slot state
        self._pos = np.zeros(b, np.int64)       # cache write cursor
        self._start = np.zeros(b, np.int64)     # left-pad count
        self._last_tok = np.zeros(b, np.int64)
        self._temp = np.ones(b, np.float32)
        self._topk = np.zeros(b, np.int64)
        self._topp = np.ones(b, np.float32)
        self._init_step_buffers()
        self._dirty = True
        #: the step graphs (None on the CPU, where the bodies run eagerly
        #: over the same buffers, and with shards on other cards than the
        #: engine's: a capture does not span devices); ``_eager`` runs them
        #: eagerly on the card too, for comparisons only
        one_card = self.mesh is None or set(self.mesh.devices) == {
            self.device}
        self.step_graphs = (graphs.StepGraphs(self.device)
                            if self.device.type == "cuda" and one_card
                            else None)
        self._eager = False

    def _init_drafter(self, scfg: SchedulerConfig, whole_params,
                      draft_params, draft_cfg, draft_acfg, draft_fn) -> None:
        """Gate speculative decoding by family and build the drafter: a
        host drafter (``"ngram"`` or ``draft_fn``) has no cache; a model
        drafter gets its params (the first ``draft_layers`` blocks, the
        packed-int4 carriers built once for ``"int4"``), its deployment and
        a contiguous per-slot cache of its own (never paged). Under tensor
        parallelism its weights and cache shard as the target's: the
        target's shards are shared, and carriers packed from the unsharded
        ``whole_params`` (or a caller's ``draft_params``) are sharded."""
        cfg, acfg = self.cfg, self.acfg
        params = whole_params if self.mesh is None else self.params
        self._spec = bool(scfg.speculative) and cfg.family in ("dense",
                                                               "moe")
        if scfg.speculative and not self._spec:
            self.gating_reasons["speculative"] = _SPEC_RECURRENT
        if self._spec and scfg.draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        self.draft_fn = draft_fn
        self._draft_host = self._spec and (draft_fn is not None
                                           or scfg.draft == "ngram")
        self.draft_params = self.draft_cfg = self.draft_acfg = None
        self.draft_caches = None
        if not self._spec or self._draft_host:
            return
        if scfg.draft not in ("int4", "self"):
            raise ValueError(f"unknown drafter {scfg.draft!r} (expected "
                             "'int4', 'self' or 'ngram')")
        dcfg = draft_cfg if draft_cfg is not None else cfg
        if draft_cfg is None and scfg.draft_layers:
            dcfg = dataclasses.replace(
                cfg, num_layers=min(scfg.draft_layers, cfg.num_layers))
        dacfg, pack = draft_acfg, False
        if dacfg is None:
            if scfg.draft == "self" or acfg.int4_serve:
                dacfg = acfg        # an int4-served target drafts itself
            else:
                # the digital int4 deployment of the same weights on the
                # packed kernel (its carriers built once, below)
                dacfg = digital_int4_config(
                    dataclasses.replace(acfg, weight_bits=4))
                pack = True
        dacfg = dataclasses.replace(dacfg, kv_bits=0)
        dparams, shard = draft_params, draft_params is not None
        if dparams is None:
            # packing reads the unsharded weights; the carriers then shard
            dparams = whole_params if pack else params
            shard = pack
            if dcfg.num_layers < cfg.num_layers:
                # layer-skip drafting: the first n stacked blocks
                dparams = dict(dparams)
                dparams["blocks"] = _slice_layers(dparams["blocks"],
                                                  dcfg.num_layers)
        if pack:
            dparams = pack_int4_weights(dparams)
        if shard and self.mesh is not None:
            dparams = sharding.shard_params_for_serve(self.mesh, dparams)
        self.draft_params, self.draft_cfg, self.draft_acfg = (dparams, dcfg,
                                                              dacfg)
        dev = dparams["embed"]["tokens"].device
        self.draft_caches = T.init_caches(dcfg, scfg.num_slots, scfg.max_len,
                                          scfg.cache_dtype, dev,
                                          per_slot=True)
        if self.mesh is not None:
            self.draft_caches = sharding.shard_caches_for_serve(
                self.mesh, self.draft_caches)
        self._daxes, self._dkinds = T.cache_slot_spec(dcfg)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request (admitted at the next free slot). Raises
        ``ValueError`` for a request this engine can never serve."""
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        need = required_max_len(len(req.prompt), req.max_new,
                                self.scfg.prefill_chunk)
        if need > self.scfg.max_len:
            raise ValueError(
                f"request {req.uid}: padded prompt + max_new needs "
                f"max_len >= {need}, engine has {self.scfg.max_len}")
        if self.pool is not None:
            nblk = self._blocks_needed(req)
            if nblk > self.pool.num_blocks:
                # backpressure can only wait for blocks that exist
                raise ValueError(
                    f"request {req.uid}: needs {nblk} KV blocks, pool has "
                    f"{self.pool.num_blocks} total")
        self.submitted += 1
        self.status[req.uid] = "queued"
        self.submit_time[req.uid] = time.perf_counter()
        self.queue.append(req)
        self.queue_high_water = max(self.queue_high_water, len(self.queue))

    def try_submit(self, req: Request) -> Optional[str]:
        """Submit under admission control: ``None`` when accepted, else the
        reason the request was shed (status ``"shed"``, the reason in
        ``errors[uid]``): the bounded queue (``max_queue``) is full, or
        :meth:`submit` would refuse the request."""
        mq = self.scfg.max_queue
        if mq and len(self.queue) >= mq:
            reason = (f"admission queue full ({len(self.queue)}/{mq}) — "
                      f"engine saturated, retry later")
        else:
            try:
                self.submit(req)
                return None
            except ValueError as e:
                reason = str(e)
        self.submitted += 1
        self.shed_count += 1
        self._finish_unadmitted(req.uid, "shed", reason)
        return reason

    def cancel(self, uid: int, *, status: str = "cancelled",
               reason: Optional[str] = None) -> bool:
        """Cancel request ``uid`` at whatever stage it is in: a queued one
        leaves the queue, a slotted one is retired with its partial output
        (every pool reference released, its block tables on the sink).
        True when the request was live, False when it was already terminal
        or unknown (a finish that won is not an error). Between
        :meth:`step_begin` and :meth:`step_commit` a slotted request's
        cancel is deferred to the commit: the step in flight may still
        rewind into its blocks (the cancel-vs-rewind ordering contract)."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                if status == "cancelled":
                    self.cancel_count += 1
                self._finish_unadmitted(uid, status, reason)
                return True
        for b, s in enumerate(self.slots):
            if s is not None and s.req.uid == uid:
                if self._inflight is not None:
                    self._deferred_cancels.append((uid, status, reason))
                else:
                    if status == "cancelled":
                        self.cancel_count += 1
                    with self._on_stream():
                        self._retire_slot(b, status, reason)
                return True
        return False

    def step(self) -> None:
        """One engine iteration: :meth:`step_begin` and, unless the engine
        was idle, :meth:`step_commit` right after it."""
        pending = self.step_begin()
        if pending is not None:
            self.step_commit(pending)

    def step_begin(self) -> Optional[dict]:
        """First half of an iteration: retire overdue requests, admit
        queue heads into free slots (strict FIFO; a paged engine admits the
        head only when the pool can cover its worst case) and dispatch the
        step the slot mix calls for (a fused mixed step while any slot is
        mid-prefill, else a decode block or a speculative window), with no
        host read. Returns the pending record for :meth:`step_commit`, or
        None when the engine is idle (or a tolerated fault reset it).
        Exactly one step may be in flight."""
        if self._inflight is not None:
            raise RuntimeError("step_begin with a step already in flight "
                               "— commit it first (step_commit)")
        # the dispatch (a graph capture included) counts as in flight: a
        # cancel from another thread waits for the commit
        self._inflight = _DISPATCHING
        with self._on_stream():
            try:
                self._enforce_deadlines()
                self._admit_loop()
                pending = self._dispatch()
            except Exception as e:                    # noqa: BLE001
                self._inflight = None
                if not self._tolerant:
                    raise
                self._fault_reset(e)
                return None
            self._inflight = pending
            if pending is None:
                self._apply_deferred_cancels()
        return pending

    def step_commit(self, pending: dict) -> None:
        """Second half: read the dispatched step back (its one host read)
        and do the host bookkeeping (token appends, phase flips,
        registration, retirement), then apply the cancels deferred while
        it was in flight, then tick the drift clock."""
        if pending is not self._inflight:
            raise RuntimeError("step_commit of a step that is not the "
                               "one in flight")
        with self._on_stream():
            try:
                {"mixed": self._mixed_commit,
                 "spec": self._spec_commit,
                 "decode": self._decode_commit}[pending["op"]](pending)
            except Exception as e:                    # noqa: BLE001
                self._inflight = None
                if not self._tolerant:
                    raise
                self._fault_reset(e)
                return
            self._inflight = None
            self.phase_time[pending["kind"]] += (time.perf_counter()
                                                 - pending["t0"])
            self._apply_deferred_cancels()
            # the chip ages only while it computes: an idle iteration
            # reaches no commit, so the clock ticks worked steps only
            if self._drift:
                self._advance_drift()

    def _apply_deferred_cancels(self) -> None:
        """Retire the slotted requests whose cancel waited for the step in
        flight (a finish during the commit won)."""
        for uid, status, reason in self._deferred_cancels:
            for b, s in enumerate(self.slots):
                if s is not None and s.req.uid == uid:
                    if status == "cancelled":
                        self.cancel_count += 1
                    self._retire_slot(b, status, reason)
                    break
        self._deferred_cancels.clear()

    def run(self, requests: Sequence[Request] = ()) -> dict[int, np.ndarray]:
        """Drive until every queued or submitted request completes."""
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return self.results

    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet admitted to a slot."""
        return len(self.queue)

    def drain_events(self) -> list[tuple]:
        """Pop every pending stream event, in order: ``("token", uid,
        tok)`` per sampled token, ``("done", uid, status)`` per terminal
        transition."""
        out = list(self.events)
        self.events.clear()
        return out

    @property
    def prefix_enabled(self) -> bool:
        """True when this engine runs the radix prefix cache
        (``prefix_cache`` with ``paged=True``, any family; ssm and hybrid
        on the state-snapshot pool)."""
        return self._prefix

    @property
    def paged_enabled(self) -> bool:
        """True when the KV cache lives in the block pool (``paged=True``
        on a family with attention)."""
        return self._paged

    @property
    def spec_enabled(self) -> bool:
        """True when pure-decode steps run draft-and-verify windows
        (``speculative=True`` on the dense or moe family)."""
        return self._spec

    @property
    def spec_acceptance(self) -> float:
        """Share of the proposed drafts that the target accepted."""
        return self.spec_accepted / max(1, self.spec_proposed)

    @property
    def drift_enabled(self) -> bool:
        """True when every worked step advances the drift clock
        (``drift_dt > 0`` on params with device state)."""
        return self._drift

    @property
    def recal_enabled(self) -> bool:
        """True when the watchdog may reprogram the chip in place
        (``recalibrate=True`` on a drift-enabled engine)."""
        return self._recal

    @property
    def num_active(self) -> int:
        """Slots holding a request (prefilling or decoding)."""
        return sum(s is not None for s in self.slots)

    @property
    def step_budget(self) -> int:
        """Per-step token budget of the fused mixed step."""
        return (self.scfg.step_tokens
                or self.scfg.num_slots + 2 * self.scfg.prefill_chunk)

    @property
    def prefill_batch(self) -> int:
        """Compact width of the fused step's chunk forward."""
        return max(1, min(self.scfg.num_slots,
                          (self.step_budget - self.scfg.num_slots)
                          // self.scfg.prefill_chunk))

    @property
    def caches_tbl_width(self) -> int:
        """Block-table row width (logical blocks per slot) when paged."""
        return -(-self.scfg.max_len // self.scfg.kv_block_size)

    # ------------------------------------------------------------------
    # admission and retirement
    # ------------------------------------------------------------------

    def _blocks_needed(self, req: Request) -> int:
        """Worst-case pool blocks a request holds (padded prompt + budget)."""
        return self.pool.blocks_for(
            padded_prompt_len(len(req.prompt), self.scfg.prefill_chunk),
            req.max_new)

    def _admit_loop(self) -> None:
        """Admit queue heads into free slots (strict FIFO: a head the pool
        cannot cover waits, and nothing behind it overtakes it). On a
        tolerant engine an allocator fault at admission sheds the head
        with its reason instead of failing the step."""
        free = [b for b in range(self.scfg.num_slots)
                if self.slots[b] is None]
        while free and self.queue:
            try:
                self._chaos("alloc")
                plan = self._plan_admission(self.queue[0])
            except Exception as e:                    # noqa: BLE001
                if not self._tolerant:
                    raise
                req = self.queue.popleft()
                self.shed_count += 1
                self._finish_unadmitted(
                    req.uid, "shed",
                    f"allocator fault at admission: "
                    f"{type(e).__name__}: {e}")
                continue
            if plan is None:
                break                          # out of blocks: head waits
            self._admit_request(self.queue.popleft(), free.pop(0), plan)

    def _dispatch(self) -> Optional[dict]:
        """Dispatch the step kind the slot mix calls for; returns its
        pending record (None: idle)."""
        decode_rows = [b for b, s in enumerate(self.slots)
                       if s is not None and not s.prefilling]
        prefill_rows = [b for b, s in enumerate(self.slots)
                        if s is not None and s.prefilling]
        t0 = time.perf_counter()
        if prefill_rows:
            pending = self._mixed_dispatch(decode_rows, prefill_rows)
            kind = "mixed" if decode_rows else "prefill"
        elif decode_rows:
            # a model drafter takes the window even at k = 0 (a row one
            # token from its budget): its draft step still consumes the
            # emitted token, keeping its cache in step; a host drafter has
            # no cache and falls back to the cheaper decode block
            if self._spec and (self.draft_caches is not None
                               or self._spec_k(decode_rows)):
                pending = self._spec_dispatch(decode_rows)
            else:
                pending = self._decode_dispatch(decode_rows)
            kind = "decode"
        else:
            return None
        pending["kind"], pending["t0"] = kind, t0
        return pending

    def _chaos(self, point: str) -> None:
        """Call the chaos hook at a named fault-injection point."""
        if self.chaos_hook is not None:
            self.chaos_hook(point)

    def _on_stream(self):
        """Context that puts the engine's device work on its own stream
        (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _enforce_deadlines(self) -> None:
        """Retire every request past its TTFT or end-to-end deadline: a
        queued one leaves the queue, a slotted one releases its blocks and
        snapshots and keeps its partial output. Runs in
        :meth:`step_begin` only, so it never races a step in flight."""
        now = time.perf_counter()

        def overdue(req, started):
            born = self.submit_time.get(req.uid, now)
            dl = min(req.ttft_deadline or float("inf"),
                     req.deadline or float("inf")) if not started else (
                         req.deadline or float("inf"))
            return now - born > dl

        stale = [r.uid for r in self.queue if overdue(r, False)]
        for uid in stale:
            self.timeout_count += 1
            self.cancel(uid, status="timed_out",
                        reason="deadline passed while queued")
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            if s.count == 0 and overdue(s.req, False):
                self.timeout_count += 1
                self._retire_slot(b, "timed_out",
                                  "TTFT deadline passed during prefill")
            elif s.count > 0 and overdue(s.req, True):
                self.timeout_count += 1
                self._retire_slot(b, "timed_out",
                                  "end-to-end deadline passed mid-decode")

    def _finish_unadmitted(self, uid: int, status: str,
                           reason: Optional[str]) -> None:
        """Terminal bookkeeping of a request that never held a slot (shed,
        or cancelled or timed out while queued)."""
        self.results[uid] = np.zeros(0, np.int32)
        self.status[uid] = status
        if reason is not None:
            self.errors[uid] = reason
        self.finished_at[uid] = time.perf_counter()
        self.events.append(("done", uid, status))

    def _plan_admission(self, req: Request) -> Optional[dict]:
        """The queue head's padded prompt layout and its prefix-cache match,
        or None when the pool cannot cover the blocks it still needs
        (backpressure). Consumed by :meth:`_admit_request` in the same
        iteration, so nothing can intervene between the two."""
        c = self.scfg.prefill_chunk
        plen = len(req.prompt)
        padded = padded_prompt_len(plen, c)
        npad = padded - plen
        toks = np.zeros(padded, np.int64)
        toks[npad:] = np.asarray(req.prompt, np.int64)
        mask = np.zeros(padded, np.float32)
        mask[npad:] = 1.0
        keys, hit, tail, snap = [], [], None, None
        if self._prefix:
            idx = self.pool if self.pool is not None else self.state_pool
            keys = idx.prefix_keys(toks, npad)
            if self.pool is not None:
                hit, tail = self.pool.match_prefix(toks, npad, keys=keys)
            if self.state_pool is not None:
                # a state family skips only to a boundary with a snapshot,
                # short of the last chunk (it re-runs for the first-token
                # logits) and, on a hybrid stack, within the KV hit (the
                # skipped positions' attention reads the cached blocks);
                # the hybrid takes no tail, whose region re-runs anyway
                limit = (padded - c) // self.scfg.kv_block_size
                if self.pool is not None:
                    limit = min(limit, len(hit))
                    tail = None
                snap = self.state_pool.match_deepest(keys[:limit])
        if self.pool is not None:
            need = self._blocks_needed(req) - len(hit)
            # hit blocks stop being evictable when admission takes them;
            # the copy-on-write source must survive until the copy
            protect = frozenset(hit) | (
                frozenset((tail[0],)) if tail else frozenset())
            if not self.pool.can_alloc(need, protect):
                return None
        return dict(toks=toks, mask=mask, npad=npad, keys=keys, hit=hit,
                    tail=tail, snap=snap)

    def _admit_request(self, req: Request, b: int, plan: dict) -> None:
        """Bind slot ``b`` to ``req``: map its block-table row onto the
        prefix-hit blocks plus fresh private ones, reset its cache rows with
        ``pos`` past the (chunk-aligned) hit, copy a matched partial tail or
        restore a matched snapshot, and plan only the remaining chunks. No
        model math: the chunks stream through the following fused steps."""
        c = self.scfg.prefill_chunk
        toks, npad = plan["toks"], plan["npad"]
        hit, tail, snap = plan["hit"], plan["tail"], plan["snap"]
        padded, nhit = len(toks), len(hit)
        row = wrow = None
        skip, blocks, hit_tokens = 0, [], 0
        if self.pool is not None:
            protect = frozenset((tail[0],)) if tail else frozenset()
            fresh = self.pool.admit(req.uid, hit,
                                    self._blocks_needed(req) - nhit, protect)
            blocks = list(hit) + fresh
            row = np.zeros(self.caches_tbl_width, np.int32)
            row[:len(blocks)] = blocks
            # write protection: the chunk writes that land in shared
            # prefix-hit blocks go to the sink instead
            wrow = row.copy()
            wrow[:nhit] = SINK_BLOCK
            bs = self.pool.block_size
            hit_tokens = min(nhit * bs + (tail[1] if tail else 0), padded)
            # pos starts past the hit, rounded down to a chunk boundary;
            # the last chunk always re-runs so the first-token logits exist
            skip = min(hit_tokens - hit_tokens % c, padded - c)
        if self.state_pool is not None:
            # a state family skips exactly to the restored snapshot (or not
            # at all): the recurrence cannot jump past tokens it never
            # consumed. Snapshots are captured at chunk boundaries only.
            skip = snap[0] * self.state_pool.block_size if snap else 0
            assert skip % c == 0
            hit_tokens = max(hit_tokens, skip)
            if snap:
                self.state_snap_restores += 1
        if self._prefix:
            # one lookup per admission (a backpressured head's retries
            # would deflate the hit rate)
            self.prefix_lookups += 1
            if hit_tokens:
                self.prefix_hits += 1
                self.prefix_hit_tokens += hit_tokens
                self.prefix_skipped_tokens += skip
        self._reset_slot(b, start=npad, pos=skip, table=row, wtable=wrow,
                         restore=snap[1] if snap else None)
        if tail:
            self._copy_block(tail[0], blocks[nhit])
            self.prefix_cow_copies += 1
        self._pos[b], self._start[b] = skip, npad
        self._temp[b], self._topp[b] = req.temperature, req.top_p
        self._topk[b] = req.top_k
        slot = _Slot(req, toks, plan["mask"], npad, c, self._admit_seq,
                     skip=skip)
        slot.blocks, slot.keys, slot.hit_full = blocks, plan["keys"], nhit
        slot.hit_snap = snap[0] if snap else 0
        self.slots[b] = slot
        self.status[req.uid] = "prefill"
        self._admit_seq += 1
        self._dirty = True

    def _reset_slot(self, b: int, start: int, pos: int,
                    table: Optional[np.ndarray],
                    wtable: Optional[np.ndarray],
                    restore: Optional[int] = None) -> None:
        """Reset slot ``b``'s cache rows on the device, in place:
        ``start`` marker, ``pos`` cursor, state rows zeroed (or copied from
        snapshot slot ``restore`` of their ``*_snap`` sibling), read and
        write block-table rows set to ``table`` / ``wtable`` (all zeros,
        the sink, on retirement). Pool leaves are untouched: stale blocks
        are masked, never attended."""
        dev = self.device
        rows = {kind: torch.as_tensor(r, device=dev) for kind, r in
                (("table", table), ("wtable", wtable)) if r is not None}

        def rec(tree: dict, axes: dict, kinds: dict) -> None:
            for name, leaf in tree.items():
                if isinstance(leaf, dict):
                    rec(leaf, axes[name], kinds[name])
                    continue
                kind = kinds[name]
                if kind in ("pool", "spool"):
                    continue
                row = leaf.select(axes[name], b)
                if kind in rows:
                    row.copy_(rows[kind])
                elif kind == "start":
                    row.fill_(start)
                elif kind == "pos":
                    row.fill_(pos)
                elif restore is not None:
                    row.copy_(tree[name + "_snap"].select(axes[name],
                                                          restore))
                else:
                    row.zero_()

        rec(self.caches, self._axes, self._kinds)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` into ``dst`` on every pool leaf (the
        copy-on-write of a frozen partial tail): the block axis of every
        pool leaf is 1, after the stacked layer axis."""
        for leaf, kind in _walk(self.caches, self._kinds):
            if kind == "pool":
                leaf.select(1, dst).copy_(leaf.select(1, src))

    def _snapshot_leaves(self):
        """``(state leaf, its snapshot pool, slot axis)`` of every mamba
        state leaf of the cache tree."""
        def rec(tree: dict, axes: dict, kinds: dict):
            for name, leaf in tree.items():
                if isinstance(leaf, dict):
                    yield from rec(leaf, axes[name], kinds[name])
                elif kinds[name] == "spool":
                    src = name[:-len("_snap")]
                    yield tree[src], leaf, axes[src]

        return rec(self.caches, self._axes, self._kinds)

    def _register_slot(self, s: _Slot) -> None:
        """Index the slot's freshly computed prompt blocks when its prefill
        completes: private full blocks under their chain keys, and the
        frozen partial tail (its content below the fill is immutable from
        here on: writes are append-only)."""
        bs = self.pool.block_size
        nfull = len(s.toks) // bs
        self.pool.register(s.keys[s.hit_full:nfull],
                           s.blocks[s.hit_full:nfull])
        fill = len(s.toks) % bs
        if fill and nfull < len(s.blocks):
            parent = (s.keys[nfull - 1] if nfull
                      else (self.pool.salt, s.npad))
            self.pool.register_tail(parent, s.blocks[nfull], fill,
                                    s.toks[nfull * bs:])

    def _maybe_snapshot(self, b: int, s: _Slot) -> None:
        """Capture slot ``b``'s SSM / conv state into the snapshot pool
        when its prefill cursor just landed on a block boundary: the state
        at ``m * kv_block_size`` tokens summarizes exactly the padded
        prompt blocks chain key ``keys[m - 1]`` addresses. Best-effort:
        with every snapshot slot live the boundary stays cold."""
        bs = self.state_pool.block_size
        p = int(self._pos[b])
        if p % bs:
            return
        m = p // bs
        if m < 1 or m <= s.hit_snap or m > len(s.keys):
            return
        key = s.keys[m - 1]
        if self.state_pool.has(key) or any(k == key for k, _ in s.snaps):
            return
        dst = self.state_pool.acquire(s.req.uid)
        if dst is None:
            return
        for state, snap, ax in self._snapshot_leaves():
            snap.select(ax, dst).copy_(state.select(ax, b))
        s.snaps.append((key, dst))
        self.state_snaps_captured += 1

    def _register_snaps(self, s: _Slot) -> None:
        """Index the snapshots captured in the slot's prefill (at the
        prefill-to-decode flip, beside :meth:`_register_slot`) and drop
        the request's ownership: indexed snapshots wait in the pool's LRU,
        a first-writer-wins loser goes back to the free list."""
        for key, dst in s.snaps:
            self.state_pool.register(key, dst)
        if s.snaps:
            self.state_pool.release(s.req.uid)

    def _retire_slot(self, b: int, status: str,
                     reason: Optional[str] = None) -> None:
        """Retire slot ``b`` into terminal ``status`` (the one retirement
        path of finish, cancel, timeout and deadline): record its full or
        partial output, release every pool reference it holds (KV blocks,
        the copy-on-write tail, snapshots captured and never registered)
        and point its block tables at the sink, so that the freed row's
        masked writes cannot land in blocks the next admission gets, or in
        retained cache blocks."""
        slot = self.slots[b]
        uid = slot.req.uid
        self.results[uid] = np.array(slot.out, np.int32)
        self.finished_at[uid] = time.perf_counter()
        self.status[uid] = status
        if reason is not None:
            self.errors[uid] = reason
        self.events.append(("done", uid, status))
        self.slots[b] = None
        self._dirty = True
        if self.state_pool is not None and self.state_pool.owns(uid):
            self.state_pool.release(uid)
        if self.pool is not None:
            # indexed zero-ref blocks stay in the pool's LRU for reuse,
            # the rest return to the free list
            self.pool.release(uid)
            zrow = np.zeros(self.caches_tbl_width, np.int32)
            self._reset_slot(b, start=0, pos=0, table=zrow, wtable=zrow)

    def _fault_reset(self, exc: BaseException) -> None:
        """Recover from a fault raised in a step: every in-flight request
        ends ``errored`` with its partial output and the fault's message,
        the host pools are made anew (their index with them), every cache
        leaf of the engine and of its drafter is zeroed in place (no leaf
        is replaced, so graphs over them stay valid; the state is that of
        a fresh engine) and the host mirrors are reset. The queue is
        untouched. On the card the reset ends with a synchronize, so that
        a device-side error, which no reset can serve after, propagates
        from here."""
        msg = f"step fault: {type(exc).__name__}: {exc}"
        self.step_faults.append(msg)
        self.fault_count += 1
        now = time.perf_counter()
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            uid = s.req.uid
            self.results[uid] = np.array(s.out, np.int32)
            self.finished_at[uid] = now
            self.status[uid] = "errored"
            self.errors[uid] = msg
            self.events.append(("done", uid, "errored"))
            self.slots[b] = None
        self._deferred_cancels.clear()
        self._inflight = None
        scfg = self.scfg
        if self.pool is not None:
            self.pool = KVPool(self.pool.num_blocks, scfg.kv_block_size,
                               salt=scfg.cache_salt)
        if self.state_pool is not None:
            self.state_pool = StateSnapshotPool(
                self.state_pool.num_blocks, scfg.kv_block_size,
                salt=scfg.cache_salt)
        for tree in (self.caches, self.draft_caches):
            for (leaf,) in _walk(tree or {}):
                if isinstance(leaf, (torch.Tensor, sharding.Shards)):
                    leaf.zero_()
        if self._stream is not None:
            self._stream.synchronize()
        self._pos[:] = 0
        self._start[:] = 0
        self._last_tok[:] = 0
        self._dirty = True

    # ------------------------------------------------------------------
    # the drift clock and its watchdog
    # ------------------------------------------------------------------

    def _read_health(self) -> None:
        """Read per-tile health into the telemetry; a non-finite read
        raises (and leaves the telemetry as it was)."""
        h = devices.health(self.params)
        if not np.isfinite(h["mean_scale_err"]):
            raise ValueError(f"non-finite tile health read: "
                             f"{h['mean_scale_err']}")
        self.tile_scale_err = h["mean_scale_err"]
        self.dead_tiles = h["dead_tiles"]
        self.stuck_cols = h["stuck_cols"]

    def _advance_drift(self) -> None:
        """Tick the deployment clock after a worked step; every
        ``recal_interval`` ticks read health and, past ``recal_threshold``
        with ``recalibrate=True``, reprogram the chip in place (the leaves
        of ``self.params`` are written, never replaced; caches, pool and
        slots are untouched). A tolerant engine skips a failed or
        non-finite health read and counts it in ``health_faults``."""
        devices.advance(self.params, self.scfg.drift_dt)
        self.drift_hours += self.scfg.drift_dt
        self._steps_since_check += 1
        if self._steps_since_check < self.scfg.recal_interval:
            return
        self._steps_since_check = 0
        try:
            self._chaos("health")
            self._read_health()
        except Exception as e:                        # noqa: BLE001
            if not self._tolerant:
                raise
            # a corrupted read must never drive the watchdog: skip this
            # check, count it and keep serving; the next interval reads
            # afresh
            self.health_faults += 1
            self.step_faults.append(
                f"health-read fault (watchdog check skipped): "
                f"{type(e).__name__}: {e}")
            return
        self.watchdog_checks += 1
        if self._recal and self.tile_scale_err > self.scfg.recal_threshold:
            t0 = time.perf_counter()
            gen = torch.Generator().manual_seed(0x5ECA1 + self.recal_count)
            devices.recalibrate(self.params, gen)
            self.recal_count += 1
            self._read_health()
            self.recal_time += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # the step: static buffers, staged uploads, the bodies
    # ------------------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _init_step_buffers(self) -> None:
        """Allocate, once, every tensor a step body reads that varies from
        step to step and every tensor it writes: the per-slot step state
        (``_dev``: ``toks``, ``off``, ``active``, ``temp``, ``topk``,
        ``topp``), the greedy mask and the noise ``[steps, num_slots, V]``
        of a decode block, a drafter's steps or a window's columns (row 1
        also serves the fused step's compact rows), the fused step's chunk
        inputs, the drafts and the window's counters, and the outputs. The
        host writes the inputs in place from staging twins (pinned on the
        card) on the engine's stream, so a graph over them stays valid."""
        scfg, nb, dev = self.scfg, self.scfg.num_slots, self.device
        c, pbw = scfg.prefill_chunk, self.prefill_batch
        kd = scfg.draft_k if self._spec else 1
        ns = max(scfg.decode_block, kd + 1)
        i64, f32 = torch.int64, torch.float32
        staged = {"toks": ((nb,), i64), "off": ((nb,), i64),
                  "active": ((nb,), f32), "temp": ((nb,), f32),
                  "topk": ((nb,), i64), "topp": ((nb,), f32),
                  "greedy": ((ns, nb), torch.bool),
                  "noise_idx": ((ns * nb,), i64),
                  "pf_toks": ((pbw, c), i64), "pf_mask": ((pbw, c), f32),
                  "pf_off": ((pbw,), i64), "pf_idx": ((pbw,), i64),
                  "drafts": ((kd, nb), i64), "counts": ((nb,), i64),
                  "gfirst": ((nb,), i64)}
        outputs = {"out": ((ns, nb), i64), "first": ((pbw,), i64),
                   "target": ((kd + 1, nb), i64), "n_emit": ((nb,), i64)}
        self._buf = {n: torch.zeros(s, dtype=t, device=dev)
                     for n, (s, t) in {**staged, **outputs}.items()}
        self._buf["noise"] = torch.full((ns, nb, self.cfg.vocab_size), 0.5,
                                        device=dev)
        cuda = dev.type == "cuda"
        self._stage = {n: torch.zeros(s, dtype=t, pin_memory=cuda)
                       for n, (s, t) in staged.items()}
        # per staging twin, its last copy: the host writes a twin only
        # after that copy has been made
        self._staged = {n: torch.cuda.Event() if cuda else None
                        for n in staged}
        self._dev = {n: self._buf[n] for n in ("toks", "off", "active",
                                               "temp", "topk", "topp")}

    def _upload(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Write ``arr`` into the leading rows of static buffer ``name`` (a
        copy from its staging twin on the current stream); returns those
        rows."""
        ev, st = self._staged[name], self._stage[name]
        n = len(arr) if np.ndim(arr) else None
        if ev is not None:
            ev.synchronize()
        st[:n].numpy()[...] = arr
        rows = self._buf[name][:n]
        rows.copy_(st[:n], non_blocking=ev is not None)
        if ev is not None:
            ev.record()
        return rows

    def _refresh_device_state(self) -> None:
        """Write the per-slot step state from the host mirrors into its
        static buffers (only when the slot set changed since the last
        step)."""
        active = np.array([s is not None and not s.prefilling
                           for s in self.slots], np.float32)
        for name, arr in (("toks", self._last_tok),
                          ("off", self._pos - self._start),
                          ("active", active), ("temp", self._temp),
                          ("topk", self._topk), ("topp", self._topp)):
            self._upload(name, arr)
        self._dirty = False

    def _stage_sampling(self, rows: Sequence[int], steps: int,
                        first: Sequence[tuple] = ()) -> tuple:
        """Stage the greedy mask and the noise of a step: slot ``b`` of
        ``rows`` draws its ``count + i``-th token at step ``i < steps``
        (mask and noise row ``i``, column ``b``), and each ``(j, b)`` of
        ``first`` its first token from the fused step's compact row ``j``
        (row 1, column ``j``). A draw is greedy below the request's
        ``greedy_first`` or at temperature 0, and then gets no noise; every
        other entry of the mask is greedy. The noise of a sampled draw is
        ``request_uniforms(seed, count)``, drawn here, outside any body.
        Returns the body's sampling key ``(sampled, use_top_k,
        use_top_p)``."""
        greedy = np.ones(self._buf["greedy"].shape, bool)
        nb = greedy.shape[1]
        draws = [(i, b, b, self.slots[b].count + i)
                 for b in rows for i in range(steps)]
        draws += [(1, j, b, 0) for j, b in first]
        seeds, cnts, flat = [], [], []
        top_k = top_p = False
        for i, col, b, cnt in draws:
            req = self.slots[b].req
            if cnt >= req.greedy_first and req.temperature > 0.0:
                greedy[i, col] = False
                seeds.append(req.seed)
                cnts.append(cnt)
                flat.append(i * nb + col)
                top_k |= req.top_k > 0
                top_p |= req.top_p < 1.0
        self._upload("greedy", greedy)
        if flat:
            noise = self._buf["noise"]
            noise.view(-1, noise.shape[-1]).index_copy_(
                0, self._upload("noise_idx", np.asarray(flat, np.int64)),
                request_uniforms(seeds, cnts, noise.shape[-1], self.device))
        return (bool(flat), top_k, top_p)

    def _run_body(self, key: tuple, body) -> None:
        """Run a step body: as a captured graph on the card (captured at
        the key's first use), eagerly on the CPU or with ``_eager``."""
        if self.step_graphs is None or self._eager:
            body()
        else:
            self.step_graphs.run(key, body, torch.cuda.current_stream(
                self.device))

    def _sample_step(self, logits: torch.Tensor, i: int, key: tuple,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample one token per row of ``logits`` [n, V] with greedy mask
        and noise row ``i``; ``idx`` maps the rows to slots (None: row
        ``b`` is slot ``b``). Body code."""
        sampled, top_k, top_p = key
        d, n = self._dev, logits.shape[0]
        temp, topk, topp = d["temp"], d["topk"], d["topp"]
        if idx is not None:
            temp, topk, topp = (t.index_select(0, idx)
                                for t in (temp, topk, topp))
        return sample_logits_batched(
            logits, temp, topk, topp, self._buf["greedy"][i, :n],
            self._buf["noise"][i, :n] if sampled else None,
            use_top_k=top_k, use_top_p=top_p)

    def _target_step(self) -> torch.Tensor:
        """One decode forward over every slot (rows not decoding are
        masked and leave the cache as it was); returns the logits [B, V].
        Body code."""
        d = self._dev
        logits, new = serve_step(
            self.params, self.cfg, self.acfg, d["toks"][:, None],
            self.caches, d["off"][:, None], seq_mask=d["active"][:, None])
        _keep_leaves(self.caches, new)
        return logits

    def _decode_body(self, k: int, key: tuple) -> None:
        """``k`` decode-and-sample steps back to back: step ``i`` samples
        with mask and noise row ``i``, feeds its tokens to the next one and
        writes them to ``out[i]``. Body code (the reference's
        ``_decode_scan``)."""
        d, out = self._dev, self._buf["out"]
        for i in range(k):
            tok = self._sample_step(self._target_step(), i, key)
            d["toks"].copy_(tok)
            d["off"].add_(1)
            out[i].copy_(tok)

    @torch.no_grad()
    def _decode_dispatch(self, decode_rows: list[int]) -> dict:
        """A decode block over all slots (no admission in flight): the
        largest power-of-two ``k <= decode_block`` that no in-flight budget
        can overshoot, back to back on the device."""
        if self._dirty:
            self._refresh_device_state()
        self._chaos("dispatch")
        k = 1
        remaining = min(self.slots[b].req.max_new - self.slots[b].count
                        for b in decode_rows)
        while k * 2 <= min(remaining, self.scfg.decode_block):
            k *= 2
        key = self._stage_sampling(decode_rows, k)
        self._run_body(("decode", k) + key,
                       lambda: self._decode_body(k, key))
        self.decode_steps += k
        self.step_token_log.append((len(decode_rows) * k, 0))
        return dict(op="decode", dec_toks=self._buf["out"][:k],
                    decode_rows=decode_rows)

    def _decode_commit(self, p: dict) -> None:
        """Read the block's tokens back (the step's one host read) and
        append them to their requests."""
        self._consume_decode_tokens(p["dec_toks"].cpu().numpy(),
                                    p["decode_rows"])

    def _gather_rows(self, idx: torch.Tensor, caches=None,
                     axes=None) -> dict:
        """The cache rows of slots ``idx`` as a compact batch (pool leaves
        pass through whole); the engine's caches unless ``caches`` and
        their ``axes`` are given (the drafter's)."""
        if caches is None:
            caches, axes = self.caches, self._axes
        return _map_leaves(lambda leaf, ax: leaf if ax < 0
                           else leaf.index_select(ax, idx), caches, axes)

    def _scatter_rows(self, sub: dict, idx: torch.Tensor, caches=None,
                      axes=None) -> None:
        """Write a compact batch back to its slots (``idx`` rows are
        distinct; pool leaves were updated in place)."""
        if caches is None:
            caches, axes = self.caches, self._axes
        for leaf, full, ax in _walk(sub, caches, axes):
            if ax >= 0:
                full.index_copy_(ax, idx, leaf)

    def _mixed_body(self, has_dec: bool, drafter: bool, key: tuple) -> None:
        """The fused step: with decode rows, the model drafter's catch-up
        (it consumes the decode substep's input token; its logits are not
        used) and one decode-and-sample substep into ``out[0]``; then the
        chunk forward of the compact rows ``pf_idx`` (gathered, run at
        ``pf_off`` under ``pf_mask``, scattered back) and the first-token
        sample of every compact row into ``first``. Body code (the
        reference's ``_mixed_step_jit`` with ``_draft_step_jit``)."""
        d, buf = self._dev, self._buf
        if has_dec:
            if drafter:
                self._draft_forward(d["toks"], d["off"], d["active"])
            self._decode_body(1, key)
        idx = buf["pf_idx"]
        sub = self._gather_rows(idx)
        logits, _, sub = model_apply(
            self.params, self.cfg, self.acfg, AnalogCtx(),
            {"tokens": buf["pf_toks"]}, caches=sub,
            pos_offset=buf["pf_off"][:, None], seq_mask=buf["pf_mask"],
            last_only=True)
        self._scatter_rows(sub, idx)
        buf["first"].copy_(self._sample_step(logits[:, -1], 1, key, idx))

    @torch.no_grad()
    def _mixed_dispatch(self, decode_rows: list[int],
                        prefill_rows: list[int]) -> dict:
        """One fused step: a decode token for every decode-phase slot, then
        as many admitting slots' prefill chunks as the budget allows
        (oldest admission first, at least one), gathered into a
        ``[prefill_batch, chunk]`` forward and scattered back. Unused
        compact rows are distinct filler slots with all-zero masks, which
        the layers leave untouched. The last-position logits of every
        compact row are sampled at token count 0; the host keeps the
        sample of a row whose prompt finished."""
        if self._dirty:
            self._refresh_device_state()
        self._chaos("dispatch")
        c, pbw = self.scfg.prefill_chunk, self.prefill_batch
        n_dec = len(decode_rows)
        n_pf = int(np.clip((self.step_budget - n_dec) // c, 1,
                           min(len(prefill_rows), pbw)))
        pf_rows = sorted(prefill_rows, key=lambda b: self.slots[b].seq)[:n_pf]
        filler = [b for b in range(self.scfg.num_slots) if b not in pf_rows]
        pf_idx = pf_rows + filler[:pbw - n_pf]
        pf_toks = np.zeros((pbw, c), np.int64)
        pf_mask = np.zeros((pbw, c), np.float32)
        pf_off = np.zeros(pbw, np.int64)
        for i, b in enumerate(pf_rows):
            s = self.slots[b]
            j = s.chunk
            pf_toks[i] = s.toks[j * c:(j + 1) * c]
            pf_mask[i] = s.mask[j * c:(j + 1) * c]
            pf_off[i] = j * c - s.npad
        for name, arr in (("pf_toks", pf_toks), ("pf_mask", pf_mask),
                          ("pf_off", pf_off),
                          ("pf_idx", np.asarray(pf_idx, np.int64))):
            self._upload(name, arr)
        done = [(i, b) for i, b in enumerate(pf_rows)
                if self.slots[b].chunk + 1 == self.slots[b].nchunks]
        key = self._stage_sampling(decode_rows, 1, done)
        k = 1 if n_dec else 0
        drafter = self.draft_caches is not None
        self._run_body(("mixed", bool(k), drafter) + key,
                       lambda: self._mixed_body(bool(k), drafter, key))
        if k:
            self.mixed_steps += 1          # steps that fused both phases
            if drafter:
                self.draft_forwards += 1
        self.prefill_forwards += 1
        self.prefill_chunks += len(pf_rows)
        self.step_token_log.append((n_dec * k, len(pf_rows) * c))
        return dict(op="mixed", dec=self._buf["out"][0] if k else None,
                    first=self._buf["first"][:n_pf], pf_rows=pf_rows,
                    decode_rows=decode_rows, k=k, n_dec=n_dec)

    def _mixed_commit(self, p: dict) -> None:
        """Host bookkeeping of the fused step: chunk cursors, snapshot
        capture, phase flips (block and snapshot registration, the sampled
        first token), decode-token appends. One host read for the step's
        tokens."""
        c = self.scfg.prefill_chunk
        pf_rows, k = p["pf_rows"], p["k"]
        both = (torch.cat([p["first"], p["dec"]]) if k else p["first"])
        host = both.cpu().numpy()
        first, dec = host[:len(p["first"])], host[len(p["first"]):]
        for i, b in enumerate(pf_rows):
            s = self.slots[b]
            s.chunk += 1
            self._pos[b] += c                  # the chunk advanced the row
            if self.state_pool is not None:
                self._maybe_snapshot(b, s)
            if not s.prefilling:               # prompt done: first token
                if self._prefix:
                    # index the prompt's blocks and snapshots before the
                    # first token can retire the request (release must
                    # see the entries to retain the blocks)
                    if self.pool is not None:
                        self._register_slot(s)
                    if self.state_pool is not None:
                        self._register_snaps(s)
                self._dirty = True             # row flips to decode phase
                self._append_token(b, int(first[i]))
                if (self.draft_caches is not None
                        and self.slots[b] is not None):
                    # the model drafter's cache reaches the same position
                    # before the slot's first window: the whole padded
                    # prompt in one forward (the drafter has no prefix
                    # cache; skipped if the first token retired the row)
                    self._draft_prefill(b, s)
        if k:
            self.decode_steps += k
            self.decode_tokens_during_admission += p["n_dec"] * k
            self._consume_decode_tokens(dec[None], p["decode_rows"])

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    def _spec_k(self, decode_rows: list[int]) -> int:
        """Proposals a row of the next window: ``draft_k``, clipped so that
        no row writes past its budget (a window at ``pos`` writes up to
        ``pos + k``, and ``k <= min(remaining) - 1`` keeps that inside the
        span its capacity was checked for), below ``draft_k`` to a power
        of two; 0 when some row has one token left."""
        head = min(self.slots[b].req.max_new - self.slots[b].count
                   for b in decode_rows) - 1
        if head < 1:
            return 0
        k = self.scfg.draft_k
        if k > head:
            k = 1
            while k * 2 <= head:
                k *= 2
        return k

    def _host_drafts(self, decode_rows: list[int], k: int) -> np.ndarray:
        """Host proposals ``[k, B]`` for the decode rows: ``draft_fn`` if
        given, else prompt-lookup n-grams over the prompt and the tokens
        generated so far. Short proposals are padded with 0, which
        exact-match verification simply rejects."""
        drafts = np.zeros((k, self.scfg.num_slots), np.int64)
        for b in decode_rows:
            s = self.slots[b]
            ctx = np.concatenate([s.toks[s.npad:],
                                  np.asarray(s.out, np.int64)])
            prop = (np.asarray(self.draft_fn(ctx, k), np.int64)
                    if self.draft_fn is not None
                    else _ngram_propose(ctx, k))[:k]
            drafts[:len(prop), b] = prop
        return drafts

    def _rewind_pos(self, caches: dict, axes: dict, kinds: dict,
                    delta: torch.Tensor) -> None:
        """Roll back speculatively written positions: subtract ``delta[b]``
        from every ``pos`` cursor of slot ``b``, in place (no leaf is
        replaced). Nothing moves: K/V past the cursor is never attended
        (every read is bounded by ``j <= pos + i``) and the next write
        overwrites it. Safe only above the pool's rewind floor, which
        :meth:`_spec_commit` checks."""
        for leaf, ax, kind in _walk(caches, axes, kinds):
            if kind == "pos":
                shape = [1] * leaf.dim()
                shape[ax] = -1
                leaf.sub_(delta.to(leaf.dtype).view(shape))

    def _draft_forward(self, toks: torch.Tensor, off: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
        """One decode step of the model drafter over every slot (inactive
        rows masked) on its own cache. Returns the logits [B, V]. Body
        code (the reference's ``_draft_step_jit``)."""
        logits, new = serve_step(
            self.draft_params, self.draft_cfg, self.draft_acfg,
            toks[:, None], self.draft_caches, off[:, None],
            seq_mask=active[:, None])
        _keep_leaves(self.draft_caches, new)
        return logits

    def _draft_prefill(self, b: int, s: _Slot) -> None:
        """Reset slot ``b`` of the drafter's cache and run the whole padded
        prompt through the drafter, so that its cursor meets the target's
        at the prefill-to-decode flip."""
        caches, axes, kinds = self.draft_caches, self._daxes, self._dkinds
        for leaf, ax, kind in _walk(caches, axes, kinds):
            row = leaf.select(ax, b)
            if kind == "start":
                row.fill_(s.npad)
            else:
                row.zero_()
        idx = self._tensor(np.array([b], np.int64))
        sub = self._gather_rows(idx, caches, axes)
        _, _, sub = model_apply(
            self.draft_params, self.draft_cfg, self.draft_acfg, AnalogCtx(),
            {"tokens": self._tensor(s.toks[None])}, caches=sub,
            pos_offset=self._tensor(np.array([[-s.npad]], np.int64)),
            seq_mask=self._tensor(s.mask[None]), last_only=True)
        self._scatter_rows(sub, idx, caches, axes)
        self.draft_forwards += 1

    def _verify_body(self, k: int, key: tuple) -> torch.Tensor:
        """Score the window ``[last token, d_1 .. d_k]`` (``drafts[:k]``)
        in one ``[B, k+1]`` forward at each row's own offset (rows not
        decoding are masked and leave the cache as it was), verify it with
        the noise rows ``0 .. k`` and the staged ``counts`` / ``gfirst``,
        and rewind each row's cursor to its old position plus its emitted
        count. Writes ``target[:k+1]`` and ``n_emit`` and returns ``delta``
        [B], by which a model drafter rewinds its own cache. Body code (the
        reference's ``_spec_verify_jit``)."""
        d, buf = self._dev, self._buf
        nb = self.scfg.num_slots
        drafts = buf["drafts"][:k]
        window = torch.cat([d["toks"][:, None], drafts.T], dim=1)
        mask = d["active"][:, None].expand(nb, k + 1).contiguous()
        logits, _, new = model_apply(
            self.params, self.cfg, self.acfg, AnalogCtx(),
            {"tokens": window}, caches=self.caches,
            pos_offset=d["off"][:, None], seq_mask=mask)
        _keep_leaves(self.caches, new)
        sampled, top_k, top_p = key
        target, n_acc = speculative_verify(
            logits, drafts, None, buf["counts"], buf["gfirst"], d["temp"],
            d["topk"], d["topp"],
            uniforms=buf["noise"][:k + 1] if sampled else None,
            use_top_k=top_k, use_top_p=top_p)
        act = d["active"] > 0
        n_emit = torch.where(act, n_acc + 1, torch.zeros_like(n_acc))
        delta = torch.where(act, k + 1 - n_emit, torch.zeros_like(n_emit))
        self._rewind_pos(self.caches, self._axes, self._kinds, delta)
        bonus = target.gather(0, n_acc[None])[0]
        d["toks"].copy_(torch.where(act, bonus, d["toks"]))
        d["off"].add_(n_emit)
        buf["target"][:k + 1].copy_(target)
        buf["n_emit"].copy_(n_emit)
        return delta

    def _spec_body(self, k: int, key: tuple) -> None:
        """``k + 1`` model drafter steps, each sampled with the verifier's
        mask and noise row, so that a drafter equal to the target proposes
        exactly the verifier's draws; the window takes drafts ``1 .. k``
        (the drafter's cache then holds exactly the window's tokens), then
        :meth:`_verify_body`, and the drafter rewinds by the same ``delta``
        as the target. Body code (the reference's ``_spec_step_jit``)."""
        d, drafts = self._dev, self._buf["drafts"]
        toks = d["toks"]
        for i in range(k + 1):
            toks = self._sample_step(
                self._draft_forward(toks, d["off"] + i, d["active"]), i, key)
            if i < k:
                drafts[i].copy_(toks)
        delta = self._verify_body(k, key)
        self._rewind_pos(self.draft_caches, self._daxes, self._dkinds, delta)

    @torch.no_grad()
    def _spec_dispatch(self, decode_rows: list[int]) -> dict:
        """One draft-and-verify window over every decode slot: propose
        ``k`` tokens a row (host drafter, or ``k + 1`` drafter steps),
        verify all ``k + 1`` positions in one forward, rewind the rejected
        ones. Opens the pool's rewind window over the rows' requests:
        releasing one of them before :meth:`_spec_commit` closes it is a
        pool error (the cancel-vs-rewind ordering contract)."""
        if self._dirty:
            self._refresh_device_state()
        self._chaos("dispatch")
        k = self._spec_k(decode_rows)
        nb = self.scfg.num_slots
        counts = np.zeros(nb, np.int64)
        # rows outside the window draw greedily (no noise; unused)
        gfirst = np.full(nb, k + 1, np.int64)
        for b in decode_rows:
            counts[b] = self.slots[b].count
            gfirst[b] = self.slots[b].req.greedy_first
        self._upload("counts", counts)
        self._upload("gfirst", gfirst)
        key = self._stage_sampling(decode_rows, k + 1)
        if self._draft_host:
            self._upload("drafts", self._host_drafts(decode_rows, k))
            self._run_body(("verify", k) + key,
                           lambda: self._verify_body(k, key))
        else:
            self._run_body(("spec", k) + key,
                           lambda: self._spec_body(k, key))
            self.draft_forwards += k + 1
        if self.pool is not None:
            self.pool.begin_window(self.slots[b].req.uid
                                   for b in decode_rows)
        return dict(op="spec", target=self._buf["target"][:k + 1],
                    n_emit=self._buf["n_emit"], decode_rows=decode_rows,
                    k=k)

    def _spec_commit(self, p: dict) -> None:
        """Read the window back (the step's one host read), close the
        pool's rewind window, append each row's emitted tokens (a stop
        token or the budget retires a row mid-window; the rest are
        dropped) and check the rewind floor of every surviving paged
        row."""
        decode_rows, k = p["decode_rows"], p["k"]
        host = torch.cat([p["target"], p["n_emit"][None]]).cpu().numpy()
        target, n_emit = host[:-1], host[-1]
        if self.pool is not None:
            self.pool.end_window()
        if k:                         # a k = 0 window is a decode step
            self.spec_steps += 1
        self.decode_steps += 1
        emitted = 0
        for b in decode_rows:
            ne = int(n_emit[b])
            self.spec_proposed += k
            self.spec_accepted += ne - 1
            uid = self.slots[b].req.uid
            for i in range(ne):
                if self.slots[b] is None:
                    break                  # stop or budget mid-window
                self._pos[b] += 1
                emitted += 1
                self._append_token(b, int(target[i, b]))
            if self.pool is not None and self.slots[b] is not None:
                self.pool.check_rewind(uid, int(self._pos[b]))
        self.step_token_log.append((emitted, 0))

    def _consume_decode_tokens(self, toks: np.ndarray,
                               decode_rows: list[int]) -> None:
        """Append a ``[k, B]`` block of tokens to their requests; a slot
        that retires mid-block stops consuming (tokens past a stop are
        discarded)."""
        for i in range(toks.shape[0]):
            for b in decode_rows:
                if self.slots[b] is not None:
                    self._pos[b] += 1
                    self._append_token(b, int(toks[i, b]))

    def _append_token(self, b: int, tok: int) -> None:
        """Record one sampled token; finish the request on a stop token or
        at its budget."""
        slot = self.slots[b]
        uid = slot.req.uid
        slot.out.append(tok)
        slot.count += 1
        self._last_tok[b] = tok
        if slot.count == 1:
            self.first_token_at[uid] = time.perf_counter()
            self.status[uid] = "decode"
        self.events.append(("token", uid, tok))
        if tok in slot.req.stop_tokens or slot.count >= slot.req.max_new:
            self._retire_slot(b, "finished")
