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
* **Per-request sampling and stop conditions** — temperature, top-k,
  top-p and ``greedy_first`` ride along as per-row tensors
  (``sampling.sample_logits_batched``). Randomness is counter-based: the
  noise of a request's ``n``-th token comes from a generator seeded by
  ``(seed, n)`` alone (``sampling.request_uniforms``), and every layer is
  row-independent, so a request draws the same tokens solo or mid-batch
  (the admission-parity contract). The draws are not the JAX package's:
  only greedy output is compared with it.

Cursors (``pos``, ``start``) live on the device; the engine keeps host
mirrors and reads the device once per engine step, for the sampled tokens.

**What this port does not run yet.** The JAX package's engine also has
radix prefix caching, speculative decoding, conductance drift and
recalibration, request deadlines, shedding and chaos recovery, and tensor
parallelism. Their ``SchedulerConfig`` / ``Request`` fields keep their
names here but default to off, and asking for one raises
``NotImplementedError`` naming its ROADMAP item. The reference's default is
``prefix_cache=True``; greedy decode with the prefix cache is bitwise equal
to decode without it, so the tests hold this engine against the
reference's with ``prefix_cache=False``. The step is not split into
``step_begin`` / ``step_commit`` (that split serves the async front end,
not ported either).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.models import transformer as T
from repro_torch.models.model import apply as model_apply
from repro_torch.serve.decode import serve_step
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.sampling import request_uniforms, sample_logits_batched


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
    ``deadline`` belong to the request lifecycle, not ported: non-zero
    values are refused at submit.
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

    The remaining fields are the JAX package's, for features not ported
    yet (see the module docstring). They default to off here, and turning
    one on raises: ``prefix_cache``, ``speculative``, ``drift_dt``,
    ``recalibrate``, ``max_queue``, ``fault_tolerant``, ``tp``. The
    fields that only tune those features (the prefix cache's salt, the
    drafter's, recalibration's) come with them.
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
    prefix_cache: bool = False
    speculative: bool = False
    drift_dt: float = 0.0
    recalibrate: bool = False
    max_queue: int = 0
    fault_tolerant: bool = False
    tp: int = 1


_SERVING = "ROADMAP section 1, item 5 (serving features)"
#: SchedulerConfig fields of features not ported: (off value, where queued)
_NOT_PORTED = {
    "prefix_cache": (False, _SERVING + ": prefix caching"),
    "speculative": (False, _SERVING + ": speculative decoding"),
    "drift_dt": (0.0, "ROADMAP section 1, item 4 (devices): drift"),
    "recalibrate": (False, "ROADMAP section 1, item 4 (devices): "
                           "recalibration"),
    "max_queue": (0, _SERVING + ": request lifecycle (shedding)"),
    "fault_tolerant": (False, _SERVING + ": request lifecycle (chaos "
                                         "recovery)"),
    "tp": (1, "ROADMAP section 1, item 6 (tensor parallelism)"),
}


class _Slot:
    """Host-side bookkeeping of one in-flight request."""

    def __init__(self, req: Request, toks: np.ndarray, mask: np.ndarray,
                 npad: int, chunk: int, seq: int):
        """The left-padded prompt ``toks`` / ``mask`` split into
        ``chunk``-sized pieces; ``seq`` is the admission order."""
        self.req = req
        self.out: list[int] = []
        self.count = 0                 # tokens sampled so far
        self.toks = toks
        self.mask = mask               # 1 = real token
        self.npad = npad               # left-pad count
        self.nchunks = len(toks) // chunk
        self.chunk = 0                 # next prefill chunk to run
        self.seq = seq

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
    mid-decode). The engine runs where ``params`` live: on the card the
    paged layout runs the paged-attention kernels, on the CPU their plain
    versions. Not ported (see the module docstring): prefix caching,
    speculative decoding, drift and recalibration, deadlines, shedding,
    chaos recovery and tensor parallelism.
    """

    def __init__(self, params, cfg, acfg: AnalogConfig,
                 scfg: SchedulerConfig = SchedulerConfig(), *,
                 chaos_hook=None):
        """Allocate the slot caches (and the block pool when paged) and the
        host-side request state. ``chaos_hook`` (fault injection) is not
        ported and raises."""
        for name, (off, where) in _NOT_PORTED.items():
            if getattr(scfg, name) != off:
                raise NotImplementedError(
                    f"SchedulerConfig.{name}={getattr(scfg, name)!r} is not "
                    f"ported yet ({where})")
        if chaos_hook is not None:
            raise NotImplementedError(
                f"chaos_hook is not ported yet ({_SERVING}: request "
                "lifecycle)")
        self.params = params
        self.cfg, self.acfg, self.scfg = cfg, acfg, scfg
        self.device = params["embed"]["tokens"].device
        b = scfg.num_slots
        self.pool: Optional[KVPool] = None
        kv_bits = acfg.kv_bits if scfg.paged else 0
        if scfg.paged:
            n_pool = scfg.kv_blocks or b * self.caches_tbl_width
            self.pool = KVPool(n_pool, scfg.kv_block_size)
        self.caches = T.init_caches(cfg, b, scfg.max_len, scfg.cache_dtype,
                                    self.device, per_slot=True,
                                    paged=scfg.paged,
                                    kv_block_size=scfg.kv_block_size,
                                    kv_blocks=scfg.kv_blocks or None,
                                    kv_bits=kv_bits)
        self._axes, self._kinds = T.cache_slot_spec(cfg, paged=scfg.paged,
                                                    kv_bits=kv_bits)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Optional[_Slot]] = [None] * b
        self.results: dict[int, np.ndarray] = {}
        self.status: dict[int, str] = {}
        self.submit_time: dict[int, float] = {}
        self.first_token_at: dict[int, float] = {}
        self.finished_at: dict[int, float] = {}
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
        self._admit_seq = 0
        # host mirrors of the per-slot state
        self._pos = np.zeros(b, np.int64)       # cache write cursor
        self._start = np.zeros(b, np.int64)     # left-pad count
        self._last_tok = np.zeros(b, np.int64)
        self._temp = np.ones(b, np.float32)
        self._topk = np.zeros(b, np.int64)
        self._topp = np.ones(b, np.float32)
        self._dev: dict[str, torch.Tensor] = {}
        self._dirty = True

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request (admitted at the next free slot)."""
        if req.ttft_deadline or req.deadline:
            raise NotImplementedError(
                f"request deadlines are not ported yet ({_SERVING}: request "
                "lifecycle)")
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
        self.status[req.uid] = "queued"
        self.submit_time[req.uid] = time.perf_counter()
        self.queue.append(req)

    def step(self) -> None:
        """One engine iteration: admit queue heads into free slots (strict
        FIFO; a paged engine admits the head only when the pool can cover
        its worst case), then run the step the slot mix calls for: a fused
        mixed step while any slot is mid-prefill, else a decode block."""
        t0 = time.perf_counter()
        self._admit_loop()
        decode_rows = [b for b, s in enumerate(self.slots)
                       if s is not None and not s.prefilling]
        prefill_rows = [b for b, s in enumerate(self.slots)
                        if s is not None and s.prefilling]
        if prefill_rows:
            self._mixed_commit(self._mixed_dispatch(decode_rows,
                                                    prefill_rows))
            kind = "mixed" if decode_rows else "prefill"
        elif decode_rows:
            self._decode_commit(self._decode_dispatch(decode_rows))
            kind = "decode"
        else:
            return
        self.phase_time[kind] += time.perf_counter() - t0

    def run(self, requests: Sequence[Request] = ()) -> dict[int, np.ndarray]:
        """Drive until every queued or submitted request completes."""
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return self.results

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
        cannot cover waits, and nothing behind it overtakes it)."""
        free = [b for b in range(self.scfg.num_slots)
                if self.slots[b] is None]
        while free and self.queue:
            plan = self._plan_admission(self.queue[0])
            if plan is None:
                break                          # out of blocks: head waits
            self._admit_request(self.queue.popleft(), free.pop(0), plan)

    def _plan_admission(self, req: Request) -> Optional[dict]:
        """The queue head's padded prompt layout, or None when the pool
        cannot cover its blocks (backpressure)."""
        c = self.scfg.prefill_chunk
        plen = len(req.prompt)
        padded = padded_prompt_len(plen, c)
        npad = padded - plen
        toks = np.zeros(padded, np.int64)
        toks[npad:] = np.asarray(req.prompt, np.int64)
        mask = np.zeros(padded, np.float32)
        mask[npad:] = 1.0
        if self.pool is not None and not self.pool.can_alloc(
                self._blocks_needed(req)):
            return None
        return dict(toks=toks, mask=mask, npad=npad)

    def _admit_request(self, req: Request, b: int, plan: dict) -> None:
        """Bind slot ``b`` to ``req``: allocate its blocks, reset its cache
        rows and plan its chunks. No model math: the chunks stream through
        the following fused steps."""
        row = None
        if self.pool is not None:
            blocks = self.pool.admit(req.uid, [], self._blocks_needed(req))
            row = np.zeros(self.caches_tbl_width, np.int32)
            row[:len(blocks)] = blocks
        self._reset_slot(b, start=plan["npad"], table=row)
        self._pos[b], self._start[b] = 0, plan["npad"]
        self._temp[b], self._topp[b] = req.temperature, req.top_p
        self._topk[b] = req.top_k
        self.slots[b] = _Slot(req, plan["toks"], plan["mask"], plan["npad"],
                              self.scfg.prefill_chunk, self._admit_seq)
        self.status[req.uid] = "prefill"
        self._admit_seq += 1
        self._dirty = True

    def _reset_slot(self, b: int, start: int,
                    table: Optional[np.ndarray]) -> None:
        """Reset slot ``b``'s cache rows on the device: ``start`` marker,
        ``pos`` cursor 0, state rows zeroed, block-table rows set to
        ``table`` (all zeros, the sink, on retirement). Pool leaves are
        untouched: stale blocks are masked, never attended."""
        for name, kind in self._kinds.items():
            ax = self._axes[name]
            if kind == "pool":
                continue
            row = self.caches[name].select(ax, b)
            if kind in ("table", "wtable"):
                row.copy_(torch.as_tensor(table, device=self.device))
            elif kind == "start":
                row.fill_(start)
            else:                                  # pos, state
                row.zero_()

    def _retire_slot(self, b: int, status: str) -> None:
        """Retire slot ``b``: record its output, release its blocks and
        point its block tables at the sink, so that the freed row's
        masked writes cannot land in blocks the next admission gets."""
        slot = self.slots[b]
        uid = slot.req.uid
        self.results[uid] = np.array(slot.out, np.int32)
        self.finished_at[uid] = time.perf_counter()
        self.status[uid] = status
        self.slots[b] = None
        self._dirty = True
        if self.pool is not None:
            self.pool.release(uid)
            self._reset_slot(b, start=0,
                             table=np.zeros(self.caches_tbl_width, np.int32))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _refresh_device_state(self) -> None:
        """Re-upload the per-slot step state from the host mirrors (only
        when the slot set changed since the last step)."""
        active = np.array([s is not None and not s.prefilling
                           for s in self.slots], np.float32)
        self._dev = {"toks": self._tensor(self._last_tok),
                     "off": self._tensor(self._pos - self._start),
                     "active": self._tensor(active),
                     "temp": self._tensor(self._temp),
                     "topk": self._tensor(self._topk),
                     "topp": self._tensor(self._topp)}
        self._dirty = False

    def _sample(self, logits: torch.Tensor, rows: Sequence[int],
                counts: Sequence[int], idx=None) -> torch.Tensor:
        """Sample one token per row of ``logits`` [n, V]. ``rows`` are the
        slots whose samples will be used, at token counts ``counts``;
        ``idx`` maps logits rows to slots (None: row ``b`` is slot ``b``).
        Noise is drawn only for those rows that do not pick greedily."""
        n, v = logits.shape
        slot_of = list(range(n)) if idx is None else list(idx)
        greedy = np.ones(n, bool)
        noisy, seeds, cnts = [], [], []
        for i, b in enumerate(slot_of):
            if b not in rows:
                continue
            req = self.slots[b].req
            cnt = counts[rows.index(b)]
            if cnt >= req.greedy_first and req.temperature > 0.0:
                greedy[i] = False
                noisy.append(i)
                seeds.append(req.seed)
                cnts.append(cnt)
        live = [self.slots[b].req for b in rows]
        sel = torch.as_tensor(slot_of, device=self.device)
        d = self._dev
        uniforms = None
        if noisy:
            uniforms = torch.full((n, v), 0.5, device=self.device)
            uniforms[torch.as_tensor(noisy, device=self.device)] = (
                request_uniforms(seeds, cnts, v, self.device))
        return sample_logits_batched(
            logits, d["temp"][sel], d["topk"][sel], d["topp"][sel],
            self._tensor(greedy), uniforms,
            use_top_k=any(r.top_k > 0 for r in live),
            use_top_p=any(r.top_p < 1.0 for r in live))

    def _decode_forward(self, decode_rows: list[int], i: int) -> None:
        """One decode step over every slot (rows not in decode phase are
        masked), sampling the decode rows at their ``i``-th token of this
        engine step. Updates the device-resident toks / off."""
        d = self._dev
        logits, self.caches = serve_step(
            self.params, self.cfg, self.acfg, d["toks"][:, None],
            self.caches, d["off"][:, None], seq_mask=d["active"][:, None])
        counts = [self.slots[b].count + i for b in decode_rows]
        d["toks"] = self._sample(logits, decode_rows, counts)
        d["off"] = d["off"] + 1

    @torch.no_grad()
    def _decode_dispatch(self, decode_rows: list[int]) -> dict:
        """A decode block over all slots (no admission in flight): the
        largest power-of-two ``k <= decode_block`` that no in-flight budget
        can overshoot, back to back on the device."""
        if self._dirty:
            self._refresh_device_state()
        k = 1
        remaining = min(self.slots[b].req.max_new - self.slots[b].count
                        for b in decode_rows)
        while k * 2 <= min(remaining, self.scfg.decode_block):
            k *= 2
        out = []
        for i in range(k):
            self._decode_forward(decode_rows, i)
            out.append(self._dev["toks"])
        self.decode_steps += k
        self.step_token_log.append((len(decode_rows) * k, 0))
        return dict(dec_toks=torch.stack(out), decode_rows=decode_rows)

    def _decode_commit(self, p: dict) -> None:
        """Read the block's tokens back (the step's one host read) and
        append them to their requests."""
        self._consume_decode_tokens(p["dec_toks"].cpu().numpy(),
                                    p["decode_rows"])

    def _gather_rows(self, idx: torch.Tensor) -> dict:
        """The cache rows of slots ``idx`` as a compact batch (pool leaves
        pass through whole)."""
        return {name: leaf if self._axes[name] < 0
                else leaf.index_select(self._axes[name], idx)
                for name, leaf in self.caches.items()}

    def _scatter_rows(self, sub: dict, idx: torch.Tensor) -> None:
        """Write a compact batch back to its slots (``idx`` rows are
        distinct; pool leaves were updated in place)."""
        for name, leaf in sub.items():
            ax = self._axes[name]
            if ax >= 0:
                self.caches[name].index_copy_(ax, idx, leaf)

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
        k = 1 if n_dec else 0
        dec = None
        if k:
            self._decode_forward(decode_rows, 0)
            dec = self._dev["toks"]
        idx = self._tensor(np.asarray(pf_idx, np.int64))
        sub = self._gather_rows(idx)
        logits, _, sub = model_apply(
            self.params, self.cfg, self.acfg, AnalogCtx(),
            {"tokens": self._tensor(pf_toks)}, caches=sub,
            pos_offset=self._tensor(pf_off)[:, None],
            seq_mask=self._tensor(pf_mask), last_only=True)
        self._scatter_rows(sub, idx)
        done = [b for b in pf_rows
                if self.slots[b].chunk + 1 == self.slots[b].nchunks]
        first = self._sample(logits[:, -1], done, [0] * len(done),
                             idx=pf_idx)
        if k:
            self.mixed_steps += 1          # steps that fused both phases
        self.prefill_forwards += 1
        self.prefill_chunks += len(pf_rows)
        self.step_token_log.append((n_dec * k, len(pf_rows) * c))
        return dict(dec=dec, first=first, pf_rows=pf_rows,
                    decode_rows=decode_rows, k=k, n_dec=n_dec)

    def _mixed_commit(self, p: dict) -> None:
        """Host bookkeeping of the fused step: chunk cursors, phase flips
        with the sampled first token, decode-token appends. One host read
        for the step's tokens."""
        c = self.scfg.prefill_chunk
        pf_rows, k = p["pf_rows"], p["k"]
        both = (torch.cat([p["first"], p["dec"]]) if k else p["first"])
        host = both.cpu().numpy()
        first, dec = host[:len(p["first"])], host[len(p["first"]):]
        for i, b in enumerate(pf_rows):
            s = self.slots[b]
            s.chunk += 1
            self._pos[b] += c                  # the chunk advanced the row
            if not s.prefilling:               # prompt done: first token
                self._dirty = True             # row flips to decode phase
                self._append_token(b, int(first[i]))
        if k:
            self.decode_steps += k
            self.decode_tokens_during_admission += p["n_dec"] * k
            self._consume_decode_tokens(dec[None], p["decode_rows"])

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
        if tok in slot.req.stop_tokens or slot.count >= slot.req.max_new:
            self._retire_slot(b, "finished")
