"""Refcounted block allocator + radix prefix index for the paged KV cache.

A pure-Python copy of the JAX package's ``serve/kv_pool.py`` (the port
imports nothing of that package), its state-snapshot pool included.

The paged slot cache (``models.layers.init_cache(paged=True)``) stores KV
state in a pool of fixed-size physical blocks shared by every slot:

* **admission** — ``admit(uid, hit_blocks, n_new)`` increfs the blocks a
  prefix match found and pops ``n_new`` fresh blocks for the request's
  private tail and decode budget; worst-case sizing up front keeps every
  device-side structure static.
* **retirement** — ``release`` decrefs; a block becomes reusable when its
  last owner lets go. Zero-ref blocks that carry prefix-index entries move
  to an LRU of released-but-indexed blocks and are evicted only under
  allocation pressure.
* **the radix/hash index** — full blocks are content-addressed by a hash
  chain ``key_k = (key_{k-1}, block-k token ids)`` rooted at ``(salt,
  left-pad count)``; ``match_prefix`` returns the longest indexed prefix.
  Partial tails are indexed frozen at their fill count and matched only
  by copy-on-write.
* **backpressure** — ``can_alloc`` counts free plus evictable cached
  blocks; admission stalls the strict-FIFO queue head when live blocks
  exhaust the pool.
* **the cancel-vs-rewind ordering contract** — a speculative step may
  still rewind a row's cursor and rewrite its private tail until it is
  committed, so ``begin_window`` / ``end_window`` bracket it and
  ``release`` refuses any uid inside the open window: commit first, then
  cancel.

Physical block 0 is reserved as the **write sink**: rows that are retired,
masked or write-protected keep executing static-shape scatter-writes, which
must land somewhere harmless (``models.layers._paged_slot_attention``).

The refcount, LRU and eviction machinery is shared with
:class:`StateSnapshotPool`, the content-addressed index of the SSM
recurrence and conv-tail snapshots that gives the ssm and hybrid families
their prefix cache (``serve.scheduler``): a KV block holds the tokens of
one block, a snapshot the recurrent summary of the whole prefix up to a
block boundary, indexed under the same chain key. The rewind floor and window
(:meth:`KVPool.rewind_floor`, :meth:`KVPool.check_rewind`,
``begin_window`` / ``end_window``) are the contract the engine's
speculative windows commit under (``serve.scheduler``).

Pure host-side Python; the device only sees the block-table rows this
hands out. Under tensor parallelism (``distributed.sharding``) each shard
holds ``KV / tp`` heads of every physical block, so one allocator, one
index and one block table serve every shard unchanged.
"""

from __future__ import annotations

import collections
from typing import Iterable, Optional, Sequence

#: Physical index of the reserved write-sink block (see module docstring).
SINK_BLOCK = 0

#: Chain-key sentinel kinds for the reverse block->keys map.
_FULL, _TAIL = "full", "tail"


class OutOfBlocksError(RuntimeError):
    """Raised when ``admit``/``alloc`` need more blocks than exist free
    or evictable."""


class RewindError(RuntimeError):
    """Raised by :meth:`KVPool.check_rewind` when a speculative rollback
    would land a ``pos`` cursor below the request's rewind floor —
    inside a refcount-shared block or the frozen span of a registered
    block, whose contents other requests may read."""


class _RefcountedPool:
    """Refcount + LRU-of-cached machinery for content-addressed device
    slots (KV blocks, state snapshots).

    Every usable slot is in exactly one of three states:

    * **free** — on the free list, carries no index entries;
    * **live** — refcount >= 1 (held by one or more request uids);
    * **cached** — refcount 0 but still content-indexed, parked in the
      LRU of released-but-cached slots awaiting reuse or eviction.

    ``free + live + cached == num_blocks`` always (the conservation
    invariant the churn tests assert for both subclasses).
    """

    def __init__(self, num_blocks: int, block_size: int, salt: int = 0,
                 reserve_sink: bool = False):
        """All blocks start free; ``salt`` roots every hash chain.
        ``reserve_sink`` shifts ids to 1-based so physical slot 0 stays a
        write sink (the KV pool); snapshot slots are plain 0-based."""
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.salt = salt
        lo = 1 if reserve_sink else 0
        self._free: collections.deque[int] = collections.deque(
            range(lo, lo + num_blocks))
        self._ref: dict[int, int] = {}            # block -> refcount (>=1)
        self._owned: dict[int, list[int]] = {}    # owner uid -> blocks
        self._index: dict = {}                    # chain key -> full block
        self._tails: dict = {}     # chain key -> (block, fill, tail tokens)
        self._block_keys: dict[int, list] = {}    # block -> [(kind, key)]
        # LRU of cached blocks: oldest first, refreshed on match/reuse
        self._lru: collections.OrderedDict[int, None] = (
            collections.OrderedDict())
        self.evictions = 0
        # uids with an in-flight speculative rewind window (see the
        # cancel-vs-rewind ordering contract in the module docstring)
        self._window: frozenset[int] = frozenset()

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Blocks on the free list (no content, no owners)."""
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Released-but-indexed blocks retained for prefix reuse."""
        return len(self._lru)

    @property
    def num_live(self) -> int:
        """Blocks currently referenced by in-flight requests."""
        return len(self._ref)

    def can_alloc(self, n: int, protect: frozenset = frozenset()) -> bool:
        """True when ``n`` blocks can be produced right now — free blocks
        plus cached blocks evictable under pressure (minus ``protect``,
        blocks a pending copy-on-write still needs readable)."""
        evictable = sum(1 for b in self._lru if b not in protect)
        return n <= len(self._free) + evictable

    # ------------------------------------------------------------------
    # ownership
    # ------------------------------------------------------------------

    def owns(self, uid: int) -> bool:
        """True while request ``uid`` holds at least one slot (lets the
        engine's retirement release best-effort snapshot acquisitions)."""
        return uid in self._owned

    def begin_window(self, uids: Iterable[int]) -> None:
        """Open an in-flight speculative rewind window over ``uids``.

        Between this call and :meth:`end_window`, the device step
        dispatched for these requests may still rewind their cursors and
        overwrite their private tails, so ``release`` refuses to recycle
        their blocks (see the cancel-vs-rewind ordering contract in the
        module docstring). Nesting is a bug: exactly one window may be
        open at a time."""
        if self._window:
            raise ValueError(
                f"rewind window already open for uids={sorted(self._window)}")
        self._window = frozenset(uids)

    def end_window(self) -> None:
        """Close the in-flight rewind window (idempotent): the committed
        step has been consumed, cursors are final, releases are legal
        again."""
        self._window = frozenset()

    def in_window(self, uid: int) -> bool:
        """True while ``uid`` is covered by the open rewind window."""
        return uid in self._window

    def release(self, uid: int) -> None:
        """Drop request ``uid``'s references. Blocks whose refcount hits
        zero go to the LRU cache when content-indexed, to the free list
        otherwise. Unknown/double release is a clear error — refcounting
        makes that failure mode likely enough to deserve naming — and so
        is releasing a uid with an in-flight speculative rewind window
        (the cancel-vs-rewind ordering contract: commit the pending step
        first, then cancel)."""
        if uid in self._window:
            raise ValueError(
                f"release of request uid={uid} with an in-flight "
                f"speculative rewind window — the dispatched step may "
                f"still rewind into its blocks; commit the pending step "
                f"(ServeEngine.step_commit) before releasing")
        blocks = self._owned.pop(uid, None)
        if blocks is None:
            raise ValueError(
                f"release of unknown or already-released request "
                f"uid={uid} (known owners: {sorted(self._owned)})")
        for b in blocks:
            r = self._ref[b] - 1
            if r:
                self._ref[b] = r
            else:
                del self._ref[b]
                if self._block_keys.get(b):
                    self._lru[b] = None            # retained, MRU end
                else:
                    self._free.append(b)

    def _evict_one(self, protect: frozenset) -> None:
        """Evict the least-recently-used unprotected cached block: drop
        its index entries and free it. Only zero-ref blocks live in the
        LRU, so a live block can never be evicted."""
        for b in self._lru:
            if b not in protect:
                del self._lru[b]
                self._drop_keys(b)
                self._free.append(b)
                self.evictions += 1
                return
        raise OutOfBlocksError("every cached block is copy-protected")

    def _drop_keys(self, b: int) -> None:
        """Remove every index entry that resolves to block ``b``."""
        for kind, key in self._block_keys.pop(b, ()):
            d = self._index if kind == _FULL else self._tails
            hit = d.get(key)
            if hit is not None and (hit if kind == _FULL else hit[0]) == b:
                del d[key]

    # ------------------------------------------------------------------
    # the radix/hash prefix index
    # ------------------------------------------------------------------

    def prefix_keys(self, tokens: Sequence[int], npad: int) -> list:
        """Hash-chain keys for every *full* block of a padded prompt.

        ``key_k`` nests ``key_{k-1}``, so equality of ``key_k`` implies
        equality of the whole prefix through block ``k`` — the radix
        property. The root carries ``(salt, npad)``: the left-pad count
        shifts every RoPE position, so prompts padded differently must
        never share blocks even when the padded token arrays collide.
        """
        parent = (self.salt, npad)
        keys = []
        bs = self.block_size
        for k in range(len(tokens) // bs):
            parent = (parent, tuple(int(t) for t in tokens[k * bs:
                                                           (k + 1) * bs]))
            keys.append(parent)
        return keys


class KVPool(_RefcountedPool):
    """Refcounted allocator + prefix index over ``num_blocks`` usable
    physical KV blocks (device pool additionally carries the reserved
    sink block 0). See the module docstring for the ownership model."""

    def __init__(self, num_blocks: int, block_size: int, salt: int = 0):
        """All blocks start free; block ids are 1-based (0 = sink)."""
        super().__init__(num_blocks, block_size, salt, reserve_sink=True)

    def blocks_for(self, padded_prompt: int, max_new: int) -> int:
        """Blocks a request's table row spans (worst-case fill)."""
        return -(-(padded_prompt + max_new) // self.block_size)

    def admit(self, uid: int, hit_blocks: Sequence[int], n_new: int,
              protect: frozenset = frozenset()) -> list[int]:
        """Bind request ``uid``: incref the prefix-hit blocks and pop
        ``n_new`` fresh blocks (evicting LRU cached blocks as needed,
        never touching ``protect``). Returns the fresh blocks; the
        caller's table row is ``list(hit_blocks) + returned``."""
        if uid in self._owned:
            raise ValueError(f"request {uid} already holds blocks")
        # capacity guard before any mutation: cached hit blocks are about
        # to be acquired, so they must not be counted as evictable
        guard = frozenset(protect) | frozenset(hit_blocks)
        if not self.can_alloc(n_new, guard):
            raise OutOfBlocksError(
                f"request {uid}: needs {n_new} new blocks, "
                f"{len(self._free)} free + {len(self._lru)} cached")
        held = []
        for b in hit_blocks:
            if b in self._ref:
                self._ref[b] += 1
            else:                       # resurrect from the released cache
                del self._lru[b]
                self._ref[b] = 1
            held.append(b)
        new = []
        for _ in range(n_new):
            if not self._free:
                self._evict_one(protect)
            b = self._free.pop()
            self._ref[b] = 1
            new.append(b)
        self._owned[uid] = held + new
        return new

    def alloc(self, uid: int, n: int) -> list[int]:
        """Pop ``n`` blocks for request ``uid`` (no prefix hit): a thin
        wrapper over :meth:`admit`."""
        return self.admit(uid, [], n)

    def register(self, keys: Iterable, blocks: Iterable[int]) -> None:
        """Index full blocks under their chain keys (first writer wins —
        a concurrent duplicate keeps its private, unindexed copy)."""
        for key, b in zip(keys, blocks):
            if key in self._index:
                continue
            self._index[key] = b
            self._block_keys.setdefault(b, []).append((_FULL, key))

    def register_tail(self, parent_key, block: int, fill: int,
                      tail_tokens: Sequence[int]) -> None:
        """Index a partial tail block, frozen at ``fill`` tokens.

        Entries below ``fill`` stay valid forever because writes are
        append-only; the donor may keep decoding into offsets >= fill.
        Matchers must copy-on-write (the scheduler device-copies the
        block before appending) — the tail is never shared in place.

        A later registration with a *strictly larger* fill for the same
        parent key upgrades the entry (same append-only validity
        argument: the longer tail serves every continuation the shorter
        one served, plus more). Equal or smaller fills are dropped, so a
        warm entry never downgrades.
        """
        if fill <= 0:
            return
        old = self._tails.get(parent_key)
        if old is not None:
            if fill <= old[1]:
                return
            # upgrade: detach the old donor block from this key; a block
            # left keyless in the LRU has nothing to offer matchers and
            # goes straight back to the free list
            ob = old[0]
            keys = self._block_keys.get(ob, [])
            keys[:] = [e for e in keys if e != (_TAIL, parent_key)]
            if not keys:
                self._block_keys.pop(ob, None)
                if ob in self._lru:
                    del self._lru[ob]
                    self._free.append(ob)
        self._tails[parent_key] = (
            block, fill, tuple(int(t) for t in tail_tokens))
        self._block_keys.setdefault(block, []).append((_TAIL, parent_key))

    def rewind_floor(self, uid: int) -> int:
        """Lowest logical position request ``uid``'s ``pos`` cursor may
        legally rewind to — the **rewind-safety contract** speculative
        rollback operates under.

        A rollback is a pure cursor rewind: positions past ``pos`` become
        stale garbage that later windows overwrite in place. That is only
        sound where the request's writes actually land in its own private
        blocks. Walking the table row (``_owned`` preserves table order),
        block ``i`` covering logical positions ``[i*bs, (i+1)*bs)``
        contributes a floor of:

        * ``(i+1)*bs`` when the block is refcount-shared (another live
          request reads it) or content-indexed as a full block (a future
          matcher may) — its whole span is immutable;
        * ``i*bs + fill`` when it is index-frozen as a partial tail —
          entries below the fill are published, the rest is the owner's
          private append region;
        * ``0`` when private and unindexed.

        In normal operation the floor never exceeds the padded prompt
        length (decode — hence any verify window — starts past it), so
        speculative rollback is always safe *by construction*; this
        method plus :meth:`check_rewind` turn that argument into a
        checkable invariant.
        """
        blocks = self._owned.get(uid)
        if blocks is None:
            raise ValueError(f"rewind_floor of unknown request uid={uid}")
        bs = self.block_size
        floor = 0
        for i, b in enumerate(blocks):
            if self._ref.get(b, 0) > 1:
                floor = max(floor, (i + 1) * bs)
                continue
            for kind, key in self._block_keys.get(b, ()):
                if kind == _FULL:
                    floor = max(floor, (i + 1) * bs)
                else:
                    t = self._tails.get(key)
                    if t is not None and t[0] == b:
                        floor = max(floor, i * bs + t[1])
        return floor

    def check_rewind(self, uid: int, pos: int) -> None:
        """Assert rewinding request ``uid``'s cursor to logical ``pos``
        respects :meth:`rewind_floor`; raises :class:`RewindError`
        otherwise. The scheduler calls this after every speculative step
        with the post-rollback cursor."""
        floor = self.rewind_floor(uid)
        if pos < floor:
            raise RewindError(
                f"request {uid}: rewind to pos={pos} would enter "
                f"shared/frozen content (floor={floor})")

    def match_prefix(self, tokens: Sequence[int], npad: int, keys=None,
                     ) -> tuple[list[int], Optional[tuple[int, int]]]:
        """Longest indexed prefix of a padded prompt.

        Returns ``(hit_blocks, tail)``: the physical blocks of every
        matched full block (chain walk from the root, stopping at the
        first miss), and — when the chain head also has a frozen partial
        tail whose tokens match the prompt's next ``fill`` tokens —
        ``(tail_block, fill)`` for the scheduler's COW copy. Matched
        cached blocks are refreshed to the MRU end of the LRU. Pass
        ``keys`` (a ``prefix_keys`` result) to skip re-hashing the
        prompt on the admission hot path.
        """
        bs = self.block_size
        parent = (self.salt, npad)
        hit: list[int] = []
        for key in (keys if keys is not None
                    else self.prefix_keys(tokens, npad)):
            b = self._index.get(key)
            if b is None:
                break
            hit.append(b)
            parent = key
        tail = None
        t = self._tails.get(parent)
        if t is not None:
            tb, fill, ttoks = t
            lo = len(hit) * bs
            seg = tuple(int(x) for x in tokens[lo:lo + fill])
            if len(seg) == fill and seg == ttoks:
                tail = (tb, fill)
        for b in hit + ([tail[0]] if tail else []):
            if b in self._lru:
                self._lru.move_to_end(b)
        return hit, tail


class StateSnapshotPool(_RefcountedPool):
    """Content-addressed pool of SSM recurrence / conv-tail snapshots.

    The device side is the ``*_snap`` leaves ``init_mamba_cache`` adds to
    every mamba cache: ``conv_snap [NS, W-1, C]`` / ``ssm_snap [NS, H, N,
    P]`` (NS = ``num_blocks`` here). This class hands out the NS-axis slot
    ids and indexes them under the same chain keys as the KV pool
    (``prefix_keys``), so a key hit means "the snapshot is the exact
    recurrent state after that whole padded prefix".

    Its lifecycle is the KV pool's, with two differences:

    * **acquire is best-effort**: a prefill that cannot get a snapshot
      slot (all live) skips capturing that boundary; the request still
      serves correctly, the boundary stays cold.
    * **no sharing while live**: a snapshot is written once by its
      capturing request (refcount 1), then registered and released at the
      prefill-to-decode flip, after which it is immutable cached content.
      A restore copies the snapshot into the slot's state rows, so
      matchers never hold references.

    Slot ids are 0-based (no write sink: a snapshot is only ever written
    by the copy that captures it).
    """

    def acquire(self, uid: int) -> Optional[int]:
        """Pop one snapshot slot for request ``uid`` (evicting the LRU
        cached snapshot if none is free). ``None`` when every slot is
        live: capture is best-effort, never a failure."""
        if not self._free:
            if not self._lru:
                return None
            self._evict_one(frozenset())
        s = self._free.pop()
        self._ref[s] = 1
        self._owned.setdefault(uid, []).append(s)
        return s

    def register(self, key, slot: int) -> None:
        """Index snapshot ``slot`` under chain ``key`` (first writer wins:
        a concurrent duplicate's slot goes back to the free list at its
        owner's release, like an unindexed KV block)."""
        if key in self._index:
            return
        self._index[key] = slot
        self._block_keys.setdefault(slot, []).append((_FULL, key))

    def has(self, key) -> bool:
        """True when ``key`` already resolves to a cached or live snapshot
        (a prefill skips capturing an indexed boundary)."""
        return key in self._index

    def match_deepest(self, keys: Sequence) -> Optional[tuple[int, int]]:
        """Deepest indexed snapshot along a prompt's key chain.

        Walks ``keys`` from the deepest boundary backwards and returns
        ``(depth, slot)``, the depth in blocks (the snapshot summarizes
        the first ``depth * block_size`` padded tokens), or ``None`` when
        no boundary is indexed. Gaps are fine: a snapshot at depth ``m``
        summarizes the whole prefix. The hit moves to the LRU's MRU end.
        """
        for i in range(len(keys) - 1, -1, -1):
            s = self._index.get(keys[i])
            if s is not None:
                if s in self._lru:
                    self._lru.move_to_end(s)
                return i + 1, s
        return None
