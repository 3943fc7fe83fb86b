"""The port's pure-Python KV pool (``repro_torch.serve.kv_pool``) against
the reference's own pool tests.

Every test of ``tests/test_kv_pool.py`` that does not use the state
snapshot pool (which serves only the ssm and hybrid families and is not
ported), run unchanged on both classes: the reference's ``KVPool`` and the
port's copy. Refcount and block conservation under randomized churn, LRU
retention and eviction order, the radix chain index, frozen partial tails,
and the unknown/double-release error contract.
"""

import types

import numpy as np
import pytest

from repro.serve import kv_pool as ref_pool
from repro_torch.serve import kv_pool as port_pool


@pytest.fixture(params=["reference", "port"])
def kv(request):
    """The module under test: ``KVPool``, ``SINK_BLOCK`` and
    ``OutOfBlocksError`` of the reference or of the port."""
    mod = ref_pool if request.param == "reference" else port_pool
    return types.SimpleNamespace(KVPool=mod.KVPool,
                                 SINK_BLOCK=mod.SINK_BLOCK,
                                 OutOfBlocksError=mod.OutOfBlocksError)


def test_port_pool_is_its_own_code():
    assert port_pool.KVPool is not ref_pool.KVPool
    assert port_pool.SINK_BLOCK == ref_pool.SINK_BLOCK == 0
    assert not hasattr(port_pool, "StateSnapshotPool")


def _toks(rng, n, vocab=64):
    return rng.integers(0, vocab, n).astype(np.int32)


def test_release_unknown_and_double_raises_valueerror(kv):
    """Unknown and double release must raise a clear ValueError naming
    the uid — refcounting makes double-release likely enough that a bare
    KeyError is not an acceptable failure mode."""
    pool = kv.KVPool(num_blocks=4, block_size=4)
    with pytest.raises(ValueError, match="uid=7"):
        pool.release(7)
    pool.alloc(3, 2)
    pool.release(3)
    with pytest.raises(ValueError, match="uid=3"):
        pool.release(3)
    assert pool.num_free == 4                  # state intact after errors


def test_refcounts_shared_blocks_survive_one_release(kv):
    """A block held by two owners must survive the first release and
    only become cached/free after the second."""
    pool = kv.KVPool(num_blocks=6, block_size=2)
    toks = np.arange(4, dtype=np.int32)
    keys = pool.prefix_keys(toks, 0)
    a = pool.alloc(1, 3)
    pool.register(keys, a[:2])
    hit, tail = pool.match_prefix(toks, 0)
    assert hit == a[:2] and tail is None
    new = pool.admit(2, hit, 1)
    assert set(new).isdisjoint(a)
    assert pool._ref[a[0]] == 2
    pool.release(1)
    assert pool._ref[a[0]] == 1                # still live via uid 2
    assert pool.match_prefix(toks, 0)[0] == a[:2]
    pool.release(2)
    assert pool.num_live == 0
    assert pool.num_cached == 2                # indexed blocks retained
    assert pool.num_free + pool.num_cached == 6


def test_match_respects_salt_and_npad(kv):
    """The chain root carries (salt, npad): entries must never match
    across salts or across different left-pad geometries."""
    toks = np.arange(8, dtype=np.int32)
    pool = kv.KVPool(num_blocks=4, block_size=4, salt=1)
    blocks = pool.alloc(0, 2)
    pool.register(pool.prefix_keys(toks, 2), blocks)
    assert pool.match_prefix(toks, 2)[0] == blocks
    assert pool.match_prefix(toks, 3)[0] == []        # npad differs
    other = kv.KVPool(num_blocks=4, block_size=4, salt=2)
    other.alloc(0, 2)
    assert other.match_prefix(toks, 2)[0] == []       # salt differs


def test_tail_register_and_match(kv):
    """A frozen partial tail matches only an exact token continuation of
    its chain and reports (block, fill) for the scheduler's COW copy."""
    pool = kv.KVPool(num_blocks=6, block_size=4)
    toks = np.arange(10, dtype=np.int32)        # 2 full blocks + fill 2
    keys = pool.prefix_keys(toks, 0)
    blocks = pool.alloc(0, 3)
    pool.register(keys, blocks[:2])
    pool.register_tail(keys[1], blocks[2], 2, toks[8:])
    hit, tail = pool.match_prefix(toks, 0)
    assert hit == blocks[:2] and tail == (blocks[2], 2)
    wrong = toks.copy()
    wrong[9] += 1                               # tail content differs
    assert pool.match_prefix(wrong, 0)[1] is None
    short = toks[:9]                            # shorter than the fill
    assert pool.match_prefix(short, 0)[1] is None


def test_lru_eviction_order_and_liveness(kv):
    """Eviction under allocation pressure must free cached blocks in LRU
    order, refresh recently matched entries, and never touch live or
    protected blocks."""
    pool = kv.KVPool(num_blocks=6, block_size=2)
    rows = {}
    for uid in range(3):                        # three 1-block prompts
        toks = np.asarray([uid * 10, uid * 10 + 1], np.int32)
        rows[uid] = (toks, pool.alloc(uid, 2))
        pool.register(pool.prefix_keys(toks, 0), rows[uid][1][:1])
    for uid in range(3):
        pool.release(uid)
    assert pool.num_cached == 3 and pool.num_free == 3
    cached = [rows[uid][1][0] for uid in range(3)]     # release order
    pool.match_prefix(rows[0][0], 0)           # refresh uid 0 to MRU
    pool.alloc(9, 4)                           # forces one eviction
    assert pool.evictions == 1
    assert cached[1] not in pool._lru          # oldest unrefreshed went
    assert cached[0] in pool._lru and cached[2] in pool._lru
    assert pool.match_prefix(rows[1][0], 0)[0] == []   # entry dropped
    # protected blocks are skipped even under pressure
    assert pool.can_alloc(2) and not pool.can_alloc(
        2, protect=frozenset(pool._lru))


def test_can_alloc_counts_cached_blocks(kv):
    """Backpressure must see evictable cached blocks as capacity."""
    pool = kv.KVPool(num_blocks=4, block_size=2)
    toks = np.arange(8, dtype=np.int32)
    blocks = pool.alloc(0, 4)
    pool.register(pool.prefix_keys(toks, 0), blocks)
    assert not pool.can_alloc(1)
    pool.release(0)
    assert pool.num_free == 0 and pool.num_cached == 4
    assert pool.can_alloc(4)
    got = pool.alloc(1, 3)                     # serviced by eviction
    assert len(got) == 3 and pool.evictions == 3
    assert kv.SINK_BLOCK not in got


def test_admit_never_counts_hit_blocks_as_evictable(kv):
    """A pool whose only evictable blocks are the prefix-hit blocks must
    refuse admission up front (no partial mutation), not acquire the
    hits and then fail eviction halfway through."""
    pool = kv.KVPool(num_blocks=4, block_size=2)
    toks = np.arange(6, dtype=np.int32)
    blocks = pool.alloc(0, 4)
    pool.register(pool.prefix_keys(toks, 0), blocks[:3])
    pool.release(0)                            # 3 cached + 1 free
    hit, _ = pool.match_prefix(toks, 0)
    assert hit == blocks[:3]
    with pytest.raises(kv.OutOfBlocksError):
        pool.admit(1, hit, 2)                  # 1 free, hits untouchable
    assert pool.num_live == 0                  # nothing leaked
    assert pool.num_cached == 3 and pool.num_free == 1
    assert pool.admit(2, hit, 1)               # exactly-fitting succeeds
    assert pool.num_live == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_churn_conservation(kv, seed):
    """Hypothesis-style randomized admit/share/release/evict churn.

    Invariants checked after every operation:

    * block conservation — free + cached + live == pool size;
    * refcount conservation — sum of per-block refcounts equals the sum
      of owner holdings;
    * no live block is ever evicted or on the free list / LRU;
    * the LRU mirrors a shadow model (same membership, same order), so
      eviction order is provably least-recently-used.
    """
    rng = np.random.default_rng(seed)
    total = 24
    pool = kv.KVPool(num_blocks=total, block_size=4)
    shadow_lru: list[int] = []                  # expected LRU, oldest first
    live: dict[int, list[int]] = {}             # uid -> blocks
    prompts: dict[int, np.ndarray] = {}
    next_uid = 0

    def check():
        assert pool.num_free + pool.num_cached + pool.num_live == total
        assert sum(pool._ref.values()) == sum(
            len(v) for v in pool._owned.values())
        assert not (set(pool._ref) & set(pool._lru))
        assert not (set(pool._ref) & set(pool._free))
        assert not (set(pool._lru) & set(pool._free))
        assert list(pool._lru) == shadow_lru

    for _ in range(300):
        op = rng.random()
        if op < 0.55 and len(live) < 5:          # admit (maybe shared)
            reuse = live and rng.random() < 0.5
            toks = (prompts[rng.choice(list(live))] if reuse
                    else _toks(rng, int(rng.integers(4, 17))))
            npad = 0
            hit, tail = pool.match_prefix(toks, npad)
            for b in hit:                        # shadow the LRU refresh
                if b in shadow_lru:
                    shadow_lru.remove(b)
                    shadow_lru.append(b)
            need = pool.blocks_for(len(toks), 4) - len(hit)
            if not pool.can_alloc(need, protect=frozenset(hit)):
                check()
                continue
            evict = max(0, need - pool.num_free)
            for b in hit:                        # resurrect from cache
                if b in shadow_lru:
                    shadow_lru.remove(b)
            del shadow_lru[:evict]               # oldest evicted first
            uid = next_uid
            next_uid += 1
            fresh = pool.admit(uid, hit, need)
            live[uid] = list(hit) + fresh
            prompts[uid] = toks
            keys = pool.prefix_keys(toks, npad)
            nfull = len(toks) // pool.block_size
            pool.register(keys[len(hit):nfull],
                          live[uid][len(hit):nfull])
        elif live:                               # release a random owner
            uid = int(rng.choice(list(live)))
            retained = [b for b in live.pop(uid)
                        if pool._ref[b] == 1 and pool._block_keys.get(b)]
            pool.release(uid)
            shadow_lru.extend(retained)
        check()

    for uid in list(live):
        retained = [b for b in live.pop(uid)
                    if pool._ref[b] == 1 and pool._block_keys.get(b)]
        pool.release(uid)
        shadow_lru.extend(retained)
        check()
    assert pool.num_live == 0
    assert pool.num_free + pool.num_cached == total


def test_tail_reregister_upgrades_larger_fill(kv):
    """Re-registering a tail for the same chain point must upgrade the
    entry only when the new fill is strictly larger — and the displaced
    donor block, if keyless and cached, must return to the free list."""
    pool = kv.KVPool(num_blocks=8, block_size=4)
    toks = np.arange(11, dtype=np.int32)        # 2 full blocks + fill 3
    keys = pool.prefix_keys(toks, 0)
    blocks = pool.alloc(0, 4)
    pool.register(keys, blocks[:2])
    pool.register_tail(keys[1], blocks[2], 2, toks[8:10])
    # same fill: first writer stays
    pool.register_tail(keys[1], blocks[3], 2, toks[8:10])
    assert pool.match_prefix(toks, 0)[1] == (blocks[2], 2)
    # smaller fill: never downgrade
    pool.register_tail(keys[1], blocks[3], 1, toks[8:9])
    assert pool.match_prefix(toks, 0)[1] == (blocks[2], 2)
    # strictly larger fill wins
    pool.register_tail(keys[1], blocks[3], 3, toks[8:11])
    assert pool.match_prefix(toks, 0)[1] == (blocks[3], 3)
    # a cached donor that lost its only key must not leak: release the
    # owner, then re-upgrade away from the now-cached tail block
    pool.release(0)
    # the displaced first tail (blocks[2]) lost its only key at the
    # upgrade, so release frees it instead of caching it
    assert pool.num_cached == 3                  # 2 full + winning tail
    assert blocks[2] not in pool._lru
    donor = blocks[3]
    fresh = pool.alloc(1, 1)[0]
    pool.register_tail(keys[1], fresh, 4, toks[8:11])  # fill 4 > 3
    assert donor not in pool._lru                # detached from the LRU...
    assert pool.num_free + pool.num_cached + pool.num_live == 8
    pool.release(1)
    hit, tail = pool.match_prefix(toks, 0)
    assert tail is None                          # fill-4 tail needs 12 toks
    assert hit == blocks[:2]


def test_zero_fill_tail_is_ignored(kv):
    """register_tail(fill=0) must be a no-op: an empty tail can never
    extend a hit and must not occupy an index entry."""
    pool = kv.KVPool(num_blocks=4, block_size=4)
    toks = np.arange(4, dtype=np.int32)
    keys = pool.prefix_keys(toks, 0)
    blocks = pool.alloc(0, 2)
    pool.register(keys, blocks[:1])
    pool.register_tail(keys[0], blocks[1], 0, toks[:0])
    assert pool.match_prefix(toks, 0) == (blocks[:1], None)
    assert not pool._tails
