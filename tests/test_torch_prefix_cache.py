"""The port's radix prefix cache (``repro_torch.serve.scheduler``) on the
dense and moe families, against the JAX package's engine.

Weights (and the hw noise instance of ``analog_hw``) are built by the
reference and carried across as numpy. The counterparts of the prefix-cache
cases of ``tests/test_scheduler.py``, run on the port's engine and held
against the reference's engine on the same requests:

* warm ≡ cold bitwise: a cold engine (``prefix_cache=False``), then one
  engine with the cache that serves the workload twice (prime, warm); all
  three give the reference's greedy tokens, the warm pass hits on every
  request, and the prefix counters equal the reference engine's (the pool
  logic is deterministic host code); no block that stays indexed under its
  key changes, and every cache leaf but the decode step's cursors keeps its
  storage (the cache writes in place);
* sharing across live requests (refcount > 1), the copy-on-write partial
  tail (``prefix_skipped_tokens == 24``), eviction under pressure, the int8
  pool, the gating reasons, ``cache_salt``;
* the CLI's ``--no-prefix-cache`` / ``--cache-salt`` and its report line.

``tests/test_torch_prefix_state.py`` holds the ssm and hybrid families.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import analog as RA
from repro.models import build as ref_build
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

FAMILIES = {"dense": "llama-3.2-1b", "moe": "qwen3-moe-30b-a3b"}
#: the pool holds the slots' worst case and every prompt block of the
#: workload (16 + 24), so the warm pass finds the whole workload cached
#: (the default 16 would evict, and a cyclic warm pass would miss on all)
GEO = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True,
           kv_block_size=4, kv_blocks=40)
#: the counters both engines keep, compared after every run
COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "prefix_skipped_tokens", "prefix_cow_copies", "decode_steps",
            "prefill_chunks")


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def carry(arch: str, seed: int = 0):
    """(cfg, reference params / labels / hw instance, port params /
    instance); moe at the reference tests' no-drop capacity."""
    cfg = get_config(arch).reduce()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(seed))
    inst = RA.sample_noise_instances(params, labels,
                                     jax.random.PRNGKey(seed + 1), "hw")
    return (cfg, params, labels, inst,
            params_from_numpy(_ref_flat(params), "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


_CARRIED: dict = {}


def carried_for(family: str):
    """:func:`carry` of a family's model, built once per test process."""
    if family not in _CARRIED:
        _CARRIED[family] = carry(FAMILIES[family])
    return _CARRIED[family]


@pytest.fixture
def dense():
    return carried_for("dense")


def deploy(carried, name: str, kv_bits: int = 0):
    """(reference params, acfg, port params, acfg) of ``off`` or
    ``analog_hw``."""
    cfg, params, labels, inst, pp, pinst = carried
    if name == "off":
        out = (params, RA.AnalogConfig(mode="off"), pp,
               PA.AnalogConfig(mode="off"))
    else:
        out = (RA.apply_noise_instances(params, labels, inst, "hw"),
               RA.AnalogConfig(mode="analog", train_noise=False),
               PA.apply_noise_instances(pp, T.model_labels(pp, cfg), pinst,
                                        "hw"),
               PA.AnalogConfig(mode="analog", train_noise=False))
    rp, racfg, tp, tacfg = out
    return (rp, dataclasses.replace(racfg, kv_bits=kv_bits), tp,
            dataclasses.replace(tacfg, kv_bits=kv_bits))


def prompt(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def workload(cfg) -> list[dict]:
    """The reference's warm/cold requests (prompts of 9 and 10 tokens from
    3 seeds), then two that share a 16-token prefix and differ in their
    last 8 (the second may hit the first's blocks while it is live)."""
    reqs = [dict(uid=i, prompt=prompt(cfg, 9 + i % 2, seed=i % 3),
                 max_new=5, temperature=0.0) for i in range(4)]
    system = prompt(cfg, 16, seed=11)
    for i in (4, 5):
        reqs.append(dict(uid=i, prompt=np.concatenate(
            [system, prompt(cfg, 8, seed=20 + i)]), max_new=5,
            temperature=0.0))
    return reqs


def renumber(reqs: list[dict], add: int) -> list[dict]:
    return [{**r, "uid": r["uid"] + add} for r in reqs]


def eq(a: dict, b: dict, shift: int = 0):
    """Every request of ``b`` has its tokens in ``a`` under its uid +
    ``shift`` (an engine's results hold all its runs)."""
    assert b and set(u + shift for u in b) <= set(a)
    for uid in b:
        np.testing.assert_array_equal(a[uid + shift], b[uid],
                                      err_msg=str(uid))


def counters(eng) -> dict:
    return {k: getattr(eng, k) for k in COUNTERS}


def storage(eng) -> dict:
    """The storage of every cache leaf the prefix cache writes (all but the
    ``pos`` cursors, which each decode step returns anew), by its path."""
    out = {}

    def rec(tree, kinds, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                rec(v, kinds[k], f"{path}{k}/")
            elif kinds[k] != "pos":
                out[path + k] = v.data_ptr()

    rec(eng.caches, eng._kinds, "")
    return out


def kept_rows(index: dict, leaves: list, axis: int):
    """``(key -> slot, [leaf rows of those slots])`` of an index now."""
    slots = sorted(set(index.values()))
    idx = torch.as_tensor(slots)
    return dict(index), slots, [leaf.index_select(axis, idx).clone()
                                for leaf in leaves]


def unchanged(index: dict, leaves: list, axis: int, kept) -> None:
    """Every slot still indexed under the key it had when ``kept`` was
    taken holds the same bytes (an evicted slot may be reused)."""
    before, slots, rows = kept
    same = sorted({s for k, s in before.items() if index.get(k) == s})
    assert same, "every indexed slot was evicted"
    pos = torch.as_tensor([slots.index(s) for s in same])
    idx = torch.as_tensor(same)
    for leaf, old in zip(leaves, rows):
        assert torch.equal(leaf.index_select(axis, idx),
                           old.index_select(axis, pos))


def pool_leaves(eng) -> list:
    _, kinds = T.cache_slot_spec(eng.cfg, paged=True,
                                 kv_bits=eng.acfg.kv_bits)
    return [eng.caches[k] for k, kind in kinds.items() if kind == "pool"]


def warm_cold(carried, name: str, kv_bits: int = 0):
    """Port: cold, then prime and warm on one engine; reference: prime and
    warm on one engine with the cache. Returns the runs and engines."""
    cfg = carried[0]
    rp, racfg, tp, tacfg = deploy(carried, name, kv_bits)
    reqs = workload(cfg)
    base = PS.SchedulerConfig(prefix_cache=False, **GEO)
    cold = PS.ServeEngine(tp, cfg, tacfg, base).run(
        [PS.Request(**r) for r in reqs])
    eng = PS.ServeEngine(tp, cfg, tacfg,
                         dataclasses.replace(base, prefix_cache=True))
    ptrs = storage(eng)
    prime = eng.run([PS.Request(**r) for r in reqs])
    after_prime = counters(eng)
    kept = kept_rows(eng.pool._index, pool_leaves(eng), 1)
    warm = eng.run([PS.Request(**r) for r in renumber(reqs, 100)])
    assert storage(eng) == ptrs
    unchanged(eng.pool._index, pool_leaves(eng), 1, kept)
    ref = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(**GEO))
    rprime = ref.run([RS.Request(**r) for r in reqs])
    ref_after_prime = counters(ref)
    rwarm = ref.run([RS.Request(**r) for r in renumber(reqs, 100)])
    return dict(reqs=reqs, cold=cold, prime=prime, warm=warm, eng=eng,
                after_prime=after_prime, rprime=rprime, rwarm=rwarm,
                ref=ref, ref_after_prime=ref_after_prime)


@pytest.mark.parametrize("family,name", [("dense", "off"),
                                         ("dense", "analog_hw"),
                                         ("moe", "off")])
def test_warm_equals_cold_and_the_reference(family, name):
    """Warm ≡ prime ≡ cold bit for bit, equal to the reference engine's
    tokens; the warm pass hits on every request and skips each padded
    prompt but its last chunk; the counters are the reference's."""
    r = warm_cold(carried_for(family), name)
    eq(r["prime"], r["cold"])
    eq(r["warm"], r["cold"], shift=100)
    eq(r["prime"], r["rprime"])
    eq(r["warm"], r["rwarm"])
    eng, ref = r["eng"], r["ref"]
    assert eng.prefix_enabled and eng.paged_enabled
    assert r["after_prime"] == r["ref_after_prime"]
    assert counters(eng) == counters(ref)
    n = len(r["reqs"])
    assert eng.prefix_lookups == 2 * n
    assert eng.prefix_hits - r["after_prime"]["prefix_hits"] == n
    c = GEO["prefill_chunk"]
    skipped = sum(PS.padded_prompt_len(len(q["prompt"]), c) - c
                  for q in r["reqs"])
    assert (eng.prefix_skipped_tokens
            - r["after_prime"]["prefix_skipped_tokens"]) == skipped
    pool = eng.pool
    assert pool.num_live == 0 and pool.num_cached > 0
    assert pool.num_free + pool.num_cached == pool.num_blocks
    assert (pool.num_cached, pool.evictions) == (ref.pool.num_cached,
                                                 ref.pool.evictions)


def test_int8_pool_warm_equals_cold(dense):
    r = warm_cold(dense, "off", kv_bits=8)
    assert r["eng"].caches["kp"].dtype == torch.int8
    eq(r["prime"], r["cold"])
    eq(r["warm"], r["cold"], shift=100)
    eq(r["warm"], r["rwarm"])
    assert counters(r["eng"]) == counters(r["ref"])


def test_shares_across_live_requests(dense):
    """A prompt submitted while its twin is still decoding maps onto the
    live request's blocks (refcount > 1), gives its solo tokens and never
    writes into the shared prefix (the reference's case)."""
    cfg, tp = dense[0], dense[4]
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=2, max_len=48, prefill_chunk=4,
                              paged=True, kv_block_size=4)
    p = prompt(cfg, 11)
    solo = PS.ServeEngine(tp, cfg, acfg, scfg).run(
        [PS.Request(uid=0, prompt=p, max_new=8, temperature=0.0)])[0]
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    eng.submit(PS.Request(uid=1, prompt=p, max_new=12, temperature=0.0))
    while eng.queue or any(s is not None and s.prefilling
                           for s in eng.slots):
        eng.step()                       # the leader prefilled, indexed
    eng.submit(PS.Request(uid=2, prompt=p, max_new=8, temperature=0.0))
    eng.step()                           # the twin admitted onto its blocks
    shared = sorted(b for b, n in eng.pool._ref.items() if n > 1)
    assert shared, "the twin did not share the leader's blocks"
    b2 = next(b for b, s in enumerate(eng.slots) if s.req.uid == 2)
    wtbl = eng.caches["wtbl"][0, b2].tolist()
    assert all(wtbl[i] == 0 for i, blk in enumerate(eng.slots[b2].blocks)
               if blk in shared)
    kept = [leaf[:, shared].clone() for leaf in pool_leaves(eng)]
    out = eng.run()
    np.testing.assert_array_equal(solo, out[2])
    for leaf, before in zip(pool_leaves(eng), kept):
        assert torch.equal(leaf[:, shared], before)
    assert eng.prefix_hit_tokens > 0 and eng.prefix_skipped_tokens > 0


def test_copy_on_write_partial_tail(dense):
    """Blocks larger than the chunk leave a partial tail block; a matching
    admission copies it on write (one block copy) and decodes as cold:
    padded 32 is one full 20-token block and a 12-token tail, so the skip
    lands at 24 (the reference's case and counters)."""
    cfg, params, tp = dense[0], dense[1], dense[4]
    p = prompt(cfg, 26)
    geo = dict(num_slots=2, max_len=40, prefill_chunk=8, paged=True,
               kv_block_size=20)
    cold = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                          PS.SchedulerConfig(prefix_cache=False, **geo)).run(
        [PS.Request(uid=0, prompt=p, max_new=6, temperature=0.0)])[0]
    out = {}
    for mod, prm, acfg in ((PS, tp, PA.AnalogConfig(mode="off")),
                           (RS, params, RA.AnalogConfig(mode="off"))):
        eng = mod.ServeEngine(prm, cfg, acfg, mod.SchedulerConfig(**geo))
        eng.run([mod.Request(uid=1, prompt=p, max_new=6, temperature=0.0)])
        out[mod] = eng.run([mod.Request(uid=2, prompt=p, max_new=6,
                                        temperature=0.0)])[2]
        assert eng.prefix_cow_copies == 1
        assert eng.prefix_skipped_tokens == 24
    np.testing.assert_array_equal(cold, out[PS])
    np.testing.assert_array_equal(out[RS], out[PS])


def test_copy_on_write_copies_every_pool_leaf(dense):
    """The tail copy writes the donor block into the private block on every
    pool leaf (int8 pool: values and scales), in place."""
    cfg, tp = dense[0], dense[4]
    acfg = PA.AnalogConfig(mode="off", kv_bits=8)
    eng = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(
        num_slots=2, max_len=40, prefill_chunk=8, paged=True,
        kv_block_size=20))
    p = prompt(cfg, 26)
    eng.run([PS.Request(uid=1, prompt=p, max_new=6, temperature=0.0)])
    (tail_block, fill, _), = eng.pool._tails.values()
    leaves = pool_leaves(eng)
    assert len(leaves) == 4
    ptrs = [leaf.data_ptr() for leaf in leaves]
    eng.submit(PS.Request(uid=2, prompt=p, max_new=6, temperature=0.0))
    eng._admit_loop()
    slot = next(s for s in eng.slots if s is not None)
    private = slot.blocks[slot.hit_full]
    assert private != tail_block and eng.prefix_cow_copies == 1
    for leaf, ptr in zip(leaves, ptrs):
        assert leaf.data_ptr() == ptr
        assert torch.equal(leaf[:, private, :fill], leaf[:, tail_block,
                                                          :fill])
    eng.run()


def test_eviction_under_pressure(dense):
    """An undersized pool evicts LRU cached blocks to keep admitting (never
    stalls on retained blocks), gives the roomy pool's tokens and conserves
    its blocks; the evictions are the reference engine's."""
    cfg, params, tp = dense[0], dense[1], dense[4]
    reqs = [dict(uid=i, prompt=prompt(cfg, 8, seed=i), max_new=4,
                 temperature=0.0) for i in range(5)]
    roomy = dict(num_slots=2, max_len=16, prefill_chunk=4, paged=True,
                 kv_block_size=4)
    want = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                          PS.SchedulerConfig(**roomy)).run(
        [PS.Request(**r) for r in reqs])
    eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                         PS.SchedulerConfig(kv_blocks=7, **roomy))
    for r in reqs:
        eng.submit(PS.Request(**r))
    while eng.queue or eng.num_active:
        eng.step()
        pool = eng.pool
        assert pool.num_live + pool.num_free + pool.num_cached == 7
    eq(eng.results, want)
    assert eng.pool.evictions > 0 and eng.pool.num_live == 0
    ref = RS.ServeEngine(params, cfg, RA.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(kv_blocks=7, **roomy))
    eq(eng.results, ref.run([RS.Request(**r) for r in reqs]))
    assert eng.pool.evictions == ref.pool.evictions
    assert eng.pool.num_cached == ref.pool.num_cached


def test_gating_reasons_and_salt(dense):
    """Without the paged pool the prefix cache is gated with its reason;
    paged, nothing is reported (the reference's gating). ``cache_salt``
    roots the pool's keys, so a salted engine matches nothing of an
    unsalted prompt chain."""
    cfg, params, tp = dense[0], dense[1], dense[4]
    for paged in (False, True):
        geo = {**GEO, "paged": paged}
        eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                             PS.SchedulerConfig(**geo))
        ref = RS.ServeEngine(params, cfg, RA.AnalogConfig(mode="off"),
                             RS.SchedulerConfig(**geo))
        assert eng.gating_reasons == ref.gating_reasons
        assert eng.prefix_enabled == ref.prefix_enabled == paged
    assert set(PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                              PS.SchedulerConfig(num_slots=2, max_len=32))
               .gating_reasons) == {"prefix_cache"}
    eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                         PS.SchedulerConfig(cache_salt=7, **GEO))
    assert eng.pool.salt == 7
    p = np.zeros(8, np.int64)
    assert eng.pool.prefix_keys(p, 0)[0][0] == (7, 0)


def test_cli_prefix_flags_reach_the_engine(monkeypatch, capsys):
    """``--no-prefix-cache`` and ``--cache-salt`` reach the engine, and the
    report line carries the hit rate, the skipped prefill tokens and the
    copy-on-write tails when the cache runs."""
    seen = []

    class Spy(PS.ServeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(port_serve, "ServeEngine", Spy)
    small = ["--reduced", "--device", "cpu", "--num-requests", "2",
             "--new-tokens", "2"]
    base = ["--reduced", "--device", "cpu", "--paged", "--num-requests",
            "3", "--new-tokens", "4"]
    on = port_serve.main(base + ["--cache-salt", "5"])
    out = capsys.readouterr().out
    assert seen[-1].scfg.prefix_cache and seen[-1].scfg.cache_salt == 5
    assert seen[-1].pool.salt == 5
    assert "prefix cache: " in out and "hit rate" in out
    assert "prefill tokens skipped" in out and "copy-on-write" in out
    off = port_serve.main(base + ["--no-prefix-cache"])
    out = capsys.readouterr().out
    assert not seen[-1].scfg.prefix_cache and not seen[-1].prefix_enabled
    assert "prefix cache: " not in out
    eq(on, off)
    # on by default; without --paged its gating reason is printed only
    # when the flag was given
    port_serve.main(small)
    assert seen[-1].scfg.prefix_cache and not seen[-1].prefix_enabled
    assert "--prefix-cache is inert" not in capsys.readouterr().out
    port_serve.main(small + ["--prefix-cache"])
    assert "--prefix-cache is inert" in capsys.readouterr().out
