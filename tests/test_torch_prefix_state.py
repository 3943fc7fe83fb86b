"""The port's prefix cache on the ssm and hybrid families: the
content-addressed state-snapshot pool (``kv_pool.StateSnapshotPool``, the
``*_snap`` leaves of ``models.mamba2.init_mamba_cache``), against the JAX
package's engine.

Weights are built by the reference (mamba2-130m and jamba-v0.1-52b,
reduced; jamba at the reference tests' no-drop capacity) and carried across
as numpy. The counterparts of the ssm / hybrid cases of
``tests/test_scheduler.py``:

* warm ≡ cold bitwise (cold engine, then prime and warm on one engine with
  the cache), equal to the reference engine's greedy tokens; the prefix and
  snapshot counters equal the reference's; the snapshot pool conserves its
  slots and holds none live after the flip; every cache leaf but the
  cursors keeps its storage (capture, restore and the table rows write in
  place) and no snapshot that stays indexed under its key changes;
* the gating (an ssm stack runs the cache on the snapshot pool alone), the
  snapshot leaves' shapes, a hybrid skip bounded by its snapshots (no tail
  copy), and ``conv_width == 1`` warm and cold against ``generate``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import ref_model
from test_torch_prefix_cache import (counters, eq, kept_rows, prompt,
                                     renumber, storage, unchanged, workload)

from repro.configs import get_config
from repro.core import analog as RA
from repro.models import build as ref_build
from repro.serve import decode as ref_decode
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

ARCHS = {"ssm": "mamba2-130m", "hybrid": "jamba-v0.1-52b"}
#: the reference's hybrid engine at one decode step per engine step (its
#: jitted steps compile once per deployment); the port runs the same. The
#: snapshot pool holds every boundary of the workload (the auto size, 16,
#: would evict, and the warm pass would re-capture into evicted slots)
GEO = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True,
           kv_block_size=4, kv_blocks=40, decode_block=1, state_snapshots=32)
SNAP_COUNTERS = ("state_snaps_captured", "state_snap_restores")


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


_CARRIED: dict = {}


def carried_for(family: str):
    """(cfg, reference params, port params) of a family's reduced model,
    built once per test process."""
    if family not in _CARRIED:
        cfg = get_config(ARCHS[family]).reduce()
        if family == "hybrid":
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.num_experts))
            params = ref_model(cfg, 0)[0]
        else:
            cfg, params, _ = ref_build(cfg, jax.random.PRNGKey(0))
        _CARRIED[family] = (cfg, params,
                            params_from_numpy(_ref_flat(params), "cpu"))
    return _CARRIED[family]


def snap_leaves(eng) -> list:
    out = []

    def rec(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                rec(v)
            elif k.endswith("_snap"):
                out.append(v)

    rec(eng.caches)
    return out


def snap_axis(eng) -> int:
    """A snapshot leaf's NS axis: the state leaf's slot axis (1, or 2
    under a hybrid super-block)."""
    return 2 if eng.cfg.family == "hybrid" else 1


@pytest.mark.parametrize("family", list(ARCHS))
def test_warm_equals_cold_and_the_reference(family):
    """Warm ≡ prime ≡ cold bit for bit and equal to the reference engine's
    tokens, with real hits: the ssm stack restores snapshots, the hybrid
    the (KV blocks, snapshot) pair; every counter is the reference's."""
    cfg, params, pp = carried_for(family)
    acfg, racfg = PA.AnalogConfig(mode="off"), RA.AnalogConfig(mode="off")
    reqs = workload(cfg)
    base = PS.SchedulerConfig(prefix_cache=False, **GEO)
    cold = PS.ServeEngine(pp, cfg, acfg, base).run(
        [PS.Request(**r) for r in reqs])
    eng = PS.ServeEngine(pp, cfg, acfg,
                         dataclasses.replace(base, prefix_cache=True))
    ptrs = storage(eng)
    prime = eng.run([PS.Request(**r) for r in reqs])
    sp = eng.state_pool
    kept = kept_rows(sp._index, snap_leaves(eng), snap_axis(eng))
    warm = eng.run([PS.Request(**r) for r in renumber(reqs, 100)])
    assert storage(eng) == ptrs
    unchanged(sp._index, snap_leaves(eng), snap_axis(eng), kept)
    eq(prime, cold)
    eq(warm, cold, shift=100)
    ref = RS.ServeEngine(params, cfg, racfg, RS.SchedulerConfig(**GEO))
    eq(prime, ref.run([RS.Request(**r) for r in reqs]))
    eq(warm, ref.run([RS.Request(**r) for r in renumber(reqs, 100)]))
    mine = {**counters(eng), **{k: getattr(eng, k) for k in SNAP_COUNTERS}}
    theirs = {**counters(ref),
              **{k: getattr(ref, k) for k in SNAP_COUNTERS}}
    assert mine == theirs
    assert eng.prefix_enabled and eng.state_snap_restores >= len(reqs)
    assert eng.state_snaps_captured > 0 and eng.prefix_skipped_tokens > 0
    assert sp.num_live == 0 and sp.num_cached > 0
    assert sp.num_free + sp.num_cached == sp.num_blocks
    assert (sp.num_cached, sp.evictions) == (ref.state_pool.num_cached,
                                             ref.state_pool.evictions)
    assert (eng.pool is None) == (family == "ssm")
    if eng.pool is not None:
        assert eng.pool.num_live == 0
        assert eng.pool.num_cached == ref.pool.num_cached


@pytest.mark.parametrize("family", list(ARCHS))
def test_gating_and_snapshot_leaves(family):
    """An ssm stack gates ``paged`` and runs the prefix cache on the
    snapshot pool alone; a hybrid stack runs both pools. The snapshot
    leaves sit where the state leaves keep their slot axis, with
    ``state_snapshots`` slots (0 = num_slots * blocks per slot)."""
    cfg, params, pp = carried_for(family)
    acfg = PA.AnalogConfig(mode="off")
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(**GEO))
    ref = RS.ServeEngine(params, cfg, RA.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(**GEO))
    assert eng.gating_reasons == ref.gating_reasons
    assert eng.prefix_enabled and ref.prefix_enabled
    assert eng.paged_enabled == ref.paged_enabled == (family == "hybrid")
    auto = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        **{**GEO, "state_snapshots": 0}))
    ns = GEO["num_slots"] * GEO["max_len"] // GEO["kv_block_size"]
    assert auto.state_pool.num_blocks == ns
    ns = GEO["state_snapshots"]
    assert eng.state_pool.num_blocks == ns
    mamba = eng.caches if family == "ssm" else eng.caches["mamba"]
    lead = mamba["ssm"].shape[:-4]
    assert mamba["ssm_snap"].shape == lead + (ns,) + mamba["ssm"].shape[-3:]
    assert mamba["conv_snap"].shape == (lead + (ns,)
                                        + mamba["conv"].shape[-2:])
    assert mamba["conv_snap"].dtype == mamba["conv"].dtype
    assert mamba["ssm_snap"].dtype == torch.float32
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        **{**GEO, "state_snapshots": 5, "cache_salt": 3}))
    assert eng.state_pool.num_blocks == 5 and eng.state_pool.salt == 3
    off = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        **{**GEO, "paged": False}))
    assert off.state_pool is None and "prefix_cache" in off.gating_reasons
    assert not any(k.endswith("_snap") for k in (
        off.caches if family == "ssm" else off.caches["mamba"]))


def test_hybrid_skips_only_to_a_snapshot():
    """Blocks of 20 with chunks of 8: the KV index hits one full block and
    a partial tail, but no chunk boundary is a block boundary below the
    last chunk, so no snapshot exists there. The hybrid takes no tail copy
    and re-runs the whole prompt, warm ≡ cold (the reference's rules:
    ``tests/test_scheduler.py``'s COW case on the hybrid's admission)."""
    cfg, _, pp = carried_for("hybrid")
    p = prompt(cfg, 26)
    geo = dict(num_slots=2, max_len=40, prefill_chunk=8, paged=True,
               kv_block_size=20, decode_block=1)
    acfg = PA.AnalogConfig(mode="off")
    cold = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        prefix_cache=False, **geo)).run(
        [PS.Request(uid=0, prompt=p, max_new=4, temperature=0.0)])[0]
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(**geo))
    for uid in (1, 2):
        out = eng.run([PS.Request(uid=uid, prompt=p, max_new=4,
                                  temperature=0.0)])[uid]
        np.testing.assert_array_equal(out, cold)
    assert eng.pool.match_prefix(np.concatenate(
        [np.zeros(6, np.int64), p]), 6)[1] is not None   # a tail is indexed
    assert (eng.prefix_hits, eng.prefix_hit_tokens) == (1, 20)
    assert eng.prefix_cow_copies == eng.prefix_skipped_tokens == 0
    assert eng.state_snaps_captured == eng.state_snap_restores == 0


def test_conv_width_one_warm_and_cold():
    """``conv_width == 1`` keeps no conv tail: the zero-width ``conv_snap``
    captures and restores, and the engine gives the lockstep ``generate``'s
    tokens cold and warm (the reference's ``test_conv_width_one_
    regression``)."""
    cfg = dataclasses.replace(get_config(ARCHS["ssm"]).reduce(),
                              conv_width=1)
    cfg, params, _ = ref_build(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(_ref_flat(params), "cpu")
    p = prompt(cfg, 6)
    want = np.asarray(ref_decode.generate(
        params, cfg, RA.AnalogConfig(mode="off"), jax.random.PRNGKey(0),
        jnp.asarray(p[None]), 4, temperature=0.0))[0]
    acfg = PA.AnalogConfig(mode="off")
    np.testing.assert_array_equal(port_decode.generate(
        pp, cfg, acfg, None, torch.from_numpy(p[None]), 4,
        greedy_first=4)[0].numpy(), want)
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        num_slots=2, max_len=16, prefill_chunk=4, paged=True,
        kv_block_size=4))
    assert eng.caches["conv_snap"].shape[2] == 0
    for uid in (0, 1):
        out = eng.run([PS.Request(uid=uid, prompt=p, max_new=4,
                                  temperature=0.0)])[uid]
        np.testing.assert_array_equal(out, want)
    assert eng.state_snap_restores > 0
