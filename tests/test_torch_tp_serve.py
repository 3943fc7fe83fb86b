"""Tensor-parallel serving on the port's continuous engine, in process.

The reference's contract (``tests/test_tp_serve.py``): weights are
column-parallel and every activation is gathered back before the next
contraction, so greedy decode under tp >= 2 is bitwise identical to tp =
1 on every family, with the prefix cache warm-hitting and the speculative
path engaged, and a tp the runtime or config cannot take is gated with a
reason and served at tp = 1.

Here the engine holds tp shards on the CPU (``shard_devices``), the
counterpart of the reference's eight host devices. On reduced granite-3-8b
(dense), mamba2-130m (ssm), jamba-v0.1-52b (hybrid) and dbrx-132b (moe, at
the reference's no-drop capacity), with weights built by the reference and
carried across as numpy:

* tp = 2 tokens equal tp = 1 bit for bit in ``off``, ``analog`` (fused:
  the plain ``analog_matmul`` per shard) and ``rtn``, and the ``off``
  tokens equal the reference engine's tp = 1 tokens (the reference proves
  its own tp = 2 equal to its tp = 1);
* the weights, pool and drafter really are sharded (``Shards`` leaves),
  and each sharded site runs once per shard;
* prefix warm == cold == tp = 1 under tp = 2 (the KV pool and the
  state-snapshot pool); the int8 pool;
* the per-tile device model with drift (``col_off``) and a recalibration,
  sites whose shard boundary falls inside a tile among them;
* speculative decoding with the packed-int4 drafter;
* a cancel and a chaos reset under tp = 2;
* tp = 3 gated ("divisible") and too few devices gated, both serving the
  tp = 1 tokens; the CLI's ``--tp``.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from test_torch_train_families import ref_model

from repro.configs import get_config
from repro.core import analog as RA
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.core import devices as PD
from repro_torch.distributed import sharding
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serve import scheduler as PS


ARCHS = ["granite-3-8b", "mamba2-130m", "jamba-v0.1-52b", "dbrx-132b"]
GEO = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True)
ON_CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this module runs (the xdist workers share
    the machine), the caller's count restored after it. The tokens
    do not depend on it: :func:`test_shard_products_at_any_thread_count`
    and :func:`test_tp2_equals_tp1_at_more_threads`."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _cfg(arch):
    cfg = get_config(arch).reduce()
    if cfg.num_experts:      # the reference's no-drop capacity
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts))
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params, port params)."""
    return _carry(request.param)


def _carry(arch):
    cfg = _cfg(arch)
    params, _ = ref_model(cfg, 0)
    return cfg, params, params_from_numpy(_ref_flat(params), "cpu")


def _reqs(cfg, n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [dict(uid=u, prompt=rng.integers(0, cfg.vocab_size, 5 + 2 * u)
                 .astype(np.int32), max_new=6, temperature=0.0)
            for u in range(n)]


def _acfg(mode):
    if mode == "analog":
        return PA.AnalogConfig(mode="analog", train_noise=False,
                               use_pallas=True)
    if mode == "rtn":
        return PA.AnalogConfig(mode="rtn", weight_bits=4)
    return PA.AnalogConfig(mode="off")


def _engine(params, cfg, acfg, tp, devices=None, **kw):
    scfg = PS.SchedulerConfig(tp=tp, **dict(GEO, **kw))
    return PS.ServeEngine(params, cfg, acfg, scfg, shard_devices=devices)


def _run(eng, reqs):
    out = eng.run([PS.Request(**r) for r in reqs])
    return {u: np.asarray(v).tolist() for u, v in out.items()}


def _count_shards(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_shards(v) for v in tree.values())
    return int(isinstance(tree, sharding.Shards))


@pytest.mark.parametrize("mode", ["off", "analog", "rtn"])
def test_tp2_equals_tp1(carried, mode, monkeypatch):
    """tp = 2 gives tp = 1's tokens bit for bit; the weights and the pool
    are sharded and every sharded site runs once per shard."""
    cfg, _, pp = carried
    acfg = _acfg(mode)
    want = _run(_engine(pp, cfg, acfg, 1), _reqs(cfg))
    calls = {"whole": 0, "shard": 0}
    real = PA.analog_linear

    def spy(p, x, c, ctx):
        key = ("shard" if kref.WHOLE_SITE.get() is not None
               else "whole")
        if not isinstance(p["kernel"], sharding.Shards):
            calls[key] += 1
        return real(p, x, c, ctx)

    monkeypatch.setattr(PA, "analog_linear", spy)
    eng = _engine(pp, cfg, acfg, 2, ON_CPU2)
    assert eng.mesh is not None and eng.mesh.tp == 2
    assert "tensor_parallel" not in eng.gating_reasons
    assert _count_shards(eng.params) > 0
    if cfg.family != "ssm":
        pool = eng.caches["attn"] if cfg.family == "hybrid" else eng.caches
        assert isinstance(pool["kp"], sharding.Shards)
        assert pool["kp"].parts[0].shape[-2] == cfg.num_kv_heads // 2
    got = _run(eng, _reqs(cfg))
    assert got == want
    # every sharded site ran as two shard calls
    assert calls["shard"] > 0 and calls["shard"] % 2 == 0


def test_int8_pool_under_tp2():
    """The int8 pool (``kv_bits=8``: ``kp`` / ``vp`` and their scales
    ``ks`` / ``vs`` split on the KV heads) gives tp = 1's tokens."""
    cfg, pp = _dense()
    acfg = PA.AnalogConfig(mode="off", kv_bits=8)
    want = _run(_engine(pp, cfg, acfg, 1), _reqs(cfg))
    eng = _engine(pp, cfg, acfg, 2, ON_CPU2)
    assert all(isinstance(eng.caches[k], sharding.Shards)
               for k in ("kp", "vp", "ks", "vs"))
    assert _run(eng, _reqs(cfg)) == want


def test_tp2_equals_the_reference_engine(carried):
    """The port's tp = 2 greedy tokens are the reference engine's tp = 1
    tokens (``off``)."""
    cfg, params, pp = carried
    reqs = _reqs(cfg)
    # one decode step a block: the reference's jitted steps compile once
    ref = RS.ServeEngine(params, cfg, RA.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(decode_block=1, **GEO)).run(
        [RS.Request(**r) for r in reqs])
    got = _run(_engine(pp, cfg, _acfg("off"), 2, ON_CPU2), reqs)
    assert got == {u: np.asarray(v).tolist() for u, v in ref.items()}


def test_prefix_warm_equals_cold_under_tp2(carried):
    """The reference's ``prefix_parity``: under tp = 2 a repeated prompt
    hits (KV blocks; the ssm and hybrid families through the snapshot
    pool) and warm == cold == tp = 1."""
    cfg, _, pp = carried
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, 17).astype(np.int32)
    acfg = _acfg("off")

    def req(uid):
        return dict(uid=uid, prompt=prompt, max_new=5, temperature=0.0)

    eng = _engine(pp, cfg, acfg, 2, ON_CPU2, max_len=48)
    cold = _run(eng, [req(0)])[0]
    warm = _run(eng, [req(1)])[1]
    ref = _run(_engine(pp, cfg, acfg, 1, max_len=48), [req(0)])[0]
    assert eng.prefix_skipped_tokens > 0
    assert cold == warm == ref


def _dense(arch="granite-3-8b"):
    cfg, _, pp = _carry(arch)
    return cfg, pp


#: sites whose shard products BLAS would sum in another order than the
#: whole product at some thread count: a column site at M = 8 (at 4
#: threads this one's column halves part from the whole product's with
#: torch 2.13's MKL build for the CPU) and a batched expert site
PRODUCT_SITES = {"columns": ((8, 2048), (2048, 1024)),
                 "experts": ((4, 8, 512), (4, 512, 256))}


@pytest.mark.parametrize("threads", [1, 3, 4, 8])
@pytest.mark.parametrize("site", sorted(PRODUCT_SITES))
@pytest.mark.parametrize("mode", ["off", "analog", "rtn"])
def test_shard_products_at_any_thread_count(threads, site, mode):
    """A sharded site on the CPU equals its whole site bit for bit at tp
    2 and 4 and any thread count: each shard's plain product runs at the
    whole site's shape (``ref.site_matmul``)."""
    xs, ws = PRODUCT_SITES[site]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal(ws)).astype(
        np.float32))
    p = {"kernel": w, "input_range": torch.tensor([2.5])}
    acfg, ctx = _acfg(mode), PA.AnalogCtx()
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        want, _ = PA.analog_linear(p, x, acfg, ctx)
        for tp in (2, 4):
            mesh = sharding.serve_mesh(tp, ["cpu"] * tp)
            axis = -3 if site == "experts" else -1
            sp = dict(p, kernel=sharding._shard(w, mesh, axis))
            got, _ = PA.analog_linear(sp, x, acfg, ctx)
            assert torch.equal(got, want), (tp, threads)
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("threads", [4])
def test_tp2_equals_tp1_at_more_threads(threads):
    """The engine's tp = 2 tokens equal tp = 1's at another thread count
    than the module's two (dense, ``off`` and fused ``analog``; more
    counts for the products alone above)."""
    cfg, pp = _dense()
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for mode in ("off", "analog"):
            acfg = _acfg(mode)
            want = _run(_engine(pp, cfg, acfg, 1), _reqs(cfg))
            got = _run(_engine(pp, cfg, acfg, 2, ON_CPU2), _reqs(cfg))
            assert got == want, mode
    finally:
        torch.set_num_threads(old)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone()


def test_engine_keeps_no_unsharded_copy():
    """A sharded engine holds each sharded weight only as its shards: once
    the caller drops its tree (as the launcher does), the whole tensors
    are freed, so no device holds a sharded site whole."""
    cfg, pp = _dense()
    want = _run(_engine(pp, cfg, _acfg("analog"), 1), _reqs(cfg))
    pp = _cloned(pp)       # tensors no other reference holds
    refs = {path: weakref.ref(t) for path, t in _leaves(pp)}
    eng = _engine(pp, cfg, _acfg("analog"), 2, ON_CPU2)
    sharded = [path for path, t in _leaves(eng.params)
               if isinstance(t, sharding.Shards)]
    assert sharded
    del pp
    gc.collect()
    assert all(refs[path]() is None for path in sharded)
    assert _run(eng, _reqs(cfg)) == want


def test_device_model_col_off_under_tp2():
    """The per-tile device model under tp = 2: drift (a nonzero
    ``col_off`` into the fused kernel's plain version) and a watchdog
    recalibration, with sites whose tiles divide over the shards (their
    state sharded) and sites whose shard boundary falls inside a tile
    (their state whole, read at each shard's columns): tokens, health and
    the recalibration count equal tp = 1's."""
    cfg, pp = _dense()
    dcfg = PD.DeviceConfig(tile_k=32, tile_n=24, p_stuck_col=0.05,
                           p_dead_tile=0.05)
    labels = T.model_labels(pp, cfg)
    acfg = _acfg("analog")
    kw = dict(drift_dt=50.0, recalibrate=True, recal_interval=2,
              recal_threshold=0.01)

    def run(tp, devices=None):
        dp = PD.attach_device_state(pp, labels,
                                    torch.Generator().manual_seed(5), dcfg)
        eng = _engine(dp, cfg, acfg, tp, devices, **kw)
        return _run(eng, _reqs(cfg)), eng

    want, e1 = run(1)
    got, e2 = run(2, ON_CPU2)
    assert got == want
    assert e2.recal_count == e1.recal_count > 0
    assert e2.tile_scale_err == e1.tile_scale_err
    assert (e2.dead_tiles, e2.stuck_cols) == (e1.dead_tiles, e1.stuck_cols)
    kinds = set()

    def walk(p):
        if isinstance(p, dict):
            if isinstance(p.get("kernel"), sharding.Shards) and "device" in p:
                kinds.add(isinstance(p["device"]["gain"], sharding.Shards))
            for v in p.values():
                walk(v)

    walk(e2.params)
    assert kinds == {True, False}


@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b"])
def test_speculative_int4_drafter_under_tp2(arch):
    """Speculative decoding with the packed-int4 drafter under tp = 2: the
    drafter's carriers and cache are sharded (no gating reason: each
    shard runs its own int4 launch), the tokens and the acceptance equal
    tp = 1's."""
    cfg, pp = _dense(arch)
    acfg = _acfg("off")
    kw = dict(speculative=True, draft_k=2, draft="int4")
    e1 = _engine(pp, cfg, acfg, 1, **kw)
    want = _run(e1, _reqs(cfg))
    e2 = _engine(pp, cfg, acfg, 2, ON_CPU2, **kw)
    got = _run(e2, _reqs(cfg))
    assert got == want
    assert "draft_packed_int4" not in e2.gating_reasons
    assert e2.spec_steps > 0
    assert (e2.spec_proposed, e2.spec_accepted) == (e1.spec_proposed,
                                                   e1.spec_accepted)
    flat = e2.draft_params["blocks"]["ffn"]
    site = flat["down"] if cfg.family == "dense" else flat["gate_up"]
    assert isinstance(site["int4"]["packed"], sharding.Shards)
    assert isinstance(e2.draft_caches["k"], sharding.Shards)


def test_cancel_and_chaos_reset_under_tp2():
    """A cancel mid-decode and a fault at dispatch (the reset zeroes every
    shard in place) under tp = 2: the same statuses, partial outputs and
    later tokens as tp = 1 under the same calls."""
    cfg, pp = _dense()
    acfg = _acfg("off")

    def run(tp, devices=None):
        fired = []

        def chaos(point):
            if point == "dispatch" and len(fired) == 0 and steps[0] == 3:
                fired.append(point)
                raise RuntimeError("injected")

        steps = [0]
        eng = _engine(pp, cfg, acfg, tp, devices, num_slots=3,
                      decode_block=1)
        eng.chaos_hook = chaos
        eng._tolerant = True
        leaves = [leaf for (leaf,) in PS._walk(eng.caches)]
        for r in _reqs(cfg, n=3):
            eng.submit(PS.Request(**r))
        while eng.num_active or eng.queue:
            steps[0] += 1
            if steps[0] == 6:
                eng.cancel(2)
            eng.step()
        # after the reset: a fresh request serves its tp = 1 tokens
        later = _run(eng, [dict(uid=9, prompt=_reqs(cfg)[1]["prompt"],
                                max_new=5, temperature=0.0)])
        assert [leaf for (leaf,) in PS._walk(eng.caches)] == leaves
        return ({u: (eng.status[u], np.asarray(eng.results[u]).tolist())
                 for u in eng.status}, later, eng)

    want, later1, e1 = run(1)
    got, later2, e2 = run(2, ON_CPU2)
    assert e2.fault_count == e1.fault_count == 1
    assert got == want and later2 == later1
    assert {s for s, _ in got.values()} >= {"errored", "finished"}


def test_gating_tp3_and_too_few_devices():
    """tp = 3 with heads 4: gated, "divisible" in the reason, tp = 1's
    tokens; tp = 2 on one device with no shard devices: gated with the
    reference's too-few-devices reason; ``use_pallas`` gates nothing (each
    shard launches its own kernel)."""
    cfg, pp = _dense()
    acfg = _acfg("off")
    want = _run(_engine(pp, cfg, acfg, 1), _reqs(cfg))
    e3 = _engine(pp, cfg, acfg, 3, ["cpu"] * 3)
    assert e3.mesh is None
    assert "divisible" in e3.gating_reasons["tensor_parallel"]
    assert _run(e3, _reqs(cfg)) == want
    e2 = _engine(pp, cfg, acfg, 2)
    assert e2.mesh is None
    assert "devices" in e2.gating_reasons["tensor_parallel"]
    assert _run(e2, _reqs(cfg)) == want
    assert sharding.serve_tp_unsupported(cfg, 2, ON_CPU2) is None
    e2 = _engine(pp, cfg, PA.AnalogConfig(mode="analog", use_pallas=True),
                 2, ON_CPU2)
    assert e2.mesh is not None and not e2.gating_reasons
    with pytest.raises(ValueError, match="shard_devices"):
        _engine(pp, cfg, acfg, 2, ["cpu"] * 3)


def test_cli_tp(capsys, monkeypatch):
    """``--tp 2`` on the CPU, one device, says why it is inert and serves
    the tp = 1 sample; with two devices to shard on (the CPU twice, as a
    runtime with two cards would give) it prints the mesh and serves the
    same sample."""
    argv = ["--device", "cpu", "--reduced", "--paged", "--num-requests",
            "3"]
    serve_cli.main(argv)
    base = capsys.readouterr().out.strip().splitlines()[-1]
    serve_cli.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "--tp is inert" in "\n".join(out)
    assert out[-1].split("sample:")[1] == base.split("sample:")[1]
    monkeypatch.setattr(sharding, "available_devices",
                        lambda device: [torch.device("cpu")] * 2)
    serve_cli.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "tensor parallel: tp=2 over ['cpu', 'cpu']" in "\n".join(out)
    assert out[-1].split("sample:")[1] == base.split("sample:")[1]


def test_shards_leaf_ops():
    """The engine's in-place row operations act on every shard, and
    ``whole`` gathers: select, index_select / index_copy_, copy_ from a
    whole tensor, zero_."""
    t = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    mesh = sharding.serve_mesh(2, ON_CPU2)
    s = sharding._shard(t, mesh, -1)
    assert s.shape == t.shape and torch.equal(s.whole(), t)
    assert torch.equal(s.select(1, 2).whole(), t.select(1, 2))
    idx = torch.tensor([1, 0])
    assert torch.equal(s.index_select(0, idx).whole(), t.index_select(0, idx))
    s.index_copy_(0, torch.tensor([0, 1]), s.index_select(0, idx))
    assert torch.equal(s.whole(), t.index_select(0, idx))
    s.copy_(t)
    assert torch.equal(s.whole(), t)
    assert [u.whole().tolist() for u in s.unbind(0)] == [t[0].tolist(),
                                                          t[1].tolist()]
    with pytest.raises(IndexError):
        s.select(2, 0)
    s.zero_()
    assert float(s.whole().abs().sum()) == 0.0
