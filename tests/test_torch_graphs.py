"""The continuous engine's step bodies (``serve.scheduler`` with
``serve.graphs``), which a CUDA engine captures as graphs and replays: on
the CPU the engine runs the same bodies eagerly over the same static
buffers, so these tests hold exactly the code that is captured.

* Inside every body there is no host read and no upload from host data:
  reduced llama-3.2-1b, qwen3-moe-30b-a3b, mamba2-130m and jamba-v0.1-52b,
  paged, through every body key (decode blocks of k = 1, 2, 4 and 8, greedy
  and sampled with top-k and top-p; the fused step with and without decode
  rows and with the int4 drafter; verify windows with the ngram, self and
  int4 drafters), with ``Tensor.item`` / ``cpu`` / ``tolist`` / ``numpy``
  / ``__bool__``, ``torch.as_tensor`` and ``torch.tensor`` raising.
* Every static buffer, staging twin and cache leaf keeps its storage
  through admissions, retirements, a cancel between the two halves of a
  step, a chaos reset and a recalibration.
* Greedy tokens and counters equal the JAX package's engine on a dense
  and a hybrid model (each reference engine built once; the port's weights
  carried into the reference's tree by value).
* A sampled request draws the same tokens solo and mid-batch.
* A step-graph set that dies while a capture is under way keeps its
  graphs until the last capture ends (the card test
  ``test_engine_capture_survives_collecting_a_dead_engine`` holds the
  capture itself).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import analog as RA
from repro.models import transformer as RT
from repro.serve import scheduler as RS
from repro_torch.checkpoint import flatten_paths
from repro_torch.configs import get_config
from repro_torch.core import analog as PA
from repro_torch.core import devices
from repro_torch.models import build
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

#: the host reads and uploads no step body may make
FORBIDDEN = ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
             (torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
             (torch.Tensor, "__bool__"), (torch, "as_tensor"),
             (torch, "tensor"))

_MISSING = object()


@contextlib.contextmanager
def no_host():
    """Inside the block every call in :data:`FORBIDDEN` raises."""
    saved = [(owner, name, owner.__dict__.get(name, _MISSING))
             for owner, name in FORBIDDEN]

    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"{name} inside a step body")
        return call

    for owner, name, _ in saved:
        setattr(owner, name, refuse(name))
    try:
        yield
    finally:
        for owner, name, orig in saved:
            if orig is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)


def guarded(eng, seen: set):
    """Run every step body of ``eng`` under :func:`no_host`, recording
    its key in ``seen``."""
    real = eng._run_body

    def run(key, body):
        seen.add(key)

        def body_guarded():
            with no_host():
                body()
        real(key, body_guarded)

    eng._run_body = run
    return eng


def _model(arch: str):
    cfg = get_config(arch).reduce()
    if cfg.family in ("moe", "hybrid"):
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return build(cfg, 0, device="cpu")[:2]


def _reqs(cfg, n: int, sampled: bool, seed: int = 0) -> list:
    """``n`` requests of 16 new tokens (a slot's decode blocks then run at
    k = 8, 4, 2, 1); with ``sampled`` every second one samples with top-k
    or top-p."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if sampled and i % 2:
            kw = dict(temperature=0.8, top_k=5 if i % 4 == 1 else 0,
                      top_p=0.9 if i % 4 == 3 else 1.0, seed=seed + i)
        else:
            kw = dict(temperature=0.0)
        out.append(PS.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       int(rng.integers(3, 20))).astype(
                                           np.int32), max_new=16, **kw))
    return out


GEO = dict(num_slots=3, max_len=64, prefill_chunk=8, kv_block_size=8,
           paged=True)


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen3-moe-30b-a3b",
                                  "mamba2-130m", "jamba-v0.1-52b"])
def test_bodies_make_no_host_read_or_upload(arch):
    """Every body key of a family runs with host reads and uploads
    refused: decode blocks of 1, 2, 4 and 8 steps, greedy and sampled; the
    fused step with and without decode rows (with the int4 drafter's
    catch-up on the dense and moe families); verify windows with each
    drafter."""
    cfg, params = _model(arch)
    acfg = PA.AnalogConfig(mode="off")
    seen = set()
    for sampled in (False, True):
        eng = guarded(PS.ServeEngine(params, cfg, acfg,
                                     PS.SchedulerConfig(**GEO)), seen)
        eng.run(_reqs(cfg, 5, sampled))
    decode = {k[1:3] for k in seen if k[0] == "decode"}
    assert decode == {(k, s) for k in (1, 2, 4, 8) for s in (False, True)}
    assert any(k[0] == "decode" and k[3] for k in seen)         # top-k
    assert any(k[0] == "decode" and k[4] for k in seen)         # top-p
    assert {k[1] for k in seen if k[0] == "mixed"} == {False, True}
    if cfg.family in ("ssm", "hybrid"):
        return
    for draft in ("ngram", "self", "int4"):
        spec = set()
        eng = guarded(PS.ServeEngine(params, cfg, acfg, PS.SchedulerConfig(
            speculative=True, draft=draft, draft_k=4, **GEO)), spec)
        res = eng.run(_reqs(cfg, 5, True))
        assert all(len(v) == 16 for v in res.values())
        kind = "verify" if draft == "ngram" else "spec"
        assert {k[1] for k in spec if k[0] == kind} >= {1, 2, 4}
        assert any(k[0] == kind and k[2] for k in spec)          # sampled
        if draft == "int4":
            assert {k[1:3] for k in spec if k[0] == "mixed"} == {
                (False, True), (True, True)}


def _storage(eng) -> dict:
    """``data_ptr`` of every static buffer, staging twin and cache leaf of
    the engine and of its drafter."""
    out = {("buf", n): t.data_ptr() for n, t in eng._buf.items()}
    out.update((("stage", n), t.data_ptr()) for n, t in eng._stage.items())
    for name, tree in (("caches", eng.caches),
                       ("draft", eng.draft_caches or {})):
        for i, (leaf,) in enumerate(PS._walk(tree)):
            out[name, i] = leaf.data_ptr()
    return out


def test_buffers_and_leaves_keep_their_storage_through_churn():
    """Admissions and retirements (more requests than slots), a cancel
    between ``step_begin`` and ``step_commit``, a chaos fault and its
    reset, and in-place recalibrations of an ageing chip leave every
    static buffer, staging twin and cache leaf (the int4 drafter's too)
    where it was."""
    cfg = get_config("llama-3.2-1b").reduce()
    cfg, params, labels = build(cfg, 0, device="cpu")
    params = devices.attach_device_state(params, labels,
                                         torch.Generator().manual_seed(3))
    calls = {"n": 0}

    def chaos(point):
        if point == "dispatch":
            calls["n"] += 1
            if calls["n"] == 9:
                raise RuntimeError("chaos: injected dispatch fault")

    eng = PS.ServeEngine(
        params, cfg, PA.AnalogConfig(mode="analog", train_noise=False),
        PS.SchedulerConfig(speculative=True, draft="int4", drift_dt=50.0,
                           recalibrate=True, recal_interval=2,
                           recal_threshold=0.0, **GEO),
        chaos_hook=chaos)
    ptrs = _storage(eng)
    reqs = _reqs(cfg, 7, True)
    for r in reqs:
        eng.submit(r)
    cancelled = False
    while eng.queue or eng.num_active:
        pending = eng.step_begin()
        if pending is None:
            continue
        live = [s.req.uid for s in eng.slots if s is not None]
        if not cancelled and pending["op"] == "spec" and live:
            assert eng.cancel(live[0])
            cancelled = True
        eng.step_commit(pending)
        assert _storage(eng) == ptrs
    assert cancelled and eng.fault_count == 1 and eng.recal_count >= 2
    assert "errored" in eng.status.values()
    assert "cancelled" in eng.status.values()
    assert _storage(eng) == ptrs


def _to_reference(cfg, pp: dict):
    """The port's params ``pp`` as the reference's tree: its structure from
    ``jax.eval_shape`` of the reference's ``init_model`` (no compile), each
    leaf the port's at the same path, by value."""
    flat = flatten_paths(pp)
    shapes = jax.eval_shape(lambda k: RT.init_model(k, cfg)[0],
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(flat["/".join(
            str(getattr(k, "key", k)) for k in path)].numpy(), s.dtype),
        shapes)


@pytest.fixture(scope="module", params=["dense", "hybrid"])
def reference_run(request):
    """A greedy churn workload through the JAX package's engine (built once
    per model) on reduced llama-3.2-1b and on a reduced jamba-v0.1-52b of
    one 4-layer super-block; the port's weights carried across by value."""
    arch, kw = (("llama-3.2-1b", {}) if request.param == "dense" else
                ("jamba-v0.1-52b", dict(num_layers=4, attn_every=4)))
    cfg = dataclasses.replace(ref_config(arch).reduce(), **kw)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    pp = build(cfg, 0, device="cpu")[1]
    rp = _to_reference(cfg, pp)
    rng = np.random.default_rng(5)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(3, 14))).astype(
                                                np.int32),
                 max_new=int(rng.integers(3, 12)), temperature=0.0)
            for i in range(5)]
    geo = dict(num_slots=2, max_len=40, prefill_chunk=4, kv_block_size=4,
               paged=True)
    ref = RS.ServeEngine(rp, cfg, RA.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(**geo))
    ref.run([RS.Request(**r) for r in reqs])
    return cfg, pp, reqs, geo, ref


COUNTERS = ("decode_steps", "mixed_steps", "prefill_chunks",
            "decode_tokens_during_admission", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "prefix_skipped_tokens")


def test_greedy_tokens_and_counters_match_the_reference(reference_run):
    """The restructured engine's greedy tokens and step counters equal the
    reference engine's (its jitted steps), blocks of up to 8 decode
    steps, the prefix cache on in both."""
    cfg, pp, reqs, geo, ref = reference_run
    port = PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="off"),
                          PS.SchedulerConfig(**geo))
    got = port.run([PS.Request(**r) for r in reqs])
    assert sorted(got) == sorted(ref.results)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, ref.results[uid],
                                      err_msg=f"request {uid}")
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("draft", [None, "int4"])
def test_sampled_request_draws_the_same_solo_and_mid_batch(draft):
    """A sampled request (top-k and top-p) admitted into a busy batch of
    sampled and greedy requests draws exactly its solo tokens: its noise
    rows are its own, staged from its seed and counts; with the int4
    drafter too."""
    cfg, params = _model("llama-3.2-1b")
    acfg = PA.AnalogConfig(mode="off")
    spec = dict(speculative=True, draft=draft) if draft else {}
    probe = PS.Request(uid=99, prompt=np.arange(7, dtype=np.int32) + 3,
                       max_new=14, temperature=0.9, top_k=6, top_p=0.85,
                       seed=41)
    solo = PS.ServeEngine(params, cfg, acfg, PS.SchedulerConfig(
        **GEO, **spec)).run([probe])[99]
    eng = PS.ServeEngine(params, cfg, acfg, PS.SchedulerConfig(**GEO, **spec))
    for r in _reqs(cfg, 3, True, seed=2):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.submit(probe)
    mid = eng.run()[99]
    np.testing.assert_array_equal(mid, solo)


@pytest.mark.parametrize("during_capture", [True, False])
def test_dead_step_graphs_wait_for_the_captures(during_capture):
    """A ``StepGraphs`` freed by a cyclic collection inside a capture (in
    any thread) hands its graphs to the module's list, which the last
    capture to end empties; outside a capture they go at once."""
    import gc
    import weakref

    from repro_torch.serve import graphs

    class Graph:                # stands in for a torch.cuda.CUDAGraph
        pass

    sg = graphs.StepGraphs(torch.device("cpu"))
    graph = Graph()
    sg._graphs[("decode", 1)] = (graph, None)
    probe = weakref.ref(graph)
    sg.cycle = sg
    del sg, graph
    outer = graphs._capture_under_way() if during_capture else (
        contextlib.nullcontext())
    with outer:
        with graphs._capture_under_way() if during_capture else (
                contextlib.nullcontext()):
            gc.collect()
            assert (probe() is not None) == during_capture
        # a capture still under way: the graphs wait for it
        assert (probe() is not None) == during_capture
    assert probe() is None
    assert not graphs._graveyard and graphs._capturing == 0
