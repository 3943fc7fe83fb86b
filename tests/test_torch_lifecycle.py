"""The port's request lifecycle (``repro_torch.serve.scheduler``) against
the JAX package's, the counterparts of ``tests/test_lifecycle.py``.

Weights are drawn by the reference and carried across as numpy
(``params_from_numpy``); the per-tile device state of the health-read case
too. Wherever the reference has the test, the port's engine and the
reference's run the same schedule of submits, cancels, deadline ageing
(``submit_time[u] -= 120.0``, no sleeps) and steps at temperature 0, and
their statuses, ``errors`` reasons, results, ``drain_events`` sequences and
lifecycle counters must be equal. Sampled decode is held only to the
port's own closed-loop run (randomness does not cross the packages).

* cancel at every stage, the deferred cancel mid speculative window, the
  pool's window contract, the TTFT and end-to-end deadlines, the bounded
  queue, chaos at dispatch (the reset in place: every cache leaf keeps its
  storage and is zeroed), chaos without the tolerance flag, the allocator
  fault, the corrupted health read;
* churn: randomized submit / cancel / timeout interleavings hold block
  conservation after every event and the survivors decode what the port's
  closed-loop run decodes, on all four engine families; on granite-3-8b and
  mamba2-130m the reference's engine runs the same churn in lockstep;
* what the reference has no test for: ``step_begin`` twice, a foreign
  ``step_commit``, a cancel from another thread issuing its device writes
  on the engine's stream, and a fault reset that fails propagating.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch
from strategies import given, settings, st
from test_torch_devices import SCALE_ERR_TOL, _carry, _ref_attach, _ref_model
from test_torch_hybrid import ref_model

from repro.configs import get_config
from repro.core import analog as RA
from repro.core import devices as RD
from repro.serve import scheduler as RS
from repro_torch.core import analog as PA
from repro_torch.core import devices as PD
from repro_torch.models import build as port_build
from repro_torch.serve import scheduler as PS
from repro_torch.serve.kv_pool import KVPool

torch.set_num_threads(2)

FAMILIES = ["granite-3-8b", "mamba2-130m", "jamba-v0.1-52b", "dbrx-132b"]
CROSS = ["granite-3-8b", "mamba2-130m"]
#: the lifecycle counters both engines keep
COUNTERS = ("submitted", "shed_count", "timeout_count", "cancel_count",
            "fault_count", "health_faults", "step_faults",
            "queue_high_water", "decode_steps", "mixed_steps",
            "prefill_chunks", "decode_tokens_during_admission")

_BUILT: dict = {}


def _cfg(arch):
    """The reduced config at no-drop capacity (deterministic greedy)."""
    cfg = get_config(arch).reduce()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.num_experts))
    return cfg


def _carried(arch):
    """``(cfg, reference params, port params)``: the reference's weights
    carried across (memoized: the suite builds many engines)."""
    if arch not in _BUILT:
        cfg = _cfg(arch)
        params, _, _ = ref_model(cfg, 0)
        _BUILT[arch] = (cfg, params, _carry(params))
    return _BUILT[arch]


def _port_model(arch):
    """``(cfg, port params)``: the port's own weights (port-only tests)."""
    key = ("port", arch)
    if key not in _BUILT:
        cfg, params, _ = port_build(_cfg(arch), 0, device="cpu")
        _BUILT[key] = (cfg, params)
    return _BUILT[key]


def _prompt(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _kw(**kw):
    base = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True,
                kv_block_size=4)
    base.update(kw)
    return base


def _reqs(cfg, n, seed=0, max_new=5, temperature=0.0):
    """``(uid, prompt, max_new, temperature, seed)`` of ``n`` requests, as
    the reference's ``_reqs`` draws them (top-k 50)."""
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 9))).astype(np.int32),
        max_new=int(rng.integers(2, max_new + 1)), temperature=temperature,
        top_k=50, seed=seed + i) for i in range(n)]


class _Pair:
    """The reference's engine (``ref``) and the port's (``port``) on the
    same weights and config, driven by one schedule; ``call`` applies one
    engine method to both and checks that they answered alike."""

    def __init__(self, arch, *, hooks=(None, None), **kw):
        cfg, rp, pp = _carried(arch)
        self.cfg = cfg
        self.ref = RS.ServeEngine(rp, cfg, RA.AnalogConfig(mode="off"),
                                  RS.SchedulerConfig(**_kw(**kw)),
                                  chaos_hook=hooks[0])
        self.port = PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="off"),
                                   PS.SchedulerConfig(**_kw(**kw)),
                                   chaos_hook=hooks[1])
        self.events = ([], [])

    def call(self, name, *args, **kw):
        """``getattr(engine, name)(*args)`` on both; a dict argument is a
        request, built for each package. Returns the port's answer."""
        out = []
        for eng, mod in ((self.ref, RS), (self.port, PS)):
            a = [mod.Request(**x) if isinstance(x, dict) else x
                 for x in args]
            out.append(getattr(eng, name)(*a, **kw))
        assert out[0] == out[1], (name, out)
        return out[1]

    def step(self):
        self.call("step")
        self.same()

    def run(self, reqs=()):
        for r in reqs:
            self.call("submit", r)
        while self.port.queue or self.port.num_active:
            self.step()
        assert not (self.ref.queue or self.ref.num_active)
        return self.port.results

    def age(self, uid):
        for eng in (self.ref, self.port):
            eng.submit_time[uid] -= 120.0

    def same(self):
        """Statuses, reasons, results, the event streams and the lifecycle
        counters are equal."""
        ref, port = self.ref, self.port
        assert port.status == ref.status
        assert port.errors == ref.errors
        assert sorted(port.results) == sorted(ref.results)
        for uid, toks in port.results.items():
            np.testing.assert_array_equal(toks, ref.results[uid])
        self.events[0].extend(ref.drain_events())
        self.events[1].extend(port.drain_events())
        assert self.events[1] == [(k, int(u), p if k == "done" else int(p))
                                  for k, u, p in self.events[0]]
        for name in COUNTERS:
            assert getattr(port, name) == getattr(ref, name), name
        _assert_conserved(port)


def _assert_conserved(eng):
    """Pool conservation and refcount bookkeeping, both pools."""
    for pool in (eng.pool, eng.state_pool):
        if pool is None:
            continue
        assert (pool.num_free + pool.num_cached + pool.num_live
                == pool.num_blocks), "block conservation broken"
        assert (sum(pool._ref.values())
                == sum(len(v) for v in pool._owned.values())), \
            "sum of refcounts != sum of owned blocks"


def _leaves(eng):
    """Every cache leaf of the engine and of its drafter."""
    out = [leaf for (leaf,) in PS._walk(eng.caches)]
    if eng.draft_caches is not None:
        out += [leaf for (leaf,) in PS._walk(eng.draft_caches)]
    return out


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

def test_cancel_at_every_stage_releases_everything():
    """A queued, a mid-prefill and a mid-decode cancel: each releases its
    blocks, keeps its partial output and counts; the engine then serves a
    fresh request as a fresh engine does. Both packages alike."""
    pair = _Pair("granite-3-8b", num_slots=2, max_len=48, prefill_chunk=4)
    cfg, port = pair.cfg, pair.port
    pair.call("submit", dict(uid=0, prompt=_prompt(cfg, 12), max_new=6,
                             temperature=0.0))
    pair.call("submit", dict(uid=1, prompt=_prompt(cfg, 4, seed=5),
                             max_new=8, temperature=0.0))
    pair.call("submit", dict(uid=2, prompt=_prompt(cfg, 4, seed=6),
                             max_new=4, temperature=0.0))
    assert port.status[2] == "queued"
    assert pair.call("cancel", 2)
    pair.same()
    assert port.status[2] == "cancelled" and len(port.results[2]) == 0
    pair.step()
    assert port.status[0] == "prefill"
    assert pair.call("cancel", 0)
    pair.same()
    assert port.status[0] == "cancelled"
    while port.status[1] != "decode":
        pair.step()
    assert pair.call("cancel", 1)
    pair.same()
    assert port.status[1] == "cancelled"
    assert 0 < len(port.results[1]) < 8
    assert port.pool.num_live == 0 and port.cancel_count == 3
    assert not pair.call("cancel", 1)
    probe = dict(uid=7, prompt=_prompt(cfg, 5), max_new=5, temperature=0.0)
    solo = PS.ServeEngine(port.params, cfg, PA.AnalogConfig(mode="off"),
                          port.scfg).run([PS.Request(**probe)])[7]
    after = pair.run([probe])[7]
    np.testing.assert_array_equal(solo, after)
    assert [e for e in pair.events[1] if e[1] == 7] == [
        ("token", 7, int(t)) for t in after] + [("done", 7, "finished")]


def test_deferred_cancel_mid_speculative_window():
    """A cancel between ``step_begin`` and ``step_commit`` of a speculative
    window (self drafter) waits for the commit: the slot stays live, the
    pool refuses the release, the commit retires it; conservation holds.
    The reference's engine takes the same steps and gives the same
    outcome."""
    pair = _Pair("granite-3-8b", num_slots=2, max_len=48, prefill_chunk=4,
                 speculative=True, draft="self", draft_k=3)
    cfg, port = pair.cfg, pair.port
    assert port.spec_enabled
    for r in _reqs(cfg, 2, max_new=12):
        pair.call("submit", r)
    for _ in range(30):
        pend = [pair.ref.step_begin(), pair.port.step_begin()]
        assert [p is None for p in pend] == [False, False]
        assert pend[1]["op"] == pend[0]["op"]
        if pend[1]["op"] == "spec":
            break
        pair.ref.step_commit(pend[0])
        pair.port.step_commit(pend[1])
        pair.same()
    assert pend[1]["op"] == "spec"
    row = pend[1]["decode_rows"][0]
    uid = port.slots[row].req.uid
    assert port.pool.in_window(uid)
    with pytest.raises(ValueError, match="rewind window"):
        port.pool.release(uid)
    assert pair.call("cancel", uid)
    assert port.status[uid] == "decode" and port.slots[row] is not None
    pair.ref.step_commit(pend[0])
    pair.port.step_commit(pend[1])
    pair.same()
    assert port.status[uid] in ("cancelled", "finished")
    assert not port.pool.in_window(uid)
    pair.run()
    assert port.pool.num_live == 0 and port.spec_steps == pair.ref.spec_steps


def test_kv_pool_release_in_window_raises():
    """``release`` inside an open window names the fix (``step_commit``);
    a second ``begin_window`` raises; after ``end_window`` it releases."""
    pool = KVPool(num_blocks=8, block_size=4)
    pool.alloc(1, 2)
    pool.alloc(2, 1)
    pool.begin_window([1])
    with pytest.raises(ValueError, match="step_commit"):
        pool.release(1)
    pool.release(2)
    with pytest.raises(ValueError, match="window already open"):
        pool.begin_window([2])
    pool.end_window()
    pool.release(1)
    assert pool.num_live == 0


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_ttft_deadline_times_out_queued_and_prefilling():
    pair = _Pair("granite-3-8b", num_slots=1, max_len=48)
    cfg, port = pair.cfg, pair.port
    pair.call("submit", dict(uid=0, prompt=_prompt(cfg, 12), max_new=4,
                             temperature=0.0, ttft_deadline=60.0))
    pair.call("submit", dict(uid=1, prompt=_prompt(cfg, 4, seed=5),
                             max_new=4, temperature=0.0, ttft_deadline=60.0))
    pair.step()
    assert port.status[0] == "prefill" and port.status[1] == "queued"
    pair.age(0)
    pair.age(1)
    pair.step()
    assert port.status[0] == "timed_out" and port.status[1] == "timed_out"
    assert "TTFT" in port.errors[0] and "queued" in port.errors[1]
    assert len(port.results[0]) == 0 and port.timeout_count == 2
    assert port.pool.num_live == 0


def test_e2e_deadline_preserves_partial_output():
    pair = _Pair("granite-3-8b", max_len=48)
    cfg, port = pair.cfg, pair.port
    pair.call("submit", dict(uid=0, prompt=_prompt(cfg, 4), max_new=24,
                             temperature=0.0, deadline=60.0))
    while port.status[0] != "decode":
        pair.step()
    pair.step()
    n = len(port.results.get(0, ()))
    pair.age(0)
    pair.step()
    assert port.status[0] == "timed_out"
    assert len(port.results[0]) >= max(1, n)
    assert "end-to-end deadline" in port.errors[0]
    assert port.num_active == 0 and port.pool.num_live == 0


# ---------------------------------------------------------------------------
# shedding
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_with_reason_and_books_balance():
    """``try_submit`` past ``max_queue`` sheds with the reference's reason,
    a request that can never fit is shed with its own, and every uid
    reaches one terminal status."""
    pair = _Pair("granite-3-8b", num_slots=1, max_queue=2)
    cfg, port = pair.cfg, pair.port
    big = dict(uid=99, prompt=_prompt(cfg, 4), max_new=999, temperature=0.0)
    assert "max_len" in pair.call("try_submit", big)
    reqs = _reqs(cfg, 6, max_new=3)
    reasons = [pair.call("try_submit", r) for r in reqs]
    pair.same()
    assert sum(r is None for r in reasons) == 2
    assert all("queue full" in r for r in reasons if r is not None)
    assert port.submitted == 7 and port.shed_count == 5
    pair.run()
    assert sorted(port.status[r["uid"]] for r in reqs) == (
        ["finished"] * 2 + ["shed"] * 4)
    assert port.submitted == 7 == (
        sum(s == "finished" for s in port.status.values())
        + port.shed_count)


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

class _Chaos:
    """Scripted fault injector: raise on the n-th visit to one point;
    ``on_raise`` runs just before."""

    def __init__(self, point, at=1, exc=RuntimeError, on_raise=None):
        self.point, self.at, self.exc = point, at, exc
        self.on_raise = on_raise
        self.seen = 0

    def __call__(self, point):
        if point == self.point:
            self.seen += 1
            if self.seen == self.at:
                if self.on_raise is not None:
                    self.on_raise()
                raise self.exc(f"chaos: injected {point} fault")


@pytest.mark.parametrize("draft", [None, "int4"])
def test_chaos_dispatch_fault_errored_then_keeps_serving(draft):
    """A fault at the third dispatch: the in-flight requests end
    ``errored`` with the reason, and the reset is in place: every cache
    leaf (the drafter's too) keeps its storage and is zeroed, as a fresh
    engine's. The engine then serves a probe as a healthy engine does; the
    reference's engine gives the same outcome."""
    spec = dict(speculative=True, draft=draft) if draft else {}
    ptrs = {}

    def record():
        ptrs.update((i, leaf.data_ptr())
                    for i, leaf in enumerate(_leaves(pair.port)))

    hooks = (_Chaos("dispatch", at=3), _Chaos("dispatch", at=3,
                                              on_raise=record))
    pair = _Pair("granite-3-8b", hooks=hooks, **spec)
    cfg, port = pair.cfg, pair.port
    res = pair.run(_reqs(cfg, 2, max_new=8))
    assert hooks[1].seen >= 3 and port.fault_count == 1
    errored = [u for u in (0, 1) if port.status[u] == "errored"]
    assert errored
    for u in errored:
        assert "chaos: injected dispatch fault" in port.errors[u]
        assert u in res
    leaves = _leaves(port)
    assert {i: leaf.data_ptr() for i, leaf in enumerate(leaves)} == ptrs
    assert all(not leaf.any() for leaf in leaves)
    probe = dict(uid=50, prompt=_prompt(cfg, 5), max_new=5, temperature=0.0)
    healthy = PS.ServeEngine(port.params, cfg, port.acfg, port.scfg).run(
        [PS.Request(**probe)])[50]
    np.testing.assert_array_equal(pair.run([probe])[50], healthy)


def test_chaos_without_tolerance_flag_still_degrades():
    """A chaos hook implies fault tolerance; a bare engine re-raises a
    fault raised in a step, and ``fault_tolerant=True`` alone degrades."""
    cfg, _, pp = _carried("granite-3-8b")
    acfg = PA.AnalogConfig(mode="off")
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(**_kw()))
    assert not eng._tolerant
    hooked = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(**_kw()),
                            chaos_hook=_Chaos("dispatch", at=10 ** 9))
    assert hooked._tolerant
    tolerant = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        **_kw(fault_tolerant=True)))
    for e in (eng, tolerant):
        e._chaos = _Chaos("dispatch")
        e.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=3,
                            temperature=0.0))
    with pytest.raises(RuntimeError, match="chaos"):
        eng.step()
    tolerant.step()
    assert tolerant.status[0] == "errored" and tolerant.fault_count == 1
    assert tolerant.pool.num_live == 0


def test_chaos_allocator_fault_sheds_head_only():
    pair = _Pair("granite-3-8b", num_slots=1,
                 hooks=(_Chaos("alloc", at=2, exc=MemoryError),
                        _Chaos("alloc", at=2, exc=MemoryError)))
    cfg, port = pair.cfg, pair.port
    reqs = _reqs(cfg, 3, max_new=3)
    pair.run(reqs)
    assert sorted(port.status[r["uid"]] for r in reqs) == [
        "finished", "finished", "shed"]
    shed = next(r["uid"] for r in reqs if port.status[r["uid"]] == "shed")
    assert "allocator fault at admission" in port.errors[shed]
    assert port.shed_count == 1 and port.fault_count == 0


_HEALTH_DCFG = RD.DeviceConfig(sigma_gain=0.02, nu_median=0.1, nu_sigma=0.3)


def _health_chip():
    """Reduced granite-3-8b with the reference's test's device state, as
    the reference's tree (memoized)."""
    if "health" not in _BUILT:
        cfg = get_config("granite-3-8b").reduce()
        rp, labels = _ref_model(cfg, 0)
        _BUILT["health"] = (cfg, _ref_attach(rp, labels, 7, _HEALTH_DCFG))
    return _BUILT["health"]


def _health_engine(mod, recalibrate, hook=None, **kw):
    """An engine of package ``mod`` (RS or PS) on that chip: contiguous
    cache, drift 4 h a step, the watchdog every step."""
    cfg, dp = _health_chip()
    params = dp if mod is RS else _carry(dp)
    acfg = (RA if mod is RS else PA).AnalogConfig(mode="analog")
    return mod.ServeEngine(params, cfg, acfg, mod.SchedulerConfig(
        num_slots=2, max_len=48, prefill_chunk=4, drift_dt=4.0,
        recalibrate=recalibrate, recal_interval=1, recal_threshold=0.05,
        **kw), chaos_hook=hook)


def test_chaos_corrupted_health_read_skips_watchdog(monkeypatch):
    """A raising health read skips that watchdog check (counted in
    ``health_faults``, no decision on it) while serving completes: with
    the clock only, the port and the reference skip and check alike and
    serve the same tokens (health reads within SCALE_ERR_TOL); with
    recalibration, every read but the faulted one checks, as the
    reference's test asks. A non-finite read is skipped alike, and raises
    on an engine that is not fault-tolerant."""
    cfg, _ = _health_chip()
    hooks = (_Chaos("health"), _Chaos("health"))
    ref = _health_engine(RS, False, hooks[0])
    port = _health_engine(PS, False, hooks[1])
    reqs = _reqs(cfg, 2, max_new=6)
    ref.run([RS.Request(**r) for r in reqs])
    res = port.run([PS.Request(**r) for r in reqs])
    assert port.health_faults == ref.health_faults == 1
    assert port.step_faults == ref.step_faults
    assert port.watchdog_checks == ref.watchdog_checks == hooks[1].seen - 1
    assert abs(port.tile_scale_err - ref.tile_scale_err) < SCALE_ERR_TOL
    for u, toks in res.items():
        assert port.status[u] == ref.status[u] == "finished"
        np.testing.assert_array_equal(toks, ref.results[u])

    hook = _Chaos("health")
    port = _health_engine(PS, True, hook)
    assert port.drift_enabled
    res = port.run([PS.Request(**dict(r, temperature=0.8)) for r in reqs])
    assert all(len(v) > 0 for v in res.values())
    assert port.health_faults >= 1
    assert all(port.status[u] == "finished" for u in res)
    assert port.watchdog_checks == hook.seen - 1

    health = PD.health
    calls = []

    def nan_second(params):
        calls.append(1)
        h = health(params)
        return dict(h, mean_scale_err=float("nan")) if len(calls) == 2 else h

    monkeypatch.setattr(PD, "health", nan_second)
    port = _health_engine(PS, False, fault_tolerant=True)
    port.run([PS.Request(**r) for r in reqs])
    assert port.health_faults == 1 and "non-finite" in port.step_faults[0]
    assert np.isfinite(port.tile_scale_err)
    calls.clear()
    strict = _health_engine(PS, False)
    with pytest.raises(ValueError, match="non-finite"):
        strict.run([PS.Request(**r) for r in reqs])


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------

def _churn_reqs(cfg, seed, temperature):
    """Six requests; every third carries deadlines the churn can age."""
    return [dict(r, deadline=60.0, ttft_deadline=60.0) if r["uid"] % 3 == 0
            else r for r in _reqs(cfg, 6, seed=seed, max_new=4,
                                  temperature=temperature)]


def _churn_events(rng, status, pending, apply):
    """One random churn event, as the reference's ``_churn`` draws it:
    0 submit, 1 cancel a live request, 2 age a deadline-carrying one, 3
    nothing. ``apply(kind, arg)`` performs it; returns the disturbed uid."""
    ev = rng.integers(0, 4)
    if ev == 0 and pending:
        apply("try_submit", pending.pop(0))
    elif ev == 1:
        live = [u for u, s in status.items()
                if s in ("queued", "prefill", "decode")]
        if live:
            u = int(rng.choice(live))
            apply("cancel", u)
            return u
    elif ev == 2:
        live = [u for u, s in status.items()
                if s in ("queued", "prefill", "decode") and u % 3 == 0]
        if live:
            u = int(rng.choice(live))
            apply("age", u)
            return u
    return None


def _churn(cfg, params, seed, temperature=0.8):
    """The port's engine under a seeded churn: conservation after every
    event, every uid one terminal status, and the undisturbed finished
    requests equal to the port's closed-loop run of the workload."""
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(**_kw(max_queue=4))
    reqs = _churn_reqs(cfg, seed, temperature)
    ref = PS.ServeEngine(params, cfg, acfg, scfg).run(
        [PS.Request(**r) for r in reqs])
    rng = np.random.default_rng(seed)
    eng = PS.ServeEngine(params, cfg, acfg, scfg)
    pending = list(reqs)
    disturbed: set = set()

    def apply(kind, arg):
        if kind == "try_submit":
            eng.try_submit(PS.Request(**arg))
        elif kind == "cancel":
            eng.cancel(arg)
        else:
            eng.submit_time[arg] -= 120.0

    while pending or eng.num_active or eng.queue_depth:
        u = _churn_events(rng, eng.status, pending, apply)
        if u is not None:
            disturbed.add(u)
        eng.step()
        _assert_conserved(eng)
        assert eng.queue_high_water <= scfg.max_queue
    for pool in (eng.pool, eng.state_pool):
        if pool is not None:
            assert pool.num_live == 0
    assert all(eng.status[r["uid"]] in PS.TERMINAL for r in reqs)
    assert eng.fault_count == 0
    for r in reqs:
        if eng.status[r["uid"]] == "finished" and r["uid"] not in disturbed:
            np.testing.assert_array_equal(eng.results[r["uid"]],
                                          ref[r["uid"]])


@pytest.mark.parametrize("arch", FAMILIES)
def test_churn_conservation_and_survivor_parity(arch):
    cfg, params = _port_model(arch)
    _churn(cfg, params, seed=2)


@pytest.mark.parametrize("arch", CROSS)
def test_churn_matches_reference_engine(arch):
    """The same churn schedule on the reference's engine and the port's,
    in lockstep at temperature 0: equal statuses, reasons, results, events
    and counters after every event and step."""
    pair = _Pair(arch, max_queue=4)
    reqs = _churn_reqs(pair.cfg, 2, 0.0)
    rng = np.random.default_rng(2)
    pending = list(reqs)

    def apply(kind, arg):
        if kind == "age":
            pair.age(arg)
        else:
            pair.call(kind, arg)

    while pending or pair.port.num_active or pair.port.queue_depth:
        _churn_events(rng, pair.port.status, pending, apply)
        pair.step()
    assert all(pair.port.status[r["uid"]] in PS.TERMINAL for r in reqs)
    assert {s for s in pair.port.status.values()} - {"finished"}


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 1000))
def test_churn_conservation_property(seed):
    cfg, params = _port_model("granite-3-8b")
    _churn(cfg, params, seed)


# ---------------------------------------------------------------------------
# the step split and the stream (the port's own)
# ---------------------------------------------------------------------------

def _engine(**kw):
    cfg, _, pp = _carried("granite-3-8b")
    return cfg, PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="off"),
                               PS.SchedulerConfig(**_kw(**kw)))


def test_step_begin_twice_and_foreign_commit_raise():
    cfg, eng = _engine()
    eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=3,
                          temperature=0.0))
    pending = eng.step_begin()
    assert pending is not None and pending["op"] == "mixed"
    with pytest.raises(RuntimeError, match="already in flight"):
        eng.step_begin()
    with pytest.raises(RuntimeError, match="not the one in flight"):
        eng.step_commit(dict(eng._inflight))
    eng.step_commit(eng._inflight)
    assert eng._inflight is None
    with pytest.raises(RuntimeError, match="not the one in flight"):
        eng.step_commit({"op": "decode"})
    eng.run()
    assert eng.status[0] == "finished"


def test_cancel_from_another_thread_writes_on_the_engine_stream(
        monkeypatch):
    """The current stream is thread-local: a cancel that another thread
    makes on an idle engine must issue its device writes (the retired
    slot's rows) on the engine's stream, not on that thread's. A recorded
    stand-in for ``torch.cuda.stream`` shows which stream each write of
    ``_reset_slot`` ran under."""
    local = threading.local()

    class FakeStream:
        def __init__(self, name):
            self.name = name

        def synchronize(self):
            pass

    class enter:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            self.prev = getattr(local, "stream", None)
            local.stream = self.stream

        def __exit__(self, *exc):
            local.stream = self.prev

    monkeypatch.setattr(torch.cuda, "stream", enter)
    cfg, eng = _engine()
    eng._stream = FakeStream("engine")
    writes = []
    reset = eng._reset_slot

    def recorded(*a, **kw):
        writes.append((threading.current_thread().name,
                       getattr(getattr(local, "stream", None), "name",
                               None)))
        return reset(*a, **kw)

    eng._reset_slot = recorded
    eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 6), max_new=8,
                          temperature=0.0))
    eng.step()
    worker = threading.Thread(target=eng.cancel, args=(0,), name="client")
    worker.start()
    worker.join()
    assert eng.status[0] == "cancelled"
    assert writes == [("MainThread", "engine"), ("client", "engine")]
    assert getattr(local, "stream", None) is None


def test_fault_reset_failure_propagates():
    """A fault whose reset itself fails (as a CUDA error poisons the
    context for good) is raised from the step, not swallowed, and the
    engine does not loop on it."""
    cfg, eng = _engine(fault_tolerant=True)

    def poisoned():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    class Stream:
        synchronize = staticmethod(poisoned)

    eng._stream = Stream()
    eng._on_stream = contextlib.nullcontext
    eng._chaos = _Chaos("dispatch")
    eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=3,
                          temperature=0.0))
    with pytest.raises(RuntimeError, match="illegal memory access") as e:
        eng.run()
    assert "chaos" in str(e.value.__context__)
    assert eng.fault_count == 1 and eng.status[0] == "errored"
