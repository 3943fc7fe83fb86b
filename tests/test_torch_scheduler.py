"""The port's continuous-batching engine (``repro_torch.serve.scheduler``)
against the JAX package's, on reduced llama-3.2-1b and phi-3-mini-4k.

Weights are built by the reference from a JAX key and carried across as
numpy (``params_from_numpy``); the hw noise instance of ``analog_hw`` is
drawn once by the reference and applied on both sides. The reference's
engine runs with ``prefix_cache=False`` (greedy decode with the prefix cache
is bitwise equal to decode without it; ``tests/test_torch_prefix_cache.py``
holds the port's prefix cache against the reference's). Its
digital_int4 counterpart is its unfused RTN-W4 path, which its own suite
holds equal to the packed-int4 kernel.

* Greedy tokens equal the reference's, for ``off``, ``analog_hw`` and
  ``digital_int4``, per-slot contiguous and paged, under slot churn; so do
  the scheduling counters (decode steps, fused mixed steps, the per-step
  token split). The int8 pool gives the reference's int8 tokens.
* The reference's engine invariants, held for the port's engine (from
  ``tests/test_scheduler.py``): left-padded prefill equals ``generate``;
  paged equals contiguous bit for bit (sampled requests too); a request
  admitted mid-decode or streamed in through fused mixed steps gives its
  solo tokens; stop tokens; ``greedy_first`` and ``top_k = 1``; the token
  budget split with no starvation; out-of-blocks backpressure; block
  conservation; ``submit``'s capacity checks.
* Tensor parallelism runs (gated to tp = 1 on one device without shard
  devices; ``tests/test_torch_tp_serve.py`` holds it); the prefix cache
  and the request lifecycle run; the drift clock and the watchdog gate as
  the reference's on params without device state.

Sampling randomness does not cross between the packages, so sampled
requests are held only to the port's own contracts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.models import build as ref_build
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.models import build as port_build
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

ARCHS = ["llama-3.2-1b", "phi-3-mini-4k"]
DEPLOYS = ["off", "analog_hw", "digital_int4"]


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params/labels/hw instance, port params/instance)."""
    cfg = get_config(request.param).reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
    inst = ref_analog.sample_noise_instances(params, labels,
                                             jax.random.PRNGKey(1), "hw")
    return (cfg, params, labels, inst,
            params_from_numpy(_ref_flat(params), "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


def _deploy(carried, deploy, kv_bits=0):
    """(reference params, acfg, port params, acfg) of one deployment."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "off":
        out = (params, ref_analog.AnalogConfig(mode="off"), pp,
               PA.AnalogConfig(mode="off"))
    elif deploy == "analog_hw":
        out = (ref_analog.apply_noise_instances(params, labels, inst, "hw"),
               ref_analog.AnalogConfig(mode="analog", train_noise=False),
               PA.apply_noise_instances(pp, plabels, pinst, "hw"),
               PA.AnalogConfig(mode="analog", train_noise=False))
    else:
        out = (params, ref_analog.AnalogConfig(mode="rtn", weight_bits=4),
               PA.pack_int4_weights(pp, plabels),
               port_decode.digital_int4_config(
                   PA.AnalogConfig(weight_bits=4)))
    rp, racfg, tp, tacfg = out
    return (rp, dataclasses.replace(racfg, kv_bits=kv_bits), tp,
            dataclasses.replace(tacfg, kv_bits=kv_bits))


def _prompt(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def _churn(cfg, temperature=0.0):
    """More requests than slots, mixed lengths (1 to 3 chunks of 4)."""
    return [dict(uid=i, prompt=_prompt(cfg, 3 + 2 * i, seed=i),
                 max_new=4 + i % 3, temperature=temperature, top_k=5,
                 seed=i) for i in range(5)]


def _run_port(params, cfg, acfg, scfg, reqs):
    eng = PS.ServeEngine(params, cfg, acfg, scfg)
    return eng, eng.run([PS.Request(**r) for r in reqs])


def _eq(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=str(uid))


@pytest.mark.parametrize("deploy", DEPLOYS)
def test_greedy_tokens_and_schedule_match_reference(carried, deploy):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    reqs = _churn(cfg)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4)
    ref = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(
        prefix_cache=False, **geo))
    want = ref.run([RS.Request(**r) for r in reqs])
    for paged in (False, True):
        eng, got = _run_port(tp, cfg, tacfg,
                             PS.SchedulerConfig(paged=paged, **geo), reqs)
        _eq(got, want)
        assert (eng.decode_steps, eng.mixed_steps,
                eng.decode_tokens_during_admission, eng.prefill_chunks) == (
            ref.decode_steps, ref.mixed_steps,
            ref.decode_tokens_during_admission, ref.prefill_chunks)
        assert list(eng.step_token_log) == list(ref.step_token_log)


def test_int8_pool_matches_reference(carried):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, "off", kv_bits=8)
    reqs = _churn(cfg)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True,
               kv_block_size=4)
    want = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(
        prefix_cache=False, **geo)).run([RS.Request(**r) for r in reqs])
    eng, got = _run_port(tp, cfg, tacfg, PS.SchedulerConfig(**geo), reqs)
    assert eng.caches["kp"].dtype == torch.int8 and "ks" in eng.caches
    _eq(got, want)


def test_left_padded_prefill_matches_generate(carried):
    """Engine greedy decode (chunk 4, prompt of 5: 3 left pads) equals the
    unpadded static ``generate``."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    prompt = _prompt(cfg, 5)
    for paged in (False, True):
        _, out = _run_port(tp, cfg, acfg, PS.SchedulerConfig(
            num_slots=2, max_len=32, prefill_chunk=4, paged=paged,
            kv_block_size=4), [dict(uid=0, prompt=prompt, max_new=6,
                                    temperature=0.0)])
        want = port_decode.generate(tp, cfg, acfg, None,
                                    torch.from_numpy(prompt[None]).long(), 6,
                                    greedy_first=6)
        np.testing.assert_array_equal(out[0], want[0].numpy())


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_sampled_paged_equals_contiguous_and_is_seeded(carried, paged):
    """Sampled requests under churn: paged equals contiguous bit for bit,
    and a rerun draws the same tokens."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    reqs = _churn(cfg, temperature=0.9)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4)
    _, a = _run_port(tp, cfg, acfg, PS.SchedulerConfig(paged=paged, **geo),
                     reqs)
    _, b = _run_port(tp, cfg, acfg, PS.SchedulerConfig(paged=not paged,
                                                       **geo), reqs)
    _, c = _run_port(tp, cfg, acfg, PS.SchedulerConfig(paged=paged, **geo),
                     reqs)
    _eq(a, b)
    _eq(a, c)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_mid_decode_admission_parity(carried, paged):
    """A sampled request admitted into a busy batch gives its solo tokens
    (per-request noise and decode-block partitioning covered)."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=3, max_len=48, prefill_chunk=4,
                              decode_block=4, paged=paged, kv_block_size=4)
    target = PS.Request(uid=99, prompt=_prompt(cfg, 6), max_new=8,
                        temperature=0.9, top_k=17, top_p=0.95, seed=42)
    solo = PS.ServeEngine(tp, cfg, acfg, scfg).run([target])[99]
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    for i in range(3):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                              max_new=3 + 2 * i, temperature=1.1, seed=i))
    for _ in range(2):
        eng.step()
    eng.submit(target)
    out = eng.run()
    np.testing.assert_array_equal(solo, out[99])
    assert sorted(out) == [0, 1, 2, 99]


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_piggybacked_prefill_parity(carried, paged):
    """A multi-chunk prompt streamed in through fused mixed steps while
    other slots decode gives its solo greedy tokens, and decode tokens keep
    flowing during its admission."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=3, max_len=48, prefill_chunk=4,
                              decode_block=4, paged=paged, kv_block_size=4)
    target = PS.Request(uid=99, prompt=_prompt(cfg, 11), max_new=6,
                        temperature=0.0)
    solo = PS.ServeEngine(tp, cfg, acfg, scfg).run([target])[99]
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    for i in range(2):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                              max_new=12, temperature=0.0))
    for _ in range(3):
        eng.step()
    assert eng.decode_steps > 0
    eng.submit(target)
    out = eng.run()
    np.testing.assert_array_equal(solo, out[99])
    assert sorted(out) == [0, 1, 99]
    assert eng.mixed_steps >= 3
    assert eng.decode_tokens_during_admission > 0


def test_stop_tokens_greedy_first_and_top_k_one(carried):
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=2, max_len=32, prefill_chunk=4)
    prompt = _prompt(cfg, 4)

    def run(**kw):
        return PS.ServeEngine(tp, cfg, acfg, scfg).run(
            [PS.Request(uid=0, prompt=prompt, **kw)])[0]

    free = run(max_new=8, temperature=0.0)
    stop = int(free[2])
    stopped = run(max_new=8, temperature=0.0, stop_tokens=(stop,))
    first = int(np.flatnonzero(free == stop)[0])
    assert len(free) == 8
    assert len(stopped) == first + 1 and stopped[-1] == stop
    np.testing.assert_array_equal(stopped, free[:first + 1])
    gf = [run(max_new=8, temperature=1.3, greedy_first=8, seed=s)
          for s in (1, 2)]
    np.testing.assert_array_equal(gf[0], free)
    np.testing.assert_array_equal(gf[1], free)
    np.testing.assert_array_equal(
        run(max_new=8, temperature=0.7, top_k=1, seed=5), free)


def test_token_budget_split_and_no_starvation(carried):
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    chunk = 4
    scfg = PS.SchedulerConfig(num_slots=4, max_len=48, prefill_chunk=chunk,
                              step_tokens=8)
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    for i in range(4):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3, seed=i),
                              max_new=14, temperature=0.0))
    for _ in range(4):
        eng.step()
    for i in range(4, 8):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 9, seed=i),
                              max_new=4, temperature=0.0))
    eng.run()
    assert sorted(eng.results) == list(range(8))
    assert [(d, p) for d, p in eng.step_token_log if d and p]
    for d, p in eng.step_token_log:
        assert d + p <= max(scfg.step_tokens, d + chunk)
        if p:
            assert p % chunk == 0 and p // chunk <= max(
                1, (scfg.step_tokens - d) // chunk)


def test_out_of_blocks_backpressure_and_conservation(carried):
    """An undersized pool defers admission (FIFO) and still completes every
    request with the roomy pool's tokens; every block comes back."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    reqs = [dict(uid=i, prompt=_prompt(cfg, 4, seed=i), max_new=4,
                 temperature=0.0) for i in range(4)]
    roomy = PS.SchedulerConfig(num_slots=4, max_len=16, prefill_chunk=4,
                               paged=True, kv_block_size=4)
    _, want = _run_port(tp, cfg, acfg, roomy, reqs)
    eng = PS.ServeEngine(tp, cfg, acfg, dataclasses.replace(roomy,
                                                            kv_blocks=5))
    total = eng.pool.num_blocks
    for r in reqs:
        eng.submit(PS.Request(**r))
    max_in_flight = 0
    while eng.queue or eng.num_active:
        eng.step()
        max_in_flight = max(max_in_flight, eng.num_active)
        assert eng.pool.num_live <= 5
        # the prefix cache (on by default) keeps released prompt blocks
        assert (eng.pool.num_live + eng.pool.num_free
                + eng.pool.num_cached == total)
    assert max_in_flight <= 2
    _eq(eng.results, want)
    assert eng.pool.num_live == 0
    assert eng.pool.num_free + eng.pool.num_cached == total
    # retired slots point at the sink
    assert int(eng.caches["tbl"].abs().sum()) == 0


def test_submit_validates_capacity(carried):
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    eng = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(
        num_slots=1, max_len=16, prefill_chunk=8))
    with pytest.raises(ValueError):
        eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=16))
    with pytest.raises(ValueError):
        eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=0))
    eng = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(
        num_slots=1, max_len=16, prefill_chunk=8, paged=True,
        kv_block_size=4, kv_blocks=1))
    with pytest.raises(ValueError):
        eng.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4), max_new=4))


@pytest.mark.parametrize("field,value", [
    ("max_queue", 4), ("fault_tolerant", True), ("tp", 2)])
def test_unported_features_raise(carried, field, value):
    """None of these raises any more: ``max_queue`` and
    ``fault_tolerant``, the request lifecycle's, run since it was ported
    (``tests/test_torch_lifecycle.py`` holds them against the reference),
    and ``tp`` since tensor parallelism was: on the CPU, one device, with
    no shard devices given, it is gated with the reference's
    too-few-devices reason and the engine serves at tp = 1
    (``tests/test_torch_tp_serve.py``)."""
    cfg, _, _, _, tp, _ = carried
    scfg = dataclasses.replace(PS.SchedulerConfig(), **{field: value})
    eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"), scfg)
    if field == "tp":
        assert eng.mesh is None
        assert "devices" in eng.gating_reasons["tensor_parallel"]
    assert eng._tolerant == (field == "fault_tolerant")
    out = eng.run([PS.Request(uid=0, prompt=_prompt(cfg, 5), max_new=4,
                              temperature=0.0)])
    assert len(out[0]) == 4 and eng.status[0] == "finished"
    assert eng.submitted == 1 and eng.queue_high_water == 1


def test_prefix_cache_is_ported(carried):
    """The former ``prefix_cache`` case of ``test_unported_features_raise``:
    asking for the prefix cache no longer raises. It is on by default and
    runs on the paged engine: a repeated prompt hits and gives its first
    run's tokens."""
    cfg, _, _, _, tp, _ = carried
    assert PS.SchedulerConfig().prefix_cache
    eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"),
                         PS.SchedulerConfig(num_slots=2, max_len=32,
                                            prefill_chunk=4, paged=True,
                                            kv_block_size=4))
    assert eng.prefix_enabled and not eng.gating_reasons
    p = _prompt(cfg, 9)
    first = eng.run([PS.Request(uid=0, prompt=p, max_new=4,
                                temperature=0.0)])[0]
    again = eng.run([PS.Request(uid=1, prompt=p, max_new=4,
                                temperature=0.0)])[1]
    np.testing.assert_array_equal(first, again)
    assert eng.prefix_hits == 1 and eng.prefix_skipped_tokens == 8


def test_speculative_is_ported(carried):
    """The former ``speculative`` case of ``test_unported_features_raise``:
    asking for speculative decoding no longer raises. On the dense family
    the engine runs draft-and-verify windows with each drafter and gives
    the non-speculative greedy tokens (``tests/test_torch_speculative.py``
    holds the rest)."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, paged=True,
               kv_block_size=4)
    req = PS.Request(uid=0, prompt=_prompt(cfg, 6), max_new=9,
                     temperature=0.0)
    base = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(**geo)).run(
        [req])[0]
    for draft in ("ngram", "self", "int4"):
        eng = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(
            speculative=True, draft=draft, **geo))
        assert eng.spec_enabled and not eng.gating_reasons
        np.testing.assert_array_equal(eng.run([req])[0], base)
        assert eng.spec_steps > 0


@pytest.mark.parametrize("field,value,gated", [
    ("drift_dt", 0.5, {"drift"}),
    ("recalibrate", True, {"recalibrate"})])
def test_drift_and_recalibrate_gate_without_device_state(carried, field,
                                                         value, gated):
    """The reference's gating: on params without per-tile device state the
    drift clock is inert (``gating_reasons["drift"]``), and without a
    running clock so is the watchdog (``["recalibrate"]``); the engine
    serves as without them. ``tests/test_torch_devices_engine.py`` holds
    both running. The engine is not paged, so the prefix cache, on by
    default, is gated too (as the reference's)."""
    cfg, _, _, _, tp, _ = carried
    scfg = dataclasses.replace(PS.SchedulerConfig(num_slots=2, max_len=32,
                                                  prefill_chunk=8),
                               **{field: value})
    eng = PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"), scfg)
    assert set(eng.gating_reasons) == gated | {"prefix_cache"}
    assert not eng.drift_enabled and not eng.recal_enabled
    out = eng.run([PS.Request(uid=0, prompt=_prompt(cfg, 5), max_new=4,
                              temperature=0.0)])
    assert len(out[0]) == 4 and eng.drift_hours == 0.0
    assert eng.watchdog_checks == eng.recal_count == 0


def test_unported_lifecycle_and_families_raise(carried):
    """Tensor parallelism runs (gated to tp = 1 on one device); the
    request lifecycle runs (a chaos hook
    is called at its points, deadlines are accepted and a request within
    them finishes); the moe family is served, the vlm and audio families
    are not; every reference field is kept, in its order, with the
    reference's defaults but for the type of ``cache_dtype``."""
    cfg, _, _, _, tp, _ = carried
    acfg = PA.AnalogConfig(mode="off")
    gated = PS.ServeEngine(tp, cfg, acfg, PS.SchedulerConfig(tp=2))
    assert "tp=2 needs 2 devices" in gated.gating_reasons["tensor_parallel"]
    points = []
    eng = PS.ServeEngine(tp, cfg, acfg, chaos_hook=points.append)
    assert eng._tolerant
    for uid, kw in enumerate((dict(deadline=60.0),
                              dict(ttft_deadline=60.0))):
        eng.submit(PS.Request(uid=uid, prompt=_prompt(cfg, 4), max_new=3,
                              temperature=0.0, **kw))
    out = eng.run()
    assert all(len(out[u]) == 3 and eng.status[u] == "finished"
               for u in (0, 1))
    assert {"alloc", "dispatch"} <= set(points)
    assert eng.timeout_count == eng.fault_count == 0
    # the moe family is served (tests/test_torch_moe.py holds its engines
    # against the reference, tests/test_torch_hybrid_engine.py the hybrid
    # family's); the vlm and audio families are not served by this engine
    # in either package
    moe = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduce(),
                              capacity_factor=4.0)
    _, mp, _ = port_build(moe, 0, device="cpu")
    out = PS.ServeEngine(mp, moe, acfg, PS.SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=4, paged=True,
        kv_block_size=4)).run([PS.Request(uid=0, prompt=_prompt(moe, 5),
                                          max_new=3, temperature=0.0)])
    assert len(out[0]) == 3 and all(0 <= t < moe.vocab_size for t in out[0])
    for arch in ("internvl2-2b", "musicgen-medium"):
        with pytest.raises(NotImplementedError,
                           match="continuous batching is not wired"):
            PS.ServeEngine(tp, get_config(arch).reduce(), acfg)
    # the port keeps every reference field, in its order; the defaults
    # differ only where a feature is not ported
    ours, theirs = PS.SchedulerConfig(), RS.SchedulerConfig()
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    assert ours.prefix_cache == theirs.prefix_cache
    for name in ("cache_salt", "state_snapshots", "speculative", "draft_k",
                 "draft", "draft_layers", "drift_dt", "recalibrate",
                 "recal_interval", "recal_threshold", "max_queue",
                 "fault_tolerant", "tp"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert ([f.name for f in dataclasses.fields(PS.Request)]
            == [f.name for f in dataclasses.fields(RS.Request)])


def test_batched_sampler_rows_are_independent():
    """Each row's draw depends on its own logits, parameters and noise row
    only; top-k = 1 and tiny top-p reduce to argmax; draws stay inside the
    top-k set; the noise of a (seed, count) pair is reproducible."""
    from repro_torch.serve.sampling import (request_uniforms,
                                            sample_logits_batched)

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 64, generator=g)
    u = request_uniforms([1, 2, 3, 4], [0, 5, 0, 7], 64, "cpu")
    assert torch.equal(u, request_uniforms([1, 2, 3, 4], [0, 5, 0, 7], 64,
                                           "cpu"))
    assert not torch.equal(u[0], request_uniforms([1], [1], 64, "cpu")[0])
    temp = torch.tensor([1.0, 0.7, 1.3, 0.9])
    topk = torch.tensor([0, 8, 1, 5])
    topp = torch.tensor([1.0, 1.0, 1.0, 1e-6])
    greedy = torch.zeros(4, dtype=torch.bool)
    out = sample_logits_batched(logits, temp, topk, topp, greedy, u)
    for i in range(4):
        solo = sample_logits_batched(logits[i:i + 1], temp[i:i + 1],
                                     topk[i:i + 1], topp[i:i + 1],
                                     greedy[i:i + 1], u[i:i + 1])
        assert int(solo[0]) == int(out[i])
    arg = torch.argmax(logits, -1)
    assert int(out[2]) == int(arg[2]) and int(out[3]) == int(arg[3])
    assert int(out[1]) in torch.topk(logits[1], 8).indices.tolist()
    assert torch.equal(sample_logits_batched(
        logits, temp, topk, topp, torch.ones(4, dtype=torch.bool), u), arg)


def test_batched_sampler_distribution():
    """Gumbel-max over the filtered logits draws from their softmax."""
    from repro_torch.serve.sampling import (request_uniforms,
                                            sample_logits_batched)

    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -3.0]])
    n = 4000
    draws = torch.cat([sample_logits_batched(
        logits, torch.tensor([0.8]), torch.tensor([3]), torch.tensor([1.0]),
        torch.zeros(1, dtype=torch.bool),
        request_uniforms([0], [c], 5, "cpu")) for c in range(n)])
    freq = torch.bincount(draws, minlength=5).float() / n
    want = torch.softmax(logits[0, :3] / 0.8, -1)
    assert freq[3:].sum() == 0
    assert torch.allclose(freq[:3], want, atol=0.03)
