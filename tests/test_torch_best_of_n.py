"""The port's best-of-n harness (``repro_torch.serve.engine``,
``repro_torch.serve.prm``) against the JAX package's, on reduced
llama-3.2-1b and phi-3-mini-4k.

* ``select_answer`` and ``best_of_n_accuracy`` give the reference's numbers
  exactly on the cases of ``tests/test_data_serve.py`` (the PRM draws from
  numpy in both packages).
* Greedy ``sample_candidates`` (``greedy_first = max_new``) gives the
  reference's answers for ``max_new`` 1 and 3 with ``extract_before_stop``
  and a stop token, on the paged and the contiguous engine, under ``off``,
  ``analog_hw`` (the reference's instance carried across) and the int4
  deployment. Both packages run their default, fork-aware path on the
  prefix cache when paged; the contiguous port runs every candidate as an
  independent request.
* Fork-aware candidates equal independent ones (sampled, the same
  generator seed), for the dense and the hybrid family, as the reference's
  ``test_fork_sample_candidates_matches_independent``.
* Sampled candidates are held to the port's own contracts: shape, range,
  determinism in the generator. Their draws are torch's, not the
  reference's.
* Speculative decoding, not ported, raises as ``SchedulerConfig`` does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.eval import tasks as ref_tasks
from repro.models import build as ref_build
from repro.serve import engine as ref_engine
from repro.serve import prm as ref_prm
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.eval import tasks as port_tasks
from repro_torch.models import build as port_build
from repro_torch.models import transformer as T
from repro_torch.serve import engine as port_engine
from repro_torch.serve import prm as port_prm

torch.set_num_threads(2)

ARCHS = ["llama-3.2-1b", "phi-3-mini-4k"]


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _carry(tree) -> dict:
    return params_from_numpy(_ref_flat(tree), "cpu")


def test_prm_selection_strategies_match_reference():
    answers = np.array([3, 3, 5, 7])
    rewards = np.array([0.1, 0.2, 0.9, 0.3])
    for s, want in (("prm_greedy", 5), ("voting", 3), ("prm_voting", 5)):
        assert port_prm.select_answer(answers, rewards, s) == want
        assert ref_prm.select_answer(answers, rewards, s) == want
    with pytest.raises(ValueError):
        port_prm.select_answer(answers, rewards, "majority")
    a, b = port_prm.NoisyOraclePRM(0.8, seed=4), ref_prm.NoisyOraclePRM(
        0.8, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(a.score(answers, 3),
                                      b.score(answers, 3))
    with pytest.raises(ValueError):
        port_prm.NoisyOraclePRM(1.5)


def _candidates(rng, num_p, n_max, p_right):
    correct = rng.integers(0, 10, num_p)
    answers = np.where(rng.random((num_p, n_max)) < p_right,
                       correct[:, None], rng.integers(0, 10, (num_p, n_max)))
    return answers, correct


# (rng seed, prompts, candidates, P(right), PRM reliability and seed, ns,
# repeats): the two cases of tests/test_data_serve.py
CASES = [(0, 64, 64, 0.3, 0.8, 1, [1, 4, 16, 64], 5),
         (2, 48, 32, 0.4, 0.5, 3, [16], 8)]


@pytest.mark.parametrize("case", CASES, ids=["informative", "coin_flip"])
def test_best_of_n_accuracy_matches_reference(case):
    seed, num_p, n_max, p_right, rel, prm_seed, ns, repeats = case
    answers, correct = _candidates(np.random.default_rng(seed), num_p, n_max,
                                   p_right)
    got = port_engine.best_of_n_accuracy(
        answers, correct, port_prm.NoisyOraclePRM(rel, seed=prm_seed), ns,
        repeats=repeats)
    want = ref_engine.best_of_n_accuracy(
        answers, correct, ref_prm.NoisyOraclePRM(rel, seed=prm_seed), ns,
        repeats=repeats)
    assert got == want
    if rel > 0.5:      # the reference test's claims, on the port's numbers
        curve = [got["prm_voting"][n]["mean"] for n in ns]
        assert curve[-1] > curve[0] + 0.15
        assert (got["prm_voting"][16]["mean"]
                >= got["voting"][16]["mean"] - 0.02)
    else:
        assert abs(got["prm_voting"][16]["mean"]
                   - got["voting"][16]["mean"]) < 0.08


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params, labels and hw instance, port params, labels
    and instance)."""
    cfg = get_config(request.param).reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
    inst = ref_analog.sample_noise_instances(params, labels,
                                             jax.random.PRNGKey(1), "hw")
    pp = _carry(params)
    return (cfg, params, labels, inst, pp, T.model_labels(pp, cfg),
            _carry(inst))


def _deploy(carried, deploy):
    """(reference params, acfg, port params, acfg, port int4_serve)."""
    cfg, params, labels, inst, pp, plabels, pinst = carried
    if deploy == "off":
        return (params, ref_analog.AnalogConfig(mode="off"), pp,
                PA.AnalogConfig(mode="off"), False)
    if deploy == "analog_hw":
        return (ref_analog.apply_noise_instances(params, labels, inst, "hw"),
                ref_analog.AnalogConfig(mode="analog", train_noise=False),
                PA.apply_noise_instances(pp, plabels, pinst, "hw"),
                PA.AnalogConfig(mode="analog", train_noise=False), False)
    # the reference's unfused RTN-W4 path against the port's int4_serve
    return (params, ref_analog.AnalogConfig(mode="rtn", weight_bits=4),
            PA.pack_int4_weights(pp, plabels),
            PA.AnalogConfig(weight_bits=4), True)


def _prompts(cfg, num=3, plen=5):
    return np.random.default_rng(11).integers(
        0, cfg.vocab_size, (num, plen)).astype(np.int32)


@pytest.mark.parametrize("max_new", [1, 3])
@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_candidates_match_reference(carried, deploy, max_new):
    cfg = carried[0]
    rp, racfg, tp, tacfg, int4 = _deploy(carried, deploy)
    prompts = _prompts(cfg)
    geo = dict(max_new=max_new, greedy_first=max_new, num_slots=2,
               prefill_chunk=4, temperature=0.7, top_k=5)
    # a stop id the greedy continuation of prompt 0 emits at its second
    # token, so that some candidates stop early
    plain = ref_engine.sample_candidates(
        rp, cfg, racfg, jax.random.PRNGKey(5), prompts[:1], 1,
        ref_engine.BestOfNConfig(**geo),
        extract=lambda t: int(t[min(1, len(t) - 1)]))
    stop = int(plain[0, 0])
    extract_r = ref_tasks.extract_before_stop(stop)
    want = ref_engine.sample_candidates(
        rp, cfg, racfg, jax.random.PRNGKey(5), prompts, 2,
        ref_engine.BestOfNConfig(**geo, stop_tokens=(stop,)),
        extract=extract_r)
    assert want.shape == (3, 2)
    for paged in (True, False):
        got = port_engine.sample_candidates(
            tp, cfg, tacfg, torch.Generator().manual_seed(5), prompts, 2,
            port_engine.BestOfNConfig(**geo, stop_tokens=(stop,),
                                      int4_serve=int4, paged=paged),
            extract=port_tasks.extract_before_stop(stop))
        np.testing.assert_array_equal(got, want, err_msg=f"paged={paged}")
        assert got.dtype.kind in "iu"


def test_sampled_candidates_are_deterministic_in_the_generator(carried):
    cfg, pp = carried[0], carried[4]
    prompts = _prompts(cfg, num=2, plen=3)
    bcfg = port_engine.BestOfNConfig(temperature=1.0, max_new=3,
                                     num_slots=4, prefill_chunk=4)

    def run(seed, extract=None):
        return port_engine.sample_candidates(
            pp, cfg, PA.AnalogConfig(mode="off"),
            torch.Generator().manual_seed(seed), prompts, 4, bcfg,
            extract=extract)

    last = lambda toks: int(np.asarray(toks)[-1])   # noqa: E731
    a = run(0, last)
    assert a.shape == (2, 4) and a.dtype.kind in "iu"
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    np.testing.assert_array_equal(a, run(0, last))
    firsts = np.concatenate([run(s) for s in range(4)], axis=1)
    assert len(np.unique(firsts)) > 1       # the candidates differ


@pytest.mark.parametrize("draft", ["ngram"])
def test_speculative_is_ported(carried, monkeypatch, draft):
    """The former ``speculative`` case of ``test_features_not_ported_raise``:
    ``BestOfNConfig(speculative=True)`` no longer raises; it passes its
    drafter to the engine, which runs windows, and the answers are the
    non-speculative ones."""
    cfg, pp = carried[0], carried[4]
    engines = []
    real = port_engine.ServeEngine

    def spy(*a, **kw):
        engines.append(real(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(port_engine, "ServeEngine", spy)
    bcfg = port_engine.BestOfNConfig(num_slots=2, max_new=5)

    def run(b):
        return port_engine.sample_candidates(
            pp, cfg, PA.AnalogConfig(mode="off"),
            torch.Generator().manual_seed(1), _prompts(cfg), 2, b,
            extract=lambda t: int(np.sum(t)))

    got = run(dataclasses.replace(bcfg, speculative=True, draft=draft,
                                  draft_k=2))
    eng = engines[-1]
    assert eng.spec_enabled and eng.scfg.draft == draft
    assert eng.scfg.draft_k == 2 and eng.spec_steps > 0
    np.testing.assert_array_equal(got, run(bcfg))


def test_prefix_cache_runs_fork_aware(carried, monkeypatch):
    """The former ``prefix_cache`` case of ``test_features_not_ported_raise``:
    the prefix cache is on by default and runs, and the forks hit as the
    reference's do (its pool and engine counters, the same prompts: the
    three 5-token prompts share one root key, so one frozen tail serves
    only its own prompt's forks)."""
    cfg, params, pp = carried[0], carried[1], carried[4]
    assert port_engine.BestOfNConfig().prefix_cache
    engines = []
    for mod in (port_engine, ref_engine):
        class Spy(mod.ServeEngine):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                engines.append(self)

        monkeypatch.setattr(mod, "ServeEngine", Spy)
    got = port_engine.sample_candidates(
        pp, cfg, PA.AnalogConfig(mode="off"), torch.Generator(),
        _prompts(cfg), 3, port_engine.BestOfNConfig(num_slots=2))
    ref_engine.sample_candidates(
        params, cfg, ref_analog.AnalogConfig(mode="off"),
        jax.random.PRNGKey(0), _prompts(cfg), 3,
        ref_engine.BestOfNConfig(num_slots=2))
    ours, theirs = engines
    assert got.shape == (3, 3) and ours.prefix_enabled
    names = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
             "prefix_skipped_tokens", "prefix_cow_copies")
    assert ({k: getattr(ours, k) for k in names}
            == {k: getattr(theirs, k) for k in names})
    assert ours.prefix_lookups == 9 and ours.prefix_cow_copies > 0


def _fork_against_independent(cfg, pp):
    prompts = np.stack([np.random.default_rng(s).integers(
        0, cfg.vocab_size, 9).astype(np.int32) for s in range(2)])
    fork = port_engine.BestOfNConfig(temperature=0.9, top_k=13, max_new=3,
                                     num_slots=4, prefill_chunk=4)
    indep = dataclasses.replace(fork, paged=False, prefix_cache=False)
    a = port_engine.sample_candidates(
        pp, cfg, PA.AnalogConfig(mode="off"),
        torch.Generator().manual_seed(5), prompts, 3, fork)
    b = port_engine.sample_candidates(
        pp, cfg, PA.AnalogConfig(mode="off"),
        torch.Generator().manual_seed(5), prompts, 3, indep)
    np.testing.assert_array_equal(a, b)
    return a


def test_fork_candidates_equal_independent_dense(carried):
    """Fork-aware best-of-n (leaders, then n − 1 forks on the prefix cache)
    gives the independent requests' answers for every candidate seed (the
    reference's ``test_fork_sample_candidates_matches_independent``,
    dense: KV-block sharing)."""
    a = _fork_against_independent(carried[0], carried[4])
    assert len(np.unique(a)) > 1            # sampled, not one answer


def test_fork_candidates_equal_independent_hybrid():
    """The same on reduced jamba-v0.1-52b (KV blocks and state snapshots,
    at the no-drop capacity of the reference's case)."""
    cfg = get_config("jamba-v0.1-52b").reduce()
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    _, pp, _ = port_build(cfg, 0, device="cpu")
    _fork_against_independent(cfg, pp)


@pytest.mark.parametrize("field,value,gated", [
    ("drift_dt", 0.5, {"drift"}),
    ("recalibrate", True, {"recalibrate"})])
def test_drift_options_reach_the_engine_and_gate(carried, monkeypatch,
                                                 field, value, gated):
    """``drift_dt`` / ``recalibrate`` pass through to the engine, which
    gates them as the reference's does on params without device state
    (``gating_reasons``, not a raise): the candidates are those of a run
    without them."""
    cfg, pp = carried[0], carried[4]
    engines = []

    class Spy(port_engine.ServeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(port_engine, "ServeEngine", Spy)
    bcfg = port_engine.BestOfNConfig(num_slots=2)

    def run(b):
        return port_engine.sample_candidates(
            pp, cfg, PA.AnalogConfig(mode="off"),
            torch.Generator().manual_seed(0), _prompts(cfg), 2, b)

    got = run(dataclasses.replace(bcfg, **{field: value}))
    eng = engines[-1]
    assert getattr(eng.scfg, field) == value
    assert set(eng.gating_reasons) == gated
    assert not eng.drift_enabled and not eng.recal_enabled
    np.testing.assert_array_equal(got, run(bcfg))


def test_config_fields_are_the_references():
    """Every field of the reference, in its order, the drafter's defaults
    equal."""
    port, ref = port_engine.BestOfNConfig(), ref_engine.BestOfNConfig()
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for name in ("speculative", "draft_k", "draft"):
        assert getattr(port, name) == getattr(ref, name)
