"""The port's noisy-eval path (``repro_torch.data``, ``repro_torch.eval``)
against the JAX package's, on reduced llama-3.2-1b and phi-3-mini-4k.

Weights are built by the reference from a JAX key and carried across as
numpy (``params_from_numpy``); so are the reference's noise-instance trees,
which have the params' layout. Then:

* ``MarkovCorpus`` is the reference's bit for bit (chain, samples, Bayes
  predictions);
* ``evaluate`` gives the reference's ``runs`` (and so ``mean`` / ``std`` /
  ``avg``) for ``none``, ``hw`` and ``gaussian`` at two gamma points on the
  reference's ``deployment_instances``, and for the Table-3 digital int4
  deployment. The two forwards may differ by one ADC level at near-ties, so
  an argmax may differ, but only where the reference's top-2 margin is
  under ``MARGIN_TOL``; a run differs only by the positions that moved.
  Both packages' analog sites are recorded, and every site input and the
  logits agree within ``SITE_TOL`` wherever no earlier site output apart
  can reach (the forward is causal);
* the port's counterpart of the reference's
  ``test_deployment_instances_pin_chips_across_evaluate_calls``, with the
  refusal of too few instances; the per-seed path is deterministic in its
  seeds (its draws are torch's, so it is not compared with the reference);
* ``teacher_logits`` within 1e-5, ``filter_low_logprob`` keeps the same
  rows, and ``generate_synthetic`` has the reference test's shape, range
  and BOS properties for ``sss``, ``rgs`` and ``sgs``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.data import synthetic as ref_syn
from repro.data.corpus import MarkovCorpus as RefCorpus
from repro.eval import harness as ref_harness
from repro.eval import tasks as ref_tasks
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.data import synthetic as port_syn
from repro_torch.data.corpus import MarkovCorpus as PortCorpus
from repro_torch.eval import harness as port_harness
from repro_torch.eval import tasks as port_tasks
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as T
from repro_torch.serve.decode import digital_int4_config

torch.set_num_threads(2)

ARCHS = ["llama-3.2-1b", "phi-3-mini-4k"]
#: an argmax of the port may differ from the reference's only where the
#: reference's top-1 and top-2 logits lie closer than this. The two packages
#: sum their matmuls in another order, so an ADC may round a near-tie one
#: level apart; later layers carry that level on to the later positions of
#: the same sequence (one such flip moved a reduced llama's logits by 0.19).
#: In these tests the positions that moved had margins 0.021 to 0.10; over
#: all scored positions the median margin is 0.21 to 0.32 (5th percentile
#: 0.006 to 0.045), so this gate alone would pass about half of them: the
#: strict one is the logits check below
MARGIN_TOL = 0.25
#: and at most this share of a task's scored positions may move (two of
#: phi-3's 176 induction_copy positions moved after one such flip)
MAX_MOVED = 0.05
#: every site input and the logits of the port agree with the reference's,
#: |port - ref| <= SITE_TOL * (1 + |ref|), at each (row, position) that no
#: earlier site output apart reaches; at least MIN_UNREACHED of a task's
#: scored positions must be so held (0.94 to 1.0 are in these tests)
SITE_TOL = 1e-5
MIN_UNREACHED = 0.75
SEEDS = 2
GAMMAS = (0.02, 0.05)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _carry(tree) -> dict:
    return params_from_numpy(_ref_flat(tree), "cpu")


@pytest.mark.parametrize("vocab,seed", [(64, 0), (256, 3), (1000, 7)])
def test_markov_corpus_is_the_references_bit_for_bit(vocab, seed):
    ref, port = RefCorpus(vocab, seed=seed), PortCorpus(vocab, seed=seed)
    np.testing.assert_array_equal(port.succ, ref.succ)
    np.testing.assert_array_equal(port.probs, ref.probs)
    toks = port.sample(8, 20, seed=5)
    np.testing.assert_array_equal(toks, ref.sample(8, 20, seed=5))
    assert toks.dtype == np.int32
    # the chain's own stream, twice in a row
    for _ in range(2):
        np.testing.assert_array_equal(port.sample(4, 9), ref.sample(4, 9))
    np.testing.assert_array_equal(port.optimal_next_token(toks),
                                  ref.optimal_next_token(toks))


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params and labels, port params and labels)."""
    cfg = get_config(request.param).reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
    pp = _carry(params)
    return cfg, params, labels, pp, T.model_labels(pp, cfg)


def _tasks(pkg, cfg):
    corpus = (RefCorpus if pkg is ref_tasks else PortCorpus)(
        cfg.vocab_size, seed=3)
    return {"markov_next": pkg.markov_next(corpus, num_seqs=16, seq_len=32),
            "induction_copy": pkg.induction_copy(cfg.vocab_size,
                                                 num_seqs=16)}


def _recording(monkeypatch, module, log: list, convert):
    """Record the logits of every task forward of ``module``."""
    real = module.model_apply

    def spy(*a, **k):
        out = real(*a, **k)
        log.append(convert(out[0]))
        return out

    monkeypatch.setattr(module, "model_apply", spy)


def _recording_sites(monkeypatch, log_r: list, log_p: list):
    """Record ``(input, output)`` of every analog site call of both
    packages, in call order, as numpy (the reference's from inside its
    layer scan, by an ordered debug callback)."""
    real_r, real_p = ref_analog.analog_linear, PA.analog_linear

    def keep(x, y):
        log_r.append((np.asarray(x), np.asarray(y)))

    def spy_r(p, x, cfg, ctx):
        y, st = real_r(p, x, cfg, ctx)
        jax.debug.callback(keep, x, y, ordered=True)
        return y, st

    def spy_p(p, x, cfg, ctx):
        y, st = real_p(p, x, cfg, ctx)
        log_p.append((x.numpy().copy(), y.numpy().copy()))
        return y, st

    for module in (ref_layers, ref_transformer):
        monkeypatch.setattr(module, "analog_linear", spy_r)
    for module in (port_layers, T):
        monkeypatch.setattr(module, "analog_linear", spy_p)


def _apart(a, b, rows_pos) -> np.ndarray:
    """[B, S]: the (row, position)s where ``a`` and ``b`` [B, S, ...]
    differ beyond ``SITE_TOL * (1 + |b|)``."""
    far = np.abs(a - b) > SITE_TOL * (1 + np.abs(b))
    return far.reshape(rows_pos + (-1,)).any(-1)


def _assert_logits_agree(names, sites_r, sites_p, ref_logits, port_logits):
    """Causal reach: the forward is causal and its rows independent, so a
    site output apart at (row, position), an ADC near-tie flip or a DAC
    code moved, can move later sites at that row's position and after
    it, nowhere else. Every site input and the logits must agree within
    ``SITE_TOL`` wherever no earlier site output apart reaches, and at
    least ``MIN_UNREACHED`` of each task's scored positions must be out of
    reach. The forwards are those of ``names``, seed by seed."""
    n = len(sites_r) // len(ref_logits)
    assert len(sites_r) == len(sites_p) == n * len(ref_logits)
    for f, (lr, lp) in enumerate(zip(ref_logits, port_logits)):
        reach = np.zeros(lr.shape[:2], bool)
        for i in range(n):
            (xr, yr), (xp, yp) = sites_r[f * n + i], sites_p[f * n + i]
            assert not (_apart(xp, xr, reach.shape) & ~reach).any(), (f, i)
            reach |= np.maximum.accumulate(_apart(yp, yr, reach.shape),
                                           axis=1)
        assert not (_apart(lp, lr, reach.shape) & ~reach).any(), f
        name = names[f % len(names)]
        assert (~reach[:, SCORED[name]]).mean() >= MIN_UNREACHED, (
            name, (~reach[:, SCORED[name]]).mean())


# the scored positions of each task's logits [B, S, V]: (time slice, its
# targets are not needed here)
SCORED = {"markov_next": slice(4, None), "induction_copy": slice(13, 24)}


def _assert_same_runs(ref_res, port_res, ref_logits, port_logits):
    """Equal runs, except where an argmax moved at a near-tie of the
    reference's top-2 logits (checked) by the positions that moved."""
    assert ref_logits and len(ref_logits) == len(port_logits)
    names = [n for n in ref_res if n != "avg"]
    assert sorted(port_res) == sorted(ref_res)
    for i, (lr, lp) in enumerate(zip(ref_logits, port_logits)):
        name = names[i % len(names)]
        seed = i // len(names)
        sl = SCORED[name]
        a_r, a_p = lr[:, sl].argmax(-1), lp[:, sl].argmax(-1)
        moved = a_r != a_p
        if moved.any():
            top2 = np.sort(lr[:, sl], axis=-1)[..., -2:]
            margin = (top2[..., 1] - top2[..., 0])[moved]
            assert margin.max() < MARGIN_TOL, (name, seed, margin)
            assert moved.mean() <= MAX_MOVED, (name, seed, moved.mean())
        bound = moved.sum() / moved.size
        assert abs(port_res[name]["runs"][seed]
                   - ref_res[name]["runs"][seed]) <= bound + 1e-7
        if not moved.any():
            assert port_res[name]["runs"][seed] == ref_res[name]["runs"][seed]
    for name in names:
        np.testing.assert_allclose(port_res[name]["mean"],
                                   ref_res[name]["mean"], atol=0.05)
    assert set(port_res["avg"]) == {"mean", "std"}


NOISES = [("none", 0.0), ("hw", 0.0)] + [("gaussian", g) for g in GAMMAS]


@pytest.mark.parametrize("model,gamma", NOISES,
                         ids=[f"{m}-{g}" for m, g in NOISES])
def test_evaluate_matches_reference(carried, monkeypatch, model, gamma):
    cfg, params, labels, pp, plabels = carried
    ref_acfg = ref_analog.AnalogConfig(mode="analog", train_noise=False)
    port_acfg = PA.AnalogConfig(mode="analog", train_noise=False)
    spec_r = ref_harness.NoiseSpec(model, gamma)
    spec_p = port_harness.NoiseSpec(model, gamma)
    inst_r = inst_p = None
    if model != "none":
        inst_r = ref_harness.deployment_instances(params, labels, model,
                                                  seeds=SEEDS, base_seed=4)
        inst_p = [_carry(t) for t in inst_r]
    lr, lp, sr, sp = [], [], [], []
    _recording(monkeypatch, ref_tasks, lr, np.asarray)
    _recording(monkeypatch, port_tasks, lp, lambda t: t.numpy())
    _recording_sites(monkeypatch, sr, sp)
    res_r = ref_harness.evaluate(params, labels, cfg, ref_acfg,
                                 _tasks(ref_tasks, cfg), spec_r,
                                 seeds=SEEDS, instances=inst_r)
    res_p = port_harness.evaluate(pp, plabels, cfg, port_acfg,
                                  _tasks(port_tasks, cfg), spec_p,
                                  seeds=SEEDS, instances=inst_p)
    n = SEEDS if model != "none" else 1
    assert len(lr) == 2 * n and all(len(v["runs"]) == n
                                    for k, v in res_p.items() if k != "avg")
    _assert_same_runs(res_r, res_p, lr, lp)
    _assert_logits_agree([n for n in res_r if n != "avg"], sr, sp, lr, lp)


def test_evaluate_digital_int4_matches_reference(carried, monkeypatch):
    """The Table-3 deployment: the port's packed-int4 weights on the int4
    kernel's plain version against the reference's unfused RTN-W4 path
    (its own suite holds that equal to its int4 kernel)."""
    cfg, params, labels, pp, plabels = carried
    lr, lp, sr, sp = [], [], [], []
    _recording(monkeypatch, ref_tasks, lr, np.asarray)
    _recording(monkeypatch, port_tasks, lp, lambda t: t.numpy())
    _recording_sites(monkeypatch, sr, sp)
    res_r = ref_harness.evaluate(
        params, labels, cfg, ref_analog.AnalogConfig(mode="rtn",
                                                     weight_bits=4),
        _tasks(ref_tasks, cfg))
    res_p = port_harness.evaluate(
        PA.pack_int4_weights(pp, plabels), plabels, cfg,
        digital_int4_config(PA.AnalogConfig(weight_bits=4)),
        _tasks(port_tasks, cfg))
    _assert_same_runs(res_r, res_p, lr, lp)
    _assert_logits_agree([n for n in res_r if n != "avg"], sr, sp, lr, lp)


def _toy_site(seed=7):
    g = torch.Generator().manual_seed(seed)
    p = PA.init_linear(g, 48, 32, use_bias=False)
    return {"l": p}, {"l": PA.linear_labels(p)}


def test_deployment_instances_pin_chips_across_evaluate_calls():
    """evaluate(..., instances=...) gives equal runs call to call, and
    refuses fewer instances than seeds (the reference's test, ported)."""
    params, labels = _toy_site(seed=7)
    tasks = {"sum": lambda p, cfg, acfg: float(torch.sum(p["l"]["kernel"]))}
    inst = port_harness.deployment_instances(params, labels, "gaussian",
                                             seeds=3)
    spec = port_harness.NoiseSpec("gaussian", 0.08)
    r1 = port_harness.evaluate(params, labels, None, None, tasks, spec,
                               seeds=3, instances=inst)
    r2 = port_harness.evaluate(params, labels, None, None, tasks, spec,
                               seeds=3, instances=inst)
    assert r1["sum"]["runs"] == r2["sum"]["runs"]
    assert len(set(r1["sum"]["runs"])) == 3          # three chips
    with pytest.raises(ValueError, match="deployment instances"):
        port_harness.evaluate(params, labels, None, None, tasks, spec,
                              seeds=5, instances=inst)


def test_gamma_points_perturb_the_same_chips():
    """Pinned instances: the gamma-0.1 perturbation is twice the 0.05 one,
    seed by seed, and the instances are those of the per-seed generators
    (``base_seed + 1000 * s``)."""
    params, labels = _toy_site(seed=2)
    w = params["l"]["kernel"]
    inst = port_harness.deployment_instances(params, labels, "gaussian",
                                             seeds=2, base_seed=3)
    for s, tree in enumerate(inst):
        d1 = PA.apply_noise_instances(params, labels, tree, "gaussian",
                                      0.05)["l"]["kernel"] - w
        d2 = PA.apply_noise_instances(params, labels, tree, "gaussian",
                                      0.10)["l"]["kernel"] - w
        assert d1.abs().max() > 0
        torch.testing.assert_close(d2, 2.0 * d1, rtol=1e-5, atol=1e-7)
        again = PA.sample_noise_instances(
            params, labels, torch.Generator().manual_seed(3 + 1000 * s),
            "gaussian")
        assert torch.equal(again["l"]["kernel"], tree["l"]["kernel"])
    assert not torch.equal(inst[0]["l"]["kernel"], inst[1]["l"]["kernel"])


def test_per_seed_path_is_deterministic_in_its_seeds(carried):
    """instances=None: each seed perturbs from its own generator, so the
    same call twice gives equal runs, and each seed's chip is the one that
    ``deployment_instances`` pins."""
    cfg, _, _, pp, plabels = carried
    acfg = PA.AnalogConfig(mode="analog", train_noise=False)
    seen = []

    def kernel_sum(p, cfg, acfg):
        seen.append(p["blocks"]["attn"]["qkv"]["kernel"].clone())
        return float(torch.sum(p["blocks"]["attn"]["qkv"]["kernel"]))

    tasks = {"sum": kernel_sum,
             "induction_copy": port_tasks.induction_copy(cfg.vocab_size,
                                                         num_seqs=8)}
    spec = port_harness.NoiseSpec("hw")
    r1 = port_harness.evaluate(pp, plabels, cfg, acfg, tasks, spec, seeds=2)
    r2 = port_harness.evaluate(pp, plabels, cfg, acfg, tasks, spec, seeds=2)
    assert r1 == r2
    assert r1["sum"]["runs"][0] != r1["sum"]["runs"][1]
    pinned = port_harness.deployment_instances(pp, plabels, "hw", seeds=2)
    for s in range(2):
        want = PA.apply_noise_instances(pp, plabels, pinned[s], "hw")
        assert torch.equal(seen[s], want["blocks"]["attn"]["qkv"]["kernel"])


class _Stop(Exception):
    pass


def test_tasks_run_where_the_params_live(carried, monkeypatch):
    """The tasks' tokens go to the device of the params, not to the CPU
    default (params on the meta device; the forward is stopped there)."""
    cfg, _, _, pp, _ = carried
    seen = []

    def spy(params, cfg, acfg, ctx, inputs, **kw):
        seen.append(inputs["tokens"].device)
        raise _Stop

    monkeypatch.setattr(port_tasks, "model_apply", spy)
    meta = {"embed": {"tokens": pp["embed"]["tokens"].to("meta")}}
    for task in (port_tasks.markov_next(PortCorpus(cfg.vocab_size),
                                        num_seqs=2, seq_len=8),
                 port_tasks.induction_copy(cfg.vocab_size, num_seqs=2)):
        with pytest.raises(_Stop):
            task(meta, cfg, PA.AnalogConfig())
    assert seen == [torch.device("meta")] * 2


def test_answer_extraction_and_mod_add_data_match_reference():
    toks = [np.array([5, 3, 9, 9]), np.array([9, 1]), np.array([4, 2]),
            np.array([30, 24, 7, 23])]
    for stop in (9, 23):
        for t in toks:
            assert (port_tasks.extract_before_stop(stop)(t)
                    == ref_tasks.extract_before_stop(stop)(t))
    for t in toks:
        assert (port_tasks.extract_first_token(t)
                == ref_tasks.extract_first_token(t))
        assert (port_tasks.mod_add_extraction(23)(t)
                == ref_tasks.mod_add_extraction(23)(t))
    for a, b in zip(port_tasks.make_mod_add_data(64, num=16),
                    ref_tasks.make_mod_add_data(64, num=16)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(port_tasks.mod_add_train_tokens(64, num=32),
                                  ref_tasks.mod_add_train_tokens(64, num=32))


def test_teacher_logits_and_logprob_filter_match_reference(carried):
    cfg, params, _, pp, _ = carried
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (10, 12)).astype(np.int32)
    want = np.asarray(ref_syn.teacher_logits(params, cfg, jnp.asarray(toks)))
    got = port_syn.teacher_logits(pp, cfg, toks)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for drop in (0.2, 0.5):
        np.testing.assert_array_equal(
            port_syn.filter_low_logprob(pp, cfg, toks, drop, batch_size=4),
            ref_syn.filter_low_logprob(params, cfg, toks, drop,
                                       batch_size=4))


@pytest.mark.parametrize("strategy", ["sss", "rgs", "sgs"])
def test_generate_synthetic_strategies(carried, strategy):
    """The reference test's properties, and determinism in the generator."""
    cfg, _, _, pp, _ = carried
    gen = port_syn.GenConfig(strategy=strategy)

    def run():
        return port_syn.generate_synthetic(
            pp, cfg, torch.Generator().manual_seed(0), 5, 12, gen,
            batch_size=4)

    toks = run()
    assert toks.shape == (5, 12) and toks.dtype == np.int32
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    if strategy != "rgs":
        assert np.all(toks[:, 0] == 1)   # BOS start
    np.testing.assert_array_equal(toks, run())


def test_generate_synthetic_greedy_span_matches_reference(carried):
    """The greedy span of ``sgs`` (tokens 1..5 after BOS) is fixed by the
    weights alone, so it equals the reference's."""
    cfg, params, _, pp, _ = carried
    gen = port_syn.GenConfig(strategy="sgs")
    got = port_syn.generate_synthetic(pp, cfg, torch.Generator(), 3, 7,
                                      gen)
    want = ref_syn.generate_synthetic(params, cfg, jax.random.PRNGKey(0), 3,
                                      7, ref_syn.GenConfig(strategy="sgs"))
    np.testing.assert_array_equal(got[:, :6], want[:, :6])
