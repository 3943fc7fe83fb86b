"""The port's speculative decoding on the continuous engine
(``repro_torch.serve.scheduler``), the counterpart of the reference's
``tests/test_speculative.py`` on reduced configs with mode ``off``.

Exact-match verification makes speculative output the non-speculative
output, so every case holds the port's speculative engine against the
port's non-speculative one, bit for bit: the four families on both cache
layouts (ssm and hybrid gated, with the reason), the target drafting for
itself (every proposal accepted), the packed-int4 drafter across block
boundaries and against its unpacked twin, an all-reject host drafter, a
stop token inside a window, sampled rows with ``greedy_first`` expiring
in a window, an admission mid-decode, prefix sharing, a layer-skip and an
injected drafter, best-of-n and the CLI. Across the packages, on weights
carried from the reference as numpy, the port's speculative tokens and
its three speculative counters equal the reference engine's for the
``ngram`` and ``int4`` drafters on the paged pool.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import analog as RA
from repro.models import build as ref_build
from repro.serve import scheduler as RS
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import analog as PA
from repro_torch.launch import serve as port_serve
from repro_torch.models import build
from repro_torch.serve import engine as PE
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

FAMILIES = {"dense": "llama-3.2-1b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-130m", "hybrid": "jamba-v0.1-52b"}
OFF = PA.AnalogConfig(mode="off")
#: the spec counters both packages keep
SPEC = ("spec_steps", "spec_proposed", "spec_accepted")

_BUILT: dict = {}


def _build(arch: str, seed: int = 0):
    """(cfg, params) of the reduced ``arch`` (moe at the no-drop capacity:
    a window's columns compete for a row's expert slots as one token does
    not), built once per process."""
    if (arch, seed) not in _BUILT:
        cfg = get_config(arch).reduce()
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.num_experts))
        cfg, params, _ = build(cfg, seed, device="cpu")
        _BUILT[arch, seed] = (cfg, params)
    return _BUILT[arch, seed]


def _prompt(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def _scfg(paged=False, **kw):
    """The reference test's geometry; 4-token blocks put a block boundary
    inside every ``draft_k = 4`` window on the paged pool."""
    base = dict(num_slots=3, max_len=64, prefill_chunk=4)
    if paged:
        base.update(paged=True, kv_block_size=4)
    base.update(kw)
    return PS.SchedulerConfig(**base)


def _reqs(cfg, temperature=0.0, max_new=8, **kw):
    return [PS.Request(uid=0, prompt=_prompt(cfg, 5), max_new=max_new,
                       temperature=temperature, seed=11, **kw),
            PS.Request(uid=1, prompt=_prompt(cfg, 9, seed=4),
                       max_new=max_new, temperature=temperature, seed=12,
                       **kw)]


def _same(out: dict, base: dict) -> None:
    assert out.keys() == base.keys()
    for uid in base:
        np.testing.assert_array_equal(out[uid], base[uid])


def _pair(cfg, params, scfg, reqs, **kw):
    """(non-speculative results, speculative results, speculative engine)
    on the same requests."""
    base = PS.ServeEngine(params, cfg, OFF, scfg).run(list(reqs))
    eng = PS.ServeEngine(params, cfg, OFF,
                         dataclasses.replace(scfg, speculative=True), **kw)
    return base, eng.run(list(reqs)), eng


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("paged", [False, True])
def test_spec_matches_nonspec_greedy(family, paged):
    """Greedy speculative output is the non-speculative output on every
    family and both layouts; dense and moe run windows, ssm and hybrid
    decode as before and say why."""
    cfg, params = _build(FAMILIES[family])
    base, out, eng = _pair(cfg, params, _scfg(paged, draft="ngram"),
                           _reqs(cfg))
    _same(out, base)
    if family in ("dense", "moe"):
        assert eng.spec_enabled and eng.spec_steps > 0
        assert "speculative" not in eng.gating_reasons
    else:
        assert not eng.spec_enabled and eng.spec_steps == 0
        assert "cumulative" in eng.gating_reasons["speculative"]


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_accepts_every_proposal(paged):
    """The target drafting for itself samples the verifier's draws, so
    every proposal is accepted and the windows emit ``k + 1`` tokens."""
    cfg, params = _build("llama-3.2-1b")
    base, out, eng = _pair(cfg, params, _scfg(paged, draft="self"),
                           _reqs(cfg, max_new=12))
    _same(out, base)
    assert eng.spec_steps > 0 and eng.spec_proposed > 0
    assert eng.spec_accepted == eng.spec_proposed
    assert eng.draft_forwards > 0


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_int4_drafter_across_block_boundaries(family):
    """The int4 drafter (the digital int4 deployment of the same weights)
    accepts some of its proposals; partial windows rewind the paged cursor
    across 4-token block boundaries and the output stays bitwise."""
    cfg, params = _build(FAMILIES[family])
    base, out, eng = _pair(cfg, params, _scfg(True, draft="int4"),
                           _reqs(cfg, max_new=10))
    _same(out, base)
    assert eng.spec_steps > 0
    assert 0 < eng.spec_accepted < eng.spec_proposed
    assert eng.draft_acfg.int4_serve and eng.draft_acfg.kv_bits == 0


def test_forced_all_reject_windows():
    """A ``draft_fn`` that proposes anything but the next token rejects
    every proposal: each window emits its bonus draw alone, and the output
    is still the non-speculative one."""
    cfg, params = _build("llama-3.2-1b")
    reqs = _reqs(cfg)
    base = PS.ServeEngine(params, cfg, OFF, _scfg(True)).run(list(reqs))
    prompts = {r.uid: np.asarray(r.prompt) for r in reqs}

    def wrong(ctx, k):
        uid = next(u for u, p in prompts.items()
                   if len(ctx) >= len(p) and np.array_equal(ctx[:len(p)], p))
        ref, n = base[uid], len(ctx) - len(prompts[uid])
        props = [(int(ref[n + i]) + 1) % cfg.vocab_size
                 for i in range(min(k, len(ref) - n))]
        return np.asarray(props or [0], np.int32)

    eng = PS.ServeEngine(params, cfg, OFF, _scfg(True, speculative=True),
                         draft_fn=wrong)
    _same(eng.run(list(reqs)), base)
    assert eng.draft_caches is None
    assert eng.spec_steps > 0 and eng.spec_accepted == 0
    assert eng.spec_acceptance == 0.0


@pytest.mark.parametrize("drafter", ["self", "host"])
def test_stop_token_inside_a_window(drafter):
    """A stop token accepted inside a window ends the request where
    sequential decode ends it; the window's later tokens are dropped and
    the slot's blocks are released (the rewind window closed first). The
    self drafter, and a host drafter that proposes the reference tokens
    (every proposal accepted); the prompt's greedy tokens do not repeat
    before the stop, so the stop fires at the third."""
    cfg, params = _build("llama-3.2-1b")
    probe = PS.Request(uid=0, prompt=_prompt(cfg, 5, seed=6), max_new=8,
                       temperature=0.0)
    ref = PS.ServeEngine(params, cfg, OFF, _scfg(True)).run([probe])[0]
    assert int(ref[2]) not in ref[:2]
    req = dataclasses.replace(probe, stop_tokens=(int(ref[2]),))
    base = PS.ServeEngine(params, cfg, OFF, _scfg(True)).run([req])[0]
    eng = PS.ServeEngine(params, cfg, OFF,
                         _scfg(True, speculative=True, draft="self"),
                         draft_fn=(lambda ctx, k: ref[len(ctx) - 5:][:k])
                         if drafter == "host" else None)
    out = eng.run([req])[0]
    np.testing.assert_array_equal(out, base)
    np.testing.assert_array_equal(out, ref[:3])
    assert eng.spec_steps > 0 and eng.pool.num_live == 0


def test_sampled_rows_with_greedy_first_expiry():
    """Sampled rows (temperature, top-k, top-p), ``greedy_first`` expiring
    inside a window: the self drafter samples with the verifier's counters,
    so the output is bitwise and proposals are accepted."""
    cfg, params = _build("llama-3.2-1b")
    reqs = [PS.Request(uid=0, prompt=_prompt(cfg, 5), max_new=10,
                       temperature=0.9, top_k=17, greedy_first=3, seed=21),
            PS.Request(uid=1, prompt=_prompt(cfg, 7, seed=5), max_new=10,
                       temperature=1.1, top_p=0.9, seed=22)]
    base, out, eng = _pair(cfg, params, _scfg(True, draft="self"), reqs)
    _same(out, base)
    assert eng.spec_steps > 0
    assert eng.spec_accepted == eng.spec_proposed


def test_mid_decode_admission_keeps_the_drafter_in_step():
    """Mixed steps decode without windows; the drafter consumes their
    decode tokens (catch-up) and prefills an admitted prompt at its flip,
    so the self drafter still accepts every proposal, and the late request
    gives its solo tokens."""
    cfg, params = _build("llama-3.2-1b", seed=1)
    target = PS.Request(uid=99, prompt=_prompt(cfg, 6), max_new=8,
                        temperature=0.0, seed=42)
    solo = PS.ServeEngine(params, cfg, OFF, _scfg(True)).run([target])[99]
    eng = PS.ServeEngine(params, cfg, OFF,
                         _scfg(True, speculative=True, draft="self"))
    for i in range(3):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                              max_new=4 + 2 * i, temperature=0.0, seed=i))
    for _ in range(2):
        eng.step()
    eng.submit(target)
    out = eng.run()
    np.testing.assert_array_equal(out[99], solo)
    assert eng.spec_steps > 0 and eng.mixed_steps > 0
    assert eng.spec_accepted == eng.spec_proposed


def test_spec_over_shared_prefix_blocks():
    """Windows beside refcount-shared prompt blocks: the second request
    maps the first's blocks, both decode speculatively, every commit's
    ``check_rewind`` passes, and both give the non-speculative tokens."""
    cfg, params = _build("llama-3.2-1b")
    prompt = _prompt(cfg, 8)
    reqs = [PS.Request(uid=0, prompt=prompt, max_new=8, temperature=0.0),
            PS.Request(uid=1, prompt=prompt.copy(), max_new=8,
                       temperature=0.7, seed=31)]

    def run(**kw):
        eng = PS.ServeEngine(params, cfg, OFF, _scfg(True, **kw))
        eng.submit(reqs[0])
        while eng.queue or any(s is not None and s.prefilling
                               for s in eng.slots):
            eng.step()
        eng.submit(reqs[1])
        return eng.run(), eng

    base, _ = run()
    out, eng = run(speculative=True, draft="self")
    _same(out, base)
    assert eng.prefix_hits > 0 and eng.spec_steps > 0
    assert eng.pool.num_live == 0
    assert eng.pool.num_free + eng.pool.num_cached == eng.pool.num_blocks


def _has_int4(tree) -> bool:
    return isinstance(tree, dict) and ("int4" in tree or any(
        _has_int4(v) for v in tree.values()))


def test_packed_int4_drafter_equals_unpacked():
    """The default drafter's packed carriers (built once at construction,
    read by the int4 kernel) draft exactly the tokens of the unfused
    RTN-W4 drafter: the same output and the same counters."""
    cfg, params = _build("llama-3.2-1b")
    scfg = _scfg(True, speculative=True, draft_k=3)
    reqs = _reqs(cfg, max_new=8)
    packed = PS.ServeEngine(params, cfg, OFF, scfg)
    assert _has_int4(packed.draft_params) and not _has_int4(params)
    out_p = packed.run(list(reqs))
    unfused = PS.ServeEngine(params, cfg, OFF, scfg, draft_acfg=(
        dataclasses.replace(OFF, mode="rtn", weight_bits=4)))
    assert not _has_int4(unfused.draft_params)
    _same(out_p, unfused.run(list(reqs)))
    for name in SPEC:
        assert getattr(packed, name) == getattr(unfused, name)
    assert packed.spec_accepted > 0


def test_layer_skip_and_injected_drafters():
    """``draft_layers`` keeps the drafter's first blocks (views of the
    target's), an injected (params, cfg, acfg) triple drafts on its own
    weights; both verify to the non-speculative output. ``draft_k < 1``
    and an unknown drafter raise."""
    cfg, params = _build("llama-3.2-1b")
    reqs = _reqs(cfg)
    base = PS.ServeEngine(params, cfg, OFF, _scfg(True)).run(list(reqs))
    skip = PS.ServeEngine(params, cfg, OFF, _scfg(
        True, speculative=True, draft="self", draft_layers=1))
    assert skip.draft_cfg.num_layers == 1 < cfg.num_layers
    leaf = skip.draft_params["blocks"]["attn"]["qkv"]["kernel"]
    assert leaf.shape[0] == 1
    assert leaf.data_ptr() == params["blocks"]["attn"]["qkv"][
        "kernel"].data_ptr()
    _same(skip.run(list(reqs)), base)
    assert skip.spec_steps > 0
    dcfg, dparams = _build("llama-3.2-1b", seed=5)
    other = PS.ServeEngine(params, cfg, OFF, _scfg(True, speculative=True),
                           draft_params=dparams, draft_cfg=dcfg,
                           draft_acfg=OFF)
    assert other.draft_params is dparams and other.draft_acfg == OFF
    _same(other.run(list(reqs)), base)
    with pytest.raises(ValueError, match="draft_k"):
        PS.ServeEngine(params, cfg, OFF, _scfg(speculative=True, draft_k=0))
    with pytest.raises(ValueError, match="unknown drafter"):
        PS.ServeEngine(params, cfg, OFF, _scfg(speculative=True,
                                                draft="medusa"))


@pytest.mark.parametrize("draft", ["ngram", "int4"])
def test_best_of_n_speculative_answers_equal_nonspec(draft):
    """``BestOfNConfig(speculative=True)`` passes its drafter to the engine
    and gives the non-speculative answers (sampled candidates, fork-aware
    on the paged pool)."""
    cfg, params = _build("llama-3.2-1b")
    prompts = np.stack([_prompt(cfg, 6, seed=s) for s in (1, 2)])
    bcfg = PE.BestOfNConfig(num_slots=4, max_new=6, kv_block_size=4,
                            prefill_chunk=4, top_k=11)

    def run(b):
        return PE.sample_candidates(params, cfg, OFF,
                                    torch.Generator().manual_seed(3),
                                    prompts, 3, b,
                                    extract=lambda t: int(np.sum(t)))

    np.testing.assert_array_equal(
        run(dataclasses.replace(bcfg, speculative=True, draft=draft,
                                draft_k=2)), run(bcfg))


def test_cli_speculative_ngram():
    """``--speculative --draft ngram`` on the reduced model and the paged
    pool serves the workload and reports its windows; the tokens are the
    non-speculative run's."""
    argv = ["--device", "cpu", "--reduced", "--paged", "--num-requests", "4",
            "--new-tokens", "12"]
    base = port_serve.main(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port_serve.main(argv + ["--speculative", "--draft", "ngram"])
    _same(out, base)
    line = buf.getvalue()
    assert "speculative (ngram drafter, k=4):" in line
    assert "verify windows" in line and "draft acceptance" in line


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("draft", ["ngram", "int4"])
def test_port_spec_equals_reference_engine(draft):
    """Across the packages, on the reference's weights carried as numpy:
    the port's speculative greedy tokens and its ``spec_steps`` /
    ``spec_proposed`` / ``spec_accepted`` equal the reference engine's on
    the paged pool (the int4 drafter's draws are argmax picks of the
    drafter's logits, so they compare too). One reference engine run per
    drafter."""
    cfg, params, _ = ref_build(ref_get_config("llama-3.2-1b").reduce(),
                               jax.random.PRNGKey(0))
    pp = params_from_numpy(_ref_flat(params), "cpu")
    geo = dict(num_slots=3, max_len=64, prefill_chunk=4, paged=True,
               kv_block_size=4, speculative=True, draft=draft)
    reqs = [dict(uid=0, prompt=_prompt(cfg, 5), max_new=10,
                 temperature=0.0),
            dict(uid=1, prompt=_prompt(cfg, 9, seed=4), max_new=10,
                 temperature=0.0),
            dict(uid=2, prompt=np.tile(_prompt(cfg, 3, seed=6), 4),
                 max_new=10, temperature=0.0)]
    ref = RS.ServeEngine(params, cfg, RA.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(**geo))
    ref_out = ref.run([RS.Request(**r) for r in reqs])
    eng = PS.ServeEngine(pp, get_config("llama-3.2-1b").reduce(), OFF,
                         PS.SchedulerConfig(**geo))
    _same(eng.run([PS.Request(**r) for r in reqs]),
          {u: np.asarray(v) for u, v in ref_out.items()})
    for name in SPEC:
        assert getattr(eng, name) == getattr(ref, name), name
    assert eng.spec_steps > 0
