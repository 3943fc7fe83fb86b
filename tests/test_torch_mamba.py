"""The port's ssm family (mamba2-130m, reduced) against the reference.

Weights are built by the reference from a JAX key and carried across as
numpy (``params_from_numpy``); the hw noise instance of ``analog_hw`` is
drawn once by the reference and applied on both sides. Then, in order:

* the carry-over is a rename, and a reference checkpoint loads to identical
  arrays (``blocks/mixer/conv_w`` and the rest);
* one mixer (``mamba2.mamba``) equals the reference's on a prefill chunk
  from a nonzero state with left-padded and fully masked rows, and on a
  decode step: output and new state within 1e-5, masked rows' state bit
  for bit;
* forward logits within 1e-5 for ``off``, ``analog`` (hw noise), ``rtn``
  and packed ``digital_int4``, with ``use_pallas`` off and on (on the CPU
  "on" runs the kernels' plain versions);
* prefill + decode equals the full forward within 5e-4 (the reference's
  bar in ``tests/test_decode.py``);
* greedy ``generate`` emits the reference's tokens, also with a bf16 conv
  cache (the SSM state stays fp32);
* the continuous engine gives the reference engine's greedy tokens and
  schedule (``prefix_cache=False``), solo and with a request admitted
  mid-decode; ``conv_width=1`` matches ``generate``; ``paged=True``
  allocates no pool and records why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.models import apply as ref_apply
from repro.models import build as ref_build
from repro.models import mamba2 as ref_mamba
from repro.serve import decode as ref_decode
from repro.serve import scheduler as RS
from repro_torch.checkpoint import (flatten_paths, load_reference_npz,
                                    params_from_numpy)
from repro_torch.core import analog as PA
from repro_torch.models import apply as port_apply
from repro_torch.models import mamba2 as PM
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-130m"
REF_EVAL = ref_analog.AnalogCtx(key=None, training=False)
PORT_EVAL = PA.AnalogCtx()


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _carry(cfg, seed=0):
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(seed))
    inst = ref_analog.sample_noise_instances(params, labels,
                                             jax.random.PRNGKey(seed + 1),
                                             "hw")
    return (cfg, params, labels, inst,
            params_from_numpy(_ref_flat(params), "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


@pytest.fixture(scope="module")
def carried():
    """(cfg, reference params/labels/hw instance, port params/instance)."""
    return _carry(get_config(ARCH).reduce())


def _deploy(carried, deploy):
    """(reference params, acfg, port params, acfg) of one deployment."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "off":
        return (params, ref_analog.AnalogConfig(mode="off"), pp,
                PA.AnalogConfig(mode="off"))
    if deploy == "analog_hw":
        return (ref_analog.apply_noise_instances(params, labels, inst, "hw"),
                ref_analog.AnalogConfig(mode="analog", train_noise=False),
                PA.apply_noise_instances(pp, plabels, pinst, "hw"),
                PA.AnalogConfig(mode="analog", train_noise=False))
    if deploy == "rtn":
        return (params, ref_analog.AnalogConfig(mode="rtn"), pp,
                PA.AnalogConfig(mode="rtn"))
    assert deploy == "digital_int4"
    return (params, ref_analog.AnalogConfig(mode="rtn", weight_bits=4),
            PA.pack_int4_weights(pp, plabels),
            port_decode.digital_int4_config(PA.AnalogConfig(weight_bits=4)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_carry_over_is_a_rename(carried, tmp_path):
    cfg, params, labels, _, pp, _ = carried
    assert cfg.family == "ssm" and cfg.tie_embeddings
    flat = _ref_flat(params)
    assert list(flatten_paths(pp)) == list(flat)
    assert "blocks/mixer/conv_w" in flat and "lm_head" not in pp
    assert T.model_labels(pp, cfg) == labels
    assert pp["blocks"]["mixer"]["in_proj"]["kernel"].shape == (
        cfg.num_layers, cfg.d_model,
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    path = ref_ckpt.save(str(tmp_path), 3, params)
    got, manifest = load_reference_npz(path)
    assert manifest["step"] == 3
    tp = flatten_paths(params_from_numpy(got, "cpu"))
    for p, arr in flat.items():
        np.testing.assert_array_equal(tp[p].numpy(), arr)


def test_mixer_matches_reference_on_a_chunk_and_a_decode_step(carried):
    """A prefill chunk from a nonzero state over rows that are live,
    left-padded and fully masked, then a decode step with one row masked."""
    cfg, params, _, _, pp, _ = carried
    rp = jax.tree.map(lambda t: t[0], params["blocks"]["mixer"])
    tp = T.tree_index(pp["blocks"]["mixer"], 0)
    rng = np.random.default_rng(4)
    b, s = 3, 6
    _, heads, _, conv_ch, _ = PM._dims(cfg)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal(
                 (b, cfg.conv_width - 1, conv_ch)).astype(np.float32),
             "ssm": rng.standard_normal(
                 (b, heads, cfg.ssm_state, cfg.ssm_headdim)).astype(
                 np.float32)}
    mask = np.ones((b, s), np.float32)
    mask[1, :4] = 0.0                      # row 1: 4 left pads
    mask[2] = 0.0                          # row 2: fully masked
    racfg = ref_analog.AnalogConfig(mode="off")
    tacfg = PA.AnalogConfig(mode="off")
    jc = jax.tree.map(jnp.asarray, cache)
    tc = {k: torch.from_numpy(v) for k, v in cache.items()}
    for step_x, step_mask in ((x, mask), (x[:, :1], np.array(
            [[1.0], [1.0], [0.0]], np.float32))):
        y_r, _, jc = ref_mamba.mamba(rp, jnp.asarray(step_x), cfg, racfg,
                                     REF_EVAL, jc, jnp.asarray(step_mask))
        y_t, st, tc = PM.mamba(tp, torch.from_numpy(step_x), cfg, tacfg,
                               PORT_EVAL, tc, torch.from_numpy(step_mask))
        assert set(st) == {"in_proj", "out_proj"}
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL)
        # the fully masked row keeps its state bit for bit
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(tc[k][2].numpy(), cache[k][2])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("deploy", ["off", "analog_hw", "rtn", "digital_int4"])
def test_forward_logits_match_reference(carried, deploy, use_pallas):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    if deploy != "digital_int4":
        tacfg = dataclasses.replace(tacfg, use_pallas=use_pallas)
    toks = _tokens(cfg, 2, 11, seed=1)
    ref_logits, _, _ = ref_apply(rp, cfg, racfg, REF_EVAL,
                                 {"tokens": jnp.asarray(toks)})
    port_logits, stats, _ = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                       {"tokens": torch.from_numpy(toks)})
    assert port_logits.shape == (2, 11, cfg.vocab_size)
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(ref_logits),
                               **TOL)
    assert stats["blocks"]["mixer"]["in_proj"]["x_std"].shape == (
        cfg.num_layers,)


@pytest.mark.parametrize("deploy", ["off", "digital_int4"])
def test_prefill_decode_equals_full_forward(carried, deploy):
    cfg = carried[0]
    _, _, tp, tacfg = _deploy(carried, deploy)
    b, s, sp = 2, 14, 9
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2))
    full, _, _ = port_apply(tp, cfg, tacfg, PORT_EVAL, {"tokens": toks})
    caches = T.init_caches(cfg, b, s, device="cpu")
    assert set(caches) == {"conv", "ssm"}
    pre, _, caches = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                {"tokens": toks[:, :sp]}, caches=caches)
    errs = [float((pre - full[:, :sp]).abs().max())]
    for t in range(sp, s):
        lg, _, caches = port_apply(tp, cfg, tacfg, PORT_EVAL,
                                   {"tokens": toks[:, t:t + 1]},
                                   caches=caches, pos_offset=t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_generate_matches_reference_tokens(carried, deploy,
                                                  cache_dtype):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    prompt = _tokens(cfg, 3, 5, seed=3)
    num_new = 6
    ref_toks = ref_decode.generate(rp, cfg, racfg, jax.random.PRNGKey(4),
                                   jnp.asarray(prompt), num_new,
                                   greedy_first=num_new, cache_dtype=jdt)
    port_toks = port_decode.generate(tp, cfg, tacfg, None,
                                     torch.from_numpy(prompt), num_new,
                                     greedy_first=num_new, cache_dtype=tdt)
    np.testing.assert_array_equal(port_toks.numpy(), np.asarray(ref_toks))
    _, caches, _ = port_decode.prefill(tp, cfg, tacfg,
                                       torch.from_numpy(prompt), 8,
                                       cache_dtype=tdt)
    assert caches["conv"].dtype == tdt
    assert caches["ssm"].dtype == torch.float32


def _churn(cfg):
    """More requests than slots, mixed lengths (1 to 3 chunks of 4)."""
    return [dict(uid=i, prompt=_tokens(cfg, 1, 3 + 2 * i, seed=i)[0],
                 max_new=4 + i % 3, temperature=0.0) for i in range(5)]


def _eq(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=str(uid))


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_engine_greedy_tokens_and_schedule_match_reference(carried, deploy):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    reqs = _churn(cfg)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4,
               cache_dtype=torch.bfloat16)
    ref = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(
        prefix_cache=False, **{**geo, "cache_dtype": jnp.bfloat16}))
    want = ref.run([RS.Request(**r) for r in reqs])
    eng = PS.ServeEngine(tp, cfg, tacfg, PS.SchedulerConfig(**geo))
    got = eng.run([PS.Request(**r) for r in reqs])
    _eq(got, want)
    assert (eng.decode_steps, eng.mixed_steps,
            eng.decode_tokens_during_admission, eng.prefill_chunks) == (
        ref.decode_steps, ref.mixed_steps,
        ref.decode_tokens_during_admission, ref.prefill_chunks)
    assert list(eng.step_token_log) == list(ref.step_token_log)
    assert eng.caches["conv"].dtype == torch.bfloat16


def test_engine_paged_is_inert_and_says_why(carried):
    cfg, params, _, _, pp, _ = carried
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4,
               paged=True)
    ref = RS.ServeEngine(params, cfg, ref_analog.AnalogConfig(mode="off"),
                         RS.SchedulerConfig(prefix_cache=False, **geo))
    eng = PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="off"),
                         PS.SchedulerConfig(**geo))
    assert eng.pool is None and ref.pool is None
    assert set(eng.gating_reasons) == set(ref.gating_reasons) == {"paged"}
    assert ref.gating_reasons["paged"].startswith(eng.gating_reasons["paged"])
    assert set(eng.caches) == {"conv", "ssm"}
    reqs = _churn(cfg)[:3]
    _eq(eng.run([PS.Request(**r) for r in reqs]),
        ref.run([RS.Request(**r) for r in reqs]))


def test_mid_decode_admission_parity(carried):
    """A request admitted into a busy batch mid-decode gives its solo
    tokens, and both equal the reference engine's (the reference's
    ``test_mid_decode_admission_parity``, greedy)."""
    cfg, params, _, _, pp, _ = carried
    geo = dict(num_slots=3, max_len=48, prefill_chunk=4, decode_block=4)
    target = dict(uid=99, prompt=_tokens(cfg, 1, 6, seed=0)[0], max_new=8,
                  temperature=0.0)
    fillers = [dict(uid=i, prompt=_tokens(cfg, 1, 3 + i, seed=i)[0],
                    max_new=3 + 2 * i, temperature=0.0) for i in range(3)]
    out = {}
    for tag, mod, p, acfg, extra in (
            ("ref", RS, params, ref_analog.AnalogConfig(mode="off"),
             dict(prefix_cache=False)),
            ("port", PS, pp, PA.AnalogConfig(mode="off"), {})):
        scfg = mod.SchedulerConfig(**geo, **extra)
        solo = mod.ServeEngine(p, cfg, acfg, scfg).run(
            [mod.Request(**target)])[99]
        eng = mod.ServeEngine(p, cfg, acfg, scfg)
        for f in fillers:
            eng.submit(mod.Request(**f))
        for _ in range(2):
            eng.step()                 # all slots busy, decode under way
        eng.submit(mod.Request(**target))
        res = eng.run()
        np.testing.assert_array_equal(solo, res[99])
        assert sorted(res) == [0, 1, 2, 99]
        out[tag] = res
    _eq(out["port"], out["ref"])


def test_conv_width_one_regression():
    """``conv_width=1`` keeps no conv tail (an empty ``[B, 0, C]`` leaf):
    the engine runs and matches the lockstep ``generate`` of both packages
    (the reference's ``test_conv_width_one_regression``, cold)."""
    cfg = dataclasses.replace(get_config(ARCH).reduce(), conv_width=1)
    cfg, params, _, _, pp, _ = _carry(cfg)
    prompt = _tokens(cfg, 1, 6, seed=0)
    want = np.asarray(ref_decode.generate(
        params, cfg, ref_analog.AnalogConfig(mode="off"),
        jax.random.PRNGKey(0), jnp.asarray(prompt), 4, temperature=0.0))[0]
    acfg = PA.AnalogConfig(mode="off")
    got = port_decode.generate(pp, cfg, acfg, None,
                               torch.from_numpy(prompt), 4,
                               greedy_first=4)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    eng = PS.ServeEngine(pp, cfg, acfg, PS.SchedulerConfig(
        num_slots=2, max_len=16, prefill_chunk=4, paged=True,
        kv_block_size=4))
    assert eng.caches["conv"].shape[2] == 0
    cold = eng.run([PS.Request(uid=0, prompt=prompt[0], max_new=4,
                               temperature=0.0)])[0]
    np.testing.assert_array_equal(cold, want)
