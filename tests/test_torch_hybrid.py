"""The port's hybrid family (jamba-v0.1-52b, reduced: one super-block of 8
layers, 4 experts) against the JAX package.

Weights are built by the reference and carried across as numpy through
its checkpoint format (``load_reference_npz``); the hw noise instance of
``analog_hw`` is drawn by the reference and applied on both sides.
Tolerances:

* forward logits: ``rtol = atol = 1e-5`` at ``off``, ``rtn`` and packed
  ``digital_int4``; under ``analog`` and ``analog_hw`` by
  ``assert_adc_parity`` (one ADC level of the LM head at a near-tie, under
  1e-4 of the outputs);
* prefill + decode against the full forward: 5e-4, the reference's bar in
  ``tests/test_decode.py``, with its no-drop capacity;
* greedy ``generate``: tokens equal (``tests/test_torch_hybrid_engine.py``
  holds the continuous engine).

The stack's own mechanics are held too: the nested layout and its labels,
the cache tree and its slot spec, the noise context (super-block, then
layer), ``rope_theta = 0``, the layer-by-layer init into a preallocated
stack, in-place perturbation, and the training refusal that is left (vlm
and audio).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config
from repro.core import analog as RA
from repro.models import apply as ref_apply
from repro.models import transformer as RT
from repro.serve.decode import generate as ref_generate
from repro_torch.checkpoint import (flatten_paths, load_reference_npz,
                                    params_from_numpy)
from repro_torch.core import analog as PA
from repro_torch.core import quant as PQ
from repro_torch.kernels import ref as kref
from repro_torch.models import apply as port_apply
from repro_torch.models import build as port_build
from repro_torch.models import layers as PL
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "jamba-v0.1-52b"
REF_EVAL = RA.AnalogCtx(key=None, training=False)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))


def ref_model(cfg, seed: int):
    """The reference's ``init_model`` and ``sample_noise_instances`` (hw),
    each run as one jitted program (the eager calls dispatch thousands of
    small ops): ``(params, labels, instance)``. The labels, plain strings,
    are read off a trace."""
    labels = []
    jax.eval_shape(lambda k: labels.append(RT.init_model(k, cfg)[1]) or 0,
                   jax.random.PRNGKey(seed))
    params = jax.jit(lambda k: RT.init_model(k, cfg)[0])(
        jax.random.PRNGKey(seed))
    inst = jax.jit(lambda p, k: RA.sample_noise_instances(
        p, labels[0], k, "hw"))(params, jax.random.PRNGKey(seed + 1))
    return params, labels[0], inst


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(cfg, reference params / labels / hw instance, port params /
    instance), the port's params read from the reference's checkpoint."""
    cfg = _no_drop(get_config(ARCH).reduce())
    params, labels, inst = ref_model(cfg, 0)
    path = ref_ckpt.save(str(tmp_path_factory.mktemp("ckpt")), 1, params)
    flat, _ = load_reference_npz(path)
    return (cfg, params, labels, inst, params_from_numpy(flat, "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


def _deploy(carried, deploy):
    """Reference (params, acfg) and port (params, acfg) of a deployment."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "analog_hw":
        return (RA.apply_noise_instances(params, labels, inst, "hw"),
                RA.AnalogConfig(mode="analog", train_noise=False),
                PA.apply_noise_instances(pp, plabels, pinst, "hw"),
                PA.AnalogConfig(mode="analog", train_noise=False))
    if deploy == "digital_int4":
        return (params, RA.AnalogConfig(mode="rtn", weight_bits=4),
                PA.pack_int4_weights(pp, plabels),
                port_decode.digital_int4_config(
                    PA.AnalogConfig(weight_bits=4)))
    return (params, RA.AnalogConfig(mode=deploy), pp,
            PA.AnalogConfig(mode=deploy))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layout, labels, carry-over
# ---------------------------------------------------------------------------

def test_nested_layout_labels_and_carry_over(carried):
    cfg, params, labels, _, pp, _ = carried
    flat = _ref_flat(params)
    assert list(flatten_paths(pp)) == list(flat)
    for p, arr in flat.items():
        np.testing.assert_array_equal(flatten_paths(pp)[p].numpy(), arr,
                                      err_msg=p)
    assert T.model_labels(pp, cfg) == labels
    n_sb, half = cfg.num_layers // cfg.attn_every, cfg.attn_every // 2
    b = pp["blocks"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert b["attn"]["attn"]["qkv"]["kernel"].shape[0] == n_sb
    assert b["mamba"]["mixer"]["in_proj"]["kernel"].shape[:2] == (
        n_sb, cfg.attn_every - 1)
    assert b["dense_ffn"]["ffn"]["gate_up"]["kernel"].shape == (
        n_sb, half - 1, d, 2 * f)
    assert b["moe_ffn"]["ffn"]["gate_up"]["kernel"].shape == (
        n_sb, half, e, d, 2 * f)
    _, own, own_labels = port_build(cfg, 0, device="cpu")
    assert own_labels == labels
    assert {k: tuple(v.shape) for k, v in flatten_paths(own).items()} == {
        k: v.shape for k, v in flat.items()}


def test_init_draws_layer_by_layer_into_the_stack():
    """The stack is filled in place, layer by layer, with the values a
    per-layer init then a stack would give (the same draws in the same
    order), and the expert kernels are drawn straight into it."""
    cfg = get_config(ARCH).reduce()
    gen = torch.Generator().manual_seed(3)
    got = T.init_blocks(gen, cfg)
    gen = torch.Generator().manual_seed(3)
    half = cfg.attn_every // 2

    def stack(n, fn):
        return T.tree_stack([fn() for _ in range(n)])

    def ffn(kind):
        return lambda: {"ln2": PL.init_norm(cfg.d_model, cfg.norm),
                        "ffn": T._init_ffn(gen, cfg, kind)}

    want = stack(cfg.num_layers // cfg.attn_every, lambda: {
        "attn": T.init_attn_layer(gen, cfg),
        "mamba": stack(cfg.attn_every - 1,
                       lambda: T.init_mamba_layer(gen, cfg)),
        "dense_ffn": stack(half - 1, ffn("dense")),
        "moe_ffn": stack(half, ffn("moe"))})
    fg, fw = flatten_paths(got), flatten_paths(want)
    assert list(fg) == list(fw)
    for p in fg:
        assert torch.equal(fg[p], fw[p]), p
    # an fp32 destination is drawn into with no temporary
    dst = torch.empty((4, 8))
    out = PA.scaled_randn(torch.Generator().manual_seed(1), (4, 8), 0.5,
                          out=dst)
    assert out.data_ptr() == dst.data_ptr()
    assert torch.equal(out, PA.scaled_randn(
        torch.Generator().manual_seed(1), (4, 8), 0.5))


def test_in_place_perturbation_and_packing(carried):
    cfg, _, _, _, pp, _ = carried
    labels = T.model_labels(pp, cfg)
    fresh = params_from_numpy(
        {k: v.numpy() for k, v in flatten_paths(pp).items()}, "cpu")
    want = PA.perturb_analog_weights(pp, labels,
                                     torch.Generator().manual_seed(5), "hw")
    got = PA.perturb_analog_weights(fresh, labels,
                                    torch.Generator().manual_seed(5), "hw",
                                    inplace=True)
    moe = ["blocks", "moe_ffn", "ffn", "gate_up", "kernel"]
    leaf = fresh
    for k in moe:
        leaf = leaf[k]
    w_got = got
    for k in moe:
        w_got = w_got[k]
    assert w_got.data_ptr() == leaf.data_ptr()       # no second copy
    fw, fg = flatten_paths(want), flatten_paths(got)
    for p in fw:
        assert torch.equal(fw[p], fg[p]), p
    # packed carriers, expert by expert, as the per-matrix RTN gives them
    site = PA.pack_int4_weights(pp, labels)["blocks"]["moe_ffn"]["ffn"][
        "down"]
    w = pp["blocks"]["moe_ffn"]["ffn"]["down"]["kernel"]
    w_int, s = PQ.rtn_quantize(w[0, 1, 2], 4)
    assert torch.equal(site["int4"]["packed"][0, 1, 2], kref.pack_int4(w_int))
    assert torch.equal(site["int4"]["scale"][0, 1, 2], s[0])


def test_cache_tree_and_slot_spec_match_reference():
    cfg = get_config(ARCH).reduce()
    for kw in (dict(), dict(per_slot=True), dict(per_slot=True, paged=True),
               dict(per_slot=True, paged=True, kv_bits=8)):
        got = T.init_caches(cfg, 3, 32, kv_block_size=8, **kw)
        want = RT.init_caches(cfg, 3, 32, kv_block_size=8, **kw)
        fg, fw = flatten_paths(got), _ref_flat(want)
        assert sorted(fg) == sorted(fw), kw
        for p in fw:
            if isinstance(fg[p], int):
                assert fg[p] == 0 and fw[p].shape == (1,), p
            else:
                assert tuple(fg[p].shape) == fw[p].shape, (kw, p)
        if kw:
            spec = T.cache_slot_spec(cfg, kw.get("paged", False),
                                     kw.get("kv_bits", 0))
            assert spec == RT.cache_slot_spec(cfg, kw.get("paged", False),
                                              kw.get("kv_bits", 0))
    assert T.cache_slot_spec(cfg, True)[0]["mamba"] == {"conv": 2, "ssm": 2}


def test_rope_theta_zero_is_the_identity(carried):
    cfg = carried[0]
    assert cfg.rope_theta == 0.0
    x = torch.randn(2, 5, 4, 16)
    pos = torch.arange(5)[None].expand(2, 5) + 7
    assert PL.rope(x, pos, 0.0) is x


# ---------------------------------------------------------------------------
# the reduced model against the reference
# ---------------------------------------------------------------------------

_REF_LOGITS: dict = {}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
@pytest.mark.parametrize("deploy", ["off", "analog", "analog_hw", "rtn",
                                    "digital_int4"])
def test_forward_logits_match_reference(carried, deploy, use_pallas):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    if deploy != "digital_int4":
        tacfg = dataclasses.replace(tacfg, use_pallas=use_pallas)
    toks = _tokens(cfg, 2, 12, seed=1)
    if deploy not in _REF_LOGITS:       # the same for both use_pallas
        _REF_LOGITS[deploy] = ref_apply(rp, cfg, racfg, REF_EVAL,
                                        {"tokens": jnp.asarray(toks)})[0]
    want = _REF_LOGITS[deploy]
    got, stats, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                               {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 12, cfg.vocab_size)
    if deploy in ("analog", "analog_hw"):
        head = tp["lm_head"]
        bound = kref.adc_bound(head["kernel"], head["input_range"],
                               tacfg.out_bound)[:cfg.vocab_size]
        assert_adc_parity(got.numpy(), np.asarray(want),
                          (bound / 127).numpy())
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    n_sb = cfg.num_layers // cfg.attn_every
    assert stats["blocks"]["moe_ffn"]["ffn"]["router"]["aux_loss"].shape \
        == (n_sb, cfg.attn_every // 2)
    assert stats["blocks"]["mamba"]["mixer"]["in_proj"]["x_std"].shape == (
        n_sb, cfg.attn_every - 1)


def test_stats_match_reference(carried):
    """The stats tree mirrors the super-block's params, as the
    reference's."""
    cfg, params, _, _, pp, _ = carried
    toks = _tokens(cfg, 2, 8, seed=2)
    _, st_r, _ = ref_apply(params, cfg, RA.AnalogConfig(mode="analog"),
                           RA.AnalogCtx(key=None, training=False,
                                        collect_stats=True),
                           {"tokens": jnp.asarray(toks)})
    _, st_p, _ = port_apply(pp, cfg, PA.AnalogConfig(mode="analog"),
                            PA.AnalogCtx(collect_stats=True),
                            {"tokens": torch.from_numpy(toks).long()})
    a, b = _ref_flat(st_r), {k: v.numpy()
                             for k, v in flatten_paths(st_p).items()}
    assert sorted(a) == sorted(b)
    for p in a:
        np.testing.assert_allclose(b[p], a[p], err_msg=p, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("deploy", ["off", "digital_int4"])
def test_prefill_decode_equals_full_forward(carried, deploy):
    cfg = carried[0]
    _, _, tp, tacfg = _deploy(carried, deploy)
    b, s, sp = 2, 16, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2)).long()
    full, _, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(), {"tokens": toks})
    caches = T.init_caches(cfg, b, s, device="cpu")
    pre, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                {"tokens": toks[:, :sp]}, caches=caches)
    errs = [float((pre - full[:, :sp]).abs().max())]
    for t in range(sp, s):
        lg, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                   {"tokens": toks[:, t:t + 1]},
                                   caches=caches, pos_offset=t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs
    assert caches["attn"]["pos"] == s


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_generate_matches_reference_tokens(carried, deploy):
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    prompt = _tokens(cfg, 3, 5, seed=3)
    want = ref_generate(rp, cfg, racfg, jax.random.PRNGKey(4),
                        jnp.asarray(prompt), 6, greedy_first=6)
    got = port_decode.generate(tp, cfg, tacfg, None,
                               torch.from_numpy(prompt).long(), 6,
                               greedy_first=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_noise_context_folds_super_block_then_layer(carried, monkeypatch):
    """Every analog site of the training forward is keyed by (super-block,
    layer in it, site), as the reference's ``fold_in(fold_in(key, sb),
    j)``. The training forward runs (it was refused before the SSD and
    batched-expert backwards were ported), and so do vlm and audio."""
    cfg, _, _, _, pp, _ = carried
    keys = []
    real = PA.analog_linear

    def spy(p, x, acfg, ctx):
        keys.append(ctx.key)
        return real(p, x, acfg, PA.AnalogCtx())

    for mod in (PL, T, T.M, T.MoE):
        monkeypatch.setattr(mod, "analog_linear", spy)
    x = torch.randn(1, 4, cfg.d_model)
    T.apply_blocks(pp["blocks"], x, cfg, PA.AnalogConfig(mode="off"),
                   PA.AnalogCtx(key=(7,)), torch.arange(4)[None])
    # the mixers' in_proj / out_proj, then each FFN's sites, per layer
    fold = PA.noise_lib.fold_in
    tag = PA.noise_lib.site_tag
    sb = fold((7,), 0)
    assert keys[0] == fold(fold(sb, 0), tag("in_proj"))
    assert keys[2] == fold(fold(sb, 0), tag("gate_up"))
    assert keys[4] == fold(fold(sb, 1), tag("in_proj"))
    assert len(set(keys)) == len(keys)
    # the hybrid family trains now (tests/test_torch_train_hybrid.py), and
    # so do the vlm and audio families (tests/test_torch_train_vlm_audio.py)
    logits, _, _ = port_apply(pp, cfg, PA.AnalogConfig(mode="analog"),
                              PA.AnalogCtx(key=(1,), training=True),
                              {"tokens": torch.zeros((1, 4),
                                                     dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    for arch in ("internvl2-2b", "musicgen-medium"):
        vcfg, vp, _ = port_build(get_config(arch).reduce(), 0, device="cpu")
        kdim = (vcfg.num_codebooks,) if vcfg.family == "audio" else ()
        logits, _, _ = port_apply(
            vp, vcfg, PA.AnalogConfig(mode="analog"),
            PA.AnalogCtx(key=(1,), training=True),
            {"tokens": torch.zeros((1, 4) + kdim, dtype=torch.long)})
        assert tuple(logits.shape) == (1, 4) + kdim + (vcfg.vocab_size,)
        assert bool(torch.isfinite(logits).all())
