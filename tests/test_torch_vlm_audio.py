"""The port's vlm (internvl2-2b) and audio (musicgen-medium) families,
reduced, against the JAX package.

Weights and the hw noise instance of ``analog_hw`` are drawn by the
reference and carried across as numpy through its checkpoint format
(``load_reference_npz``: the ``projector`` site and the ``[K, V, d]``
codebook table included). The vlm's patch embeddings and the tokens come
from a numpy generator. Tolerances:

* forward logits (vlm with ``patch_embeds``, audio ``[B, S, K, V]``):
  ``rtol = atol = 1e-5`` at ``off``, ``rtn`` and packed ``digital_int4``;
  under ``analog`` and ``analog_hw`` by ``assert_adc_parity`` (one ADC
  level of the LM head at a near-tie, under 1e-4 of the outputs);
* prefill + decode against the full forward: 5e-4, the reference's bar in
  ``tests/test_decode.py`` (the vlm's decode positions count its patch
  prefix);
* greedy ``generate``: tokens equal, the vlm's with its patch prefix and
  the audio's ``[B, n, K]`` (``tests/test_decode.py::
  test_generate_audio_multicodebook``'s case, greedy).

Both families are served by the static engine only, as in the reference:
the continuous engine refuses them and the CLI falls back and says so.
They train (``test_torch_train_vlm_audio.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity
from test_torch_hybrid import ref_model

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config
from repro.core import analog as RA
from repro.models import apply as ref_apply
from repro.serve.decode import generate as ref_generate
from repro_torch.checkpoint import (flatten_paths, load_reference_npz,
                                    params_from_numpy)
from repro_torch.core import analog as PA
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import apply as port_apply
from repro_torch.models import build as port_build
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["internvl2-2b", "musicgen-medium"]
REF_EVAL = RA.AnalogCtx(key=None, training=False)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module", params=ARCHS)
def carried(request, tmp_path_factory):
    """(cfg, reference params / labels / hw instance, port params /
    instance), the port's params read from the reference's checkpoint."""
    cfg = get_config(request.param).reduce()
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


def _inputs(cfg, b, s, seed):
    """numpy model inputs: tokens [B, S] (audio [B, S, K]) and, for the
    vlm, ``patch_embeds`` [B, vit_tokens, vit_dim]."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.family == "audio" else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vit_tokens, cfg.vit_dim)).astype(np.float32)
    return out


def _ref_in(inputs: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _port_in(inputs: dict) -> dict:
    return {k: (torch.from_numpy(v).long() if k == "tokens"
                else torch.from_numpy(v)) for k, v in inputs.items()}


def test_labels_and_carry_over(carried):
    cfg, params, labels, _, pp, _ = carried
    flat = _ref_flat(params)
    assert list(flatten_paths(pp)) == list(flat)
    assert T.model_labels(pp, cfg) == labels
    if cfg.family == "vlm":
        assert pp["projector"]["kernel"].shape == (cfg.vit_dim, cfg.d_model)
        assert labels["projector"]["kernel"] == "analog_weight"
    else:
        assert pp["embed"]["codebooks"].shape == (
            cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
        assert pp["lm_head"]["kernel"].shape == (
            cfg.d_model, cfg.num_codebooks * cfg.vocab_size)
    _, own, own_labels = port_build(cfg, 0, device="cpu")
    assert own_labels == labels
    assert {k: tuple(v.shape) for k, v in flatten_paths(own).items()} == {
        k: v.shape for k, v in flat.items()}


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
    inputs = _inputs(cfg, 2, 10, seed=1)
    key = (cfg.name, deploy)
    if key not in _REF_LOGITS:          # the same for both use_pallas
        _REF_LOGITS[key] = ref_apply(rp, cfg, racfg, REF_EVAL,
                                     _ref_in(inputs))[0]
    want = np.asarray(_REF_LOGITS[key])
    got, stats, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                               _port_in(inputs))
    if cfg.family == "audio":
        assert got.shape == (2, 10, cfg.num_codebooks, cfg.vocab_size)
    else:
        assert got.shape == (2, cfg.vit_tokens + 10, cfg.vocab_size)
        assert "projector" in stats
    if deploy in ("analog", "analog_hw"):
        head = tp["lm_head"]
        bound = kref.adc_bound(head["kernel"], head["input_range"],
                               tacfg.out_bound)
        if cfg.family == "audio":
            bound = bound.reshape(cfg.num_codebooks, cfg.vocab_size)
        else:
            bound = bound[:cfg.vocab_size]
        assert_adc_parity(got.numpy(), want, (bound / 127).numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("deploy", ["off", "digital_int4"])
def test_prefill_decode_equals_full_forward(carried, deploy):
    cfg = carried[0]
    _, _, tp, tacfg = _deploy(carried, deploy)
    b, s, sp = 2, 16, 12
    inputs = _port_in(_inputs(cfg, b, s, seed=2))
    toks, extra = inputs["tokens"], {k: v for k, v in inputs.items()
                                     if k != "tokens"}
    off = cfg.vit_tokens if cfg.family == "vlm" else 0
    full, _, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(), inputs)
    caches = T.init_caches(cfg, b, s + off, device="cpu")
    pre, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                {"tokens": toks[:, :sp], **extra},
                                caches=caches)
    errs = [float((pre - full[:, :off + sp]).abs().max())]
    for t in range(sp, s):
        lg, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                   {"tokens": toks[:, t:t + 1]},
                                   caches=caches, pos_offset=off + t)
        errs.append(float((lg[:, 0] - full[:, off + t]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_generate_matches_reference_tokens(carried, deploy):
    """Greedy tokens of ``generate`` equal the reference's: the vlm with
    its patch prefix (``extra_inputs``), the audio model from a ``[2, 3,
    K]`` prompt to ``[2, 5, K]`` tokens (``tests/test_decode.py``'s
    multi-codebook case, greedy)."""
    cfg = carried[0]
    rp, racfg, tp, tacfg = _deploy(carried, deploy)
    inputs = _inputs(cfg, 2, 3, seed=3)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    want = ref_generate(rp, cfg, racfg, jax.random.PRNGKey(4),
                        jnp.asarray(inputs["tokens"]), 5, greedy_first=5,
                        extra_inputs=_ref_in(extra) or None)
    got = port_decode.generate(
        tp, cfg, tacfg, None, torch.from_numpy(inputs["tokens"]).long(), 5,
        greedy_first=5, extra_inputs=_port_in(extra) or None)
    want_shape = (2, 5) + ((cfg.num_codebooks,) if cfg.family == "audio"
                           else ())
    assert tuple(got.shape) == want_shape == np.asarray(want).shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_seeded(carried):
    """Sampled decode (not compared across packages): the same generator
    gives the same tokens, of the reference's shape."""
    cfg, tp = carried[0], carried[4]
    prompt = torch.from_numpy(_inputs(cfg, 2, 3, seed=5)["tokens"]).long()
    acfg = PA.AnalogConfig(mode="off")
    a, b = (port_decode.generate(tp, cfg, acfg,
                                 torch.Generator().manual_seed(9), prompt, 5)
            for _ in range(2))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_continuous_engine_and_training_are_refused(carried, capsys):
    cfg, tp = carried[0], carried[4]
    with pytest.raises(NotImplementedError, match="continuous batching"):
        PS.ServeEngine(tp, cfg, PA.AnalogConfig(mode="off"))
    # training runs now (tests/test_torch_train_vlm_audio.py holds its
    # step against the reference's): a training forward gives finite
    # logits of the serving forward's shape
    logits, _, _ = port_apply(tp, cfg, PA.AnalogConfig(mode="analog"),
                              PA.AnalogCtx(key=(1,), training=True),
                              _port_in(_inputs(cfg, 1, 4, seed=6)))
    s_out = 4 + (cfg.vit_tokens if cfg.family == "vlm" else 0)
    kdim = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    assert tuple(logits.shape) == (1, s_out) + kdim + (cfg.vocab_size,)
    assert bool(torch.isfinite(logits).all())
    toks = serve_cli.main(["--device", "cpu", "--reduced", "--arch",
                           cfg.name.removesuffix("-smoke"), "--num-requests",
                           "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "falling back to the static engine" in out
    want = (2, 3) + ((cfg.num_codebooks,) if cfg.family == "audio" else ())
    assert tuple(toks.shape) == want
