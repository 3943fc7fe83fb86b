"""``analog_linear`` of the port against the reference, mode by mode.

Both packages run one linear site on the same seeded numpy parameters and
activations, with ``use_pallas`` off and on (on the CPU the port's "on"
runs the kernels' plain versions, the reference's its Pallas kernels in
interpret mode is left to its own suite: here its unfused path is the
oracle). Deployment noise is drawn once by the reference and applied on
both sides, since the two frameworks' generators differ; the port's own
PCM sampler is checked by distribution.

Tolerances: ADC-quantized outputs (``analog``, ``rtn``) use
``assert_adc_parity``; ``off`` / ``qat`` / ``di8`` use
``rtol = atol = 1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.core import analog as ref_analog
from repro.core import noise as ref_noise
from repro.kernels import ref as jref
from repro_torch.core import analog as port_analog
from repro_torch.core import noise as port_noise
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import int4_matmul as k_int4

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
REF_EVAL = ref_analog.AnalogCtx(key=None, training=False)
PORT_EVAL = port_analog.AnalogCtx()
MODES = ["off", "analog", "qat", "di8", "rtn"]


def _site(k, n, seed, bias=True):
    """One linear site and [B, S, K] activations as numpy."""
    rng = np.random.default_rng(seed)
    p = {"kernel": (rng.standard_normal((k, n)) * k ** -0.5
                    ).astype(np.float32),
         "input_range": np.full((1,), 2.5, np.float32)}
    if bias:
        p["bias"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    return p, x


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _lsb(p, acfg):
    """Per-column ADC step of a site (RTN-dequantized weights in rtn)."""
    w = jnp.asarray(p["kernel"])
    if acfg.mode == "rtn":
        from repro.core import quant
        w = quant.rtn_dequantize(*quant.rtn_quantize(w, acfg.weight_bits))
    bound = jref.adc_bound(w, jnp.asarray(p["input_range"][0]),
                           acfg.out_bound)
    return np.asarray(bound) / (2 ** (acfg.output_bits - 1) - 1)


def _compare(y_port, y_ref, p, mode, acfg):
    y_port, y_ref = y_port.numpy(), np.asarray(y_ref)
    assert y_port.shape == y_ref.shape
    if mode in ("analog", "rtn"):
        # the bias is added after the ADC; parity is on the ADC output
        b = p.get("bias", 0.0)
        assert_adc_parity(y_port - b, y_ref - b, _lsb(p, acfg))
    else:
        np.testing.assert_allclose(y_port, y_ref, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n", [(64, 96), (300, 257)])
def test_analog_linear_matches_reference(mode, use_pallas, k, n):
    p, x = _site(k, n, seed=k + n)
    acfg_ref = ref_analog.AnalogConfig(mode=mode)   # reference: unfused
    acfg = port_analog.AnalogConfig(mode=mode, use_pallas=use_pallas)
    y_ref, st_ref = ref_analog.analog_linear(
        _jax(p), jnp.asarray(x), acfg_ref,
        dataclasses.replace(REF_EVAL, collect_stats=True))
    y_port, st_port = port_analog.analog_linear(
        _torch(p), torch.from_numpy(x), acfg,
        dataclasses.replace(PORT_EVAL, collect_stats=True))
    _compare(y_port, y_ref, p, mode, acfg_ref)
    assert set(st_port) == set(st_ref)
    for key in st_ref:
        np.testing.assert_allclose(np.asarray(st_port[key]),
                                   np.asarray(st_ref[key]), **TOL)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "on_the_fly"])
def test_int4_serve_matches_reference_rtn(packed):
    p, x = _site(300, 258, seed=1)
    labels = ref_analog.linear_labels(p)
    acfg_ref = ref_analog.AnalogConfig(mode="rtn", weight_bits=4)
    y_ref, _ = ref_analog.analog_linear(_jax(p), jnp.asarray(x), acfg_ref,
                                        REF_EVAL)
    tp = _torch(p)
    if packed:
        tp = port_analog.pack_int4_weights(tp, port_analog.linear_labels(tp))
        ref_packed = ref_analog.pack_int4_weights(_jax(p), labels)["int4"]
        for key in ("packed", "scale", "colmax"):
            np.testing.assert_array_equal(tp["int4"][key].numpy(),
                                          np.asarray(ref_packed[key]))
    acfg = port_analog.AnalogConfig(mode="rtn", weight_bits=4,
                                    use_pallas=True, int4_serve=True)
    y_port, _ = port_analog.analog_linear(tp, torch.from_numpy(x), acfg,
                                          PORT_EVAL)
    _compare(y_port, y_ref, p, "rtn", acfg_ref)


def _two_site_tree(seed):
    """A small tree with stacked [L, K, N] analog weights and digital
    leaves, its labels, in numpy."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"mlp": {
        "kernel": (rng.standard_normal((2, 64, 48)) * 0.1).astype(np.float32),
        "input_range": np.full((2, 1), 3.0, np.float32)}},
        "norm": {"scale": np.ones(64, np.float32)}}
    params["blocks"]["mlp"]["kernel"][0, 5, :] = 0.0     # exact zeros
    labels = {"blocks": {"mlp": {"kernel": "analog_weight",
                                 "input_range": "input_range"}},
              "norm": {"scale": "digital"}}
    return params, labels


@pytest.mark.parametrize("model,gamma", [("hw", 0.0), ("gaussian", 0.05)])
def test_noise_instances_carry_across(model, gamma):
    params, labels = _two_site_tree(0)
    inst = ref_analog.sample_noise_instances(_jax(params), labels,
                                             jax.random.PRNGKey(3), model)
    ref_out = ref_analog.apply_noise_instances(_jax(params), labels, inst,
                                               model, gamma)
    port_out = port_analog.apply_noise_instances(
        _torch(params), labels, _torch(jax.tree.map(np.asarray, inst)),
        model, gamma)
    for path in (("blocks", "mlp", "kernel"), ("blocks", "mlp", "input_range"),
                 ("norm", "scale")):
        a, b = port_out, ref_out
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_pcm_hermes_noise_distribution():
    """Per-element std of the port's PCM sampler against the reference's
    ``pcm_hermes_sigma`` polynomial: ``noise / sigma`` must be standard
    normal overall (mean and std within 0.01 for 2^18 draws, ~5 standard
    errors) and in each weight-magnitude quartile (std within 0.03);
    exact zeros stay exactly zero."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((1024, 256)).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = 0.0
    gen = torch.Generator().manual_seed(0)
    noise = port_noise.pcm_hermes_noise(gen, torch.from_numpy(w)).numpy()
    assert noise.dtype == np.float32
    zero = w == 0
    assert np.all(noise[zero] == 0.0)
    wmax = np.max(np.abs(w), axis=0, keepdims=True)
    pct = 100.0 * np.abs(w) / wmax
    sigma = np.asarray(ref_noise.pcm_hermes_sigma(jnp.asarray(pct))) \
        / 100.0 * wmax
    z = noise[~zero] / sigma[~zero]
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    mag = pct[~zero]
    edges = np.quantile(mag, [0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (mag >= lo) & (mag <= hi)
        assert abs(z[sel].std() - 1.0) < 0.03, (lo, hi, z[sel].std())


def test_perturb_and_quantize_for_digital():
    params, labels = _two_site_tree(1)
    tp = _torch(params)
    gen = torch.Generator().manual_seed(0)
    pert = port_analog.perturb_analog_weights(tp, labels, gen, "hw")
    assert pert["norm"]["scale"] is tp["norm"]["scale"]
    d = (pert["blocks"]["mlp"]["kernel"] - tp["blocks"]["mlp"]["kernel"])
    assert float(d.abs().max()) > 0 and torch.all(d[0, 5] == 0)
    assert port_analog.perturb_analog_weights(tp, labels, gen, "none") is tp
    with pytest.raises(ValueError):
        port_analog.apply_noise_instances(tp, labels, tp, "gaussian", 0.0)

    ref_q = ref_analog.quantize_for_digital(_jax(params), labels)
    port_q = port_analog.quantize_for_digital(tp, labels)
    np.testing.assert_array_equal(
        port_q["blocks"]["mlp"]["kernel"].numpy(),
        np.asarray(ref_q["blocks"]["mlp"]["kernel"]))


def test_eval_path_refusals():
    p, x = _site(64, 96, seed=2)
    tp, tx = _torch(p), torch.from_numpy(x)
    acfg = port_analog.AnalogConfig(mode="analog")
    with pytest.raises(NotImplementedError):
        port_analog.analog_linear(tp, tx, acfg,
                                  port_analog.AnalogCtx(training=True))
    with pytest.raises(NotImplementedError):
        port_analog.analog_linear({**tp, "device": {}}, tx, acfg, PORT_EVAL)
    fused = port_analog.AnalogConfig(mode="analog", use_pallas=True)
    needs_grad = {**tp, "kernel": tp["kernel"].clone().requires_grad_()}
    with pytest.raises(NotImplementedError):
        port_analog.analog_linear(needs_grad, tx, fused, PORT_EVAL)
    with torch.no_grad():
        port_analog.analog_linear(needs_grad, tx, fused, PORT_EVAL)
    assert k_analog.launches == 0 and k_int4.launches == 0
