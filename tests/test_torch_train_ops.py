"""The port's training ops against the JAX package's, op by op.

The STE autograd rules (``round_ste``, ``input_quantize``,
``output_quantize``, ``weight_fake_quant``, ``dynamic_input_quantize``,
``noisy_matmul``, ``dispatch.fused_analog_mvm``) and ``analog_linear``'s
training forward are held against ``jax.vjp`` of the reference on the same
seeded numpy inputs, with elements placed on the clip edges and the DAC
rounding boundaries. Training noise is handed to both packages as an
argument (the two frameworks' generators differ); ``analog_linear`` is
compared with the noise off. Then the cases of the reference's
``test_quant.py`` (gradients, range rules), ``test_noise_clip.py``
(clipping) and ``test_train_mechanics.py`` (losses, compression, the AdamW
decay mask), each also against the reference's function.

Tolerances: values and gradients within ``TOL`` = 1e-5 · (1 + |ref|);
clamp masks, DAC codes and forward quantizer outputs exact; ``dbeta``, a
sum over all M·K elements whose fp32 order differs from XLA's, within
``DBETA_TOL`` · (1 + Σ|terms|); ADC-quantized outputs by
``assert_adc_parity``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.core import clipping as ref_clipping
from repro.core import quant as ref_quant
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import ref as jref
from repro.models import mamba2 as ref_mamba
from repro.models import moe as ref_moe
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.optim import schedule as ref_schedule
from repro.train import distill as ref_distill
from repro_torch.core import analog as PA
from repro_torch.core import clipping
from repro_torch.core import devices as PD
from repro_torch.core import noise as noise_lib
from repro_torch.core import quant
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as kref
from repro_torch.models import moe as PM
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train import distill

torch.set_num_threads(2)

TOL = 1e-5
#: |dbeta_port - dbeta_ref| <= DBETA_TOL * (1 + sum |err * g|): a sum over
#: M·K terms in another order than XLA's (fp32 pairwise sums drift by
#: about log2(M·K) · 2^-24 of the sum of magnitudes)
DBETA_TOL = 1e-5


def close(port, ref, tol=TOL):
    """|port - ref| <= tol * (1 + |ref|) elementwise."""
    p = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    err = np.abs(np.asarray(p, np.float64) - r)
    assert np.all(err <= tol * (1 + np.abs(r))), float(err.max())


def t(a, grad=False):
    """numpy → CPU tensor (optionally a leaf that requires grad)."""
    out = torch.from_numpy(np.array(a, np.float32))
    return out.requires_grad_(grad)


def edge_inputs(rng, shape, beta, bits):
    """Activations with some elements exactly on ±beta, some just beyond,
    and some on DAC half-levels (k + 1/2) · beta / Q."""
    q = 2 ** (bits - 1) - 1
    x = rng.standard_normal(shape).astype(np.float32) * beta * 0.7
    flat = x.reshape(-1)
    n = flat.size
    idx = rng.permutation(n)
    flat[idx[0::11]] = beta
    flat[idx[1::11]] = -beta
    flat[idx[2::11]] = np.float32(beta * 1.25)
    k = rng.integers(-q, q, size=flat[idx[3::11]].size)
    flat[idx[3::11]] = ((k + 0.5) * np.float32(beta) / q).astype(np.float32)
    return x


def test_round_ste_value_and_gradient():
    x = np.array([-2.5, -1.5, -0.5, 0.49, 0.5, 1.5, 2.5, 3.7], np.float32)
    xt = t(x, True)
    y = quant.round_ste(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(ref_quant.round_ste(x)))
    y.sum().backward()
    g_ref = jax.grad(lambda v: jnp.sum(ref_quant.round_ste(v)))(x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_ref))


@pytest.mark.parametrize("bits,beta,seed", [(8, 2.0, 0), (6, 0.37, 1),
                                            (8, 1e-9, 2)])
def test_input_quantize_vjp(bits, beta, seed):
    rng = np.random.default_rng(seed)
    x = edge_inputs(rng, (6, 40), max(beta, 1e-3), bits)
    g = rng.standard_normal(x.shape).astype(np.float32)
    b = np.float32(beta)
    y_r, vjp = jax.vjp(lambda xx, bb: ref_quant.input_quantize(xx, bb, bits),
                       jnp.asarray(x), jnp.asarray(b))
    dx_r, db_r = vjp(jnp.asarray(g))
    xt, bt = t(x, True), t(b, True)
    y = quant.input_quantize(xt, bt, bits)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_r))
    y.backward(torch.from_numpy(g))
    # the clamp mask is exact: dx is g or 0 elementwise, as the reference's
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_r))
    bc = max(beta, 1e-8)
    inside = np.abs(x) <= np.float32(bc)
    err = np.where(inside, (np.asarray(y_r) - x) / np.float32(bc),
                   np.sign(x))
    scale = 1 + np.abs(err * g).sum()
    assert bt.grad.shape == ()
    assert abs(float(bt.grad) - float(db_r)) <= DBETA_TOL * scale


def test_input_quantize_gradients_masked():
    """The reference's ``test_input_quantize_gradients_masked``."""
    x = t([[-3.0, -0.5, 0.2, 4.0]], True)
    beta = t(1.0, True)
    quant.input_quantize(x, beta, 8).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0.0, 1.0, 1.0, 0.0]])
    assert np.isfinite(float(beta.grad))


def test_output_quantize_is_a_pure_ste():
    """The reference's ``test_output_quantize_ste_gradient``, and no bound
    gradient."""
    y = torch.linspace(-5, 5, 64).reshape(8, 8).requires_grad_()
    bound = torch.full((8,), 2.0, requires_grad=True)
    yq = quant.output_quantize(y, bound, 8)
    (yq ** 2).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), 2 * yq.detach().numpy(),
                               atol=1e-5)
    assert bound.grad is None
    y_r = np.asarray(ref_quant.output_quantize(
        jnp.asarray(y.detach().numpy()), jnp.full((8,), 2.0),
        jnp.float32(8)))
    np.testing.assert_array_equal(yq.detach().numpy(), y_r)


@pytest.mark.parametrize("fn", ["weight_fake_quant", "dynamic_input_quantize"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fake_quant_vjp(fn, seed):
    """STE rounding, detached ranges: the gradient is the clip's (1/2 at
    each range's own max element, as ``jnp.clip``'s)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    y_r, vjp = jax.vjp(lambda v: getattr(ref_quant, fn)(v, 4),
                       jnp.asarray(w))
    (dw_r,) = vjp(jnp.asarray(g))
    wt = t(w, True)
    y = getattr(quant, fn)(wt, 4)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_r))
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(dw_r))


def test_noisy_matmul_vjp_uses_clean_weights():
    """The reference's ``test_noisy_matmul_backward_uses_clean_weights``,
    and ``jax.vjp`` of its ``noisy_matmul`` with the noise injected."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    nz = (rng.standard_normal(w.shape) * 0.3).astype(np.float32)
    g = rng.standard_normal((2, 8, 12)).astype(np.float32)
    y_r, vjp = jax.vjp(ref_analog.noisy_matmul, jnp.asarray(x),
                       jnp.asarray(w), jnp.asarray(nz))
    dx_r, dw_r, dn_r = vjp(jnp.asarray(g))
    xt, wt = t(x, True), t(w, True)
    y = PA.noisy_matmul(xt, wt, t(nz))
    close(y, y_r)
    y.backward(torch.from_numpy(g))
    close(xt.grad, dx_r)
    close(wt.grad, dw_r)
    assert not np.asarray(dn_r).any()
    # with a huge noise the gradient is still the clean one
    xt.grad = wt.grad = None
    PA.noisy_matmul(xt, wt, torch.full(w.shape, 100.0)).sum().backward()
    close(xt.grad, np.ones((2, 8, 12), np.float32) @ w.T)


@pytest.mark.parametrize("m,k,n,with_noise", [(24, 40, 48, True),
                                              (24, 40, 48, False),
                                              (7, 33, 20, True)])
def test_fused_analog_mvm_vjp(m, k, n, with_noise):
    """Forward on ``w + w_noise`` against the noise-free bound, backward
    the unfused STE chain: against ``jax.vjp`` of the reference's
    ``dispatch.fused_analog_mvm`` (its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(m + k + n)
    beta = np.float32(2.0)
    x = edge_inputs(rng, (2, m // 2, k) if m % 2 == 0 else (m, k), beta, 8)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    colmax = np.abs(w).max(0, keepdims=True)
    nz = (0.02 * colmax * rng.standard_normal(w.shape)).astype(np.float32) \
        if with_noise else np.zeros_like(w)
    g = rng.standard_normal(x.shape[:-1] + (n,)).astype(np.float32)
    bound = np.asarray(jref.adc_bound(jnp.asarray(w), jnp.asarray(beta),
                                      14.0))
    y_r, vjp = jax.vjp(
        lambda xx, ww, bb: ref_dispatch.fused_analog_mvm(
            xx, ww, jnp.asarray(nz), bb, jnp.asarray(bound)),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    dx_r, dw_r, db_r = vjp(jnp.asarray(g))

    xt, wt, bt = t(x, True), t(w, True), t(beta, True)
    bound_t = kref.adc_bound(wt.detach(), bt.detach(), 14.0)
    np.testing.assert_array_equal(bound_t.numpy(), bound)
    y = dispatch.fused_analog_mvm(xt, wt, t(nz) if with_noise else None, bt,
                                  bound_t)
    lsb = bound / 127.0
    assert_adc_parity(y.detach().numpy(), np.asarray(y_r), lsb)
    y.backward(torch.from_numpy(g))
    close(xt.grad, dx_r)
    close(wt.grad, dw_r)
    # the clamp mask is exact
    np.testing.assert_array_equal(xt.grad.numpy() == 0,
                                  np.asarray(dx_r) == 0)
    xq = np.asarray(ref_quant.input_quantize(jnp.asarray(x), beta, 8))
    inside = np.abs(x) <= beta
    err = np.where(inside, (xq - x) / beta, np.sign(x))
    dxq = g @ w.T
    assert abs(float(bt.grad) - float(db_r)) <= DBETA_TOL * (
        1 + np.abs(err * dxq).sum())
    assert k_analog.launches == 0


def test_fused_backward_equals_unfused_chain_autograd():
    """The fused Function's gradients equal plain autograd through the
    port's unfused chain (``input_quantize`` → ``noisy_matmul`` →
    ``output_quantize``) on the same inputs."""
    rng = np.random.default_rng(9)
    x = edge_inputs(rng, (3, 5, 32), 1.5, 8)
    w = (rng.standard_normal((32, 24)) * 0.2).astype(np.float32)
    nz = (0.02 * rng.standard_normal(w.shape)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((3, 5, 24)).astype(np.float32))
    grads = []
    for fused in (True, False):
        xt, wt, bt = t(x, True), t(w, True), t(1.5, True)
        bound = kref.adc_bound(wt.detach(), bt.detach(), 12.0)
        if fused:
            y = dispatch.fused_analog_mvm(xt, wt, t(nz), bt, bound)
        else:
            y = quant.output_quantize(PA.noisy_matmul(
                quant.input_quantize(xt, bt, 8), wt, t(nz)), bound, 8)
        y.backward(g)
        grads.append((xt.grad, wt.grad, bt.grad))
    for a, b in zip(*grads):
        close(a, b.numpy())


def test_fused_refuses_a_folded_bound_beside_noise():
    w = torch.randn(8, 4)
    with pytest.raises(ValueError, match="noise-free"):
        dispatch.fused_analog_mvm(torch.randn(2, 8), w, torch.randn(8, 4),
                                  torch.tensor(1.0), lam=12.0)


# ---------------------------------------------------------------------------
# the batched (MoE expert) site, the SSD and the MoE layer in training
# ---------------------------------------------------------------------------

E_SITE, K_SITE, N_SITE = 4, 24, 20


def _batched_site(seed, with_noise):
    """x [E, 2, 3, K] with edge elements, w [E, K, N] with each expert on
    its own scale, eq. (3) noise per expert, the noise-free [E, N] bound
    and an upstream gradient, as numpy."""
    rng = np.random.default_rng(seed)
    beta = np.float32(1.7)
    x = edge_inputs(rng, (E_SITE, 2, 3, K_SITE), beta, 8)
    scale = (2.0 ** np.arange(E_SITE))[:, None, None]
    w = (rng.standard_normal((E_SITE, K_SITE, N_SITE)) * scale
         * K_SITE ** -0.5).astype(np.float32)
    colmax = np.abs(w).max(1, keepdims=True)
    nz = ((0.02 * colmax * rng.standard_normal(w.shape)).astype(np.float32)
          if with_noise else np.zeros_like(w))
    bound = np.asarray(jax.vmap(lambda ww: jref.adc_bound(
        ww, jnp.asarray(beta), 14.0))(jnp.asarray(w)))
    g = rng.standard_normal((E_SITE, 2, 3, N_SITE)).astype(np.float32)
    return x, w, nz, beta, bound, g


@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "clean"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_batched_site_backward_matches_the_reference_vmap(fused, with_noise):
    """A batched expert site's STE backward against ``jax.vjp`` of the
    reference's per-expert site vmapped over the experts (its
    ``dispatch.fused_analog_mvm`` with the Pallas kernel in interpret
    mode; unfused ``noisy_matmul ∘ input_quantize``), the input range
    shared: dx and each expert's dw on its own rows (the 2-D helper took
    ``w.T`` of all three dims and one dw over every row), dbeta summed
    over every expert and row."""
    x, w, nz, beta, bound, g = _batched_site(11, with_noise)
    if fused:
        def one(xx, ww, nn, bb, bd):
            return ref_dispatch.fused_analog_mvm(xx, ww, nn, bb, bd)
    else:
        def one(xx, ww, nn, bb, bd):
            return ref_analog.noisy_matmul(
                ref_quant.input_quantize(xx, bb, 8), ww, nn)
    y_r, vjp = jax.vjp(
        lambda xx, ww, bb: jax.vmap(one, in_axes=(0, 0, 0, None, 0))(
            xx, ww, jnp.asarray(nz), bb, jnp.asarray(bound)),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta))
    dx_r, dw_r, db_r = vjp(jnp.asarray(g))

    xt, wt, bt = t(x, True), t(w, True), t(beta, True)
    if fused:
        bound_t = kref.adc_bound(wt.detach(), bt.detach(), 14.0)
        np.testing.assert_array_equal(bound_t.numpy(), bound)
        y = dispatch.fused_analog_mvm(xt, wt, t(nz) if with_noise else None,
                                      bt, bound_t)
        assert_adc_parity(y.detach().numpy(), np.asarray(y_r),
                          (bound / 127.0)[:, None, None, :])
    else:
        y = PA.noisy_matmul(quant.input_quantize(xt, bt, 8), wt, t(nz))
        close(y, y_r)
    y.backward(torch.from_numpy(g))
    close(xt.grad, dx_r)
    close(wt.grad, dw_r)
    np.testing.assert_array_equal(xt.grad.numpy() == 0,
                                  np.asarray(dx_r) == 0)
    xq = np.asarray(ref_quant.input_quantize(jnp.asarray(x), beta, 8))
    inside = np.abs(x) <= beta
    err = np.where(inside, (xq - x) / beta, np.sign(x))
    dxq = np.einsum("eabn,ekn->eabk", g, w)
    assert abs(float(bt.grad) - float(db_r)) <= DBETA_TOL * (
        1 + np.abs(err * dxq).sum())
    # each expert's dw is its own rows' x_qᵀ g
    for e in range(E_SITE):
        close(wt.grad[e], xq[e].reshape(-1, K_SITE).T
              @ g[e].reshape(-1, N_SITE))
    assert k_analog.launches == 0


def test_batched_training_noise_is_per_expert(monkeypatch):
    """A batched site's training noise is each expert's own eq. (3) draw:
    ``noise / (gamma · colmax_e)`` over the expert's own K has mean 0 and
    std 1 within 5 standard errors for every expert (experts whose scales
    differ by 8x; the max over the experts would shrink the small ones'
    std), and the experts' draws are uncorrelated within 5 / sqrt(n)."""
    gamma = 0.05
    calls = []
    real = noise_lib.gaussian_weight_noise

    def spy(gen, w, g, beta_mult=0.0, axis=0):
        out = real(gen, w, g, beta_mult, axis)
        calls.append((w.detach().clone(), out.clone()))
        return out

    monkeypatch.setattr(noise_lib, "gaussian_weight_noise", spy)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((4, 96, 80))
         * (2.0 ** np.arange(4))[:, None, None]).astype(np.float32)
    p = {"kernel": t(w, True), "input_range": t([3.0], True)}
    for use_pallas in (False, True):
        acfg = PA.AnalogConfig(mode="analog", gamma_weight=gamma,
                               use_pallas=use_pallas)
        y, _ = PA.analog_linear(p, torch.randn(4, 6, 96), acfg,
                                PA.AnalogCtx(key=(3, 1), training=True))
        y.sum().backward()
    assert len(calls) == 2
    assert torch.equal(calls[0][1], calls[1][1])   # keyed, not stateful
    wt, nz = calls[0]
    colmax = torch.amax(torch.abs(wt), dim=1, keepdim=True)
    z = (nz / (gamma * colmax)).double()
    n = z[0].numel()
    for e in range(4):
        assert abs(float(z[e].mean())) < 5 / n ** 0.5, e
        assert abs(float(z[e].std()) - 1) < 5 / (2 * n) ** 0.5, e
        for f in range(e):
            a, b = z[e].reshape(-1), z[f].reshape(-1)
            corr = float(((a - a.mean()) * (b - b.mean())).mean()
                         / (a.std() * b.std()))
            assert abs(corr) < 5 / n ** 0.5, (e, f, corr)


#: |port - reference| <= SSD_GRAD_TOL * (1 + |reference|) for every SSD
#: gradient: both differentiate the same chunked fp32 math, whose sums run
#: in other orders (test_torch_ssd.py's SSD_TOL is 2e-4)
SSD_GRAD_TOL = 1e-4


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", [(2, 13, 4, 16, 2, 8),
                                   (1, 130, 4, 8, 1, 16)], ids=str)
def test_ssd_gradients_match_the_reference(shape, with_h0):
    """``dispatch.ssd``'s gradients (x, dt, a, b, c and h0, from the
    upstream gradients of y and of the final state) against ``jax.vjp``
    of the reference's ``mamba2._ssd_with_state`` (its chunked jnp path,
    which XLA differentiates); and the autograd Function that the card
    runs (kernel forward, the plain version rebuilt and differentiated in
    the backward), run here on CPU tensors, equal to differentiating the
    plain version directly, bit for bit, with and without the final
    state's gradient."""
    bsz, s, h, p, g, n = shape
    rng = np.random.default_rng(sum(shape))
    ins = [rng.standard_normal((bsz, s, h, p)),
           np.log1p(np.exp(0.5 * rng.standard_normal((bsz, s, h)))) * 0.5,
           -np.exp(0.3 * rng.standard_normal(h)),
           0.3 * rng.standard_normal((bsz, s, g, n)),
           0.3 * rng.standard_normal((bsz, s, g, n))]
    if with_h0:
        ins.append(rng.standard_normal((bsz * h, n, p)))
    ins = [v.astype(np.float32) for v in ins]
    gy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    gh = rng.standard_normal((bsz * h, n, p)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: ref_mamba._ssd_with_state(*a),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    def grads(fn, with_gh=True):
        leaves = [t(v, True) for v in ins]
        y, hf = fn(*leaves)
        torch.autograd.backward(
            [y, hf] if with_gh else [y],
            [torch.from_numpy(gy), torch.from_numpy(gh)][:2 if with_gh
                                                         else 1])
        return [v.grad for v in leaves]

    got = grads(dispatch.ssd)
    for name, a, b in zip(("x", "dt", "a", "b", "c", "h0"), got, want):
        b = np.asarray(b, np.float64)
        err = np.abs(a.numpy() - b)
        assert np.all(err <= SSD_GRAD_TOL * (1 + np.abs(b))), (
            name, float(err.max()))
    for with_gh in (True, False):
        direct = grads(dispatch.ssd, with_gh)
        via_fn = grads(dispatch._SSD.apply if with_h0 else
                       (lambda *a: dispatch._SSD.apply(*a, None)), with_gh)
        for a, b in zip(direct, via_fn):
            assert torch.equal(a, b)


def _moe_cfg(arch):
    return dataclasses.replace(get_config(arch).reduce(),
                               capacity_factor=1.25)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_layer_gradients_match_the_reference(arch, fused):
    """The MoE layer in training (noise off, statistics on): the gradients
    of ``sum(y · g) + 0.3 · aux_loss`` with respect to x, the router, both
    expert kernels and both input ranges against ``jax.grad`` of the
    reference's ``models/moe.py::moe``; a dropped assignment's token row
    gets no gradient through it, the site statistics are detached and
    ``aux_loss`` is not."""
    cfg = _moe_cfg(arch)
    rng = np.random.default_rng(6)
    p = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(2),
                                                  cfg))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(mode="analog", train_noise=False, use_pallas=fused)

    def ref_loss(pp, xx):
        y, st = ref_moe.moe(pp, xx, cfg, ref_analog.AnalogConfig(**kw),
                            ref_analog.AnalogCtx(key=None, training=True,
                                                 collect_stats=True))
        return jnp.sum(y * g) + 0.3 * st["router"]["aux_loss"], (y, st)

    (l_r, (y_r, st_r)), (gp_r, gx_r) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    pt = jax.tree.map(lambda v: t(v, True), p)
    xt = t(x, True)
    y, st = PM.moe(pt, xt, cfg, PA.AnalogConfig(**kw),
                   PA.AnalogCtx(training=True, collect_stats=True))
    assert st["router"]["aux_loss"].requires_grad
    assert not any(v.requires_grad for site in ("gate_up", "down")
                   for v in st[site].values())
    loss = (y * torch.from_numpy(g)).sum() + 0.3 * st["router"]["aux_loss"]
    close(loss, l_r)
    close(y, y_r)
    close(st["router"]["aux_loss"], st_r["router"]["aux_loss"])
    loss.backward()
    close(xt.grad, gx_r)
    close(pt["router"]["kernel"].grad, gp_r["router"]["kernel"])
    assert bool(pt["router"]["kernel"].grad.abs().sum() > 0)
    for site in ("gate_up", "down"):
        close(pt[site]["kernel"].grad, gp_r[site]["kernel"])
        close(pt[site]["input_range"].grad, gp_r[site]["input_range"])


def test_moe_dropped_assignments_get_no_gradient():
    """With a capacity of 1 most assignments drop to the spare row: each
    token's gradient is the sum over its kept assignments only, which a
    moe whose dropped experts are cut out of the combine reproduces."""
    cfg = dataclasses.replace(get_config("dbrx-132b").reduce(),
                              capacity_factor=0.01)
    gen = torch.Generator().manual_seed(3)
    p = PM.init_moe(gen, cfg)
    x = torch.randn((2, 12, cfg.d_model), generator=gen, requires_grad=True)
    acfg = PA.AnalogConfig(mode="off")
    cap = PM.moe_capacity(12, cfg.num_experts, cfg.top_k, 0.01)
    _, _, row, order, _ = PM._route(x.detach(), p["router"]["kernel"], cfg,
                                    cap)
    drop = cfg.num_experts * 2 * cap
    assert int((row == drop).sum()) > 0
    # the tokens whose every assignment dropped get no expert gradient:
    # theirs comes through the router only, so with the router frozen
    # (detached) their rows of x.grad are exactly 0
    p_frozen = dict(p, router={"kernel": p["router"]["kernel"].detach()})
    y, _ = PM.moe(p_frozen, x, cfg, acfg, PA.AnalogCtx(training=True))
    y.sum().backward()
    kept = torch.zeros((2, 12 * cfg.top_k), dtype=torch.bool)
    kept.scatter_(1, order, row < drop)
    tok_kept = kept.reshape(2, 12, cfg.top_k).any(-1)
    assert bool((~tok_kept).any()) and bool(tok_kept.any())
    grad_rows = x.grad.abs().sum(-1)
    assert bool((grad_rows[~tok_kept] == 0).all())
    assert bool((grad_rows[tok_kept] > 0).all())


def _ref_site(p, x, acfg, training=True):
    return ref_analog.analog_linear(
        p, x, acfg, ref_analog.AnalogCtx(key=None, training=training,
                                         collect_stats=True))


@pytest.mark.parametrize("mode,fused", [("analog", False), ("analog", True),
                                        ("qat", False), ("di8", False),
                                        ("off", False)])
def test_analog_linear_training_gradients(mode, fused):
    """One site's training forward with the noise off: outputs, stats and
    the gradients of every parameter and of the input against
    ``jax.grad`` of the reference's ``analog_linear``."""
    rng = np.random.default_rng(5)
    k, n = 48, 40
    p = {"kernel": (rng.standard_normal((k, n)) * k ** -0.5
                    ).astype(np.float32),
         "input_range": np.full((1,), 1.8, np.float32),
         "bias": (rng.standard_normal(n) * 0.1).astype(np.float32)}
    x = edge_inputs(rng, (2, 6, k), 1.8, 8)
    g = rng.standard_normal((2, 6, n)).astype(np.float32)
    kw = dict(mode=mode, use_pallas=fused, train_noise=False, out_bound=8.0)
    rcfg = ref_analog.AnalogConfig(**kw)

    def f(pp, xx):
        y, st = _ref_site(pp, xx, rcfg)
        return jnp.sum(y * g), (y, st)

    (_, (y_r, st_r)), (gp_r, gx_r) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    pt = {key: t(v, True) for key, v in p.items()}
    xt = t(x, True)
    y, st = PA.analog_linear(pt, xt, PA.AnalogConfig(**kw),
                             PA.AnalogCtx(training=True, collect_stats=True))
    if mode == "analog":
        bound = jref.adc_bound(p["kernel"], jnp.float32(1.8), 8.0)
        assert_adc_parity(y.detach().numpy(), np.asarray(y_r),
                          np.asarray(bound) / 127.0)
    else:
        close(y, y_r)
    if mode != "off":
        for key in ("x_std", "x_absmax", "clip_frac"):
            close(st[key], st_r[key])
    (y * torch.from_numpy(g)).sum().backward()
    close(xt.grad, gx_r)
    close(pt["kernel"].grad, gp_r["kernel"])
    close(pt["bias"].grad, gp_r["bias"])
    if mode in ("analog", "qat"):
        xq = np.asarray(ref_quant.input_quantize(jnp.asarray(x), 1.8, 8))
        scale = 1 + np.abs(xq).sum() * np.abs(g).sum()
        assert abs(float(pt["input_range"].grad[0])
                   - float(gp_r["input_range"][0])) <= DBETA_TOL * scale
    else:
        assert pt["input_range"].grad is None or not bool(
            pt["input_range"].grad.any())


def test_training_forward_refusals_and_device_state():
    """``rtn`` is eval-only; the per-tile ``device`` sub-dict is ignored in
    training (as the reference does), and at eval a null device state
    (no variation, no faults, at ``t = 0``) changes no bit; the SSD,
    which refused an input that needs a gradient before its backward was
    ported, now differentiates it (``test_ssd_gradients_match_the_
    reference`` holds the values)."""
    p = {"kernel": torch.randn(16, 8), "input_range": torch.full((1,), 2.0)}
    x = torch.randn(2, 3, 16)
    train = PA.AnalogCtx(training=True)
    with pytest.raises(NotImplementedError, match="rtn"):
        PA.analog_linear(p, x, PA.AnalogConfig(mode="rtn"), train)
    acfg = PA.AnalogConfig(mode="analog", train_noise=False)
    y_dev, _ = PA.analog_linear({**p, "device": {}}, x, acfg, train)
    y, _ = PA.analog_linear(p, x, acfg, train)
    assert torch.equal(y, y_dev)
    null = PD.attach_device_state(
        {"l": p}, {"l": PA.linear_labels(p)}, torch.Generator(),
        PD.DeviceConfig(sigma_gain=0.0, nu_median=0.0, nu_sigma=0.0))
    y_null, _ = PA.analog_linear(null["l"], x, acfg, PA.AnalogCtx())
    assert torch.equal(y_null, PA.analog_linear(p, x, acfg,
                                                PA.AnalogCtx())[0])
    xs = torch.randn(1, 4, 2, 8, requires_grad=True)
    y, h = dispatch.ssd(xs, torch.rand(1, 4, 2), -torch.rand(2),
                        torch.randn(1, 4, 1, 4), torch.randn(1, 4, 1, 4))
    assert y.requires_grad and h.requires_grad
    y.sum().backward()
    assert xs.grad is not None and bool(torch.isfinite(xs.grad).all())


def test_training_noise_is_drawn_from_the_key_and_detached():
    """With a key the analog site draws ``gamma · colmax · tau`` from the
    key's own generator: the same key gives the same output, another key
    another one, and no gradient reaches the noise."""
    torch.manual_seed(0)
    p = {"kernel": torch.randn(32, 16).requires_grad_(),
         "input_range": torch.full((1,), 3.0)}
    x = torch.randn(4, 32)
    acfg = PA.AnalogConfig(mode="analog", output_quant=False)
    outs = [PA.analog_linear(p, x, acfg, PA.AnalogCtx(key=key,
                                                      training=True))[0]
            for key in ((1, 2), (1, 2), (1, 3))]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    outs[0].sum().backward()
    xq = quant.input_quantize(x, torch.tensor(3.0), 8)
    torch.testing.assert_close(p["kernel"].grad,
                               xq.T @ torch.ones(4, 16), rtol=0, atol=1e-5)


def test_ema_init_and_decay_rules():
    """The reference's ``test_ema_init_and_decay_rules``, and its
    functions' values."""
    beta = torch.tensor(5.0)
    one = torch.tensor(1.0)
    assert float(quant.ema_init_update(beta, one, 0, 15.0, 10)) == 15.0
    b2 = float(quant.ema_init_update(beta, one, 5, 15.0, 10))
    assert 5.0 < b2 < 15.0
    assert float(quant.ema_init_update(beta, one, 20, 15.0, 10)) == 5.0
    d1 = quant.range_decay_update(beta, torch.tensor(0.0), 20, 0.01, 0.95, 10)
    assert float(d1) == pytest.approx(5.0 * 0.99)
    assert float(quant.range_decay_update(beta, torch.tensor(0.5), 20, 0.01,
                                          0.95, 10)) == 5.0
    assert float(quant.range_decay_update(beta, torch.tensor(0.0), 5, 0.01,
                                          0.95, 10)) == 5.0
    rng = np.random.default_rng(0)
    b = rng.uniform(1, 20, 6).astype(np.float32)
    s = rng.uniform(0, 2, 6).astype(np.float32)
    cf = rng.uniform(0, 0.1, 6).astype(np.float32)
    for step in (0, 3, 9, 10, 40):
        e_r = ref_quant.ema_init_update(b, s, jnp.int32(step), 18.0, 10)
        e = quant.ema_init_update(t(b), t(s), step, 18.0, 10)
        np.testing.assert_array_equal(e.numpy(), np.asarray(e_r))
        d_r = ref_quant.range_decay_update(b, cf, jnp.int32(step), 0.01,
                                           0.95, 10)
        d = quant.range_decay_update(t(b), t(cf), step, 0.01, 0.95, 10)
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))


@pytest.mark.parametrize("seed,alpha", [(0, 1.5), (7, 2.5), (123, 4.0)])
def test_clip_weight_bound(seed, alpha):
    """The reference's ``test_clip_weight_bound``, and its values."""
    w = np.random.default_rng(seed).standard_normal((128, 32)).astype(
        np.float32)
    wc = clipping.clip_weight(t(w), alpha).numpy()
    assert np.all(np.abs(wc) <= alpha * w.std(axis=0) + 1e-5)
    wcc = clipping.clip_weight(t(wc), alpha).numpy()
    assert np.abs(wcc).max() <= np.abs(wc).max() + 1e-6
    assert wcc.std() <= wc.std() + 1e-6
    close(wc, ref_clipping.clip_weight(jnp.asarray(w), alpha))


def test_clipping_reduces_kurtosis():
    """The reference's ``test_clipping_reduces_kurtosis`` (heavy-tailed
    weights from numpy's Student t)."""
    w = np.random.default_rng(2).standard_t(3.0, 4096).astype(
        np.float32).reshape(256, 16)
    k_before = float(clipping.kurtosis(t(w)))
    k_after = float(clipping.kurtosis(clipping.clip_weight(t(w), 3.0)))
    assert k_after < k_before
    close(torch.tensor(k_before),
          ref_clipping.kurtosis(jnp.asarray(w)))


def test_clip_tree_only_touches_analog_weights():
    """The reference's ``test_clip_tree_only_touches_analog_weights``, on
    a stacked [L, in, out] leaf too (std over axis -2 within a layer)."""
    rng = np.random.default_rng(4)
    params = {"a": {"kernel": rng.standard_normal((3, 16, 8)).astype(
                        np.float32) * 10,
                    "input_range": np.ones((3, 1), np.float32)},
              "n": {"scale": np.ones((4,), np.float32) * 10}}
    labels = {"a": {"kernel": "analog_weight", "input_range": "input_range"},
              "n": {"scale": "digital"}}
    out = clipping.clip_tree({k: {kk: t(v) for kk, v in d.items()}
                              for k, d in params.items()}, labels, 2.0)
    out_r = ref_clipping.clip_tree(jax.tree.map(jnp.asarray, params), labels,
                                   2.0)
    assert float(out["n"]["scale"].max()) == 10.0
    close(out["a"]["kernel"], out_r["a"]["kernel"])
    np.testing.assert_array_equal(out["a"]["input_range"].numpy(),
                                  params["a"]["input_range"])


def test_kd_and_ce_losses():
    """The reference's ``test_kd_loss_properties`` and
    ``test_ce_loss_matches_manual``, and both losses against its
    functions."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 8, 32)).astype(np.float32)
    b = a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
    assert float(distill.kd_loss(t(a), t(a))) == pytest.approx(0.0, abs=1e-6)
    assert float(distill.kd_loss(t(b), t(a))) > 0
    assert float(distill.kd_loss(t(a), t(a), 2.0)) == pytest.approx(
        0.0, abs=1e-6)
    mask = np.zeros((4, 8), np.float32)
    mask[:, :4] = 1.0
    c = a.copy()
    c[:, 4:] = 100.0
    assert float(distill.kd_loss(t(c), t(a), mask=t(mask))) == pytest.approx(
        0.0, abs=1e-5)
    for temp in (1.0, 2.0):
        close(distill.kd_loss(t(b), t(a), temp, t(mask)),
              ref_distill.kd_loss(b, a, temp, mask))
    labels = rng.integers(0, 32, (4, 8))
    lp = torch.log_softmax(t(b), -1).numpy()
    manual = -np.mean(lp[np.arange(4)[:, None], np.arange(8), labels])
    assert float(distill.ce_loss(t(b), torch.from_numpy(labels))) == \
        pytest.approx(float(manual), rel=1e-5)
    close(distill.ce_loss(t(b), torch.from_numpy(labels), t(mask)),
          ref_distill.ce_loss(b, labels, mask))
    inp, lab, m = distill.shift_for_next_token(torch.arange(12).reshape(2, 6))
    r_inp, r_lab, r_m = ref_distill.shift_for_next_token(
        jnp.arange(12).reshape(2, 6))
    for p_, r_ in ((inp, r_inp), (lab, r_lab), (m, r_m)):
        np.testing.assert_array_equal(p_.numpy(), np.asarray(r_))


def test_schedule_matches_the_reference():
    for step in (0, 1, 3, 16, 17, 500, 999, 1000, 1200):
        for ratio in (0.016, 0.0):
            r = ref_schedule.polynomial_with_warmup(
                step, peak_lr=1e-4, total_steps=1000, warmup_ratio=ratio)
            p = schedule.polynomial_with_warmup(
                step, peak_lr=1e-4, total_steps=1000, warmup_ratio=ratio)
            close(p, r, 1e-6)


def _opt_tree(rng):
    return ({"a": {"kernel": rng.standard_normal((3, 8, 6)),
                   "input_range": rng.uniform(1, 3, (3, 1))},
             "ln": {"scale": rng.standard_normal((3, 6))},
             "b": rng.standard_normal((6,)),
             "emb": rng.standard_normal((10, 6))},
            {"a": {"kernel": "analog_weight", "input_range": "input_range"},
             "ln": {"scale": "digital"}, "b": "digital", "emb": "digital"})


def _np32(tree):
    return {k: _np32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def _tt(tree):
    return {k: _tt(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_adamw_update_matches_the_reference(max_norm):
    """Three AdamW steps (global-norm clipping active and not) on a tree of
    every label: parameters, moments, count and norm against the
    reference's ``adamw_update``."""
    rng = np.random.default_rng(1)
    params, labels = _opt_tree(rng)
    params = _np32(params)
    cfg_r = ref_adamw.AdamWConfig(max_grad_norm=max_norm)
    cfg_p = adamw.AdamWConfig(max_grad_norm=max_norm)
    p_r, o_r = jax.tree.map(jnp.asarray, params), ref_adamw.init_opt_state(
        params)
    p_p = _tt(params)
    o_p = adamw.init_opt_state(p_p)
    for i in range(3):
        grads = _np32(jax.tree.map(lambda v: rng.standard_normal(v.shape),
                                   params))
        lr = np.float32(1e-2 * (i + 1))
        p_r, o_r, n_r = ref_adamw.adamw_update(p_r, grads, o_r, labels,
                                               jnp.float32(lr), cfg_r)
        p_p, o_p, n_p = adamw.adamw_update(p_p, _tt(grads), o_p, labels,
                                           torch.tensor(lr), cfg_p)
        close(n_p, n_r, 1e-6)
        assert int(o_p["count"]) == int(o_r["count"]) == i + 1
        for tree_p, tree_r in ((p_p, p_r), (o_p["m"], o_r["m"]),
                               (o_p["v"], o_r["v"])):
            for a, b in zip(jax.tree.leaves(jax.tree.map(
                    lambda v: v.numpy(), tree_p)), jax.tree.leaves(tree_r)):
                close(a, b, 1e-6)


def test_adamw_decay_mask():
    """The reference's ``test_adamw_decay_mask``."""
    params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,))}
    labels = {"w": "analog_weight", "scale": "digital"}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = adamw.adamw_update(params, grads, adamw.init_opt_state(params),
                                  labels, torch.tensor(0.1),
                                  adamw.AdamWConfig(weight_decay=0.1))
    assert float(p2["w"][0, 0]) < 1.0
    assert float(p2["scale"][0]) == 1.0


def test_compression_error_feedback():
    """The reference's ``test_compression_error_feedback_reduces_bias``,
    and each step's values against its ``compress_grads``."""
    g = np.random.default_rng(3).standard_normal((64, 64)).astype(
        np.float32) * 1e-3
    err = compression.init_error_state({"w": t(g)})
    err_r = ref_compression.init_error_state({"w": jnp.asarray(g)})
    total_true = np.zeros((64, 64))
    total_deq = np.zeros((64, 64))
    for i in range(20):
        gi = (g * np.float32(1 + 0.1 * i)).astype(np.float32)
        deq, err = compression.compress_grads({"w": t(gi)}, err)
        deq_r, err_r = ref_compression.compress_grads({"w": jnp.asarray(gi)},
                                                      err_r)
        close(deq["w"], deq_r["w"], 1e-6)
        close(err["w"], err_r["w"], 1e-6)
        total_true += gi
        total_deq += deq["w"].numpy()
    rel = np.linalg.norm(total_deq - total_true) / np.linalg.norm(total_true)
    assert rel < 0.05
