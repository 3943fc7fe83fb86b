"""The port's SpinQuant-lite PTQ baseline (``repro_torch.core.rotations``,
``repro_torch.train.recipes``) against the JAX package's.

Weights are built by the reference and carried across as numpy. Randomness
does not cross between the packages: the port's random signs and QR draws
are checked by their properties, and the parity cases inject the
reference's rotation ``R`` (``_rotate_residual_stream(..., r=R)``).
Tolerances:

* folded and rotated leaves: ``rtol = atol = 1e-5`` (fp32 products that
  XLA and PyTorch sum in other orders);
* FP invariance of the rotated model (rmsnorm archs): log-softmax within
  3e-3, the reference's own bar in ``tests/test_rotations.py``;
* calibrated input ranges: ``1e-5 · (1 + |ref|)``, the fp32 reduction
  bound of a max over site inputs that the two forwards reach through
  differently ordered sums;
* the PTQ model's logits under ``qat`` / ``di8`` / ``rtn``: within
  ``1e-5 · (1 + |ref|)`` at every (row, position) before the row's first
  position apart, and at least ``MIN_HELD`` of the positions so held. The
  two forwards sum in other orders, so a quantizer input that lies at a
  rounding tie (a DAC or dynamic-range code, an ADC level) may round the
  other way; the forward is causal and its rows independent, so such a
  flip moves its position and the later ones of its row, nowhere else
  (``tests/test_torch_eval.py``'s causal reach). Both packages' site
  inputs and outputs are recorded (``_recording_sites``, and each MoE FFN
  as one unit), and every first difference must follow a code at a tie:
  a site's input code one level apart where the scaled input lies within
  the two packages' input difference of a rounding tie, or an ADC level
  apart where the pre-ADC value lies within the fp32 dot error of one, or
  inside a MoE FFN, a routing choice at a router near-tie or such a code
  of its experts.
"""


import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import SITE_TOL, _recording_sites

from repro.configs import get_config
from repro.core import analog as RA
from repro.core import rotations as RR
from repro.models import apply as ref_apply
from repro.models import build as ref_build
from repro.models import moe as ref_moe
from repro.train import recipes as RREC
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as PA
from repro_torch.core import quant as PQ
from repro_torch.core import rotations as PR
from repro_torch.kernels import ref as kref
from repro_torch.models import apply as port_apply
from repro_torch.models import layers as port_layers
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as T
from repro_torch.train import recipes as PREC

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
#: the share of (row, position)s of the PTQ logits that no quantizer flip
#: may reach (see the module docstring)
MIN_HELD = 0.75
ARCHS = ["granite-3-8b", "qwen3-moe-30b-a3b", "dbrx-132b"]
RMS_ARCHS = ["granite-3-8b", "qwen3-moe-30b-a3b"]


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _port_flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v.detach().cpu().numpy()
    return out


def _assert_trees_close(ref_tree, port_tree, **tol):
    a, b = _ref_flat(ref_tree), _port_flat(port_tree)
    assert list(a) == list(b)
    for path in a:
        np.testing.assert_allclose(b[path], a[path], err_msg=path, **tol)


def _randomize_scales(params, key):
    """The reference test's non-trivial norm scales, each leaf's draw keyed
    by a stable hash of its path (Python's ``hash`` of a tuple of strings
    changes from process to process)."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path and path[-1] == "scale":
            k = jax.random.fold_in(key, zlib.crc32("/".join(path).encode())
                                   % (2**31))
            return node * (1.0 + 0.3 * jax.random.normal(k, node.shape))
        return node
    return walk(params)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params with random norm scales, port params)."""
    cfg = get_config(request.param).reduce()
    key = jax.random.PRNGKey(3)
    cfg, params, _ = ref_build(cfg, key)
    params = _randomize_scales(params, key)
    return cfg, params, params_from_numpy(_ref_flat(params), "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _logits(tree, cfg, acfg, toks, port: bool):
    if port:
        out, _, _ = port_apply(tree, cfg, acfg, PA.AnalogCtx(),
                               {"tokens": torch.as_tensor(toks).long()})
        return out.numpy()
    out, _, _ = ref_apply(tree, cfg, acfg, RA.AnalogCtx(key=None,
                                                       training=False),
                          {"tokens": jnp.asarray(toks)})
    return np.asarray(out)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256, 2048])
def test_hadamard_matrix_equals_reference(n):
    np.testing.assert_array_equal(PR.hadamard_matrix(n),
                                  RR.hadamard_matrix(n))


def test_hadamard_matrix_refuses_non_powers_of_two():
    with pytest.raises(ValueError):
        PR.hadamard_matrix(96)


@pytest.mark.parametrize("n", [4, 64, 128, 96])
def test_random_hadamard_orthogonality(n):
    r = PR.random_hadamard(torch.Generator().manual_seed(0), n)
    assert r.dtype == torch.float32 and tuple(r.shape) == (n, n)
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(n), atol=1e-5)
    if n & (n - 1) == 0:
        # H · diag(s): every column is a signed column of H
        h = PR.hadamard_matrix(n).astype(np.float32)
        signs = np.sign(r.numpy()[0]) * np.sign(h[0])
        np.testing.assert_array_equal(r.numpy(), h * signs[None])


def test_random_orthogonal_sign_fix_and_seeding():
    a = PR.random_orthogonal(torch.Generator().manual_seed(5), 48)
    b = PR.random_orthogonal(torch.Generator().manual_seed(5), 48)
    c = PR.random_orthogonal(torch.Generator().manual_seed(6), 48)
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose((a.T @ a).numpy(), np.eye(48), atol=1e-5)
    # a = q · sign(diag(r)) for the QR of the generator's normal draw:
    # aᵀ · draw = sign(diag(r)) · r, upper triangular with a positive
    # diagonal
    draw = torch.randn((48, 48), generator=torch.Generator().manual_seed(5))
    t = a.T @ draw
    assert bool((torch.diagonal(t) > 0).all())
    np.testing.assert_allclose(torch.tril(t, -1).numpy(), 0, atol=1e-4)


def test_hadamard_spreads_outliers():
    """A one-hot (outlier) vector becomes uniform-magnitude after
    rotation."""
    n = 64
    r = PR.random_hadamard(torch.Generator().manual_seed(1), n)
    x = torch.zeros(n)
    x[7] = 8.0
    y = (x @ r).numpy()
    assert np.abs(y).max() < 0.25 * 8.0
    np.testing.assert_allclose(np.linalg.norm(y), 8.0, rtol=1e-5)


def test_rotation_reduces_activation_kurtosis_after_quant():
    """Rotation makes static-range quantization less lossy on
    outlier-heavy activations (the SpinQuant mechanism at tensor level)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.distributions.StudentT(2.5).sample((512, 128))
    r = PR.random_hadamard(gen, 128)

    def quant_err(v):
        beta = v.abs().max() * 0.5
        q = torch.clamp(v, -beta, beta)
        q = torch.round(q / beta * 127) / 127 * beta
        return float(((v - q) ** 2).mean() / (v ** 2).mean())

    assert quant_err(x @ r) < quant_err(x)


def test_fold_norm_scales_matches_reference(carried):
    cfg, params, pp = carried
    folded_p = PR.fold_norm_scales(pp, cfg)
    folded_r = RR.fold_norm_scales(params, cfg)
    _assert_trees_close(folded_r, folded_p, **TOL)
    # the inputs are untouched, and the folded model keeps its function
    _assert_trees_close(params, pp, rtol=0, atol=0)
    toks = _tokens(cfg, 2, 12, seed=0)
    off = PA.AnalogConfig(mode="off")
    np.testing.assert_allclose(_logits(folded_p, cfg, off, toks, True),
                               _logits(pp, cfg, off, toks, True), atol=2e-4)


def test_fold_rotation_into_linear_matches_reference():
    rng = np.random.default_rng(0)
    site = {"kernel": rng.standard_normal((16, 24)).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    r_in = np.array(RR.random_hadamard(jax.random.PRNGKey(0), 16))
    r_out = np.array(RR.random_hadamard(jax.random.PRNGKey(1), 24))
    p = {k: torch.as_tensor(v) for k, v in site.items()}
    for side, r in (("in", r_in), ("out", r_out)):
        site_o = {**site, "bias": site["bias"] if side == "in"
                  else rng.standard_normal(24).astype(np.float32)}
        p_o = {k: torch.as_tensor(v) for k, v in site_o.items()}
        ref = RR.fold_rotation_into_linear(
            {k: jnp.asarray(v) for k, v in site_o.items()}, jnp.asarray(r),
            side)
        got = PR.fold_rotation_into_linear(p_o, torch.as_tensor(r), side)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       **TOL)
    with pytest.raises(ValueError):
        PR.fold_rotation_into_linear(p, torch.as_tensor(r_in), "both")


def test_rotate_residual_stream_matches_reference(carried):
    """The reference's R injected: every leaf equal, writers and readers
    (the MoE router and batched expert kernels included)."""
    cfg, params, pp = carried
    rotated_r, r = RREC._rotate_residual_stream(params, cfg,
                                                jax.random.PRNGKey(7))
    rotated_p, r_p = PREC._rotate_residual_stream(
        pp, cfg, None, r=torch.as_tensor(np.array(r)))
    _assert_trees_close(rotated_r, rotated_p, **TOL)
    np.testing.assert_array_equal(r_p.numpy(), np.asarray(r))
    # the port draws its own rotation from a generator, orthogonal too
    _, r_own = PREC._rotate_residual_stream(pp, cfg,
                                            torch.Generator().manual_seed(0))
    np.testing.assert_allclose((r_own @ r_own.T).numpy(),
                               np.eye(cfg.d_model), atol=1e-5)


@pytest.mark.parametrize("arch", RMS_ARCHS)
def test_rotation_invariance_fp(arch):
    """Folded norms + a rotation leave the FP model's function unchanged
    on the rmsnorm archs (SpinQuant's core property); dbrx's layernorm
    does not commute with a rotation, as the reference documents."""
    cfg = get_config(arch).reduce()
    key = jax.random.PRNGKey(3)
    cfg, params, _ = ref_build(cfg, key)
    pp = PR.fold_norm_scales(params_from_numpy(
        _ref_flat(_randomize_scales(params, key)), "cpu"), cfg)
    rotated, _ = PREC._rotate_residual_stream(
        pp, cfg, torch.Generator().manual_seed(3))
    toks = _tokens(cfg, 2, 10, seed=1)
    off = PA.AnalogConfig(mode="off")
    a = torch.log_softmax(torch.as_tensor(_logits(pp, cfg, off, toks, True)),
                          -1)
    b = torch.log_softmax(torch.as_tensor(
        _logits(rotated, cfg, off, toks, True)), -1)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-3)


def _assert_ranges_close(ref_tree, port_tree):
    a, b = _ref_flat(ref_tree), _port_flat(port_tree)
    assert list(a) == list(b)
    for path in a:
        if path.endswith("input_range"):
            assert b[path].shape == a[path].shape, path
            assert np.all(np.abs(b[path] - a[path])
                          <= 1e-5 * (1 + np.abs(a[path]))), path
        else:
            np.testing.assert_allclose(b[path], a[path], err_msg=path,
                                       **TOL)


def test_calibrate_input_ranges_matches_reference(carried):
    cfg, params, pp = carried
    toks = _tokens(cfg, 3, 16, seed=2)
    for scale in (1.0, 0.5):
        cal_r = RREC.calibrate_input_ranges(params, cfg, jnp.asarray(toks),
                                            scale=scale)
        cal_p = PREC.calibrate_input_ranges(
            pp, cfg, torch.as_tensor(toks).long(), scale=scale)
        _assert_ranges_close(cal_r, cal_p)
    # every analog site got a calibrated range; the [L] stacks per layer
    flat = _port_flat(cal_p)
    ranges = {k: v for k, v in flat.items() if k.endswith("input_range")}
    assert ranges and all(np.all(v > 1e-6) for v in ranges.values())
    assert not np.all(ranges["blocks/attn/qkv/input_range"]
                      == ranges["blocks/attn/qkv/input_range"][0])


@pytest.fixture(scope="module")
def ptq(carried):
    """Both packages' ``spinquant_ptq`` with the reference's R injected."""
    cfg, params, pp = carried
    calib = _tokens(cfg, 4, 16, seed=3)
    key = jax.random.PRNGKey(11)
    r = RR.random_hadamard(key, cfg.d_model)
    ref = RREC.spinquant_ptq(params, cfg, jnp.asarray(calib), key)
    port = PREC.spinquant_ptq(pp, cfg, torch.as_tensor(calib).long(), None,
                              r=torch.as_tensor(np.array(r)))
    return cfg, ref, port


def test_spinquant_ptq_matches_reference(ptq):
    _, ref, port = ptq
    _assert_ranges_close(ref, port)


def test_spinquant_ptq_without_rotation_is_calibration(carried):
    cfg, params, pp = carried
    calib = torch.as_tensor(_tokens(cfg, 2, 8, seed=4)).long()
    got = PREC.spinquant_ptq(pp, cfg, calib, None, rotate=False)
    want = PREC.calibrate_input_ranges(pp, cfg, calib)
    for path, v in _port_flat(want).items():
        np.testing.assert_array_equal(_port_flat(got)[path], v)


U32 = 2.0 ** -24


def _recording_units(monkeypatch, log_r: list, log_p: list, units: list):
    """``_recording_sites`` (every 2-D analog site's (input, output) of
    both packages, in call order), with each MoE FFN recorded the same way
    as one unit (its experts' sites inside it are not), and the port's
    ``(kind, params)`` of each unit appended to ``units`` in step."""
    _recording_sites(monkeypatch, log_r, log_p)
    real_rm, real_pm = ref_moe.moe, port_moe.moe
    site_p = port_layers.analog_linear          # the recording spy

    def keep(x, y):
        log_r.append((np.asarray(x), np.asarray(y)))

    def spy_rm(p, x, cfg, acfg, ctx):
        y, st = real_rm(p, x, cfg, acfg, ctx)
        jax.debug.callback(keep, x, y, ordered=True)
        return y, st

    def spy_pm(p, x, cfg, acfg, ctx):
        y, st = real_pm(p, x, cfg, acfg, ctx)
        log_p.append((x.numpy().copy(), y.numpy().copy()))
        units.append(("moe", p))
        return y, st

    def spy_p(p, x, acfg, ctx):
        units.append(("site", p))
        return site_p(p, x, acfg, ctx)

    monkeypatch.setattr(ref_moe, "moe", spy_rm)
    monkeypatch.setattr(port_moe, "moe", spy_pm)
    for module in (port_layers, T):
        monkeypatch.setattr(module, "analog_linear", spy_p)


def _apart(a, b, rows_pos) -> np.ndarray:
    """[B, S]: where ``a`` and ``b`` [B, S, ...] differ beyond ``SITE_TOL
    * (1 + |b|)``."""
    far = np.abs(a - b) > SITE_TOL * (1 + np.abs(b))
    return far.reshape(rows_pos + (-1,)).any(-1)


def _code_tie(v_r, v_p) -> bool:
    """Rounded codes of the scaled inputs ``v_r`` / ``v_p`` (the two
    packages') one level apart somewhere, each such element within the
    inputs' own difference (and the scale's rounding) of a rounding
    tie."""
    c_r, c_p = np.round(v_r), np.round(v_p)
    moved = c_r != c_p
    if not moved.any():
        return False
    near = np.abs(np.abs(v_p - np.floor(v_p)) - 0.5) <= (
        np.abs(v_r - v_p) + 4 * U32 * np.abs(v_p))
    assert (np.abs(c_r - c_p)[moved] == 1).all() and near[moved].all(), (
        "an input code moved away from a rounding tie")
    return True


def _input_codes(x, beta, acfg):
    """The DAC codes' pre-round values ``x Q / beta`` (static range, or the
    per-token absmax under di8), float64."""
    q = kref.qmax(acfg.input_bits)
    x = np.asarray(x, np.float64)
    if acfg.mode == "di8":
        beta = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8)
    return np.clip(x, -beta, beta) * q / beta


def _adc_tie(p, x_q, acfg) -> bool:
    """Some output of the site ``p`` on the quantized input ``x_q`` [..., K]
    lies within the fp32 dot error of an ADC rounding tie (rtn only: the
    other modes run no ADC here)."""
    if not (acfg.output_quant and acfg.mode == "rtn"):
        return False
    w = PQ.rtn_dequantize(*PQ.rtn_quantize(p["kernel"].float(),
                                           acfg.weight_bits, axis=-2))
    beta = p["input_range"].reshape(()).float()
    bound = torch.clamp_min(kref.adc_bound(w, beta, acfg.out_bound), 1e-8)
    inv = kref.rdiv(kref.qmax(acfg.output_bits), bound) * kref.ADC_TIE_BREAK
    x_q = torch.as_tensor(x_q, dtype=torch.float32)
    v = (x_q @ w) * inv
    err = w.shape[-2] * U32 * (x_q.abs() @ w.abs()) * inv
    return bool(((v - torch.floor(v) - 0.5).abs() <= err).any())


def _ref_units(ref: dict, cfg, n: int) -> list:
    """The reference's params of each recorded unit, in call order: per
    layer qkv, o and the FFN (gate_up, down, or the MoE as one unit), then
    the LM head."""
    blocks = ref["blocks"]
    names = [("attn", "qkv"), ("attn", "o")] + (
        [("ffn",)] if cfg.family == "moe"
        else [("ffn", "gate_up"), ("ffn", "down")])
    out = []
    for layer in range(cfg.num_layers):
        for path in names:
            node = blocks
            for k in path:
                node = node[k]
            out.append(jax.tree.map(lambda t: np.asarray(t[layer]), node))
    out.append(jax.tree.map(np.asarray, ref["lm_head"]))
    assert len(out) == n
    return out


def _explain_site(p, p_ref, xr, xp, acfg) -> str:
    """Why a 2-D site's outputs part at one (row, position) where its
    inputs agree: an input code at a tie, or an ADC level at one."""
    beta = float(p["input_range"].reshape(()))
    beta_r = float(np.asarray(p_ref["input_range"]).reshape(()))
    if _code_tie(_input_codes(xr, beta_r, acfg),
                 _input_codes(xp, beta, acfg)):
        return "input code"
    q = kref.qmax(acfg.input_bits)
    v = _input_codes(xp, beta, acfg)
    scale = (np.maximum(np.abs(np.asarray(xp, np.float64)).max(), 1e-8)
             if acfg.mode == "di8" else beta) / q
    assert _adc_tie(p, np.round(v) * scale, acfg), (
        "a site output moved with equal input codes and no ADC near-tie")
    return "adc level"


def _explain_moe(p, p_ref, cfg, xr, xp, acfg, b, s) -> str:
    """Why a MoE FFN's outputs part at token (b, s) where its inputs
    agree: its routing at a router near-tie, a code of the token's input
    (the experts' gate_up input) at a tie, or, inside its experts, a code
    of the down input or an ADC level at a tie."""
    def f64(t):
        return torch.as_tensor(np.asarray(t), dtype=torch.float64)

    probs = [torch.softmax(f64(x) @ f64(r), -1)
             for x, r in ((xr, p_ref["router"]["kernel"]),
                          (xp, p["router"]["kernel"]))]
    ids = [torch.topk(pr, cfg.top_k).indices.sort().values for pr in probs]
    if not torch.equal(*ids):
        top = probs[1].sort(descending=True).values
        gap = float(top[cfg.top_k - 1] - top[cfg.top_k])
        assert gap <= float((probs[0] - probs[1]).abs().max()) + 1e-6, (
            "a route moved away from a router near-tie")
        return "route"
    site = p["gate_up"]
    beta = float(site["input_range"].reshape(()))
    beta_r = float(np.asarray(p_ref["gate_up"]["input_range"]).reshape(()))
    if _code_tie(_input_codes(xr, beta_r, acfg),
                 _input_codes(xp, beta, acfg)):
        return "input code"
    q = kref.qmax(acfg.input_bits)
    for e in ids[1].tolist():
        gu = {k: v[e] for k, v in site.items() if k != "int4"}
        dn = {k: v[e] for k, v in p["down"].items() if k != "int4"}
        x_q = torch.as_tensor(xp, dtype=torch.float32)[None]
        if acfg.mode == "di8":
            x_q = PQ.dynamic_input_quantize(x_q, acfg.input_bits)
        else:
            x_q = PQ.input_quantize(x_q, site["input_range"].reshape(()),
                                    acfg.input_bits)
        if _adc_tie(gu, x_q, acfg):
            return "adc level"
        # the down input's codes: h within its fp32 dot error of a tie
        w = gu["kernel"].float()
        if acfg.mode in ("qat", "di8"):
            w = PQ.weight_fake_quant(w, acfg.weight_bits, axis=-2)
        pre = x_q @ w
        err = w.shape[-2] * U32 * (x_q.abs() @ w.abs())
        g, u = torch.chunk(pre, 2, -1)
        eg, eu = torch.chunk(err, 2, -1)
        h = torch.nn.functional.silu(g) * u
        dh = 1.1 * eg * u.abs() + torch.nn.functional.silu(g).abs() * eu
        if acfg.mode == "di8":
            beta_h = torch.clamp_min(h.abs().max(), 1e-8)
        else:
            beta_h = dn["input_range"].reshape(())
        v = torch.clamp(h, -beta_h, beta_h) * q / beta_h
        if bool(((v - torch.floor(v) - 0.5).abs()
                 <= dh * q / beta_h + 4 * U32 * v.abs()).any()):
            return "down input code"
        if _adc_tie(dn, torch.round(v) * beta_h / q, acfg):
            return "adc level"
    raise AssertionError(f"MoE output at ({b}, {s}) moved with no route, "
                         "code or ADC level at a tie")


def _assert_first_differences_explained(cfg, acfg, ref, sites_r, sites_p,
                                        units, want, got) -> np.ndarray:
    """Causal reach over the recorded units (``tests/test_torch_eval.py``'s
    ``_assert_logits_agree``): every unit input and the logits agree
    wherever no earlier unit output apart reaches; each unit output that
    parts where it was not yet reached is explained by a code at a tie.
    Returns the reach [B, S]."""
    assert len(sites_r) == len(sites_p) == len(units) > 0
    ref_units = _ref_units(ref, cfg, len(units))
    reach = np.zeros(want.shape[:2], bool)
    for i, ((xr, yr), (xp, yp), (kind, p), p_ref) in enumerate(
            zip(sites_r, sites_p, units, ref_units)):
        assert not (_apart(xp, xr, reach.shape) & ~reach).any(), i
        first = _apart(yp, yr, reach.shape) & ~reach
        for b, s in zip(*np.nonzero(first)):
            if kind == "moe":
                _explain_moe(p, p_ref, cfg, xr[b, s], xp[b, s], acfg, b, s)
            else:
                _explain_site(p, p_ref, xr[b, s], xp[b, s], acfg)
        reach |= np.maximum.accumulate(first, axis=1)
    assert not (_apart(got, want, reach.shape) & ~reach).any()
    return reach


@pytest.mark.parametrize("mode", ["qat", "di8", "rtn"])
def test_ptq_model_logits_match_reference(ptq, mode, monkeypatch):
    """The PTQ baselines the paper's Table 1 reports (SI8-W4 = ``qat``,
    DI8-W4 = ``di8``) and the RTN deployment, on the calibrated model."""
    cfg, ref, port = ptq
    toks = _tokens(cfg, 2, 12, seed=5)
    kw = dict(mode=mode, weight_bits=4)
    if mode == "qat":
        kw["output_quant"] = False
    for use_pallas in (False, True):
        sr, sp, units = [], [], []
        with monkeypatch.context() as mp:
            _recording_units(mp, sr, sp, units)
            want = _logits(ref, cfg, RA.AnalogConfig(**kw), toks, False)
            acfg = PA.AnalogConfig(use_pallas=use_pallas, **kw)
            got = _logits(port, cfg, acfg, toks, True)
        reach = _assert_first_differences_explained(cfg, acfg, ref, sr, sp,
                                                    units, want, got)
        assert (~reach).mean() >= MIN_HELD, (mode, use_pallas, reach)


def test_first_difference_explanations_on_constructed_ties():
    """The explanations of the PTQ parity check: inputs that agree to 1e-6
    around a DAC rounding tie explain a site output apart by an input
    code one level apart; equal inputs with no pre-ADC value at a tie
    explain nothing, and the check fails."""
    g = torch.Generator().manual_seed(0)
    p = PA.init_linear(g, 16, 8, use_bias=False)
    acfg = PA.AnalogConfig(mode="rtn", weight_bits=4)
    beta = float(p["input_range"].reshape(()))
    q = kref.qmax(acfg.input_bits)
    x = (np.arange(16) - 8.0 + 0.5) * beta / q          # every code at a tie
    assert _explain_site(p, p, x * (1 - 1e-6), x * (1 + 1e-6),
                         acfg) == "input code"
    assert not _code_tie(np.array([10.2]), np.array([10.2 + 1e-5]))
    xs = np.linspace(-1.0, 1.0, 16) * beta
    codes = np.round(_input_codes(xs, beta, acfg))
    x_q = torch.as_tensor(codes * beta / q, dtype=torch.float32)
    assert not _adc_tie(p, x_q, acfg)
    with pytest.raises(AssertionError, match="no ADC near-tie"):
        _explain_site(p, p, xs, xs, acfg)
