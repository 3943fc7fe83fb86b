"""The MVM kernels' folded ADC bound and their 2xTF32 split, on the CPU.

* ``analog_matmul`` takes its ADC bound either explicitly or as ``lam``,
  folded from the weights it streams: ``(lam · β) · max_k |w[k, n]|``.
  The plain version's ``lam`` form, and the dispatch layer's, are held
  against the reference's ``adc_bound`` + ``analog_matmul_ref`` and its
  Pallas kernel in interpret mode; ``analog_linear``'s fused sites pass
  ``lam`` and still give the explicit-bound path's output bit for bit.
* The tensor-core (``mma``) mapping of both kernels multiplies one operand
  that is exact in TF32 by the other split into ``hi + lo`` TF32 parts,
  over 32-deep K spans promoted into fp32 by round-to-nearest adds. Here
  that arithmetic is emulated (``cvt.rna.tf32.f32`` by integer operations
  on the ``int32`` view; each span's exact TF32 products summed by an fp32
  matmul) and held to the contracts the card is held to: the ADC parity
  contract for ``analog_matmul`` at 8- and 12-bit DACs, the fp32 dot
  bound for ``int4_matmul``, at K up to 8192.

Tolerances: ADC-quantized outputs use ``assert_adc_parity`` (exact within
1e-5 except one-level flips at near-ties, at a rate below 1e-4); the folded
bound is compared bit for bit; int4 stays within ``K * 2^-24 * (|x| .
|w_deq|)`` per element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.core import quant as ref_quant
from repro.kernels import ref as jref
from repro.kernels.analog_matmul import analog_matmul as pallas_analog
from repro_torch.core import analog as port_analog
from repro_torch.kernels import _launch, dispatch
from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

U32 = 2.0 ** -24
SPAN = 32                       # K rows of one promoted span (mvm_mma.cuh)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    off = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, np.float32(2.5), off


def _lsb(bound, out_bits):
    return np.maximum(np.asarray(bound), 1e-8) / (2 ** (out_bits - 1) - 1)


# ---------------------------------------------------------------------------
# the folded ADC bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_off", [False, True], ids=["plain", "col_off"])
@pytest.mark.parametrize("bits", [(8, 8), (4, 6), (12, 8)],
                         ids=lambda b: f"i{b[0]}o{b[1]}")
@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (8, 300, 130),
                                   (37, 515, 257)])
def test_lam_form_matches_the_reference(m, k, n, bits, with_off):
    in_bits, out_bits = bits
    lam = 14.0
    x, w, beta, off = _inputs(m, k, n, seed=m + k + n + in_bits)
    off = off if with_off else None
    bound = jref.adc_bound(jnp.asarray(w), jnp.asarray(beta), lam)
    y_ref = jref.analog_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta), bound,
        None if off is None else jnp.asarray(off), in_bits=in_bits,
        out_bits=out_bits)
    kw = dict(in_bits=in_bits, out_bits=out_bits)
    t_off = None if off is None else _t(off)
    y_lam = tref.analog_matmul_ref(_t(x), _t(w), _t(beta), None, t_off,
                                   lam=lam, **kw)
    assert_adc_parity(y_lam.numpy(), np.asarray(y_ref),
                      _lsb(bound, out_bits))
    # the fold is the explicit bound of ref.adc_bound, bit for bit
    y_bound = tref.analog_matmul_ref(
        _t(x), _t(w), _t(beta), tref.adc_bound(_t(w), _t(beta), lam), t_off,
        **kw)
    assert torch.equal(y_lam, y_bound)
    # the wrapper and the dispatch layer run the same on CPU tensors
    y_wrap = k_analog.analog_matmul(_t(x), _t(w), _t(beta), None, t_off,
                                    lam=lam, **kw)
    y_disp = dispatch.analog_mvm(_t(x).reshape(1, m, k), _t(w), _t(beta),
                                 lam=lam, col_off=t_off, **kw)
    assert torch.equal(y_wrap, y_lam)
    assert torch.equal(y_disp.reshape(m, n), y_lam)


def test_lam_form_matches_pallas_interpret():
    m, k, n, lam = 5, 200, 136, 12.0
    x, w, beta, off = _inputs(m, k, n, seed=3)
    bound = jref.adc_bound(jnp.asarray(w), jnp.asarray(beta), lam)
    for o in (None, off):
        y_pallas = pallas_analog(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta), bound,
            None if o is None else jnp.asarray(o), bm=8, bn=128, bk=128,
            interpret=True)
        y_port = dispatch.analog_mvm(_t(x), _t(w), _t(beta), lam=lam,
                                     col_off=None if o is None else _t(o))
        assert_adc_parity(y_port.numpy(), np.asarray(y_pallas),
                          _lsb(bound, 8))


def _site(k, n, seed):
    rng = np.random.default_rng(seed)
    p = {"kernel": _t((rng.standard_normal((k, n)) * k ** -0.5
                       ).astype(np.float32)),
         "input_range": torch.full((1,), 2.5)}
    x = _t(rng.standard_normal((2, 3, k)).astype(np.float32))
    return p, x


@pytest.mark.parametrize("mode", ["analog", "rtn"])
def test_fused_sites_fold_the_bound(mode, monkeypatch):
    """``analog_linear`` on the fused path passes ``lam`` (no bound pass of
    its own) and gives the explicit-bound path's output bit for bit."""
    from repro_torch.core import quant
    p, x = _site(48, 40, seed=5)
    cfg = port_analog.AnalogConfig(mode=mode, use_pallas=True)
    assert dispatch.use_fused(cfg)
    calls = []
    real = dispatch.analog_mvm

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, "analog_mvm", spy)
    y, _ = port_analog.analog_linear(p, x, cfg, port_analog.AnalogCtx())
    assert len(calls) == 1 and calls[0]["lam"] == cfg.out_bound
    assert calls[0].get("bound") is None
    w = p["kernel"]
    if mode == "rtn":
        w = quant.rtn_dequantize(*quant.rtn_quantize(w, cfg.weight_bits))
    beta = p["input_range"].reshape(())
    y_bound = real(x, w, beta, tref.adc_bound(w, beta, cfg.out_bound),
                   in_bits=cfg.input_bits, out_bits=cfg.output_bits)
    assert torch.equal(y, y_bound)


def test_training_noise_keeps_the_explicit_bound():
    """``fused_analog_mvm`` on ``w + w_noise`` with an explicit bound (as
    training calibrates it on ``w``) is the plain version on ``w + w_noise``
    with that bound, not with one folded from the noisy weights."""
    x, w, beta, _ = _inputs(4, 64, 32, seed=9)
    noise = np.random.default_rng(1).standard_normal(w.shape).astype(
        np.float32) * 0.05
    bound = tref.adc_bound(_t(w), _t(beta), 12.0)
    y = dispatch.fused_analog_mvm(_t(x), _t(w), _t(noise), _t(beta), bound)
    want = tref.analog_matmul_ref(_t(x), _t(w + noise), _t(beta), bound)
    assert torch.equal(y, want)


@pytest.mark.parametrize("with_noise", [True, False],
                         ids=["noise", "eval"])
def test_fused_mvm_folds_lam_only_without_noise(with_noise):
    """``lam`` folds the bound from the weights the kernel is handed, so
    ``fused_analog_mvm`` refuses it beside a ``w_noise`` (the reference
    folds from the noise-free ``wf``, ``core/analog.py``); at eval
    (``w_noise=None``) it is the plain version's folded bound on ``w``."""
    x, w, beta, _ = _inputs(4, 64, 32, seed=10)
    noise = (np.random.default_rng(2).standard_normal(w.shape).astype(
        np.float32) * 0.05 if with_noise else None)

    def call():
        return dispatch.fused_analog_mvm(
            _t(x), _t(w), None if noise is None else _t(noise), _t(beta),
            lam=12.0)

    if with_noise:
        with pytest.raises(ValueError, match="noise-free"):
            call()
    else:
        assert torch.equal(call(), tref.analog_matmul_ref(
            _t(x), _t(w), _t(beta), lam=12.0))


@pytest.mark.parametrize("fn", ["wrapper", "ref", "analog_mvm",
                                "fused_analog_mvm"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "neither"])
def test_exactly_one_of_bound_and_lam(fn, both):
    x, w, beta, _ = _inputs(2, 16, 8, seed=0)
    x, w, beta = _t(x), _t(w), _t(beta)
    bound = tref.adc_bound(w, beta, 12.0) if both else None
    lam = 12.0 if both else None
    call = {"wrapper": lambda: k_analog.analog_matmul(x, w, beta, bound,
                                                      lam=lam),
            "ref": lambda: tref.analog_matmul_ref(x, w, beta, bound,
                                                  lam=lam),
            "analog_mvm": lambda: dispatch.analog_mvm(x, w, beta, bound,
                                                      lam=lam),
            "fused_analog_mvm": lambda: dispatch.fused_analog_mvm(
                x, w, None, beta, bound, lam=lam)}[fn]
    with pytest.raises(ValueError, match="exactly one of bound"):
        call()


def test_plan_scratch_is_the_plans_size():
    none = _launch.Plan("gemv", 1, 64, 0)
    assert _launch.scratch(none, torch.device("cpu")) is None
    some = _launch.Plan("mma", 3, 64, 1234)
    buf = _launch.scratch(some, torch.device("cpu"))
    assert buf.dtype == torch.float32 and buf.shape == (1234,)
    assert _launch.MAPPINGS == ("gemv", "mma", "tiled")


# ---------------------------------------------------------------------------
# emulation of the mma mapping's 2xTF32 arithmetic
# ---------------------------------------------------------------------------

def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, to nearest
    with ties away from zero (adding half a TF32 ulp to the magnitude bits
    carries into the exponent exactly as rounding up does)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def promoted_spans(a_parts, b_parts) -> torch.Tensor:
    """Sum over K of the products of the operand parts, one 32-deep span
    at a time (the span's products are exact in fp32; the span sum is an
    fp32 matmul), each span added into the fp32 total in K order."""
    k = a_parts[0].shape[1]
    tot = torch.zeros((a_parts[0].shape[0], b_parts[0].shape[1]))
    for k0 in range(0, k, SPAN):
        span = sum(a[:, k0:k0 + SPAN] @ b[k0:k0 + SPAN]
                   for a in a_parts for b in b_parts)
        tot = tot + span
    return tot


def test_tf32_rounding_emulation():
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0, 1e-30,
                      2.0 - 2.0 ** -23])
    got = tf32_rna(v)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                         float(tf32_rna(torch.tensor([1e-30]))[0]), 2.0])
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 7
    hi, lo = split_tf32(x)
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("in_bits", [8, 12, 13, 16])
def test_dac_lattice_is_exact_in_tf32_up_to_12_bits(in_bits):
    """The analog mma mapping's exact operand: every DAC level n with
    |n| <= 2^(in_bits-1) - 1 survives TF32 for in_bits <= 12; above, some
    do not, which is why those widths take the CUDA-core tiled mapping."""
    qi = 2 ** (in_bits - 1) - 1
    n = torch.arange(-qi, qi + 1, dtype=torch.float32)
    exact = torch.equal(tf32_rna(n), n)
    assert exact == (in_bits <= 12)


def _adc(y, bound, out_bits):
    """The ADC of the plain version (``kernels/ref.py``) on y [M, N]."""
    qo = tref.qmax(out_bits)
    b = torch.clamp_min(bound.float(), 1e-8)[None, :]
    inv = tref.rdiv(qo, b) * tref.ADC_TIE_BREAK
    return tref.clip(tref.div(b, qo) * torch.round(y * inv), -b, b)


@pytest.mark.parametrize("in_bits", [8, 12])
@pytest.mark.parametrize("m,k,n", [(9, 100, 66), (16, 2048, 128),
                                   (8, 8192, 96), (64, 515, 130)])
def test_split_tf32_analog_holds_the_adc_contract(m, k, n, in_bits):
    lam, out_bits = 14.0, 8
    x, w, beta, off = _inputs(m, k, n, seed=k + n + in_bits)
    xt, wt, bt = _t(x), _t(w), torch.tensor(beta)
    qi = tref.qmax(in_bits)
    b = torch.clamp_min(bt, 1e-8)
    lattice = torch.round(tref.clip(xt, -b, b) * tref.rdiv(qi, b))
    assert torch.equal(tf32_rna(lattice), lattice)
    w_hi, w_lo = split_tf32(wt)
    tot = promoted_spans([lattice], [w_hi, w_lo])
    bound = tref.adc_bound(wt, bt, lam)
    y = _adc(tot * tref.div(b, qi) + _t(off), bound, out_bits)
    y_ref = jref.analog_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta),
        jref.adc_bound(jnp.asarray(w), jnp.asarray(beta), lam),
        jnp.asarray(off), in_bits=in_bits, out_bits=out_bits)
    assert_adc_parity(y.numpy(), np.asarray(y_ref),
                      _lsb(bound.numpy(), out_bits))


@pytest.mark.parametrize("m,k,n", [(9, 100, 66), (16, 2048, 128),
                                   (8, 8192, 96), (64, 515, 130)])
def test_split_tf32_int4_holds_the_fp32_dot_bound(m, k, n):
    rng = np.random.default_rng(m * k + n)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w_int, scale = ref_quant.rtn_quantize(jnp.asarray(w), 4)
    w_int, scale = np.asarray(w_int), np.asarray(scale)[0]
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = np.asarray(jref.pack_int4(jnp.asarray(w_int)))
    y_ref = np.asarray(jref.int4_matmul_ref(jnp.asarray(x),
                                            jnp.asarray(packed),
                                            jnp.asarray(scale)))
    w_nib = tref.unpack_int4(_t(packed)).float()
    assert torch.equal(tf32_rna(w_nib), w_nib)          # exact operand
    x_hi, x_lo = split_tf32(_t(x))
    y = promoted_spans([x_hi, x_lo], [w_nib]) * _t(scale)
    w_deq = w_int.astype(np.float64) * scale
    mag = np.abs(x).astype(np.float64) @ np.abs(w_deq)
    assert (np.abs(y.numpy().astype(np.float64) - y_ref)
            <= k * U32 * mag).all()
    # and within the split's own, K-independent-per-span error: 2^-22 |x|
    # left by the split, the fp32 sums of a span's 2 x 32 products, one
    # round-to-nearest add per span and the scale (plain TF32 fails this)
    exact = x.astype(np.float64) @ w_deq
    span_bound = (4 + 2 * SPAN + k / SPAN + 1) * U32 * mag
    assert (np.abs(y.numpy().astype(np.float64) - exact) <= span_bound).all()
