"""The port's plain kernel versions against the JAX oracles, on the CPU.

``repro_torch.kernels.ref`` holds the plain PyTorch version of each
hand-written CUDA kernel; on a CPU tensor the kernel wrappers (and the
dispatch layer above them) run exactly these. Here the same seeded numpy
inputs go through the reference's oracles (``repro.kernels.ref``), its
Pallas kernels in interpret mode at one small shape each, and the port.

Tolerances: ADC-quantized outputs use ``assert_adc_parity`` (exact within
1e-5, except boundary ties from fp32 reassociation between the two
frameworks' matmuls, which flip exactly one ADC level at rate < 1e-4); every
other output is held to ``rtol = atol = 1e-5``; the quantizers on the RTN
lattice are held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.core import quant as ref_quant
from repro.kernels import ref as jref
from repro.kernels.analog_matmul import analog_matmul as pallas_analog
from repro.kernels.int4_matmul import int4_matmul as pallas_int4
from repro_torch.core import quant as port_quant
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

# decode (M <= 8) and ragged prefill shapes (M, K, N); none is a tile multiple
SHAPES = [(1, 64, 96), (4, 128, 130), (8, 96, 64), (37, 300, 257),
          (130, 515, 96)]
BITS = [(8, 8), (4, 8), (8, 4), (4, 4)]


def _inputs(m, k, n, seed):
    """x [M, K], w [K, N], beta (), bound [N], col_off [N] as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    beta = np.float32(2.5)
    bound = np.asarray(jref.adc_bound(jnp.asarray(w), jnp.asarray(beta), 12.0))
    col_off = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, beta, bound, col_off


def _t(a):
    return torch.from_numpy(np.array(a))


def _lsb(bound, out_bits):
    return np.maximum(bound, 1e-8) / (2 ** (out_bits - 1) - 1)


@pytest.mark.parametrize("with_off", [False, True], ids=["plain", "col_off"])
@pytest.mark.parametrize("bits", BITS, ids=lambda b: f"i{b[0]}o{b[1]}")
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_analog_matmul_ref_matches_oracle(m, k, n, bits, with_off):
    in_bits, out_bits = bits
    x, w, beta, bound, col_off = _inputs(m, k, n, seed=m * 7 + k + n)
    off = col_off if with_off else None
    y_ref = jref.analog_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta), jnp.asarray(bound),
        None if off is None else jnp.asarray(off),
        in_bits=in_bits, out_bits=out_bits)
    y_port = tref.analog_matmul_ref(
        _t(x), _t(w), _t(beta), _t(bound), None if off is None else _t(off),
        in_bits=in_bits, out_bits=out_bits)
    assert y_port.dtype == torch.float32 and y_port.shape == (m, n)
    assert_adc_parity(y_port.numpy(), np.asarray(y_ref), _lsb(bound, out_bits))
    # the dispatch layer over [B, S, K] activations runs the same function
    y_disp = dispatch.analog_mvm(_t(x).reshape(1, m, k), _t(w), _t(beta),
                                 _t(bound), in_bits=in_bits,
                                 out_bits=out_bits,
                                 col_off=None if off is None else _t(off))
    np.testing.assert_array_equal(y_disp.reshape(m, n).numpy(),
                                  y_port.numpy())


def test_analog_matmul_matches_pallas_interpret():
    m, k, n = 5, 200, 136
    x, w, beta, bound, col_off = _inputs(m, k, n, seed=11)
    for off in (None, col_off):
        y_pallas = pallas_analog(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta),
            jnp.asarray(bound), None if off is None else jnp.asarray(off),
            bm=8, bn=128, bk=128, interpret=True)
        y_port = tref.analog_matmul_ref(_t(x), _t(w), _t(beta), _t(bound),
                                        None if off is None else _t(off))
        assert_adc_parity(y_port.numpy(), np.asarray(y_pallas),
                          _lsb(bound, 8))


def _rtn(k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w_int, scale = ref_quant.rtn_quantize(jnp.asarray(w), 4)
    return rng, w, np.asarray(w_int), np.asarray(scale)


@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (8, 130, 64), (37, 300, 258)])
def test_int4_matmul_ref_and_pack_match_oracle(m, k, n):
    rng, w, w_int, scale = _rtn(k, n, seed=m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed_ref = np.asarray(jref.pack_int4(jnp.asarray(w_int)))
    packed_port = tref.pack_int4(_t(w_int))
    assert packed_port.dtype == torch.uint8
    np.testing.assert_array_equal(packed_port.numpy(), packed_ref)
    np.testing.assert_array_equal(tref.unpack_int4(packed_port).numpy(),
                                  w_int.astype(np.int32))
    y_ref = jref.int4_matmul_ref(jnp.asarray(x), jnp.asarray(packed_ref),
                                 jnp.asarray(scale[0]))
    y_port = tref.int4_matmul_ref(_t(x), packed_port, _t(scale[0]))
    np.testing.assert_allclose(y_port.numpy(), np.asarray(y_ref), **TOL)
    # dispatch: packed and pack-on-the-fly routes
    y_disp = dispatch.int4_mvm_packed(_t(x)[None], packed_port, _t(scale))
    np.testing.assert_allclose(y_disp[0].numpy(), np.asarray(y_ref), **TOL)
    y_fly = dispatch.int4_mvm(_t(x), _t(w_int), _t(scale))
    np.testing.assert_allclose(y_fly.numpy(), np.asarray(y_ref), **TOL)


def test_int4_matmul_matches_pallas_interpret():
    rng, w, w_int, scale = _rtn(200, 136, seed=3)
    x = rng.standard_normal((5, 200)).astype(np.float32)
    packed = np.asarray(jref.pack_int4(jnp.asarray(w_int)))
    y_pallas = pallas_int4(jnp.asarray(x), jnp.asarray(packed),
                           jnp.asarray(scale[0]), bm=8, bn=128, bk=128,
                           interpret=True)
    y_port = tref.int4_matmul_ref(_t(x), _t(packed), _t(scale[0]))
    np.testing.assert_allclose(y_port.numpy(), np.asarray(y_pallas), **TOL)


def test_adc_bound_and_helpers_match_oracle():
    _, w, beta, bound, _ = _inputs(4, 300, 257, seed=5)
    np.testing.assert_allclose(
        tref.adc_bound(_t(w), _t(beta), 14.0).numpy(),
        np.asarray(jref.adc_bound(jnp.asarray(w), jnp.asarray(beta), 14.0)),
        **TOL)
    assert tref.ADC_TIE_BREAK == jref.ADC_TIE_BREAK
    for v, mult in [(0, 8), (1, 8), (8, 8), (300, 128), (515, 512)]:
        assert tref.round_up(v, mult) == jref.round_up(v, mult)


def test_flatten_batch():
    x2, lead = dispatch.flatten_batch(torch.zeros(2, 3, 5))
    assert x2.shape == (6, 5) and lead == (2, 3)
    x2, lead = dispatch.flatten_batch(torch.zeros(4, 5))
    assert x2.shape == (4, 5) and lead == (4,)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantizers_bitwise_on_the_rtn_lattice(bits):
    """Regression for the reciprocal-division trap: RTN-dequantized weights
    and lattice activations sit exactly on rounding boundaries, where a
    ``scalar / tensor`` written as ``tensor.reciprocal() * scalar`` would
    flip levels. The port's quantizers must agree bit for bit."""
    rng, w, w_int, scale = _rtn(256, 192, seed=bits)
    ti, ts = port_quant.rtn_quantize(_t(w), 4)
    np.testing.assert_array_equal(ti.numpy(), w_int)
    np.testing.assert_array_equal(ts.numpy(), scale)
    w_deq = np.asarray(ref_quant.rtn_dequantize(jnp.asarray(w_int),
                                                jnp.asarray(scale)))
    np.testing.assert_array_equal(port_quant.rtn_dequantize(ti, ts).numpy(),
                                  w_deq)
    # re-quantizing the lattice weights: every value is a tie candidate
    ri, rs = ref_quant.rtn_quantize(jnp.asarray(w_deq), bits)
    pi, ps = port_quant.rtn_quantize(_t(w_deq), bits)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))

    # static beta, activations on and between the DAC lattice
    beta = np.float32(2.7)
    q = 2 ** (bits - 1) - 1
    x = ((beta / np.float32(q))
         * rng.integers(-q - 2, q + 3, (16, 256)).astype(np.float32))
    x = np.concatenate([x, x + np.float32(0.5) * beta / np.float32(q)])
    xq_ref = np.asarray(ref_quant.input_quantize(jnp.asarray(x),
                                                 jnp.asarray(beta), bits))
    xq_port = port_quant.input_quantize(_t(x), _t(beta), bits)
    np.testing.assert_array_equal(xq_port.numpy(), xq_ref)

    # the ADC on the same pre-ADC values, bound from the lattice weights
    y = (xq_ref @ w_deq).astype(np.float32)
    bound = np.asarray(jref.adc_bound(jnp.asarray(w_deq), jnp.asarray(beta),
                                      12.0))
    yq_ref = np.asarray(ref_quant.output_quantize(
        jnp.asarray(y), jnp.asarray(bound), jnp.float32(bits)))
    yq_port = port_quant.output_quantize(_t(y), _t(bound), bits)
    np.testing.assert_array_equal(yq_port.numpy(), yq_ref)
