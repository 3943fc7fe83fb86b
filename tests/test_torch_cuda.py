"""The hand-written CUDA kernels on the card; every test skips without one.

This file imports neither JAX nor the reference package, so that it runs on
a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It holds the libraries' launch plans (mapping switch, split-K) and both
kernels against their plain versions at small ragged shapes, where the
edges of M, N and K are masked. ``chip_smoke.py`` does the same at the
main path's full-width shapes.

Tolerance: ``analog_matmul`` may differ from its plain version only by one
ADC level where the plain version's pre-ADC value lies within the fp32 dot
error bound ``K * 2^-24 * (|x_q| . |w|) * inv`` of a rounding tie;
``int4_matmul`` stays within ``K * 2^-24 * (|x| . |w_deq|)`` per element.
"""

import pytest
import torch

from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int4_matmul as k_int4

U32 = 2.0 ** -24
RAGGED = [(1, 64, 96), (4, 128, 130), (8, 96, 64), (5, 4100, 258),
          (37, 300, 257), (130, 515, 96)]


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc to build and run the "
                    "CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_select_blocks_decode_mapping(card):
    for kernel in ("analog_matmul", "int4_matmul"):
        for m in range(1, 9):
            plan = dispatch.select_blocks(m, 2048, 2048, kernel=kernel)
            assert plan.mapping == "gemv"
        assert dispatch.select_blocks(9, 2048, 2048,
                                      kernel=kernel).mapping == "tiled"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["analog_matmul", "int4_matmul"])
@pytest.mark.parametrize("m,k,n", [
    (4, 2048, 3072), (4, 2048, 2048), (4, 8192, 2048), (4, 2048, 128256),
    (128, 2048, 16384), (128, 8192, 2048), (1, 100, 64), (37, 515, 258)])
def test_split_k_covers_k_with_nonempty_splits(card, kernel, m, k, n):
    """The libraries' split-K: the splits tile K exactly (the C entry
    points refuse anything else), rows are whole 16-deep K steps, and the
    small decode projections get more than one split to fill the card."""
    plan = dispatch.select_blocks(m, k, n, kernel=kernel)
    assert plan.splits >= 1 and plan.k_per_split % 16 == 0
    assert plan.splits * plan.k_per_split >= k
    assert (plan.splits - 1) * plan.k_per_split < k
    if m <= 8 and n <= 3072 and k >= 2048:
        assert plan.splits > 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [(8, 8), (4, 4)], ids=["i8o8", "i4o4"])
@pytest.mark.parametrize("with_off", [False, True], ids=["plain", "col_off"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_analog_matmul_matches_plain_version(card, m, k, n, with_off, bits):
    in_bits, out_bits = bits
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=card)
    w = torch.randn((k, n), generator=g, device=card) * k ** -0.5
    beta = torch.full((1,), 2.5, device=card)
    bound = ref.adc_bound(w, beta, 12.0)
    off = (0.1 * bound * torch.randn((n,), generator=g, device=card)
           if with_off else None)
    before = k_analog.launches
    y = k_analog.analog_matmul(x, w, beta, bound, off, in_bits=in_bits,
                               out_bits=out_bits)
    assert k_analog.launches == before + 1
    y_ref = ref.analog_matmul_ref(x, w, beta, bound, off, in_bits=in_bits,
                                  out_bits=out_bits)
    qi, qo = ref.qmax(in_bits), ref.qmax(out_bits)
    x_q = ref.div(beta, qi) * torch.round(
        ref.clip(x, -beta, beta) * ref.rdiv(qi, beta))
    b = torch.clamp_min(bound, 1e-8)
    inv = ref.rdiv(qo, b) * ref.ADC_TIE_BREAK
    v = (x_q @ w + (0 if off is None else off)) * inv
    err_bound = k * U32 * (x_q.abs() @ w.abs()) * inv
    diff = (y - y_ref).abs()
    flips = diff != 0
    lsb = ref.div(b, qo).expand_as(y)
    assert torch.isfinite(y).all()
    assert ((diff[flips] - lsb[flips]).abs() <= 1e-3 * lsb[flips]).all()
    tie = (v - torch.floor(v) - 0.5).abs()
    assert (tie[flips] <= err_bound[flips]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n + n % 2) for m, k, n in RAGGED])
def test_int4_matmul_matches_plain_version(card, m, k, n):
    g = torch.Generator(device=card).manual_seed(m * k + n)
    w_int = torch.randint(-7, 8, (k, n), generator=g, device=card,
                          dtype=torch.int8)
    packed = ref.pack_int4(w_int)
    scale = (torch.rand((n,), generator=g, device=card) + 0.5) * 0.01
    x = torch.randn((m, k), generator=g, device=card)
    before = k_int4.launches
    y = k_int4.int4_matmul(x, packed, scale)
    assert k_int4.launches == before + 1
    y_ref = ref.int4_matmul_ref(x, packed, scale)
    w_deq = w_int.float() * scale
    assert ((y - y_ref).abs() <= k * U32 * (x.abs() @ w_deq.abs())).all()
