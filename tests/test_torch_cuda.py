"""The hand-written CUDA kernels on the card; every test skips without one.

This file imports neither JAX nor the reference package, so that it runs on
a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It holds the libraries' launch plans (mapping switch, split-K) and the
MVM kernels against their plain versions at small ragged shapes, where the
edges of M, N and K are masked, and both paged-attention kernels against
theirs at ragged tables and cursors, for fp32, bf16 and int8 pools and
1 to 8 decode splits. ``chip_smoke.py`` does the same at the main path's
full-width shapes.

Tolerance: ``analog_matmul`` may differ from its plain version only by one
ADC level where the plain version's pre-ADC value lies within the fp32 dot
error bound ``K * 2^-24 * (|x_q| . |w|) * inv`` of a rounding tie;
``int4_matmul`` stays within ``K * 2^-24 * (|x| . |w_deq|)`` per element;
the paged kernels stay within ``1e-5 + 1e-5 * |plain|`` of their plain
versions (both run the same fp32 online softmax over the same blocks; only
the order of the sums inside a block differs).
"""

import pytest
import torch

from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int4_matmul as k_int4
from repro_torch.kernels import paged_attention as k_decode
from repro_torch.kernels import paged_prefill as k_prefill

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


# (B, H, KV, hd, bs, NB): GQA at llama-3.2-1b's head shape, MHA at
# phi-3-mini-4k's, a tiny one, and hd 128 (over 48 KB of shared memory)
PAGED = [(3, 32, 8, 64, 16, 9), (4, 32, 32, 96, 8, 7), (2, 4, 2, 16, 4, 11),
         (2, 16, 2, 128, 16, 5)]
POOL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}


def _paged_case(dev, b, h, kv, hd, bs, nb, dtype, seed, chunk=1):
    """A pool with distinct random physical blocks per row (block 0 is the
    sink), ragged ``start`` and cursors with room for a chunk of ``chunk``
    columns: one row ends in its first block, one row's start lies past
    the first block, and one row fills its table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    npool = 1 + b * nb
    shape = (npool, bs, kv, hd)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=g, device=dev) * 0.02
        vs = torch.rand(shape[:3], generator=g, device=dev) * 0.02
    else:
        kp = torch.randn(shape, generator=g, device=dev).to(dtype)
        vp = torch.randn(shape, generator=g, device=dev).to(dtype)
        ks = vs = None
    perm = torch.randperm(npool - 1, generator=g, device=dev) + 1
    tbl = perm.reshape(b, nb).to(torch.int32).contiguous()
    cap = nb * bs - chunk                      # last legal chunk start
    pos = torch.randint(0, cap + 1, (b,), generator=g, device=dev)
    pos[0] = min(bs - 1 - (chunk - 1), cap) if bs > chunk else 0
    pos[-1] = cap
    start = (torch.rand((b,), generator=g, device=dev) * (pos + 1)).long()
    if b > 2:
        start[1] = min(bs + 1, int(pos[1]))
    return (kp, vp, ks, vs, tbl, pos.to(torch.int32).contiguous(),
            start.to(torch.int32).contiguous())


def _close(out, plain):
    err = (out - plain).abs()
    assert torch.isfinite(out).all()
    assert (err <= 1e-5 + 1e-5 * plain.abs()).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
@pytest.mark.parametrize("shape", PAGED, ids=str)
def test_paged_decode_matches_plain_version(card, shape, pool, splits):
    b, h, kv, hd, bs, nb = shape
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, b, h, kv, hd, bs, nb, POOL_DTYPES[pool], seed=hd + nb)
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn((b, h, hd), generator=g, device=card)
    before = k_decode.launches
    out = k_decode.paged_flash_decode(q, kp, vp, tbl, pos, start, scale=0.125,
                                      k_scale=ks, v_scale=vs,
                                      num_splits=splits)
    assert k_decode.launches == before + 1
    plain = ref.paged_decode_ref(q, kp, vp, tbl, pos, start, 0.125, ks, vs,
                                 num_splits=splits)
    _close(out, plain)
    one = ref.paged_decode_ref(q, kp, vp, tbl, pos, start, 0.125, ks, vs)
    _close(out, one)                       # the split does not change it


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5, 32])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
@pytest.mark.parametrize("shape", PAGED, ids=str)
def test_paged_prefill_matches_plain_version(card, shape, pool, chunk):
    b, h, kv, hd, bs, nb = shape
    if chunk > nb * bs:
        pytest.skip("chunk longer than the table")
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, b, h, kv, hd, bs, nb, POOL_DTYPES[pool], seed=hd * nb,
        chunk=chunk)
    g = torch.Generator(device=card).manual_seed(2)
    q = torch.randn((b, chunk, h, hd), generator=g, device=card)
    before = k_prefill.launches
    out = k_prefill.paged_flash_prefill(q, kp, vp, tbl, pos, start,
                                        scale=0.125, k_scale=ks, v_scale=vs)
    assert k_prefill.launches == before + 1
    _close(out, ref.paged_prefill_ref(q, kp, vp, tbl, pos, start, 0.125, ks,
                                      vs))


@pytest.mark.cuda
def test_paged_kernels_are_deterministic_and_read_only(card):
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, 4, 32, 8, 64, 16, 33, torch.bfloat16, seed=3, chunk=32)
    q = torch.randn((4, 32, 64), device=card)
    qs = torch.randn((4, 32, 32, 64), device=card)
    before = kp.clone(), vp.clone()
    a = k_decode.paged_flash_decode(q, kp, vp, tbl, pos, start, scale=0.125,
                                    num_splits=4)
    b = k_decode.paged_flash_decode(q, kp, vp, tbl, pos, start, scale=0.125,
                                    num_splits=4)
    c = k_prefill.paged_flash_prefill(qs, kp, vp, tbl, pos, start,
                                      scale=0.125)
    d = k_prefill.paged_flash_prefill(qs, kp, vp, tbl, pos, start,
                                      scale=0.125)
    assert torch.equal(a, b) and torch.equal(c, d)
    assert torch.equal(kp, before[0]) and torch.equal(vp, before[1])


@pytest.mark.cuda
def test_paged_wrappers_refuse_what_the_kernels_do_not_take(card):
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, 2, 4, 2, 16, 4, 3, torch.int8, seed=4)
    q = torch.randn((2, 4, 16), device=card)
    with pytest.raises(ValueError):            # int8 pool without scales
        k_decode.paged_flash_decode(q, kp, vp, tbl, pos, start, scale=1.0)
    with pytest.raises(TypeError):             # int64 table
        k_decode.paged_flash_decode(q, kp, vp, tbl.long(), pos, start,
                                    scale=1.0, k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError):             # fp16 pool
        k_prefill.paged_flash_prefill(q[:, None], kp.half(), vp.half(), tbl,
                                      pos, start, scale=1.0)
    with pytest.raises(ValueError):            # 3 heads on 2 kv heads
        k_decode.paged_flash_decode(q[:, :3].contiguous(), kp, vp, tbl, pos,
                                    start, scale=1.0, k_scale=ks,
                                    v_scale=vs)
