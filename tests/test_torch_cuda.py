"""The hand-written CUDA kernels on the card; every test skips without one.

This file imports neither JAX nor the reference package, so that it runs on
a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It holds the libraries' launch plans (mapping switch, split-K) and the
MVM kernels against their plain versions at small ragged shapes, where the
edges of M, N and K are masked, and both paged-attention kernels against
theirs at ragged tables and cursors, for fp32, bf16 and int8 pools and
1 to 8 decode splits, and ``ssd_scan`` against its plain version at ragged
sequence lengths, with groups shared by several heads, strided inputs and
an incoming state. ``chip_smoke.py`` does the same at the main path's
full-width shapes.

Tolerance: ``analog_matmul`` may differ from its plain version only by one
ADC level where the plain version's pre-ADC value lies within the fp32 dot
error bound ``K * 2^-24 * (|x_q| . |w|) * inv`` of a rounding tie;
``int4_matmul`` stays within ``K * 2^-24 * (|x| . |w_deq|)`` per element;
the paged kernels stay within ``1e-5 + 1e-5 * |plain|`` of their plain
versions (both run the same fp32 online softmax over the same blocks; only
the order of the sums inside a block differs); ``ssd_scan``'s y and final
state stay within ``2e-4 * (1 + |plain|)`` (the kernel and the plain version
differ only in the order of their sums and in their chunking; the JAX
package holds its own kernel to its jnp path at 2e-4).
"""

import pytest
import torch

from repro_torch.kernels import analog_matmul as k_analog
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int4_matmul as k_int4
from repro_torch.kernels import paged_attention as k_decode
from repro_torch.kernels import paged_prefill as k_prefill
from repro_torch.kernels import ssd_scan as k_ssd

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


# (B, S, H, P, G, N): ragged S around the kernel's 32-token chunk, groups
# shared by 1 to 24 heads, and mamba2-130m's head shape (P 64, N 128)
SSD = [(1, 1, 2, 16, 1, 16), (2, 33, 4, 32, 2, 16), (3, 70, 4, 64, 1, 128),
       (2, 100, 6, 48, 3, 64), (1, 257, 24, 64, 1, 128),
       (4, 32, 24, 64, 1, 128)]


def _ssd_inputs(dev, b, s, h, p, g, n, seed, wide=False):
    """x, dt, a, b, c, h0 on the card; with ``wide`` x, b and c are strided
    views of one [B, S, H*P + 2*G*N + 3] tensor, as the mixer hands them
    over."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = h * p + 2 * g * n
    if wide:
        xbc = torch.randn((b, s, d + 3), generator=gen, device=dev)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        bg = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        cg = xbc[..., h * p + g * n:d].reshape(b, s, g, n)
    else:
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        bg = torch.randn((b, s, g, n), generator=gen, device=dev) * 0.3
        cg = torch.randn((b, s, g, n), generator=gen, device=dev) * 0.3
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev) * 0.5) * 0.5
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.3)
    h0 = torch.randn((b * h, n, p), generator=gen, device=dev)
    return x, dt, a, bg, cg, h0


def _ssd_close(got, want):
    for out, plain in zip(got, want):
        assert out.shape == plain.shape and out.dtype == torch.float32
        assert torch.isfinite(out).all()
        err = (out - plain).abs()
        assert (err <= 2e-4 * (1 + plain.abs())).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", SSD, ids=str)
def test_ssd_scan_matches_plain_version(card, shape, with_h0):
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, *shape, seed=sum(shape))
    h0 = h0 if with_h0 else None
    before = k_ssd.launches
    got = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    assert k_ssd.launches == before + 1
    _ssd_close(got, ref.ssd_scan_ref(x, dt, a, bg, cg, h0))


@pytest.mark.cuda
def test_ssd_scan_strided_inputs_and_masked_positions(card):
    """The mixer's strided views give the contiguous inputs' result; a
    fully masked sequence (dt = 0, x = 0) returns h0 bit for bit; left pads
    give the unpadded run's state; two runs are equal."""
    shape = (2, 45, 4, 32, 2, 16)
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, *shape, seed=7, wide=True)
    assert not x.is_contiguous() and not bg.is_contiguous()
    got = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    want = k_ssd.ssd_scan(x.contiguous(), dt, a, bg.contiguous(),
                          cg.contiguous(), h0)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    _ssd_close(got, ref.ssd_scan_ref(x, dt, a, bg, cg, h0))
    again = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _, h_masked = k_ssd.ssd_scan(torch.zeros_like(x), torch.zeros_like(dt),
                                 a, bg, cg, h0)
    assert torch.equal(h_masked, h0)
    pad = 7
    pads = lambda t: torch.cat([torch.zeros_like(t[:, :pad]), t], dim=1)
    _, h_pad = k_ssd.ssd_scan(pads(x), pads(dt), a, pads(bg), pads(cg), h0)
    err = (h_pad - got[1]).abs()
    assert (err <= 2e-4 * (1 + got[1].abs())).all(), float(err.max())


@pytest.mark.cuda
def test_ssd_scan_plan_and_refusals(card):
    from repro_torch.kernels import _launch
    plan = _launch.ssd_plan(1, 8192, 24, 64, 128, 1)
    assert plan.chunk == 32 and plan.threads == 256
    assert 48 * 1024 < plan.smem <= 227 * 1024
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, 1, 9, 4, 16, 2, 16, seed=1)
    with pytest.raises(ValueError):            # P not a multiple of 16
        k_ssd.ssd_scan(x[..., :8], dt, a, bg, cg)
    with pytest.raises(ValueError):            # N above 128
        big = torch.zeros((1, 9, 2, 144), device=card)
        k_ssd.ssd_scan(x, dt, a, big, big)
    with pytest.raises(TypeError):             # fp64
        k_ssd.ssd_scan(x.double(), dt, a, bg, cg)
    with pytest.raises(ValueError):            # h0 of the wrong shape
        k_ssd.ssd_scan(x, dt, a, bg, cg, h0[:2])
    with pytest.raises(ValueError):            # x not contiguous in P
        k_ssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                       a, bg, cg)
