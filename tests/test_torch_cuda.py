"""The hand-written CUDA kernels on the card; every test skips without one.

This file imports neither JAX nor the reference package, so that it runs on
a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It holds the libraries' launch plans (mapping switch, split-K) and the
MVM kernels against their plain versions at small ragged shapes, where the
edges of M, N and K are masked: the decode GEMV at M = 1..8, the
tensor-core mapping at M from 9 to 130 on ragged and misaligned rows (N %
4 != 0, odd N / 2, K % 32 != 0, base pointers off 16-byte alignment), the
CUDA-core tiled mapping at a 16-bit DAC, the folded ADC bound bit for bit
against the explicit one, and every MVM launch bitwise the same run to run
for one and several K splits; and both paged-attention kernels against
theirs at ragged tables and cursors, for fp32, bf16 and int8 pools and
1 to 8 decode splits, at the edges of their split over warps (tables of
1 to 40 blocks, more splits than blocks, chunks that are not a multiple
of the query tile), and ``ssd_scan`` against its plain version at ragged
sequence lengths (one launch up to 32 tokens, three with scratch beyond,
and the three on a single chunk as well), with groups shared by several heads, strided inputs and an incoming
state, bitwise the same run to run and under CUDA-graph replay.
``chip_smoke.py`` does the same at the main path's full-width shapes.

Tolerance: ``analog_matmul`` may differ from its plain version only by one
ADC level where the plain version's pre-ADC value lies within the fp32 dot
error bound ``K * 2^-24 * (|x_q| . |w|) * inv`` of a rounding tie;
``int4_matmul`` stays within ``K * 2^-24 * (|x| . |w_deq|)`` per element;
the paged kernels stay within ``1e-5 + 1e-5 * |plain|`` of their plain
versions (both run the same fp32 online softmax over the same blocks; only
the order of the sums inside a block differs); ``ssd_scan``'s y and final
state stay within ``2e-4 * (1 + |plain|)`` (the kernel and the plain version
differ in the order of their sums, in their chunking and in the kernel's
split-TF32 products, which keep about fp32 accuracy; the JAX package holds
its own kernel to its jnp path at 2e-4).
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
    """M <= 8 takes the GEMV, larger M the tensor cores ("mma"); a DAC
    wider than 12 bits is not exact in TF32 and takes the CUDA-core tiled
    mapping (analog_matmul only)."""
    for kernel in ("analog_matmul", "int4_matmul"):
        for m in range(1, 9):
            plan = dispatch.select_blocks(m, 2048, 2048, kernel=kernel)
            assert plan.mapping == "gemv"
        assert dispatch.select_blocks(9, 2048, 2048,
                                      kernel=kernel).mapping == "mma"
    for bits, mapping in ((12, "mma"), (13, "tiled"), (16, "tiled")):
        assert dispatch.select_blocks(64, 2048, 2048,
                                      in_bits=bits).mapping == mapping
        assert dispatch.select_blocks(8, 2048, 2048,
                                      in_bits=bits).mapping == "gemv"


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


def _analog_inputs(dev, m, k, n, seed, with_off=False, misaligned=False):
    """x, w, beta, the explicit bound (lam 12) and col_off; ``misaligned``
    puts w 4 bytes past a 16-byte boundary (contiguous, so the kernel
    takes it, on its 4-byte copies)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    if misaligned:
        buf = torch.empty((k * n + 1,), device=dev)
        w = buf[1:].view(k, n).copy_(w)
    beta = torch.full((1,), 2.5, device=dev)
    bound = ref.adc_bound(w, beta, 12.0)
    off = (0.1 * bound * torch.randn((n,), generator=g, device=dev)
           if with_off else None)
    return x, w, beta, bound, off


def _check_analog(y, x, w, beta, bound, off, in_bits, out_bits):
    """y against the plain version: equal, or one ADC level apart where
    the plain version's pre-ADC value lies within the fp32 dot error bound
    of a rounding tie."""
    k = x.shape[1]
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
@pytest.mark.parametrize("bits", [(8, 8), (4, 4)], ids=["i8o8", "i4o4"])
@pytest.mark.parametrize("with_off", [False, True], ids=["plain", "col_off"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_analog_matmul_matches_plain_version(card, m, k, n, with_off, bits):
    in_bits, out_bits = bits
    x, w, beta, bound, off = _analog_inputs(card, m, k, n, m + k + n,
                                            with_off)
    before = k_analog.launches
    y = k_analog.analog_matmul(x, w, beta, bound, off, in_bits=in_bits,
                               out_bits=out_bits)
    assert k_analog.launches == before + 1
    _check_analog(y, x, w, beta, bound, off, in_bits, out_bits)


# the tensor-core mapping's edges: (K, N) aligned; K % 32 != 0 with N % 4
# != 0; odd K; N / 2 odd with K % 4 != 0
MMA_M = [9, 17, 63, 64, 65, 128, 130]
MMA_KN = [(256, 384), (300, 258), (515, 130), (97, 66)]


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("k,n", MMA_KN, ids=str)
@pytest.mark.parametrize("m", MMA_M)
def test_analog_mma_mapping_matches_plain_version(card, m, k, n,
                                                  misaligned):
    """The mma mapping with the bound folded (the main path's call) equals
    the explicit-bound launch bit for bit, and the plain version but for
    near-tie flips."""
    assert dispatch.select_blocks(m, k, n).mapping == "mma"
    x, w, beta, bound, off = _analog_inputs(card, m, k, n, m * k + n,
                                            with_off=True,
                                            misaligned=misaligned)
    y = k_analog.analog_matmul(x, w, beta, None, off, lam=12.0)
    assert torch.equal(y, k_analog.analog_matmul(x, w, beta, bound, off))
    _check_analog(y, x, w, beta, bound, off, 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(9, 300, 258), (37, 515, 257),
                                   (130, 2048, 384), (64, 4100, 96)])
def test_analog_tiled_mapping_at_16_bits(card, m, k, n):
    """A 16-bit DAC's lattice is not exact in TF32: the CUDA-core tiled
    mapping runs it, folded bound and all."""
    assert dispatch.select_blocks(m, k, n, in_bits=16).mapping == "tiled"
    x, w, beta, bound, off = _analog_inputs(card, m, k, n, m + n,
                                            with_off=True)
    y = k_analog.analog_matmul(x, w, beta, None, off, lam=12.0, in_bits=16)
    assert torch.equal(y, k_analog.analog_matmul(x, w, beta, bound, off,
                                                 in_bits=16))
    _check_analog(y, x, w, beta, bound, off, 16, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("k,n", [(2048, 2048), (300, 258)], ids=str)
def test_gemv_mappings_at_every_decode_row_count(card, m, k, n):
    """Both decode GEMVs at M = 1..8: int4 (conversion-free nibbles) within
    the fp32 dot bound, analog with the folded bound bit for bit equal to
    the explicit one."""
    x, w, beta, bound, off = _analog_inputs(card, m, k, n, m * 7 + n,
                                            with_off=True)
    y = k_analog.analog_matmul(x, w, beta, None, off, lam=12.0)
    assert torch.equal(y, k_analog.analog_matmul(x, w, beta, bound, off))
    _check_analog(y, x, w, beta, bound, off, 8, 8)
    g = torch.Generator(device=card).manual_seed(m + k)
    w_int = torch.randint(-8, 8, (k, n), generator=g, device=card,
                          dtype=torch.int8)
    packed = ref.pack_int4(w_int)
    scale = (torch.rand((n,), generator=g, device=card) + 0.5) * 0.01
    y4 = k_int4.int4_matmul(x, packed, scale)
    w_deq = w_int.float() * scale
    err = (y4 - ref.int4_matmul_ref(x, packed, scale)).abs()
    assert (err <= k * U32 * (x.abs() @ w_deq.abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["analog_matmul", "int4_matmul"])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 3072), (4, 256, 65536),
                                   (64, 2048, 2048), (128, 256, 16384),
                                   (130, 8192, 512)])
def test_mvm_launches_are_bitwise_deterministic(card, kernel, m, k, n):
    """The same call twice gives the same bits, with one K split and with
    several (the splits are added in a fixed order)."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((m, k), generator=g, device=card)
    if kernel == "analog_matmul":
        w = torch.randn((k, n), generator=g, device=card) * k ** -0.5
        beta = torch.full((1,), 2.5, device=card)
        runs = [k_analog.analog_matmul(x, w, beta, lam=12.0)
                for _ in range(2)]
    else:
        packed = ref.pack_int4(torch.randint(
            -8, 8, (k, n), generator=g, device=card, dtype=torch.int8))
        scale = torch.rand((n,), generator=g, device=card) + 0.5
        runs = [k_int4.int4_matmul(x, packed, scale) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_determinism_cases_cover_one_and_several_splits(card):
    splits = {dispatch.select_blocks(m, k, n, kernel=kernel).splits
              for kernel in ("analog_matmul", "int4_matmul")
              for m, k, n in [(4, 256, 65536), (128, 256, 16384),
                              (64, 2048, 2048), (130, 8192, 512)]}
    assert 1 in splits and max(splits) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, k, n + n % 2) for m, k, n in RAGGED]
                         + [(m, k, n) for m in MMA_M
                            for k, n in [(300, 258), (97, 66), (515, 200)]])
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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64, 130])
def test_int4_matmul_on_misaligned_rows(card, m):
    """x and the packed weights off their 16-byte boundaries (contiguous
    views one element in): the copies fall back to narrower ones."""
    k, n = 260, 384
    g = torch.Generator(device=card).manual_seed(m)
    w_int = torch.randint(-8, 8, (k, n), generator=g, device=card,
                          dtype=torch.int8)
    packed = ref.pack_int4(w_int)
    pbuf = torch.empty((k * n // 2 + 1,), dtype=torch.uint8, device=card)
    packed_off = pbuf[1:].view(k, n // 2).copy_(packed)
    x = torch.randn((m, k), generator=g, device=card)
    xbuf = torch.empty((m * k + 1,), device=card)
    x_off = xbuf[1:].view(m, k).copy_(x)
    scale = torch.rand((n,), generator=g, device=card) + 0.5
    y = k_int4.int4_matmul(x_off, packed_off, scale)
    assert torch.equal(y, k_int4.int4_matmul(x, packed, scale))


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


# (B, H, KV, hd, bs, NB) at the edges of the kernels' warp split: tables
# so short that most warps of a thread block take no pool block (NB 1 and
# 3) or long enough that every warp takes several (NB 40), and hd 96 and
# 128 under GQA
WARP_EDGES = [(3, 32, 8, 64, 16, 1), (3, 32, 8, 64, 16, 3),
              (3, 32, 8, 64, 16, 40), (2, 24, 8, 96, 16, 12),
              (2, 32, 8, 128, 16, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", ["1", "4", "over"])
@pytest.mark.parametrize("pool", ["bf16", "i8"])
@pytest.mark.parametrize("shape", WARP_EDGES, ids=str)
def test_paged_decode_at_the_warp_split_edges(card, shape, pool, splits):
    """"over": more splits than the table has blocks, so that whole
    thread blocks are dead and write m = -inf, l = 0 partials."""
    b, h, kv, hd, bs, nb = shape
    n = nb + 3 if splits == "over" else int(splits)
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, b, h, kv, hd, bs, nb, POOL_DTYPES[pool], seed=hd + 7 * nb)
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn((b, h, hd), generator=g, device=card)
    out = k_decode.paged_flash_decode(q, kp, vp, tbl, pos, start, scale=0.125,
                                      k_scale=ks, v_scale=vs, num_splits=n)
    _close(out, ref.paged_decode_ref(q, kp, vp, tbl, pos, start, 0.125, ks,
                                     vs, num_splits=n))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "i8"])
@pytest.mark.parametrize("shape,chunk", [
    (s, c) for s in WARP_EDGES for c in (7, 33) if c <= s[4] * s[5]],
    ids=str)
def test_paged_prefill_at_the_warp_split_edges(card, shape, chunk, pool):
    """Chunks that are not a multiple of the query tile (16 vectors at
    hd 64, 8 at hd 96 and 128) and fit the table."""
    b, h, kv, hd, bs, nb = shape
    kp, vp, ks, vs, tbl, pos, start = _paged_case(
        card, b, h, kv, hd, bs, nb, POOL_DTYPES[pool], seed=hd + 5 * nb,
        chunk=chunk)
    g = torch.Generator(device=card).manual_seed(6)
    q = torch.randn((b, chunk, h, hd), generator=g, device=card)
    out = k_prefill.paged_flash_prefill(q, kp, vp, tbl, pos, start,
                                        scale=0.125, k_scale=ks, v_scale=vs)
    _close(out, ref.paged_prefill_ref(q, kp, vp, tbl, pos, start, 0.125, ks,
                                      vs))


@pytest.mark.cuda
def test_paged_plans_fill_the_warps(card):
    """The libraries' plans at llama-3.2-1b's attention shape: decode holds
    the 4 heads of a kv head in one tile, prefill 16 query vectors; the
    lanes of a warp multiply to 32."""
    for dtype in POOL_DTYPES.values():
        dec = k_decode.decode_plan(32, 8, 64, 16, dtype)
        pre = k_prefill.prefill_plan(64, 16, dtype)
        assert dec.tile == 4 and pre.tile == 16
        for p in (dec, pre):
            assert p.tile * p.key_lanes * p.chunk_lanes == 32
            assert 1 <= p.warps <= 8 and p.stages >= 2
    with pytest.raises(ValueError):
        k_decode.decode_plan(3, 2, 64, 16, torch.float32)


@pytest.mark.cuda
def test_paged_kernels_are_deterministic_and_read_only(card):
    """Bitwise equal run to run (the warps and splits merge in a fixed
    order), for one and four decode splits and the bf16 and int8 pools."""
    for dtype in (torch.bfloat16, torch.int8):
        kp, vp, ks, vs, tbl, pos, start = _paged_case(
            card, 4, 32, 8, 64, 16, 33, dtype, seed=3, chunk=32)
        q = torch.randn((4, 32, 64), device=card)
        qs = torch.randn((4, 32, 32, 64), device=card)
        before = kp.clone(), vp.clone()
        for splits in (1, 4):
            a, b = (k_decode.paged_flash_decode(
                q, kp, vp, tbl, pos, start, scale=0.125, k_scale=ks,
                v_scale=vs, num_splits=splits) for _ in range(2))
            assert torch.equal(a, b)
        c, d = (k_prefill.paged_flash_prefill(
            qs, kp, vp, tbl, pos, start, scale=0.125, k_scale=ks, v_scale=vs)
            for _ in range(2))
        assert torch.equal(c, d)
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


# (B, S, H, P, G, N): ragged S around the kernel's chunks (one launch at
# L = 32 up to 32 tokens; three launches at L = 64 beyond),
# groups shared by 1 to 24 heads, one group per head, jamba's N = 16, and
# mamba2-130m's head shape (P 64, N 128), whose state pass spans 8 tiles
SSD = [(1, 1, 2, 16, 1, 16), (2, 33, 4, 32, 2, 16), (3, 70, 4, 64, 1, 128),
       (2, 100, 6, 48, 3, 64), (1, 257, 24, 64, 1, 128),
       (4, 32, 24, 64, 1, 128), (2, 20, 8, 64, 4, 16),
       (1, 64, 6, 48, 2, 128), (2, 50, 4, 16, 4, 32),
       (1, 300, 8, 64, 2, 128), (1, 65, 24, 64, 1, 128)]
#: the chunk lengths ``ssd_scan_plan`` chooses (``csrc/ssd_scan.cu``)
SSD_CHUNKS = (32, 64)


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
@pytest.mark.parametrize("shape", [(1, 1, 2, 16, 1, 16),
                                   (2, 20, 8, 64, 4, 16),
                                   (2, 32, 24, 64, 1, 128)], ids=str)
def test_ssd_scan_three_passes_on_one_chunk(card, shape):
    """A single chunk that the plan runs in one launch, run as the chunk,
    state and output passes instead (as phase 6 of ``chip_smoke.py`` times
    it), is the plain version's scan too."""
    from repro_torch.kernels import _launch
    b, s, h, p, g, n = shape
    assert _launch.ssd_plan(b, s, h, p, n, g, passes=True).launches == 3
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, *shape, seed=5)
    before = k_ssd.launches
    got = k_ssd.ssd_scan(x, dt, a, bg, cg, h0, passes=True)
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
@pytest.mark.parametrize("shape", [(2, 32, 24, 64, 1, 128),
                                   (1, 300, 8, 64, 2, 128)], ids=str)
def test_ssd_scan_deterministic_and_graph_replay(card, shape):
    """One chunk (one launch) and several (three launches with scratch):
    two runs give the same bits, a fully masked sequence returns h0 bit for
    bit, and the scan captured in a CUDA graph replays to eager's bits."""
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, *shape, seed=3)
    eager = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    again = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    assert all(torch.equal(u, v) for u, v in zip(eager, again))
    _, h_masked = k_ssd.ssd_scan(torch.zeros_like(x), torch.zeros_like(dt),
                                 a, bg, cg, h0)
    assert torch.equal(h_masked, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = k_ssd.ssd_scan(x, dt, a, bg, cg, h0)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(replayed, eager))


@pytest.mark.cuda
def test_ssd_scan_plan_and_refusals(card):
    from repro_torch.kernels import _launch
    plan = _launch.ssd_plan(1, 8192, 24, 64, 128, 1)
    assert plan.chunk == 64 and plan.launches == 3
    assert plan.blocks == (25 * 128, 8 * 24, 24 * 128)
    assert plan.scratch == 4 * 128 * (24 * 128 * 64 + 64 * 64 + 24)
    assert 48 * 1024 < plan.smem <= 227 * 1024
    one = _launch.ssd_plan(2, 32, 24, 64, 128, 1)
    assert (one.chunk, one.launches, one.blocks, one.scratch) == (
        32, 1, (4 * 24 * 2,), 0)
    assert _launch.ssd_plan(1, 64, 6, 48, 128, 2)[:3] == (64, 3, (8, 36, 6))
    assert _launch.ssd_plan(1, 33, 24, 64, 128, 1).launches == 3
    forced = _launch.ssd_plan(2, 32, 24, 64, 128, 1, passes=True)
    assert (forced.chunk, forced.launches, forced.blocks, forced.scratch) == (
        64, 3, (25 * 2, 8 * 24 * 2, 24 * 2),
        4 * 2 * (24 * 128 * 64 + 64 * 64 + 24))
    for s in (1, 31, 33, 100, 1024, 8193):
        assert _launch.ssd_plan(4, s, 24, 64, 128, 1).chunk in SSD_CHUNKS
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
