"""The hand-written CUDA kernels on the card; every test skips without one.

This file imports neither JAX nor the reference package, so that it runs on
a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It holds the libraries' launch plans (mapping switch, split-K) and the
MVM kernels against their plain versions at small ragged shapes, where the
edges of M, N and K are masked: the decode GEMV at M = 1..8, the
tensor-core mapping at M from 9 to 130 on ragged and misaligned rows (N %
4 != 0, odd N / 2, K % 32 != 0, base pointers off 16-byte alignment), the
CUDA-core tiled mapping at a 16-bit DAC, all three with a leading expert
dimension in one launch (a MoE site, qwen3-moe-30b-a3b's E = 128 among
them), the folded ADC bound bit for bit
against the explicit one, every MVM launch bitwise the same run to run
for one and several K splits, and the training form of
``dispatch.fused_analog_mvm`` (the kernel forward on noisy weights against
the noise-free bound; its STE backward on the card equal to the CPU's
within ``1e-5 * (1 + |cpu|)``, dbeta within 1e-5 of its terms' sum); and
both paged-attention kernels against
theirs at ragged tables and cursors, for fp32, bf16 and int8 pools and
1 to 8 decode splits, at the edges of their split over warps (tables of
1 to 40 blocks, more splits than blocks, chunks that are not a multiple
of the query tile), and ``ssd_scan`` against its plain version at ragged
sequence lengths (one launch up to 32 tokens, three with scratch beyond,
and the three on a single chunk as well), with groups shared by several heads, strided inputs and an incoming
state, bitwise the same run to run and under CUDA-graph replay.
Tensor-parallel serving (``-k tp``): a shard's MVM launch on its columns or
experts under the whole site's plan equals the whole launch's bit for bit;
tp = 2 engines whose shards share the card replay their step graphs equal
to eager, step by step; a tp-way run counts tp launches per sharded site.
``chip_smoke.py`` does the same at the main path's full-width shapes.
Data-parallel training (``-k data_shard``): a data shard's MVM launch on
its rows under ``dispatch.data_shards`` equals the whole launch's rows
bit for bit; a data-2 train step on a mesh over the card and the CPU
holds the unsharded step on the card (digital: metrics within 1e-5,
state within 1e-4; analog finite, with the unsharded step's launches),
and the compressed gradient's
slices on both devices equal ``compress_grads`` bit for bit.

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
# (M, K, N) over both mappings; the last two at jamba-v0.1-52b's down
# (K 14336, the largest K of any site: 448 promoted spans on mma)
RAGGED = [(1, 64, 96), (4, 128, 130), (8, 96, 64), (5, 4100, 258),
          (37, 300, 257), (130, 515, 96), (4, 14336, 4096),
          (64, 14336, 4096)]


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


# batched experts (a MoE site, one launch): (E, M, K, N, in_bits) over the
# GEMV (one split and several), the mma mapping (ragged, several M tiles)
# and the tiled one; qwen3-moe-30b-a3b's gate_up and down at E = 128;
# jamba-v0.1-52b's down (K 14336) at E = 16, at its decode's 4 rows and its
# engine chunk's 10
BATCHED = [(3, 4, 300, 258, 8), (2, 8, 4096, 96, 8), (128, 4, 2048, 1536, 8),
           (128, 8, 768, 2048, 8), (3, 37, 515, 257, 8),
           (2, 130, 300, 66, 8), (4, 64, 2048, 384, 8), (3, 9, 300, 258, 16),
           (16, 4, 14336, 4096, 8), (16, 10, 14336, 4096, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n,bits", BATCHED, ids=str)
def test_batched_analog_matmul_matches_plain_version(card, e, m, k, n, bits):
    """E experts in one launch: each expert's slice against the plain
    version of its own [M, K] @ [K, N] (near-tie flips only), the bound
    folded per expert bit for bit equal to the explicit [E, N] one, and
    the same bits run to run."""
    g = torch.Generator(device=card).manual_seed(e * m + k + n)
    x = torch.randn((e, m, k), generator=g, device=card)
    w = torch.randn((e, k, n), generator=g, device=card) * k ** -0.5
    w[1:] *= torch.linspace(0.5, 2.0, e - 1, device=card)[:, None, None]
    beta = torch.full((1,), 2.5, device=card)
    bound = ref.adc_bound(w, beta, 12.0)
    off = 0.1 * bound * torch.randn((e, n), generator=g, device=card)
    plan = dispatch.select_blocks(m, k, n, in_bits=bits, experts=e)
    assert plan.mapping == ("gemv" if m <= 8 else
                            "mma" if bits <= 12 else "tiled")
    before = k_analog.launches
    y = k_analog.analog_matmul(x, w, beta, None, off, lam=12.0,
                               in_bits=bits)
    assert k_analog.launches == before + 1 and y.shape == (e, m, n)
    assert torch.equal(y, k_analog.analog_matmul(x, w, beta, bound, off,
                                                 in_bits=bits))
    assert torch.equal(y, k_analog.analog_matmul(x, w, beta, None, off,
                                                 lam=12.0, in_bits=bits))
    for i in range(e):
        _check_analog(y[i], x[i], w[i], beta, bound[i], off[i], bits, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", [(3, 4, 300, 258), (2, 8, 4096, 96),
                                     (128, 4, 2048, 1536),
                                     (128, 8, 768, 2048), (3, 37, 515, 200),
                                     (2, 130, 260, 384),
                                     (16, 4, 14336, 4096)], ids=str)
def test_batched_int4_matmul_matches_plain_version(card, e, m, k, n):
    g = torch.Generator(device=card).manual_seed(e + m * k + n)
    w_int = torch.randint(-7, 8, (e, k, n), generator=g, device=card,
                          dtype=torch.int8)
    packed = ref.pack_int4(w_int)
    scale = (torch.rand((e, n), generator=g, device=card) + 0.5) * 0.01
    x = torch.randn((e, m, k), generator=g, device=card)
    before = k_int4.launches
    y = k_int4.int4_matmul(x, packed, scale)
    assert k_int4.launches == before + 1 and y.shape == (e, m, n)
    assert torch.equal(y, k_int4.int4_matmul(x, packed, scale))
    y_ref = ref.int4_matmul_ref(x, packed, scale)
    w_deq = w_int.float() * scale[:, None, :]
    assert ((y - y_ref).abs() <= k * U32 * (x.abs() @ w_deq.abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["analog_matmul", "int4_matmul"])
def test_batched_plans_spread_the_experts_over_the_card(card, kernel):
    """A batched plan is keyed on (E, M, K, N): the split of K counts every
    expert's tiles (so it never grows with E), the scratch grows by E, and
    one expert plans as the 2-D call."""
    for m, k, n in [(4, 8192, 128), (64, 4096, 256)]:
        one = dispatch.select_blocks(m, k, n, kernel=kernel)
        assert dispatch.select_blocks(m, k, n, kernel=kernel,
                                      experts=1) == one
        few = dispatch.select_blocks(m, k, n, kernel=kernel, experts=2)
        many = dispatch.select_blocks(m, k, n, kernel=kernel, experts=128)
        assert one.splits >= few.splits >= many.splits >= 1
        if few.splits == one.splits and one.splits > 1:
            assert few.scratch == 2 * one.scratch
    with pytest.raises(ValueError):
        dispatch.select_blocks(4, 64, 64, kernel=kernel, experts=70000)


# (B, H, KV, hd, bs, NB): GQA at llama-3.2-1b's head shape, MHA at
# phi-3-mini-4k's, a GQA group of 8 at qwen3-moe-30b-a3b's, a tiny one, hd
# 128 (over 48 KB of shared memory), and jamba-v0.1-52b's GQA group of 4 at
# hd 128
PAGED = [(3, 32, 8, 64, 16, 9), (4, 32, 32, 96, 8, 7), (3, 32, 4, 64, 16, 9),
         (2, 4, 2, 16, 4, 11), (2, 16, 2, 128, 16, 5),
         (3, 32, 8, 128, 16, 9)]
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
# groups shared by 1 to 24 heads, one group per head, jamba's N = 16 (and
# its 128 heads of P 64 on one group), and mamba2-130m's head shape (P 64,
# N 128), whose state pass spans 8 tiles
SSD = [(1, 1, 2, 16, 1, 16), (2, 33, 4, 32, 2, 16), (3, 70, 4, 64, 1, 128),
       (2, 100, 6, 48, 3, 64), (1, 257, 24, 64, 1, 128),
       (4, 32, 24, 64, 1, 128), (2, 20, 8, 64, 4, 16),
       (1, 64, 6, 48, 2, 128), (2, 50, 4, 16, 4, 32),
       (1, 300, 8, 64, 2, 128), (1, 65, 24, 64, 1, 128),
       (2, 70, 128, 64, 1, 16)]
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(9, 64, 96), (130, 515, 257)])
def test_fused_analog_mvm_training_form(card, m, k, n):
    """The training forward's call: one launch on ``w + w_noise`` against
    the explicit bound of the noise-free ``w`` (within the ADC contract of
    its plain version), then the STE backward (dx, dw, dbeta) on the card
    against the same Function on the CPU."""
    x, w, beta, bound, _ = _analog_inputs(card, m, k, n, seed=m + n)
    g = torch.Generator(device=card).manual_seed(1)
    noise = 0.02 * torch.amax(w.abs(), dim=0) * torch.randn(
        (k, n), generator=g, device=card)
    dy = torch.randn((m, n), generator=g, device=card)
    grads = []
    for dev in (card, torch.device("cpu")):
        xl, wl, bl = (t.to(dev).clone().requires_grad_()
                      for t in (x, w, beta.reshape(())))
        before = k_analog.launches
        y = dispatch.fused_analog_mvm(xl, wl, noise.to(dev), bl,
                                      bound.to(dev))
        assert k_analog.launches == before + (dev.type == "cuda")
        y.backward(dy.to(dev))
        grads.append((y.detach(), xl.grad.cpu(), wl.grad.cpu(),
                      bl.grad.cpu()))
    (y_k, dx_k, dw_k, db_k), (_, dx_r, dw_r, db_r) = grads
    _check_analog(y_k, x, w + noise, beta, bound, None, 8, 8)
    for a, b in ((dx_k, dx_r), (dw_k, dw_r)):
        assert bool(((a - b).abs() <= 1e-5 * (1 + b.abs())).all())
    assert bool(torch.equal(dx_k == 0, dx_r == 0))
    xc, wc, b0 = x.cpu(), w.cpu(), float(beta)
    xq = ref.div(torch.full((), b0), 127.0) * torch.round(
        xc.clamp(-b0, b0) * (127.0 / b0))
    err = torch.where(xc.abs() <= b0, (xq - xc) / b0, torch.sign(xc))
    terms = (err * (dy.cpu() @ wc.T)).abs().sum()
    assert abs(float(db_k - db_r)) <= 1e-5 * (1 + float(terms))


#: (E, rows per expert, K, N) of the batched training form: E 4 / 16 /
#: 128 at the 8-row GEMV and at qwen3-moe's 80 training rows on mma, K up
#: to jamba's 14336
BATCHED_TRAIN = [(4, 8, 300, 258), (4, 80, 515, 130), (16, 8, 14336, 256),
                 (16, 80, 14336, 256), (128, 8, 768, 2048),
                 (128, 80, 2048, 1536)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", BATCHED_TRAIN, ids=str)
def test_batched_fused_training_form(card, e, m, k, n):
    """A batched expert site's training call: one launch for all experts
    on ``w + w_noise`` (each expert's own noise scale) against the
    explicit [E, N] bound of the noise-free ``w`` (each expert within the
    ADC contract of its plain version), then the STE backward (dx, each
    expert's dw, the shared dbeta) on the card against the same Function
    on the CPU within ``1e-5 * (1 + |cpu|)``, dbeta within 1e-5 of its
    terms' sum."""
    g = torch.Generator(device=card).manual_seed(e + m + k + n)
    x = torch.randn((e, m, k), generator=g, device=card)
    w = torch.randn((e, k, n), generator=g, device=card) * k ** -0.5
    w[1:] *= torch.linspace(0.5, 2.0, e - 1, device=card)[:, None, None]
    beta = torch.full((1,), 2.5, device=card)
    bound = ref.adc_bound(w, beta, 12.0)
    noise = 0.02 * torch.amax(w.abs(), dim=1, keepdim=True) * torch.randn(
        (e, k, n), generator=g, device=card)
    dy = torch.randn((e, m, n), generator=g, device=card)
    grads = []
    for dev in (card, torch.device("cpu")):
        xl, wl, bl = (t.to(dev).clone().requires_grad_()
                      for t in (x, w, beta.reshape(())))
        before = k_analog.launches
        y = dispatch.fused_analog_mvm(xl, wl, noise.to(dev), bl,
                                      bound.to(dev))
        assert k_analog.launches == before + (dev.type == "cuda")
        y.backward(dy.to(dev))
        assert k_analog.launches == before + (dev.type == "cuda")
        grads.append((y.detach(), xl.grad.cpu(), wl.grad.cpu(),
                      bl.grad.cpu()))
    (y_k, dx_k, dw_k, db_k), (_, dx_r, dw_r, db_r) = grads
    for i in range(e):
        _check_analog(y_k[i], x[i], w[i] + noise[i], beta, bound[i], None,
                      8, 8)
    for a, b in ((dx_k, dx_r), (dw_k, dw_r)):
        assert bool(((a - b).abs() <= 1e-5 * (1 + b.abs())).all())
    assert bool(torch.equal(dx_k == 0, dx_r == 0))
    xc, wc, b0 = x.cpu(), w.cpu(), float(beta)
    xq = ref.div(torch.full((), b0), 127.0) * torch.round(
        xc.clamp(-b0, b0) * (127.0 / b0))
    err = torch.where(xc.abs() <= b0, (xq - xc) / b0, torch.sign(xc))
    terms = (err * (dy.cpu() @ wc.transpose(-1, -2))).abs().sum()
    assert abs(float(db_k - db_r)) <= 1e-5 * (1 + float(terms))


def _ssd_f64(x, dt, a, b, c):
    """The SSD recurrence token by token in float64 from a zero state
    (head h reads group h // (H / G)): y [B, S, H, P]."""
    bsz, s, heads, p = x.shape
    rep = heads // b.shape[2]
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)
    h = torch.zeros((bsz, heads, b.shape[3], p), dtype=x.dtype,
                    device=x.device)
    ys = []
    for t in range(s):
        h = (torch.exp(dt[:, t] * a)[..., None, None] * h
             + (dt[:, t, :, None] * bh[:, t])[..., None] * x[:, t, :, None])
        ys.append(torch.einsum("zhn,zhnp->zhp", ch[:, t], h))
    return torch.stack(ys, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 70, 8, 64, 2, 16),
                                   (2, 100, 24, 64, 1, 128)], ids=str)
def test_ssd_autograd_rule_matches_float64(card, shape):
    """``dispatch.ssd`` with inputs that need a gradient (x, b and c
    strided views of one projection): the forward launches ``ssd_scan``
    once, the backward launches nothing (it differentiates the plain
    version rebuilt from the saved inputs), and the gradients of x, dt, a,
    b and c from an upstream gradient of y lie within 1e-4 of each
    gradient's largest magnitude of the recurrence's autograd in
    float64; with the final state's gradient too, h0 included."""
    b_, s, h, p, g, n = shape
    x, dt, a, bg, cg, h0 = _ssd_inputs(card, b_, s, h, p, g, n, seed=s,
                                       wide=True)
    gen = torch.Generator(device=card).manual_seed(7)
    gy = torch.randn((b_, s, h, p), generator=gen, device=card)
    base = x._base
    got = {}
    for kind in ("kernel", "f64"):
        dtype = torch.float32 if kind == "kernel" else torch.float64
        xbc = base.to(dtype).clone().requires_grad_()
        dtl, al = (t.to(dtype).clone().requires_grad_() for t in (dt, a))
        xl = xbc[..., :h * p].reshape(b_, s, h, p)
        bl = xbc[..., h * p:h * p + g * n].reshape(b_, s, g, n)
        cl = xbc[..., h * p + g * n:h * p + 2 * g * n].reshape(b_, s, g, n)
        if kind == "kernel":
            before = k_ssd.launches
            y, _ = dispatch.ssd(xl, dtl, al, bl, cl)
            assert k_ssd.launches == before + 1
            y.backward(gy)
            assert k_ssd.launches == before + 1
        else:
            _ssd_f64(xl, dtl, al, bl, cl).backward(gy.double())
        got[kind] = (xbc.grad, dtl.grad, al.grad)
    for a_, b64 in zip(got["kernel"], got["f64"]):
        assert torch.isfinite(a_).all()
        err = (a_.double() - b64).abs().max()
        assert float(err) <= 1e-4 * float(b64.abs().max())
    # the final state's gradient and an incoming state: against the plain
    # version differentiated directly on the card
    outs = []
    for fn in (dispatch.ssd, ref.ssd_scan_ref):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, dt, a, bg, cg, h0)]
        y, hf = fn(*leaves)
        torch.autograd.backward([y, hf], [gy, torch.ones_like(hf)])
        outs.append([t.grad for t in leaves])
    for a_, b_ in zip(*outs):
        assert float((a_ - b_).abs().max()) <= 1e-4 * float(b_.abs().max())


def _device_site(lead, k, n, dev):
    """A site of weights ``lead + (k, n)`` with device state attached (on
    a CPU generator) and aged 12 h, on ``dev``, and the CPU's copy."""
    from repro_torch.core import analog as A
    from repro_torch.core import devices as D

    g = torch.Generator().manual_seed(0)
    p = {"kernel": torch.randn(lead + (k, n), generator=g) * k ** -0.5,
         "input_range": torch.full((1,), 2.5)}
    dcfg = D.DeviceConfig(sigma_offset=0.01, p_stuck_col=0.05,
                          p_dead_tile=0.1)
    cpu = D.attach_device_state({"l": p}, {"l": A.linear_labels(p)},
                                torch.Generator().manual_seed(1), dcfg)
    D.advance(cpu, 12.0)
    on_dev = {"l": {key: ({kk: vv.to(dev) for kk, vv in v.items()}
                          if isinstance(v, dict) else v.to(dev))
                    for key, v in cpu["l"].items()}}
    return cpu, on_dev


@pytest.mark.cuda
@pytest.mark.parametrize("lead,k,n", [((), 600, 3352), ((4,), 300, 520)],
                         ids=["site", "experts"])
def test_device_site_on_the_card_matches_the_cpu(card, lead, k, n):
    """A site with per-tile device state (tiles of 200 x 240 at K 600, N
    3352: the span does not divide by 256) is one ``analog_matmul`` launch
    with ``col_off`` ([N], or [E, N] for four experts in one launch),
    against the plain version on the CPU's corrupted weights and offsets
    (``_check_analog``, expert by expert)."""
    from repro_torch.core import analog as A
    from repro_torch.core import devices as D

    cpu, dev = _device_site(lead, k, n, card)
    x = torch.randn(lead + (8, k), generator=torch.Generator().manual_seed(2))
    acfg = A.AnalogConfig(mode="analog", use_pallas=True)
    before = k_analog.launches
    y, _ = A.analog_linear(dev["l"], x.to(card), acfg, A.AnalogCtx())
    torch.cuda.synchronize()
    assert k_analog.launches == before + 1
    site = cpu["l"]
    beta = site["input_range"]
    bound = ref.adc_bound(site["kernel"], beta, acfg.out_bound)
    w_eff, off = D.corrupt_weights(site["kernel"], site["device"], bound)
    y = y.cpu()
    if not lead:
        _check_analog(y, x, w_eff, beta, bound, off, 8, 8)
        return
    for e in range(lead[0]):
        _check_analog(y[e], x[e], w_eff[e], beta, bound[e], off[e], 8, 8)


@pytest.mark.cuda
def test_device_clock_and_recalibration_in_place_on_the_card(card):
    """``advance`` and ``recalibrate`` write into the leaves on the card
    (every ``data_ptr`` kept); one seed redraws the CPU's bits; a CUDA
    graph captured before a tick replays the new state, equal to the eager
    call bit for bit."""
    from repro_torch.core import analog as A
    from repro_torch.core import devices as D

    cpu, dev = _device_site((3,), 512, 768, card)
    leaves = dev["l"]["device"]
    ptrs = {key: v.data_ptr() for key, v in leaves.items()}
    layer = {key: (v[1] if not isinstance(v, dict) else
                   {kk: vv[1] for kk, vv in v.items()})
             for key, v in dev["l"].items() if key != "input_range"}
    layer["input_range"] = dev["l"]["input_range"]
    x = torch.randn((8, 512), device=card)
    acfg = A.AnalogConfig(mode="analog", use_pallas=True)

    def step():
        return A.analog_linear(layer, x, acfg, A.AnalogCtx())[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for tick in ("advance", "recalibrate"):
        if tick == "advance":
            assert D.advance(dev, 30.0) is dev
            D.advance(cpu, 30.0)
        else:
            assert D.recalibrate(dev, torch.Generator().manual_seed(3)) is dev
            D.recalibrate(cpu, torch.Generator().manual_seed(3))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, step())
        assert {key: v.data_ptr() for key, v in leaves.items()} == ptrs
        for key in ("t", "t_prog", "gain", "off", "nu", "dead", "stuck"):
            assert torch.equal(leaves[key].cpu(), cpu["l"]["device"][key])


# ---------------------------------------------------------------------------
# the continuous engine's steps as CUDA graphs (serve.graphs)
# ---------------------------------------------------------------------------

def _graph_model(arch, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(arch).reduce()
    if cfg.family in ("moe", "hybrid"):
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return build(cfg, 0, device=dev)[:2]


def _graph_reqs(cfg, n, seed=0):
    """``n`` requests of 16 new tokens (decode blocks at k = 8, 4, 2, 1),
    every second one sampled with top-k or top-p."""
    import numpy as np

    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = (dict(temperature=0.8, top_k=5 if i % 4 == 1 else 0,
                   top_p=0.9 if i % 4 == 3 else 1.0, seed=seed + i)
              if i % 2 else dict(temperature=0.0))
        out.append(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(3, 20))).astype(np.int32),
            max_new=16, **kw))
    return out


def _launch_counts():
    from repro_torch.serve import graphs
    return [m.launches for m in graphs.KERNELS]


def _cache_leaves(eng):
    """Every cache leaf of the engine and of its drafter; a pool leaf
    without its sink block, which the masked rows of a step write in an
    undefined order (duplicate indices) and nothing reads."""
    from repro_torch.serve.kv_pool import SINK_BLOCK
    from repro_torch.serve.scheduler import _walk

    out = [leaf if kind != "pool" else torch.cat(
               [leaf[:, :SINK_BLOCK], leaf[:, SINK_BLOCK + 1:]], dim=1)
           for leaf, kind in _walk(eng.caches, eng._kinds)]
    if eng.draft_caches is not None:
        out += [leaf for (leaf,) in _walk(eng.draft_caches)]
    return out


GRAPH_CASES = [(arch, None) for arch in ("llama-3.2-1b", "qwen3-moe-30b-a3b",
                                         "mamba2-130m", "jamba-v0.1-52b")]
GRAPH_CASES += [(arch, draft) for arch in ("llama-3.2-1b",
                                           "qwen3-moe-30b-a3b")
                for draft in ("ngram", "self", "int4")]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,draft", GRAPH_CASES, ids=str)
def test_engine_graph_replay_equals_eager_steps(card, arch, draft):
    """Two engines on the same weights in lockstep, one replaying its
    captured step graphs and one running the same bodies eagerly (the
    private ``_eager``): after every step the tokens, the host cursors,
    every cache leaf (``pos`` cursors included; a pool leaf without its
    sink block), the decoding rows' next tokens and every counter are
    equal bit for bit, and so are the kernel launches the step counted;
    every body key of the workload was captured once and replayed."""
    import numpy as np

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg, params = _graph_model(arch, card)
    spec = dict(speculative=True, draft=draft, draft_k=4) if draft else {}
    scfg = SchedulerConfig(num_slots=3, max_len=64, prefill_chunk=8,
                           kv_block_size=8, paged=True, **spec)
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    engines = [ServeEngine(params, cfg, acfg, scfg) for _ in range(2)]
    eager, graphed = engines
    eager._eager = True
    for eng in engines:
        for r in _graph_reqs(cfg, 6):
            eng.submit(r)
    names = ("decode_steps", "mixed_steps", "prefill_forwards",
             "prefill_chunks", "spec_steps", "spec_proposed",
             "spec_accepted", "draft_forwards")
    while eager.queue or eager.num_active:
        c0 = _launch_counts()
        eager.step()
        c1 = _launch_counts()
        graphed.step()
        c2 = _launch_counts()
        assert [b - a for a, b in zip(c0, c1)] == [
            b - a for a, b in zip(c1, c2)]
        assert [getattr(eager, n) for n in names] == [
            getattr(graphed, n) for n in names]
        np.testing.assert_array_equal(eager._pos, graphed._pos)
        for a, b in zip(_cache_leaves(eager), _cache_leaves(graphed)):
            assert torch.equal(a, b)
        # the next step's input tokens of the decoding rows (a masked
        # row's token is never read: it is written anew at its flip)
        live = eager._dev["active"] > 0
        assert torch.equal(eager._dev["toks"][live],
                           graphed._dev["toks"][live])
        assert torch.equal(eager._dev["off"], graphed._dev["off"])
    assert not graphed.queue and not graphed.num_active
    for uid, toks in eager.results.items():
        np.testing.assert_array_equal(graphed.results[uid], toks)
    sg = graphed.step_graphs
    assert eager.step_graphs.captures == 0
    assert sg.captures == len(sg.keys()) and sg.replays > 0
    kinds = {k[0] for k in sg.keys()}
    assert {"decode", "mixed"} <= kinds if not draft else (
        {"verify" if draft == "ngram" else "spec", "mixed"} <= kinds)


@pytest.mark.cuda
def test_engine_launch_counters_graphed_equal_eager(card):
    """Whole runs: the kernel launch counters after a graphed run equal
    those after an eager run of the same workload, and follow the
    engine's forwards."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve import graphs
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg, params = _graph_model("llama-3.2-1b", card)
    scfg = SchedulerConfig(num_slots=3, max_len=64, prefill_chunk=8,
                           kv_block_size=8, paged=True)
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    counts, forwards = [], []
    for eager in (True, False):
        for m in graphs.KERNELS:
            m.launches = 0
        eng = ServeEngine(params, cfg, acfg, scfg)
        eng._eager = eager
        eng.run(_graph_reqs(cfg, 6, seed=1))
        counts.append(_launch_counts())
        forwards.append((eng.decode_steps, eng.prefill_forwards))
    assert counts[0] == counts[1] and forwards[0] == forwards[1]
    steps, chunks = forwards[0]
    got = dict(zip(graphs.KERNELS, counts[1]))
    sites = 4 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)
    assert got[k_analog] == sites * (steps + chunks)
    assert got[k_decode] == cfg.num_layers * steps
    assert got[k_prefill] == cfg.num_layers * chunks


@pytest.mark.cuda
def test_engine_failed_capture_raises(card):
    """A body that reads the host cannot be captured: the step raises
    (no fallback to eager)."""
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg, params = _graph_model("llama-3.2-1b", card)
    eng = ServeEngine(params, cfg, AnalogConfig(mode="off"),
                      SchedulerConfig(num_slots=2, max_len=40,
                                      prefill_chunk=8, kv_block_size=8,
                                      paged=True))
    real = eng._decode_body

    def reads_host(k, key):
        real(k, key)
        eng._dev["toks"].sum().item()

    eng._decode_body = reads_host
    with pytest.raises(RuntimeError):
        eng.run(_graph_reqs(cfg, 2))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_engine_capture_survives_collecting_a_dead_engine(card):
    """A cyclic collection inside a capture frees a dead engine (kept
    alive only by a reference cycle) with its step graphs: the capture is
    not invalidated (the dead graphs are destroyed after it), and the live
    engine gives the dead engine's tokens, and again when the same
    workload replays the graphs captured around the collection."""
    import gc
    import weakref

    import numpy as np

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve import graphs
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg, params = _graph_model("llama-3.2-1b", card)
    scfg = SchedulerConfig(num_slots=2, max_len=40, prefill_chunk=8,
                           kv_block_size=8, paged=True)
    acfg = AnalogConfig(mode="off")
    dead = ServeEngine(params, cfg, acfg, scfg)
    dead.run(_graph_reqs(cfg, 2))
    assert dead.step_graphs.captures > 0
    want = {uid: np.array(t) for uid, t in dead.results.items()}
    probe = weakref.ref(dead.step_graphs)
    dead.cycle = dead
    holder = [dead]
    del dead
    eng = ServeEngine(params, cfg, acfg, scfg)
    real = eng._decode_body
    collected = []

    def drops_and_collects(k, key):
        real(k, key)
        if holder and torch.cuda.is_current_stream_capturing():
            # the dead engine becomes garbage inside the capture (a
            # collection at the capture's start cannot free it first)
            holder.clear()
            collected.append(gc.collect())
            collected.append(probe() is None)

    eng._decode_body = drops_and_collects
    first = {uid: np.array(t) for uid, t in
             eng.run(_graph_reqs(cfg, 2)).items()}
    torch.cuda.synchronize()
    assert collected and collected[0] > 0 and collected[1]
    assert not graphs._graveyard and graphs._capturing == 0
    again = eng.run(_graph_reqs(cfg, 2))
    torch.cuda.synchronize()
    assert eng.step_graphs.replays > 0
    assert set(first) == set(again) == set(want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(first[uid], toks)
        np.testing.assert_array_equal(again[uid], toks)


# ---------------------------------------------------------------------------
# tensor-parallel serving on one card (distributed.sharding)
# ---------------------------------------------------------------------------

TP_SHAPES = [(1, 8, 2048, 3072), (1, 64, 2048, 16384), (1, 8, 8192, 2048),
             (1, 130, 515, 1032), (8, 4, 300, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("e,m,k,n", TP_SHAPES, ids=str)
def test_tp_shard_launch_runs_the_whole_sites_plan(card, e, m, k, n, tp):
    """A shard's launch under ``plan_shape`` (the whole site's experts and
    columns) gives the whole launch's columns (a batched site: its
    experts) bit for bit, for both MVM kernels; so does a shard run through
    ``dispatch.whole_site``."""
    gen = torch.Generator(device=card).manual_seed(e * m + k + n + tp)
    lead = (e,) if e > 1 else ()
    x = torch.randn(lead + (m, k), generator=gen, device=card)
    w = torch.randn(lead + (k, n), generator=gen, device=card) * k ** -0.5
    beta = torch.full((1,), 2.5, device=card)
    w_int, scale = _rtn4(w)
    packed = ref.pack_int4(w_int)
    scale = scale.reshape(lead + (n,)).contiguous()
    whole = k_analog.analog_matmul(x, w, beta, lam=14.0)
    whole4 = k_int4.int4_matmul(x, packed, scale)
    if e > 1:                          # expert-parallel: E / tp experts each
        step = e // tp
        for i in range(tp):
            s = slice(i * step, (i + 1) * step)
            got = k_analog.analog_matmul(x[s].contiguous(),
                                         w[s].contiguous(), beta, lam=14.0,
                                         plan_shape=(e, n))
            assert torch.equal(got, whole[s])
            got4 = k_int4.int4_matmul(x[s].contiguous(),
                                      packed[s].contiguous(),
                                      scale[s].contiguous(),
                                      plan_shape=(e, n))
            assert torch.equal(got4, whole4[s])
        return
    cols = n // tp
    for i in range(tp):
        c = slice(i * cols, (i + 1) * cols)
        ws = w[:, c].contiguous()
        got = k_analog.analog_matmul(x, ws, beta, lam=14.0,
                                     plan_shape=(1, n))
        assert torch.equal(got, whole[:, c])
        with dispatch.whole_site(1, n):
            got = dispatch.analog_mvm(x, ws, beta, lam=14.0)
        assert torch.equal(got, whole[:, c])
        pc = slice(i * cols // 2, (i + 1) * cols // 2)
        got4 = k_int4.int4_matmul(x, packed[:, pc].contiguous(),
                                  scale[c].contiguous(), plan_shape=(1, n))
        assert torch.equal(got4, whole4[:, c])


# (E, M of the whole batch, K, N): llama-3.2-1b's training sites at phase
# 14's 1024 rows, a ragged site, and a batched expert site
DATA_SHAPES = [(1, 1024, 2048, 3072), (1, 1024, 8192, 2048),
               (1, 1024, 2048, 16384), (1, 520, 515, 1032),
               (8, 64, 300, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("e,m,k,n_cols", DATA_SHAPES, ids=str)
def test_data_shard_launch_runs_the_whole_batchs_plan(card, e, m, k, n_cols,
                                                      n):
    """A data shard's rows (each expert's rows of a batched site) under
    ``dispatch.data_shards(n)`` give the whole launch's rows bit for bit:
    the shard's launch runs the whole batch's K split."""
    gen = torch.Generator(device=card).manual_seed(e * m + k + n_cols + n)
    lead = (e,) if e > 1 else ()
    x = torch.randn(lead + (m, k), generator=gen, device=card)
    w = torch.randn(lead + (k, n_cols), generator=gen,
                    device=card) * k ** -0.5
    beta = torch.full((1,), 2.5, device=card)
    whole = dispatch.analog_mvm(x, w, beta, lam=14.0)
    rows = m // n
    for i in range(n):
        r = slice(i * rows, (i + 1) * rows)
        with dispatch.data_shards(n):
            got = dispatch.analog_mvm(x[..., r, :].contiguous(), w, beta,
                                      lam=14.0)
        assert torch.equal(got, whole[..., r, :])


def _two_device_run(card, mode: str, mesh_devices, steps: int = 3):
    """``steps`` steps of reduced llama-3.2-1b's train step (teacher
    inside, a CE mix and a mask that gives the shards unequal token
    counts) from weights on the card, under a data mesh on
    ``mesh_devices`` (None: unsharded). Returns ``[(params, opt, metrics)]``
    gathered to the card and the ``analog_matmul`` launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.distributed import placement
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh, place_mesh
    from repro_torch.models import build
    from repro_torch.optim.schedule import polynomial_with_warmup
    from repro_torch.train import train_step as ts

    cfg, params, labels = build(get_config("llama-3.2-1b").reduce(), 0,
                                device=card)
    teacher = {k: v for k, v in params.items()}
    acfg = AnalogConfig(mode=mode, use_pallas=True, init_steps=3,
                        kappa_init=18.0, out_bound=14.0)
    tcfg = ts.TrainConfig(peak_lr=1e-3, total_steps=20, kd_temperature=2.0,
                          ce_weight=0.5)
    step = ts.make_train_step(cfg, acfg, tcfg, labels, lambda s: (
        polynomial_with_warmup(s, peak_lr=1e-3, total_steps=20)))
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 13), generator=gen)
    mask = (torch.rand((4, 12), generator=gen) < 0.7).float()
    mask[-1, :3] = 0.0
    batch = {"tokens": toks[:, :-1].to(card), "labels": toks[:, 1:].to(card),
             "mask": mask.to(card)}
    mesh = (None if mesh_devices is None else place_mesh(
        Mesh(("data", "model"), (len(mesh_devices), 1)), mesh_devices))
    p, st, out = params, ts.init_train_state(params), []
    k_analog.launches = 0
    for _ in range(steps):
        if mesh is None:
            p, st, m = step(p, st, batch, (7,), teacher)
        else:
            with shd.activate(mesh, shd.default_rules(mesh)):
                p, st, m = step(p, st, batch, (7,), teacher)
        out.append((placement.gather_tree(p, card),
                    placement.gather_tree(st["opt"], card), m))
    return out, k_analog.launches


@pytest.mark.cuda
def test_data_shard_step_across_card_and_cpu(card):
    """A data-2 train step on a mesh placed over ``["cuda:0", "cpu"]``
    (the one card's rig): the shards' forwards and backwards on their own
    devices, the gradient sum on the first, the ZeRO slices and AdamW on
    each slice's device (its clipping scale and learning rate moved
    there), against the unsharded step on the card over 3 steps. Digital
    (mode ``off``), the CPU's products and the card's round apart by a
    few u of their K-term sums: the loss, ``ce`` and ``grad_norm`` within
    ``1e-5 (1 + |card|)``; every parameter within ``1e-4 (1 + |card|)``
    and every moment leaf within ``1e-4`` of its largest magnitude, since
    AdamW divides each gradient element by its own RMS, so an element
    whose sum over the batch cancels carries its terms' rounding at O(1)
    relative into m, times the learning rate into the parameter (the same
    run with both positions on the CPU parts from the unsharded step by
    1.2e-7 in the metrics, 1.9e-6 in the parameters and 2.8e-6 in the
    moments). Analog, the CPU shard runs the
    kernel's plain version, which may part from it at ADC near-ties: the
    run's values are finite and the card shard launches the kernel as
    often as the unsharded step does."""
    from repro_torch.checkpoint import flatten_paths

    cpu = torch.device("cpu")
    base, _ = _two_device_run(card, "off", None)
    runs, _ = _two_device_run(card, "off", [card, cpu])
    for i, ((p, o, m), (p0, o0, m0)) in enumerate(zip(runs, base)):
        for name in ("loss", "ce", "grad_norm"):
            a, b = float(m[name]), float(m0[name])
            assert abs(a - b) <= 1e-5 * (1 + abs(b)), (i, name, a, b)
        fp = flatten_paths(p)
        for path, v in flatten_paths(p0).items():
            err = float(((fp[path] - v).abs() / (1 + v.abs())).max())
            assert err <= 1e-4, (i, path, err)
        fo = flatten_paths({"m": o["m"], "v": o["v"]})
        for path, v in flatten_paths({"m": o0["m"], "v": o0["v"]}).items():
            err = float((fo[path] - v).abs().max())
            assert err <= 1e-4 * float(v.abs().max()), (i, path, err)
    base, n_base = _two_device_run(card, "analog", None, steps=2)
    runs, n_runs = _two_device_run(card, "analog", [card, cpu], steps=2)
    assert n_runs == n_base > 0
    for p, o, m in runs:
        assert all(bool(torch.isfinite(v).all()) for v in
                   flatten_paths({"p": p, "m": o["m"], "v": o["v"]}).values())
        assert all(bool(torch.isfinite(m[k])) for k in ("loss", "kd", "ce",
                                                        "grad_norm"))


@pytest.mark.cuda
def test_data_shard_compressed_slices_across_card_and_cpu(card):
    """A gradient and error state placed by their ZeRO specs on a data-2
    mesh over ``["cuda:0", "cpu"]``, each leaf compressed slice by slice
    with the whole leaf's scale (the scale taken on the first slice's
    device, moved to the other's), equals ``compress_grads`` of the whole
    trees on the CPU bit for bit (every op is elementwise or a max)."""
    from repro_torch.checkpoint import flatten_paths, unflatten_paths
    from repro_torch.configs import get_config
    from repro_torch.distributed import placement
    from repro_torch.launch.mesh import Mesh, place_mesh
    from repro_torch.models import build
    from repro_torch.optim import compression

    _, params, _ = build(get_config("llama-3.2-1b").reduce(), 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    grads = {p: torch.randn(v.shape, generator=gen) * 1e-3
             for p, v in flatten_paths(params).items()}
    errs = {p: torch.randn(v.shape, generator=gen) * 1e-5
            for p, v in grads.items()}
    want_g, want_e = compression.compress_grads(unflatten_paths(grads),
                                                unflatten_paths(errs))
    mesh = place_mesh(Mesh(("data", "model"), (2, 1)), [card, "cpu"])
    pg = flatten_paths(placement.place_by(unflatten_paths(grads), mesh))
    pe = flatten_paths(placement.place_by(unflatten_paths(errs), mesh))
    split = 0
    for path, leaf in pg.items():
        if not isinstance(leaf, placement.Placed):
            continue
        split += len(leaf.blocks()) > 1
        g, e = placement.map_leaf(compression.compress_slices, leaf,
                                  pe[path])
        assert torch.equal(placement.gather(g, "cpu"),
                           flatten_paths(want_g)[path]), path
        assert torch.equal(placement.gather(e, "cpu"),
                           flatten_paths(want_e)[path]), path
    assert split > 0


def _rtn4(w):
    from repro_torch.core import quant
    return quant.rtn_quantize(w, 4, axis=-2)


def _tp_cache_leaves(eng):
    """Every cache leaf of a (possibly sharded) engine, gathered, a pool
    leaf without its sink block (see ``_cache_leaves``)."""
    from repro_torch.distributed import sharding
    from repro_torch.serve.kv_pool import SINK_BLOCK
    from repro_torch.serve.scheduler import _walk

    out = []
    for leaf, kind in _walk(eng.caches, eng._kinds):
        leaf = sharding.whole(leaf)
        if kind == "pool":
            leaf = torch.cat([leaf[:, :SINK_BLOCK], leaf[:, SINK_BLOCK + 1:]],
                             dim=1)
        out.append(leaf)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen3-moe-30b-a3b"])
def test_tp_engine_graph_replay_equals_eager_steps(card, arch):
    """Two tp = 2 engines whose shards share the card, in lockstep, one
    replaying its captured step graphs (decode blocks and fused chunk
    steps, every shard's launches inside) and one running the bodies
    eagerly: after every step the tokens, cursors, every cache leaf (the
    shards gathered), the decoding rows' next tokens, the counters and the
    launches counted are equal; the tokens equal a tp = 1 engine's."""
    import numpy as np

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg, params = _graph_model(arch, card)
    scfg = SchedulerConfig(num_slots=3, max_len=64, prefill_chunk=8,
                           kv_block_size=8, paged=True, tp=2)
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    engines = [ServeEngine(params, cfg, acfg, scfg, shard_devices=[card] * 2)
               for _ in range(2)]
    eager, graphed = engines
    assert graphed.mesh is not None and graphed.step_graphs is not None
    eager._eager = True
    for eng in engines:
        for r in _graph_reqs(cfg, 6):
            eng.submit(r)
    names = ("decode_steps", "mixed_steps", "prefill_forwards",
             "prefill_chunks")
    while eager.queue or eager.num_active:
        c0 = _launch_counts()
        eager.step()
        c1 = _launch_counts()
        graphed.step()
        c2 = _launch_counts()
        assert [b - a for a, b in zip(c0, c1)] == [
            b - a for a, b in zip(c1, c2)]
        assert [getattr(eager, n) for n in names] == [
            getattr(graphed, n) for n in names]
        np.testing.assert_array_equal(eager._pos, graphed._pos)
        for a, b in zip(_tp_cache_leaves(eager), _tp_cache_leaves(graphed)):
            assert torch.equal(a, b)
        live = eager._dev["active"] > 0
        assert torch.equal(eager._dev["toks"][live],
                           graphed._dev["toks"][live])
    one = ServeEngine(params, cfg, acfg, SchedulerConfig(
        num_slots=3, max_len=64, prefill_chunk=8, kv_block_size=8,
        paged=True)).run(_graph_reqs(cfg, 6))
    for uid, toks in one.items():
        np.testing.assert_array_equal(graphed.results[uid], toks)
        np.testing.assert_array_equal(eager.results[uid], toks)
    kinds = {k[0] for k in graphed.step_graphs.keys()}
    assert {"decode", "mixed"} <= kinds


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_launch_counters_count_every_shard(card, tp):
    """A graphed tp-way run counts ``tp`` launches per sharded site and per
    attention layer: every kernel's count is tp times the tp = 1 run's,
    and the tokens are the same."""
    import numpy as np

    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve import graphs
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    # the reduced llama's 2 KV heads do not split 4 ways: MHA at tp = 4
    cfg = get_config("llama-3.2-1b").reduce()
    if cfg.num_kv_heads % tp:
        cfg = dataclasses.replace(cfg, num_kv_heads=cfg.num_heads)
    cfg, params, _ = build(cfg, 0, device=card)
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    counts, outs = [], []
    for n in (1, tp):
        for m in graphs.KERNELS:
            m.launches = 0
        eng = ServeEngine(params, cfg, acfg, SchedulerConfig(
            num_slots=3, max_len=64, prefill_chunk=8, kv_block_size=8,
            paged=True, tp=n), shard_devices=[card] * n if n > 1 else None)
        assert "tensor_parallel" not in eng.gating_reasons
        outs.append(eng.run(_graph_reqs(cfg, 6, seed=2)))
        counts.append(_launch_counts())
    assert [tp * c for c in counts[0]] == counts[1]
    for uid, toks in outs[0].items():
        np.testing.assert_array_equal(outs[1][uid], toks)


@pytest.mark.cuda
def test_tp_engine_from_host_params_holds_only_shards(card):
    """A tp = 2 engine handed a model in host memory (full-width
    llama-3.2-1b at 2 layers, as ``launch/serve.py --tp`` builds it):
    every shard and replicated leaf lands on the card, the card's peak
    while the engine is built stays below twice the model (the whole model
    is never there beside its shards), and the tokens equal a tp = 1
    engine's over the same weights moved to the card."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.serve.scheduler import SchedulerConfig, ServeEngine

    cfg = dataclasses.replace(get_config("llama-3.2-1b"), num_layers=2)
    cfg, params, _ = build(cfg, 0, device="cpu")
    model_bytes = sum(t.numel() * t.element_size()
                      for t in _tree_tensors(params))
    acfg = AnalogConfig(mode="analog", train_noise=False, use_pallas=True)
    scfg = SchedulerConfig(num_slots=3, max_len=64, prefill_chunk=8,
                           kv_block_size=8, paged=True)
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    eng = ServeEngine(params, cfg, acfg, dataclasses.replace(scfg, tp=2),
                      shard_devices=[card] * 2)
    peak = torch.cuda.max_memory_allocated(card) - base
    assert eng.mesh is not None and eng.device.type == "cuda"
    for t in _tree_tensors(eng.params):
        parts = t.parts if isinstance(t, sharding.Shards) else [t]
        assert all(p.device == eng.device for p in parts)
    assert peak < 1.5 * model_bytes, (peak, model_bytes)
    got = eng.run(_graph_reqs(cfg, 4, seed=3))
    del eng
    want = ServeEngine(_to_card(params, card), cfg, acfg, scfg).run(
        _graph_reqs(cfg, 4, seed=3))
    for uid, toks in want.items():
        np.testing.assert_array_equal(got[uid], toks)


def _tree_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v)
    else:
        yield tree


def _to_card(tree, card):
    if isinstance(tree, dict):
        return {k: _to_card(v, card) for k, v in tree.items()}
    return tree.to(card)
