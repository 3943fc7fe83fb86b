"""The port's paged attention against the JAX package, on numpy inputs from
a seed.

* The plain versions ``paged_decode_ref`` / ``paged_prefill_ref`` /
  ``merge_splits`` (what the CUDA kernels compute, and what a CPU tensor
  runs) against the reference's ``kernels/ref.py`` oracles and against its
  Pallas kernels in interpret mode (``dispatch.paged_*_attention(
  impl="kernel")``): fp32, bf16 and int8 pools, ragged ``start``, several
  fills, 1, 2 and 4 decode splits, GQA (llama-3.2-1b's 2:1 at reduced
  width) and MHA (phi-3-mini-4k's). Tolerance ``rtol = atol = 1e-5``: the
  same online softmax in fp32, differing only in the order of the sums
  inside a block.
* ``kv_quantize`` bit for bit on values at the rounding lattice.
* The slot and paged branches of ``layers.attention`` against the
  reference's, with a fully masked row and a masked row whose cursor runs
  past the end (JAX drops or clamps those writes, the port masks them),
  within ``1e-5``. The caches they leave behind equal the reference's:
  cursors and tables exactly, K/V written in fp32 within ``1e-5`` (the
  projections agree to the last bit or two), and in int8 exactly but for
  elements one level apart where the fp32 value sat within that error of
  a rounding tie (at most 1 in 500).
* The sink block: live rows never read it, so random values written into
  it leave their outputs unchanged bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import analog as ref_analog
from repro.core import quant as ref_quant
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import ref as ref_kernels
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.core import analog as port_analog
from repro_torch.core import quant as port_quant
from repro_torch.kernels import dispatch, ref
from repro_torch.models import layers as port_layers

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
POOLS = ["f32", "bf16", "i8"]
# (H, KV): GQA as llama-3.2-1b reduced, MHA as phi-3-mini-4k reduced
HEADS = {"gqa": (4, 2), "mha": (4, 4)}
BS, NB, HD = 4, 6, 16


def _case(rng, pool, heads, bsz=4, chunk=1):
    """Numpy pool, tables and cursors: distinct physical blocks per row
    (block 0 the sink), ragged ``start``, fills from one token to the
    whole table."""
    nq, nkv = HEADS[heads]
    npool = 1 + bsz * NB
    shape = (npool, BS, nkv, HD)
    if pool == "i8":
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.05).astype(np.float32)
        vs = (rng.random(shape[:3]) * 0.05).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    tbl = (rng.permutation(npool - 1) + 1).reshape(bsz, NB).astype(np.int32)
    cap = NB * BS - chunk
    pos = np.array([0, BS + 1, 2 * BS + 3, cap][:bsz], np.int32)
    start = np.array([0, 2, BS + 1, 5][:bsz], np.int32)
    start = np.minimum(start, pos)
    return kp, vp, ks, vs, tbl, pos, start


def _to_jax(a):
    return None if a is None else jnp.asarray(a)


def _to_port(a, pool):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if (pool == "bf16" and t.dim() == 4) else t


def _jax_pool(a, pool):
    if a is None:
        return None
    return (jnp.asarray(a, jnp.bfloat16) if (pool == "bf16" and a.ndim == 4)
            else jnp.asarray(a))


def _both(case, pool):
    kp, vp, ks, vs, tbl, pos, start = case
    port = ([_to_port(a, pool) for a in (kp, vp)]
            + [_to_port(a, pool) for a in (tbl, pos, start)]
            + [_to_port(ks, pool), _to_port(vs, pool)])
    jx = ([_jax_pool(a, pool) for a in (kp, vp)]
          + [_to_jax(a) for a in (tbl, pos, start)]
          + [_to_jax(ks), _to_jax(vs)])
    return port, jx


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("pool", POOLS)
def test_paged_decode_plain_matches_reference(pool, heads):
    rng = np.random.default_rng(10 * POOLS.index(pool)
                                + list(HEADS).index(heads))
    case = _case(rng, pool, heads)
    q = rng.standard_normal((4, HEADS[heads][0], HD)).astype(np.float32)
    (kp, vp, tbl, pos, start, ks, vs), jx = _both(case, pool)
    want = np.asarray(ref_kernels.paged_decode_ref(
        jnp.asarray(q), *jx[:5], 0.3, k_scale=jx[5], v_scale=jx[6]))
    for splits in (1, 2, 4):
        out = ref.paged_decode_ref(torch.from_numpy(q), kp, vp, tbl, pos,
                                   start, 0.3, ks, vs, num_splits=splits)
        np.testing.assert_allclose(out.numpy(), want, **TOL)
        # the dispatch layer runs the plain version for a CPU tensor
        got = dispatch.paged_decode_attention(
            torch.from_numpy(q), kp, vp, tbl, pos, start, 0.3, k_scale=ks,
            v_scale=vs, num_splits=splits)
        assert torch.equal(got, out)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("pool", POOLS)
def test_paged_decode_plain_matches_interpret_kernel(pool, splits):
    heads = "mha" if splits == 4 else "gqa"
    rng = np.random.default_rng(7 + splits)
    case = _case(rng, pool, heads)
    q = rng.standard_normal((4, HEADS[heads][0], HD)).astype(np.float32)
    (kp, vp, tbl, pos, start, ks, vs), jx = _both(case, pool)
    want = np.asarray(ref_dispatch.paged_decode_attention(
        jnp.asarray(q), *jx[:5], 0.3, k_scale=jx[5], v_scale=jx[6],
        num_splits=splits, impl="kernel"))
    out = ref.paged_decode_ref(torch.from_numpy(q), kp, vp, tbl, pos, start,
                               0.3, ks, vs, num_splits=splits)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("pool", POOLS)
def test_paged_prefill_plain_matches_reference_and_kernel(pool, heads):
    rng = np.random.default_rng(20 + 10 * POOLS.index(pool)
                                + list(HEADS).index(heads))
    chunk = 5
    case = _case(rng, pool, heads, chunk=chunk)
    q = rng.standard_normal((4, chunk, HEADS[heads][0], HD)).astype(
        np.float32)
    (kp, vp, tbl, pos, start, ks, vs), jx = _both(case, pool)
    out = dispatch.paged_prefill_attention(torch.from_numpy(q), kp, vp, tbl,
                                           pos, start, 0.3, k_scale=ks,
                                           v_scale=vs)
    want = ref_kernels.paged_prefill_ref(jnp.asarray(q), *jx[:5], 0.3,
                                         k_scale=jx[5], v_scale=jx[6])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    if heads == "gqa":
        kern = ref_dispatch.paged_prefill_attention(
            jnp.asarray(q), *jx[:5], 0.3, k_scale=jx[5], v_scale=jx[6],
            impl="kernel")
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)


def test_merge_splits_matches_reference():
    """Partials with a dead split (m = -inf, l = 0, acc = 0) merge as the
    reference merges them."""
    from repro.kernels.paged_attention import merge_splits as ref_merge

    rng = np.random.default_rng(3)
    o = rng.standard_normal((3, 4, 2, 5)).astype(np.float32)
    m = rng.standard_normal((3, 4, 2)).astype(np.float32)
    l = (rng.random((3, 4, 2)) + 0.5).astype(np.float32)
    o[:, 1], m[:, 1], l[:, 1] = 0.0, -np.inf, 0.0
    out = ref.merge_splits(*map(torch.from_numpy, (o, m, l)))
    want = ref_merge(*map(jnp.asarray, (o, m, l)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_split_partials_of_a_dead_split():
    """A split with no live block carries m = -inf, l = 0, acc = 0."""
    rng = np.random.default_rng(4)
    (kp, vp, tbl, pos, start, _, _), _ = _both(_case(rng, "f32", "gqa"),
                                               "f32")
    q = torch.from_numpy(rng.standard_normal((4, 4, HD)).astype(np.float32))
    acc, m, l = ref.paged_decode_partials(q, kp, vp, tbl, pos, start, 0.3,
                                          num_splits=3)
    # row 0 lives in block 0 only: splits 1 and 2 are dead
    assert torch.all(m[0, 1:] == -float("inf"))
    assert torch.all(l[0, 1:] == 0) and torch.all(acc[0, 1:] == 0)
    assert torch.isfinite(m[0, 0]).all()


def test_kv_quantize_bitwise_on_the_rounding_lattice():
    """Values that sit on the round-half lattice of their own scale round
    half to even in both packages, bit for bit."""
    rng = np.random.default_rng(5)
    s = rng.random((6, 3, 1)).astype(np.float32) + 0.01
    levels = rng.integers(-126, 126, (6, 3, 16)).astype(np.float32) + 0.5
    x = (levels * s / 127.0).astype(np.float32)
    x[..., 0] = s[..., 0]                              # absmax = s
    x = np.concatenate([x, rng.standard_normal((6, 3, 8)).astype(
        np.float32) * 0.01], axis=-1)
    a, sa = ref_quant.kv_quantize(jnp.asarray(x))
    b, sb = port_quant.kv_quantize(torch.from_numpy(x))
    assert b.dtype == torch.int8 and sb.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(sa))
    np.testing.assert_array_equal(
        port_quant.kv_dequantize(b, sb).numpy(),
        np.asarray(ref_quant.kv_dequantize(a, sa)))


# ---------------------------------------------------------------------------
# layers.attention, slot and paged branches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_params():
    """Reduced llama-3.2-1b's first attention layer, reference and port."""
    import jax
    cfg = get_config("llama-3.2-1b").reduce()
    cfg, params, _ = ref_build(cfg, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda t: np.asarray(t[0]), params["blocks"]["attn"])
    flat = {f"{site}/{leaf}": arr for site, d in p.items()
            for leaf, arr in d.items()}
    return cfg, jax.tree.map(jnp.asarray, p), params_from_numpy(flat, "cpu")


def _slot_cache(rng, cfg, paged, kv_bits, bsz, s):
    """A numpy slot cache of either layout, mid-serving: ragged cursors
    (row 2's runs past the end of its buffer), random contents."""
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    t = 16
    pos = np.array([3, 0, t - 2, 8][:bsz], np.int32)
    start = np.array([1, 0, 2, 5][:bsz], np.int32)
    if not paged:
        return {"k": rng.standard_normal((bsz, t, nkv, hd)).astype(
                    np.float32),
                "v": rng.standard_normal((bsz, t, nkv, hd)).astype(
                    np.float32),
                "pos": pos, "start": start}
    bs, nb = 4, t // 4
    npool = 1 + bsz * nb
    c = {"tbl": (rng.permutation(npool - 1) + 1).reshape(bsz, nb).astype(
             np.int32), "pos": pos, "start": start}
    c["wtbl"] = c["tbl"].copy()
    if kv_bits == 8:
        c["kp"] = rng.integers(-127, 128, (npool, bs, nkv, hd)).astype(
            np.int8)
        c["vp"] = rng.integers(-127, 128, (npool, bs, nkv, hd)).astype(
            np.int8)
        c["ks"] = (rng.random((npool, bs, nkv)) * 0.05).astype(np.float32)
        c["vs"] = (rng.random((npool, bs, nkv)) * 0.05).astype(np.float32)
    else:
        c["kp"] = rng.standard_normal((npool, bs, nkv, hd)).astype(
            np.float32)
        c["vp"] = rng.standard_normal((npool, bs, nkv, hd)).astype(
            np.float32)
    return c


def _run_both(attn_params, cache, x, mask, positions):
    cfg, rp, pp = attn_params
    racfg = ref_analog.AnalogConfig(mode="off")
    pacfg = port_analog.AnalogConfig(mode="off")
    y_ref, _, c_ref = ref_layers.attention(
        rp, jnp.asarray(x), cfg, racfg,
        ref_analog.AnalogCtx(key=None, training=False),
        jnp.asarray(positions), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(mask))
    y, _, c = port_layers.attention(
        pp, torch.from_numpy(x), cfg, pacfg, port_analog.AnalogCtx(),
        torch.from_numpy(positions),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
        torch.from_numpy(mask))
    return y, c, y_ref, c_ref


@pytest.mark.parametrize("s", [1, 3], ids=["decode", "chunk"])
@pytest.mark.parametrize("layout", ["slot", "paged", "paged_int8"])
def test_slot_attention_matches_reference(attn_params, layout, s):
    cfg = attn_params[0]
    rng = np.random.default_rng(len(layout) + s)
    bsz = 4
    cache = _slot_cache(rng, cfg, layout != "slot",
                        8 if layout == "paged_int8" else 0, bsz, s)
    x = rng.standard_normal((bsz, s, cfg.d_model)).astype(np.float32)
    mask = np.ones((bsz, s), np.float32)
    mask[1] = 0.0                      # fully masked: cache-transparent
    mask[2] = 0.0                      # masked, cursor at the end
    mask[3, 0] = 0.0                   # a left pad of an active row
    positions = (cache["pos"] - cache["start"])[:, None] + np.arange(s)
    positions = positions.astype(np.int32)
    y, c, y_ref, c_ref = _run_both(attn_params, cache, x, mask, positions)
    active = [0, 3]
    np.testing.assert_allclose(y.numpy()[active], np.asarray(y_ref)[active],
                               **TOL)
    for name, leaf in c.items():
        want = np.asarray(c_ref[name])
        got = leaf.numpy()
        if name in ("kp", "vp", "ks", "vs"):
            # masked rows wrote the sink; which write wins there is
            # unspecified, and no live row ever reads it
            got, want = got[1:], want[1:]
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        elif got.dtype == np.int8:
            off = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 2e-3, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("s", [1, 4], ids=["decode", "chunk"])
def test_sink_block_content_never_reaches_live_rows(attn_params, s):
    cfg = attn_params[0]
    rng = np.random.default_rng(9)
    cache = _slot_cache(rng, cfg, True, 0, 4, s)
    cache["tbl"][1] = 0                # an empty slot reads the sink
    cache["wtbl"][1] = 0
    x = rng.standard_normal((4, s, cfg.d_model)).astype(np.float32)
    mask = np.ones((4, s), np.float32)
    mask[1] = mask[2] = 0.0
    positions = ((cache["pos"] - cache["start"])[:, None]
                 + np.arange(s)).astype(np.int32)
    outs = []
    for fill in (0.0, None):
        c = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        c["kp"][0] = 0.0 if fill is not None else torch.randn(c["kp"][0].shape)
        c["vp"][0] = 0.0 if fill is not None else torch.randn(c["vp"][0].shape)
        y, _, _ = port_layers.attention(
            attn_params[2], torch.from_numpy(x), cfg,
            port_analog.AnalogConfig(mode="off"), port_analog.AnalogCtx(),
            torch.from_numpy(positions), c, torch.from_numpy(mask))
        outs.append(y)
    live = [0, 3]
    assert torch.equal(outs[0][live], outs[1][live])


def test_init_cache_layouts_match_reference():
    cfg = get_config("phi-3-mini-4k").reduce()
    for kw in (dict(per_slot=True), dict(paged=True, kv_block_size=4),
               dict(paged=True, kv_block_size=4, kv_blocks=5, kv_bits=8)):
        want = ref_layers.init_cache(cfg, 3, 10, **kw)
        got = port_layers.init_cache(cfg, 3, 10, device="cpu", **kw)
        assert set(got) == set(want)
        for name in want:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype).split(".")[-1] == str(
                want[name].dtype), name
