"""The pieces of the port's speculative decoding, against the JAX package's:
exact-match verification (``serve.sampling.speculative_verify``), the host
drafter (``_ngram_propose``), the window's size (``ServeEngine._spec_k``),
the pool's rewind contract (``KVPool.rewind_floor`` / ``check_rewind`` /
the rewind window) and the verify seam of the plain paged-attention
versions.

Greedy verification is compared bit for bit with the reference's. Sampled
columns are held against a per-column oracle of the port's own sampler:
randomness does not cross the packages (the port's noise is counter-based,
``sampling.request_uniforms``), so no sampled token is compared with JAX.
``tests/test_torch_speculative.py`` holds the engine.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strategies import given, settings, st

from repro.serve import kv_pool as RK
from repro.serve import sampling as RSa
from repro.serve import scheduler as RS
from repro_torch.kernels import ref as kref
from repro_torch.serve import kv_pool as PK
from repro_torch.serve import sampling as PSa
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)


def _greedy_window(rng, b: int, k: int, v: int, accept: np.ndarray):
    """Logits [B, k+1, V] with distinct maxima and drafts [k, B] that match
    each column's argmax for the first ``accept[b]`` columns of row b."""
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    top = logits.argmax(-1)                                     # [B, k+1]
    drafts = np.zeros((k, b), np.int32)
    for r in range(b):
        for i in range(k):
            drafts[i, r] = (top[r, i] if i < accept[r]
                            else (top[r, i] + 1 + rng.integers(v - 1)) % v)
    return logits, drafts


@pytest.mark.parametrize("k", [0, 1, 3, 4])
def test_greedy_verify_matches_reference(k):
    """``target`` and ``n_acc`` equal the reference's on the same greedy
    logits, drafts and counters, every acceptance depth included."""
    rng = np.random.default_rng(k)
    b, v = 6, 97
    accept = np.array([0, k, k // 2, 1, k, 0])[:b].clip(0, k)
    logits, drafts = _greedy_window(rng, b, k, v, accept)
    counts = rng.integers(0, 5, b)
    gfirst = counts + k + 1                  # every column greedy
    temp, topk, topp = (np.full(b, 0.8, np.float32), np.zeros(b, np.int32),
                        np.ones(b, np.float32))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b))
    rt, rn = RSa.speculative_verify(
        keys, jnp.asarray(logits), jnp.asarray(drafts),
        jnp.asarray(counts, jnp.int32), jnp.asarray(temp),
        jnp.asarray(topk), jnp.asarray(topp), jnp.asarray(gfirst, jnp.int32))
    pt, pn = PSa.speculative_verify(
        torch.as_tensor(logits), torch.as_tensor(drafts, dtype=torch.int64),
        np.arange(b), counts, gfirst, temp, topk, topp)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(pn.numpy(), accept)


def test_sampled_columns_match_a_per_column_oracle():
    """Column ``i`` of a sampled window is the port's own batched sampler
    at token count ``count + i`` (its noise from ``request_uniforms(seed,
    count + i)``), with ``greedy_first`` expiring inside the window and a
    temperature-0 row; the accepted prefix is the cumulative product of
    matches."""
    rng = np.random.default_rng(7)
    b, k, v = 5, 4, 61
    logits = torch.as_tensor(rng.standard_normal((b, k + 1, v)),
                             dtype=torch.float32)
    seeds = np.array([3, 9, 27, 81, 243])
    counts = np.array([0, 2, 5, 1, 3])
    gfirst = np.array([2, 0, 9, 4, 0])
    temp = np.array([0.9, 1.1, 0.7, 0.0, 1.3], np.float32)
    topk = np.array([13, 0, 5, 0, 0])
    topp = np.array([1.0, 0.9, 1.0, 1.0, 0.8], np.float32)
    cols = []
    for i in range(k + 1):
        cnt = counts + i
        greedy = (cnt < gfirst) | (temp <= 0)
        u = torch.full((b, v), 0.5)
        noisy = np.flatnonzero(~greedy)
        u[noisy] = PSa.request_uniforms(seeds[noisy], cnt[noisy], v, "cpu")
        cols.append(PSa.sample_logits_batched(
            logits[:, i], torch.as_tensor(temp), torch.as_tensor(topk),
            torch.as_tensor(topp), torch.as_tensor(greedy), u))
    oracle = torch.stack(cols)
    # rows 0-2 accept all, 3 the first two, 4 none
    drafts = oracle[:-1].clone()
    drafts[2, 3] = (drafts[2, 3] + 1) % v
    drafts[0, 4] = (drafts[0, 4] + 1) % v
    target, n_acc = PSa.speculative_verify(logits, drafts, seeds, counts,
                                           gfirst, temp, topk, topp)
    torch.testing.assert_close(target, oracle, rtol=0, atol=0)
    np.testing.assert_array_equal(n_acc.numpy(), [4, 4, 4, 2, 0])
    # with no row filtering, the filters' fast paths change no draw
    off = dict(top_k=np.zeros(b), top_p=np.ones(b, np.float32))
    fast, _ = PSa.speculative_verify(logits, drafts, seeds, counts, gfirst,
                                     temp, **off, use_top_k=False,
                                     use_top_p=False)
    full, _ = PSa.speculative_verify(logits, drafts, seeds, counts, gfirst,
                                     temp, **off)
    torch.testing.assert_close(fast, full, rtol=0, atol=0)


def test_empty_window_is_one_decode_draw():
    """``k = 0``: the window is the last token alone; ``target`` [1, B] is
    the non-speculative draw and nothing is accepted (reference
    ``tests/test_sampling.py``'s empty window)."""
    rng = np.random.default_rng(1)
    b, v = 3, 33
    logits = torch.as_tensor(rng.standard_normal((b, 1, v)),
                             dtype=torch.float32)
    target, n_acc = PSa.speculative_verify(
        logits, torch.zeros((0, b), dtype=torch.int64), np.arange(b),
        np.zeros(b), np.full(b, 1), np.ones(b, np.float32), np.zeros(b),
        np.ones(b, np.float32))
    assert tuple(target.shape) == (1, b)
    np.testing.assert_array_equal(target[0].numpy(),
                                  logits[:, 0].argmax(-1).numpy())
    np.testing.assert_array_equal(n_acc.numpy(), np.zeros(b))


@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_matches_reference(seed):
    """Prompt-lookup proposals equal the reference's on random contexts,
    repetitive ones (where lookup hits), empty and one-token contexts."""
    rng = np.random.default_rng(seed)
    ctxs = [np.zeros(0, np.int32), np.array([5], np.int32)]
    for _ in range(40):
        n = int(rng.integers(2, 30))
        vocab = int(rng.integers(2, 12))
        ctx = rng.integers(0, vocab, n).astype(np.int32)
        if rng.random() < 0.5:
            ctx = np.tile(ctx[:int(rng.integers(1, 6))], 6)[:n]
        ctxs.append(ctx)
    for ctx in ctxs:
        for k in (1, 2, 4, 7):
            for max_n in (1, 3):
                np.testing.assert_array_equal(
                    PS._ngram_propose(ctx, k, max_n),
                    RS._ngram_propose(ctx, k, max_n))


def test_spec_k_matches_reference():
    """The window's size, ``draft_k`` clipped to the smallest remaining
    budget less one (powers of two below ``draft_k``, 0 at one token
    left), equals the reference's on random slot mixes."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        draft_k = int(rng.integers(1, 9))
        rows = list(range(int(rng.integers(1, 5))))
        slots = []
        for _b in rows:
            max_new = int(rng.integers(1, 20))
            slots.append(types.SimpleNamespace(
                req=types.SimpleNamespace(max_new=max_new),
                count=int(rng.integers(0, max_new))))
        eng = types.SimpleNamespace(
            slots=slots, scfg=types.SimpleNamespace(draft_k=draft_k))
        got = PS.ServeEngine._spec_k(eng, rows)
        assert got == RS.ServeEngine._spec_k(eng, rows)
        assert 0 <= got <= draft_k


def _pools(**kw):
    return PK.KVPool(**kw), RK.KVPool(**kw)


def _both(pools, fn):
    """``fn`` on the port's pool and the reference's: equal results, or
    the same exception type from both."""
    out = []
    for pool, err in zip(pools, (PK.RewindError, RK.RewindError)):
        try:
            out.append(("ok", fn(pool)))
        except err:
            out.append(("rewind", None))
        except ValueError:
            out.append(("value", None))
    assert out[0] == out[1], out
    return out[0]


def test_rewind_floor_private_shared_and_frozen():
    """The contract's three cases on both pools: private blocks give 0, a
    shared or indexed full block freezes its span, a registered tail its
    fill; below the floor ``check_rewind`` raises ``RewindError``."""
    pools = _pools(num_blocks=8, block_size=4)
    toks = np.arange(8, dtype=np.int32)
    blocks = [p.alloc(1, 3) for p in pools]
    assert blocks[0] == blocks[1]
    blocks = blocks[0]
    assert _both(pools, lambda p: p.rewind_floor(1)) == ("ok", 0)
    keys = pools[0].prefix_keys(toks, 0)
    for p in pools:
        p.register(p.prefix_keys(toks, 0), blocks[:2])
    assert _both(pools, lambda p: p.rewind_floor(1)) == ("ok", 8)
    assert _both(pools, lambda p: p.check_rewind(1, 8)) == ("ok", None)
    assert _both(pools, lambda p: p.check_rewind(1, 7))[0] == "rewind"
    with pytest.raises(PK.RewindError, match="floor=8"):
        pools[0].check_rewind(1, 7)
    for p in pools:
        p.register_tail(keys[1], blocks[2], 3, np.arange(3, dtype=np.int32))
    assert _both(pools, lambda p: p.rewind_floor(1)) == ("ok", 11)
    assert _both(pools, lambda p: p.check_rewind(1, 10))[0] == "rewind"
    for p in pools:
        hit, _ = p.match_prefix(toks, 0)
        assert hit == blocks[:2]
        p.admit(2, hit, 1)
    assert _both(pools, lambda p: p.rewind_floor(2)) == ("ok", 8)
    assert _both(pools, lambda p: p.check_rewind(2, 4))[0] == "rewind"


def test_rewind_floor_unknown_uid_and_the_window():
    """An unknown uid is a ``ValueError``, not a floor of 0; inside the
    rewind window ``release`` refuses the window's uids (commit first),
    a second window may not open, and ``end_window`` is idempotent."""
    pools = _pools(num_blocks=6, block_size=4)
    assert _both(pools, lambda p: p.rewind_floor(9))[0] == "value"
    for p in pools:
        p.alloc(1, 2)
        p.alloc(2, 2)
    _both(pools, lambda p: p.begin_window([1]))
    assert _both(pools, lambda p: (p.in_window(1), p.in_window(2))) == (
        "ok", (True, False))
    assert _both(pools, lambda p: p.release(1))[0] == "value"
    assert _both(pools, lambda p: p.begin_window([2]))[0] == "value"
    _both(pools, lambda p: p.release(2))            # outside the window
    _both(pools, lambda p: p.end_window())
    _both(pools, lambda p: p.end_window())
    _both(pools, lambda p: p.release(1))
    assert _both(pools, lambda p: (p.num_free, p.num_live)) == ("ok", (6, 0))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_rewind_contract_under_pool_churn(seed):
    """The reference's churn property, on both pools in lockstep: random
    admissions (some sharing a live prompt's blocks), registrations,
    speculative cursor motion and releases give equal floors and equal
    raises; below every floor ``check_rewind`` raises; the pools conserve
    their blocks."""
    rng = np.random.default_rng(seed)
    total, bs = 24, 4
    pools = _pools(num_blocks=total, block_size=bs)
    live = {}
    next_uid = 0

    def invariants():
        for p in pools:
            assert p.num_free + p.num_cached + p.num_live == total
            assert sum(p._ref.values()) == sum(
                len(v) for v in p._owned.values())

    for _ in range(120):
        op = rng.random()
        if op < 0.5 and len(live) < 5:
            reuse = live and rng.random() < 0.4
            toks = (live[int(rng.choice(list(live)))][0] if reuse
                    else rng.integers(0, 64, int(rng.integers(4, 17)))
                    .astype(np.int32))
            hits = [p.match_prefix(toks, 0)[0] for p in pools]
            assert hits[0] == hits[1]
            hit = hits[0]
            need = pools[0].blocks_for(len(toks), 8) - len(hit)
            ok = _both(pools, lambda p: p.can_alloc(
                need, protect=frozenset(hit)))[1]
            if not ok:
                invariants()
                continue
            uid = next_uid
            next_uid += 1
            _both(pools, lambda p: p.admit(uid, hit, need))
            if rng.random() < 0.7:
                nfull = len(toks) // bs
                for p in pools:
                    p.register(p.prefix_keys(toks, 0)[len(hit):nfull],
                               p._owned[uid][len(hit):nfull])
            live[uid] = (toks, len(toks))
        elif op < 0.75 and live:
            uid = int(rng.choice(list(live)))
            toks, cur = live[uid]
            cur = min(cur + int(rng.integers(0, 6)),
                      len(pools[0]._owned[uid]) * bs)
            cur = max(cur - int(rng.integers(0, 4)), len(toks))
            assert _both(pools, lambda p: p.check_rewind(uid, cur))[0] == "ok"
            floor = _both(pools, lambda p: p.rewind_floor(uid))[1]
            for probe in range(0, cur + 1):
                want = "rewind" if probe < floor else "ok"
                assert _both(pools, lambda p: p.check_rewind(
                    uid, probe))[0] == want
            live[uid] = (toks, cur)
        elif live:
            uid = int(rng.choice(list(live)))
            del live[uid]
            _both(pools, lambda p: p.release(uid))
        invariants()
    for uid in list(live):
        _both(pools, lambda p: p.release(uid))
        invariants()
    assert all(p.num_live == 0 for p in pools)


def _seam_pool(rng, dtype: str, nq: int, nkv: int, hd: int, bs: int,
               nb: int):
    """A random pool (fp32, bf16 or int8 with scales), shuffled tables."""
    b = 3
    npool = 1 + b * nb
    kp = torch.as_tensor(rng.standard_normal((npool, bs, nkv, hd)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((npool, bs, nkv, hd)),
                         dtype=torch.float32)
    ks = vs = None
    if dtype == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    elif dtype == "i8":
        ks = torch.as_tensor(rng.uniform(0.005, 0.02, (npool, bs, nkv)),
                             dtype=torch.float32)
        vs = torch.as_tensor(rng.uniform(0.005, 0.02, (npool, bs, nkv)),
                             dtype=torch.float32)
        kp = torch.as_tensor(rng.integers(-127, 128, kp.shape),
                             dtype=torch.int8)
        vp = torch.as_tensor(rng.integers(-127, 128, vp.shape),
                             dtype=torch.int8)
    tbl = torch.as_tensor(1 + rng.permutation(b * nb).reshape(b, nb),
                          dtype=torch.int32)
    return kp, vp, ks, vs, tbl


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("heads", [(8, 2, 16), (8, 1, 16)])
def test_verify_seam_prefill_column_against_decode_steps(dtype, heads):
    """The verify seam of the plain versions: column ``i`` of
    ``paged_prefill_ref`` at odd cursors that cross a block boundary
    against ``paged_decode_ref`` at cursor ``pos + i`` (``i`` successive
    decode calls), GQA groups 4 and 8, three pool dtypes. Both run the
    same online softmax over the same blocks, but the prefill scores a
    ``[S, G]`` tile per block (``einsum`` over ``bnsgh``) where the decode
    scores ``[G]`` (over ``bngh``), and the CPU's matmul kernels may sum a
    dot product in another order at another shape; so the seam is held at
    1e-6 of the output scale (fp32 rounding of a 16-term dot and an online
    softmax over a few blocks) and the share of bitwise columns is
    reported by the assertion message only."""
    nq, nkv, hd = heads
    bs, nb = 4, 6
    rng = np.random.default_rng([("f32", "bf16", "i8").index(dtype), nkv])
    kp, vp, ks, vs, tbl = _seam_pool(rng, dtype, nq, nkv, hd, bs, nb)
    for s in (2, 3, 5):
        pos = torch.tensor([3, 7, 13], dtype=torch.int32)       # odd
        start = torch.tensor([0, 2, 1], dtype=torch.int32)
        q = torch.as_tensor(rng.standard_normal((3, s, nq, hd)),
                            dtype=torch.float32)
        pre = kref.paged_prefill_ref(q, kp, vp, tbl, pos, start, 0.25, ks,
                                     vs)
        bitwise = 0
        for i in range(s):
            dec = kref.paged_decode_ref(q[:, i], kp, vp, tbl, pos + i, start,
                                        0.25, ks, vs)
            err = (pre[:, i] - dec).abs().max().item()
            bitwise += torch.equal(pre[:, i], dec)
            assert err <= 1e-6 * (1 + dec.abs().max().item()), (
                f"S={s} column {i}: |prefill - decode| = {err:.3e} "
                f"({bitwise} of {i + 1} columns bitwise)")
