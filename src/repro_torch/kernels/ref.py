"""Plain PyTorch versions of the hand-written kernels in this package.

Each function computes what its CUDA kernel computes, in the reference's
op order, and is what a kernel wrapper runs for a tensor on the CPU. On the
card ``chip_smoke.py`` holds every kernel against these functions.

Quantizers are reciprocal-free: ``round(v * (q / range))``, never
``round(v / (range / q))``. PyTorch evaluates ``python_scalar / tensor`` as
``tensor.reciprocal() * scalar`` (and, on CUDA, ``tensor / python_scalar``
as a multiply by the scalar's reciprocal), which moves values that sit on a
rounding boundary. On the RTN lattice those values are systematic, so every
scalar division here goes through :func:`rdiv` / :func:`div`, which are true
IEEE divisions of two tensors on every device.
"""

from __future__ import annotations

import contextvars

import torch


def qmax(bits: int) -> float:
    """Largest positive level of a symmetric ``bits``-bit quantizer."""
    return float(2 ** (bits - 1) - 1)


def rdiv(q: float, t: torch.Tensor) -> torch.Tensor:
    """``q / t`` as an IEEE division (not ``t.reciprocal() * q``)."""
    return torch.div(torch.full_like(t, q), t)


def div(t: torch.Tensor, q: float) -> torch.Tensor:
    """``t / q`` as an IEEE division (not ``t * (1 / q)``)."""
    return torch.div(t, torch.full_like(t, q))


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip`` with tensor bounds: ``min(max(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


# Deterministic ADC tie-break, shared by every implementation of eq. (2)
# (``core.quant.output_quantize``, this file, the CUDA kernel's epilogue).
# RTN-lattice arithmetic puts accumulator values exactly on round-half
# boundaries, where a 1-ulp accumulation-order difference flips a whole ADC
# level. Scaling the rounding operand by (1 - 2^-16) moves the decision
# boundary strictly between lattice points, so implementations agree while
# their accumulations differ by much less than 2^-16 relative.
ADC_TIE_BREAK = 1.0 - 2.0 ** -16


def round_up(v: int, mult: int) -> int:
    """Round ``v`` up to a multiple of ``mult``."""
    return ((v + mult - 1) // mult) * mult


def adc_bound(w_eff: torch.Tensor, beta: torch.Tensor,
              lam: float) -> torch.Tensor:
    """Per-column ADC bound of eq. (2): ``lam * beta * max|W[:, i]|`` [N],
    or [E, N] for batched experts ``[E, K, N]`` (each over its own K)."""
    return lam * beta.float() * abs_max(w_eff.float(), -2)


def abs_max(w: torch.Tensor, dim: int, keepdim: bool = False
            ) -> torch.Tensor:
    """``amax(|w|, dim)`` without the ``|w|`` temporary (a whole leaf of
    expert weights): ``|max(amax(w), -amin(w))|``, the same value (the
    outer ``abs`` only clears the sign of a zero)."""
    return torch.abs(torch.maximum(torch.amax(w, dim=dim, keepdim=keepdim),
                                   -torch.amin(w, dim=dim, keepdim=keepdim)))


def check_one_bound(bound: torch.Tensor | None, lam: float | None) -> None:
    """Raise unless exactly one of an explicit ADC ``bound`` and the
    ``lam`` that folds it from the weights is given."""
    if (bound is None) == (lam is None):
        raise ValueError("give exactly one of bound (the ADC bound) and lam "
                         "(fold lam * beta * max|w| from the weights)")


#: ``(experts, columns, first expert, first column)`` of the whole site a
#: tensor-parallel shard's product belongs to, or None
#: (``kernels.dispatch.whole_site`` sets it)
WHOLE_SITE: contextvars.ContextVar = contextvars.ContextVar(
    "whole_site", default=None)


def site_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)``; for a tensor-parallel shard on the CPU
    (inside ``dispatch.whole_site``), computed at its whole site's shape.

    A BLAS product picks its blocking, and so each output's order of
    summation over K, from the product's shape and the thread count: the
    columns of a shard's narrower product need not equal the whole
    product's (at 4 threads an ``[8, 2048] @ [2048, 1024]`` column half
    does not). Here the shard's columns (or experts: ``x`` [e, M, K],
    ``w`` [e, K, N]) are placed at their offsets in zeros of the whole
    site's shape, the whole-shaped product is run, and the shard's part
    is taken: every output is then the whole product's bit for bit, at
    any thread count. On the card the products are the caller's (a shard
    launch runs its whole site's plan; cuBLAS picks by shape)."""
    site = WHOLE_SITE.get()
    if site is None or x.device.type != "cpu":
        return torch.matmul(x, w)
    e, n, e0, c0 = site
    if w.dim() == 3 and w.shape[0] < e:
        es = w.shape[0]
        xp = x.new_zeros((e,) + tuple(x.shape[1:]))
        wp = w.new_zeros((e,) + tuple(w.shape[1:]))
        xp[e0:e0 + es] = x
        wp[e0:e0 + es] = w
        return torch.matmul(xp, wp)[e0:e0 + es]
    ns = w.shape[-1]
    if ns < n:
        wp = w.new_zeros(tuple(w.shape[:-1]) + (n,))
        wp[..., c0:c0 + ns] = w
        return torch.matmul(x, wp)[..., c0:c0 + ns]
    return torch.matmul(x, w)


def analog_matmul_ref(x: torch.Tensor, w_eff: torch.Tensor,
                      beta: torch.Tensor, bound: torch.Tensor | None = None,
                      col_off: torch.Tensor | None = None, *,
                      lam: float | None = None, in_bits: int = 8,
                      out_bits: int = 8) -> torch.Tensor:
    """Plain version of the fused analog MVM.

    x [M, K], w_eff [K, N] (already noise-perturbed), beta scalar static
    input range (eq. 1), bound [N] per-column ADC bound (eq. 2), or None
    with ``lam`` for :func:`adc_bound` of ``w_eff`` (exactly one of the
    two), col_off [N] optional per-column offset added before the ADC.
    Returns [M, N] in ``x.dtype``. Batched experts: x [E, M, K], w_eff
    [E, K, N], bound and col_off [E, N], one shared beta; each expert is
    the 2-D function on its own slices (the reference's vmap).
    """
    check_one_bound(bound, lam)
    if bound is None:
        bound = adc_bound(w_eff, beta, lam)
    xf = x.float()
    qi = qmax(in_bits)
    beta = torch.clamp_min(beta.float(), 1e-8)
    x_q = div(beta, qi) * torch.round(clip(xf, -beta, beta) * rdiv(qi, beta))

    y = site_matmul(x_q, w_eff.float())
    if col_off is not None:
        y = y + col_off.float()[..., None, :]

    qo = qmax(out_bits)
    b = torch.clamp_min(bound.float(), 1e-8)[..., None, :]
    inv = rdiv(qo, b) * ADC_TIE_BREAK
    y_q = clip(div(b, qo) * torch.round(y * inv), -b, b)
    return y_q.to(x.dtype)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """[..., K, N//2] uint8 → [..., K, N] int32 in [-8, 7] (low nibble =
    column 2j)."""
    lo = (w_packed & 0x0F).to(torch.int32) - 8
    hi = (w_packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *w_packed.shape[:-1], -1)


def int4_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed-int4 matmul: ``x @ ((nib - 8) * scale)``.

    w_packed [K, N//2] uint8 holds column 2j in the low nibble and 2j+1 in
    the high nibble, each storing ``int4 + 8``; scale [N] per-column.
    Batched experts: x [E, M, K], w_packed [E, K, N//2], scale [E, N].
    """
    w = unpack_int4(w_packed).float() * scale.float()[..., None, :]
    return site_matmul(x.float(), w).to(x.dtype)


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """Pack int4 values in an int8 carrier ([..., K, N], N even) to
    [..., K, N//2]."""
    u = (w_int.to(torch.int32) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


# ---------------------------------------------------------------------------
# paged attention over the block pool (decode and prefill)
# ---------------------------------------------------------------------------

def _load_block(pool: torch.Tensor, scale: torch.Tensor | None,
                phys: torch.Tensor) -> torch.Tensor:
    """Physical blocks ``phys`` [B] of a ``[P, bs, KV, hd]`` pool as fp32,
    dequantized right after the load when ``scale`` [P, bs, KV] is given."""
    blk = pool[phys].float()                               # [B, bs, KV, hd]
    if scale is not None:
        blk = blk * scale[phys].float()[..., None]
    return blk


def _online_softmax_step(carry, logits, valid, v_blk, live, pv_eq: str):
    """One block of the flash loop. ``logits`` [..., bs] with ``valid``
    broadcastable to it; ``live`` [B] keeps the carry of a row whose block
    is dead unchanged (the kernel skips such blocks)."""
    m, l, acc = carry
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(valid, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(pv_eq, p, v_blk)
    shape = (-1,) + (1,) * (m.dim() - 1)
    lv = live.reshape(shape)
    return (torch.where(lv, m_new, m), torch.where(lv, l_new, l),
            torch.where(lv[..., None], acc_new, acc))


def merge_splits(o_part: torch.Tensor, m_part: torch.Tensor,
                 l_part: torch.Tensor) -> torch.Tensor:
    """Second pass of the split-K flash decode: combine per-split partials.

    o_part [B, NS, H, hd] unnormalized accumulators, m_part / l_part
    [B, NS, H] running max and sum of exponentials. Dead splits carry
    ``m = -inf, l = 0, acc = 0`` and drop out through ``exp(-inf - M) = 0``.
    """
    m_tot = torch.amax(m_part, dim=1)                      # [B, H]
    w = torch.exp(m_part - m_tot[:, None])                 # [B, NS, H]
    l_tot = torch.sum(l_part * w, dim=1)
    o = torch.sum(o_part * w[..., None], dim=1)
    return o / torch.clamp_min(l_tot, 1e-30)[..., None]


def paged_decode_partials(q, kp, vp, tbl, pos, start, scale: float,
                          k_scale=None, v_scale=None, num_splits: int = 1):
    """Per-split flash-decode partials ``(acc [B, NS, H, hd], m, l
    [B, NS, H])`` in fp32; split ``s`` covers logical blocks
    ``[s * nbs, (s + 1) * nbs)`` with ``nbs = ceil(NB / num_splits)``."""
    bsz, nq, hd = q.shape
    nb = tbl.shape[1]
    bs, nkv = kp.shape[1], kp.shape[2]
    group = nq // nkv
    nbs = -(-nb // num_splits)
    qg = q.reshape(bsz, nkv, group, hd).float()
    pos, start, tbl = pos.long(), start.long(), tbl.long()
    first, last = start // bs, pos // bs
    ar = torch.arange(bs, device=q.device)
    parts = []
    for s in range(num_splits):
        carry = (torch.full((bsz, nkv, group), -float("inf"),
                            device=q.device),
                 torch.zeros((bsz, nkv, group), device=q.device),
                 torch.zeros((bsz, nkv, group, hd), device=q.device))
        for j in range(s * nbs, min((s + 1) * nbs, nb)):
            phys = tbl[:, j]
            k_blk = _load_block(kp, k_scale, phys)
            v_blk = _load_block(vp, v_scale, phys)
            jpos = j * bs + ar
            valid = ((jpos[None] >= start[:, None])
                     & (jpos[None] <= pos[:, None]))[:, None, None, :]
            logits = torch.einsum("bngh,bsnh->bngs", qg, k_blk) * scale
            live = (j >= first) & (j <= last)
            carry = _online_softmax_step(carry, logits, valid, v_blk, live,
                                         "bngs,bsnh->bngh")
        parts.append(carry)
    m, l, acc = (torch.stack([p[i] for p in parts], dim=1) for i in range(3))
    return (acc.reshape(bsz, num_splits, nq, hd),
            m.reshape(bsz, num_splits, nq), l.reshape(bsz, num_splits, nq))


def paged_decode_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                     tbl: torch.Tensor, pos: torch.Tensor,
                     start: torch.Tensor, scale: float,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     num_splits: int = 1) -> torch.Tensor:
    """Plain version of the paged flash-decode kernel.

    One GQA decode step per row against the block pool, with the online
    softmax block loop of the kernel:

    q        [B, H, hd]       current-token queries (H = KV * group)
    kp, vp   [P, bs, KV, hd]  physical pool (fp32, bf16, or int8 + scales)
    tbl      [B, NB]          per-slot block table (logical → physical)
    pos      [B]              logical index of the current token
    start    [B]              first valid logical index (left-pad count)
    k_scale, v_scale [P, bs, KV]  dequant scales of the int8 pool

    Row ``b`` attends ``start[b] <= j <= pos[b]``; blocks outside
    ``start // bs … pos // bs`` leave the row's carry untouched. With
    ``num_splits > 1`` the block loop is cut into independent partials
    merged by :func:`merge_splits`, as the kernel does. Returns
    [B, H, hd] in ``q.dtype``.
    """
    acc, m, l = paged_decode_partials(q, kp, vp, tbl, pos, start, scale,
                                      k_scale, v_scale, num_splits)
    if num_splits == 1:
        out = acc[:, 0] / torch.clamp_min(l[:, 0], 1e-30)[..., None]
    else:
        out = merge_splits(acc, m, l)
    return out.to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      tbl: torch.Tensor, pos: torch.Tensor,
                      start: torch.Tensor, scale: float,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the paged flash-prefill kernel.

    One query chunk ``q`` [B, S, H, hd] per row, scored in place against
    the pool; column ``i`` of row ``b`` sits at logical position
    ``pos[b] + i`` (``pos`` is the pre-chunk write cursor; the chunk's own
    K/V are already in the pool) and attends ``start[b] <= j <= pos[b] + i``.
    Blocks outside ``start // bs … (pos + S - 1) // bs`` are skipped.
    Returns [B, S, H, hd] in ``q.dtype``.
    """
    bsz, s, nq, hd = q.shape
    nb = tbl.shape[1]
    bs, nkv = kp.shape[1], kp.shape[2]
    group = nq // nkv
    qg = q.reshape(bsz, s, nkv, group, hd).permute(0, 2, 1, 3, 4).float()
    pos, start, tbl = pos.long(), start.long(), tbl.long()
    first, last = start // bs, (pos + s - 1) // bs
    ar = torch.arange(bs, device=q.device)
    qpos = pos[:, None] + torch.arange(s, device=q.device)[None]   # [B, S]
    carry = (torch.full((bsz, nkv, s, group), -float("inf"),
                        device=q.device),
             torch.zeros((bsz, nkv, s, group), device=q.device),
             torch.zeros((bsz, nkv, s, group, hd), device=q.device))
    for j in range(nb):
        phys = tbl[:, j]
        k_blk = _load_block(kp, k_scale, phys)
        v_blk = _load_block(vp, v_scale, phys)
        jpos = j * bs + ar
        valid = ((jpos[None, None] >= start[:, None, None])
                 & (jpos[None, None] <= qpos[..., None]))    # [B, S, bs]
        logits = torch.einsum("bnsgh,btnh->bnsgt", qg, k_blk) * scale
        live = (j >= first) & (j <= last)
        carry = _online_softmax_step(carry, logits, valid[:, None, :, None],
                                     v_blk, live, "bnsgt,btnh->bnsgh")
    _, l, acc = carry
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(bsz, s, nq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) scan
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            h0: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential Mamba-2 SSD recurrence (the slow-but-sure oracle).

    x [BH, S, P], dt [BH, S] (positive), a [BH] (negative), b / c
    [BH, S, N] (already broadcast from groups to heads), h0 [BH, N, P]
    optional initial state. Per step ``h = exp(dt·a)·h + (dt·b)ᵀ x`` and
    ``y = c·h``. Returns y [BH, S, P] in ``x.dtype``.
    """
    bh, s, p = x.shape
    n = b.shape[-1]
    h = (torch.zeros((bh, n, p), device=x.device) if h0 is None
         else h0.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)
        h = (decay[:, None, None] * h
             + (dtf[:, t, None] * bf[:, t])[:, :, None] * xf[:, t, None, :])
        ys.append(torch.einsum("zn,znp->zp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    chunk: int = 128) -> torch.Tensor:
    """Chunk-parallel SSD, the math of the JAX package's Pallas kernel
    (``kernels/ops.py::ssd_chunked_jnp``), from a zero state.

    Shapes as :func:`ssd_ref`. A ragged tail is padded with ``dt = 0,
    x = b = c = 0``. Within a chunk of length L the output is
    ``(C Bᵀ ⊙ exp(min(cums_t - cums_r, 0)) ⊙ [r <= t]) (dt ⊙ X)`` plus the
    carried state's ``exp(cums_t) C_t h_in``; the clamp before ``exp``
    keeps the masked (positive) entries from overflowing to inf, which
    times the mask's 0 would be NaN. Returns y [BH, S, P] in ``x.dtype``.
    """
    bh, s, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    sc = x.shape[1] // chunk
    xf = x.reshape(bh, sc, chunk, p).float()
    dtf = dt.reshape(bh, sc, chunk).float()
    bf = b.reshape(bh, sc, chunk, n).float()
    cf = c.reshape(bh, sc, chunk, n).float()

    la = dtf * a[:, None, None]
    cums = torch.cumsum(la, dim=-1)                        # [bh, sc, L]
    rel = cums[..., :, None] - cums[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), device=x.device))
    decay = torch.exp(torch.clamp_max(rel, 0.0)) * mask
    gates = torch.einsum("zctn,zcrn->zctr", cf, bf)
    y_intra = torch.einsum("zctr,zcrp->zctp", gates * decay,
                           dtf[..., None] * xf)

    # the inter-chunk state recurrence, one chunk after the other
    total = cums[..., -1]                                  # [bh, sc]
    w_r = torch.exp(total[..., None] - cums) * dtf         # [bh, sc, L]
    states = torch.einsum("zcrn,zcrp->zcnp", bf * w_r[..., None], xf)
    h = torch.zeros((bh, n, p), device=x.device)
    h_ins = []
    for j in range(sc):
        h_ins.append(h)                                    # entering chunk j
        h = torch.exp(total[:, j])[:, None, None] * h + states[:, j]
    h_in = torch.stack(h_ins, dim=1)
    y_inter = torch.exp(cums)[..., None] * torch.einsum(
        "zctn,zcnp->zctp", cf, h_in)
    y = (y_intra + y_inter).reshape(bh, sc * chunk, p)
    return y[:, :s].to(x.dtype)


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    a: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor):
    """One token of the SSD recurrence (serving decode): h [BH, N, P],
    x_t [BH, P], dt_t [BH], a [BH], b_t / c_t [BH, N] → (h', y [BH, P]).
    Plain tensor code in the JAX package too (no kernel). Mixed dtypes
    promote as ``jnp.einsum``'s do (a bf16 gate against the fp32 state
    contracts in fp32)."""
    decay = torch.exp(dt_t * a)
    h = (decay[:, None, None] * h
         + (dt_t[:, None] * b_t)[:, :, None] * x_t[:, None, :])
    dtype = torch.promote_types(c_t.dtype, h.dtype)
    y = torch.einsum("zn,znp->zp", c_t.to(dtype), h.to(dtype))
    return h, y.to(x_t.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor | None = None, *, chunk: int = 128):
    """Plain version of the ``ssd_scan`` kernel: the whole of the JAX
    package's ``mamba2._ssd_with_state`` in its op order.

    x [B, S, H, P], dt [B, S, H], a [H], b / c [B, S, G, N] (head ``h``
    reads group ``h // (H / G)``), h0 [B·H, N, P] optional incoming state.
    The groups are repeated to heads and ``(B, H)`` flattened (``ops.ssd``),
    y comes from :func:`ssd_chunked_ref` from a zero state, and the final
    state and the incoming state's terms (``exp(cums_t) C_t h0`` in y,
    ``exp(total) h0`` in the state) are added after it, over the whole
    sequence. Returns (y [B, S, H, P] fp32, final state [B·H, N, P] fp32).
    """
    bsz, s, heads, pdim = x.shape
    g = b.shape[2]
    rep = heads // g

    def to_bh(t):
        return torch.movedim(torch.repeat_interleave(t, rep, dim=2), 2, 1
                             ).reshape(bsz * heads, s, -1)

    xf = torch.movedim(x, 2, 1).reshape(bsz * heads, s, pdim)
    dtf = torch.movedim(dt, 2, 1).reshape(bsz * heads, s)
    af = a.repeat(bsz)
    bf, cf = to_bh(b), to_bh(c)
    # the JAX package's CPU chunk: ``chunk`` when it divides S, else
    # min(chunk, S) with a padded tail
    y = ssd_chunked_ref(xf, dtf, af, bf, cf,
                        chunk=min(chunk, s) if s % chunk else chunk)
    y = torch.movedim(y.reshape(bsz, heads, s, pdim), 1, 2).float()

    xf, dtf, bf = xf.float(), dtf.float(), bf.float()
    la = dtf * af[:, None]
    cums = torch.cumsum(la, dim=-1)
    total = cums[:, -1]
    w_r = torch.exp(total[:, None] - cums) * dtf               # [BH, S]
    h = torch.einsum("zs,zsn,zsp->znp", w_r, bf, xf)
    if h0 is not None:
        h0 = h0.float()
        y_carry = torch.einsum("zs,zsn,znp->zsp", torch.exp(cums),
                               cf.float(), h0)
        y = y + torch.movedim(y_carry.reshape(bsz, heads, s, pdim), 1, 2)
        h = h + torch.exp(total)[:, None, None] * h0
    return y, h
