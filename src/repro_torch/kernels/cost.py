"""The work of each hand-written kernel, by shape, and how a wrapper
reports a call to a cost counter.

One formula per kernel, in FLOPs and bytes: the cost counter
(``launch.cost_analysis``) counts each wrapper call by it, and
``chip_smoke.py`` feeds the same numbers to each kernel's bound, so the
two cannot drift apart. Bytes count each input read once and each output
written once. FLOPs follow the function, not a kernel's tiling:

* ``analog_matmul`` / ``int4_matmul``: ``2 · E · M · K · N``.
* ``paged_flash_decode`` / ``paged_flash_prefill``: ``4 · hd`` per query
  head and (query column, key) pair scored, the ``q·k`` and ``p·v``
  products. Two counts: the table's capacity (every key of every block of
  every row's table, for every column), as the JAX package's masked jnp
  version computes it and XLA counts it, and the attended work, the keys
  the cursors reach, which is what the kernel does (it skips the blocks
  past each row's cursor). A wrapper call reports the capacity always and
  the attended work where it can read the cursors without a device sync
  (CPU tensors); on the card and on the meta device a caller that knows
  the cursors on the host passes them to :func:`paged_work`. A share of
  the card's peak divides the attended count, never the capacity, which
  at a long ``max_len`` with short contexts is many times the work.
* ``ssd_scan``: two counts. The counter's (:func:`ssd_scan`) is the dot
  products of the JAX package's chunked jnp path
  (``kernels/ops.py::ssd_chunked_jnp`` under ``models/mamba2.py::
  _ssd_with_state``), at its chunk ``min(128, S)``, whatever chunk the
  kernel runs: the intra-chunk ``C Bᵀ`` and its product with ``dt · x``,
  the chunk states and the inter-chunk term (which vanishes, as XLA
  drops it, when one chunk holds the sequence), the final state, and the
  incoming state's term; it matches XLA's count. The bound's
  (:func:`ssd_scan_least`) is the least work of the function, the
  recurrence's ``C h`` and state update, 2 N P FMAs per token and head,
  with the same bytes.

A wrapper runs its call through :func:`counted`: every active counter
takes the call's work and sees none of the torch ops inside it (the plain
version on the CPU, the allocations of the launch on the card, the empty
result on the meta device), so one call counts the same on every device.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

#: fp32 bytes
F32 = 4


def analog_matmul(e: int, m: int, k: int, n: int, *, bound: bool,
                  col_off: bool) -> tuple[float, int]:
    """``(flops, bytes)`` of an ``analog_matmul`` call of ``e`` experts'
    [M, K] @ [K, N] (``e = 1`` for a 2-D call): x, w_eff and β read, the
    explicit bound and ``col_off`` where given, the output written."""
    nbytes = F32 * (e * m * k + e * k * n + 1 + (e * n if bound else 0)
                    + (e * n if col_off else 0) + e * m * n)
    return 2.0 * e * m * k * n, nbytes


def int4_matmul(e: int, m: int, k: int, n: int) -> tuple[float, int]:
    """``(flops, bytes)`` of an ``int4_matmul`` call: x fp32, the packed
    weights at half a byte each, the scales, the fp32 output."""
    nbytes = F32 * e * m * k + e * k * n // 2 + F32 * e * n + F32 * e * m * n
    return 2.0 * e * m * k * n, nbytes


def paged_attention(rows: int, cols: int, nq: int, nkv: int, hd: int,
                    kv_elem: int, quantized: bool, nb: int, bs: int,
                    live: list[int] | None = None) -> tuple[float, int]:
    """``(flops, bytes)`` of a paged attention call of ``rows`` rows of
    ``cols`` query columns (1 for decode) of ``nq`` heads against ``nkv``
    kv heads of width ``hd``, through a table of ``nb`` blocks of ``bs``
    tokens per row. ``live``: each row's keys for its first column
    (``pos - start + 1``; column ``i`` attends ``i`` more), for the
    attended work; None: the table's capacity. Bytes: the K/V tokens read
    (with their int8 scales), q and the fp32 output, the table rows and
    the two cursors."""
    if live is None:
        kv_tokens = rows * nb * bs
        scored = kv_tokens * cols
    else:
        kv_tokens = sum(max(0, n + cols - 1) for n in live)
        scored = sum(max(0, n + i) for n in live for i in range(cols))
    kv_bytes = kv_tokens * nkv * (2 * hd * kv_elem
                                  + (2 * F32 if quantized else 0))
    q_elems = rows * cols * nq * hd
    nbytes = kv_bytes + 2 * F32 * q_elems + F32 * (rows * nb + 2 * rows)
    return 4.0 * hd * nq * scored, nbytes


def paged_work(q, kp, tbl, pos=None, start=None) -> tuple[float, int]:
    """:func:`paged_attention` of a call on q [B, H, hd] (decode) or
    [B, S, H, hd] (a chunk), the pool ``kp`` and the table ``tbl``: the
    capacity, or with the cursors ``pos`` / ``start`` (host values: CPU
    tensors, arrays or lists) the attended work."""
    cols = q.shape[1] if q.dim() == 4 else 1
    live = None
    if pos is not None:
        live = [int(p) - int(s) + 1 for p, s in zip(
            _host(pos), _host(start))]
    return paged_attention(q.shape[0], cols, q.shape[-2], kp.shape[2],
                           q.shape[-1], kp.element_size(),
                           kp.dtype == torch.int8, tbl.shape[1],
                           kp.shape[1], live)


def paged_attended(q, kp, tbl, pos, start):
    """The attended work of a wrapper call where its cursors lie on the
    CPU, else None (on the card they would need a sync, which a capture
    forbids; the meta device has no values)."""
    if pos.device.type != "cpu":
        return None
    return paged_work(q, kp, tbl, pos, start)


def _host(v) -> list:
    return v.tolist() if hasattr(v, "tolist") else list(v)


def ssd_scan(bsz: int, s: int, heads: int, pdim: int, n: int, g: int,
             h0: bool) -> tuple[float, int]:
    """``(flops, bytes)`` of an ``ssd_scan`` call on x [B, S, H, P], dt
    [B, S, H], a [H], b / c [B, S, G, N] and the optional state h0 [B·H,
    N, P]: the JAX package's chunked count (module docstring); bytes of
    each input once (b and c per group), y and the final state written."""
    bh = bsz * heads
    chunk = min(128, s) if s % 128 else 128
    s_pad = -(-s // chunk) * chunk
    inter = 2 if s_pad > chunk else 1
    flops = (2.0 * bh * s_pad * chunk * (n + pdim)
             + 2.0 * bh * s_pad * n * pdim * inter
             + 2.0 * bh * s * n * pdim * (2 if h0 else 1))
    state = bh * n * pdim
    in_elems = bsz * s * (heads * pdim + heads + 2 * g * n) + heads
    nbytes = F32 * (in_elems + (state if h0 else 0)
                    + bsz * s * heads * pdim + state)
    return flops, nbytes


def ssd_scan_least(bsz: int, s: int, heads: int, pdim: int, n: int, g: int,
                   h0: bool) -> tuple[float, int]:
    """``(flops, bytes)`` of the least work of an ``ssd_scan`` call, the
    bound's: the recurrence's ``C h`` and state update, 2 N P FMAs per
    token and head (a chunked form adds ``L (P + N G / H)``), two
    operations per FMA; the bytes of :func:`ssd_scan`."""
    return (2.0 * bsz * s * heads * 2 * n * pdim,
            ssd_scan(bsz, s, heads, pdim, n, g, h0)[1])


def _counters() -> list:
    """The cost counters on the current dispatch-mode stack (the stack
    follows autograd into its worker threads, so a backward's recompute
    finds them too)."""
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "count_kernel")]


def counted(name: str, work: Callable[[], tuple[float, int]],
            call: Callable[[], object], attended: Callable | None = None):
    """``call()`` as one call of kernel ``name``: each active counter
    takes ``work()`` (evaluated only when one is active), for a paged
    kernel ``attended()`` (its attended ``(flops, bytes)`` or None where
    the cursors cannot be read), and the storage of the result, and none
    of the ops ``call`` or ``attended`` run."""
    counters = _counters()
    if not counters:
        return call()
    flops, nbytes = work()
    for c in counters:
        c.hidden += 1
    try:
        out = call()
        att = attended() if attended is not None else False
    finally:
        for c in counters:
            c.hidden -= 1
    for c in counters:
        c.count_kernel(name, flops, nbytes, out, att)
    return out


def uncounted(call: Callable[[], object]):
    """``call()`` with every active counter blind to its ops (a backward's
    rebuild of a forward that a kernel call has counted already)."""
    counters = _counters()
    for c in counters:
        c.hidden += 1
    try:
        return call()
    finally:
        for c in counters:
            c.hidden -= 1


def collective(kind: str, nbytes: int) -> None:
    """Report one collective of ``kind`` moving ``nbytes`` (its output:
    the gathered result, or a reduce-scatter's slice) to every active
    counter."""
    for c in _counters():
        c.count_collective(kind, nbytes)
