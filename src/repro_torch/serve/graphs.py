"""CUDA graphs of the continuous engine's steps.

The reference dispatches every step of its continuous engine as one
compiled program: the ``jax.jit`` decorators of ``serve/scheduler.py``
(``_step_jit`` over the ``_decode_scan`` decode block, ``_mixed_step_jit``,
``_draft_step_jit``, ``_spec_step_jit`` and ``_spec_verify_jit``), each
keyed by its ``static_argnames``. The reference has no module of this
name: this one is the counterpart of those decorators. A step body of
``serve.scheduler.ServeEngine`` is a function of the engine's static
buffers and cache leaves alone (no host read, no upload from host data, no
Python branch on device values, its outputs written into static buffers),
so one CUDA graph captured over it replays the step for any slot mix that
has the same key.

:class:`StepGraphs` captures each key at its first use and keeps it for the
engine's life. The first call runs the body eagerly on the engine's stream:
that is the step's own work, and it also builds the kernel libraries and
caches their launch plans. Then it records the body on a side stream that
waits on the engine's (capture is not allowed on the legacy default
stream), with ``capture_error_mode="thread_local"``, so that another
thread's CUDA calls cannot invalidate the capture. Every later call
replays the graph on the engine's stream. All graphs of one engine share
one memory pool. A capture or a replay that fails raises; nothing falls
back to eager execution.

CUDA refuses to destroy a graph while a stream of the capturing thread
captures, and the refusal invalidates the capture. A dead engine in a
reference cycle is freed by a cyclic collection, which may run inside a
capture (any allocation can start one). So a :class:`StepGraphs` that dies
while a capture is under way, in any thread, leaves its graphs to a
module-level list, and the last capture to end destroys them.

The kernels' ``launches`` counters are Python increments, which a replay
does not run. So a capture records the counters' deltas (and takes them
back: the capture launched nothing) and every replay adds them, and the
counters say what the card ran. :func:`counting` registers a caller's dict
of integer counts (a spy on a dispatch function, say) for the same
treatment while it is open.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

import torch

from repro_torch.kernels import (analog_matmul, int4_matmul, paged_attention,
                                 paged_prefill, ssd_scan)

#: the kernel modules whose ``launches`` counters a replay advances
KERNELS = (analog_matmul, int4_matmul, paged_attention, paged_prefill,
           ssd_scan)

#: the callers' count dicts open in :func:`counting`
_counting: list[dict] = []

#: captures under way in all threads, and the graphs of the StepGraphs that
#: died during one (destroyed when the last capture ends); reentrant, as a
#: collection that frees a StepGraphs can start while this thread holds it
_lock = threading.RLock()
_capturing = 0
_graveyard: list[dict] = []


def _retire(graphs: dict) -> None:
    """A dead StepGraphs' graphs: destroyed now, or after the last capture
    under way."""
    with _lock:
        if _capturing:
            _graveyard.append(graphs)
        else:
            graphs.clear()


@contextlib.contextmanager
def _capture_under_way():
    global _capturing
    with _lock:
        _capturing += 1
    try:
        yield
    finally:
        with _lock:
            _capturing -= 1
            if not _capturing:
                while _graveyard:
                    _graveyard.pop().clear()


@contextlib.contextmanager
def counting(counts: dict):
    """While the block runs, a capture records the changes to the integer
    values of ``counts`` and every replay of that graph adds them again."""
    _counting.append(counts)
    try:
        yield counts
    finally:
        _counting[:] = [d for d in _counting if d is not counts]


def _snapshot() -> tuple:
    return ([m.launches for m in KERNELS],
            [(d, dict(d)) for d in _counting])


def _take_back(snap: tuple) -> tuple:
    """Restore the counters of ``snap`` and return what changed since."""
    launches, dicts = snap
    k_delta = [m.launches - n for m, n in zip(KERNELS, launches)]
    for m, n in zip(KERNELS, launches):
        m.launches = n
    d_delta = []
    for d, before in dicts:
        changed = {k: v - before.get(k, 0) for k, v in d.items()
                   if v != before.get(k, 0)}
        d.clear()
        d.update(before)
        d_delta.append((d, changed))
    return k_delta, d_delta


def _add(deltas: tuple) -> None:
    k_delta, d_delta = deltas
    for m, n in zip(KERNELS, k_delta):
        m.launches += n
    for d, changed in d_delta:
        if any(d is c for c in _counting):
            for k, v in changed.items():
                d[k] = d.get(k, 0) + v


class StepGraphs:
    """The captured step graphs of one engine, keyed as the reference keys
    its jitted steps. ``captures``, ``replays`` and ``capture_s`` (host
    seconds spent capturing, the first eager run of each key excluded)
    are telemetry."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: dict[tuple, tuple] = {}
        weakref.finalize(self, _retire, self._graphs)
        self._pool = None
        self._side = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def keys(self) -> list[tuple]:
        """The captured keys, in capture order."""
        return list(self._graphs)

    def run(self, key: tuple, body, stream) -> None:
        """Replay ``key``'s graph on ``stream`` (the current stream), or at
        the key's first use run ``body`` eagerly and capture it."""
        entry = self._graphs.get(key)
        if entry is not None:
            entry[0].replay()
            _add(entry[1])
            self.replays += 1
            return
        body()
        self._capture(key, body, stream)

    def _capture(self, key: tuple, body, stream) -> None:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        snap = _snapshot()
        try:
            with _capture_under_way(), torch.cuda.graph(
                    graph, pool=self._pool, stream=self._side,
                    capture_error_mode="thread_local"):
                body()
        finally:
            deltas = _take_back(snap)
        stream.wait_stream(self._side)
        self._graphs[key] = (graph, deltas)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
