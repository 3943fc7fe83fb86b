"""Async open-loop serving front end over the continuous-batching engine.

``ServeEngine`` (``serve.scheduler``) is a closed loop: callers submit,
then call ``step()`` until done. Open-loop traffic (requests arriving on
their own clock, clients that disconnect, queues that overflow) needs a
front end that keeps the card busy while the host talks to clients.
:class:`AsyncServeFrontend` is that layer, over three seams of the engine:

* **The split step.** ``step_begin`` dispatches the step's device work
  (CUDA launches return before the kernels finish) and ``step_commit``
  reads it back. Both halves run on one single-thread executor, so the
  engine is only ever called by one thread at a time; between them the
  event loop applies the commands clients sent meanwhile and serves its
  other tasks (the HTTP front door of ``launch.serve``).
* **Bounded admission with explicit shedding.** ``submit`` goes through
  ``ServeEngine.try_submit``: a request arriving at a full queue
  (``SchedulerConfig.max_queue``) raises :class:`ShedError` with the
  engine's reason at once; nothing is dropped silently and nothing hangs.
  Deadlines (``Request.ttft_deadline`` / ``deadline``) are enforced by
  the engine at step boundaries.
* **Step-boundary cancellation.** A cancel is applied by the engine, which
  defers one that arrives while a step is in flight to its commit (the
  cancel-vs-rewind ordering contract of ``serve.kv_pool``). The engine
  issues every device write on its own stream, whichever thread calls it.

A :class:`RequestHandle` is one request's view: ``stream()`` yields its
tokens as the engine emits them (fed from the engine's event log after
every commit) and ``result()`` awaits its terminal state, one of
``finished``, ``cancelled``, ``timed_out`` or ``errored``, with the full or
partial output and the engine's reason.

The standard library only (asyncio and one worker thread); the HTTP front
door lives in ``launch.serve`` (``--serve``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
from typing import AsyncIterator, Optional

import numpy as np

from repro_torch.serve.scheduler import Request, ServeEngine


class ShedError(RuntimeError):
    """Raised to a submitter whose request was shed at admission; carries
    the engine's reason (queue full, or a request that can never fit)."""


@dataclasses.dataclass
class RequestResult:
    """Terminal state of one request as the front end saw it.

    ``status`` is the engine's terminal status, ``tokens`` the full or
    partial output, ``reason`` the engine's reason for a terminal status
    other than ``finished``; ``ttft`` is the engine's first-token time
    from submission (None when no token was sampled) and ``latency`` the
    event loop's seconds from submission to the terminal state."""

    uid: int
    status: str
    tokens: np.ndarray
    reason: Optional[str] = None
    ttft: Optional[float] = None
    latency: float = 0.0


class RequestHandle:
    """The caller's view of one accepted request."""

    _DONE = object()                   # end of the token stream

    def __init__(self, uid: int, loop: asyncio.AbstractEventLoop):
        """Made by :meth:`AsyncServeFrontend.submit` only."""
        self.uid = uid
        self._tokens: asyncio.Queue = asyncio.Queue()
        self._result: asyncio.Future = loop.create_future()

    async def stream(self) -> AsyncIterator[int]:
        """Yield tokens as they are sampled; ends at the terminal state."""
        while True:
            t = await self._tokens.get()
            if t is RequestHandle._DONE:
                return
            yield t

    async def result(self) -> RequestResult:
        """Await the terminal state. A timeout, cancel or tolerated fault
        does not raise: ``status`` says which. It raises only what ended
        the serving loop (a fault the engine does not tolerate)."""
        return await self._result


class AsyncServeFrontend:
    """Open-loop asyncio front end driving one :class:`ServeEngine`.

    Usage::

        fe = AsyncServeFrontend(engine)
        await fe.start()
        h = await fe.submit(Request(uid=1, prompt=..., deadline=2.0))
        async for tok in h.stream(): ...
        res = await h.result()           # RequestResult
        await fe.stop()

    ``idle_sleep`` is the poll interval while the engine has no work;
    under load, the loop is driven by step completion.
    """

    def __init__(self, engine: ServeEngine, *, idle_sleep: float = 0.002):
        """Wrap ``engine``; call :meth:`start` before submitting."""
        self.engine = engine
        self.idle_sleep = idle_sleep
        self._handles: dict[int, RequestHandle] = {}
        self._submit_times: dict[int, float] = {}
        # the engine is not thread-safe: every engine step runs on this
        # one worker thread, and the loop below never overlaps two calls
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-engine")
        self._commands: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._error: Optional[BaseException] = None
        self.steps = 0

    async def start(self) -> None:
        """Start the serving loop task."""
        if self._task is not None:
            raise RuntimeError("frontend already started")
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        """Serve what is in flight to its end, then stop the loop task and
        the worker thread. An exception the loop raised (a fault the
        engine does not tolerate) is raised here."""
        self._stopping = True
        try:
            if self._task is not None:
                await self._task
        finally:
            self._task = None
            self._exec.shutdown(wait=True)

    def _check_alive(self) -> None:
        """Refuse a command once the serving loop has failed."""
        if self._error is not None:
            raise RuntimeError("the serving loop failed") from self._error

    async def submit(self, req: Request) -> RequestHandle:
        """Submit under admission control: a handle, or :class:`ShedError`
        with the engine's reason."""
        self._check_alive()
        loop = asyncio.get_running_loop()
        handle = RequestHandle(req.uid, loop)
        fut: asyncio.Future = loop.create_future()
        await self._commands.put(("submit", req, handle, fut))
        reason = await fut
        if reason is not None:
            raise ShedError(f"request {req.uid} shed: {reason}")
        return handle

    async def cancel(self, uid: int) -> bool:
        """Cancel ``uid``, applied by the engine at the next step boundary.
        True when the request was still live."""
        self._check_alive()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        await self._commands.put(("cancel", uid, None, fut))
        return await fut

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def _apply_commands(self) -> None:
        """Apply the queued client commands to the engine, on the event
        loop's thread while the worker is idle: a submit only touches the
        host queue, and a cancel of a slotted request is deferred by the
        engine while a step is in flight."""
        loop = asyncio.get_running_loop()
        while True:
            try:
                kind, arg, handle, fut = self._commands.get_nowait()
            except asyncio.QueueEmpty:
                return
            if kind == "submit":
                reason = self.engine.try_submit(arg)
                if reason is None:
                    self._handles[arg.uid] = handle
                    self._submit_times[arg.uid] = loop.time()
                fut.set_result(reason)
            else:                                  # cancel
                fut.set_result(self.engine.cancel(arg))

    def _pump_events(self) -> None:
        """Move the engine's stream events into the requests' queues and
        resolve each terminal one's result."""
        loop = asyncio.get_running_loop()
        eng = self.engine
        for kind, uid, payload in eng.drain_events():
            h = self._handles.get(uid)
            if h is None:
                continue
            if kind == "token":
                h._tokens.put_nowait(int(payload))
                continue
            born = self._submit_times.pop(uid, loop.time())
            first = eng.first_token_at.get(uid)
            sub = eng.submit_time.get(uid)
            ttft = (first - sub) if (first is not None
                                     and sub is not None) else None
            res = RequestResult(
                uid=uid, status=payload,
                tokens=eng.results.get(uid, np.zeros(0, np.int32)),
                reason=eng.errors.get(uid),
                ttft=ttft, latency=loop.time() - born)
            h._tokens.put_nowait(RequestHandle._DONE)
            if not h._result.done():
                h._result.set_result(res)
            del self._handles[uid]

    async def _loop(self) -> None:
        """Serve until :meth:`stop` (see :meth:`_serve`). An exception the
        engine raises ends the loop and is handed to every waiting caller,
        so that none waits forever, then raised from :meth:`stop`."""
        try:
            await self._serve()
        except BaseException as e:
            self._error = e
            for h in self._handles.values():
                h._tokens.put_nowait(RequestHandle._DONE)
                if not h._result.done():
                    h._result.set_exception(e)
            self._handles.clear()
            while not self._commands.empty():
                fut = self._commands.get_nowait()[3]
                if not fut.done():
                    fut.set_exception(e)
            raise

    async def _serve(self) -> None:
        """Dispatch on the worker, apply the commands that arrived while
        the step is in flight, commit on the worker, then stream its
        events."""
        loop = asyncio.get_running_loop()
        eng = self.engine
        while True:
            self._apply_commands()
            pending = await loop.run_in_executor(self._exec,
                                                 eng.step_begin)
            if pending is None:
                self._pump_events()    # deadline and shed terminals, faults
                if self._stopping and not self._handles:
                    return
                await asyncio.sleep(self.idle_sleep)
                continue
            # the step is in flight: submits join the queue (admitted at
            # the next step_begin), cancels of its slots are deferred
            self._apply_commands()
            await loop.run_in_executor(self._exec, eng.step_commit,
                                       pending)
            self.steps += 1
            self._pump_events()
