"""The port's async front end (``repro_torch.serve.frontend``) and the
launcher's open-loop modes (``repro_torch.launch.serve``), the
counterparts of ``tests/test_lifecycle.py``'s front-end tests.

* The front end streams each request's tokens equal to its result (equal
  to the engine's record, and at temperature 0 to the reference engine's),
  a cancel mid-stream ends a request with its partial output, an arrival
  at a full queue raises ``ShedError``; its outputs equal the closed-loop
  ``run``'s (the port's; at temperature 0 the reference's too); a fault
  the engine does not tolerate reaches every waiter instead of hanging.
* The launcher's ``--qps`` in poisson and burst modes with a bounded
  queue and both timeouts on ``--device cpu --reduced``: every arrival
  reaches one terminal status, streamed tokens equal the result; without
  a card the open-loop mode raises.
* The HTTP front door's handler driven in memory (an ``asyncio.StreamReader``
  and a writer stub): 200, 503 at a full queue, 400, 404 and ``/health``;
  and once over a loopback socket.
"""

import argparse
import asyncio
import json

import numpy as np
import pytest
import torch
from test_torch_lifecycle import _assert_conserved, _carried, _kw, _prompt

from repro.core import analog as RA
from repro.serve import scheduler as RS
from repro_torch.core import analog as PA
from repro_torch.launch import serve as port_serve
from repro_torch.serve import scheduler as PS
from repro_torch.serve.frontend import AsyncServeFrontend, ShedError

torch.set_num_threads(2)


def _engine(**kw):
    cfg, _, pp = _carried("granite-3-8b")
    return cfg, PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="off"),
                               PS.SchedulerConfig(**_kw(**kw)))


def _reqs(cfg, n, seed, temperature):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(3, 9))).astype(np.int32),
        max_new=int(rng.integers(2, 7)), temperature=temperature, top_k=50,
        seed=seed + i) for i in range(n)]


def _ref_run(reqs, **kw):
    """The reference engine's closed-loop results on the same weights."""
    cfg, rp, _ = _carried("granite-3-8b")
    return RS.ServeEngine(rp, cfg, RA.AnalogConfig(mode="off"),
                          RS.SchedulerConfig(**_kw(**kw))).run(
        [RS.Request(**r) for r in reqs])


def test_frontend_streams_cancels_and_sheds():
    cfg, eng = _engine(num_slots=1, max_queue=1)
    fe = AsyncServeFrontend(eng)
    a_req = dict(uid=0, prompt=_prompt(cfg, 4), max_new=6, temperature=0.0)

    async def scenario():
        await fe.start()
        a = await fe.submit(PS.Request(**a_req))
        b = await fe.submit(PS.Request(uid=1, prompt=_prompt(cfg, 5, seed=4),
                                       max_new=24, temperature=0.0))
        with pytest.raises(ShedError, match="queue full"):
            await fe.submit(PS.Request(uid=2, prompt=_prompt(cfg, 3, seed=5),
                                       max_new=2, temperature=0.0))
        streamed = [t async for t in a.stream()]
        res_a = await a.result()
        async for _ in b.stream():
            assert await fe.cancel(1)
            break
        res_b = await b.result()
        await fe.stop()
        return streamed, res_a, res_b

    streamed, res_a, res_b = asyncio.run(scenario())
    assert res_a.status == "finished" and res_a.ttft is not None
    np.testing.assert_array_equal(streamed, res_a.tokens)
    np.testing.assert_array_equal(res_a.tokens, eng.results[0])
    np.testing.assert_array_equal(
        res_a.tokens, _ref_run([a_req], num_slots=1)[0])
    assert res_b.status == "cancelled" and res_b.reason is None
    assert 0 < len(res_b.tokens) < 24
    assert eng.shed_count == 1 and eng.status[2] == "shed"
    assert "queue full" in eng.errors[2]
    assert eng.pool.num_live == 0 and fe.steps > 0
    _assert_conserved(eng)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_frontend_closed_loop_parity(temperature):
    """The split step under the front end changes no token: its outputs
    equal the port's closed-loop ``run`` (sampled too: the noise is keyed
    by request and count) and, greedy, the reference engine's."""
    cfg, eng = _engine()
    reqs = _reqs(cfg, 4, seed=1, temperature=temperature)
    closed = PS.ServeEngine(eng.params, cfg, eng.acfg, eng.scfg).run(
        [PS.Request(**r) for r in reqs])
    fe = AsyncServeFrontend(eng)

    async def scenario():
        await fe.start()
        handles = [await fe.submit(PS.Request(**r)) for r in reqs]
        out = [await h.result() for h in handles]
        await fe.stop()
        return out

    results = asyncio.run(scenario())
    ref = _ref_run(reqs) if temperature == 0.0 else closed
    for res in results:
        assert res.status == "finished"
        np.testing.assert_array_equal(res.tokens, closed[res.uid])
        np.testing.assert_array_equal(res.tokens, ref[res.uid])


def test_frontend_loop_failure_reaches_waiters():
    """A fault the engine does not tolerate ends the serving loop; every
    waiter gets it (no hang), ``stop`` raises it, and later commands are
    refused."""
    cfg, eng = _engine()

    def broken(*a, **kw):
        raise RuntimeError("device fault")

    eng._mixed_dispatch = broken
    fe = AsyncServeFrontend(eng)

    async def scenario():
        await fe.start()
        h = await fe.submit(PS.Request(uid=0, prompt=_prompt(cfg, 4),
                                       max_new=3, temperature=0.0))
        with pytest.raises(RuntimeError, match="device fault"):
            await asyncio.wait_for(h.result(), 30)
        with pytest.raises(RuntimeError, match="serving loop failed"):
            await fe.submit(PS.Request(uid=1, prompt=_prompt(cfg, 4)))
        with pytest.raises(RuntimeError, match="device fault"):
            await fe.stop()

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# the launcher's open-loop modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival", ["poisson", "burst"])
def test_launcher_open_loop_every_arrival_terminal(arrival, capsys):
    flags = ["--device", "cpu", "--reduced", "--paged", "--num-requests",
             "8", "--new-tokens", "8", "--num-slots", "1", "--qps", "40",
             "--arrival", arrival, "--max-queue", "2", "--request-timeout",
             "30", "--ttft-timeout", "20"]
    records = port_serve.main(flags)
    out = capsys.readouterr().out
    assert sorted(r["uid"] for r in records) == list(range(8))
    assert all(r["status"] in PS.TERMINAL for r in records)
    assert not any(r["status"] == "errored" for r in records)
    for r in records:
        assert len(r["streamed"]) == r["tokens"]
        assert (r["reason"] is None) == (r["status"] == "finished")
    assert f"open-loop ({arrival} @ 40 qps, 8 arrivals)" in out
    assert "queue high-water" in out and "shed" in out
    if arrival == "burst":   # 4 within 1 ms: one slot and a queue of 2
        assert any(r["status"] == "shed" for r in records)


def test_launcher_open_loop_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--reduced", "--paged", "--qps", "2"])


def test_arrival_offsets():
    rng = np.random.default_rng(0)
    burst = port_serve.arrival_offsets(8, 8.0, "burst", rng)
    assert np.allclose(burst[:4], 0.0, atol=1e-3)
    assert np.allclose(burst[4:], 0.5, atol=1e-3)
    poisson = port_serve.arrival_offsets(4000, 8.0, "poisson", rng)
    assert np.all(np.diff(poisson) > 0)
    assert abs(poisson[-1] / 4000 - 1 / 8.0) < 0.01


# ---------------------------------------------------------------------------
# the HTTP front door
# ---------------------------------------------------------------------------

class _Writer:
    """The writer side of a connection, in memory."""

    def __init__(self):
        self.data = b""
        self.closed = False

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        self.closed = True


def _request(method, path, body=None):
    raw = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else b"")
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    if raw:
        head += f"Content-Length: {len(raw)}\r\n"
    return head.encode() + b"\r\n" + raw


async def _exchange(handle, raw):
    """Run the handler on ``raw``; returns (status code, JSON body)."""
    reader = asyncio.StreamReader()
    reader.feed_data(raw)
    reader.feed_eof()
    w = _Writer()
    await handle(reader, w)
    assert w.closed
    head, body = w.data.split(b"\r\n\r\n", 1)
    return int(head.split()[1]), json.loads(body)


def _args():
    """The launcher's defaults the front door reads, on a free port."""
    return argparse.Namespace(new_tokens=4, seed=0, ttft_timeout=0.0,
                              request_timeout=0.0, port=0)


def test_http_handler_in_memory():
    """200 with the engine's tokens, 503 with the reason at a full queue
    (the queue filled before the front end applies the request), 400 on a
    bad body, 404 elsewhere, ``/health`` equal to the engine's
    counters."""
    cfg, eng = _engine(num_slots=1, max_queue=1)
    fe = AsyncServeFrontend(eng)
    handle = port_serve.http_handler(fe, _args(), cfg.vocab_size)
    prompt = [int(t) for t in _prompt(cfg, 5)]

    async def scenario():
        # the engine's queue is full (1 of 1) when the front end starts
        # and applies the request: it is shed
        assert eng.try_submit(PS.Request(uid=1000, prompt=_prompt(cfg, 4),
                                         max_new=2)) is None
        shed = asyncio.ensure_future(_exchange(handle, _request(
            "POST", "/generate", {"prompt": prompt, "max_new": 3})))
        await asyncio.sleep(0.05)
        await fe.start()
        code, body = await shed
        assert code == 503 and body["status"] == "shed"
        assert "queue full" in body["reason"]
        code, body = await _exchange(handle, _request(
            "POST", "/generate", {"prompt": prompt, "max_new": 4,
                                  "temperature": 0.0}))
        assert code == 200 and body["status"] == "finished"
        ok = body
        for bad in (b"{not json", {"max_new": 3}, {"prompt": "abc"},
                    {"prompt": []}, {"prompt": [[1, 2]]}):
            code, body = await _exchange(handle, _request(
                "POST", "/generate", bad))
            assert code == 400 and "error" in body
        for head in (b"Content-Length: x", b"Content-Length: -1",
                     b"Content-Length: 99"):   # 99: the body ends early
            code, body = await _exchange(
                handle, b"POST /generate HTTP/1.1\r\n" + head
                + b"\r\n\r\n{}")
            assert code == 400 and "error" in body
        code, body = await _exchange(handle, _request("GET", "/nope"))
        assert code == 404
        while eng.num_active or eng.queue_depth:
            await asyncio.sleep(0.01)
        code, health = await _exchange(handle, _request("GET", "/health"))
        await fe.stop()
        return ok, code, health

    ok, code, health = asyncio.run(scenario())
    assert ok["tokens"] == [int(t) for t in eng.results[ok["uid"]]]
    assert len(ok["tokens"]) == 4 and ok["ttft"] is not None
    assert code == 200 and health == dict(
        active=eng.num_active, queued=eng.queue_depth,
        submitted=eng.submitted, shed=eng.shed_count,
        timed_out=eng.timeout_count, cancelled=eng.cancel_count,
        step_faults=eng.fault_count, queue_high_water=eng.queue_high_water)
    assert health["submitted"] == 3 and health["shed"] == 1


def test_http_front_door_over_loopback():
    """The front door on a free loopback port answers a POST with the
    engine's tokens and stops."""
    cfg, eng = _engine()
    fe = AsyncServeFrontend(eng)

    async def scenario():
        await fe.start()
        server = await port_serve.open_http(fe, _args(), cfg.vocab_size)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(_request("POST", "/generate", {
            "prompt": [1, 2, 3], "max_new": 3, "temperature": 0.0}))
        await writer.drain()
        data = await reader.read()
        writer.close()
        server.close()
        await server.wait_closed()
        await fe.stop()
        return data

    head, body = asyncio.run(scenario()).split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 200")
    body = json.loads(body)
    assert body["tokens"] == [int(t) for t in eng.results[body["uid"]]]


def test_frontend_stress_books_balance():
    """Many clients at once, submitting and cancelling at random, with the
    interpreter switching threads every few microseconds: every request
    resolves exactly once with one terminal status, the books balance,
    the pool is conserved, and every finished request that no client
    cancelled decodes what the closed loop decodes."""
    import sys

    cfg, eng = _engine(num_slots=2, max_queue=3)
    reqs = _reqs(cfg, 24, seed=5, temperature=0.0)
    closed = PS.ServeEngine(eng.params, cfg, eng.acfg, PS.SchedulerConfig(
        **_kw())).run([PS.Request(**r) for r in reqs])
    fe = AsyncServeFrontend(eng, idle_sleep=0.0005)
    rng = np.random.default_rng(5)
    plan = [(r, float(rng.uniform(0, 0.2)), bool(rng.random() < 0.3))
            for r in reqs]
    cancelled = set()

    async def client(r, delay, cancel):
        await asyncio.sleep(delay)
        try:
            h = await fe.submit(PS.Request(**r))
        except ShedError:
            return r["uid"], "shed", None
        if cancel:
            await asyncio.sleep(delay / 4)
            if await fe.cancel(r["uid"]):
                cancelled.add(r["uid"])
        streamed = [t async for t in h.stream()]
        res = await h.result()
        assert streamed == [int(t) for t in res.tokens]
        return r["uid"], res.status, res.tokens

    async def scenario():
        await fe.start()
        out = await asyncio.wait_for(asyncio.gather(
            *(client(*p) for p in plan)), 120)
        await fe.stop()
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = asyncio.run(scenario())
    finally:
        sys.setswitchinterval(old)
    assert sorted(u for u, _, _ in out) == [r["uid"] for r in reqs]
    assert eng.submitted == len(reqs)
    for uid, status, toks in out:
        assert status == eng.status[uid] in PS.TERMINAL
        if status == "finished" and uid not in cancelled:
            np.testing.assert_array_equal(toks, closed[uid])
    assert eng.shed_count == sum(s == "shed" for _, s, _ in out)
    assert eng.num_active == eng.queue_depth == 0
    assert eng.pool.num_live == 0 and not fe._handles
    _assert_conserved(eng)
