"""The continuous engine's drift clock and watchdog, and the serving
CLI's drift flags, against the JAX package's engine
(``tests/test_noise_clip.py::test_engine_drift_watchdog_recalibrates_in_
flight``), on reduced granite-3-8b with the reference's device state
carried across (``tests/test_torch_devices.py`` says how).

* ``recalibrate=False``: greedy tokens, ``drift_hours`` and every step's
  health read (``tile_scale_err`` within 1e-6) equal the reference's.
* ``recalibrate=True``: the watchdog checks at the reference's steps and
  first reprograms at its step, with equal health reads up to it; the
  redraw is the port's own generator's, so later reads are not compared.
  Every request completes, and no leaf of the params is replaced.
"""

import numpy as np
import pytest
import torch
from test_torch_devices import (SCALE_ERR_TOL, _carry, _ref_attach,
                                _ref_model)

from repro.configs import get_config
from repro.core import analog as RA
from repro.serve import scheduler as RS
from repro_torch.checkpoint import flatten_paths
from repro_torch.core import analog as PA
from repro_torch.launch import serve as port_serve
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def granite():
    """(cfg, reference params with device state) of reduced
    granite-3-8b."""
    cfg = get_config("granite-3-8b").reduce()
    rp, labels = _ref_model(cfg, 0)
    return cfg, _ref_attach(rp, labels, 7)


def _engines(granite, recalibrate: bool):
    """The reference's and the port's engines on reduced granite-3-8b with
    the same device state, as ``test_engine_drift_watchdog_recalibrates_
    in_flight``: 2 slots, chunk 8, 4 greedy requests of 10 tokens."""
    cfg, dp = granite
    pp = _carry(dp)                       # a chip of this engine's own
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, drift_dt=4.0,
              recalibrate=recalibrate, recal_interval=2,
              recal_threshold=0.05)
    ref = RS.ServeEngine(dp, cfg, RA.AnalogConfig(mode="analog"),
                         RS.SchedulerConfig(prefix_cache=False, **kw))
    port = PS.ServeEngine(pp, cfg, PA.AnalogConfig(mode="analog"),
                          PS.SchedulerConfig(**kw))
    rng = np.random.default_rng(1)
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size, 6 + i).astype(np.int32)
        ref.submit(RS.Request(uid=i, prompt=prompt, max_new=10,
                              temperature=0.0))
        port.submit(PS.Request(uid=i, prompt=prompt, max_new=10,
                               temperature=0.0))
    return ref, port


def _trace(eng) -> list:
    """Drive ``eng`` to the end, recording the watchdog after each step."""
    out = []
    while eng.queue or eng.num_active:
        eng.step()
        out.append((eng.watchdog_checks, eng.recal_count,
                    eng.tile_scale_err, eng.drift_hours))
    return out


def test_engine_drift_clock_matches_reference(granite):
    ref, port = _engines(granite, recalibrate=False)
    assert port.drift_enabled and not port.recal_enabled
    t_ref, t_port = _trace(ref), _trace(port)
    assert [r[:2] for r in t_port] == [r[:2] for r in t_ref]
    assert port.drift_hours == ref.drift_hours > 0
    for a, b in zip(t_port, t_ref):
        assert abs(a[2] - b[2]) < SCALE_ERR_TOL
    assert sorted(port.results) == [0, 1, 2, 3]
    for uid, toks in port.results.items():
        np.testing.assert_array_equal(toks, ref.results[uid])


def test_engine_watchdog_recalibrates_in_flight_as_the_reference(granite):
    """The watchdog checks at the reference's steps and first reprograms
    the chip at the reference's step; up to it the health reads agree.
    The recalibration evicts nothing: every request completes."""
    ref, port = _engines(granite, recalibrate=True)
    assert port.drift_enabled and port.recal_enabled
    ptrs = [v.data_ptr() for v in flatten_paths(port.params).values()]
    t_ref, t_port = _trace(ref), _trace(port)
    first = next(i for i, r in enumerate(t_ref) if r[1])
    assert next(i for i, r in enumerate(t_port) if r[1]) == first
    assert [r[0] for r in t_port[:first + 1]] == [r[0] for r in
                                                   t_ref[:first + 1]]
    for a, b in zip(t_port[:first], t_ref[:first]):
        assert abs(a[2] - b[2]) < SCALE_ERR_TOL
    assert port.recal_count >= 1 and port.tile_scale_err < 0.1
    assert sorted(port.results) == [0, 1, 2, 3]
    assert all(len(v) == 10 and port.status[u] == "finished"
               for u, v in port.results.items())
    assert [v.data_ptr() for v in flatten_paths(port.params).values()] == (
        ptrs)


def test_engine_recal_interval_must_be_positive(granite):
    cfg, dp = granite
    with pytest.raises(ValueError, match="recal_interval"):
        PS.ServeEngine(_carry(dp), cfg, PA.AnalogConfig(mode="analog"),
                       PS.SchedulerConfig(drift_dt=1.0, recalibrate=True,
                                          recal_interval=0))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_drift_report_and_static_note(capsys):
    flags = ["--reduced", "--device", "cpu", "--deploy", "analog_hw",
             "--drift-hours", "48", "--recalibrate", "--fault-prob", "0.01",
             "--num-requests", "4", "--new-tokens", "8"]
    results = port_serve.main(flags)
    out = capsys.readouterr().out
    assert sorted(results) == [0, 1, 2, 3]
    assert "per-tile device state attached" in out
    assert "drift: " in out and "watchdog checks" in out
    port_serve.main(flags + ["--engine", "static"])
    out = capsys.readouterr().out
    assert "ignored on the static path" in out and "drift: " not in out
    port_serve.main(["--reduced", "--device", "cpu", "--drift-hours", "48",
                     "--num-requests", "2", "--new-tokens", "4"])
    assert "needs an analog deployment" in capsys.readouterr().out
