"""The resumable training loop.

Wraps a train step with what a long run needs: auto-resume from the newest
valid checkpoint, periodic and emergency atomic checkpoints, a skipped
update (that still advances the step) on a non-finite loss, a straggler
watchdog, and the metric history. The loop is plain Python around the
functional step of ``train.train_step``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Iterable, Optional

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import noise as noise_lib
from repro_torch.distributed import placement


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-clock watchdog: a step far above the running median
    (``factor`` times, once 8 steps are known) is recorded as an event."""
    factor: float = 3.0
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record one step time; True when it is straggler-slow."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        if len(self.times) >= 8 and dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            return True
        return False


class Trainer:
    """Checkpointing train loop: auto-resume, retention, straggler log.

    It runs where the step's tensors live: the recipes put them on the card
    unless the caller asks for the CPU. ``seed`` gives the noise key
    (``noise.prng_key``), which the step folds with its step count, so a
    resumed run draws the noise the uninterrupted one would have. A
    sharded run's state (``distributed.placement``) is written whole, in
    the same layout, so a checkpoint resumes on any mesh or none: it is
    restored whole, and the step places it."""

    def __init__(self, train_step: Callable, params, state, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 200,
                 keep: int = 3, log_every: int = 20,
                 data_state_fn: Optional[Callable[[], dict]] = None,
                 seed: int = 0):
        """Wire a train step to params / state and a checkpoint dir."""
        self.train_step = train_step
        self.params = params
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.data_state_fn = data_state_fn or (lambda: {})
        self.key = noise_lib.prng_key(seed)
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []
        self.skipped_steps = 0

    # -- fault tolerance ----------------------------------------------------
    def try_resume(self) -> Optional[dict]:
        """Restore the newest valid checkpoint, if any, whole onto the
        devices of the current trees (a placed leaf: its first slice's).
        Returns its ``extra`` (None without one)."""
        if not self.ckpt_dir or ckpt.latest_step(self.ckpt_dir) is None:
            return None
        tree = {"params": self.params, "state": self.state}
        tree, extra, step = ckpt.restore(self.ckpt_dir, tree)
        self.params, self.state = tree["params"], tree["state"]
        print(f"[trainer] resumed from step {step}")
        return extra

    def save(self, tag_extra: Optional[dict] = None) -> None:
        """Write an atomic checkpoint of params, state and the loader's
        state, then apply the retention."""
        if not self.ckpt_dir:
            return
        step = int(self.state["step"])
        extra = {"data_state": self.data_state_fn(),
                 "skipped_steps": self.skipped_steps, **(tag_extra or {})}
        ckpt.save(self.ckpt_dir, step, placement.gather_tree(
            {"params": self.params, "state": self.state}), extra=extra)
        ckpt.retain(self.ckpt_dir, keep=self.keep)

    # -- the loop -------------------------------------------------------------
    def fit(self, batches: Iterable[Any], num_steps: int) -> list[dict]:
        """Run ``num_steps`` steps, checkpointing on the save cadence, on
        an exception (emergency save) and at the end."""
        it = iter(batches)
        try:
            for _ in range(num_steps):
                batch = next(it)
                t0 = time.perf_counter()
                new_params, new_state, metrics = self.train_step(
                    self.params, self.state, batch, self.key)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0

                if not math.isfinite(loss):
                    # drop the update but advance the step, so the data
                    # and the noise move on
                    self.skipped_steps += 1
                    self.state = dict(self.state,
                                      step=self.state["step"] + 1)
                    print(f"[trainer] non-finite loss at step "
                          f"{int(new_state['step'])}; update skipped")
                    continue

                self.params, self.state = new_params, new_state
                step = int(self.state["step"])
                self.monitor.observe(step, dt)
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, dt=dt)
                self.history.append(rec)
                if self.log_every and step % self.log_every == 0:
                    print(f"[trainer] step {step} " +
                          " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                                   if k != "step"))
                if self.ckpt_every and step % self.ckpt_every == 0:
                    self.save()
        except (KeyboardInterrupt, Exception):
            self.save({"emergency": True})
            raise
        self.save()
        return self.history
