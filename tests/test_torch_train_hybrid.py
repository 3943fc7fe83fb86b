"""The port's HWA train step on the hybrid family (reduced jamba-v0.1-52b:
one super-block of 8 layers, mixers, 4-expert MoE FFNs) against the JAX
package's, and its rematerialisation.

* One ``make_train_step`` step against the reference's, ``use_pallas`` off
  and on, as ``test_torch_train_families.py`` holds the other families
  (the same helper, tolerance ``TOL`` = 1e-5 · (1 + |ref|), routes checked
  clear of near-ties). The reference's side runs in a child process: its
  jitted jamba train step is the largest program the suite compiles, and
  a crash of XLA's compiler there (a segmentation fault, seen once under
  six test workers) then ends the child, which is started once more, and
  not the test worker. One child serves both cases of a module: its
  imports and its copy of the model are made once, while the parent
  builds its own.
* ``remat`` checkpoints each super-block, as the reference's scan body is
  checkpointed: a training step recomputes every site of the stack in its
  backward (the LM head, outside the stack, runs once), and its result
  equals the step without remat bit for bit, with the training noise on,
  fused and unfused (every site's noise is keyed by super-block, layer and
  site, so the recomputation draws what the forward drew).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_train_families import (_lr, carried_model,  # noqa: F401
                                       check_train_step, no_route_ties)

from repro_torch.checkpoint import flatten_paths
from repro_torch.configs import get_config
from repro_torch.core import analog as PA
from repro_torch.core.analog import AnalogConfig
from repro_torch.models import build
from repro_torch.models import layers as PL
from repro_torch.models import transformer as T
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def model():
    return carried_model(ARCH)


#: the child's loop: build the carried model once, then one reference step
#: per request line ("<use_pallas> <npz path>"), "done" after each
_CHILD = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
          "import test_torch_train_families as F; "
          "model = F.carried_model(sys.argv[2]); "
          "[(np.savez(line.split()[1], **F.reference_step("
          "model, line.split()[0] == '1')), print('done', flush=True)) "
          "for line in sys.stdin]")


class _ReferenceChild:
    """``reference_step`` for jamba in a child process, started once per
    module (its imports and the carried model shared by both cases and
    made while the parent builds its own) and asked for one step per
    case; a child that dies by a signal is started once more."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.proc = None
        self._start()

    def _start(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(TESTS.parent / "src"), os.environ.get("PYTHONPATH", "")]),
            JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
        self.err = open(self.tmp / "child.err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(TESTS), ARCH], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err,
            text=True, cwd=TESTS.parent)

    def step(self, use_pallas: bool) -> dict:
        out = self.tmp / f"reference_{int(use_pallas)}.npz"
        for attempt in range(2):
            try:
                self.proc.stdin.write(f"{int(use_pallas)} {out}\n")
                self.proc.stdin.flush()
                done = self.proc.stdout.readline().strip() == "done"
            except BrokenPipeError:
                done = False
            if done:
                break
            code = self.proc.wait(timeout=900)
            self.err.seek(0)
            assert attempt == 0 and code < 0, self.err.read()[-3000:]
            self._start()
        with np.load(out) as f:
            return dict(f)

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=900)
        self.err.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    child = _ReferenceChild(tmp_path_factory.mktemp("reference"))
    yield child
    child.close()


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
def test_train_step_matches_the_reference(reference, model, use_pallas,
                                          no_route_ties):
    check_train_step(model, use_pallas, no_route_ties,
                     reference.step(use_pallas))


def _site_calls(monkeypatch):
    """Count every analog site call of the stack and the head."""
    calls = []
    real = PA.analog_linear

    def spy(p, x, acfg, ctx):
        calls.append(ctx.training)
        return real(p, x, acfg, ctx)

    for mod in (PL, T, T.M, T.MoE):
        monkeypatch.setattr(mod, "analog_linear", spy)
    return calls


def test_hybrid_remat_recomputes_and_is_bit_exact(monkeypatch):
    cfg, params, labels = build(get_config(ARCH).reduce(), 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 13))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = _site_calls(monkeypatch)
    # sites of one forward: per super-block the attention layer's 4, each
    # mixer's in/out projections and its FFN's 2 (a MoE FFN's expert sites
    # one batched call each), and the untied head
    blocks = 4 * cfg.num_layers
    for use_pallas in (False, True):
        acfg = AnalogConfig(mode="analog", init_steps=2, use_pallas=use_pallas)
        outs = []
        for remat in (False, True):
            tcfg = ts.TrainConfig(peak_lr=1e-3, total_steps=8, kd_beta=0.0,
                                  ce_weight=1.0, remat=remat)
            step = ts.make_train_step(cfg, acfg, tcfg, labels, _lr)
            state = dict(ts.init_train_state(params),
                         step=torch.ones((), dtype=torch.int32))
            calls.clear()
            outs.append(step(params, state, batch, (5,)))
            assert len(calls) == blocks * (2 if remat else 1) + 1, (
                remat, len(calls))
        (p0, s0, m0), (p1, s1, m1) = outs
        assert torch.equal(m0["loss"], m1["loss"])
        for tree0, tree1 in ((p0, p1), (s0["opt"], s1["opt"])):
            for (path, a), b in zip(flatten_paths(tree0).items(),
                                    flatten_paths(tree1).values()):
                assert torch.equal(a, b), path
    # and the noise is on: another key gives another loss
    _, _, m2 = step(params, state, batch, (6,))
    assert not torch.equal(m2["loss"], m1["loss"])
