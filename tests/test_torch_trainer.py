"""The port's loader, checkpoints, trainer, recipes and training CLI.

* ``TokenLoader`` gives the reference's batches, state and restore;
* checkpoints: the cases of the reference's ``test_checkpoint.py``
  (round trip, a corrupt newest file skipped, a structure mismatch
  refused, retention, no temporary file left), and a train state saved by
  either package restored by the other, bit for bit;
* ``Trainer``: the reference's resume / NaN-guard and straggler cases; a
  run of the real train step on reduced llama-3.2-1b with the training
  noise on, saved at step 2 and resumed in a fresh trainer, equals the
  uninterrupted run bit for bit (parameters and Adam state), and so does
  ``distill_recipe`` resumed from its checkpoint directory (it restores
  the loader's position too);
* ``python -m repro_torch.launch.train --device cpu --reduced --steps 4
  --pretrain-steps 4`` exits 0, and ``--production-mesh`` on fewer than
  256 cards raises the mesh's ``ValueError``, naming both counts.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.data.loader import TokenLoader as RefLoader
from repro.optim.adamw import init_opt_state as ref_init_opt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint import flatten_paths
from repro_torch.configs import get_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.data.corpus import MarkovCorpus
from repro_torch.data.loader import TokenLoader
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train import recipes
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import StragglerMonitor, Trainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("micro", [1, 2])
def test_token_loader_gives_the_references_batches(micro):
    toks = np.arange(23 * 5, dtype=np.int32).reshape(23, 5)
    ref, port = RefLoader(toks, 4, seed=3, microbatches=micro), \
        TokenLoader(toks, 4, seed=3, microbatches=micro)
    it_r, it_p = iter(ref), iter(port)
    for _ in range(9):          # crosses an epoch boundary (5 batches each)
        np.testing.assert_array_equal(next(it_p), next(it_r))
        assert port.state() == ref.state()
    state = port.state()
    fresh_p = TokenLoader(toks, 4, seed=0, microbatches=micro)
    fresh_r = RefLoader(toks, 4, seed=0, microbatches=micro)
    fresh_p.restore(state)
    fresh_r.restore(state)
    for a, b, c, _ in zip(iter(fresh_p), iter(fresh_r), iter(port),
                          range(6)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g) * scale,
                       "b": torch.zeros((4,))},
            "state": {"step": torch.tensor(7, dtype=torch.int32),
                      "m": torch.randn((8, 4), generator=g)}}


def _equal_trees(a, b):
    fa, fb = flatten_paths(a), flatten_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb)


def test_checkpoint_roundtrip_and_atomic_write(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "hello"})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    restored, extra, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and extra["note"] == "hello"
    _equal_trees(restored, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_corrupt_checkpoint_skipped(tmp_path):
    tree = _tree(1)
    ckpt.save(str(tmp_path), 1, tree)
    tree2 = {k: {kk: v + 1 for kk, v in d.items()} for k, d in tree.items()}
    p2 = ckpt.save(str(tmp_path), 2, tree2)
    with open(p2, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    restored, _, step = ckpt.restore(str(tmp_path), tree)
    assert step == 1
    _equal_trees(restored, tree)


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree(2))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"different": torch.zeros((2,))})


def test_retention(tmp_path):
    tree = _tree(3)
    for s in range(1, 8):
        ckpt.save(str(tmp_path), s, tree)
    ckpt.retain(str(tmp_path), keep=2, keep_every=3)
    assert [s for s, _ in ckpt._ckpt_files(str(tmp_path))] == [3, 6, 7]


def _train_tree(seed):
    """A train-state tree of the shape both packages save: params, step
    count and Adam moments (with its int32 count)."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": rng.standard_normal((2, 4, 3)).astype(
                  np.float32),
                         "input_range": np.full((2, 1), 3.0, np.float32)},
              "lm": rng.standard_normal((3,)).astype(np.float32)}
    opt = ref_init_opt(params)
    opt = {"m": jax.tree.map(lambda v: v + 0.5, opt["m"]),
           "v": jax.tree.map(lambda v: v + 0.25, opt["v"]),
           "count": jnp.int32(5)}
    return {"params": jax.tree.map(jnp.asarray, params),
            "state": {"step": jnp.int32(5), "opt": opt}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_cross_package_restore(tmp_path):
    """Each package restores the other's train checkpoint bit for bit
    (paths, dtypes, shapes, extra and checksum agree)."""
    jtree = _train_tree(0)
    ref_ckpt.save(str(tmp_path / "ref"), 5, jtree, extra={"from": "jax"})
    like = _to_torch(jax.tree.map(jnp.zeros_like, jtree))
    restored, extra, step = ckpt.restore(str(tmp_path / "ref"), like)
    assert step == 5 and extra == {"from": "jax"}
    _equal_trees(restored, _to_torch(jtree))
    assert restored["state"]["step"].dtype == torch.int32

    ttree = _to_torch(_train_tree(1))
    ckpt.save(str(tmp_path / "port"), 9, ttree, extra={"from": "torch"})
    j_like = jax.tree.map(jnp.zeros_like, _train_tree(1))
    j_restored, j_extra, j_step = ref_ckpt.restore(str(tmp_path / "port"),
                                                   j_like)
    assert j_step == 9 and j_extra == {"from": "torch"}
    _equal_trees(_to_torch(j_restored), ttree)


def test_trainer_resume_and_nan_guard(tmp_path):
    """The reference's ``test_trainer_resume_and_nan_guard``: a NaN step
    drops its update but advances the step; a fresh trainer resumes from
    disk."""
    def step_fn(params, state, batch, key):
        s = int(state["step"])
        loss = torch.tensor(float("nan") if s == 3 else 1.0 / (1 + s))
        return ({k: v + 1.0 for k, v in params.items()},
                dict(state, step=state["step"] + 1), {"loss": loss})

    tr = Trainer(step_fn, {"w": torch.zeros((2,))},
                 {"step": torch.tensor(0, dtype=torch.int32)},
                 ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0)
    tr.fit(iter([{}] * 100), 6)
    assert tr.skipped_steps == 1
    assert float(tr.params["w"][0]) == 5.0
    assert int(tr.state["step"]) == 6
    tr2 = Trainer(step_fn, {"w": torch.zeros((2,))},
                  {"step": torch.tensor(0, dtype=torch.int32)},
                  ckpt_dir=str(tmp_path), ckpt_every=100, log_every=0)
    assert tr2.try_resume() is not None
    assert int(tr2.state["step"]) == 6
    assert float(tr2.params["w"][0]) == 5.0


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 1.0)
    assert not mon.observe(11, 0.12)
    assert len(mon.events) == 1


@pytest.fixture(scope="module")
def reduced():
    cfg, params, labels = build(get_config("llama-3.2-1b").reduce(), 0,
                                device="cpu")
    tokens = MarkovCorpus(cfg.vocab_size, seed=0).sample(32, 13)
    return cfg, params, labels, tokens


def _flat_np(tree):
    return {k: v.numpy() for k, v in flatten_paths(tree).items()}


def test_trainer_resume_is_bit_exact_with_noise_on(reduced, tmp_path):
    """4 steps of the real train step (analog, training noise and remat
    on), against 2 steps, a save, a fresh trainer's resume and 2 more."""
    cfg, params, labels, tokens = reduced
    acfg = AnalogConfig(mode="analog", init_steps=2, use_pallas=True)
    tcfg = ts.TrainConfig(peak_lr=1e-3, total_steps=8, kd_beta=0.0,
                          ce_weight=1.0)

    def trainer(ckpt_dir):
        step = ts.make_train_step(cfg, acfg, tcfg, labels, lambda s: (
            polynomial_with_warmup(s, peak_lr=1e-3, total_steps=8)))
        return Trainer(step, params, ts.init_train_state(params),
                       ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0, seed=4)

    def batches(start):
        for i in range(start, 8):
            raw = torch.from_numpy(tokens[4 * i:4 * i + 4]).long()
            yield {"tokens": raw[:, :-1], "labels": raw[:, 1:]}

    whole = trainer(None)
    whole.fit(batches(0), 4)
    first = trainer(str(tmp_path))
    first.fit(batches(0), 2)
    second = trainer(str(tmp_path))
    assert second.try_resume() is not None
    assert int(second.state["step"]) == 2
    second.fit(batches(2), 2)
    for a, b in ((whole.params, second.params),
                 (whole.state["opt"], second.state["opt"])):
        fa, fb = _flat_np(a), _flat_np(b)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert [h["loss"] for h in whole.history[2:]] == \
        [h["loss"] for h in second.history]


def test_distill_recipe_resumes_where_it_stopped(reduced, tmp_path):
    """``distill_recipe`` for 4 steps equals 2 steps plus 2 resumed from
    its checkpoint directory (parameters and loader position)."""
    cfg, params, labels, tokens = reduced
    acfg = AnalogConfig(mode="analog", init_steps=2)
    tcfg = ts.TrainConfig(peak_lr=1e-3, total_steps=8, kd_temperature=2.0)
    kw = dict(acfg=acfg, tcfg=tcfg, batch_size=4, seed=1)
    whole, _ = recipes.distill_recipe(params, labels, cfg, tokens,
                                      num_steps=4, **kw)
    recipes.distill_recipe(params, labels, cfg, tokens, num_steps=2,
                           ckpt_dir=str(tmp_path), **kw)
    resumed, tr = recipes.distill_recipe(params, labels, cfg, tokens,
                                         num_steps=2, ckpt_dir=str(tmp_path),
                                         **kw)
    assert int(tr.state["step"]) == 4
    fa, fb = _flat_np(whole), _flat_np(resumed)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "4", "--pretrain-steps", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final KD loss" in out.stdout
    with pytest.raises(ValueError,
                       match=r"needs 256 devices, \d+ are visible"):
        train_cli.main(["--production-mesh", "--device", "cpu"])
