"""The port's HWA train step on the ssm, moe and hybrid families against the
JAX package's: reduced mamba2-130m, qwen3-moe-30b-a3b and dbrx-132b here,
jamba-v0.1-52b in ``test_torch_train_hybrid.py``.

Weights are built by the reference from a JAX key (``init_model`` as one
jitted program) and carried across as numpy. With the training noise off
both packages take one ``make_train_step`` step on the same weights and batch
(KD against injected teacher logits plus a CE mix, the MoE aux loss, remat
on), with ``use_pallas`` off and on (the reference's Pallas kernel in
interpret mode, the port's plain version of ``analog_matmul``; the SSD is
the reference's chunked jnp path and the port's plain ``ssd_scan``). Held:
the loss and every metric (aux included), every gradient leaf (from both
packages' loss functions), and after the step every parameter, the Adam
moments and count, and the updated ``input_range``s. Then, in the port
alone: each family's recipe resumed from its checkpoint equals the
uninterrupted run bit for bit with the noise on, and the training CLI runs
each family.

Tolerance: ``TOL`` = 1e-5 · (1 + |ref|), as ``test_torch_train.py``: every
gradient is a sum over the batch's rows in another order than XLA's (an
expert's ``dw`` sums its rows of every sequence in one product, where the
reference's vmaps sum per sequence and then over sequences). A routing id
may differ only at a router near-tie (``ROUTE_TIE`` between the k-th and
(k+1)-th probability); none occurs at these seeds, which the test checks
before it compares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.analog import AnalogConfig as RefAnalogConfig
from repro.models import transformer as RT
from repro.optim.schedule import polynomial_with_warmup as ref_sched
from repro.train import train_step as ref_ts
from repro_torch.checkpoint import (flatten_paths, params_from_numpy,
                                    unflatten_paths)
from repro_torch.core.analog import AnalogConfig
from repro_torch.data.corpus import MarkovCorpus
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models import moe as PM
from repro_torch.models import transformer as T
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train import recipes
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

TOL = 1e-5
ROUTE_TIE = 1e-5
#: the families' archs; jamba's step against the reference runs in
#: ``test_torch_train_hybrid.py`` (its reference compile takes most of a
#: minute)
ARCHS = ["mamba2-130m", "qwen3-moe-30b-a3b", "dbrx-132b", "jamba-v0.1-52b"]
COMPARED = ARCHS[:3]
B, S = 2, 12
ACFG = dict(mode="analog", train_noise=False, init_steps=3, alpha_clip=2.5,
            range_decay=0.05, kappa_init=18.0, out_bound=14.0)
TCFG = dict(peak_lr=1e-3, total_steps=20, kd_temperature=2.0, kd_beta=1.0,
            ce_weight=0.5, remat=True)
METRICS = ("loss", "kd", "ce", "aux", "grad_norm", "lr")


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def close(port, ref, tol=TOL, what=""):
    p = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    err = np.abs(p.astype(np.float64) - r)
    assert np.all(err <= tol * (1 + np.abs(r))), (what, float(err.max()))


def ref_model(cfg, seed: int):
    """The reference's ``init_model`` as one jitted program (the eager
    call dispatches thousands of small ops): ``(params, labels)``; the
    labels, plain strings, are read off a trace."""
    labels = []
    jax.eval_shape(lambda k: labels.append(RT.init_model(k, cfg)[1]) or 0,
                   jax.random.PRNGKey(seed))
    params = jax.jit(lambda k: RT.init_model(k, cfg)[0])(
        jax.random.PRNGKey(seed))
    return params, labels[0]


@pytest.fixture(scope="module", params=COMPARED)
def model(request):
    """(cfg, reference params and labels, port params and labels, batch as
    numpy)."""
    return carried_model(request.param)


def carried_model(arch: str):
    """``model``'s tuple for ``arch``."""
    cfg = get_config(arch).reduce()
    params, labels = ref_model(cfg, 0)
    pp = params_from_numpy(_ref_flat(params), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "teacher_logits": (2.0 * rng.standard_normal(
                 (B, S, cfg.vocab_size))).astype(np.float32)}
    return cfg, params, labels, pp, T.model_labels(pp, cfg), batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _lr(step):
    return polynomial_with_warmup(step, peak_lr=TCFG["peak_lr"],
                                  total_steps=TCFG["total_steps"])


def _port_grads(cfg, acfg, tcfg, params, batch):
    """(loss, metrics, grads by path) of the port's loss function."""
    leaves = {p: v.detach().clone().requires_grad_(True)
              for p, v in flatten_paths(params).items()}
    loss, (_, metrics) = ts.make_loss_fn(cfg, acfg, tcfg)(
        unflatten_paths(leaves), batch, (0,))
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, metrics, {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), gs)}


@pytest.fixture
def no_route_ties(monkeypatch):
    """Every MoE routing of the test, on the port's side, has its k-th and
    (k+1)-th router probabilities more than ROUTE_TIE apart (so the two
    packages' routes cannot part on fp32 rounding)."""
    real = PM._route
    log = {"gaps": [], "drops": 0}

    def spy(x, router, cfg, capacity):
        probs = torch.softmax(torch.matmul(x.float(), router.float()), -1)
        top = probs.detach().sort(-1, descending=True).values
        log["gaps"].append(float((top[..., cfg.top_k - 1]
                                  - top[..., cfg.top_k]).min()))
        out = real(x, router, cfg, capacity)
        log["drops"] += int((out[2] == cfg.num_experts * x.shape[0]
                             * capacity).sum())
        return out

    monkeypatch.setattr(PM, "_route", spy)
    yield log
    assert all(g > ROUTE_TIE for g in log["gaps"]), min(log["gaps"])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
def test_train_step_matches_the_reference(model, use_pallas, no_route_ties):
    check_train_step(model, use_pallas, no_route_ties)


def reference_step(model, use_pallas) -> dict:
    """The reference's side of :func:`check_train_step`, as numpy: its
    loss function's ``loss``, ``metric/<kd|ce|aux>`` and ``grad/<path>``,
    then one jitted ``make_train_step`` step from step 1: ``step/<metric>``,
    ``step``, ``count`` and ``params/<path>``, ``m/<path>``,
    ``v/<path>``."""
    cfg, params, labels, _, _, batch = model
    racfg = RefAnalogConfig(**ACFG, use_pallas=use_pallas)
    rtcfg = ref_ts.TrainConfig(**TCFG)
    rbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    (loss, (_, metrics)), grads = jax.jit(jax.value_and_grad(
        ref_ts.make_loss_fn(cfg, racfg, rtcfg), has_aux=True))(
        params, rbatch, key)
    out = {"loss": loss,
           **{f"metric/{k}": metrics[k] for k in ("kd", "ce", "aux")},
           **{f"grad/{k}": v for k, v in _ref_flat(grads).items()}}
    # one step, taken from step 1: the schedule's lr is 0 at step 0, and
    # from step 1 every parameter moves and the ranges take the EMA blend
    step = jax.jit(ref_ts.make_train_step(
        cfg, racfg, rtcfg, labels, lambda s: ref_sched(
            s, peak_lr=TCFG["peak_lr"], total_steps=TCFG["total_steps"])))
    state = dict(ref_ts.init_train_state(params),
                 step=jnp.ones((), jnp.int32))
    params, state, metrics = step(params, state, rbatch, key)
    out.update({f"step/{k}": metrics[k] for k in METRICS},
               step=state["step"], count=state["opt"]["count"])
    for name, tree in (("params", params), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        out.update({f"{name}/{k}": v for k, v in _ref_flat(tree).items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _under(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def check_train_step(model, use_pallas, no_route_ties, ref=None):
    """The loss function's loss, metrics and gradients, then one train
    step's metrics, parameters and moments, against the reference's
    (``reference_step``'s dict, computed here when ``ref`` is None)."""
    cfg, _, _, pp, plabels, batch = model
    if ref is None:
        ref = reference_step(model, use_pallas)
    pacfg = AnalogConfig(**ACFG, use_pallas=use_pallas)
    ptcfg = ts.TrainConfig(**TCFG)
    p_loss, p_metrics, p_grads = _port_grads(cfg, pacfg, ptcfg, pp,
                                             _port_batch(batch))
    close(p_loss, ref["loss"], what="loss")
    for name in ("kd", "ce", "aux"):
        close(p_metrics[name], ref[f"metric/{name}"], what=name)
    if cfg.family != "ssm":
        assert float(p_metrics["aux"]) > 0
        # the capacity drops assignments here: the spare row is covered
        assert no_route_ties["drops"] > 0
    r_flat = _under(ref, "grad/")
    assert set(r_flat) == set(p_grads)
    for path, g in p_grads.items():
        close(g, r_flat[path], what=path)
    # the router learns, through the combine weights and the aux loss
    if cfg.family in ("moe", "hybrid"):
        routers = [g for path, g in p_grads.items() if "router" in path]
        assert routers and all(bool(g.abs().sum() > 0) for g in routers)

    # one step from step 1, as the reference's
    p_step = ts.make_train_step(cfg, pacfg, ptcfg, plabels, _lr)
    p_s = dict(ts.init_train_state(pp), step=torch.ones((), dtype=torch.int32))
    p_p, p_s, p_m = p_step(pp, p_s, _port_batch(batch), (0,))
    for name in METRICS:
        close(p_m[name], ref[f"step/{name}"], what=name)
    assert float(p_m["lr"]) == np.float32(TCFG["peak_lr"])
    assert int(p_s["step"]) == int(ref["step"]) == 2
    assert int(p_s["opt"]["count"]) == int(ref["count"]) == 1
    for tree_p, what in ((p_p, "params"), (p_s["opt"]["m"], "m"),
                         (p_s["opt"]["v"], "v")):
        r_flat = _under(ref, what + "/")
        assert set(r_flat) == set(flatten_paths(tree_p))
        for path, v in flatten_paths(tree_p).items():
            close(v, r_flat[path], what=f"{what} {path}")
    # every range moved off its initial 3.0 by the EMA rule, and every
    # analog weight moved
    for path, v in flatten_paths(p_p).items():
        if path.endswith(("input_range", "kernel")):
            assert not torch.equal(v, flatten_paths(pp)[path]), path


def _corpus(cfg, rows, seq, seed=0):
    return MarkovCorpus(cfg.vocab_size, seed=seed).sample(rows, seq + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_distill_recipe_resumes_bit_exact(arch, tmp_path):
    """``distill_recipe`` (analog, training noise and remat on, fused) for
    4 steps equals 2 steps plus 2 resumed from its checkpoint directory,
    bit for bit: every expert's noise, routing and the SSD's backward are
    functions of the step's key and data alone."""
    cfg, params, labels = build(get_config(arch).reduce(), 0, device="cpu")
    tokens = _corpus(cfg, 16, 12)
    kw = dict(acfg=AnalogConfig(mode="analog", init_steps=2,
                                use_pallas=True),
              tcfg=ts.TrainConfig(peak_lr=1e-3, total_steps=8,
                                  kd_temperature=2.0),
              batch_size=2, seed=1)
    whole, tw = recipes.distill_recipe(params, labels, cfg, tokens,
                                       num_steps=4, **kw)
    recipes.distill_recipe(params, labels, cfg, tokens, num_steps=2,
                           ckpt_dir=str(tmp_path), **kw)
    resumed, tr = recipes.distill_recipe(params, labels, cfg, tokens,
                                         num_steps=2, ckpt_dir=str(tmp_path),
                                         **kw)
    assert int(tr.state["step"]) == 4
    assert all(np.isfinite(h["loss"]) for h in tw.history)
    fa, fb = flatten_paths(whole), flatten_paths(resumed)
    for k in fa:
        np.testing.assert_array_equal(fa[k].numpy(), fb[k].numpy(),
                                      err_msg=k)
    assert [h["loss"] for h in tw.history[2:]] == \
        [h["loss"] for h in tr.history]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_each_family(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu``: pre-training, then HWA distillation, to a finite KD
    loss."""
    trainer = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "2", "--pretrain-steps", "2",
                              "--batch", "2", "--seq", "16"])
    assert int(trainer.state["step"]) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "final KD loss" in capsys.readouterr().out

