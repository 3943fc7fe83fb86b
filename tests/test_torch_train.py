"""The port's HWA train step against the JAX package's, on reduced
llama-3.2-1b (2 layers, d 64, vocab 256).

Weights are built by the reference from a JAX key and carried across as
numpy. With the training noise off both packages take one
``make_train_step`` step on the same weights and batch (KD against
injected teacher logits plus a CE mix, remat on), with ``use_pallas`` off
and on (the reference's Pallas kernel in interpret mode, the port's plain
version of ``analog_matmul``). Held: the loss and metrics, every gradient
leaf (from both packages' loss functions), and after the step every
parameter, the Adam moments and count, and the updated ``input_range``s.
Then, in the port alone: ``accum_steps=2`` with and without
``fused_accum``; the chunked-vocab loss against the unchunked one (and the
reference's chunked loss); remat against no remat, bit for bit, with the
noise on; the per-site training noise, ``gamma · colmax · N(0, 1)``
within a statistical bound and uncorrelated between sites; and the step
cases of the reference's ``test_train_mechanics.py`` (EMA init then decay
of the ranges, eq. 4 after every step, convergence with compression).

Tolerance: ``TOL`` = 1e-5 · (1 + |ref|) for losses, metrics, gradients
(the ``input_range`` ones, LSQ sums over every element of a site's input,
included), parameters and moments: every gradient is a sum over the
batch's rows in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.analog import AnalogConfig as RefAnalogConfig
from repro.models import build as ref_build
from repro.optim.schedule import polynomial_with_warmup as ref_sched
from repro.train import train_step as ref_ts
from repro_torch.checkpoint import (flatten_paths, params_from_numpy,
                                    unflatten_paths)
from repro_torch.core import noise as noise_lib
from repro_torch.core.analog import AnalogConfig
from repro_torch.models import transformer as T
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

TOL = 1e-5
B, S = 4, 12
ACFG = dict(mode="analog", train_noise=False, init_steps=3, alpha_clip=2.5,
            range_decay=0.05, kappa_init=18.0, out_bound=14.0)
TCFG = dict(peak_lr=1e-3, total_steps=20, kd_temperature=2.0, kd_beta=1.0,
            ce_weight=0.5, remat=True)


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


@pytest.fixture(scope="module")
def model():
    """(cfg, reference params and labels, port params and labels, batch as
    numpy)."""
    cfg = get_config("llama-3.2-1b").reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
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


def _port_grads(cfg, acfg, tcfg, params, batch, key=(0,),
                teacher_params=None):
    """(loss, grads by path, stats) of the port's loss function."""
    leaves = {p: v.detach().clone().requires_grad_(True)
              for p, v in flatten_paths(params).items()}
    loss, (stats, _) = ts.make_loss_fn(cfg, acfg, tcfg)(
        unflatten_paths(leaves), batch, key, teacher_params)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, dict(zip(leaves, gs)), stats


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_the_reference(model, use_pallas):
    cfg, params, labels, pp, plabels, batch = model
    racfg = RefAnalogConfig(**ACFG, use_pallas=use_pallas)
    pacfg = AnalogConfig(**ACFG, use_pallas=use_pallas)
    rtcfg = ref_ts.TrainConfig(**TCFG)
    ptcfg = ts.TrainConfig(**TCFG)
    rbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)

    (r_loss, _), r_grads = jax.value_and_grad(
        ref_ts.make_loss_fn(cfg, racfg, rtcfg), has_aux=True)(
        params, rbatch, key)
    p_loss, p_grads, _ = _port_grads(cfg, pacfg, ptcfg, pp,
                                     _port_batch(batch))
    close(p_loss, r_loss, what="loss")
    r_flat = _ref_flat(r_grads)
    assert set(r_flat) == set(p_grads)
    for path, g in p_grads.items():
        close(g, r_flat[path], what=path)

    r_step = jax.jit(ref_ts.make_train_step(
        cfg, racfg, rtcfg, labels, lambda s: ref_sched(
            s, peak_lr=TCFG["peak_lr"], total_steps=TCFG["total_steps"])))
    p_step = ts.make_train_step(cfg, pacfg, ptcfg, plabels, _lr)
    r_state = ref_ts.init_train_state(params)
    p_state = ts.init_train_state(pp)
    r_p, r_s, p_p, p_s = params, r_state, pp, p_state
    for _ in range(2):
        r_p, r_s, r_m = r_step(r_p, r_s, rbatch, key)
        p_p, p_s, p_m = p_step(p_p, p_s, _port_batch(batch), (0,))
        for name in ("loss", "kd", "ce", "grad_norm", "lr"):
            close(p_m[name], r_m[name], what=name)
    assert int(p_s["step"]) == int(r_s["step"]) == 2
    assert int(p_s["opt"]["count"]) == int(r_s["opt"]["count"]) == 2
    for tree_p, tree_r, what in ((p_p, r_p, "params"),
                                 (p_s["opt"]["m"], r_s["opt"]["m"], "m"),
                                 (p_s["opt"]["v"], r_s["opt"]["v"], "v")):
        r_flat = _ref_flat(tree_r)
        for path, v in flatten_paths(tree_p).items():
            close(v, r_flat[path], what=f"{what} {path}")
    # the ranges left the EMA init's first value (18 · std), not 3.0
    assert float(p_p["blocks"]["attn"]["qkv"]["input_range"][0, 0]) > 5.0


def _step_once(cfg, acfg, tcfg, pp, plabels, batch, key=(0,)):
    step = ts.make_train_step(cfg, acfg, tcfg, plabels, _lr)
    return step(pp, ts.init_train_state(pp, tcfg.grad_compression), batch,
                key)


def test_accumulation_fused_and_unfused_agree(model):
    """``accum_steps=2`` with one backward per microbatch and with one
    backward over the accumulated loss give the same update; with the
    noise off both equal the reference's accumulated step's loss."""
    cfg, params, labels, pp, plabels, batch = model
    acfg = AnalogConfig(**ACFG)
    mb = {k: torch.from_numpy(np.array(v)).reshape(2, B // 2, *v.shape[1:])
          for k, v in batch.items()}
    outs = [_step_once(cfg, acfg, ts.TrainConfig(
        **TCFG, accum_steps=2, fused_accum=fused), pp, plabels, mb)
        for fused in (False, True)]
    (p0, s0, m0), (p1, s1, m1) = outs
    close(m1["loss"], m0["loss"].numpy(), what="loss")
    for (path, a), b in zip(flatten_paths(p1).items(),
                            flatten_paths(p0).values()):
        close(a, b.numpy(), what=path)
    r_step = ref_ts.make_train_step(
        cfg, RefAnalogConfig(**ACFG), ref_ts.TrainConfig(**TCFG,
                                                         accum_steps=2),
        labels, lambda s: ref_sched(s, peak_lr=TCFG["peak_lr"],
                                    total_steps=TCFG["total_steps"]))
    _, _, r_m = jax.jit(r_step)(params, ref_ts.init_train_state(params),
                                jax.tree.map(jnp.asarray, {
                                    k: v.numpy() for k, v in mb.items()}),
                                jax.random.PRNGKey(0))
    close(m0["loss"], r_m["loss"], what="reference loss")


def test_chunked_vocab_loss_matches_unchunked(model):
    """vocab 256 >= 4 x chunk 8: the chunked loss (S = 12 in two chunks,
    the second padded) equals the unchunked one, gradients included, and
    the reference's chunked loss; the teacher runs inside the loss."""
    cfg, params, labels, pp, plabels, batch = model
    acfg = AnalogConfig(**ACFG)
    teacher = params_from_numpy(
        {p: v * 1.01 for p, v in _ref_flat(params).items()}, "cpu")
    pb = {k: v for k, v in _port_batch(batch).items()
          if k != "teacher_logits"}
    res = {}
    for chunk in (0, 8):
        tcfg = ts.TrainConfig(**TCFG, vocab_chunk=chunk)
        res[chunk] = _port_grads(cfg, acfg, tcfg, pp, pb,
                                 teacher_params=teacher)
    close(res[8][0], res[0][0].detach().numpy(), what="loss")
    for path, g in res[8][1].items():
        close(g, res[0][1][path].numpy(), what=path)
    r_teacher = jax.tree.map(lambda v: v * 1.01, params)
    r_loss, _ = ref_ts.make_loss_fn(
        cfg, RefAnalogConfig(**ACFG), ref_ts.TrainConfig(
            **TCFG, vocab_chunk=8))(
        params, {k: jnp.asarray(v) for k, v in batch.items()
                 if k != "teacher_logits"}, jax.random.PRNGKey(0),
        r_teacher)
    close(res[8][0], r_loss, what="reference chunked loss")


def test_remat_is_bit_exact_with_noise_on(model):
    """Each layer recomputed under ``torch.utils.checkpoint`` draws the
    noise its forward drew (keyed by step, layer and site), so a step with
    remat equals one without bit for bit, fused and unfused."""
    cfg, _, _, pp, plabels, batch = model
    pb = _port_batch(batch)
    for use_pallas in (False, True):
        acfg = AnalogConfig(**{**ACFG, "train_noise": True},
                            use_pallas=use_pallas)
        outs = [_step_once(cfg, acfg, ts.TrainConfig(**{**TCFG,
                                                        "remat": remat}),
                           pp, plabels, pb, key=(7,))
                for remat in (False, True)]
        (p0, s0, m0), (p1, s1, m1) = outs
        assert torch.equal(m0["loss"], m1["loss"])
        for tree0, tree1 in ((p0, p1), (s0["opt"], s1["opt"])):
            for (path, a), b in zip(flatten_paths(tree0).items(),
                                    flatten_paths(tree1).values()):
                assert torch.equal(a, b), path
    # and the noise is on: another key gives another loss
    _, _, m2 = _step_once(cfg, acfg, ts.TrainConfig(**TCFG), pp, plabels, pb,
                          key=(8,))
    assert not torch.equal(m2["loss"], m1["loss"])


def test_per_site_noise_statistics(model, monkeypatch):
    """Every analog site of a training forward draws its own eq. (3) noise:
    ``noise / (gamma · colmax)`` has mean 0 and std 1 within 5 standard
    errors, and the draws of any two sites (their leading elements) are
    uncorrelated within 5 / sqrt(n). The reference hands one key to every
    site of a layer, so its sites' leading draws coincide (ROADMAP §3)."""
    cfg, _, _, pp, plabels, batch = model
    gamma = 0.05
    calls = []
    real = noise_lib.gaussian_weight_noise

    def spy(gen, w, g, beta_mult=0.0, axis=0):
        out = real(gen, w, g, beta_mult, axis)
        calls.append((w.detach().clone(), out.clone()))
        return out

    monkeypatch.setattr(noise_lib, "gaussian_weight_noise", spy)
    acfg = AnalogConfig(**{**ACFG, "train_noise": True, "gamma_weight": gamma})
    tcfg = ts.TrainConfig(**{**TCFG, "remat": False})
    ts.make_loss_fn(cfg, acfg, tcfg)(pp, _port_batch(batch), (3, 0))
    assert len(calls) == 4 * cfg.num_layers + 1
    zs = []
    for w, nz in calls:
        colmax = torch.amax(torch.abs(w), dim=0, keepdim=True)
        z = (nz / (gamma * colmax)).reshape(-1).double()
        n = z.numel()
        assert abs(float(z.mean())) < 5 / n ** 0.5
        assert abs(float(z.std()) - 1) < 5 / (2 * n) ** 0.5
        zs.append(z)
    for i in range(len(zs)):
        for j in range(i):
            n = min(zs[i].numel(), zs[j].numel())
            a, b = zs[i][:n], zs[j][:n]
            corr = float(((a - a.mean()) * (b - b.mean())).mean()
                         / (a.std() * b.std()))
            assert abs(corr) < 5 / n ** 0.5, (i, j, corr)


def _ce_steps(model, n, compress=False):
    """``n`` CE steps of the port's train step with the noise on (the
    reference's ``test_train_mechanics`` setup: kd off, ce on, remat
    off)."""
    cfg, _, _, pp, plabels, batch = model
    acfg = AnalogConfig(**{**ACFG, "train_noise": True})
    tcfg = ts.TrainConfig(peak_lr=1e-3, total_steps=20, kd_beta=0.0,
                          ce_weight=1.0, remat=False,
                          grad_compression=compress)
    step = ts.make_train_step(cfg, acfg, tcfg, plabels, _lr)
    state = ts.init_train_state(pp, compress)
    pb = {k: v for k, v in _port_batch(batch).items()
          if k != "teacher_logits"}
    p, out = pp, []
    for _ in range(n):
        p, state, m = step(p, state, pb, (2,))
        out.append((p, m))
    return out


def test_input_range_ema_then_decay(model):
    """The reference's ``test_input_range_ema_then_decay``: the EMA init
    lifts a range far above its initial 3.0, and after ``init_steps`` the
    decay pulls it back down."""
    betas = [3.0] + [float(p["blocks"]["attn"]["qkv"]["input_range"][0, 0])
                     for p, _ in _ce_steps(model, 6)]
    assert betas[1] > 5.0
    assert betas[-1] < betas[3]


def test_weight_clipping_enforced_every_step(model):
    """The reference's ``test_weight_clipping_enforced_every_step``: after
    a step every analog weight is within ``alpha · std`` of its channel
    (the pre-clip std, so 1.35 x the post-clip one covers the shrink), and
    clipping again moves little."""
    p, _ = _ce_steps(model, 1)[0]
    w = p["blocks"]["attn"]["qkv"]["kernel"].numpy()
    std = w.std(axis=-2, keepdims=True)
    assert np.all(np.abs(w) <= ACFG["alpha_clip"] * std * 1.35 + 1e-5)
    from repro_torch.core.clipping import clip_weight
    re = clip_weight(torch.from_numpy(w), ACFG["alpha_clip"], axis=-2)
    assert np.abs(re.numpy() - w).max() <= np.abs(w).max() * 0.2


def test_compressed_train_step_converges(model):
    """The reference's ``test_compressed_train_step_converges``: with int8
    error-feedback compression the loss still falls over 8 steps."""
    losses = [float(m["loss"]) for _, m in _ce_steps(model, 8, True)]
    assert losses[-1] < losses[0]
