"""The port's HWA train step on the vlm (internvl2-2b) and audio
(musicgen-medium) families against the JAX package's.

Weights are built by the reference from a JAX key and carried across as
numpy (``test_torch_train_families``' helpers); the batch comes from a
numpy generator: the vlm's tokens ``[B, S]`` with ``patch_embeds`` ``[B,
vit_tokens, vit_dim]`` (its labels and mask lined up with the image prefix
by ``_align_vlm_labels`` in both packages), the audio's tokens and labels
``[B, S, K]``. With the training noise off both packages take one
``make_train_step`` step from step 1, twice: with ``use_pallas`` off and
the unchunked loss (KD against injected teacher logits plus a CE mix), and
with ``use_pallas`` on (the reference's Pallas kernel in interpret mode,
the port's plain version of ``analog_matmul``) and the chunked loss (a
small ``vocab_chunk``: the LM heads per sequence chunk, KD against a
teacher's weights run inside the step); each reference step is a compile
of its own, so the two settings are paired rather than crossed. Held: the
loss and every metric, every gradient leaf (the projector's and the
codebook table's included), and after the step every parameter, the Adam
moments and the updated ``input_range``s (the projector's among them).

The reference's chunked loss takes audio labels ``[B, S, K]`` through its
padding but its CE term cannot broadcast the ``[B, S]`` mask onto them, so
chunked audio CE raises in both packages (pinned below) and the chunked
audio case trains on KD alone.

Tolerance: ``TOL`` = 1e-5 · (1 + |ref|), as ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_families import (METRICS, TOL, _lr, _port_batch,
                                       _ref_flat, _under, close, ref_model)

from repro.configs import get_config
from repro.core.analog import AnalogConfig as RefAnalogConfig
from repro.optim.schedule import polynomial_with_warmup as ref_sched
from repro.train import train_step as ref_ts
from repro_torch.checkpoint import (flatten_paths, params_from_numpy,
                                    unflatten_paths)
from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.launch import train as train_cli
from repro_torch.models import apply as port_apply
from repro_torch.models import transformer as T
from repro_torch.train import distill as port_distill
from repro_torch.train import train_step as ts


ARCHS = ["internvl2-2b", "musicgen-medium"]
B, S = 2, 6
#: the chunked loss: vocab 256 >= 4 x 4, so it applies; S (plus the vlm's
#: 8 patch tokens) is not a multiple of it, so the last chunk is padded
CHUNK = 4
ACFG = dict(mode="analog", train_noise=False, init_steps=3, alpha_clip=2.5,
            range_decay=0.05, kappa_init=18.0, out_bound=14.0)
TCFG = dict(peak_lr=1e-3, total_steps=20, kd_temperature=2.0, kd_beta=1.0,
            ce_weight=0.5, remat=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this module runs (the xdist workers share
    the machine), the caller's count restored after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    kdim = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1) + kdim).astype(
        np.int32)
    s_out = S + (cfg.vit_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "teacher_logits": (2.0 * rng.standard_normal(
                 (B, s_out) + kdim + (cfg.vocab_size,))).astype(np.float32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.vit_tokens, cfg.vit_dim)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg, reference params / labels / teacher, port params / labels /
    teacher, the batch as numpy)."""
    cfg = get_config(request.param).reduce()
    params, labels = ref_model(cfg, 0)
    teacher, _ = ref_model(cfg, 1)
    pp = params_from_numpy(_ref_flat(params), "cpu")
    pt = params_from_numpy(_ref_flat(teacher), "cpu")
    return (cfg, params, labels, teacher, pp, T.model_labels(pp, cfg), pt,
            _batch(cfg))


def _cfgs(cfg, use_pallas: bool, chunked: bool):
    tcfg = dict(TCFG, vocab_chunk=CHUNK if chunked else 0)
    if chunked and cfg.family == "audio":
        tcfg["ce_weight"] = 0.0
    return (dict(ACFG, use_pallas=use_pallas), tcfg)


def reference_step(model, use_pallas: bool, chunked: bool) -> dict:
    """The reference's loss, metrics and gradients, then one jitted step
    from step 1 (the chunked case with the teacher's weights), as numpy."""
    cfg, params, labels, teacher, *_, batch = model
    acfg, tcfg = _cfgs(cfg, use_pallas, chunked)
    racfg, rtcfg = RefAnalogConfig(**acfg), ref_ts.TrainConfig(**tcfg)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if not (chunked and k == "teacher_logits")}
    t_args = (teacher,) if chunked else ()
    step = ref_ts.make_train_step(
        cfg, racfg, rtcfg, labels, lambda s: ref_sched(
            s, peak_lr=TCFG["peak_lr"], total_steps=TCFG["total_steps"]),
        with_teacher=chunked)
    loss_fn = ref_ts.make_loss_fn(cfg, racfg, rtcfg)

    def both(params, state, key, *t):
        vg = jax.value_and_grad(loss_fn, has_aux=True)(params, rbatch, key,
                                                       *t)
        return vg, step(params, state, rbatch, key, *t)

    state = dict(ref_ts.init_train_state(params),
                 step=jnp.ones((), jnp.int32))
    ((loss, (_, metrics)), grads), (p1, s1, m1) = jax.jit(both)(
        params, state, jax.random.PRNGKey(0), *t_args)
    out = {"loss": loss,
           **{f"metric/{k}": v for k, v in metrics.items()},
           **{f"grad/{k}": v for k, v in _ref_flat(grads).items()},
           **{f"step/{k}": m1[k] for k in METRICS if k in m1},
           "step": s1["step"], "count": s1["opt"]["count"]}
    for name, tree in (("params", p1), ("m", s1["opt"]["m"]),
                       ("v", s1["opt"]["v"])):
        out.update({f"{name}/{k}": v for k, v in _ref_flat(tree).items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("use_pallas,chunked", [(False, False),
                                                (True, True)],
                         ids=["unfused-unchunked", "fused-chunked"])
def test_train_step_matches_the_reference(model, use_pallas, chunked):
    cfg, *_, pp, plabels, pt, batch = model
    ref = reference_step(model, use_pallas, chunked)
    acfg, tcfg = _cfgs(cfg, use_pallas, chunked)
    pacfg, ptcfg = AnalogConfig(**acfg), ts.TrainConfig(**tcfg)
    pbatch = _port_batch({k: v for k, v in batch.items()
                          if not (chunked and k == "teacher_logits")})
    teacher = pt if chunked else None

    leaves = {p: v.detach().clone().requires_grad_(True)
              for p, v in flatten_paths(pp).items()}
    loss, (_, metrics) = ts.make_loss_fn(cfg, pacfg, ptcfg)(
        unflatten_paths(leaves), pbatch, (0,), teacher)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    close(loss, ref["loss"], what="loss")
    assert set(metrics) == {k[len("metric/"):] for k in ref
                            if k.startswith("metric/")}
    for name, v in metrics.items():
        close(v, ref[f"metric/{name}"], what=name)
    r_grads = _under(ref, "grad/")
    assert set(r_grads) == set(leaves)
    for (path, v), g in zip(leaves.items(), gs):
        close(torch.zeros_like(v) if g is None else g, r_grads[path],
              what=path)
    # the family's own leaves learn
    own = ("projector/kernel" if cfg.family == "vlm"
           else "embed/codebooks")
    g_own = dict(zip(leaves, gs))[own]
    assert g_own is not None and bool(g_own.abs().sum() > 0)

    p_step = ts.make_train_step(cfg, pacfg, ptcfg, plabels, _lr)
    p_s = dict(ts.init_train_state(pp), step=torch.ones((), dtype=torch.int32))
    p_p, p_s, p_m = p_step(pp, p_s, pbatch, (0,), teacher)
    for name in METRICS:
        if f"step/{name}" in ref:
            close(p_m[name], ref[f"step/{name}"], what=f"step {name}")
    assert int(p_s["step"]) == int(ref["step"]) == 2
    assert int(p_s["opt"]["count"]) == int(ref["count"]) == 1
    for tree_p, what in ((p_p, "params"), (p_s["opt"]["m"], "m"),
                         (p_s["opt"]["v"], "v")):
        r_flat = _under(ref, what + "/")
        assert set(r_flat) == set(flatten_paths(tree_p))
        for path, v in flatten_paths(tree_p).items():
            close(v, r_flat[path], what=f"{what} {path}")
    # every range took the EMA rule, the projector's too
    for path, v in flatten_paths(p_p).items():
        if path.endswith("input_range"):
            assert not torch.equal(v, flatten_paths(pp)[path]), path


def test_align_vlm_labels_and_audio_ce(model):
    """``_align_vlm_labels`` and the audio ``[B, S, K, V]`` losses against
    the reference's, and the chunked audio CE refused by both."""
    cfg, params, *_, batch = model
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = _port_batch(batch)
    for with_mask in (False, True):
        if with_mask:
            m = np.ones(batch["labels"].shape[:2], np.float32)
            m[:, -2:] = 0
            rbatch["mask"], pbatch["mask"] = jnp.asarray(m), torch.tensor(m)
        r_lab, r_mask = ref_ts._align_vlm_labels(cfg, rbatch)
        p_lab, p_mask = ts._align_vlm_labels(cfg, pbatch)
        np.testing.assert_array_equal(p_lab.numpy(), np.asarray(r_lab))
        if r_mask is None:
            assert p_mask is None
        else:
            np.testing.assert_array_equal(p_mask.numpy(), np.asarray(r_mask))
    if cfg.family != "audio":
        return
    from repro.train import distill as ref_distill
    rng = np.random.default_rng(4)
    lg = rng.standard_normal((B, S, cfg.num_codebooks, cfg.vocab_size)
                             ).astype(np.float32)
    tl = rng.standard_normal(lg.shape).astype(np.float32)
    lab = batch["labels"]
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    close(port_distill.kd_loss(torch.tensor(lg), torch.tensor(tl), 2.0,
                               torch.tensor(mask)),
          ref_distill.kd_loss(jnp.asarray(lg), jnp.asarray(tl), 2.0,
                              jnp.asarray(mask)), what="kd")
    close(port_distill.ce_loss(torch.tensor(lg), torch.tensor(lab).long()),
          ref_distill.ce_loss(jnp.asarray(lg), jnp.asarray(lab)), what="ce")
    with pytest.raises(ValueError):
        ref_distill.ce_loss(jnp.asarray(lg), jnp.asarray(lab),
                            jnp.asarray(mask))
    with pytest.raises(RuntimeError):
        port_distill.ce_loss(torch.tensor(lg), torch.tensor(lab).long(),
                             torch.tensor(mask))


def test_forward_trains_and_cli_follows_the_reference(model, capsys):
    """A training forward runs for the family (stats at the family's own
    sites), and the training CLI does what the reference's does: it trains
    the vlm on text (its corpus has no patch embeddings) and refuses the
    audio family's two-dimensional corpus tokens."""
    cfg, *_, pp, _, _, batch = model
    inputs = {k: torch.from_numpy(batch[k]) for k in ("tokens",
                                                       "patch_embeds")
              if k in batch}
    inputs["tokens"] = inputs["tokens"].long()
    logits, stats, _ = port_apply(
        pp, cfg, AnalogConfig(mode="analog"),
        AnalogCtx(key=(3,), training=True, collect_stats=True), inputs)
    assert bool(torch.isfinite(logits).all())
    if cfg.family == "vlm":
        assert float(stats["projector"]["x_std"]) > 0
    argv = ["--arch", cfg.name.removesuffix("-smoke"), "--reduced",
            "--device", "cpu", "--steps", "2", "--pretrain-steps", "2",
            "--batch", "2", "--seq", "8"]
    if cfg.family == "audio":
        with pytest.raises(ValueError, match="tokens \\[B, S, K\\]"):
            train_cli.main(argv)
        return
    trainer = train_cli.main(argv)
    assert int(trainer.state["step"]) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "final KD loss" in capsys.readouterr().out
