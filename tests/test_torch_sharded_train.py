"""The port's sharded training state, on the CPU (every mesh position on
the CPU, as shards share one card in ``chip_smoke.py`` phase 25).

* (a) The train step under a placed mesh, at data 2 and 4 and at (2, 2)
  data x model, against the port's own unsharded step (which
  ``test_torch_train.py`` holds against the reference's), on reduced
  granite-3-8b (the reference's sharded config), qwen3-moe-30b-a3b and
  mamba2-130m, after 1 and 3 steps with the training noise on and a mask
  that gives the shards unequal token counts: the loss, ``grad_norm``,
  every parameter (the ``input_range``s among them) and both moments;
  also on a pod x data x model mesh, and with two microbatches (fused
  and unfused accumulation). Then one data-2 run against the reference's
  unsharded
  ``make_train_step`` at ``test_torch_train.py``'s tolerance.
* (b) A ``(1, 1)`` mesh gives the unsharded step bit for bit, with and
  without ``grad_compression``.
* (c) Placing then gathering every family's tree is bit-exact, and each
  position's slices hold ``launch.steps.device_bytes`` of the tree under
  the same specs.
* (d) ``elastic.reshard`` from data 4 to data 2 is value-exact; a step on
  the new mesh from the resharded state equals, bit for bit, the step
  from the gathered state placed afresh; a checkpoint written by a
  sharded run resumes unsharded, and one written unsharded resumes
  sharded, bit for bit.
* (e) ``shrink_batch_plan`` against the reference's.
* (f) ``psum_compressed`` against the reference's under ``jax.vmap`` with
  an axis name, bit for bit.
* (g) The summed gradient compressed slice by slice with the whole
  leaf's scale equals ``compress_grads`` of the whole gradient, bit for
  bit.
* (h) The training launcher on the host mesh, and ``--production-mesh``'s
  ``ValueError``.

Tolerance of (a): each gradient element is a sum over the batch's B · S =
48 token terms, which the sharded step adds in another order (each
shard's rows, then the shards in order), so it may move by up to 48 u (u =
2^-24) of its terms' magnitudes; an ``input_range``'s gradient sums over
every element of its site's input, K times as many. ``TOL = 48 u`` bounds
the loss, ``grad_norm`` and every parameter, the ``input_range``s among
them (``|a - b| <= TOL (1 + |b|)``: a range is set by the EMA init from
the pooled ``x_std``, a few u from the whole batch's, and AdamW moves it
by at most the learning rate); ``2 TOL`` (times K for an input range's
moments) bounds every moment leaf: ``v`` (which squares the gradient)
against its largest magnitude, ``m`` against ``(1 - b1)`` times the leaf's
largest RMS gradient ``sqrt(v / (1 - b2^t))``, the size of one step's part
of ``m`` (``m`` itself may cancel across steps). Measured largest, each
over its scale (an input range's moments divided by K): 6.0e-8
(parameters other than the ranges), 6.4e-8 (input ranges), 1.3e-6 (m),
1.6e-6 (v), 1.4e-7 (losses and ``grad_norm``), against TOL = 2.9e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.analog import AnalogConfig as RefAnalogConfig
from repro.distributed import elastic as ref_elastic
from repro.models import build as ref_build
from repro.optim import compression as ref_comp
from repro.optim.schedule import polynomial_with_warmup as ref_sched
from repro.train import train_step as ref_ts
from repro_torch.checkpoint import (flatten_paths, params_from_numpy,
                                    unflatten_paths)
from repro_torch.configs import get_config
from repro_torch.core.analog import AnalogConfig
from repro_torch.distributed import elastic, placement
from repro_torch.distributed import sharding as shd
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh, make_host_mesh, place_mesh
from repro_torch.launch.steps import device_bytes
from repro_torch.models import build
from repro_torch.models import transformer as T
from repro_torch.optim import compression
from repro_torch.optim.schedule import polynomial_with_warmup
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer

TOL = 48 * 2.0 ** -24
REF_TOL = 1e-5                  # test_torch_train.py's
B, S = 4, 12
ACFG = dict(mode="analog", init_steps=3, alpha_clip=2.5, range_decay=0.05,
            kappa_init=18.0, out_bound=14.0)
TCFG = dict(peak_lr=1e-3, total_steps=20, kd_temperature=2.0, kd_beta=1.0,
            ce_weight=0.5, remat=True)
KEY = (7,)
ARCHS = ("granite-3-8b", "qwen3-moe-30b-a3b", "mamba2-130m")
MESHES = ((2, 1), (4, 1), (2, 2))
FAMILY_ARCHS = ("llama-3.2-1b", "qwen3-moe-30b-a3b", "mamba2-130m",
                "jamba-v0.1-52b", "internvl2-2b", "musicgen-medium")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this module runs (the xdist workers share
    the machine), the caller's count restored after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _mesh(*sizes, names=("data", "model")):
    """A mesh of ``sizes`` with every position on the CPU."""
    n = int(np.prod(sizes))
    return place_mesh(Mesh(names, sizes), ["cpu"] * n)


def _lr(step):
    return polynomial_with_warmup(step, peak_lr=TCFG["peak_lr"],
                                  total_steps=TCFG["total_steps"])


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    mask[-1, :3] = 0.0                       # the last shard's count apart
    return {"tokens": torch.tensor(toks[:, :-1]),
            "labels": torch.tensor(toks[:, 1:]),
            "mask": torch.tensor(mask),
            "teacher_logits": torch.tensor((2.0 * rng.standard_normal(
                (B, S, cfg.vocab_size))).astype(np.float32))}


@pytest.fixture(scope="module")
def models():
    """``{arch: (cfg, params, labels)}`` of the reduced configs (built by
    the port from seed 0)."""
    return {a: build(get_config(a).reduce(), 0, device="cpu")
            for a in set(ARCHS) | {"llama-3.2-1b"}}


def _run(model, mesh, steps, *, compress=False, noise=True):
    """``steps`` steps of the port's step, under ``mesh`` (None:
    unsharded). Returns ``[(params, state, metrics)]`` gathered."""
    cfg, params, labels = model
    acfg = AnalogConfig(**ACFG, train_noise=noise)
    tcfg = ts.TrainConfig(**TCFG, grad_compression=compress)
    step = ts.make_train_step(cfg, acfg, tcfg, labels, _lr)
    p, st, out = params, ts.init_train_state(params, compress), []
    batch = _batch(cfg)
    for _ in range(steps):
        if mesh is None:
            p, st, m = step(p, st, batch, KEY)
        else:
            with shd.activate(mesh, shd.default_rules(mesh)):
                p, st, m = step(p, st, batch, KEY)
        out.append((placement.gather_tree(p), placement.gather_tree(st), m))
    return out


_BASE = {}


def _base(models, arch):
    if arch not in _BASE:
        _BASE[arch] = _run(models[arch], None, 3)
    return _BASE[arch]


def _rel(a, b):
    return float(((a.double() - b.double()).abs()
                  / (1 + b.double().abs())).max())


def _within(got, want, what):
    """(a)'s tolerance between two gathered runs' (params, state,
    metrics)."""
    (p, s, m), (p0, s0, m0) = got, want
    f0, fp = flatten_paths(p0), flatten_paths(p)

    def terms(path):
        if not path.endswith("input_range"):
            return 1
        return f0[path[:-len("input_range")] + "kernel"].shape[-2]
    for name in ("loss", "kd", "ce", "grad_norm"):
        assert _rel(m[name], m0[name]) <= TOL, (what, name)
    for path, v in f0.items():
        assert _rel(fp[path], v) <= TOL, (what, path)
    t = int(s0["opt"]["count"])
    b1, b2 = ts.AdamWConfig().b1, ts.AdamWConfig().b2
    fm, fv = flatten_paths(s["opt"]["m"]), flatten_paths(s["opt"]["v"])
    for path, v in flatten_paths(s0["opt"]["v"]).items():
        m_ref = flatten_paths(s0["opt"]["m"])[path]
        rms = float(v.double().abs().max() / (1 - b2 ** t)) ** 0.5
        for got_x, ref_x, scale in ((fm[path], m_ref, (1 - b1) * rms),
                                    (fv[path], v, float(v.abs().max()))):
            err = float((got_x.double() - ref_x.double()).abs().max())
            assert err <= 2 * TOL * terms(path) * scale, (what, path)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded(models, arch, shape):
    """(a): the sharded step at ``shape`` within TOL of the unsharded one
    after 1 and 3 steps."""
    runs = _run(models[arch], _mesh(*shape), 3)
    base = _base(models, arch)
    for k in (0, 2):
        _within(runs[k], base[k], f"{arch} {shape} step {k + 1}")
    # the statistics reached the ranges: the EMA init lifted them
    ranges = [v for p, v in flatten_paths(runs[0][0]).items()
              if p.endswith("input_range")]
    assert ranges and all(float(r.min()) > 3.0 for r in ranges)


def test_sharded_step_on_a_pod_mesh(models):
    """(a) on a 2 x 2 x 1 ``("pod", "data", "model")`` mesh: the batch
    splits over pod x data, four shards, within TOL after 1 and 3
    steps."""
    mesh = _mesh(2, 2, 1, names=("pod", "data", "model"))
    runs = _run(models["granite-3-8b"], mesh, 3)
    base = _base(models, "granite-3-8b")
    for k in (0, 2):
        _within(runs[k], base[k], f"pod step {k + 1}")


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_step_with_accumulation(models, fused):
    """(a) with ``accum_steps=2`` (one backward per microbatch, or one
    over the accumulated loss): data 2 splits each microbatch's rows,
    within TOL of the unsharded accumulated step."""
    cfg, params, labels = models["granite-3-8b"]
    tcfg = ts.TrainConfig(**TCFG, accum_steps=2, fused_accum=fused)
    step = ts.make_train_step(cfg, AnalogConfig(**ACFG, train_noise=True),
                              tcfg, labels, _lr)
    mb = {k: v.reshape(2, B // 2, *v.shape[1:])
          for k, v in _batch(cfg).items()}
    want = step(params, ts.init_train_state(params), mb, KEY)
    mesh = _mesh(2, 1)
    with shd.activate(mesh, shd.default_rules(mesh)):
        p, s, m = step(params, ts.init_train_state(params), mb, KEY)
    _within((placement.gather_tree(p), placement.gather_tree(s), m), want,
            f"accum fused={fused}")


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _close_ref(port, ref, what):
    p = port.detach().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    r = np.asarray(ref, np.float64)
    err = np.abs(p.astype(np.float64) - r)
    assert np.all(err <= REF_TOL * (1 + np.abs(r))), (what, float(err.max()))


def test_data2_step_matches_the_reference():
    """(a): two steps at data 2 against the reference's unsharded jitted
    step on the same weights and batch (the noise off, as
    ``test_torch_train.py`` compares them)."""
    cfg = ref_get_config("llama-3.2-1b").reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(_ref_flat(params), "cpu")
    batch = _batch(cfg)
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    r_step = jax.jit(ref_ts.make_train_step(
        cfg, RefAnalogConfig(**ACFG, train_noise=False),
        ref_ts.TrainConfig(**TCFG), labels,
        lambda s: ref_sched(s, peak_lr=TCFG["peak_lr"],
                            total_steps=TCFG["total_steps"])))
    p_step = ts.make_train_step(cfg, AnalogConfig(**ACFG, train_noise=False),
                                ts.TrainConfig(**TCFG),
                                T.model_labels(pp, cfg), _lr)
    mesh = _mesh(2, 1)
    r_p, r_s = params, ref_ts.init_train_state(params)
    p_p, p_s = pp, ts.init_train_state(pp)
    for _ in range(2):
        r_p, r_s, r_m = r_step(r_p, r_s, rbatch, jax.random.PRNGKey(0))
        with shd.activate(mesh, shd.default_rules(mesh)):
            p_p, p_s, p_m = p_step(p_p, p_s, batch, (0,))
        for name in ("loss", "kd", "ce", "grad_norm", "lr"):
            _close_ref(p_m[name], r_m[name], name)
    whole_p, whole_s = placement.gather_tree(p_p), placement.gather_tree(p_s)
    for tree_p, tree_r, what in ((whole_p, r_p, "params"),
                                 (whole_s["opt"]["m"], r_s["opt"]["m"], "m"),
                                 (whole_s["opt"]["v"], r_s["opt"]["v"], "v")):
        r_flat = _ref_flat(tree_r)
        for path, v in flatten_paths(tree_p).items():
            _close_ref(v, r_flat[path], f"{what} {path}")


@pytest.mark.parametrize("compress", [False, True])
def test_mesh_1x1_is_the_unsharded_step(models, compress):
    """(b): a (1, 1) mesh gives the unsharded step bit for bit, every
    metric, parameter, moment and error-feedback leaf, over 3 steps."""
    model = models["llama-3.2-1b"]
    runs = _run(model, _mesh(1, 1), 3, compress=compress)
    base = _run(model, None, 3, compress=compress)
    for (p, s, m), (p0, s0, m0) in zip(runs, base):
        for name in m0:
            assert torch.equal(m[name], m0[name]), name
        for a, b in ((p, p0), (s["opt"], s0["opt"]),
                     (s.get("err", {}), s0.get("err", {}))):
            fa, fb = flatten_paths(a), flatten_paths(b)
            assert fa.keys() == fb.keys()
            for path in fb:
                assert torch.equal(fa[path], fb[path]), path


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_place_then_gather_is_exact(arch):
    """(c): every family's reduced tree (and its moments) placed by its
    ZeRO and tensor-parallel specs on data x model and pod x data x model
    meshes, then gathered, equals itself bit for bit; each position holds
    ``device_bytes`` of it under the same specs, in slices of the spec's
    shape."""
    cfg, params, _ = build(get_config(arch).reduce(), 0, device="cpu")
    for mesh in (_mesh(2, 2), _mesh(4, 1),
                 _mesh(2, 2, 2, names=("pod", "data", "model"))):
        for zero in (True, False):
            placed = placement.place_by(params, mesh, zero=zero)
            with shd.activate(mesh, shd.default_rules(mesh)):
                specs = placement.specs_for(params, zero=zero)
            want = device_bytes(params, specs, mesh)
            assert placement.position_bytes(placed) == [want] * mesh.size
            back = placement.gather_tree(placed)
            flat_s = flatten_paths(specs)
            for path, v in flatten_paths(params).items():
                leaf = flatten_paths(placed)[path]
                assert torch.equal(flatten_paths(back)[path], v), path
                if not isinstance(leaf, placement.Placed):
                    assert v.dim() == 0
                    continue
                grid = [shd._axis_size(mesh, ax) for ax in
                        tuple(flat_s[path]) + (None,) * (
                            v.dim() - len(flat_s[path]))]
                for part in leaf.parts:
                    assert list(part.shape) == [n // g for n, g in
                                                zip(v.shape, grid)], path
    # a split on two dimensions exists in these trees (data x model)
    with shd.activate(_mesh(2, 2), shd.default_rules(_mesh(2, 2))):
        two = [s for s in flatten_paths(shd.zero_spec_tree(params)).values()
               if sum(ax is not None for ax in s) == 2]
    assert two or arch == "mamba2-130m"


def test_reshard_and_resume(models, tmp_path):
    """(d): reshard 4 → 2 is value-exact; the next step on data 2 from
    it equals the step from the gathered state placed afresh, bit for
    bit; checkpoints cross between sharded and unsharded runs bit for
    bit."""
    cfg, params, labels = models["granite-3-8b"]
    acfg, tcfg = AnalogConfig(**ACFG, train_noise=True), ts.TrainConfig(**TCFG)
    step = ts.make_train_step(cfg, acfg, tcfg, labels, _lr)
    batch = _batch(cfg)
    m4, m2 = _mesh(4, 1), _mesh(2, 1)
    p, st = params, ts.init_train_state(params)
    with shd.activate(m4, shd.default_rules(m4)):
        for _ in range(2):
            p, st, _ = step(p, st, batch, KEY)
    tree = {"params": p, "state": st}
    moved = elastic.reshard(tree, m2)
    whole = placement.gather_tree(tree)
    for path, v in flatten_paths(whole).items():
        got = flatten_paths(placement.gather_tree(moved))[path]
        assert torch.equal(got, v), path
    leaf = moved["params"]["blocks"]["attn"]["qkv"]["kernel"]
    assert isinstance(leaf, placement.Placed) and leaf.mesh == m2
    fresh = placement.place_by(whole, m2)
    outs = []
    with shd.activate(m2, shd.default_rules(m2)):
        for t in (moved, fresh):
            outs.append(step(t["params"], t["state"], batch, KEY))
    (pa, sa, ma), (pb, sb, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"])
    for a, b in ((pa, pb), (sa["opt"], sb["opt"])):
        fa = flatten_paths(placement.gather_tree(a))
        for path, v in flatten_paths(placement.gather_tree(b)).items():
            assert torch.equal(fa[path], v), path

    # checkpoints: written sharded, resumed unsharded, and back
    for src, dst in ((m2, None), (None, m2)):
        d = tmp_path / f"{src is None}"
        writer = Trainer(step, params, ts.init_train_state(params),
                         ckpt_dir=str(d), ckpt_every=0, log_every=0)
        with (shd.activate(src, shd.default_rules(src)) if src
              else _null()):
            writer.fit(iter([batch] * 2), 2)
        saved = placement.gather_tree({"params": writer.params,
                                       "state": writer.state})
        reader = Trainer(step, params, ts.init_train_state(params),
                         ckpt_dir=str(d), ckpt_every=0, log_every=0)
        with (shd.activate(dst, shd.default_rules(dst)) if dst
              else _null()):
            reader.try_resume()
            got = {"params": reader.params, "state": reader.state}
            for path, v in flatten_paths(saved).items():
                assert torch.equal(flatten_paths(got)[path], v), path
            reader.ckpt_dir = None
            reader.fit(iter([batch]), 1)
        writer.ckpt_dir = None
        with (shd.activate(dst, shd.default_rules(dst)) if dst
              else _null()):
            writer.fit(iter([batch]), 1)
        fa = flatten_paths(placement.gather_tree(reader.params))
        for path, v in flatten_paths(placement.gather_tree(
                writer.params)).items():
            assert torch.equal(fa[path], v), path


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_shrink_batch_plan_matches_the_reference():
    """(e): every (global batch, old, new) of a grid, the ValueError and
    assertion cases included."""
    seen = set()
    for g in range(1, 33):
        for old in (1, 2, 3, 4, 8, 16):
            for new in (1, 2, 3, 4, 5, 6, 7, 8, 16, 64):
                outs = []
                for fn in (ref_elastic.shrink_batch_plan,
                           elastic.shrink_batch_plan):
                    try:
                        outs.append(fn(g, old, new))
                    except (ValueError, AssertionError) as e:
                        outs.append(type(e))
                assert outs[0] == outs[1], (g, old, new, outs)
                seen.add(outs[0] if isinstance(outs[0], type) else "ok")
    assert seen == {"ok", ValueError, AssertionError}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_psum_compressed_matches_the_reference(n):
    """(f): the reference's ``psum_compressed`` under ``jax.vmap`` over
    ``n`` stacked shards (one of them all zeros) against the port's over
    their list, bit for bit."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal((n, 5, 33)) * 10.0 ** rng.uniform(
        -3, 2, (n, 1, 1))).astype(np.float32)
    g[1] = 0.0
    want = jax.vmap(lambda x: ref_comp.psum_compressed(x, "d"),
                    axis_name="d")(jnp.asarray(g))
    got = compression.psum_compressed([torch.from_numpy(x) for x in g])
    for i in range(n):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_compressed_slices_equal_compress_grads(models, shape):
    """(g): an injected gradient and error state, placed by the ZeRO
    specs; each leaf compressed slice by slice with the whole leaf's
    scale equals ``compress_grads`` of the whole trees, bit for bit."""
    _, params, _ = models["granite-3-8b"]
    rng = np.random.default_rng(3)
    grads = {p: torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                  * 1e-3).astype(np.float32))
             for p, v in flatten_paths(params).items()}
    errs = {p: torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                 * 1e-5).astype(np.float32))
            for p, v in grads.items()}
    want_g, want_e = compression.compress_grads(unflatten_paths(grads),
                                                unflatten_paths(errs))
    mesh = _mesh(*shape)
    pg = flatten_paths(placement.place_by(unflatten_paths(grads), mesh))
    pe = flatten_paths(placement.place_by(unflatten_paths(errs), mesh))
    for path, leaf in pg.items():
        if not isinstance(leaf, placement.Placed):
            continue
        g, e = placement.map_leaf(compression.compress_slices, leaf,
                                  pe[path])
        assert torch.equal(placement.gather(g),
                           flatten_paths(want_g)[path]), path
        assert torch.equal(placement.gather(e),
                           flatten_paths(want_e)[path]), path


def test_launcher_host_mesh_and_production_mesh(capsys):
    """(h): the launcher trains on the host mesh (one CPU device: (1, 1));
    ``--production-mesh`` raises the mesh's ValueError naming 256 and the
    cards it found."""
    trainer = train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                              "--pretrain-steps", "2", "--batch", "4",
                              "--seq", "16"])
    assert int(trainer.state["step"]) == 2
    assert "[launch] mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert isinstance(flatten_paths(trainer.params)["embed/tokens"],
                      placement.Placed)
    with pytest.raises(ValueError, match=r"needs 256 devices, \d+ are "
                                         r"visible"):
        train_cli.main(["--production-mesh", "--device", "cpu"])
    assert make_host_mesh(devices=["cpu"] * 4).shape == {"data": 4,
                                                         "model": 1}
    with pytest.raises(ValueError, match="needs 4 devices, 2 were given"):
        place_mesh(Mesh(("data", "model"), (2, 2)), ["cpu"] * 2)
