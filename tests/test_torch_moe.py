"""The port's moe family (``repro_torch.models.moe`` and the FFN dispatch of
``models.transformer``) and the batched expert launch of the MVM kernels,
against the JAX package on reduced qwen3-moe-30b-a3b and dbrx-132b.

Weights are built by the reference and carried across as numpy; the hw
noise instance of ``analog_hw`` is drawn by the reference and applied on
both sides. Tolerances:

* the MoE forward, its stats tree and the model's logits: ``rtol = atol =
  1e-5`` (the reference's own bar for fused against unfused forwards);
  routing ids and capacity slots exactly;
* batched plain versions against a per-expert loop of the 2-D ones: ADC
  outputs by ``assert_adc_parity`` (one level at a near-tie, under 1e-4 of
  the outputs), the int4 product within 1e-5;
* prefill + decode against the full forward: 5e-4, the reference's bar in
  ``tests/test_decode.py``, with its no-drop capacity (capacity dropping
  legitimately breaks prefix equivalence when sequence lengths differ);
* engines: greedy tokens equal, paged and contiguous, under the reference
  scheduler tests' no-drop capacity.

The invariants of ``tests/test_moe.py`` (capacity formula, no drops equal
the dense expert sum, monotone dropping, permutation equivariance, finite
output) are held for the port on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity

from repro.configs import get_config
from repro.core import analog as RA
from repro.models import apply as ref_apply
from repro.models import build as ref_build
from repro.models import moe as RM
from repro.serve import scheduler as RS
from repro.serve.decode import generate as ref_generate
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ArchConfig
from repro_torch.core import analog as PA
from repro_torch.kernels import dispatch, ref
from repro_torch.models import apply as port_apply
from repro_torch.models import build as port_build
from repro_torch.models import moe as PM
from repro_torch.models import transformer as T
from repro_torch.serve import decode as port_decode
from repro_torch.serve import scheduler as PS

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
REF_EVAL = RA.AnalogCtx(key=None, training=False)
MODES = ["off", "analog", "rtn", "qat", "di8"]


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _port_flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v.detach().cpu().numpy()
    return out


def _no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(cfg, reference params / labels / hw instance, port params /
    instance)."""
    cfg = get_config(request.param).reduce()
    cfg, params, labels = ref_build(cfg, jax.random.PRNGKey(0))
    inst = RA.sample_noise_instances(params, labels, jax.random.PRNGKey(1),
                                     "hw")
    return (cfg, params, labels, inst,
            params_from_numpy(_ref_flat(params), "cpu"),
            params_from_numpy(_ref_flat(inst), "cpu"))


def _deploy(carried, deploy):
    """Reference (params, acfg) and port (params, acfg) of a deployment."""
    cfg, params, labels, inst, pp, pinst = carried
    plabels = T.model_labels(pp, cfg)
    if deploy == "analog_hw":
        return (RA.apply_noise_instances(params, labels, inst, "hw"),
                RA.AnalogConfig(mode="analog", train_noise=False),
                PA.apply_noise_instances(pp, plabels, pinst, "hw"),
                PA.AnalogConfig(mode="analog", train_noise=False))
    if deploy == "digital_int4":
        return (params, RA.AnalogConfig(mode="rtn", weight_bits=4),
                PA.pack_int4_weights(pp, plabels),
                port_decode.digital_int4_config(
                    PA.AnalogConfig(weight_bits=4)))
    return (params, RA.AnalogConfig(mode=deploy), pp,
            PA.AnalogConfig(mode=deploy))


@pytest.fixture(scope="module")
def deployed(carried):
    """:func:`_deploy` of ``carried``, each deployment made once per model
    and shared by the tests that use it."""
    made = {}

    def get(deploy):
        if deploy not in made:
            made[deploy] = _deploy(carried, deploy)
        return made[deploy]
    return get


@pytest.fixture(scope="module")
def ref_logits(carried, deployed):
    """The reference's logits of each deployment on the forward tests'
    tokens, computed once per model (the fused and unfused cases of the
    port hold themselves against the same reference forward)."""
    made = {}

    def get(deploy):
        if deploy not in made:
            rp, racfg, _, _ = deployed(deploy)
            toks = _tokens(carried[0], 2, 12, seed=1)
            made[deploy] = (toks, ref_apply(rp, carried[0], racfg, REF_EVAL,
                                            {"tokens": jnp.asarray(toks)})[0])
        return made[deploy]
    return get


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _layer(tree, i=0):
    """Layer ``i`` of a stacked ``blocks/ffn`` tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# tests/test_moe.py, for the port
# ---------------------------------------------------------------------------

def _cfg(e=4, k=2, cf=8.0):
    return dataclasses.replace(get_config("dbrx-132b").reduce(),
                               num_experts=e, top_k=k, capacity_factor=cf)


def _moe_params(cfg, seed):
    return PM.init_moe(torch.Generator().manual_seed(seed), cfg)


def _run(p, x, cfg, acfg=PA.AnalogConfig(mode="off"), **ctx):
    return PM.moe(p, x, cfg, acfg, PA.AnalogCtx(**ctx))


@pytest.mark.parametrize("args", [(4096, 16, 4, 1.25), (1, 128, 8, 1.25),
                                  (32, 128, 8, 1.25), (1, 4, 2, 1.25),
                                  (12, 4, 2, 0.25), (16, 16, 4, 16.0)])
def test_moe_capacity_formula(args):
    assert PM.moe_capacity(*args) == RM.moe_capacity(*args)
    assert PM.moe_capacity(4096, 16, 4, 1.25) == 1280
    assert PM.moe_capacity(1, 128, 8, 1.25) == 1


@pytest.mark.parametrize("seed", [0, 1, 17, 4242, 9999])
def test_moe_output_finite_and_shaped(seed):
    cfg = _cfg()
    p = _moe_params(cfg, seed)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    y, stats = _run(p, x, cfg)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    assert float(stats["router"]["aux_loss"]) >= 0.99   # >= 1 at optimum


def test_moe_no_drop_equals_dense_expert_sum():
    """With capacity >= S*k the dispatch reproduces the dense weighted sum
    over the selected experts."""
    cfg = _cfg(e=4, k=2, cf=100.0)
    p = _moe_params(cfg, 0)
    x = torch.randn((1, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    y, _ = _run(p, x, cfg)
    probs = torch.softmax(x[0] @ p["router"]["kernel"], -1)
    w, ids = torch.topk(probs, cfg.top_k)
    w = w / w.sum(-1, keepdim=True)
    outs = []
    for e in range(cfg.num_experts):
        g, u = torch.chunk(x[0] @ p["gate_up"]["kernel"][e], 2, -1)
        outs.append((torch.nn.functional.silu(g) * u)
                    @ p["down"]["kernel"][e])
    outs = torch.stack(outs, 1)                          # [S, E, d]
    want = torch.einsum("sk,skd->sd", w,
                        torch.gather(outs, 1, ids[..., None].expand(
                            -1, -1, cfg.d_model)))
    np.testing.assert_allclose(y[0].numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_capacity_dropping_monotone():
    """A tiny capacity drops assignments (less output energy); raising it
    only adds expert contributions."""
    small, big = _cfg(e=4, k=2, cf=0.25), _cfg(e=4, k=2, cf=100.0)
    p = _moe_params(big, 1)
    x = torch.randn((1, 32, big.d_model),
                    generator=torch.Generator().manual_seed(1))
    y_small, _ = _run(p, x, small)
    y_big, _ = _run(p, x, big)
    assert float(y_small.norm()) < float(y_big.norm())


def test_moe_permutation_equivariance_without_drops():
    cfg = _cfg(e=4, k=2, cf=100.0)
    p = _moe_params(cfg, 2)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, 16, cfg.d_model), generator=gen)
    perm = torch.randperm(16, generator=gen)
    y1, _ = _run(p, x, cfg)
    y2, _ = _run(p, x[:, perm], cfg)
    np.testing.assert_allclose(y1[:, perm].numpy(), y2.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_training_is_refused():
    """Nothing of a MoE layer refuses training any more (the batched
    site's STE backward and the router's gradient are ported; the values
    are held against the reference in ``test_torch_train_ops.py``): the
    layer, a batched ``analog_linear`` site and the fused batched MVM each
    run a training forward whose backward reaches the input, the experts
    and the router, and the fused forward alone still runs without
    autograd."""
    cfg = _cfg()
    p = {k: {kk: v.clone().requires_grad_(True) for kk, v in site.items()}
         for k, site in _moe_params(cfg, 0).items()}
    x = torch.randn((1, 4, cfg.d_model), requires_grad=True)
    y, st = _run(p, x, cfg, PA.AnalogConfig(mode="analog"), training=True,
                 key=(1,))
    (y.sum() + st["router"]["aux_loss"]).backward()
    for g in (x.grad, p["router"]["kernel"].grad, p["gate_up"]["kernel"].grad,
              p["down"]["kernel"].grad, p["down"]["input_range"].grad):
        assert g is not None and bool(torch.isfinite(g).all())
    assert bool(p["router"]["kernel"].grad.abs().sum() > 0)
    xe = x.detach().expand(4, 4, -1).clone().requires_grad_(True)
    ys, _ = PA.analog_linear(p["gate_up"], xe, PA.AnalogConfig(mode="analog"),
                             PA.AnalogCtx(training=True))
    ys.sum().backward()
    assert xe.grad.shape == xe.shape
    w = p["gate_up"]["kernel"].detach().clone().requires_grad_(True)
    beta = p["gate_up"]["input_range"]
    bound = ref.adc_bound(w.detach(), beta.detach(), 12.0)
    yf = dispatch.fused_analog_mvm(xe, w, None, beta, bound)
    yf.sum().backward()
    assert w.grad.shape == w.shape and bool(w.grad.abs().sum() > 0)
    with torch.no_grad():       # the forward alone runs
        y = dispatch.fused_analog_mvm(x.expand(4, 4, -1), w, None,
                                      p["gate_up"]["input_range"], lam=12.0)
    assert y.shape == (4, 4, 2 * cfg.d_ff)


# ---------------------------------------------------------------------------
# the MoE layer against the reference
# ---------------------------------------------------------------------------

def _ref_route(x, p, cfg, capacity):
    """The reference's routing of one sequence, op for op
    (``moe._route_one_sequence``): ids, kept slots, and the order."""
    logits = jnp.matmul(x.astype(jnp.float32), p["router"]["kernel"])
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    counts = jnp.bincount(flat, length=cfg.num_experts)
    offsets = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat.shape[0]) - offsets[flat[order]]
    return (np.asarray(ids), np.asarray(order),
            np.asarray(jnp.where(pos < capacity, pos, capacity)))


@pytest.mark.parametrize("cf", [0.25, 1.25, 100.0], ids=["drops", "default",
                                                         "no-drop"])
def test_routing_matches_reference(carried, cf):
    cfg, params, _, _, pp, _ = carried
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    p_r, p_p = _layer(params["blocks"]["ffn"]), _layer(pp["blocks"]["ffn"])
    x = np.random.default_rng(0).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32)
    capacity = PM.moe_capacity(16, cfg.num_experts, cfg.top_k, cf)
    w, ids_p, row, order, aux = PM._route(torch.as_tensor(x),
                                          p_p["router"]["kernel"], cfg,
                                          capacity)
    b_, e_ = x.shape[0], cfg.num_experts
    drop = e_ * b_ * capacity
    for b in range(b_):
        ids, order_r, slot_r = _ref_route(jnp.asarray(x[b]), p_r, cfg,
                                          capacity)
        np.testing.assert_array_equal(ids_p[b].numpy(), ids)
        np.testing.assert_array_equal(order[b].numpy(), order_r)
        sorted_ids = ids.reshape(-1)[order_r]
        want = np.where(slot_r < capacity,
                        (sorted_ids * b_ + b) * capacity + slot_r, drop)
        np.testing.assert_array_equal(row[b].numpy(), want)
    # a kept assignment never shares its row; every drop goes to the spare
    kept = row[row < drop]
    assert kept.unique().numel() == kept.numel()
    assert bool((row <= drop).all())


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_moe_layer_and_stats_match_reference(carried, mode, use_pallas):
    """One MoE layer and its stats tree (per (sequence, expert), then the
    mean over experts and sequences) against ``repro.models.moe.moe``."""
    cfg, params, _, _, pp, _ = carried
    p_r, p_p = _layer(params["blocks"]["ffn"]), _layer(pp["blocks"]["ffn"])
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    ra = RA.AnalogConfig(mode=mode, use_pallas=use_pallas)
    pa = PA.AnalogConfig(mode=mode, use_pallas=use_pallas)
    y_r, st_r = RM.moe(p_r, jnp.asarray(x), cfg, ra,
                       RA.AnalogCtx(key=None, training=False,
                                    collect_stats=True))
    y_p, st_p = PM.moe(p_p, torch.as_tensor(x), cfg, pa,
                       PA.AnalogCtx(collect_stats=True))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    a, b = _ref_flat(st_r), _port_flat(st_p)
    assert sorted(a) == sorted(b)
    for path in a:
        np.testing.assert_allclose(b[path], a[path], err_msg=path, **TOL)
    if mode in ("analog", "rtn", "qat"):
        assert float(b["gate_up/x_absmax"]) > 0


def test_moe_fused_forward_parity():
    """``tests/test_kernel_dispatch.py``'s toy moe: the batched fused site
    (one launch per site) against the unfused one."""
    cfg = ArchConfig(name="toymoe", family="moe", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                     d_head=16, norm="rmsnorm", act="silu", num_experts=4,
                     top_k=2)
    cfg, params, _ = port_build(cfg, 1, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 2, 16, seed=1)).long()
    l0, _, _ = port_apply(params, cfg, PA.AnalogConfig(mode="analog"),
                          PA.AnalogCtx(), {"tokens": toks})
    l1, _, _ = port_apply(params, cfg,
                          PA.AnalogConfig(mode="analog", use_pallas=True),
                          PA.AnalogCtx(), {"tokens": toks})
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the batched plain versions against a per-expert loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 8, 33])
def test_batched_analog_matmul_ref_equals_per_expert(m):
    gen = torch.Generator().manual_seed(m)
    e, k, n = 5, 96, 40
    x = torch.randn((e, m, k), generator=gen)
    w = torch.randn((e, k, n), generator=gen) * k ** -0.5
    beta = torch.full((1,), 2.5)
    off = 0.05 * torch.randn((e, n), generator=gen)
    bound = ref.adc_bound(w, beta, 12.0)
    assert bound.shape == (e, n)
    for b_arg, lam in ((bound, None), (None, 12.0)):
        y = ref.analog_matmul_ref(x, w, beta, b_arg, off, lam=lam)
        assert y.shape == (e, m, n)
        for i in range(e):
            want = ref.analog_matmul_ref(x[i], w[i], beta, bound[i], off[i])
            assert_adc_parity(y[i].numpy(), want.numpy(),
                              (bound[i] / 127).numpy())
    # the CPU path of the dispatch layer, an [E, B, S, K] activation
    y4 = dispatch.analog_mvm(x.reshape(e, 1, m, k), w, beta, lam=12.0)
    np.testing.assert_array_equal(y4.reshape(e, m, n).numpy(),
                                  ref.analog_matmul_ref(x, w, beta,
                                                        lam=12.0).numpy())


@pytest.mark.parametrize("m", [1, 8, 20])
def test_batched_int4_matmul_ref_equals_per_expert(m):
    gen = torch.Generator().manual_seed(m)
    e, k, n = 3, 64, 48
    w_int = torch.randint(-7, 8, (e, k, n), generator=gen, dtype=torch.int8)
    packed = ref.pack_int4(w_int)
    assert packed.shape == (e, k, n // 2)
    np.testing.assert_array_equal(ref.unpack_int4(packed).numpy(),
                                  w_int.numpy())
    scale = torch.rand((e, n), generator=gen) + 0.5
    x = torch.randn((e, m, k), generator=gen)
    y = ref.int4_matmul_ref(x, packed, scale)
    yd = dispatch.int4_mvm_packed(x, packed, scale)
    np.testing.assert_array_equal(y.numpy(), yd.numpy())
    for i in range(e):
        want = ref.int4_matmul_ref(x[i], ref.pack_int4(w_int[i]), scale[i])
        np.testing.assert_allclose(y[i].numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the reduced models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
@pytest.mark.parametrize("deploy", ["off", "analog_hw", "rtn",
                                    "digital_int4"])
def test_forward_logits_match_reference(carried, deployed, ref_logits,
                                        deploy, use_pallas):
    cfg = carried[0]
    _, _, tp, tacfg = deployed(deploy)
    if deploy != "digital_int4":
        tacfg = dataclasses.replace(tacfg, use_pallas=use_pallas)
    toks, want = ref_logits(deploy)
    got, stats, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                               {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert stats["blocks"]["ffn"]["router"]["aux_loss"].shape == (
        cfg.num_layers,)


def test_labels_and_carry_over(carried):
    cfg, params, labels, _, pp, _ = carried
    assert T.model_labels(pp, cfg) == labels
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    ffn = pp["blocks"]["ffn"]
    assert ffn["gate_up"]["kernel"].shape == (cfg.num_layers, e, d, 2 * f)
    assert ffn["down"]["kernel"].shape == (cfg.num_layers, e, f, d)
    assert ffn["router"]["kernel"].shape == (cfg.num_layers, d, e)
    _, own, own_labels = port_build(cfg, 0, device="cpu")
    assert own_labels == labels
    assert {k: tuple(v.shape) for k, v in _port_flat(own).items()} == {
        k: v.shape for k, v in _ref_flat(params).items()}


@pytest.mark.parametrize("deploy", ["off", "digital_int4"])
def test_prefill_decode_equals_full_forward(carried, deployed, deploy):
    cfg = _no_drop(carried[0])
    _, _, tp, tacfg = deployed(deploy)
    b, s, sp = 2, 16, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2)).long()
    full, _, _ = port_apply(tp, cfg, tacfg, PA.AnalogCtx(), {"tokens": toks})
    caches = T.init_caches(cfg, b, s, device="cpu")
    pre, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                {"tokens": toks[:, :sp]}, caches=caches)
    errs = [float((pre - full[:, :sp]).abs().max())]
    for t in range(sp, s):
        lg, _, caches = port_apply(tp, cfg, tacfg, PA.AnalogCtx(),
                                   {"tokens": toks[:, t:t + 1]},
                                   caches=caches, pos_offset=t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_greedy_generate_matches_reference_tokens(carried, deployed,
                                                  deploy):
    cfg = carried[0]
    rp, racfg, tp, tacfg = deployed(deploy)
    prompt = _tokens(cfg, 3, 5, seed=3)
    want = ref_generate(rp, cfg, racfg, jax.random.PRNGKey(4),
                        jnp.asarray(prompt), 6, greedy_first=6)
    got = port_decode.generate(tp, cfg, tacfg, None,
                               torch.from_numpy(prompt).long(), 6,
                               greedy_first=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _prompt(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def _churn(cfg):
    """More requests than slots, mixed lengths, mid-decode admission."""
    return [dict(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                 max_new=4 + i % 3, temperature=0.0) for i in range(5)]


@pytest.mark.parametrize("deploy", ["off", "analog_hw", "digital_int4"])
def test_engine_matches_reference_paged_and_contiguous(carried, deployed,
                                                       deploy):
    """Greedy tokens of the port's engine, paged and per-slot contiguous,
    equal the reference engine's (no-drop capacity, as the reference's
    ``tests/test_scheduler.py`` builds its moe models)."""
    cfg = _no_drop(carried[0])
    rp, racfg, tp, tacfg = deployed(deploy)
    reqs = _churn(cfg)
    geo = dict(num_slots=2, max_len=32, prefill_chunk=4, kv_block_size=4)
    want = RS.ServeEngine(rp, cfg, racfg, RS.SchedulerConfig(
        prefix_cache=False, **geo)).run([RS.Request(**r) for r in reqs])
    for paged in (False, True):
        got = PS.ServeEngine(tp, cfg, tacfg, PS.SchedulerConfig(
            paged=paged, **geo)).run([PS.Request(**r) for r in reqs])
        assert sorted(got) == sorted(want)
        for uid in got:
            np.testing.assert_array_equal(got[uid], want[uid],
                                          err_msg=f"{uid} paged={paged}")


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_piggybacked_prefill_parity(carried, paged):
    """A multi-chunk prompt streamed in through fused mixed steps gives its
    solo tokens (``tests/test_scheduler.py``'s dbrx case, both layouts)."""
    cfg = _no_drop(carried[0])
    tp = carried[4]
    acfg = PA.AnalogConfig(mode="off")
    scfg = PS.SchedulerConfig(num_slots=3, max_len=48, prefill_chunk=4,
                              decode_block=4, paged=paged, kv_block_size=4)
    target = PS.Request(uid=99, prompt=_prompt(cfg, 11), max_new=6,
                        temperature=0.0)
    solo = PS.ServeEngine(tp, cfg, acfg, scfg).run([target])[99]
    eng = PS.ServeEngine(tp, cfg, acfg, scfg)
    for i in range(2):
        eng.submit(PS.Request(uid=i, prompt=_prompt(cfg, 3 + i, seed=i),
                              max_new=12, temperature=0.0))
    for _ in range(3):
        eng.step()
    assert eng.decode_steps > 0
    eng.submit(target)
    out = eng.run()
    np.testing.assert_array_equal(solo, out[99])
    assert sorted(out) == [0, 1, 99]
    assert eng.mixed_steps >= 3 and eng.decode_tokens_during_admission > 0
