"""The port's cost counter (``launch.cost_analysis``) against the JAX
package's HLO count, and against itself across devices.

* FLOP parity: for one reduced config of each family (jamba's with a
  super-block of 4 layers, ``CUTS``), the counted FLOPs of
  a prefill forward and of a KD train step (``accum_steps=2``, remat, the
  reference's ``build_cell`` defaults) equal
  ``repro.launch.hlo_analysis.analyze(...)["flops"]`` of the reference's
  compiled step within ``FLOP_TOL`` = 1%. Both sides are built by their
  ``launch.steps.build_cell`` at a small shape (B 4, S 64: attention below
  1024 tokens runs unchunked on both sides; above it the reference's
  static count includes the future KV chunks its ``lax.cond`` skips at run
  time, which the port never runs). The one difference that remains is
  named: under remat the ssm and hybrid families' recompute of
  ``ssd_scan`` counts the final state's product (2·B·H·S·N·P, the kernel
  writes the state), which XLA drops from its recompute as dead.
* Meta equals CPU: the counts of a step on meta tensors equal those of
  the same step on CPU tensors (FLOPs, bytes, every kernel entry and the
  peak bytes), with the kernels on (the wrappers' shape-only calls against
  their plain versions) and off, and on the paged pool.
* The meta path is no fallback: each of the five wrappers, given meta
  tensors, checks them as on the card, returns an empty result of the
  card's shape and dtype, is counted by its formula, and launches nothing
  (its launch counter stays put).
* The tensor-parallel gathers report their bytes as all-gathers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import hlo_analysis
from repro.launch import steps as rsteps
from repro_torch.configs import base as pbase
from repro_torch.configs import get_config
from repro_torch.core.analog import AnalogConfig, AnalogCtx, analog_linear
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import analog_matmul as km
from repro_torch.kernels import cost
from repro_torch.kernels import int4_matmul as k4
from repro_torch.kernels import paged_attention as kpd
from repro_torch.kernels import paged_prefill as kpp
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as kss
from repro_torch.launch import steps as psteps
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.train.train_step import init_train_state

torch.set_num_threads(2)

FLOP_TOL = 0.01
B, S = 4, 64
FAMILIES = {"dense": "llama-3.2-1b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-130m", "hybrid": "jamba-v0.1-52b",
            "vlm": "internvl2-2b", "audio": "musicgen-medium"}
META = torch.device("meta")
CPU = torch.device("cpu")
HOST1 = Mesh(("data", "model"), (1, 1))
COUNTED = ("flops", "hbm_bytes", "kernels", "peak_bytes")


#: jamba's reduced super-block cut from 8 layers to 4 (one attention
#: layer, three Mamba-2 mixers, MoE at the odd ones): the reference's
#: train step then compiles in half the time
CUTS = {"jamba-v0.1-52b": {"attn_every": 4}}


def _reduced_cfg(arch: str):
    return dataclasses.replace(get_config(arch),
                               **CUTS.get(arch, {})).reduce()


def _reduced(arch: str) -> dict:
    red = _reduced_cfg(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}


@pytest.fixture
def tiny(monkeypatch):
    """A ``tiny_<kind>`` cell of B x S in both packages' shape grids."""
    for kind in ("train", "prefill"):
        name = f"tiny_{kind}"
        monkeypatch.setitem(rsteps.SHAPES, name,
                            rbase.ShapeConfig(name, S, B, kind))
        monkeypatch.setitem(psteps.SHAPES, name,
                            pbase.ShapeConfig(name, S, B, kind))


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_flops_match_the_reference(family, kind, tiny):
    arch = FAMILIES[family]
    over = _reduced(arch)
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    plan = rsteps.build_cell(arch, f"tiny_{kind}", rmesh, accum_steps=2,
                             arch_overrides=over)
    want = hlo_analysis.analyze(plan.lower().compile().as_text())["flops"]
    got, _ = psteps.build_cell(arch, f"tiny_{kind}", HOST1, accum_steps=2,
                               arch_overrides=over).analyze()
    assert abs(got["flops"] - want) <= FLOP_TOL * want, (got["flops"], want)
    if family in ("ssm", "hybrid") and kind == "train":
        # the named difference: each ssd_scan recompute's final state
        cfg = _reduced_cfg(arch)
        mixers = (cfg.num_layers if family == "ssm"
                  else cfg.num_layers // cfg.attn_every
                  * (cfg.attn_every - 1))
        per = 2.0 * (B // 2) * cfg.ssm_heads * S * cfg.ssm_state \
            * cfg.ssm_headdim
        assert got["flops"] - want == 2 * mixers * per
    else:
        assert got["flops"] == want


def _cpu_args(args, gen):
    """The plan's meta arguments as CPU tensors: parameters and
    activations drawn small and positive where a range must be, ids and
    cursors zero."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return t
        if t.dtype.is_floating_point:
            return (torch.rand(t.shape, generator=gen) * 0.1 + 0.01).to(
                t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return conv(args)


def _counts(fn, *args):
    with CostCounter() as cc:
        fn(*args)
    a = cc.analyze()
    return {k: a[k] for k in COUNTED}


@pytest.mark.parametrize("arch,kind,pallas", [
    ("llama-3.2-1b", "prefill", False), ("llama-3.2-1b", "prefill", True),
    ("llama-3.2-1b", "train", True), ("mamba2-130m", "train", True),
    ("qwen3-moe-30b-a3b", "prefill", True)])
def test_meta_counts_equal_cpu_counts(arch, kind, pallas, tiny):
    acfg = AnalogConfig(mode="analog", use_pallas=pallas)
    plan = psteps.build_cell(arch, f"tiny_{kind}", HOST1, accum_steps=2,
                             arch_overrides=_reduced(arch), acfg=acfg,
                             dtype=torch.float32)
    meta = _counts(plan.fn, *plan.args)
    gen = torch.Generator().manual_seed(0)
    cpu_args = _cpu_args(plan.args, gen)
    if kind == "train":         # the train state's host step, as built
        cpu_args = (cpu_args[0], init_train_state(cpu_args[0]),
                    *cpu_args[2:])
    cpu = _counts(plan.fn, *cpu_args)
    assert cpu == meta
    if pallas and arch == "llama-3.2-1b":
        cfg = get_config(arch).reduce()
        per_fwd = 4 * cfg.num_layers + 1
        calls = {"prefill": per_fwd,
                 # 2 microbatches: the forward, the layers' recompute
                 "train": 2 * (per_fwd + 4 * cfg.num_layers)}[kind]
        assert meta["kernels"]["analog_matmul"]["calls"] == calls


@pytest.mark.parametrize("cols", [1, 8])
def test_paged_step_counts_equal_on_meta_and_cpu(cols):
    """A decode step (one column) and a chunk step of the continuous
    engine's forward on the paged pool, int8 and bf16 pools alike."""
    cfg = get_config("llama-3.2-1b").reduce()
    gen = torch.Generator().manual_seed(1)
    params, _ = T.init_model(gen, cfg, torch.float32, CPU)
    acfg = AnalogConfig(mode="analog", use_pallas=True)
    for kv_bits in (0, 8):
        counts = []
        for dev in (META, CPU):
            p = params if dev == CPU else T.init_model(None, cfg,
                                                       torch.float32, META)[0]
            caches = T.init_caches(cfg, 2, 64, torch.float32, dev,
                                   paged=True, kv_bits=kv_bits)
            tokens = torch.zeros((2, cols), dtype=torch.long, device=dev)
            pos = caches["pos"][0][:, None]
            counts.append(_counts(
                lambda: T.forward(p, cfg, acfg, AnalogCtx(),
                                  {"tokens": tokens}, caches=caches,
                                  pos_offset=pos)))
        name = "paged_flash_decode" if cols == 1 else "paged_flash_prefill"
        # the attended work needs the cursors' values: the CPU's calls
        # report it, the meta device's cannot
        meta_k, cpu_k = counts[0]["kernels"][name], counts[1]["kernels"][name]
        assert meta_k.pop("attended_flops") is None
        assert meta_k.pop("attended_bytes") is None
        att = cost.paged_work(
            torch.empty((2, cols, cfg.num_heads, cfg.head_dim)),
            caches["kp"][0], caches["tbl"][0], caches["pos"][0],
            caches["start"][0])
        assert cpu_k.pop("attended_flops") == cfg.num_layers * att[0]
        assert cpu_k.pop("attended_bytes") == cfg.num_layers * att[1]
        assert counts[0] == counts[1]
        assert counts[0]["kernels"][name]["calls"] == cfg.num_layers


def _wrapper_calls(dev, gen):
    """One call of each kernel wrapper on ``dev``: ``(name, thunk,
    (flops, bytes) of the formula, result shape, the paged calls'
    attended (flops, bytes) by hand)``."""
    def rnd(*shape, dtype=torch.float32):
        t = torch.randn(shape, generator=gen)
        return t.to(dtype).to(dev)

    m, k, n, e = 8, 32, 16, 3
    x, w, beta = rnd(m, k), rnd(k, n), torch.ones(1).to(dev)
    bound = torch.full((n,), 4.0).to(dev)
    xe, we = rnd(e, m, k), rnd(e, k, n)
    packed = ref.pack_int4(torch.randint(-7, 8, (k, n), generator=gen,
                                         dtype=torch.int8)).to(dev)
    scale = rnd(n).abs()
    rows, cols, nq, nkv, hd, bs, nb = 2, 4, 4, 2, 16, 8, 3
    npool = 1 + rows * nb
    kp, vp = rnd(npool, bs, nkv, hd, dtype=torch.bfloat16), rnd(
        npool, bs, nkv, hd, dtype=torch.bfloat16)
    tbl = (1 + torch.arange(rows * nb, dtype=torch.int32)).reshape(
        rows, nb).to(dev)
    pos = torch.tensor([9, 17], dtype=torch.int32).to(dev)
    start = torch.tensor([0, 3], dtype=torch.int32).to(dev)
    q1, qs = rnd(rows, nq, hd), rnd(rows, cols, nq, hd)

    def attended(ncol):
        # rows attend 0..9 and 3..17 at their first column, one key more
        # at each next: 10 and 15 keys, tokens to 10 + ncol - 1 and
        # 15 + ncol - 1 read
        keys = sum(10 + i + 15 + i for i in range(ncol))
        toks = 10 + 15 + 2 * (ncol - 1)
        return (4.0 * hd * nq * keys,
                toks * nkv * 2 * hd * 2 + 2 * 4 * rows * ncol * nq * hd
                + 4 * (rows * nb + 2 * rows))
    bsz, s, heads, pdim, g, nst = 2, 40, 4, 8, 2, 16
    sx, sdt = rnd(bsz, s, heads, pdim), rnd(bsz, s, heads).abs() * 0.1
    sa = -torch.linspace(1.0, 2.0, heads).to(dev)
    sb, sc = rnd(bsz, s, g, nst), rnd(bsz, s, g, nst)
    h0 = rnd(bsz * heads, nst, pdim)
    return [
        ("analog_matmul", lambda: km.analog_matmul(x, w, beta, bound),
         cost.analog_matmul(1, m, k, n, bound=True, col_off=False),
         (m, n), None),
        ("analog_matmul", lambda: km.analog_matmul(xe, we, beta, lam=12.0),
         cost.analog_matmul(e, m, k, n, bound=False, col_off=False),
         (e, m, n), None),
        ("int4_matmul", lambda: k4.int4_matmul(x, packed, scale),
         cost.int4_matmul(1, m, k, n), (m, n), None),
        ("paged_flash_decode", lambda: kpd.paged_flash_decode(
            q1, kp, vp, tbl, pos, start, scale=0.25),
         cost.paged_attention(rows, 1, nq, nkv, hd, 2, False, nb, bs),
         (rows, nq, hd), attended(1)),
        ("paged_flash_prefill", lambda: kpp.paged_flash_prefill(
            qs, kp, vp, tbl, pos, start, scale=0.25),
         cost.paged_attention(rows, cols, nq, nkv, hd, 2, False, nb, bs),
         (rows, cols, nq, hd), attended(cols)),
        ("ssd_scan", lambda: kss.ssd_scan(sx, sdt, sa, sb, sc, h0)[0],
         cost.ssd_scan(bsz, s, heads, pdim, nst, g, True),
         (bsz, s, heads, pdim), None),
    ]


def test_meta_wrapper_calls_are_counted_and_launch_nothing():
    mods = (km, k4, kpd, kpp, kss)
    before = [mod.launches for mod in mods]
    for dev in (META, CPU):
        calls = _wrapper_calls(dev, torch.Generator().manual_seed(2))
        for name, call, (flops, nbytes), shape, att in calls:
            with CostCounter() as cc:
                out = call()
            a = cc.analyze()
            assert tuple(out.shape) == shape and out.dtype == torch.float32
            assert out.device.type == dev.type
            entry = {"calls": 1, "flops": flops, "bytes": nbytes}
            if name.startswith("paged"):
                # the keys the cursors reach, read on the CPU alone
                entry["attended_flops"], entry["attended_bytes"] = (
                    att if dev == CPU else (None, None))
            assert a["kernels"] == {name: entry}
            # the plain version's own ops are not counted beside it
            assert a["flops"] == flops and a["hbm_bytes"] == nbytes
            if name.startswith("paged"):
                assert a["attended_flops"] == entry["attended_flops"]
                assert a["attended_hbm_bytes"] == entry["attended_bytes"]
            else:
                assert a["attended_flops"] == flops
    assert [mod.launches for mod in mods] == before


@pytest.mark.parametrize("cols", [1, 5])
def test_paged_attended_work_counts_the_keys_the_cursors_reach(cols):
    """At a long table with short contexts the attended work is the keys
    each column reaches (counted one by one here), far below the table's
    capacity; the bytes read those tokens' K and V."""
    rows, nq, nkv, hd, bs, nb = 3, 4, 2, 8, 16, 64
    q = torch.empty((rows, cols, nq, hd) if cols > 1 else (rows, nq, hd))
    kp = torch.empty((1 + rows * nb, bs, nkv, hd), dtype=torch.bfloat16)
    tbl = torch.zeros((rows, nb), dtype=torch.int32)
    pos, start = [20, 7, 3], [0, 5, 4]      # the last row: nothing yet
    keys = sum(1 for b in range(rows) for i in range(cols)
               for j in range(start[b], pos[b] + i + 1))
    toks = sum(max(0, pos[b] + cols - start[b]) for b in range(rows))
    flops, nbytes = cost.paged_work(q, kp, tbl, torch.tensor(pos),
                                    torch.tensor(start))
    cap_flops, cap_bytes = cost.paged_work(q, kp, tbl)
    assert flops == 4.0 * hd * nq * keys
    assert nbytes == (toks * nkv * 2 * hd * 2 + 2 * 4 * rows * cols * nq * hd
                      + 4 * (rows * nb + 2 * rows))
    assert cap_flops == 4.0 * hd * nq * rows * nb * bs * cols
    assert flops < cap_flops / 20 and nbytes < cap_bytes


def test_ssd_least_work_is_the_recurrence():
    """The bound's count of an ``ssd_scan`` call is the recurrence's 2 N P
    FMAs per token and head, below the chunked count the counter takes
    (XLA's), with the same bytes."""
    shape = (4, 1024, 24, 64, 128, 1, False)      # mamba2-130m, 4 x 1024
    least, chunked = cost.ssd_scan_least(*shape), cost.ssd_scan(*shape)
    assert least[0] == 4.0 * 4 * 1024 * 24 * 128 * 64
    assert least[1] == chunked[1] and chunked[0] > 2 * least[0]


def test_meta_calls_are_checked_as_on_the_card():
    meta = torch.device("meta")
    x = torch.empty((4, 8), device=meta)
    w = torch.empty((8, 6), device=meta)
    beta = torch.empty((1,), device=meta)
    with pytest.raises(ValueError, match="shape"):
        km.analog_matmul(x, torch.empty((7, 6), device=meta), beta, lam=1.0)
    with pytest.raises(TypeError):
        km.analog_matmul(x.double(), w, beta, lam=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        km.analog_matmul(x, torch.empty((6, 8), device=meta).T, beta,
                         lam=1.0)
    with pytest.raises(TypeError):
        k4.int4_matmul(x, torch.empty((8, 3), dtype=torch.int8,
                                      device=meta),
                       torch.empty((6,), device=meta))
    out = km.analog_matmul(x, w, beta, lam=1.0)
    assert out.device.type == "meta" and tuple(out.shape) == (4, 6)


def test_tensor_parallel_gathers_report_their_bytes():
    gen = torch.Generator().manual_seed(3)
    site = {"kernel": torch.randn((64, 96), generator=gen) * 0.1,
            "input_range": torch.ones(1)}
    mesh = shd.serve_mesh(2, devices=["cpu", "cpu"])
    sharded = shd.shard_params_for_serve(mesh, {"gate_up": site})["gate_up"]
    x = torch.randn((2, 5, 64), generator=gen)
    acfg = AnalogConfig(mode="analog")
    with CostCounter() as cc:
        y, _ = shd.parallel_linear(analog_linear, sharded, x, acfg,
                                   AnalogCtx())
    a = cc.analyze()
    assert tuple(y.shape) == (2, 5, 96)
    assert a["collective_counts"]["all-gather"] == 1
    assert a["collective_bytes"]["all-gather"] == 4 * 2 * 5 * 96
    assert a["collective_total_bytes"] == 4 * 2 * 5 * 96
