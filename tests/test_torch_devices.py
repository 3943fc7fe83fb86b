"""The port's per-tile device model (``repro_torch.core.devices``), its
device branch of ``analog_linear`` and the engine's drift clock and
watchdog, against the JAX package's.

Randomness does not cross between the packages, so the reference's
``attach_device_state`` output is carried across as numpy
(``params_from_numpy``, the ``int32`` ``stuck`` leaf included) wherever
the two are compared; the port's own sampler is held by distribution and
by seed determinism. ``_DCFG`` is ``tests/test_noise_clip.py``'s. The
reference's sampler runs jitted on an ``rbg`` key (XLA's bit generator
compiles in a fraction of threefry's time; the state is the reference
function's output either way), and the reduced models' weights are drawn
by the port and handed to both packages.

Tolerances:

* ``corrupt_weights`` at K 600, N 3352 (tiles of 200 x 240, not 256 x
  256): bit for bit at ``dt = 0``; after ``advance(12.0)`` within
  ``ULPS`` units in the last place (``torch.pow`` / ``torch.log1p`` and
  their jnp counterparts differ by 1-2 ulps on a few percent of inputs);
* site outputs and logits with an analog head: ``assert_adc_parity``
  (one ADC level at a near-tie, under 1e-4 of the outputs); a tied
  (digital) head ``rtol = atol = 1e-5``;
* ``health``'s ``mean_scale_err``: 1e-6 (the packages sum a site's tiles
  in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_adc_parity
from test_kernel_dispatch import SHAPES_STRICT, _adc_lsb

from repro.configs import get_config
from repro.core import analog as RA
from repro.core import devices as RD
from repro.models import apply as ref_apply
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.checkpoint import (flatten_paths, params_from_numpy,
                                    unflatten_paths)
from repro_torch.core import analog as PA
from repro_torch.core import devices as PD
from repro_torch.kernels import ref as kref
from repro_torch.models import apply as port_apply
from repro_torch.models import moe as PM
from repro_torch.models import transformer as T

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ULPS = 4
SCALE_ERR_TOL = 1e-6
REF_EVAL = RA.AnalogCtx(key=None, training=False)
PORT_EVAL = PA.AnalogCtx()
ANALOG = dict(mode="analog", train_noise=False)

_DCFG = RD.DeviceConfig(tile_k=32, tile_n=32, sigma_gain=0.03,
                        nu_median=0.08, nu_sigma=0.3, sigma_offset=0.01,
                        p_stuck_col=0.05, p_dead_tile=0.05)
#: the same settings for the port's sampler
_PDCFG = PD.DeviceConfig(**dataclasses.asdict(_DCFG))


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat}


def _carry(tree) -> dict:
    return params_from_numpy(_ref_flat(tree), "cpu")


def _ref_attach(params, labels, seed: int, dcfg=_DCFG):
    """The reference's ``attach_device_state``, jitted, on an rbg key."""
    return jax.jit(lambda p, k: RD.attach_device_state(p, labels, k, dcfg))(
        params, jax.random.key(seed, impl="rbg"))


def _site(k, n, seed, bias=False):
    """One reference linear site ``{"l": ...}`` and its labels."""
    rng = np.random.default_rng(seed)
    p = {"kernel": jnp.asarray((rng.standard_normal((k, n)) * k ** -0.5
                                ).astype(np.float32)),
         "input_range": jnp.full((1,), 2.5, jnp.float32)}
    if bias:
        p["bias"] = jnp.asarray((rng.standard_normal(n) * 0.1
                                 ).astype(np.float32))
    return {"l": p}, {"l": RA.linear_labels(p)}


def _port_site(k, n, seed):
    params, labels = _site(k, n, seed)
    return _carry(params), {"l": PA.linear_labels(params["l"])}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


def _ulps(a, b) -> int:
    return int(np.abs(_bits(a) - _bits(b)).max())


# ---------------------------------------------------------------------------
# the config, the state, the sampler
# ---------------------------------------------------------------------------

def test_validate_device_config_rejects_nonsense():
    PD.validate_config(PD.DeviceConfig())
    for bad, match in ((dict(tile_k=0), "tile dims"),
                       (dict(sigma_gain=-0.1), "sigma_gain"),
                       (dict(p_stuck_col=1.5), "probability"),
                       (dict(t0=0.0), "t0")):
        with pytest.raises(ValueError, match=match):
            PD.validate_config(PD.DeviceConfig(**bad))
        with pytest.raises(ValueError, match=match):
            RD.validate_config(RD.DeviceConfig(**bad))
    assert ({f.name: f.default for f in dataclasses.fields(PD.DeviceConfig)}
            == {f.name: f.default
                for f in dataclasses.fields(RD.DeviceConfig)})


def test_port_sampler_distribution_and_seed_determinism():
    """The port's own draws: per-tile gain ``1 + sigma_gain eps``,
    lognormal ``nu``, offsets, dead tiles and the stuck split, by
    distribution over 4 M tiles and 16 k columns; one seed, one chip."""
    dcfg = dataclasses.replace(_PDCFG, tile_k=1, tile_n=1, p_stuck_col=0.2,
                               p_dead_tile=0.1)
    params = {"l": {"kernel": torch.zeros(64, 256, 256),
                    "input_range": torch.full((1,), 3.0)}}
    labels = {"l": PA.linear_labels(params["l"])}

    def draw(seed):
        return PD.attach_device_state(
            params, labels, torch.Generator().manual_seed(seed),
            dcfg)["l"]["device"]

    d = draw(0)
    assert d["gain"].shape == (64, 256, 256) and d["stuck"].shape == (64,
                                                                     256)
    assert abs(float(d["gain"].mean()) - 1.0) < 1e-3
    assert abs(float(d["gain"].std()) / dcfg.sigma_gain - 1.0) < 0.01
    lnu = torch.log(d["nu"])
    assert abs(float(lnu.mean()) - np.log(dcfg.nu_median)) < 2e-3
    assert abs(float(lnu.std()) / dcfg.nu_sigma - 1.0) < 0.01
    assert abs(float(d["off"].std()) / dcfg.sigma_offset - 1.0) < 0.01
    assert abs(float(d["dead"].mean()) - dcfg.p_dead_tile) < 2e-3
    for code in (1, 2):
        share = float((d["stuck"] == code).float().mean())
        assert abs(share - dcfg.p_stuck_col / 2) < 0.015
    assert set(torch.unique(d["dead"]).tolist()) == {0.0, 1.0}
    assert float(d["t"].abs().max()) == 0.0 and bool(
        (d["t0"] == dcfg.t0).all())
    again, other = draw(0), draw(1)
    for leaf in ("gain", "nu", "off", "dead", "stuck"):
        assert torch.equal(d[leaf], again[leaf])
        assert not torch.equal(d[leaf], other[leaf])
    assert not PD.has_device_state(params)
    with pytest.raises(ValueError, match="already"):
        PD.attach_device_state({"l": {**params["l"], "device": d}}, labels,
                               torch.Generator(), dcfg)


# ---------------------------------------------------------------------------
# drift, faults, recalibration
# ---------------------------------------------------------------------------

def _injected(k=96, n=64, seed=2, dcfg=_DCFG):
    """(reference params with device state, the port's copy)."""
    params, labels = _site(k, n, seed)
    dp = _ref_attach(params, labels, seed, dcfg)
    return dp, _carry(dp)


def test_drift_monotone_in_health_and_the_clock_accumulates():
    dp, pp = _injected()
    errs = []
    for h in (0.0, 1.0, 5.0, 42.0, 120.0):       # ages 0, 1, 6, 48, 168 h
        PD.advance(pp, h)
        dp = RD.advance(dp, h)
        got, want = PD.health(pp), RD.health(dp)
        assert {k: got[k] for k in got if k != "mean_scale_err"} == {
            k: want[k] for k in want if k != "mean_scale_err"}
        assert abs(got["mean_scale_err"] - want["mean_scale_err"]) < (
            SCALE_ERR_TOL)
        errs.append(got["mean_scale_err"])
    assert all(b >= a - 1e-9 for a, b in zip(errs, errs[1:]))
    assert errs[-1] > errs[0]
    # advance(a) then advance(b) is advance(a + b)
    _, one = _injected()
    _, two = _injected()
    PD.advance(PD.advance(one, 5.0), 43.0)
    PD.advance(two, 48.0)
    assert torch.equal(one["l"]["device"]["t"], two["l"]["device"]["t"])
    assert float(one["l"]["device"]["t"]) == 48.0


def test_fault_masks_at_non_dividing_tiles_and_faults_survive_recalibrate():
    """Stuck-at-Gmin columns read 0, stuck-at-Gmax columns the pristine
    column absmax, dead tiles 0 over their span: K 100 at tile 32 is 4
    tiles of 25 rows, N 70 three tiles of 24 columns (the last 22)."""
    dcfg = dataclasses.replace(_DCFG, p_stuck_col=0.3, p_dead_tile=0.6)
    _, pp = _injected(100, 70, seed=5, dcfg=dcfg)
    dev = pp["l"]["device"]
    w = pp["l"]["kernel"]
    assert dev["gain"].shape == (4, 3)
    w_eff, _ = PD.corrupt_weights(w, dev, torch.ones(70))
    w_eff, w, stuck = w_eff.numpy(), w.numpy(), dev["stuck"].numpy()
    colmax = np.abs(w).max(axis=0)
    assert (stuck == 1).any() and (stuck == 2).any()
    assert np.all(w_eff[:, stuck == 1] == 0.0)
    np.testing.assert_array_equal(
        w_eff[:, stuck == 2],
        np.broadcast_to(colmax[stuck == 2], w_eff[:, stuck == 2].shape))
    dead = dev["dead"].numpy()
    assert dead.any() and not dead.all()
    for ti, tj in np.ndindex(*dead.shape):
        tile = w_eff[ti * 25:(ti + 1) * 25, tj * 24:(tj + 1) * 24]
        cols = stuck[tj * 24:(tj + 1) * 24]
        if dead[ti, tj]:
            assert np.all(tile[:, cols != 2] == 0.0)
        else:
            assert np.all(tile[:, cols == 0] != 0.0)
    kept = {k: dev[k].clone() for k in ("stuck", "dead", "nu")}
    PD.advance(pp, 30.0)
    PD.recalibrate(pp, torch.Generator().manual_seed(1))
    for k, v in kept.items():
        assert torch.equal(dev[k], v)


def test_recalibration_contract_in_place():
    """Recalibration restores the scale and restarts the clock in place:
    ``t`` unchanged, ``t_prog = t``, ``nu`` / ``dead`` / ``stuck`` bit for
    bit kept, every leaf the same storage, the same tree returned; one
    seed, the same redraw."""
    _, pp = _injected(seed=6)
    dev = pp["l"]["device"]
    ptrs = {k: v.data_ptr() for k, v in dev.items()}
    kept = {k: dev[k].clone() for k in ("nu", "dead", "stuck", "t0")}
    PD.advance(pp, 168.0)
    err_aged = PD.health(pp)["mean_scale_err"]
    assert PD.recalibrate(pp, torch.Generator().manual_seed(2)) is pp
    err_recal = PD.health(pp)["mean_scale_err"]
    assert err_aged > 0.1 and err_recal < err_aged / 3
    assert float(dev["t"]) == 168.0 and torch.equal(dev["t_prog"], dev["t"])
    assert PD.health(pp)["hours_since_cal"] == 0.0
    for k, v in kept.items():
        assert torch.equal(dev[k], v)
    assert {k: v.data_ptr() for k, v in dev.items()} == ptrs
    _, twin = _injected(seed=6)
    PD.advance(twin, 168.0)
    PD.recalibrate(twin, torch.Generator().manual_seed(2))
    for k in ("gain", "off"):
        assert torch.equal(twin["l"]["device"][k], dev[k])


def test_corrupt_weights_match_reference_at_non_dividing_tiles():
    """K 600 and N 3352 at tile 256: 3 row tiles of 200, 14 column tiles
    of 240 (the reference's ``ceil(dim / ceil(dim / T))`` span). Bit for
    bit at ``dt = 0``; within ULPS after a tick."""
    dcfg = dataclasses.replace(_DCFG, tile_k=256, tile_n=256)
    dp, pp = _injected(600, 3352, seed=9, dcfg=dcfg)
    assert pp["l"]["device"]["gain"].shape == (3, 14)
    bound = np.random.default_rng(1).random(3352).astype(np.float32) + 0.5
    w = pp["l"]["kernel"]
    for dt in (0.0, 12.0):
        if dt:
            dp = RD.advance(dp, dt)
            PD.advance(pp, dt)
        want_w, want_off = RD.corrupt_weights(
            dp["l"]["kernel"], dp["l"]["device"], jnp.asarray(bound))
        got_w, got_off = PD.corrupt_weights(w, pp["l"]["device"],
                                            torch.from_numpy(bound))
        assert got_w.shape == (600, 3352) and got_off.shape == (3352,)
        if dt == 0.0:
            assert np.array_equal(_bits(got_w), _bits(want_w))
            assert np.array_equal(_bits(got_off), _bits(want_off))
            assert float(got_off.abs().max()) == 0.0
        else:
            assert _ulps(got_w, want_w) <= ULPS
            assert _ulps(got_off, want_off) <= ULPS
            assert float(got_off.abs().max()) > 0.0
    # the span: column 239 and 240 sit in tiles 0 and 1
    scale = PD._tile_scale(pp["l"]["device"])
    spread = PD._expand_tiles(scale, 600, 3352)
    assert torch.equal(spread[199, 239], scale[0, 0])
    assert torch.equal(spread[200, 240], scale[1, 1])


def test_state_shapes_and_dtypes_match_reference(models):
    """The port's own ``attach_device_state`` gives the reference's paths,
    shapes and dtypes, stacked ``[L]``, ``[L, E]`` and jamba's ``[n_sb]``
    / ``[n_sb, attn_every - 1]`` included."""
    for arch, (cfg, rp, _, dp, _) in models.items():
        pristine = _carry(rp)
        ours = PD.attach_device_state(pristine, T.model_labels(pristine, cfg),
                                      torch.Generator().manual_seed(0),
                                      _PDCFG)
        want = {k: (v.shape, str(v.dtype)) for k, v in _ref_flat(dp).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in flatten_paths(ours).items()}
        assert got == want, arch
    nested = [k for k in want if "mamba" in k and k.endswith("/device/t")]
    assert nested and all(len(want[k][0]) == 2 for k in nested)
    experts = [k for k, v in _ref_flat(models["qwen3-moe-30b-a3b"][3]).items()
               if "gate_up/device/gain" in k]
    assert experts and _ref_flat(models["qwen3-moe-30b-a3b"][3])[
        experts[0]].ndim == 4


# ---------------------------------------------------------------------------
# the device site of analog_linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES_STRICT)
def test_device_site_fused_unfused_and_reference(m, k, n):
    """Per-tile corruption (scale, faults, offsets) after a 12 h tick, on
    the reference's device state: the port's fused and unfused sites
    against each other and the reference's unfused site by
    ``assert_adc_parity``; the corruption is live."""
    params, labels = _site(k, n, m * 7 + n, bias=True)
    p = params["l"]
    x = np.random.default_rng(m).standard_normal((2, m, k)).astype(
        np.float32)
    dp = RD.advance(_ref_attach(params, labels, m * 7 + n), 12.0)
    want = jax.jit(lambda d, x: RA.analog_linear(
        d, x, RA.AnalogConfig(mode="analog"), REF_EVAL)[0])(dp["l"], x)
    pp = _carry(dp)["l"]
    xt = torch.from_numpy(x)
    lsb = _adc_lsb(p, 8)
    bias = np.asarray(p["bias"])
    got = {}
    for fused in (False, True):
        got[fused], _ = PA.analog_linear(
            pp, xt, PA.AnalogConfig(mode="analog", use_pallas=fused),
            PORT_EVAL)
        assert_adc_parity(got[fused].numpy() - bias, np.asarray(want) - bias,
                          lsb)
    assert_adc_parity(got[True].numpy() - bias, got[False].numpy() - bias,
                      lsb)
    clean, _ = PA.analog_linear({k_: v for k_, v in pp.items()
                                 if k_ != "device"}, xt,
                                PA.AnalogConfig(mode="analog"), PORT_EVAL)
    assert not torch.allclose(clean, got[False])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_null_device_state_is_bitwise_noop(fused):
    """All-zero sigmas and no faults at ``dt = 0`` leave both paths bit for
    bit as without the sub-dict; training ignores the sub-dict."""
    null = PD.DeviceConfig(sigma_gain=0.0, nu_median=0.0, nu_sigma=0.0,
                           sigma_offset=0.0)
    pp, plabels = _port_site(64, 48, seed=21)
    dp = PD.attach_device_state(pp, plabels, torch.Generator(), null)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, 64)).astype(np.float32))
    cfg = PA.AnalogConfig(mode="analog", use_pallas=fused)
    y_dev, _ = PA.analog_linear(dp["l"], x, cfg, PORT_EVAL)
    y, _ = PA.analog_linear(pp["l"], x, cfg, PORT_EVAL)
    assert np.array_equal(_bits(y_dev), _bits(y))
    for mode in ("rtn", "qat", "di8"):
        mcfg = PA.AnalogConfig(mode=mode, use_pallas=fused)
        assert torch.equal(PA.analog_linear(dp["l"], x, mcfg, PORT_EVAL)[0],
                           PA.analog_linear(pp["l"], x, mcfg, PORT_EVAL)[0])


def test_perturb_before_attach():
    pp, plabels = _port_site(32, 16, seed=1)
    dp = PD.attach_device_state(pp, plabels, torch.Generator(), _PDCFG)
    with pytest.raises(ValueError, match="before attach_device_state"):
        PA.perturb_analog_weights(dp, plabels, torch.Generator(), "hw")


# ---------------------------------------------------------------------------
# reduced models with device state
# ---------------------------------------------------------------------------

ARCHS = ["granite-3-8b", "mamba2-130m", "qwen3-moe-30b-a3b",
         "jamba-v0.1-52b"]


def _ref_model(cfg, seed: int):
    """Weights drawn by the port, as the reference's tree, and the
    reference's labels (plain strings, read off a trace of its
    ``init_model``)."""
    labels = []
    jax.eval_shape(lambda k: labels.append(RT.init_model(k, cfg)[1]) or 0,
                   jax.random.PRNGKey(seed))
    params, _ = T.init_model(torch.Generator().manual_seed(seed), cfg)
    flat = {k: jnp.asarray(v.numpy()) for k, v in
            flatten_paths(params).items()}
    return unflatten_paths(flat), labels[0]


@pytest.fixture(scope="module")
def models():
    """arch → (cfg, reference params, labels, reference params with
    device state, the port's copy of them), the no-drop capacity on the
    routed models. A test that ages the chip ages its own copy
    (``_carry``)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduce()
        if cfg.num_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.num_experts))
        rp, labels = _ref_model(cfg, i)
        dp = _ref_attach(rp, labels, 10 + i)
        out[arch] = (cfg, rp, labels, dp, _carry(dp))
    return out


_REF_LOGITS: dict = {}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_with_device_state_matches_reference(models, arch,
                                                             use_pallas):
    """A 12 h-old chip: each family's logits against the reference's on
    the same state (an analog head by ``assert_adc_parity``, a tied one by
    TOL)."""
    cfg, _, _, dp, _ = models[arch]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    if arch not in _REF_LOGITS:
        _REF_LOGITS[arch] = np.asarray(jax.jit(lambda p, t: ref_apply(
            RD.advance(p, 12.0), cfg, RA.AnalogConfig(**ANALOG), REF_EVAL,
            {"tokens": t})[0])(dp, toks))
    pp = PD.advance(_carry(dp), 12.0)
    got, _, _ = port_apply(
        pp, cfg, PA.AnalogConfig(**ANALOG, use_pallas=use_pallas), PORT_EVAL,
        {"tokens": torch.from_numpy(toks).long()})
    want = _REF_LOGITS[arch]
    assert got.shape == want.shape
    if "lm_head" in pp:
        head = pp["lm_head"]
        bound = kref.adc_bound(head["kernel"], head["input_range"], 12.0)
        assert_adc_parity(got.numpy(), want,
                          (bound[:cfg.vocab_size] / 127).numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_expert_sites_serve_pristine_weights(models):
    """The reference drops an expert site's device state
    (``src/repro/models/moe.py:95-102``), and so does the port: a MoE
    layer gives the same bits with and without its experts' state, and the
    reference's layer."""
    cfg, _, _, dp, _ = models["qwen3-moe-30b-a3b"]
    pp = PD.advance(_carry(dp), 48.0)
    ffn = T.tree_index(pp["blocks"]["ffn"], 0)
    bare = {k: ({kk: vv for kk, vv in v.items() if kk != "device"}
                if isinstance(v, dict) else v) for k, v in ffn.items()}
    assert "device" in ffn["gate_up"] and "device" not in bare["gate_up"]
    x = np.random.default_rng(4).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    acfg = PA.AnalogConfig(**ANALOG)
    y_dev, _ = PM.moe(ffn, torch.from_numpy(x), cfg, acfg, PORT_EVAL)
    y_bare, _ = PM.moe(bare, torch.from_numpy(x), cfg, acfg, PORT_EVAL)
    assert torch.equal(y_dev, y_bare)
    rffn = jax.tree.map(lambda v: v[0], RD.advance(dp, 48.0)["blocks"]["ffn"])
    y_ref = jax.jit(lambda p, x: RM.moe(p, x, cfg, RA.AnalogConfig(**ANALOG),
                                        REF_EVAL)[0])(rffn, x)
    np.testing.assert_allclose(y_dev.numpy(), np.asarray(y_ref), **TOL)
