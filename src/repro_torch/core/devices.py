"""Per-tile analog device state: programming variation, conductance drift,
fault injection, and the in-engine recalibration contract.

The port of the JAX package's ``core/devices.py``, with its names and its
op order. A weight matrix is partitioned across crossbar tiles, and every
tile carries its own state (Rasch et al., arXiv:2302.08469; Luquin et al.,
arXiv:2506.00004):

* **Programming gain variation** — a multiplicative gain ``1 + sigma_gain
  * eps`` per tile, drawn at each (re)programming.
* **Conductance drift** — ``G(t) = G(t_prog) * ((t - t_prog + t0)/t0)^-nu``
  with a lognormal drift coefficient ``nu`` per tile.
* **Periphery offset drift** — a per-tile offset instance that is zero at
  calibration and grows as ``log1p(hours since calibration / t0)``, summed
  over a column's row-tiles into a per-column pre-ADC offset (a fraction
  of the ADC bound).
* **Hard faults** — stuck-at-Gmin columns (read as 0), stuck-at-Gmax
  columns (pinned at the column's pristine absmax) and dead tiles (the
  whole tile reads 0). Recalibration never repairs them.

A ``[.., K, N]`` weight has ``ceil(K / tile_k) x ceil(N / tile_n)`` tiles,
and each tile spans ``ceil(dim / tiles)`` rows or columns (the last one
fewer), so a tile is not ``tile_k x tile_n`` wide where the dims do not
divide: N 3352 at ``tile_n`` 256 gives 14 tiles of 240 columns.

State lives inside the params tree: :func:`attach_device_state` adds a
``"device"`` sub-dict to every analog site, every leaf keeping the site's
leading stack dims (``[L]``, ``[L, E]``, jamba's ``[n_sb]`` and ``[n_sb,
attn_every - 1]``), so that the per-layer views the models take of a
stacked tree carry each layer's state. The state is drawn on a CPU
``torch.Generator`` (a few kilobytes a site) and moved to the weights'
device, so one seed programs the same chip on the card and on the CPU.

Unlike the reference, whose params are new arrays after every step, the
clock and the recalibration here write into the existing leaves
(:func:`advance`, :func:`recalibrate`): every per-layer view sees the new
state, and a CUDA graph captured before a tick replays the new state.

The recalibration contract (``docs/noise.md``): :func:`recalibrate`
redraws the per-tile gain and offset instances and sets ``t_prog := t``;
``t``, ``nu``, ``dead`` and ``stuck`` are untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Static per-deployment description of the tiled analog hardware (the
    reference's fields and defaults).

    Attributes:
        tile_k: Crossbar tile height (input/row dimension) in weight
            elements.
        tile_n: Crossbar tile width (output/column dimension).
        sigma_gain: Std of the per-tile programming gain ``1 + sigma_gain
            * eps``, redrawn by every (re)programming.
        nu_median: Median of the lognormal per-tile drift coefficient
            ``nu``.
        nu_sigma: Std of ``log nu``: the tile-to-tile drift-rate spread.
        sigma_offset: Std of the per-tile output-offset instance, in units
            of the column's ADC bound.
        p_stuck_col: Per-column probability of a stuck fault, split evenly
            between stuck-at-Gmin and stuck-at-Gmax.
        p_dead_tile: Per-tile probability that the whole tile reads 0.
        t0: Drift reference time in deployment hours (the unit of
            :func:`advance`'s ``dt_hours``).
    """

    tile_k: int = 256
    tile_n: int = 256
    sigma_gain: float = 0.02
    nu_median: float = 0.05
    nu_sigma: float = 0.3
    sigma_offset: float = 0.0
    p_stuck_col: float = 0.0
    p_dead_tile: float = 0.0
    t0: float = 1.0


def validate_config(dcfg: DeviceConfig) -> None:
    """Raise ``ValueError`` on a physically meaningless setting instead of
    serving a placebo device model."""
    if dcfg.tile_k < 1 or dcfg.tile_n < 1:
        raise ValueError(f"tile dims must be >= 1, got "
                         f"({dcfg.tile_k}, {dcfg.tile_n})")
    for name in ("sigma_gain", "nu_median", "nu_sigma", "sigma_offset"):
        if getattr(dcfg, name) < 0:
            raise ValueError(f"{name} must be >= 0, got "
                             f"{getattr(dcfg, name)!r}")
    for name in ("p_stuck_col", "p_dead_tile"):
        v = getattr(dcfg, name)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"{name} must be a probability in [0, 1], "
                             f"got {v!r}")
    if dcfg.t0 <= 0:
        raise ValueError(f"t0 must be > 0 hours, got {dcfg.t0!r}")


def _sample_site(gen: torch.Generator, w_shape: tuple, dcfg: DeviceConfig,
                 device) -> dict:
    """One site's device sub-dict (leading stack dims kept), drawn on the
    CPU generator ``gen`` and moved to ``device``."""
    lead, (kdim, n) = tuple(w_shape[:-2]), tuple(w_shape[-2:])
    tshape = lead + (-(-kdim // dcfg.tile_k), -(-n // dcfg.tile_n))
    gain = 1.0 + dcfg.sigma_gain * torch.randn(tshape, generator=gen)
    nu = dcfg.nu_median * torch.exp(
        dcfg.nu_sigma * torch.randn(tshape, generator=gen))
    off = dcfg.sigma_offset * torch.randn(tshape, generator=gen)
    dead = (torch.rand(tshape, generator=gen) < dcfg.p_dead_tile).float()
    u = torch.rand(lead + (n,), generator=gen)
    stuck = torch.where(u < dcfg.p_stuck_col / 2.0, 1,
                        torch.where(u < dcfg.p_stuck_col, 2, 0)
                        ).to(torch.int32)
    d = {"gain": gain, "nu": nu, "off": off, "dead": dead, "stuck": stuck,
         "t": torch.zeros(lead), "t_prog": torch.zeros(lead),
         "t0": torch.full(lead, dcfg.t0),
         "sigma_gain": torch.full(lead, dcfg.sigma_gain),
         "sigma_offset": torch.full(lead, dcfg.sigma_offset)}
    return {k: v.to(device) for k, v in d.items()}


def _check_cpu(gen: torch.Generator) -> None:
    if gen.device.type != "cpu":
        raise ValueError("device state is drawn on a CPU torch.Generator "
                         f"(one seed, one chip on every device), not on "
                         f"{gen.device}")


def attach_device_state(params: dict, labels: dict, gen: torch.Generator,
                        dcfg: DeviceConfig = DeviceConfig()) -> dict:
    """A new tree with a seeded ``"device"`` sub-dict at every analog site
    (the weights and other leaves are shared with ``params``).

    One deployment is one call: the same seed in ``gen`` (a CPU generator)
    gives the same chip, on whichever device the weights live. Sites are
    drawn in sorted key order. Must run after ``perturb_analog_weights``,
    which refuses a tree with device state, as the reference's does.
    """
    validate_config(dcfg)
    _check_cpu(gen)
    if has_device_state(params):
        raise ValueError("params already carry device state")

    def walk(p, lab):
        if not isinstance(p, dict):
            return p
        done = {k: walk(p[k], lab[k]) for k in sorted(p)}
        out = {k: done[k] for k in p}
        if isinstance(lab, dict) and lab.get("kernel") == "analog_weight":
            w = p["kernel"]
            out["device"] = _sample_site(gen, tuple(w.shape), dcfg,
                                         w.device)
        return out

    return walk(params, labels)


def _devices(params) -> list:
    """Every ``"device"`` sub-dict of ``params``, in sorted key order."""
    out = []

    def walk(p):
        if isinstance(p, dict):
            for k in sorted(p):
                if k == "device" and isinstance(p[k], dict):
                    out.append(p[k])
                else:
                    walk(p[k])

    walk(params)
    return out


def has_device_state(params) -> bool:
    """True when any analog site carries a ``"device"`` sub-dict."""
    return bool(_devices(params))


@torch.no_grad()
def advance(params: dict, dt_hours: float) -> dict:
    """Advance every site's deployment clock by ``dt_hours``, in place.

    Writes into each ``t`` leaf and returns the same tree: every per-layer
    view, and any CUDA graph captured over these leaves, sees the new
    clock (the reference returns a new tree instead)."""
    dt = float(np.float32(dt_hours))
    for d in _devices(params):
        d["t"].add_(dt)
    return params


@torch.no_grad()
def recalibrate(params: dict, gen: torch.Generator) -> dict:
    """One reprogram-and-recalibrate cycle (see the module docstring), in
    place: each site's ``gain`` and ``off`` are redrawn from ``gen`` (a
    CPU generator; a site's gain, then its offset, sites in sorted key
    order) and written into the existing leaves, and ``t_prog`` is set to
    ``t``. ``t``, ``nu``, ``dead`` and ``stuck`` are untouched. Returns
    the same tree."""
    _check_cpu(gen)
    for d in _devices(params):
        lead = tuple(d["t"].shape)
        sg = d["sigma_gain"].reshape(lead + (1, 1))
        so = d["sigma_offset"].reshape(lead + (1, 1))
        shape, dev = tuple(d["gain"].shape), d["gain"].device
        eps_g = torch.randn(shape, generator=gen).to(dev)
        eps_o = torch.randn(shape, generator=gen).to(dev)
        d["gain"].copy_(1.0 + sg * eps_g)
        d["off"].copy_(so * eps_o)
        d["t_prog"].copy_(d["t"])
    return params


def _tile_scale(d: dict) -> torch.Tensor:
    """Per-tile effective conductance scale at the current clock."""
    t, tp, t0 = d["t"], d["t_prog"], d["t0"]
    age = (t - tp + t0) / t0
    if t.dim():                               # leading stack dims
        age = age[..., None, None]
    return d["gain"] * torch.pow(age, -d["nu"]) * (1.0 - d["dead"])


def _expand_tiles(s: torch.Tensor, kdim: int, n: int) -> torch.Tensor:
    """A ``[.., TK, TN]`` tile grid spread to ``[.., K, N]`` elements, each
    tile over ``ceil(dim / tiles)`` rows and columns."""
    *lead, tk, tn = s.shape
    rk, rn = -(-kdim // tk), -(-n // tn)
    s = s[..., :, None, :, None].expand(*lead, tk, rk, tn, rn)
    return s.reshape(*lead, tk * rk, tn * rn)[..., :kdim, :n]


def _scale_tiles(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``w * _expand_tiles(s, K, N)``; where the tiles divide both dims the
    grid is broadcast over a tiled view of ``w`` instead of spread (the
    same products, one pass fewer)."""
    kdim, n = w.shape[-2:]
    tk, tn = s.shape[-2:]
    rk, rn = -(-kdim // tk), -(-n // tn)
    if rk * tk != kdim or rn * tn != n:
        return w * _expand_tiles(s, kdim, n)
    lead = tuple(w.shape[:-2])
    return (w.reshape(lead + (tk, rk, tn, rn))
            * s[..., :, None, :, None]).reshape(w.shape)


def corrupt_weights(w: torch.Tensor, dev: dict, bound: torch.Tensor,
                    colmax: torch.Tensor | None = None,
                    cols: tuple[int, int] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device state materialised as ``(w_eff, col_off)``.

    ``w`` is the pristine ``[.., K, N]`` weight the site serves; ``bound``
    its per-column ADC bound ``[.., N]``, taken from the pristine weights
    (the ADC range is set at programming time and does not track drift).
    ``w_eff`` is ``w`` times each tile's scale, dead tiles 0, stuck-at-Gmin
    columns 0 and stuck-at-Gmax columns at the pristine column absmax
    (``colmax`` [.., N] where the caller has it, as the bound's own pass
    gives it); ``col_off`` the per-column offset added to the accumulator
    before the ADC. The fused kernel and the unfused path both take these
    two arrays as they are. No host read: a CUDA graph can hold the call.

    ``cols`` ``(c0, n_site)``: ``w`` is columns ``c0 ..`` of a site
    ``n_site`` wide whose whole state ``dev`` holds (a tensor-parallel
    shard whose boundary falls inside a tile): the grid is spread over the
    site's columns and read at the shard's, the same products as the whole
    site's.
    """
    kdim, n = w.shape[-2:]
    stuck = dev["stuck"]
    if cols is None:
        w_eff = _scale_tiles(w, _tile_scale(dev))
        n_site, c0 = n, 0
    else:
        c0, n_site = cols
        w_eff = w * _expand_tiles(_tile_scale(dev), kdim,
                                  n_site)[..., c0:c0 + n]
        stuck = stuck[..., c0:c0 + n]
    if colmax is None:
        colmax = kref.abs_max(w, -2)                   # pristine ceiling
    # both faults in one pass: a stuck column reads 0 (Gmin) or colmax
    pinned = torch.where(stuck == 2, colmax, torch.zeros_like(colmax))
    w_eff = torch.where((stuck != 0).unsqueeze(-2), pinned.unsqueeze(-2),
                        w_eff)

    t, tp, t0 = dev["t"], dev["t_prog"], dev["t0"]
    growth = torch.log1p(torch.clamp_min(t - tp, 0.0) / t0)
    if t.dim():
        growth = growth[..., None, None]
    col_frac = torch.sum(dev["off"] * growth, dim=-2)  # [.., TN]
    tn = col_frac.shape[-1]
    rn = -(-n_site // tn)
    col_frac = col_frac[..., :, None].expand(
        *col_frac.shape, rn).reshape(*col_frac.shape[:-1],
                                     tn * rn)[..., c0:c0 + n]
    return w_eff, col_frac * bound


@torch.no_grad()
def health(params) -> dict:
    """Host-side per-tile health read for the engine's drift watchdog.

    Returns the reference's keys as plain numbers: ``mean_scale_err``
    (mean ``|scale - 1|`` over live tiles, the watchdog's trip signal),
    ``dead_tiles``, ``stuck_cols``, ``tiles``, ``sites`` and
    ``hours_since_cal`` (the largest ``t - t_prog``). Each site's sums are
    taken where its state lives and read back in one transfer.
    """
    # a tensor-parallel site's state is read gathered
    devs = [{k: sharding.whole(v) for k, v in d.items()}
            for d in _devices(params)]
    if not devs:
        return {"sites": 0, "tiles": 0, "dead_tiles": 0, "stuck_cols": 0,
                "mean_scale_err": 0.0, "hours_since_cal": 0.0}
    rows = []
    for d in devs:
        live = 1.0 - d["dead"]
        err = torch.sum(torch.abs(_tile_scale(d) - 1.0) * live)
        rows.append(torch.stack([
            err.double(), torch.sum(live).double(),
            torch.sum(d["dead"] > 0).double(),
            torch.sum(d["stuck"] != 0).double(),
            torch.max(d["t"] - d["t_prog"]).double()]))
    host = torch.stack(rows).cpu().numpy()
    err_sum = live_n = 0.0
    for r in host:
        err_sum += float(r[0])
        live_n += float(r[1])
    return {"sites": len(devs),
            "tiles": sum(int(d["dead"].numel()) for d in devs),
            "dead_tiles": int(host[:, 2].sum()),
            "stuck_cols": int(host[:, 3].sum()),
            "mean_scale_err": err_sum / max(live_n, 1.0),
            "hours_since_cal": float(host[:, 4].max())}
