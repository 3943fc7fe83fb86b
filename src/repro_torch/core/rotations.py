"""SpinQuant-lite: rotation-based outlier removal for the PTQ baseline.

SpinQuant / QuaRot multiply the residual stream by an orthogonal matrix
``R``, folded into the adjacent weight matrices (so inference costs
nothing more), to spread activation outliers across channels before
quantization. This is the *random Hadamard* variant (SpinQuant's
initialization; its Cayley-learned refinement is an optimizer detail) and
the weight-folding transforms, as in the JAX package's
``core/rotations.py``.

The random signs and the QR draw come from the caller's
``torch.Generator``. Every fold is an fp32 product; with TF32 on, the
folded model's FP invariance breaks at about 1e-3, so the products here
run with ``allow_tf32`` off whatever the caller set.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls in full fp32 inside the block (TF32 off, restored on
    exit)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of size ``n`` (power of two), normalized."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def random_orthogonal(gen: torch.Generator, n: int,
                      device=None) -> torch.Tensor:
    """Haar-random orthogonal matrix [n, n] via QR of a normal draw, with
    the sign fix ``q * sign(diag(r))`` (for non-power-of-two dims)."""
    device = gen.device if device is None else device
    a = torch.randn((n, n), generator=gen, device=device,
                    dtype=torch.float32)
    with full_fp32():
        q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def random_hadamard(gen: torch.Generator, n: int,
                    device=None) -> torch.Tensor:
    """Random-signed Hadamard rotation ``R = H · diag(s)``, ``s ∈ {±1}^n``.

    Falls back to :func:`random_orthogonal` when ``n`` is not a power of
    two (e.g. d_model = 3072): the same variance spreading, exactly
    orthogonal either way.
    """
    device = gen.device if device is None else device
    if n & (n - 1) == 0:
        h = torch.as_tensor(hadamard_matrix(n), dtype=torch.float32,
                            device=device)
        s = torch.randint(0, 2, (n,), generator=gen, device=device
                          ).float() * 2.0 - 1.0
        return h * s[None, :]
    return random_orthogonal(gen, n, device)


def _scale_in(site: dict, s: torch.Tensor) -> dict:
    """Fold the norm scale ``s`` ([d], or [L, d] scan-stacked) into the
    input side of a site whose kernel is ``[..., d_in, d_out]`` with
    matching leading dims (a MoE's ``[L, E, d, f]`` broadcast over E)."""
    out = dict(site)
    k = site["kernel"].float()
    sb = s.float()[..., :, None]
    if sb.dim() < k.dim():
        sb = sb.reshape(tuple(sb.shape[:-2]) + (1,) * (k.dim() - sb.dim())
                        + tuple(sb.shape[-2:]))
    out["kernel"] = (k * sb).to(site["kernel"].dtype)
    return out


def _unit(norm: dict) -> dict:
    return dict(norm, scale=torch.ones_like(norm["scale"]))


def _fold_layer(layer: dict) -> dict:
    out = dict(layer)
    if "ln1" in layer:
        s = layer["ln1"]["scale"].float()
        if "attn" in layer:
            attn = dict(layer["attn"])
            for site in ("qkv", "q", "k", "v"):
                if site in attn:
                    attn[site] = _scale_in(attn[site], s)
            out["attn"] = attn
        if "mixer" in layer:
            mixer = dict(layer["mixer"])
            mixer["in_proj"] = _scale_in(mixer["in_proj"], s)
            out["mixer"] = mixer
        out["ln1"] = _unit(layer["ln1"])
    if "ln2" in layer and "ffn" in layer:
        s = layer["ln2"]["scale"].float()
        ffn = dict(layer["ffn"])
        for k in ("gate_up", "up", "router"):
            if k in ffn:
                ffn[k] = _scale_in(ffn[k], s)
        out["ffn"] = ffn
        out["ln2"] = _unit(layer["ln2"])
    return out


def fold_norm_scales(params: dict, cfg) -> dict:
    """Fold the norm scales into the downstream linear(s), leaving
    unit-scale norms (the SpinQuant/QuaRot prerequisite: a unit-scale
    RMSNorm commutes with an orthogonal rotation of the residual stream,
    since ``rms(xR) = rms(x)``).

    Folding map: ln1 → attn.qkv | mixer.in_proj; ln2 → ffn.{gate_up, up}
    and the MoE router; final_norm → lm_head. LayerNorm archs (dbrx)
    subtract the mean, which does not commute: their rotation is
    approximate, as in the reference. Returns a new tree; untouched leaves
    are shared.
    """
    def walk(node):
        if isinstance(node, dict):
            if "ln1" in node or ("ln2" in node and "ffn" in node):
                return _fold_layer({k: walk(v) for k, v in node.items()})
            return {k: walk(v) for k, v in node.items()}
        return node

    with full_fp32():
        out = walk(dict(params))
        if "lm_head" in out:
            out["lm_head"] = _scale_in(out["lm_head"],
                                       out["final_norm"]["scale"].float())
            out["final_norm"] = _unit(out["final_norm"])
    return out


def fold_rotation_into_linear(p: dict, r: torch.Tensor, side: str) -> dict:
    """Fold the residual rotation ``R`` into one linear site.

    ``side='in'``: the layer consumes the rotated stream, ``W' = Rᵀ W``.
    ``side='out'``: the layer writes into the rotated stream, ``W' = W R``
    (its bias rotated too). A kernel may have leading (layer, expert)
    dims; every product is full fp32.
    """
    out = dict(p)
    w = p["kernel"]
    with full_fp32():
        if side == "in":
            out["kernel"] = (r.T @ w.float()).to(w.dtype)
        elif side == "out":
            out["kernel"] = (w.float() @ r).to(w.dtype)
            if "bias" in p:
                out["bias"] = (p["bias"].float() @ r).to(p["bias"].dtype)
        else:
            raise ValueError(side)
    return out
