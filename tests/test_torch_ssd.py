"""The port's plain SSD versions against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages:

* ``ssd_chunked_ref`` equals ``ops.ssd_chunked_jnp`` within 1e-5 (the same
  chunked math in the same op order), the Pallas ``ssd_scan`` in interpret
  mode within 2e-4 (the reference's own bar between the two,
  ``tests/test_kernels.py``) and the sequential oracle ``ref.ssd_ref``
  within 5e-4 (the reference's bar for its kernel against the oracle);
* ``ssd_decode_step`` equals its reference within 1e-5;
* ``ssd_scan_ref``, the plain version of the port's ``ssd_scan`` kernel,
  equals the reference's ``ops.ssd`` plus ``mamba2._ssd_with_state``'s state
  terms within 1e-5, at ragged S, with groups shared by several heads, from
  a nonzero incoming state, final state included; and it equals the
  sequential oracle run from the same state;
* ``dt = 0`` positions are state-transparent: a fully masked chunk leaves
  the state bit for bit, and left pads give the unpadded run's state;
* the ``ssd_scan`` wrapper and ``dispatch.ssd`` run the plain version on
  CPU tensors and count no launch;
* the CUDA kernel's decomposition, emulated here in plain PyTorch at each
  chunk length its plan chooses: chunk summaries ``S_c = B^T (w x)`` and
  one ``C B^T`` per group, the state pass ``h_{c+1} = exp(total_c) h_c +
  S_c`` over chunks, and the outputs ``(C B^T ⊙ decay)(dt x) + exp(cums)
  (C h_c)``, every product in split TF32 (``cvt.rna.tf32.f32`` by integer
  operations, ``hi·lo + lo·hi + hi·hi``), equals the reference's
  ``_ssd_with_state`` within ``2e-4 * (1 + |ref|)`` (the tolerance the
  card holds the kernel to against its plain version) at small widths and
  at mamba2-130m's, from zero and from ``h0``, at ragged S and with left
  pads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.models import mamba2 as ref_mamba
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import ssd_scan as k_ssd
from test_torch_mvm import split_tf32

torch.set_num_threads(2)


def _bh_inputs(seed, bh, s, p, n):
    """x, dt, a, b, c in the kernel's [BH, S, ...] layout, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((bh, s)))).astype(
        np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(bh))).astype(np.float32)
    b = (0.3 * rng.standard_normal((bh, s, n))).astype(np.float32)
    c = (0.3 * rng.standard_normal((bh, s, n))).astype(np.float32)
    return x, dt, a, b, c


def _mixer_inputs(seed, bsz, s, h, p, g, n, with_h0=True):
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,G,N], h0 [B*H,N,P]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((bsz, s, h)))).astype(
        np.float32) * 0.5
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    b = (0.3 * rng.standard_normal((bsz, s, g, n))).astype(np.float32)
    c = (0.3 * rng.standard_normal((bsz, s, g, n))).astype(np.float32)
    h0 = (rng.standard_normal((bsz * h, n, p)).astype(np.float32)
          if with_h0 else None)
    return x, dt, a, b, c, h0


def _t(*arrays):
    return [None if v is None else torch.from_numpy(v) for v in arrays]


def _j(*arrays):
    return [None if v is None else jnp.asarray(v) for v in arrays]


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 16, 8, 16), (3, 37, 8, 4, 8), (2, 20, 16, 8, 32),
    (4, 128, 32, 16, 64)])
def test_chunked_matches_reference_jnp_path(bh, s, p, n, chunk):
    inputs = _bh_inputs(bh + s, bh, s, p, n)
    want = ref_ops.ssd_chunked_jnp(*_j(*inputs), chunk=chunk)
    got = ref.ssd_chunked_ref(*_t(*inputs), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 16, 8, 16), (3, 96, 8, 16, 32), (2, 128, 32, 8, 64)])
def test_chunked_matches_reference_pallas_kernel(bh, s, p, n, chunk):
    inputs = _bh_inputs(7 * s + n, bh, s, p, n)
    want = ref_ssd_scan(*_j(*inputs), chunk=chunk, interpret=True)
    got = ref.ssd_chunked_ref(*_t(*inputs), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 16, 8, 16), (3, 45, 8, 4, 16), (1, 130, 16, 16, 128)])
def test_chunked_matches_sequential_oracle(bh, s, p, n, chunk):
    inputs = _bh_inputs(3 * s + p, bh, s, p, n)
    want = ref_kref.ssd_ref(*_j(*inputs))
    got = ref.ssd_chunked_ref(*_t(*inputs), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    oracle = ref.ssd_ref(*_t(*inputs))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decode_step_matches_reference():
    x, dt, a, b, c = _bh_inputs(11, 4, 3, 8, 16)
    h = np.random.default_rng(12).standard_normal((4, 16, 8)).astype(
        np.float32)
    for t in range(3):
        args = (h, x[:, t], dt[:, t], a, b[:, t], c[:, t])
        h_ref, y_ref = ref_ops.ssd_decode_step(*_j(*args))
        h_got, y_got = ref.ssd_decode_step(*_t(*args))
        np.testing.assert_allclose(h_got.numpy(), np.asarray(h_ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y_got.numpy(), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)
        h = h_got.numpy()


def _reference_with_state(x, dt, a, b, c, h0):
    """The reference's ``_ssd_with_state``, whose ``kops.ssd`` takes its CPU
    path (the chunked jnp version)."""
    y, h = ref_mamba._ssd_with_state(*_j(x, dt, a, b, c, h0))
    return np.asarray(y), np.asarray(h)


# (B, S, H, P, G, N): ragged S below and above the reference's chunk of
# 128, groups shared by 2 and 4 heads, one S a multiple of 128
MIXER_SHAPES = [(2, 13, 4, 16, 2, 8), (1, 37, 4, 8, 1, 16),
                (2, 130, 4, 16, 2, 8), (1, 128, 2, 8, 1, 4),
                (3, 1, 4, 8, 2, 8)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", MIXER_SHAPES, ids=str)
def test_scan_plain_version_matches_reference_with_state(shape, with_h0):
    bsz, s, h, p, g, n = shape
    x, dt, a, b, c, h0 = _mixer_inputs(sum(shape), *shape, with_h0=with_h0)
    y_ref, h_ref = _reference_with_state(x, dt, a, b, c, h0)
    y, hf = ref.ssd_scan_ref(*_t(x, dt, a, b, c, h0))
    assert y.dtype == hf.dtype == torch.float32
    assert tuple(y.shape) == (bsz, s, h, p) and tuple(hf.shape) == (
        bsz * h, n, p)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), h_ref, rtol=1e-5, atol=1e-5)


def test_scan_plain_version_matches_sequential_oracle_from_h0():
    """Groups → heads and the incoming state, against the oracle run on the
    repeated, flattened inputs from the same state (tolerance 5e-4, the
    reference's bar against its oracle)."""
    bsz, s, h, p, g, n = 2, 45, 4, 8, 2, 8
    x, dt, a, b, c, h0 = _mixer_inputs(5, bsz, s, h, p, g, n)

    def to_bh(t):
        return np.moveaxis(np.repeat(t, h // g, axis=2), 2, 1).reshape(
            bsz * h, s, -1)

    xf = np.moveaxis(x, 2, 1).reshape(bsz * h, s, p)
    dtf = np.moveaxis(dt, 2, 1).reshape(bsz * h, s)
    oracle = ref_kref.ssd_ref(*_j(xf, dtf, np.tile(a, bsz), to_bh(b),
                                  to_bh(c), h0))
    want = np.moveaxis(np.asarray(oracle).reshape(bsz, h, s, p), 1, 2)
    y, _ = ref.ssd_scan_ref(*_t(x, dt, a, b, c, h0))
    np.testing.assert_allclose(y.numpy(), want, rtol=5e-4, atol=5e-4)


def test_masked_positions_are_state_transparent():
    """``dt = 0`` (with zeroed x, as the mixer masks) passes the state
    through: a fully masked chunk returns h0 bit for bit, and a run with
    left pads ends in the unpadded run's state."""
    bsz, s, h, p, g, n = 2, 8, 4, 8, 2, 8
    x, dt, a, b, c, h0 = _mixer_inputs(9, bsz, s, h, p, g, n)
    z = np.zeros_like
    _, h_masked = ref.ssd_scan_ref(*_t(z(x), z(dt), a, b, c, h0))
    assert torch.equal(h_masked, torch.from_numpy(h0))

    pad = 5
    xp = np.concatenate([z(x[:, :pad]), x], axis=1)
    dtp = np.concatenate([z(dt[:, :pad]), dt], axis=1)
    bp = np.concatenate([b[:, :pad], b], axis=1)
    cp = np.concatenate([c[:, :pad], c], axis=1)
    y, h_plain = ref.ssd_scan_ref(*_t(x, dt, a, b, c, h0))
    yp, h_padded = ref.ssd_scan_ref(*_t(xp, dtp, a, bp, cp, h0))
    assert torch.equal(h_padded, h_plain)
    np.testing.assert_allclose(yp[:, pad:].numpy(), y.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrapper_and_dispatch_run_the_plain_version_on_cpu():
    x, dt, a, b, c, h0 = _mixer_inputs(2, 2, 19, 4, 16, 2, 8)
    xt, dtt, at, bt, ct, h0t = _t(x, dt, a, b, c, h0)
    want = ref.ssd_scan_ref(xt, dtt, at, bt, ct, h0t)
    before = k_ssd.launches
    for got in (k_ssd.ssd_scan(xt, dtt, at, bt, ct, h0t),
                dispatch.ssd(xt, dtt, at, bt, ct, h0t)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    # a strided view of a wider projection, as the mixer hands it over
    wide = torch.zeros(2, 19, 4 * 16 + 5)
    wide[..., :64] = xt.reshape(2, 19, 64)
    view = wide[..., :64].reshape(2, 19, 4, 16)
    assert not view.is_contiguous()
    y, hf = dispatch.ssd(view, dtt, at, bt, ct, h0t)
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    assert k_ssd.launches == before == 0
    with pytest.raises(ValueError, match="multiple"):
        dispatch.ssd(xt[:, :, :3], dtt[:, :, :3], at[:3], bt, ct)


# ---------------------------------------------------------------------------
# emulation of the CUDA kernel's passes (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

#: the chunk lengths ``ssd_scan_plan`` chooses: 32 for S <= 32, else 64
KERNEL_CHUNKS = (32, 64)
#: |emulation - reference| <= SSD_TOL * (1 + |reference|), y and state
SSD_TOL = 2e-4


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's mma does it: both operands split into TF32
    ``hi + lo`` and the products ``lo·hi + hi·lo + hi·hi`` summed in fp32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_emulation(x, dt, a, b, c, h0, chunk):
    """The three passes of ``ssd_scan.cu`` in plain PyTorch (a scan of one
    chunk runs the same arithmetic in one launch). Shapes as
    ``ssd_scan``; returns (y [B, S, H, P], final state [B·H, N, P])."""
    bsz, s, heads, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):          # [B, S, K, ...] -> [B, K, nc, L, ...], padded
        t = torch.movedim(t, 2, 1)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, pad))
        return t.reshape(*t.shape[:2], nc, chunk, *t.shape[3:])

    xc = chunks(x)                                   # [B, H, nc, L, P]
    dtc = chunks(dt[..., None])[..., 0]              # [B, H, nc, L]
    bc = chunks(b).repeat_interleave(heads // g, 1)  # [B, H, nc, L, N]
    cc = chunks(c).repeat_interleave(heads // g, 1)
    cbt = _mm3(chunks(c), chunks(b).transpose(-1, -2))   # per group
    cbt = cbt.repeat_interleave(heads // g, 1)       # [B, H, nc, L, L]
    cums = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    total = cums[..., -1]
    # 1. chunk pass: S_c = B^T (w x)
    w_r = torch.exp(total[..., None] - cums) * dtc
    sums = _mm3(bc.transpose(-1, -2), w_r[..., None] * xc)   # [.., N, P]
    # 2. state pass: the state entering each chunk, and the final state
    h = (torch.zeros(bsz, heads, n, pdim) if h0 is None
         else h0.reshape(bsz, heads, n, pdim))
    entering = []
    for ci in range(nc):
        entering.append(h)
        h = torch.exp(total[..., ci])[..., None, None] * h + sums[:, :, ci]
    hc = torch.stack(entering, dim=2)                # [B, H, nc, N, P]
    # 3. output pass
    rel = cums[..., :, None] - cums[..., None, :]
    mask = torch.ones(chunk, chunk).tril().bool()
    m = torch.where(mask, cbt * torch.exp(torch.clamp(rel, max=0.0)),
                    torch.zeros(()))
    y = (_mm3(m, dtc[..., None] * xc)
         + torch.exp(cums)[..., None] * _mm3(cc, hc))
    y = y.reshape(bsz, heads, nc * chunk, pdim)[:, :, :s]
    return torch.movedim(y, 1, 2), h.reshape(bsz * heads, n, pdim)


def _assert_ssd_tol(got, want):
    got, want = got.numpy(), np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= SSD_TOL * (1 + np.abs(want))), float(err.max())


# (B, S, H, P, G, N): one chunk and ragged multi-chunk S at each L, groups
# shared by 2 and 3 heads, jamba's N = 16 and P = 48; then mamba2-130m's
# head widths (H 24, P 64, N 128, G 1) at S up to 256
EMULATED = [(2, 13, 4, 16, 2, 16), (1, 100, 4, 16, 1, 16),
            (2, 130, 4, 32, 2, 32), (3, 64, 6, 48, 3, 16),
            (1, 256, 24, 64, 1, 128), (2, 45, 24, 64, 1, 128)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("chunk", KERNEL_CHUNKS)
@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_kernel_passes_match_reference_with_state(shape, chunk, with_h0):
    x, dt, a, b, c, h0 = _mixer_inputs(3 * sum(shape), *shape,
                                       with_h0=with_h0)
    y_ref, h_ref = _reference_with_state(x, dt, a, b, c, h0)
    y, hf = _kernel_emulation(*_t(x, dt, a, b, c, h0), chunk=chunk)
    _assert_ssd_tol(y, y_ref)
    _assert_ssd_tol(hf, h_ref)


@pytest.mark.parametrize("chunk", KERNEL_CHUNKS)
def test_kernel_passes_left_pads_and_masked_state(chunk):
    """Left pads (dt = x = b = c = 0) are transparent in the emulated
    passes, as in the reference, and a fully masked sequence returns h0 bit
    for bit (exp(0) h0 + 0 at every chunk)."""
    bsz, s, h, p, g, n = 2, 70, 24, 64, 1, 128
    x, dt, a, b, c, h0 = _mixer_inputs(21, bsz, s, h, p, g, n)
    pads = np.array([11, 0])
    live = (np.arange(s)[None] >= pads[:, None]).astype(np.float32)
    x, dt = x * live[..., None, None], dt * live[..., None]
    b, c = b * live[..., None, None], c * live[..., None, None]
    y_ref, h_ref = _reference_with_state(x, dt, a, b, c, h0)
    y, hf = _kernel_emulation(*_t(x, dt, a, b, c, h0), chunk=chunk)
    _assert_ssd_tol(y, y_ref)
    _assert_ssd_tol(hf, h_ref)
    z = np.zeros_like
    _, h_masked = _kernel_emulation(*_t(z(x), z(dt), a, b, c, h0),
                                    chunk=chunk)
    assert torch.equal(h_masked, torch.from_numpy(h0))
