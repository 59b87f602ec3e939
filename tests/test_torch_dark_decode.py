"""The port's DARK decode (``fami_pose_torch/ops/heatmap.py``:
``_gaussian_kernel1d``, ``dark_blur``, ``taylor_refine``,
``dark_get_final_preds``) against the JAX functions on the same numpy
heatmaps, in float32.

Tolerances: the blur 1e-6 of the map's maximum (two 11-tap sums in another
order); the Taylor step on one and the same log-heatmap 1e-5 px; decoded
coordinates 1e-3 heatmap px on Gaussian heatmaps, which in image
coordinates is 1e-3 times the box's image pixels per heatmap pixel (2.5 to
9.4 here; the blur's last-bit differences change with the thread count of
either framework's convolution, and reach 2e-4 heatmap px), and on random
heatmaps that bound times the larger of 1 and the Newton step's own length
in heatmap pixels (a random map's Hessian is near-singular at many maxima,
and the step then multiplies the blur's 1e-7 differences by its own size:
steps of tens of pixels occur); maxvals 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.ops import heatmap as jax_hm
from fami_pose_torch.ops import heatmap as port_hm

H, W = 32, 24


def _gaussian_heatmaps(rs, b=3, j=17, sigma=2.0, at=None):
    """Gaussians with sub-pixel centres (``at`` overrides them)."""
    mu = rs.uniform([4.0, 4.0], [W - 5.0, H - 5.0], size=(b, j, 2))
    if at is not None:
        mu[...] = at
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    d2 = ((xs - mu[..., 0, None, None]) ** 2
          + (ys - mu[..., 1, None, None]) ** 2)
    amp = rs.uniform(0.3, 1.0, size=(b, j, 1, 1))
    return (amp * np.exp(-d2 / (2 * sigma ** 2))).astype(np.float32), mu


def _boxes(rs, b):
    center = rs.uniform(40, 200, size=(b, 2)).astype(np.float32)
    scale = rs.uniform(0.4, 1.5, size=(b, 1)).astype(np.float32) * np.array(
        [0.75, 1.0], np.float32)
    return center, scale


def _px_tol(scale):
    """1e-3 heatmap px in image pixels, per sample: (B, 1, 1)."""
    return (1e-3 * scale[:, 0] * 200.0 / W)[:, None, None]


def _assert_coords_close(got, ref, scale):
    err = np.abs(got.numpy() - np.asarray(ref))
    assert (err <= _px_tol(scale)).all(), float((err / _px_tol(scale)).max())


def _both(fn, hm, *args):
    ref = getattr(jax_hm, fn)(jnp.asarray(hm), *map(jnp.asarray, args))
    got = getattr(port_hm, fn)(torch.from_numpy(hm),
                               *map(torch.from_numpy, args))
    return got, ref


@pytest.mark.parametrize("ksize", [3, 11, 15])
def test_gaussian_kernel1d_matches(ksize):
    np.testing.assert_array_equal(port_hm._gaussian_kernel1d(ksize),
                                  jax_hm._gaussian_kernel1d(ksize))


@pytest.mark.parametrize("kind", ["gaussian", "random", "huge", "zero"])
def test_dark_blur_matches(kind):
    rs = np.random.RandomState(0)
    if kind == "gaussian":
        hm, _ = _gaussian_heatmaps(rs)
    elif kind == "random":
        hm = rs.rand(2, 17, H, W).astype(np.float32)
    elif kind == "huge":  # x * orig_max would overflow; the ratio does not
        hm = (rs.rand(2, 5, H, W) * 3e27).astype(np.float32)
    else:
        hm = np.zeros((1, 3, H, W), np.float32)
    got, ref = _both("dark_blur", hm)
    ref = np.asarray(ref)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * max(float(ref.max()), 1e-30))
    if kind != "zero":  # the blur keeps each map's maximum
        np.testing.assert_allclose(got.amax((2, 3)).numpy(), hm.max((2, 3)),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["gaussian", "random"])
def test_taylor_refine_matches_on_the_same_log_heatmap(kind):
    rs = np.random.RandomState(1)
    hm = (_gaussian_heatmaps(rs)[0] if kind == "gaussian"
          else rs.rand(3, 17, H, W).astype(np.float32))
    log_hm = np.log(np.maximum(np.asarray(jax_hm.dark_blur(jnp.asarray(hm))),
                               1e-10))
    coords = np.asarray(jax_hm.get_max_preds(jnp.asarray(hm))[0])
    got, ref = _both("taylor_refine", log_hm, coords)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_taylor_refine_border_and_zero_determinant_guards():
    """No move where the maximum lies within two pixels of the border, nor
    where the Hessian's determinant is exactly zero (a flat map); a move
    elsewhere. Both sides agree on every case."""
    rs = np.random.RandomState(2)
    hm, _ = _gaussian_heatmaps(rs, b=1, j=6)
    log_hm = np.log(np.maximum(hm, 1e-10))
    log_hm[0, 4] = 0.5   # flat: det == 0 at an interior point
    log_hm[0, 5] = 0.25  # flat too
    coords = np.array([[[1, 10], [W - 2, 10], [10, 1], [10, H - 2],
                        [12, 12], [5, 20]]], np.float32)
    got, ref = _both("taylor_refine", log_hm, coords)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), coords)  # every case guarded
    inside = np.array([[[10, 10]] * 6], np.float32)
    moved, ref2 = _both("taylor_refine", log_hm, inside)
    np.testing.assert_allclose(moved.numpy(), np.asarray(ref2), rtol=0,
                               atol=1e-5)
    assert np.all(moved.numpy()[0, :4] != inside[0, :4])
    np.testing.assert_array_equal(moved.numpy()[0, 4:], inside[0, 4:])


def test_dark_get_final_preds_on_gaussians():
    rs = np.random.RandomState(3)
    hm, mu = _gaussian_heatmaps(rs)
    center, scale = _boxes(rs, hm.shape[0])
    (preds, maxvals), (ref_p, ref_m) = _both("dark_get_final_preds", hm,
                                             center, scale)
    _assert_coords_close(preds, ref_p, scale)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_m), rtol=0,
                               atol=1e-6)
    # and it does what DARK is for: the sub-pixel centres come back (in
    # heatmap pixels, through the forward affine's inverse on both sides)
    want = port_hm.transform_preds(torch.from_numpy(mu.astype(np.float32)),
                                   center, scale, (W, H))
    px_per_hm = float(scale.max()) * 200.0 / W
    assert float((preds - want).abs().max()) <= 0.05 * px_per_hm


def test_dark_get_final_preds_at_the_border():
    """Maxima on the border rows and columns: the guard leaves the argmax
    as it is, on both sides."""
    rs = np.random.RandomState(4)
    at = np.array([[0.0, 5.0], [W - 1.0, 7.0], [6.0, 0.0], [9.0, H - 1.0],
                   [1.0, 1.0]])
    hm, _ = _gaussian_heatmaps(rs, b=2, j=5, at=at)
    center, scale = _boxes(rs, 2)
    (preds, maxvals), (ref_p, ref_m) = _both("dark_get_final_preds", hm,
                                             center, scale)
    _assert_coords_close(preds, ref_p, scale)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_m), rtol=0,
                               atol=1e-6)
    plain = port_hm.transform_preds(
        port_hm.get_max_preds(torch.from_numpy(hm))[0], center, scale, (W, H))
    np.testing.assert_allclose(preds.numpy(), plain.numpy(), atol=1e-5)


@pytest.mark.parametrize("kind", ["uniform", "signed", "bf16"])
def test_dark_get_final_preds_on_random_heatmaps(kind):
    """Heatmaps that are not Gaussians, as seeded random weights give them:
    negative values (the log's floor), bf16-rounded values (computed in
    float32 on both sides)."""
    rs = np.random.RandomState(5)
    hm = rs.rand(3, 17, H, W).astype(np.float32)
    if kind == "signed":
        hm = (hm - 0.7) * 4.0
    port_in = torch.from_numpy(hm)
    if kind == "bf16":
        port_in = port_in.bfloat16()
        hm = port_in.float().numpy()
    center, scale = _boxes(rs, 3)
    ref_p, ref_m = jax_hm.dark_get_final_preds(
        jnp.asarray(hm), jnp.asarray(center), jnp.asarray(scale))
    preds, maxvals = port_hm.dark_get_final_preds(port_in, center, scale)
    assert preds.dtype == torch.float32 and maxvals.dtype == torch.float32
    assert np.all(np.isfinite(preds.numpy()))
    start = port_hm.transform_preds(
        port_hm.get_max_preds(torch.from_numpy(hm))[0], center, scale, (W, H))
    unit = torch.from_numpy(_px_tol(scale)[..., 0])  # 1e-3 heatmap px
    step = (torch.from_numpy(np.asarray(ref_p)) - start).abs().amax(-1)
    tol = unit * torch.clamp(step / (1e3 * unit), min=1.0)
    err = (preds - torch.from_numpy(np.asarray(ref_p))).abs().amax(-1)
    assert bool((err <= tol).all()), float((err / tol).max())
    # many joints take a step under a heatmap pixel: held to the plain bound
    assert float((tol <= unit).float().mean()) > 0.25
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_m), rtol=0,
                               atol=1e-6)
