"""The port's translation-warp backward on the CPU, against ``jax.vjp`` of
the JAX package's warps on the same numpy inputs (shifts past the clamp and
integer shifts included), and against finite differences.

Tolerance: d_images 1e-5 (four products per element); d_offsets 2e-4
relative to their scale (float32 sums over C*H*W products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.ops.warp import warp_translate as jax_warp_slice
from fami_pose_tpu.ops.warp import warp_translate_matmul as jax_warp_matmul
from fami_pose_torch.ops.warp import (
    warp_translate, warp_translate_backward_plain, warp_translate_plain,
)
from torch_port_helpers import nchw, nhwc

OFFSETS = np.array([[1.3, -2.6], [40.0, 0.5], [3.0, -2.0], [0.25, -50.0],
                    [-25.5, 25.75], [0.0, 7.0]], np.float32)


def _data(rng):
    img = rng.randn(6, 9, 11, 5).astype(np.float32)
    gout = rng.randn(6, 9, 11, 5).astype(np.float32)
    return img, gout


@pytest.mark.parametrize("impl", ["matmul", "slice"])
def test_warp_backward_matches_jax_vjp(rng, impl):
    img, gout = _data(rng)
    if impl == "matmul":
        fn, shift = (lambda a, t: jax_warp_matmul(a, t, max_shift=26)), 26
    else:
        fn, shift = jax_warp_slice, 32
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(OFFSETS))
    r_img, r_off = vjp(jnp.asarray(gout))
    d_img, d_off = warp_translate_backward_plain(
        nchw(img), torch.from_numpy(OFFSETS), nchw(gout), shift)
    np.testing.assert_allclose(nhwc(d_img), np.asarray(r_img), atol=1e-5,
                               rtol=1e-5)
    scale = float(np.abs(np.asarray(r_off)).max())
    np.testing.assert_allclose(d_off.numpy(), np.asarray(r_off), rtol=2e-4,
                               atol=2e-4 * scale)
    past = np.abs(OFFSETS) > shift
    assert past.any() and not np.any(d_off.numpy()[past])
    # rows whose shift keeps the 9x11 image in view, two of them integer
    assert np.all(d_off.numpy()[[0, 2, 5]] != 0)


def test_warp_function_routes_both_gradients(rng):
    img, gout = _data(rng)
    a = nchw(img).requires_grad_()
    t = torch.from_numpy(OFFSETS.copy()).requires_grad_()
    out = warp_translate(a, t, max_shift=26)
    assert torch.equal(out, warp_translate_plain(a, t, 26))
    out.backward(nchw(gout))
    want = warp_translate_backward_plain(a.detach(), t.detach(), nchw(gout), 26)
    assert torch.equal(a.grad, want[0]) and torch.equal(t.grad, want[1])
    # offsets without a gradient: only the images' comes back
    a2 = nchw(img).requires_grad_()
    warp_translate(a2, torch.from_numpy(OFFSETS), max_shift=26).backward(
        nchw(gout))
    assert torch.equal(a2.grad, want[0])


def test_warp_offset_gradient_is_right_hand_at_integers():
    """Forward differences of sum(out * gout) in t (float64 arithmetic on
    float32 storage is not available, so a step of 1e-2 on a smooth image
    and 1e-3 relative tolerance): at an integer shift the derivative is the
    right-hand one."""
    rs = np.random.RandomState(0)
    ys, xs = np.meshgrid(np.arange(12), np.arange(10), indexing="ij")
    img = np.sin(0.3 * ys + 0.2 * xs)[None, None].astype(np.float32)
    img = torch.from_numpy(np.repeat(img, 3, axis=0))
    gout = torch.from_numpy(rs.randn(3, 1, 12, 10).astype(np.float32))
    t = torch.tensor([[2.0, -1.0], [0.4, 0.6], [-3.0, 3.0]])
    _, d_off = warp_translate_backward_plain(img, t, gout, 26)
    # the warp is linear in the fraction between two integers: a forward
    # step of 0.5 gives the right-hand slope exactly
    for axis in (0, 1):
        step = torch.zeros_like(t)
        step[:, axis] = 0.5
        f0 = (warp_translate_plain(img, t, 26) * gout).sum(dim=(1, 2, 3))
        f1 = (warp_translate_plain(img, t + step, 26) * gout).sum(dim=(1, 2, 3))
        slope = (f1 - f0) / 0.5
        rows = [0, 2]  # the integer shifts
        np.testing.assert_allclose(d_off[rows, axis].numpy(),
                                   slope[rows].numpy(), rtol=1e-3, atol=1e-4)


def test_warp_backward_dtypes(rng):
    img, gout = _data(rng)
    bf = torch.bfloat16
    d_img, d_off = warp_translate_backward_plain(
        nchw(img).to(bf), torch.from_numpy(OFFSETS).to(bf), nchw(gout).to(bf),
        26)
    assert d_img.dtype == bf and d_off.dtype == bf
