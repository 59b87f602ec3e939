"""The port's plain DCN at the widths its kernels take on the card beyond
the main path's (C = 96 and 192, C_out = 6, 24 and 96, one or two offset
groups: the deform blocks inside HRNet-W48's branches), forward and every
gradient, against the JAX package's exact ``deform_conv2d`` and ``jax.vjp``
of it on the same numpy inputs (NHWC there, NCHW here).

Tolerance: 2e-4 of each output's largest magnitude, the absolute part of
``tests/test_torch_dcn_backward.py``'s tolerance taken in scale (f32 sums
over up to 9C = 1,728 products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from fami_pose_torch.ops.deform_conv import (
    deform_conv2d, deform_conv2d_backward_plain,
)

ATOL = 2e-4


def _t(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("c_out", [6, 24, 96])
@pytest.mark.parametrize("c", [96, 192])
def test_plain_dcn_at_the_blocks_widths_matches_jax(c, c_out, g):
    """The deform blocks' settings (exact, dilation and padding 1, a mask
    with two groups, none with one) at the widths the kernels now take on
    the card: the plain forward and all its gradients against JAX's
    ``deform_conv2d`` and ``jax.vjp`` of it, on a 6x5 plane with offsets
    ~N(0, 2) px."""
    rng = np.random.RandomState(c + c_out + g)
    n, h, w = 1, 6, 5
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = (rng.randn(n, h, w, 18 * g) * 2).astype(np.float32)
    msk = rng.rand(n, h, w, 9 * g).astype(np.float32) if g > 1 else None
    wgt = (rng.randn(3, 3, c, c_out) / np.sqrt(9 * c)).astype(np.float32)
    gout = rng.randn(n, h, w, c_out).astype(np.float32)

    def f(x, off, wgt, *msk):
        return jax_deform_conv2d(x, off, msk[0] if msk else None, wgt, None,
                                 stride=1, padding=1, dilation=1,
                                 offset_groups=g)

    args = [jnp.asarray(a) for a in (x, off, wgt)] + (
        [jnp.asarray(msk)] if msk is not None else [])
    ref, vjp = jax.vjp(f, *args)
    rdx, rdoff, rdw, *rdmsk = vjp(jnp.asarray(gout))
    w_t = torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1)))
    m_t = None if msk is None else _t(msk)
    kw = dict(padding=1, dilation=1, offset_groups=g, max_offset=None)
    got = deform_conv2d(_t(x), _t(off), m_t, w_t, **kw)
    grads = deform_conv2d_backward_plain(_t(x), _t(off), m_t, w_t, _t(gout),
                                         **kw)
    want = {"out": (_n(got), ref), "dx": (_n(grads[0]), rdx),
            "doffset": (_n(grads[1]), rdoff),
            "dweight": (grads[3].numpy().transpose(2, 3, 1, 0), rdw)}
    if msk is not None:
        want["dmask"] = (_n(grads[2]), rdmsk[0])
    else:
        assert grads[2] is None
    for name, (a, r) in want.items():
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(a, r, rtol=0, atol=ATOL * scale,
                                   err_msg=name)
