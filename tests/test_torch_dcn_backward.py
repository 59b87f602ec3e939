"""The port's DCN backward on the CPU.

* :func:`deform_conv2d_backward_plain` (NCHW) against the TPU kernel
  ``deform_conv2d_windowed_bwd_pallas`` in interpret mode (NHWC) on the same
  numpy inputs: all four gradients plus dbias, with offsets that are
  fractional, exactly integer, exactly +-D and past D, with and without a
  mask. rtol 2e-3, atol 2e-4, the JAX package's own tolerance for this kernel
  (``tests/test_pallas_dcn.py``: f32 sums over the 5x5 hat window in another
  order than the 4-corner form).
* The exact (unclamped) mode against ``jax.vjp(deform_conv2d)``, fractional
  offsets, same tolerance.
* The ``torch.autograd.Function`` against central finite differences in
  float64, offsets kept away from integers and from +-D (where the function
  has a kink), and its ``needs_input_grad`` handling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from fami_pose_tpu.ops.pallas.dcn_bwd import deform_conv2d_windowed_bwd_pallas
from fami_pose_torch.ops.deform_conv import (
    deform_conv2d, deform_conv2d_backward, deform_conv2d_backward_plain,
    deform_conv2d_windowed,
)

TOL = dict(rtol=2e-3, atol=2e-4)
N, H, W, C, G, C_OUT, D = 2, 16, 16, 8, 2, 6, 2


def _t(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _n(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(rng, kind, with_mask=True):
    """NHWC numpy inputs of the JAX package's DCN. ``kind`` picks the
    offsets: ``fractional`` (inside +-D), ``integer`` (every offset rounded),
    ``boundary`` (a third exactly +-D, the rest fractional) or ``past``
    (uniform in +-2D, half of them past the clamp)."""
    x = rng.randn(N, H, W, C).astype(np.float32)
    shape = (N, H, W, 2 * G * 9)
    if kind == "past":
        off = (rng.rand(*shape) * 2 - 1) * 2 * D
    else:
        off = (rng.rand(*shape) * 2 - 1) * (D - 0.05)
    if kind == "integer":
        off = np.round((rng.rand(*shape) * 2 - 1) * (D + 1))
    if kind == "boundary":
        pick = rng.rand(*shape)
        off = np.where(pick < 1 / 6, D, np.where(pick < 1 / 3, -D, off))
    off = off.astype(np.float32)
    msk = rng.rand(N, H, W, G * 9).astype(np.float32) if with_mask else None
    wgt = (rng.randn(3, 3, C, C_OUT) * 0.2).astype(np.float32)
    gout = rng.randn(N, H, W, C_OUT).astype(np.float32)
    return x, off, msk, wgt, gout


def _port_backward(x, off, msk, wgt, gout, max_offset):
    dx, doff, dmsk, dw = deform_conv2d_backward_plain(
        _t(x), _t(off), None if msk is None else _t(msk),
        torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
        _t(gout), padding=3, dilation=3, offset_groups=G,
        max_offset=max_offset,
    )
    return (_n(dx), _n(doff), None if dmsk is None else _n(dmsk),
            dw.numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("kind", ["fractional", "integer", "boundary", "past"])
def test_plain_backward_matches_pallas_backward(rng, kind, with_mask):
    x, off, msk, wgt, gout = _inputs(rng, kind, with_mask)
    ref = deform_conv2d_windowed_bwd_pallas(
        jnp.asarray(x), jnp.asarray(off),
        None if msk is None else jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(gout), padding=3, dilation=3, offset_groups=G,
        max_offset=D, row_block=8,
    )
    got = _port_backward(x, off, msk, wgt, gout, D)
    for name, g, r in zip(("dx", "doffset", "dmask", "dweight"), got, ref):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)
    if kind == "integer":
        assert not np.any(got[1]), "doffset is zero at integer offsets"
        assert np.any(got[0]) and np.any(got[3])
    if kind == "past":
        outside = np.abs(off) > D
        assert outside.mean() > 0.3 and not np.any(got[1][outside])


def test_bias_gradient_matches_pallas_dbias(rng):
    """dbias is a plain sum outside the kernel on both sides; the port gets
    it from autograd through the wrapper's bias add."""
    x, off, msk, wgt, gout = _inputs(rng, "past")
    ref = deform_conv2d_windowed_bwd_pallas(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(gout), padding=3, dilation=3, offset_groups=G,
        max_offset=D, row_block=8,
    )
    bias = torch.zeros(C_OUT, requires_grad=True)
    out = deform_conv2d_windowed(
        _t(x), _t(off), _t(msk),
        torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
        bias, padding=3, dilation=3, offset_groups=G, max_offset=D,
    )
    out.backward(_t(gout))
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(ref[4]), **TOL)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_exact_mode_matches_jax_vjp(rng, with_mask):
    x, off, msk, wgt, gout = _inputs(rng, "past", with_mask)

    def f(x, off, msk, wgt):
        return jax_deform_conv2d(x, off, msk, wgt, None, stride=1, padding=3,
                                 dilation=3, offset_groups=G)

    if with_mask:
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, off, msk, wgt)))
        rdx, rdoff, rdmsk, rdw = vjp(jnp.asarray(gout))
    else:
        _, vjp = jax.vjp(lambda a, b, c: f(a, b, None, c), jnp.asarray(x),
                         jnp.asarray(off), jnp.asarray(wgt))
        rdx, rdoff, rdw = vjp(jnp.asarray(gout))
        rdmsk = None
    got = _port_backward(x, off, msk, wgt, gout, None)
    for name, g, r in zip(("dx", "doffset", "dmask", "dweight"), got,
                          (rdx, rdoff, rdmsk, rdw)):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("max_offset", [2, None], ids=["D2", "exact"])
def test_function_matches_finite_differences(max_offset):
    """Central differences (step 1e-6, float64) of sum(out * gout) along a
    random direction of each input; tolerance 1e-6 relative to the slope."""
    rs = np.random.RandomState(5)
    n, c, h, w, g, c_out = 1, 4, 6, 5, 2, 3
    f64 = torch.float64
    x = torch.from_numpy(rs.randn(n, c, h, w))
    # fractional parts in [0.1, 0.9]: no kink within the step; some past D
    off = torch.from_numpy(np.floor(rs.rand(n, 2 * g * 9, h, w) * 8 - 4)
                           + 0.1 + 0.8 * rs.rand(n, 2 * g * 9, h, w))
    msk = torch.from_numpy(rs.rand(n, g * 9, h, w))
    wgt = torch.from_numpy(rs.randn(c_out, c, 3, 3) * 0.3)
    bias = torch.from_numpy(rs.randn(c_out))
    gout = torch.from_numpy(rs.randn(n, c_out, h, w))
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)

    def value(*args):
        return float((deform_conv2d_windowed(*args, **kw) * gout).sum())

    leaves = [t.clone().requires_grad_() for t in (x, off, msk, wgt, bias)]
    out = deform_conv2d_windowed(*leaves, **kw)
    assert out.dtype == f64
    grads = torch.autograd.grad(out, leaves, gout)
    base = [x, off, msk, wgt, bias]
    eps = 1e-6
    for i, name in enumerate(("x", "offset", "mask", "weight", "bias")):
        direction = torch.from_numpy(rs.randn(*base[i].shape))
        plus = [t + eps * direction if j == i else t for j, t in enumerate(base)]
        minus = [t - eps * direction if j == i else t for j, t in enumerate(base)]
        slope = (value(*plus) - value(*minus)) / (2 * eps)
        got = float((grads[i] * direction).sum())
        assert abs(got - slope) <= 1e-6 * max(1.0, abs(slope)), name


def test_function_skips_unneeded_gradients(rng):
    x, off, msk, wgt, gout = _inputs(rng, "fractional")
    tx, toff, tmsk = _t(x), _t(off).requires_grad_(), _t(msk)
    tw = torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1)))
    tw.requires_grad_()
    out = deform_conv2d_windowed(tx, toff, tmsk, tw, padding=3, dilation=3,
                                 offset_groups=G, max_offset=D)
    out.backward(_t(gout))
    assert tx.grad is None and tmsk.grad is None
    want = deform_conv2d_backward(tx, toff.detach(), tmsk, tw.detach(),
                                  _t(gout), padding=3, dilation=3,
                                  offset_groups=G, max_offset=D)
    assert torch.equal(toff.grad, want[1]) and torch.equal(tw.grad, want[3])


def test_backward_dtypes_follow_the_inputs(rng):
    """dx in x's dtype, doffset/dmask in the offsets', dweight in the
    weight's, computed in float32 from the bfloat16 values."""
    x, off, msk, wgt, gout = _inputs(rng, "integer")
    bf = torch.bfloat16
    args = [_t(x).to(bf), _t(off).to(bf), _t(msk).to(bf),
            torch.from_numpy(np.ascontiguousarray(
                wgt.transpose(3, 2, 0, 1))).to(bf), _t(gout).to(bf)]
    kw = dict(padding=3, dilation=3, offset_groups=G, max_offset=D)
    got = deform_conv2d_backward_plain(*args, **kw)
    assert all(g.dtype == bf for g in got)
    ref = deform_conv2d_backward_plain(*(a.float() for a in args), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r.to(bf))


def test_forward_unchanged_by_the_function(rng):
    """The Function's CPU forward is the plain forward."""
    x, off, msk, wgt, _ = _inputs(rng, "past")
    tw = torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1)))
    kw = dict(padding=3, dilation=3, offset_groups=G, max_offset=D)
    a = deform_conv2d_windowed(_t(x), _t(off), _t(msk), tw, **kw)
    b = deform_conv2d(_t(x), _t(off), _t(msk), tw, **kw)
    assert torch.equal(a, b)
