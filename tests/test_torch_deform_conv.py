"""The port's plain DCN (``fami_pose_torch.ops.deform_conv``, NCHW) against
the JAX package's DCNs (NHWC) on the same numpy inputs: the exact gather
``deform_conv2d``, the windowed ``deform_conv2d_windowed`` and the Pallas
kernel ``deform_conv2d_pallas`` (interpret mode on the CPU).

Tolerance: 2e-4 absolute and relative, as the JAX package's own DCN tests
(f32 sums taken in a different order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fami_pose_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from fami_pose_tpu.ops.deform_conv import deform_conv2d_windowed as jax_windowed
from fami_pose_tpu.ops.pallas.dcn import deform_conv2d_pallas
from fami_pose_torch.ops.deform_conv import deform_conv2d, deform_conv2d_windowed

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, n=2, h=12, w=10, c=8, g=2, d=2.0, c_out=6, spread=2.0):
    """NHWC numpy inputs; offsets uniform in [-spread*d, spread*d] so about
    half of them exceed the clamp. A few offsets sit exactly on +-d."""
    k = 9
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = ((rng.rand(n, h, w, 2 * g * k) * 2 - 1) * spread * d).astype(np.float32)
    off.reshape(-1)[::7] = d
    off.reshape(-1)[3::11] = -d
    msk = rng.rand(n, h, w, g * k).astype(np.float32)
    wgt = (rng.randn(3, 3, c, c_out) * 0.2).astype(np.float32)
    bias = rng.randn(c_out).astype(np.float32)
    return x, off, msk, wgt, bias


def _port(x, off, msk, wgt, bias, **kw):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    out = deform_conv2d_windowed(
        t(x), t(off), None if msk is None else t(msk),
        torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
        None if bias is None else torch.from_numpy(bias), **kw,
    )
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("max_offset", [None, 0])
def test_exact_matches_jax_gather(rng, dilation, max_offset):
    x, off, msk, wgt, bias = _inputs(rng)
    ref = jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(bias), padding=dilation, dilation=dilation,
    )
    got = _port(x, off, msk, wgt, bias, padding=dilation, dilation=dilation,
                max_offset=max_offset)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("max_offset", [1, 2, 4])
def test_windowed_matches_jax(rng, dilation, max_offset):
    x, off, msk, wgt, bias = _inputs(rng, d=float(max_offset))
    ref = jax_windowed(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(bias), padding=dilation, dilation=dilation,
        max_offset=max_offset,
    )
    got = _port(x, off, msk, wgt, bias, padding=dilation, dilation=dilation,
                max_offset=max_offset)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_windowed_no_mask_no_bias(rng):
    x, off, _, wgt, _ = _inputs(rng)
    ref = jax_windowed(
        jnp.asarray(x), jnp.asarray(off), None, jnp.asarray(wgt), None,
        padding=3, dilation=3, max_offset=2,
    )
    got = _port(x, off, None, wgt, None, padding=3, dilation=3, max_offset=2)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_clamp_is_the_function(rng):
    """Clamping at D then the exact DCN == the windowed DCN: offsets at and
    beyond D give the same output as offsets clipped to D by hand."""
    x, off, msk, wgt, bias = _inputs(rng, d=2.0, spread=3.0)
    clipped = np.clip(off, -2.0, 2.0)
    a = _port(x, off, msk, wgt, bias, padding=3, dilation=3, max_offset=2)
    b = _port(x, clipped, msk, wgt, bias, padding=3, dilation=3, max_offset=None)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_offset,kernel_version", [(2, 3), (1, 9)])
def test_matches_pallas_kernel(rng, max_offset, kernel_version):
    """The live TPU kernel bodies (v3 for D >= 2, v9 at D = 1), interpreted."""
    x, off, msk, wgt, bias = _inputs(rng, n=1, h=8, w=8, c=4, g=2, c_out=4,
                                     d=float(max_offset))
    ref = deform_conv2d_pallas(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(bias), padding=3, dilation=3, offset_groups=2,
        max_offset=max_offset, row_block=8, kernel_version=kernel_version,
    )
    got = _port(x, off, msk, wgt, bias, padding=3, dilation=3,
                offset_groups=2, max_offset=max_offset)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_plain_deform_conv2d_strided_matches_jax(rng):
    """The general plain DCN (stride 2) against the JAX gather DCN."""
    x, _, _, wgt, bias = _inputs(rng)
    off = (rng.randn(2, 6, 5, 36) * 1.5).astype(np.float32)
    msk = rng.rand(2, 6, 5, 18).astype(np.float32)
    ref = jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(bias), stride=2, padding=1, dilation=1,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    got = deform_conv2d(
        t(x), t(off), t(msk),
        torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
        torch.from_numpy(bias), stride=2, padding=1, dilation=1,
    )
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), **TOL)


def test_bf16_input_keeps_dtype(rng):
    """bf16 in -> bf16 out, computed in f32 (the kernel's contract)."""
    x, off, msk, wgt, bias = _inputs(rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    args = (t(x), t(off), t(msk),
            torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))))
    out = deform_conv2d_windowed(
        *[a.to(torch.bfloat16) for a in args], padding=3, dilation=3,
        max_offset=2,
    )
    ref = deform_conv2d_windowed(
        *[a.to(torch.bfloat16).float() for a in args], padding=3, dilation=3,
        max_offset=2,
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())


def test_wrapper_counts_no_launch_on_cpu(rng):
    x, off, msk, wgt, bias = _inputs(rng)
    before = deform_conv2d_windowed.launches
    _port(x, off, msk, wgt, bias, padding=3, dilation=3, max_offset=2)
    assert deform_conv2d_windowed.launches == before


def test_wrapper_refuses_a_device_without_kernel(rng):
    """Off the CPU the wrapper launches the kernel or raises; it never falls
    back to the plain version."""
    x, off, msk, wgt, _ = _inputs(rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("meta")
    with pytest.raises(ValueError, match="no DCN kernel"):
        deform_conv2d_windowed(t(x), t(off), t(msk), t(wgt), max_offset=2)
