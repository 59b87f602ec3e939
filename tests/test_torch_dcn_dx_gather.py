"""The plain gather-form dx of the windowed DCN on the CPU.

:func:`deform_conv2d_dx_gather_plain` walks the window in the order of the
card's ``dcn_bwd.cu::dx_gather_kernel`` (taps, then the displacements of
``[-R, R]^2`` row by row, R = ceil(D)), each input pixel summing its own
sources. It is held

* to the dx of the TPU kernel ``deform_conv2d_windowed_bwd_pallas`` in
  interpret mode (NHWC) on the same numpy inputs, at 1e-5 of dx's scale (f32
  sums over the hat window in another order);
* to the dx of :func:`deform_conv2d_backward_plain`'s scatter, at 1e-6 of
  dx's scale (the same products in another order);

at D in {1, 4, 6}, dilation 3 with padding 3, G = 12 groups of 4 channels
and groups of Cg in {1, 3, 8}, on offsets that are fractional, integers,
exactly +-D and beyond +-D, with and without a mask; and to the scatter at
the card's widest windows, D = 16 (its 64-bit hit masks) and 31, past
which the card's backward refuses the call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.ops.pallas.dcn_bwd import deform_conv2d_windowed_bwd_pallas
from fami_pose_torch.ops.deform_conv import (
    MAX_GATHER_OFFSET, _check_backward_args, deform_conv2d_backward_plain,
    deform_conv2d_dx_gather_plain,
)

C_OUT = 8


def _inputs(seed, n, h, w, g, cg, d, with_mask=True):
    """NHWC numpy inputs: a quarter of the offsets integers (from -D-1 to
    D+1), a sixth exactly +-D, a quarter beyond +-D (up to 2D), the rest
    fractional inside the window."""
    rng = np.random.RandomState(seed)
    c = g * cg
    x = rng.randn(n, h, w, c).astype(np.float32)
    shape = (n, h, w, 2 * g * 9)
    frac = (rng.rand(*shape) * 2 - 1) * d
    pick = rng.rand(*shape)
    off = np.where(pick < 0.25, np.round((rng.rand(*shape) * 2 - 1) * (d + 1)),
                   frac)
    off = np.where((pick >= 0.25) & (pick < 1 / 3), d, off)
    off = np.where((pick >= 1 / 3) & (pick < 5 / 12), -d, off)
    beyond = d + rng.rand(*shape) * d + 1e-3
    off = np.where((pick >= 5 / 12) & (pick < 2 / 3),
                   np.sign(frac + 1e-9) * beyond, off).astype(np.float32)
    msk = rng.rand(n, h, w, g * 9).astype(np.float32) if with_mask else None
    wgt = (rng.randn(3, 3, c, C_OUT) * 0.2).astype(np.float32)
    gout = rng.randn(n, h, w, C_OUT).astype(np.float32)
    return x, off, msk, wgt, gout


def _t(a):
    """NHWC numpy -> NCHW torch."""
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_args(x, off, msk, wgt, gout):
    return (_t(x), _t(off), _t(msk),
            torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1))),
            _t(gout))


def _scale_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _kinds_present(off, d):
    a = np.abs(off)
    assert (off == np.round(off)).mean() > 0.2
    assert (a == d).mean() > 0.1 and (a > d).mean() > 0.2


# (D, G, Cg, mask, plane): the main path's groups at D = 1 and at
# Sub-JHMDB's D = 6, and groups of 3 channels at PoseTrack's D = 4 (each
# case ~5-9 s of JAX interpret mode on a CPU, so the other group widths
# are held to the scatter only)
JAX_CASES = [(1, 12, 4, True, (8, 12)), (4, 2, 3, False, (8, 12)),
             (6, 12, 4, True, (8, 12))]


@pytest.mark.parametrize("d,g,cg,with_mask,plane", JAX_CASES)
def test_gather_dx_matches_the_pallas_dx(d, g, cg, with_mask, plane):
    x, off, msk, wgt, gout = _inputs(d * 10 + cg, 1, *plane, g, cg, d,
                                     with_mask)
    _kinds_present(off, d)
    ref = deform_conv2d_windowed_bwd_pallas(
        jnp.asarray(x), jnp.asarray(off),
        None if msk is None else jnp.asarray(msk), jnp.asarray(wgt),
        jnp.asarray(gout), padding=3, dilation=3, offset_groups=g,
        max_offset=d, row_block=plane[0], interpret=True,
    )[0]
    got = deform_conv2d_dx_gather_plain(
        *_port_args(x, off, msk, wgt, gout), padding=3, dilation=3,
        offset_groups=g, max_offset=d)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert _scale_err(got, ref) <= 1e-5


# the JAX cases and more: the main path's groups at D = 4, groups of 1 and
# 8 channels, batch 2, ragged planes, fractional windows, D = 8, and the
# windows past 15 px (a row of 2R + 1 candidates no longer fits the card's
# 32-bit mask word) up to the widest the card takes
SCATTER_CASES = [(dd, g, cg, m, p, 1) for dd, g, cg, m, p in JAX_CASES] + [
    (4, 12, 4, True, (8, 12), 1), (4, 2, 1, True, (8, 12), 1),
    (4, 2, 8, True, (8, 12), 1), (4, 12, 4, False, (7, 5), 2),
    (2.5, 3, 4, True, (9, 11), 2), (0.5, 12, 4, True, (6, 6), 1),
    (8, 4, 4, True, (10, 9), 1), (16, 2, 4, True, (20, 18), 1),
    (15.5, 1, 3, False, (18, 17), 1), (31, 1, 4, True, (24, 22), 1)]


@pytest.mark.parametrize("d,g,cg,with_mask,plane,n", SCATTER_CASES)
def test_gather_dx_matches_the_scatter_dx(d, g, cg, with_mask, plane, n):
    x, off, msk, wgt, gout = _inputs(int(d * 7) + cg, n, *plane, g, cg, d,
                                     with_mask)
    args = _port_args(x, off, msk, wgt, gout)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=d)
    got = deform_conv2d_dx_gather_plain(*args, **kw)
    ref = deform_conv2d_backward_plain(*args, **kw)[0]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert _scale_err(got.numpy(), ref.numpy()) <= 1e-6


def test_gather_dx_exact_at_integer_offsets():
    """Offsets on integers inside the window: each source feeds one corner
    with weight 1, so each dx is a sum of m * dcol values; the gather and
    the scatter agree to the last bit in float64."""
    x, off, msk, wgt, gout = _inputs(5, 1, 8, 9, 12, 4, 4)
    off = np.clip(np.round(off), -4, 4)
    args = [a.double() for a in _port_args(x, off, msk, wgt, gout)]
    kw = dict(padding=3, dilation=3, offset_groups=12, max_offset=4)
    got = deform_conv2d_dx_gather_plain(*args, **kw)
    ref = deform_conv2d_backward_plain(*args, **kw)[0]
    assert got.dtype == torch.float64
    assert _scale_err(got.numpy(), ref.numpy()) <= 1e-14


def test_gather_dx_rounds_once_into_the_input_type():
    x, off, msk, wgt, gout = _inputs(6, 1, 8, 8, 12, 4, 4)
    args = _port_args(x, off, msk, wgt, gout)
    kw = dict(padding=3, dilation=3, offset_groups=12, max_offset=4)
    f32 = deform_conv2d_dx_gather_plain(*args, **kw)
    bf = deform_conv2d_dx_gather_plain(
        *[a.to(torch.bfloat16) for a in args], **kw)
    ref = deform_conv2d_dx_gather_plain(
        *[a.to(torch.bfloat16).float() for a in args], **kw)
    assert bf.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(bf, ref.to(torch.bfloat16))


@pytest.mark.parametrize("max_offset", [None, 0, -1])
def test_gather_dx_needs_a_window(max_offset):
    with pytest.raises(ValueError, match="window"):
        deform_conv2d_dx_gather_plain(*_port_args(*_inputs(
            1, 1, 6, 6, 12, 4, 4)), padding=3, dilation=3, offset_groups=12,
            max_offset=max_offset)


@pytest.mark.parametrize("max_offset,taken", [
    (None, True), (4, True), (30.5, True), (MAX_GATHER_OFFSET, True),
    (MAX_GATHER_OFFSET + 1e-3, False), (32, False), (1e9, False)])
def test_the_card_backward_takes_windows_up_to_31_px(max_offset, taken):
    """The card's dx gather marks hits in one 64-bit word per window row,
    so ceil(max_offset) <= 31; a wider window is refused before any launch
    (never sent to the exact mode's atomic scatter). The check runs on CPU
    tensors as the wrapper runs it on the card's."""
    x, off, msk, wgt, gout = _port_args(*_inputs(2, 1, 6, 6, 12, 4, 4))
    args = (x, off, msk, wgt, gout, 3, 3, 12)
    assert MAX_GATHER_OFFSET == 31
    if taken:
        assert _check_backward_args(*args, max_offset=max_offset) == (6, 6)
    else:
        with pytest.raises(ValueError, match="at most 31 px"):
            _check_backward_args(*args, max_offset=max_offset)
