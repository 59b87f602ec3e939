"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels from
``fami_pose_torch/ops/cuda/csrc``); elsewhere they skip. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: f32 1e-4 of the output's scale (the kernel sums the 9*C products
in another order than the plain matmul, the backward's dx is summed with
atomics and its dweight from per-block partials); bf16 one bf16 ulp of the
largest output (both sides round one f32 sum to bf16).

The last group runs every kernel on buffers placed between unmapped pages,
so that a read or write outside an argument faults: a check that needs no
``compute-sanitizer``.
"""

import ctypes
import itertools
import os
import subprocess
import sys

import pytest
import torch

from fami_pose_torch.ops.deform_conv import deform_conv2d, deform_conv2d_windowed
from fami_pose_torch.ops.warp import warp_translate, warp_translate_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, ref, dtype):
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [2, 0])
@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_kernel_matches_plain(gen, dtype, max_offset, with_mask):
    n, c, h, w, g, c_out = 2, 16, 13, 11, 4, 32
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = ((torch.rand(n, 2 * g * 9, h, w, generator=gen, device="cuda") * 2
            - 1) * 5).to(dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    msk = msk if with_mask else None
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
           * 0.1).to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    before = deform_conv2d_windowed.launches
    got = deform_conv2d_windowed(x, off, msk, wgt, **kw)
    torch.cuda.synchronize()
    assert deform_conv2d_windowed.launches == before + 1
    assert got.dtype == dtype
    _assert_close(got, deform_conv2d(x, off, msk, wgt, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_shift", [26, 32])
def test_warp_kernel_matches_plain(gen, dtype, max_shift):
    img = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(6, 2, generator=gen, device="cuda") * 2 - 1) * 40
    before = warp_translate.launches
    got = warp_translate(img, offs, max_shift=max_shift)
    torch.cuda.synchronize()
    assert warp_translate.launches == before + 1
    _assert_close(got, warp_translate_plain(img, offs, max_shift), dtype)


@pytest.mark.parametrize("impl", ["matmul", "slice", "pallas"])
@pytest.mark.parametrize("shape", [(4, 3, 17, 24), (3, 2, 9, 23),
                                   (8, 48, 96, 72)])
def test_warp_kernel_blends_as_the_plain_version(gen, impl, shape):
    """bf16, each JAX warp's roundings, on the vector and the scalar path:
    the matmul and slice blends round every f32 sum of exact bf16 products,
    so the kernel gives the plain version's bits; the Pallas blend's
    products are not exact (one bf16 ulp)."""
    n = shape[0]
    img = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[:3] = torch.tensor([[26.0, -26.0], [-3.0, 2.0], [0.25, -0.75]])[:n]
    before = warp_translate.launches
    got = warp_translate(img, offs, max_shift=26, impl=impl)
    torch.cuda.synchronize()
    assert warp_translate.launches == before + 1
    ref = warp_translate_plain(img, offs, 26, impl)
    if impl == "pallas":
        _assert_close(got, ref, torch.bfloat16)
    else:
        assert torch.equal(got, ref)


# shapes the redesigned kernels take by different internal paths: 16x24 has
# whole 64-pixel tiles and 16-byte output rows (16-byte stores), 13x11 a
# ragged last tile and 286-byte rows (scalar stores)
DCN_SIZES = [(16, 24), (13, 11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("c_out", [16, 32, 48, 64])
@pytest.mark.parametrize("max_offset", [4, 1, 0])
def test_dcn_kernel_shapes(gen, dtype, c, c_out, max_offset):
    """C in {16, 48} (G = C/4), every C_out, D in {4, 1, exact} with some
    offsets exactly at +-D, with and without a mask, at both sizes."""
    g = c // 4
    for (h, w), with_mask in itertools.product(DCN_SIZES, (True, False)):
        x = torch.randn(2, c, h, w, generator=gen, device="cuda").to(dtype)
        off = _offsets(gen, (2, 2 * g * 9, h, w), max_offset, dtype)
        msk = torch.rand(2, g * 9, h, w, generator=gen, device="cuda")
        msk = msk.to(dtype) if with_mask else None
        wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
               * 0.05).to(dtype)
        kw = dict(padding=3, dilation=3, offset_groups=g,
                  max_offset=max_offset)
        got = deform_conv2d_windowed(x, off, msk, wgt, **kw)
        torch.cuda.synchronize()
        _assert_close(got, deform_conv2d(x, off, msk, wgt, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, g", [(48, 48), (12, 4), (24, 3), (64, 16)])
def test_dcn_kernel_other_groupings(gen, dtype, c, g):
    """Cg = 1 and 3: the scalar gather (432 and 108 units); Cg = 8: two
    vector loads a corner; C = 64: the bf16 layout takes it, the f32 one
    (258 KB) is refused."""
    for h, w in DCN_SIZES:
        x = torch.randn(2, c, h, w, generator=gen, device="cuda").to(dtype)
        off = _offsets(gen, (2, 2 * g * 9, h, w), 3, dtype)
        msk = torch.rand(2, g * 9, h, w, generator=gen, device="cuda").to(dtype)
        wgt = (torch.randn(48, c, 3, 3, generator=gen, device="cuda")
               * 0.05).to(dtype)
        kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=3)
        if dtype == torch.float32 and c == 64:
            with pytest.raises(ValueError, match="shared memory"):
                deform_conv2d_windowed(x, off, msk, wgt, **kw)
            continue
        got = deform_conv2d_windowed(x, off, msk, wgt, **kw)
        torch.cuda.synchronize()
        _assert_close(got, deform_conv2d(x, off, msk, wgt, **kw), dtype)


def test_dcn_kernel_padded_reduction(gen):
    """C = 12, G = 3: 9C = 108 is padded to 112 in the wgmma operands."""
    x = torch.randn(2, 12, 13, 11, generator=gen, device="cuda").bfloat16()
    off = _offsets(gen, (2, 2 * 3 * 9, 13, 11), 2, torch.bfloat16)
    msk = torch.rand(2, 27, 13, 11, generator=gen, device="cuda").bfloat16()
    wgt = (torch.randn(16, 12, 3, 3, generator=gen, device="cuda")
           * 0.1).bfloat16()
    kw = dict(padding=3, dilation=3, offset_groups=3, max_offset=2)
    got = deform_conv2d_windowed(x, off, msk, wgt, **kw)
    torch.cuda.synchronize()
    _assert_close(got, deform_conv2d(x, off, msk, wgt, **kw), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 17, 24), (4, 3, 17, 20),
                                   (3, 2, 9, 23), (8, 48, 96, 72)])
def test_warp_kernel_vector_and_scalar_paths(gen, dtype, shape):
    """W a multiple of 8 (the bf16 16-byte rows), of 4 only (f32 rows, the
    bf16 scalar path) and of neither; shifts at, inside and past the clamp,
    integers, and both signs of a fraction."""
    n = shape[0]
    img = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[:4] = torch.tensor([[26.0, -26.0], [-3.0, 2.0], [0.25, -0.75],
                             [-100.0, 7.5]])[:n]
    before = warp_translate.launches
    got = warp_translate(img, offs, max_shift=26)
    torch.cuda.synchronize()
    assert warp_translate.launches == before + 1
    _assert_close(got, warp_translate_plain(img, offs, 26), dtype)


def test_kernels_refuse_what_they_do_not_take(gen):
    """A CUDA tensor goes to the kernel or raises: no plain fallback."""
    x = torch.zeros(1, 16, 8, 8, device="cuda")
    off = torch.zeros(1, 72, 8, 8, device="cuda")
    before = deform_conv2d_windowed.launches
    with pytest.raises(ValueError, match="C_out"):
        deform_conv2d_windowed(x, off, None, torch.zeros(24, 16, 3, 3,
                               device="cuda"), padding=3, dilation=3)
    xb = torch.zeros(1, 256, 8, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        deform_conv2d_windowed(
            xb, torch.zeros(1, 2 * 16 * 9, 8, 8, device="cuda",
                            dtype=torch.bfloat16), None,
            torch.zeros(64, 256, 3, 3, device="cuda", dtype=torch.bfloat16),
            padding=3, dilation=3, offset_groups=16)
    assert deform_conv2d_windowed.launches == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_translate(torch.zeros(1, 2, 8, 8, device="cuda",
                                   dtype=torch.float64),
                       torch.zeros(1, 2, device="cuda"))


def _offsets(gen, shape, d, dtype):
    """A third of the offsets past D, a quarter rounded to integers (the
    backward's zero-derivative points), some exactly at +-D."""
    spread = 1.5 * d if d > 0 else 5.0
    off = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * spread
    pick = torch.rand(shape, generator=gen, device="cuda")
    off = torch.where(pick < 0.25, off.round(), off)
    if d > 0:
        off = torch.where(pick > 0.95, torch.full_like(off, float(d)), off)
    return off.to(dtype)


def _assert_grad_close(name, got, ref, dtype):
    """f32: 1e-4 of the gradient's scale (other sum order, atomics); bf16
    outputs: one bf16 ulp (2^-7) of the scale, both sides rounding an f32
    sum once."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4) * scale
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [2, 1, 0])
@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_backward_kernel_matches_plain(gen, dtype, max_offset, with_mask):
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    n, c, h, w, g, c_out = 2, 16, 13, 11, 4, 32
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), max_offset, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    msk = msk if with_mask else None
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
           * 0.1).to(dtype)
    gout = torch.randn(n, c_out, h, w, generator=gen, device="cuda").to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    before = deform_conv2d_backward.launches
    got = deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    torch.cuda.synchronize()
    assert deform_conv2d_backward.launches == before + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), got, ref):
        if b is None:
            assert a is None, name
        else:
            _assert_grad_close(name, a, b, dtype)


def _check_backward(gen, x, off, msk, wgt, **kw):
    """The backward kernel against its plain version on these inputs, with a
    seeded gout; one launch counted."""
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    dtype = x.dtype
    ho = x.shape[2] + 2 * kw["padding"] - kw["dilation"] * (wgt.shape[2] - 1)
    wo = x.shape[3] + 2 * kw["padding"] - kw["dilation"] * (wgt.shape[3] - 1)
    gout = torch.randn(x.shape[0], wgt.shape[0], ho, wo, generator=gen,
                       device="cuda").to(dtype)
    before = deform_conv2d_backward.launches
    got = deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    torch.cuda.synchronize()
    assert deform_conv2d_backward.launches == before + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), got, ref):
        if b is None:
            assert a is None, name
        else:
            _assert_grad_close(name, a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("c_out", [16, 32, 48, 64])
@pytest.mark.parametrize("max_offset", [4, 1, 0])
def test_dcn_backward_kernel_shapes(gen, dtype, c, c_out, max_offset):
    """The forward's shape cases for the backward: C in {16, 48} (G = C/4,
    the float4 atomics), every C_out, D in {4, 1, exact} with integer
    offsets, offsets exactly at +-D and past D, with and without a mask,
    whole and ragged tiles."""
    g = c // 4
    for (h, w), with_mask in itertools.product(DCN_SIZES, (True, False)):
        x = torch.randn(2, c, h, w, generator=gen, device="cuda").to(dtype)
        off = _offsets(gen, (2, 2 * g * 9, h, w), max_offset, dtype)
        msk = torch.rand(2, g * 9, h, w, generator=gen, device="cuda")
        msk = msk.to(dtype) if with_mask else None
        wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
               * 0.05).to(dtype)
        _check_backward(gen, x, off, msk, wgt, padding=3, dilation=3,
                        offset_groups=g, max_offset=max_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, g", [(48, 48), (12, 4), (24, 3), (64, 16)])
def test_dcn_backward_kernel_other_groupings(gen, dtype, c, g):
    """Cg = 1 and 3: scalar gathers and scalar atomics; Cg = 8: two float4
    atomics a corner; C = 64: the widest slice (both types)."""
    for h, w in DCN_SIZES:
        x = torch.randn(2, c, h, w, generator=gen, device="cuda").to(dtype)
        off = _offsets(gen, (2, 2 * g * 9, h, w), 3, dtype)
        msk = torch.rand(2, g * 9, h, w, generator=gen, device="cuda").to(dtype)
        wgt = (torch.randn(48, c, 3, 3, generator=gen, device="cuda")
               * 0.05).to(dtype)
        _check_backward(gen, x, off, msk, wgt, padding=3, dilation=3,
                        offset_groups=g, max_offset=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [4, 0])
def test_dcn_backward_kernel_smooth_offsets(gen, dtype, max_offset):
    """A smooth field of small offsets (|t| < 1.5 px), as a trained model
    gives: neighbouring pixels scatter into the same corners, so the dx
    atomics collide; at the main path's channels and plane size."""
    n, c, h, w, g = 2, 48, 96, 72, 12
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    yy = torch.arange(h, device="cuda").view(1, 1, h, 1).float()
    xx = torch.arange(w, device="cuda").view(1, 1, 1, w).float()
    phase = torch.rand(n, 2 * g * 9, 1, 1, generator=gen, device="cuda") * 6.3
    freq = torch.rand(n, 2 * g * 9, 1, 1, generator=gen, device="cuda") * 0.3
    off = (1.5 * torch.sin(freq * (yy + 0.7 * xx) + phase)).to(dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(48, c, 3, 3, generator=gen, device="cuda")
           * 0.05).to(dtype)
    _check_backward(gen, x, off, msk, wgt, padding=3, dilation=3,
                    offset_groups=g, max_offset=max_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_backward_kernel_taps_not_a_multiple_of_three(gen, dtype):
    """A 2x2 kernel: 4 taps, so the second tap group holds one tap and the
    slice's other columns stay zero."""
    x = torch.randn(2, 16, 13, 11, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (2, 2 * 4 * 4, 14, 12), 2, dtype)
    msk = torch.rand(2, 4 * 4, 14, 12, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(32, 16, 2, 2, generator=gen, device="cuda")
           * 0.1).to(dtype)
    _check_backward(gen, x, off, msk, wgt, padding=1, dilation=1,
                    offset_groups=4, max_offset=2)


def test_dcn_backward_refuses_what_it_does_not_take(gen):
    from fami_pose_torch.ops.deform_conv import deform_conv2d_backward

    before = deform_conv2d_backward.launches
    x = torch.zeros(1, 80, 8, 8, device="cuda", dtype=torch.bfloat16)
    off = torch.zeros(1, 2 * 16 * 9, 8, 8, device="cuda", dtype=torch.bfloat16)
    wgt = torch.zeros(16, 80, 3, 3, device="cuda", dtype=torch.bfloat16)
    gout = torch.zeros(1, 16, 8, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C <= 64"):
        deform_conv2d_backward(x, off, None, wgt, gout, padding=3, dilation=3,
                               offset_groups=16)
    with pytest.raises(ValueError, match="gout"):
        deform_conv2d_backward(x[:, :64], off, None, wgt[:, :64], gout[..., :4],
                               padding=3, dilation=3, offset_groups=16)
    assert deform_conv2d_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_autograd_on_the_card(gen, dtype):
    """The autograd Function launches both kernels for CUDA tensors and
    returns the bias gradient as a plain sum."""
    from fami_pose_torch.ops.deform_conv import (
        deform_conv2d_backward, deform_conv2d_backward_plain,
    )

    n, c, h, w, g = 1, 16, 9, 8, 4
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), 2, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(16, c, 3, 3, generator=gen, device="cuda") * 0.1).to(dtype)
    bias = torch.zeros(16, device="cuda", dtype=dtype)
    leaves = [t.requires_grad_() for t in (x, off, msk, wgt, bias)]
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=2)
    fwd, bwd = deform_conv2d_windowed.launches, deform_conv2d_backward.launches
    out = deform_conv2d_windowed(*leaves, **kw)
    gout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    grads = torch.autograd.grad(out, leaves, gout)
    torch.cuda.synchronize()
    assert deform_conv2d_windowed.launches == fwd + 1
    assert deform_conv2d_backward.launches == bwd + 1
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), grads, ref):
        _assert_grad_close(name, a, b, dtype)
    _assert_grad_close("dbias", grads[4], gout.float().sum((0, 2, 3)).to(dtype),
                       dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_shift", [26, 32])
def test_warp_backward_kernel_matches_plain(gen, dtype, max_shift):
    from fami_pose_torch.ops.warp import (
        warp_translate_backward, warp_translate_backward_plain,
    )

    img = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(6, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[0] = torch.tensor([3.0, -2.0])  # integers: right-hand derivative
    gout = torch.randn(6, 5, 17, 23, generator=gen, device="cuda").to(dtype)
    before = warp_translate_backward.launches
    got = warp_translate_backward(img, offs, gout, max_shift)
    torch.cuda.synchronize()
    assert warp_translate_backward.launches == before + 1
    ref = warp_translate_backward_plain(img, offs, gout, max_shift)
    _assert_grad_close("d_images", got[0], ref[0], dtype)
    # d_offsets is an f32 sum of 5*17*23 products of bf16-rounded factors
    assert got[1].dtype == offs.dtype
    scale = max(1.0, float(ref[1].abs().max()))
    assert float((got[1] - ref[1]).abs().max()) <= 1e-4 * scale


def test_warp_autograd_on_the_card(gen):
    from fami_pose_torch.ops.warp import warp_translate_backward

    img = torch.randn(3, 4, 12, 10, generator=gen, device="cuda",
                      requires_grad=True)
    offs = ((torch.rand(3, 2, generator=gen, device="cuda") * 2 - 1)
            * 5).requires_grad_()
    fwd, bwd = warp_translate.launches, warp_translate_backward.launches
    out = warp_translate(img, offs, max_shift=26)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert warp_translate.launches == fwd + 1
    assert warp_translate_backward.launches == bwd + 1
    ref_img = img.detach().cpu().requires_grad_()
    ref_offs = offs.detach().cpu().requires_grad_()
    warp_translate(ref_img, ref_offs, max_shift=26).square().sum().backward()
    assert float((img.grad.cpu() - ref_img.grad).abs().max()) <= 1e-4
    assert float((offs.grad.cpu() - ref_offs.grad).abs().max()) <= 1e-3


# the row-strip backward: image 0's translation (tx, ty) in each case, the
# other images' random within +-40 (past the clamp of 26 on either axis)
WARP_BWD_CASES = {"integer": (3.0, -2.0), "x_past_clamp": (-40.0, 2.5),
                  "y_past_clamp": (1.25, 33.0)}


def _warp_bwd_inputs(gen, dtype, shape, first):
    img = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(shape[0], 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[0] = torch.tensor(first)
    gout = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return img, offs, gout


def _check_warp_bwd(img, offs, gout):
    """The kernel against the plain version; a second call bitwise equal to
    the first in both outputs (d_offsets is summed in a fixed order)."""
    from fami_pose_torch.ops.warp import (
        warp_translate_backward, warp_translate_backward_plain,
    )

    before = warp_translate_backward.launches
    got = warp_translate_backward(img, offs, gout, 26)
    again = warp_translate_backward(img, offs, gout, 26)
    torch.cuda.synchronize()
    assert warp_translate_backward.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ref = warp_translate_backward_plain(img, offs, gout, 26)
    _assert_grad_close("d_images", got[0], ref[0], img.dtype)
    # d_offsets: f32 sums of C*H*W terms in another order
    assert got[1].dtype == torch.float32
    scale = max(1.0, float(ref[1].abs().max()))
    assert float((got[1] - ref[1]).abs().max()) <= 1e-4 * scale
    return got, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("case", list(WARP_BWD_CASES))
def test_warp_backward_row_strips(gen, dtype, n, case):
    """The train path's plane (48, 96, 72): 16-byte row strips. An axis
    whose raw translation lies past the clamp gets d_offsets 0, the other
    axis not."""
    first = WARP_BWD_CASES[case]
    got, ref = _check_warp_bwd(*_warp_bwd_inputs(gen, dtype, (n, 48, 96, 72),
                                                 first))
    for axis in (0, 1):
        past = abs(first[axis]) > 26
        assert (float(got[1][0, axis]) == 0.0) == past
        assert (float(ref[1][0, axis]) == 0.0) == past


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["width_23", "width_20", "unaligned"])
def test_warp_backward_scalar_path(gen, dtype, layout):
    """W = 23 (no 16-byte rows), W = 20 (f32 rows, the bf16 scalar path)
    and a contiguous view one element past an aligned address (the scalar
    path at W = 72)."""
    shape = {"width_23": (8, 5, 17, 23), "width_20": (8, 5, 17, 20),
             "unaligned": (8, 6, 24, 72)}[layout]
    img, offs, gout = _warp_bwd_inputs(gen, dtype, shape, (3.0, -2.0))
    if layout == "unaligned":
        def shifted(t):
            flat = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
            view = flat[1:].view(shape)
            view.copy_(t)
            assert view.is_contiguous() and view.data_ptr() % 16 != 0
            return view

        img, gout = shifted(img), shifted(gout)
    _check_warp_bwd(img, offs, gout)


# -- the on-chip gather and rotate probes (bitwise: copies of input values) --

def _probe_on_card(name, **kw):
    from fami_pose_torch.ops import probes

    return probes, probes.probe_inputs(name, device="cuda", **kw)


@pytest.mark.parametrize("variant", ["smem", "shfl"])
def test_probe_gather_lane_matches_plain(gen, variant):
    probes, (x, idx) = _probe_on_card("gather_lane", seed=1)
    before = probes.gather_lane.launches
    got = probes.gather_lane(x, idx, variant=variant)
    torch.cuda.synchronize()
    assert probes.gather_lane.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, probes.gather_lane_plain(x, idx))


def test_probe_gather_lane_f32_and_other_shapes(gen):
    from fami_pose_torch.ops import probes

    x = torch.rand(5, 96, generator=gen, device="cuda")
    idx = torch.randint(0, 96, (5, 96), generator=gen, device="cuda",
                        dtype=torch.int32)
    assert torch.equal(probes.gather_lane(x, idx),
                       probes.gather_lane_plain(x, idx))
    with pytest.raises(ValueError, match="shuffle"):
        probes.gather_lane(x, idx, variant="shfl")


# (shape, dtype) of the lane gather's row groups (2 rows of 128 columns a
# block, chunks of 4 elements): rows not a multiple of the group, a last
# group of one row, rows whose bytes are not a multiple of 16 (200-byte
# bf16 rows in 8-byte chunks), column counts not a multiple of 4 (the
# scalar path), rows wider than a block's chunks (the loop past the
# registers)
LANE_CASES = [((5, 96), torch.float32), ((5, 96), torch.bfloat16),
              ((37, 128), torch.float32), ((37, 128), torch.bfloat16),
              ((300, 64), torch.bfloat16), ((150, 64), torch.float32),
              ((7, 100), torch.bfloat16), ((6, 102), torch.bfloat16),
              ((9, 37), torch.float32), ((9, 37), torch.bfloat16),
              ((1, 8192), torch.bfloat16), ((2, 6000), torch.float32),
              ((3, 8), torch.bfloat16)]


def _lane_inputs(gen, shape, dtype, low=0, high=None):
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    high = shape[-1] if high is None else high
    idx = torch.randint(low, high, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    return x, idx


@pytest.mark.parametrize("shape,dtype", LANE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{str(d)[6:]}"
                              for s, d in LANE_CASES])
def test_probe_gather_lane_row_groups(gen, shape, dtype):
    from fami_pose_torch.ops import probes

    x, idx = _lane_inputs(gen, shape, dtype)
    got = probes.gather_lane(x, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, probes.gather_lane_plain(x, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_gather_lane_unaligned_and_clamped(gen, dtype):
    """A view one element into its buffer takes the scalar path; indices
    past either end of the row are clamped into it (no read outside the
    staged rows), on the vector and the scalar path."""
    from fami_pose_torch.ops import probes

    flat = torch.rand(16 * 128 + 1, generator=gen, device="cuda").to(dtype)
    x = flat[1:].view(16, 128)
    _, idx = _lane_inputs(gen, (16, 128), dtype)
    assert torch.equal(probes.gather_lane(x, idx),
                       probes.gather_lane_plain(x, idx))
    for tile in (x, x.clone(), x[:, :37].clone()):
        cols = tile.shape[1]
        _, wild = _lane_inputs(gen, tuple(tile.shape), dtype, low=-40,
                               high=cols + 40)
        got = probes.gather_lane(tile, wild)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.gather(
            tile, 1, wild.long().clamp(0, cols - 1)))


@pytest.mark.parametrize("shape", [(1, 16, 128), (7, 16, 128), (7, 5, 96),
                                   (3, 9, 37), (2, 40, 300)])
def test_probe_gather_3d_row_groups(gen, shape):
    """Batch 1 and 7, rows not a multiple of the group (5, 9), a scalar
    row (37 f32: 148 bytes), groups of one row (300 columns); out-of-range
    indices clamped."""
    from fami_pose_torch.ops import probes

    x, idx = _lane_inputs(gen, shape, torch.float32)
    before = probes.gather_3d.launches
    got = probes.gather_3d(x, idx)
    torch.cuda.synchronize()
    assert probes.gather_3d.launches == before + 1
    assert torch.equal(got, probes.gather_3d_plain(x, idx))
    _, wild = _lane_inputs(gen, shape, torch.float32, low=-9,
                           high=shape[-1] + 9)
    assert torch.equal(probes.gather_3d(x, wild), torch.gather(
        x, 2, wild.long().clamp(0, shape[-1] - 1)))


def test_probe_gather_3d_matches_plain(gen):
    probes, (x, idx) = _probe_on_card("gather_3d", seed=2)
    before = probes.gather_3d.launches
    got = probes.gather_3d(x, idx)
    torch.cuda.synchronize()
    assert probes.gather_3d.launches == before + 1
    assert torch.equal(got, probes.gather_3d_plain(x, idx))


def test_probe_gather_rows_matches_plain(gen):
    probes, (x, idx) = _probe_on_card("gather_rows", seed=3)
    before = probes.gather_rows.launches
    got = probes.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert probes.gather_rows.launches == before + 1
    assert torch.equal(got, probes.gather_rows_plain(x, idx))


@pytest.mark.parametrize("shape", [(40, 100), (300, 37), (5, 7)])
def test_probe_gather_rows_other_shapes(gen, shape):
    """Column counts that are not a multiple of 32 (a last strip of 4, 5
    and 7 columns), more rows than a block's warps take ahead (300) and
    fewer columns than a strip."""
    from fami_pose_torch.ops import probes

    x = torch.rand(shape, generator=gen, device="cuda")
    idx = torch.randint(0, shape[0], shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    got = probes.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.gather(x, 0, idx.long()))


@pytest.mark.parametrize("shift", [0, 5, 127, 128, -3, -1000, 2 ** 31 - 1])
def test_probe_dynamic_roll_matches_plain(gen, shift):
    probes, (x, s) = _probe_on_card("dynamic_roll", seed=4, shift=shift)
    before = probes.dynamic_roll.launches
    got = probes.dynamic_roll(x, s)
    # the shift lives in device memory: changing it there changes the result
    # of the same call, with no new host argument
    s.fill_(shift + 1 if shift < 2 ** 31 - 1 else 0)
    again = probes.dynamic_roll(x, s)
    torch.cuda.synchronize()
    assert probes.dynamic_roll.launches == before + 2
    assert torch.equal(got, torch.roll(x, shift % 128, dims=1))
    assert torch.equal(again, probes.dynamic_roll_plain(x, s))


@pytest.mark.parametrize("shape", [(5, 96), (3, 128), (40, 128)])
@pytest.mark.parametrize("shift", [0, 7, -130])
def test_probe_dynamic_roll_other_shapes(gen, shape, shift):
    """Rows of 128 columns take the register kernel (one warp a row, one
    block or several); other widths the shared-memory kernel."""
    from fami_pose_torch.ops import probes

    x = torch.rand(shape, generator=gen, device="cuda")
    s = torch.tensor([shift], dtype=torch.int32, device="cuda")
    got = probes.dynamic_roll(x, s)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.roll(x, shift % shape[1], dims=1))


def test_probes_refuse_what_the_kernels_do_not_take(gen):
    from fami_pose_torch.ops import probes

    x = torch.rand(64, 128, device="cuda")
    idx = torch.zeros(64, 128, device="cuda", dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        probes.gather_rows(x, idx)
    with pytest.raises(ValueError, match="shared memory"):
        probes.gather_rows(torch.rand(128, 128, device="cuda"),
                           torch.zeros(128, 128, device="cuda",
                                       dtype=torch.int32))
    with pytest.raises(TypeError, match="kernel takes"):
        probes.gather_3d(torch.rand(2, 4, 128, device="cuda").bfloat16(),
                         torch.zeros(2, 4, 128, device="cuda",
                                     dtype=torch.int32))
    with pytest.raises(ValueError, match="one device"):
        probes.dynamic_roll(x[:16], torch.tensor([5], dtype=torch.int32))


def test_hopper_watch_reports_supported(gen, capsys):
    from fami_pose_torch.tools import hopper_watch

    assert hopper_watch.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("SUPPORTED") == 5 and "unsupported" not in out


# -- guard pages: no kernel reads or writes outside its arguments ------------
#
# Every argument of a launch lives in a mapping of its own made with the
# cuMem* virtual-memory calls of libcuda, inside a reserved address range
# whose pages before and after the mapping stay unmapped. With the buffer
# flush against the mapping's end an overrun faults, flush against its start
# an underrun does; inside the caching allocator's large blocks either would
# pass unnoticed. A fault ends the process's CUDA context, so a failure here
# fails every later test of the run too.

class _Loc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _AllocProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Loc), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _Loc), ("flags", ctypes.c_int)]


class GuardedBuffers:
    """Device buffers between unmapped pages; ``where`` is ``"end"`` or
    ``"start"``. ``put`` copies a tensor in and returns the address, ``get``
    copies a buffer back into a tensor like the given one."""

    def __init__(self, where):
        torch.zeros(1, device="cuda")  # the context the cuMem* calls use
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.where = where
        # pinned device memory on device 0
        self.prop = _AllocProp(type=1, location=_Loc(1, 0))
        gran = ctypes.c_size_t()
        self._ck(self.cu.cuMemGetAllocationGranularity(
            ctypes.byref(gran), ctypes.byref(self.prop), 0))
        self.gran = gran.value
        self.held = []

    @staticmethod
    def _ck(rc):
        if rc != 0:
            raise RuntimeError(f"libcuda call failed: CUresult {rc}")

    def sync(self):
        self._ck(self.cu.cuCtxSynchronize())

    def put(self, t):
        cu, u64, sz = self.cu, ctypes.c_uint64, ctypes.c_size_t
        nb = t.numel() * t.element_size()
        mapped = -(-nb // self.gran) * self.gran
        va, handle = u64(), u64()
        self._ck(cu.cuMemAddressReserve(
            ctypes.byref(va), sz(mapped + 2 * self.gran), sz(0), u64(0),
            u64(0)))
        self._ck(cu.cuMemCreate(ctypes.byref(handle), sz(mapped),
                                ctypes.byref(self.prop), u64(0)))
        base = va.value + self.gran
        self._ck(cu.cuMemMap(u64(base), sz(mapped), sz(0), handle, u64(0)))
        access = _AccessDesc(_Loc(1, 0), 3)  # read and write
        self._ck(cu.cuMemSetAccess(u64(base), sz(mapped),
                                   ctypes.byref(access), sz(1)))
        self.held.append((va.value, base, mapped, handle))
        addr = base + (mapped - nb if self.where == "end" else 0)
        torch.cuda.synchronize()
        self._ck(cu.cuMemcpyDtoD_v2(u64(addr), u64(t.data_ptr()), sz(nb)))
        self.sync()
        return addr

    def get(self, addr, like):
        out = torch.empty_like(like)
        self._ck(self.cu.cuMemcpyDtoD_v2(
            ctypes.c_uint64(out.data_ptr()), ctypes.c_uint64(addr),
            ctypes.c_size_t(out.numel() * out.element_size())))
        self.sync()
        return out

    def close(self):
        cu, u64, sz = self.cu, ctypes.c_uint64, ctypes.c_size_t
        for va, base, mapped, handle in self.held:
            cu.cuMemUnmap(u64(base), sz(mapped))
            cu.cuMemRelease(handle)
            cu.cuMemAddressFree(u64(va), sz(mapped + 2 * self.gran))
        self.held = []


@pytest.fixture(params=["end", "start"])
def guarded(request, gen):
    bufs = GuardedBuffers(request.param)
    yield bufs
    bufs.close()


def _kernel_library():
    from fami_pose_torch.ops.cuda.build import load_library

    return load_library()


def _overrun_child():
    """Launches the warp on 3 planes of a 1-plane guarded buffer: must fault
    (run in a process of its own by the test below)."""
    bufs = GuardedBuffers("end")
    img = torch.zeros(1, 1, 96, 72, device="cuda")
    a, o = bufs.put(img), bufs.put(torch.zeros(1, 2, device="cuda"))
    _kernel_library().fami_warp_translate(a, o, bufs.put(img), 0, 1, 1, 400,
                                          96, 72, 26.0, None)
    bufs.sync()


def test_guard_pages_fault_on_an_overrun(gen):
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [here, os.path.dirname(here)]
    code = (f"import sys; sys.path[:0] = {paths!r}; "
            "import test_torch_cuda_kernels as t; t._overrun_child()")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "CUresult 700" in run.stderr, run.stderr


@pytest.mark.parametrize("case", ["37x128-bf16", "9x37-f32", "3d-7x5x96",
                                  "3d-3x9x37"])
def test_lane_gathers_stay_inside_their_buffers(guarded, gen, case):
    """The row groups of the lane and 3-D gathers, a last group of fewer
    rows, the vector path (16-byte aligned buffers) and the scalar one (a
    148-byte row, placed flush against a guard page and unaligned there),
    with indices past both ends of the row."""
    shape, dtype = {"37x128-bf16": ((37, 128), torch.bfloat16),
                    "9x37-f32": ((9, 37), torch.float32),
                    "3d-7x5x96": ((7, 5, 96), torch.float32),
                    "3d-3x9x37": ((3, 9, 37), torch.float32)}[case]
    x, idx = _lane_inputs(gen, shape, dtype, low=-5, high=shape[-1] + 5)
    ref = torch.gather(x, x.dim() - 1, idx.long().clamp(0, shape[-1] - 1))
    lib = _kernel_library()
    px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
    if len(shape) == 2:
        code = 0 if dtype == torch.float32 else 1
        err = lib.fami_probe_gather_lane(px, pi, po, code, *shape, 0, None)
    else:
        err = lib.fami_probe_gather_3d(px, pi, po, *shape, None)
    assert err == 0
    guarded.sync()
    assert torch.equal(guarded.get(po, x), ref)


# (N, C, H, W, G): the main path's plane (8-byte gathers, 16-byte stores,
# forward and backward), a ragged one (scalar stores), 48 groups (scalar
# gathers, 432 units), Cg = 3 (scalar gathers, the reduction padded), Cg = 8
# (two vectors a corner)
DCN_GUARDED = {"main": (2, 48, 96, 72, 12), "ragged": (2, 16, 13, 11, 4),
               "groups48": (1, 48, 20, 18, 48), "cg3": (2, 12, 13, 11, 4),
               "cg8": (2, 24, 13, 11, 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_offset", [4, 0])
@pytest.mark.parametrize("case", list(DCN_GUARDED))
def test_dcn_kernels_stay_inside_their_buffers(guarded, gen, dtype,
                                               max_offset, case):
    """The forward (its channels-last copy of x included) and the backward
    (its copy and zeroed accumulator, its main kernel on the vector and the
    scalar atomics, the ragged last tile, the finishing transpose and dW
    sum) on every internal path; results equal to the wrappers'."""
    from fami_pose_torch.ops.deform_conv import (
        BWD_BLOCKS_PER_SM, deform_conv2d_backward,
    )

    n, c, h, w, g = DCN_GUARDED[case]
    c_out = c if c in (16, 32, 48, 64) else 16
    code = 0 if dtype == torch.float32 else 1
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    off = _offsets(gen, (n, 2 * g * 9, h, w), max_offset, dtype)
    msk = torch.rand(n, g * 9, h, w, generator=gen, device="cuda").to(dtype)
    wgt = (torch.randn(c_out, c, 3, 3, generator=gen, device="cuda")
           * 0.05).to(dtype)
    kw = dict(padding=3, dilation=3, offset_groups=g, max_offset=max_offset)
    ref = deform_conv2d_windowed(x, off, msk, wgt, **kw)
    lib = _kernel_library()
    px, pxg, po, pm, pw, pout = (guarded.put(t)
                                 for t in (x, x, off, msk, wgt, ref))
    dims = (code, n, c, h, w, c_out, h, w, 3, 3, 3, 3, g, float(max_offset),
            None)
    assert lib.fami_dcn_fwd(px, pxg, po, pm, pw, pout, *dims) == 0
    guarded.sync()
    assert torch.equal(guarded.get(pout, ref), ref)
    gout = torch.randn(ref.shape, generator=gen, device="cuda").to(dtype)
    ref_b = deform_conv2d_backward(x, off, msk, wgt, gout, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = -(-BWD_BLOCKS_PER_SM * sms // 3)
    acc = torch.zeros(x.shape, device="cuda")
    part = torch.zeros(slots * 3 * c_out * 3 * c, device="cuda")
    pg, pxg2, pdx, pdo, pdm, pdw, pacc, ppart = (
        guarded.put(t) for t in (gout, x, x, off, msk, wgt, acc, part))
    assert lib.fami_dcn_bwd(px, pxg2, po, pm, pw, pg, pdx, pdo, pdm, pdw,
                            pacc, ppart, slots, *dims) == 0
    guarded.sync()
    _assert_grad_close("dx", guarded.get(pdx, x), ref_b[0], dtype)
    assert torch.equal(guarded.get(pdo, off), ref_b[1])
    assert torch.equal(guarded.get(pdm, msk), ref_b[2])
    _assert_grad_close("dweight", guarded.get(pdw, wgt), ref_b[3], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 48, 96, 72), (3, 5, 17, 23)])
def test_warp_kernels_stay_inside_their_buffers(guarded, gen, dtype, shape):
    """Shifts at, inside and far past the clamp of 26 in both directions;
    the 16-byte row paths (W = 72) and the scalar paths (W = 23) of the
    forward (each blend) and the backward, the backward's partials buffer
    included."""
    from fami_pose_torch.ops.warp import BLEND_CODES, warp_translate_backward

    n, c, h, w = shape
    code = 0 if dtype == torch.float32 else 1
    img = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    offs = (torch.rand(n, 2, generator=gen, device="cuda") * 2 - 1) * 40
    offs[:3] = torch.tensor([[26.0, -26.0], [-100.0, 100.0], [3.0, -7.0]])
    gout = torch.randn(n, c, h, w, generator=gen, device="cuda").to(dtype)
    d_img, d_offs = warp_translate_backward(img, offs, gout, max_shift=26)
    lib = _kernel_library()
    pi, pf = guarded.put(img), guarded.put(offs)
    for impl, blend in BLEND_CODES.items():
        ref = warp_translate(img, offs, max_shift=26, impl=impl)
        pout = guarded.put(ref)
        assert lib.fami_warp_translate(pi, pf, pout, code, blend, n, c, h, w,
                                       26.0, None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(pout, ref), ref)
    zeros = torch.zeros(n, 2, device="cuda")
    blocks = lib.fami_warp_translate_bwd_blocks(code, c, h, w)
    partials = torch.zeros(2 * n * blocks, device="cuda")
    pg, pdi, pdo, ppart = (guarded.put(t)
                           for t in (gout, img, zeros, partials))
    assert lib.fami_warp_translate_bwd(pi, pf, pg, pdi, pdo, ppart, code, n,
                                       c, h, w, 26.0, None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(pdi, img), d_img)
    # the partials are summed in a fixed order: the wrapper's bits
    assert torch.equal(guarded.get(pdo, zeros), d_offs)


def test_probe_kernels_stay_inside_their_buffers(guarded, gen):
    probes, (x, idx) = _probe_on_card("gather_lane", seed=1)
    lib = _kernel_library()
    for variant in (0, 1):
        px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
        assert lib.fami_probe_gather_lane(px, pi, po, 1, *x.shape, variant,
                                          None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(po, x),
                           probes.gather_lane_plain(x, idx))
    _, (x, idx) = _probe_on_card("gather_3d", seed=2)
    px, pi, po = guarded.put(x), guarded.put(idx), guarded.put(x)
    assert lib.fami_probe_gather_3d(px, pi, po, *x.shape, None) == 0
    guarded.sync()
    assert torch.equal(guarded.get(po, x), probes.gather_3d_plain(x, idx))
    _, (x, idx) = _probe_on_card("gather_rows", seed=3)
    # the probe's tile and one whose last strip has 4 of 32 columns
    for tile, rows in ((x, idx), (x[:40, :100].contiguous(),
                                  (idx[:40, :100] % 40).contiguous())):
        px, pi, po = guarded.put(tile), guarded.put(rows), guarded.put(tile)
        assert lib.fami_probe_gather_rows(px, pi, po, *tile.shape, None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(po, tile),
                           probes.gather_rows_plain(tile, rows))
    for shift in (0, 5, 127, 128, -3, -1000003):
        _, (x, s) = _probe_on_card("dynamic_roll", seed=4, shift=shift)
        # the probe's tile (register kernel) and a 96-column one (shared
        # memory kernel)
        for tile in (x, x[:5, :96].contiguous()):
            px, ps, po = guarded.put(tile), guarded.put(s), guarded.put(tile)
            assert lib.fami_probe_dynamic_roll(px, ps, po, *tile.shape,
                                               None) == 0
            guarded.sync()
            assert torch.equal(guarded.get(po, tile),
                               probes.dynamic_roll_plain(tile, s))


# -- the int8 conv: the quantize pass and the s8 implicit GEMM --------------
#
# (B, C, H, W, C_out, kernel, stride, padding, dilation): the stem's 3
# channels (Cp 16, K = 144 padded to 160), a branch 3x3, a strided 3x3 (a
# fuse chain's), a 1x1 at 256 channels (layer1's), layer1's 1x1 to 256 (one
# N tile of 256), the 12x9 branch's 384 (K = 3456: twelve N tiles of 32, so
# that each tile's weights fit in shared memory), a dilated 3x3, and a
# ragged 1x1 (rows not a multiple of the kernel's 64, C = 40 -> Cp 48,
# C_out = 24 -> Np 32, one N tile of 32), and N = 300 (Np 304: two N tiles
# of 192, the second's rows past Np zero-filled)
INT8_CASES = {"stem": (2, 3, 37, 29, 64, 3, 2, 1, 1),
              "3x3": (2, 48, 24, 18, 48, 3, 1, 1, 1),
              "3x3s2": (2, 48, 24, 18, 96, 3, 2, 1, 1),
              "1x1": (2, 256, 24, 18, 64, 1, 1, 0, 1),
              "1x1to256": (2, 64, 24, 18, 256, 1, 1, 0, 1),
              "n384": (2, 384, 12, 9, 384, 3, 1, 1, 1),
              "dilated": (2, 16, 20, 17, 32, 3, 1, 3, 3),
              "ragged": (3, 40, 7, 5, 24, 1, 1, 0, 1),
              "n300": (2, 16, 9, 7, 300, 1, 1, 0, 1)}


def _int8_inputs(gen, case, dtype):
    from fami_pose_torch.ops.int8_conv import pack_weight, quantize_weight

    b, c, h, w, n, k, s, p, d = INT8_CASES[case]
    x = (torch.randn(b, c, h, w, generator=gen, device="cuda") * 1.5).to(dtype)
    # 0.8 of the absmax: the largest inputs clip
    act = (x.float().abs().amax() * 0.8 / 127).reshape(())
    wq, ws = quantize_weight(torch.randn(n, c, k, k, generator=gen,
                                         device="cuda"))
    bias = torch.randn(n, generator=gen, device="cuda")
    return (x, act, wq, ws, pack_weight(wq, c, k), bias,
            dict(kernel_size=k, stride=s, padding=p, dilation=d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_kernels_match_plain(gen, dtype, case):
    """The quantize pass and the implicit GEMM (with and without a bias)
    against their plain versions, and the whole card conv against the
    float64 plain conv: bit for bit."""
    from fami_pose_torch.ops.int8_conv import (
        implicit_gemm, implicit_gemm_plain, int8_conv2d, int8_conv2d_plain,
        quant_nhwc, quant_nhwc_plain,
    )

    x, act, wq, ws, wp, bias, geo = _int8_inputs(gen, case, dtype)
    before = (quant_nhwc.launches, implicit_gemm.launches)
    xq = quant_nhwc(x, act)
    torch.cuda.synchronize()
    assert torch.equal(xq, quant_nhwc_plain(x, act))
    for bb in (None, bias):
        got = implicit_gemm(xq, wp, ws, act, bb, out_dtype=dtype, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, implicit_gemm_plain(xq, wp, ws, act, bb,
                                                    out_dtype=dtype, **geo))
    y = int8_conv2d(x, wq, ws, act, bias, w_packed=wp, **geo)
    torch.cuda.synchronize()
    assert torch.equal(y, int8_conv2d_plain(x, wq, ws, act, bias, **geo))
    assert (quant_nhwc.launches, implicit_gemm.launches) == (before[0] + 2,
                                                             before[1] + 3)


def test_int8_kernels_round_half_to_even(gen):
    """Inputs on the half-way points of the quantizer's grid (and past its
    ends): the kernel rounds as torch.round does, to even."""
    from fami_pose_torch.ops.int8_conv import quant_nhwc, quant_nhwc_plain

    act = torch.tensor(0.5, device="cuda")
    vals = torch.tensor([0.25, 0.75, 1.25, -0.25, -0.75, -1.25, 63.25, 63.75,
                         70.0, -70.0], device="cuda")
    x = vals.repeat(2 * 8 * 4 * 4 // 10 + 1)[:2 * 8 * 4 * 4].reshape(2, 8, 4, 4)
    for dtype in (torch.float32, torch.bfloat16):
        xq = quant_nhwc(x.to(dtype), act)
        assert torch.equal(xq, quant_nhwc_plain(x.to(dtype), act))
        assert set(xq.unique().tolist()) <= {0, 2, -2, 126, 127, -127}


def test_int8_conv_refuses_what_it_does_not_take(gen):
    from fami_pose_torch.ops.int8_conv import (
        implicit_gemm, int8_conv2d, quant_nhwc,
    )

    x, act, wq, ws, wp, _, geo = _int8_inputs(gen, "3x3", torch.float32)
    with pytest.raises(ValueError, match="act_scale"):
        quant_nhwc(x, act.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_nhwc(x.half(), act)
    xq = quant_nhwc(x, act)
    with pytest.raises(ValueError, match="wp: contiguous int8"):
        implicit_gemm(xq, wp[:, :64].contiguous(), ws, act, None, **geo)
    with pytest.raises(ValueError, match="w_scale"):
        implicit_gemm(xq, wp, ws.double(), act, None, **geo)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        implicit_gemm(xq, wp, ws, act, None, out_dtype=torch.half, **geo)
    with pytest.raises(ValueError, match="hrnet.conv9: wq must be int8"):
        int8_conv2d(x, wq[:, :8], ws, act, None, name="hrnet.conv9", **geo)
    with pytest.raises(ValueError, match="hrnet.conv9: w_packed"):
        int8_conv2d(x, wq, ws, act, None, name="hrnet.conv9",
                    w_packed=wp[:32], **geo)
    with pytest.raises(ValueError, match="hrnet.conv9: w_packed"):
        int8_conv2d(x, wq, ws, act, None, name="hrnet.conv9", **geo)
    # the entry point refuses a packed weight of the wrong width itself
    lib = _kernel_library()
    out = torch.empty(2, 48, 24, 18, device="cuda")
    assert lib.fami_int8_implicit_gemm(
        xq.data_ptr(), wp.data_ptr(), ws.data_ptr(), act.data_ptr(), None,
        out.data_ptr(), 0, 2, 24, 18, 48, 3, 3, 1, 1, 1, 1, 1, 1, 24, 18, 48,
        64, wp.shape[1], None) != 0


@pytest.mark.parametrize("case", ["stem", "ragged", "3x3s2", "n384", "n300"])
def test_int8_kernels_stay_inside_their_buffers(guarded, gen, case):
    """The quantize pass (a last task of fewer pixels, padded channels) and
    the implicit GEMM (border taps, whose zero fill copies 0 bytes from the
    copy's first byte; the padded K chunks; a last tile of fewer rows; an N
    tile past Np, also zero-filled) on guarded buffers; results equal to the
    wrappers'."""
    from fami_pose_torch.ops.int8_conv import implicit_gemm, quant_nhwc

    for dtype in (torch.float32, torch.bfloat16):
        x, act, _, ws, wp, bias, geo = _int8_inputs(gen, case, dtype)
        code = 0 if dtype == torch.float32 else 1
        b, c, h, w = x.shape
        k, s = geo["kernel_size"], geo["stride"]
        p, d = geo["padding"], geo["dilation"]
        ref_q = quant_nhwc(x, act)
        lib = _kernel_library()
        px, pact, pq = guarded.put(x), guarded.put(act), guarded.put(ref_q)
        assert lib.fami_int8_quant_nhwc(px, pact, pq, code, b, c, h, w,
                                        ref_q.shape[3], None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(pq, ref_q), ref_q)
        ref_y = implicit_gemm(ref_q, wp, ws, act, bias, out_dtype=dtype,
                              **geo)
        ho, wo = ref_y.shape[2:]
        pwp, pws, pbias, py = (guarded.put(t) for t in (wp, ws, bias, ref_y))
        assert lib.fami_int8_implicit_gemm(
            pq, pwp, pws, pact, pbias, py, code, b, h, w, ref_q.shape[3], k,
            k, s, s, p, p, d, d, ho, wo, ws.shape[0], *wp.shape, None) == 0
        guarded.sync()
        assert torch.equal(guarded.get(py, ref_y), ref_y)
