"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels from
``fami_pose_torch/ops/cuda/csrc``); elsewhere they skip. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: f32 1e-4 of the output's scale (the kernel sums the 9*C products
in another order than the plain matmul, and the backward's dx and dweight
are summed with atomics); bf16 one bf16 ulp of the largest output (both
sides round one f32 sum to bf16).
"""

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
