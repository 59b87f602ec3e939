"""The bf16 DCN kernels' arithmetic, emulated on the CPU, and the wrappers'
argument checks.

``ops/cuda/csrc/dcn_fwd.cu`` rounds the sampled column (``s * mask``) to
bf16 once, so that the tensor cores can take it; the products are exact
there, the sums f32, and the output is rounded to bf16 once. This file
computes the same thing in torch at the main path's channel shape (C = Cout
= 48, G = 12, 3x3, dilation 3) on a small image, with ``chip_smoke``-style
random offsets (a third past D, a quarter rounded to integers) and with
smooth ones, for D in {4, 1, exact}, and holds it to the tolerance the card
checks use: 2^-7 of the output's scale against the plain f32
``deform_conv2d``. The column's rounding must also move the f32 sum by far
less than one output ulp (measured 0.28-0.37 of the ulp of the largest
output; the error stays 2.4-2.8x inside the tolerance), which is why the
kernel needs no hi/lo pair; the pair (5e-4 of that ulp, 2.7-3.9x inside)
is emulated too, as the fallback the design keeps in reserve.

The backward kernel (``ops/cuda/csrc/dcn_bwd.cu``) gets the same treatment:
gout and W are bf16, so dcol is exact products summed in f32; the sampled
column is rounded to bf16 once for the dW contraction; dx, dmask and
doffset are computed in f32; each output is rounded to bf16 once. The
emulation holds every gradient to 2^-7 of its scale against the plain f32
``deform_conv2d_backward_plain``; the column's rounding alone moves dW by
~0.2 of that tolerance, and with dW's own rounding ~0.4.

The second half calls ``_check_kernel_args``, ``_check_backward_args`` and
``_check_warp_args`` on CPU tensors: the kernels' shared-memory limits
(recomputed for the bf16 wgmma layouts), the C / C_out / group / shape
refusals and the warp's checks.
"""

import numpy as np
import pytest
import torch

from fami_pose_torch.ops.deform_conv import (
    SMEM_PER_BLOCK, _bilinear_grouped, _check_backward_args,
    _check_kernel_args, dcn_bwd_smem, dcn_fwd_smem, deform_conv2d,
    deform_conv2d_backward_plain,
)
from fami_pose_torch.ops.warp import _check_warp_args

C = COUT = 48
G = 12
K = 9
PAD = DIL = 3


def _inputs(seed, d, smooth, n=2, h=14, w=12):
    """bf16 inputs as the kernel gets them (float32 tensors holding bf16
    values). Random: ``chip_smoke.dcn_inputs``' recipe; smooth: offsets a
    low-frequency field of amplitude 1.5 D (6 px for the exact mode)."""
    rng = np.random.RandomState(seed)
    spread = 1.5 * d if d > 0 else 6.0
    x = rng.randn(n, C, h, w)
    if smooth:
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        phase = rng.rand(n, 2 * G * K, 1, 1) * 2 * np.pi
        freq = rng.rand(n, 2 * G * K, 1, 1) * 0.3
        off = spread * np.sin(freq * (yy + 0.7 * xx) + phase)
    else:
        off = (rng.rand(n, 2 * G * K, h, w) * 2 - 1) * spread
        off = np.where(rng.rand(*off.shape) < 0.25, np.round(off), off)
    msk = rng.rand(n, G * K, h, w)
    wgt = rng.randn(COUT, C, 3, 3) * 0.05
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    return bf(x), bf(off), bf(msk), bf(wgt)


def _columns(x, off, msk, d):
    """The sampled column per tap, f32 (N, K, C, P): what the kernel's
    threads compute before rounding."""
    n, c, h, w = x.shape
    off = off.reshape(n, G, K, 2, h, w)
    if d > 0:
        off = off.clamp(-d, d)
    msk = msk.reshape(n, G, K, h, w)
    xg = x.reshape(n, G, c // G, h, w)
    ys = (torch.arange(h) - PAD).view(1, 1, h, 1)
    xs = (torch.arange(w) - PAD).view(1, 1, 1, w)
    cols = []
    for t in range(K):
        a, b = divmod(t, 3)
        v = _bilinear_grouped(xg, (ys + a * DIL, off[:, :, t, 0]),
                              (xs + b * DIL, off[:, :, t, 1]))
        cols.append((v * msk[:, :, t].unsqueeze(2)).reshape(n, c, h * w))
    return torch.stack(cols, dim=1)


def _emulate(x, off, msk, wgt, d, hilo):
    """The kernel's order: column rounded to bf16 (or split into a bf16
    hi/lo pair, two products into one sum), exact products summed in f32
    tap by tap. Returns the f32 sum before the output's rounding."""
    col = _columns(x, off, msk, d)
    parts = [col.bfloat16().float()]
    if hilo:
        parts.append((col - parts[0]).bfloat16().float())
    w_t = wgt.reshape(COUT, C, K)
    acc = torch.zeros(x.shape[0], COUT, col.shape[-1])
    for t in range(K):
        for part in parts:
            acc = acc + torch.einsum("oc,ncp->nop", w_t[:, :, t].double(),
                                     part[:, t].double()).float()
    return acc.reshape(x.shape[0], COUT, *x.shape[2:])


def _ulp(v):
    """bf16 ulp of each value (2^(e - 7) for |v| in [2^e, 2^(e+1)))."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("hilo", [False, True], ids=["bf16", "hilo"])
@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize("d", [4, 1, 0])
def test_bf16_column_stays_within_tolerance(d, smooth, hilo):
    x, off, msk, wgt = _inputs(10 + d, d, smooth)
    ref = deform_conv2d(x, off, msk, wgt, padding=PAD, dilation=DIL,
                        offset_groups=G, max_offset=d)  # plain f32
    acc = _emulate(x, off, msk, wgt, d, hilo)
    got = acc.bfloat16().float()
    scale = max(1.0, float(ref.abs().max()))
    tol = 2.0 ** -7 * scale
    err = float((got - ref).abs().max())
    assert err <= tol, (err, tol)
    # the rounding of the column moves the f32 sum by a share of the ulp of
    # the largest output (measured 0.28-0.37 with one bf16 column, 5e-4
    # with the pair), so the bf16 result stays within one such ulp of the
    # plain version's (both round one f32 sum): one bf16 column suffices
    ulp = float(_ulp(ref.abs().max()))
    shift = float((acc - ref).abs().max()) / ulp
    assert shift < (0.5 if not hilo else 0.01), shift
    ref_bf16 = ref.bfloat16().float()
    assert float((got - ref_bf16).abs().max()) <= ulp


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("smooth", [False, True], ids=["random", "smooth"])
@pytest.mark.parametrize("d", [4, 1, 0])
def test_bf16_backward_stays_within_tolerance(d, smooth):
    """The backward kernel's order: the plain f32 gradients for dx, doffset
    and dmask (dcol from exact bf16 products summed in f32), dW from the
    bf16-rounded column, every output rounded to bf16 once."""
    x, off, msk, wgt = _inputs(20 + d, d, smooth)
    gout = _bf16(torch.from_numpy(
        np.random.RandomState(30 + d).randn(*x.shape).astype(np.float32)))
    kw = dict(padding=PAD, dilation=DIL, offset_groups=G, max_offset=d)
    ref = deform_conv2d_backward_plain(x, off, msk, wgt, gout, **kw)
    col = _columns(x, off, msk, d)  # (N, K, C, P), f32
    n = x.shape[0]
    go = gout.reshape(n, COUT, -1).double()
    dw_col = torch.einsum("nop,nkcp->ock", go, _bf16(col).double()).float()
    emulated = {"dx": ref[0], "doffset": ref[1], "dmask": ref[2],
                "dweight": dw_col.reshape(wgt.shape)}
    for (name, got), want in zip(emulated.items(), ref):
        scale = max(1.0, float(want.abs().max()))
        tol = 2.0 ** -7 * scale
        err = float((_bf16(got) - want).abs().max())
        assert err <= tol, (name, err, tol)
    # the margin of dW: the column's rounding alone, then with dW's own
    # (measured ~0.2 and ~0.4 of the tolerance)
    scale = max(1.0, float(ref[3].abs().max()))
    tol = 2.0 ** -7 * scale
    shift = float((emulated["dweight"] - ref[3]).abs().max()) / tol
    total = float((_bf16(emulated["dweight"]) - ref[3]).abs().max()) / tol
    assert shift < 0.3 and total < 0.55, (shift, total)


# -- the wrappers' argument checks ---------------------------------------------

def _dcn_args(c=48, c_out=48, g=12, h=10, w=9, dtype=torch.bfloat16,
              mask=True):
    x = torch.zeros(2, c, h, w, dtype=dtype)
    off = torch.zeros(2, 2 * g * K, h, w, dtype=dtype)
    msk = torch.zeros(2, g * K, h, w, dtype=dtype) if mask else None
    wgt = torch.zeros(c_out, c, 3, 3, dtype=dtype)
    return x, off, msk, wgt


def test_forward_smem_at_the_main_path_shape():
    # bf16: W 41,472 B + column 55,296 + result tile 13,056 + 108 gather
    # units 1,792 (1,728 rounded up to 128 B): two blocks fit an SM
    assert dcn_fwd_smem(torch.bfloat16, 48, 48, 9, 12) == 111616
    # f32: W and the column in f32, as before, and the units
    assert dcn_fwd_smem(torch.float32, 48, 48, 9, 12) == 195264
    # 48 groups: one channel a group, 432 units
    assert dcn_fwd_smem(torch.bfloat16, 48, 48, 9, 48) == 116736


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_out", [16, 32, 48, 64])
@pytest.mark.parametrize("mask", [True, False])
def test_check_kernel_args_takes_the_kernel_shapes(dtype, c_out, mask):
    for c, g in ((16, 4), (48, 12), (12, 4), (48, 48)):
        args = _dcn_args(c=c, c_out=c_out, g=g, dtype=dtype, mask=mask)
        assert _check_kernel_args(*args, 3, 3, g) == (10, 9)


@pytest.mark.parametrize("c_out", [8, 24, 96])
def test_check_kernel_args_refuses_other_cout(c_out):
    with pytest.raises(ValueError, match="C_out in 16/32/48/64"):
        _check_kernel_args(*_dcn_args(c_out=c_out), 3, 3, 12)


def test_check_kernel_args_refuses_bad_groups_and_shapes():
    x, off, msk, wgt = _dcn_args()
    with pytest.raises(ValueError, match="bad channels"):
        _check_kernel_args(x, off, msk, wgt, 3, 3, 5)
    with pytest.raises(ValueError, match="offset"):
        _check_kernel_args(x, off[:, :-2], msk, wgt, 3, 3, 12)
    with pytest.raises(ValueError, match="mask"):
        _check_kernel_args(x, off, msk[:, :-1], wgt, 3, 3, 12)
    with pytest.raises(ValueError, match="offset"):
        _check_kernel_args(x, off, msk, wgt, 1, 3, 12)  # other output size
    with pytest.raises(TypeError, match="offset is torch.float32"):
        _check_kernel_args(x, off.float(), msk, wgt, 3, 3, 12)
    with pytest.raises(ValueError, match="must be 4-D"):
        _check_kernel_args(x, off, msk, wgt[0], 3, 3, 12)


def test_check_kernel_args_shared_memory_limit_per_dtype():
    # C = 64, C_out = 64: the f32 layout needs 297,216 B and is refused; the
    # bf16 wgmma layout fits
    with pytest.raises(ValueError, match="shared memory"):
        _check_kernel_args(*_dcn_args(c=64, c_out=64, g=16,
                                      dtype=torch.float32), 3, 3, 16)
    assert _check_kernel_args(*_dcn_args(c=64, c_out=64, g=16), 3, 3, 16)
    assert dcn_fwd_smem(torch.bfloat16, 64, 64, 9, 16) <= SMEM_PER_BLOCK
    # C = 256: even the bf16 operands exceed a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        _check_kernel_args(*_dcn_args(c=256, c_out=64, g=16), 3, 3, 16)


def test_backward_smem_at_the_main_path_shape():
    # bf16, 3 taps a block: W's slice 48 x 144 13,824 B + gout^T 6,144 +
    # gout 64 x 64 8,192 + column 64 x 144 18,432 + dcol f32 64 x 148
    # 37,888 + 36 units 576 (640 rounded up to 128 B): two blocks an SM
    assert dcn_bwd_smem(torch.bfloat16, 48, 48, 12) == 85120
    assert 2 * 85120 <= 228 * 1024
    # f32: W's slice 27,648 + gout 48 x 68 13,056 + column 144 x 68 39,168
    # + dcol 37,888 + units 640
    assert dcn_bwd_smem(torch.float32, 48, 48, 12) == 118400
    # C = 12 is padded to 16 columns a tap; C = 64 the widest slice
    assert dcn_bwd_smem(torch.bfloat16, 12, 16, 4) == (
        1536 + 2048 + 8192 + 6144 + 13312 + 256)
    assert dcn_bwd_smem(torch.float32, 64, 64, 64) <= SMEM_PER_BLOCK


def _bwd_args(c=48, c_out=48, g=12, h=10, w=9, dtype=torch.bfloat16):
    x, off, msk, wgt = _dcn_args(c=c, c_out=c_out, g=g, h=h, w=w,
                                 dtype=dtype)
    return x, off, msk, wgt, torch.zeros(2, c_out, h, w, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, g", [(48, 12), (16, 4), (12, 4), (48, 48),
                                  (64, 16), (24, 3)])
def test_check_backward_args_takes_the_kernel_shapes(dtype, c, g):
    for c_out in (16, 32, 48, 64):
        args = _bwd_args(c=c, c_out=c_out, g=g, dtype=dtype)
        assert _check_backward_args(*args, 3, 3, g) == (10, 9)


def test_check_backward_args_refusals():
    with pytest.raises(ValueError, match="C <= 64"):
        _check_backward_args(*_bwd_args(c=80, g=16), 3, 3, 16)
    with pytest.raises(ValueError, match="C_out in 16/32/48/64"):
        _check_backward_args(*_bwd_args(c_out=24), 3, 3, 12)
    with pytest.raises(ValueError, match="bad channels"):
        _check_backward_args(*_bwd_args(), 3, 3, 5)
    with pytest.raises(ValueError, match="shared memory"):
        _check_backward_args(*_bwd_args(c=256, g=16), 3, 3, 16)
    x, off, msk, wgt, gout = _bwd_args()
    with pytest.raises(ValueError, match="gout"):
        _check_backward_args(x, off, msk, wgt, gout[:, :16], 3, 3, 12)
    with pytest.raises(ValueError, match="gout"):
        _check_backward_args(x, off, msk, wgt, gout[..., :-1], 3, 3, 12)
    with pytest.raises(TypeError, match="mask is torch.float32"):
        _check_backward_args(x, off, msk.float(), wgt, gout, 3, 3, 12)


def test_check_warp_args():
    img = torch.zeros(3, 4, 8, 8, dtype=torch.bfloat16)
    offs = torch.zeros(3, 2)
    assert _check_warp_args(img, offs) == 1
    assert _check_warp_args(img.float(), offs) == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check_warp_args(img.double(), offs)
    with pytest.raises(ValueError, match="offsets"):
        _check_warp_args(img, torch.zeros(2, 2))
    with pytest.raises(ValueError, match="offsets"):
        _check_warp_args(img[0], offs)
    with pytest.raises(ValueError, match="same device"):
        _check_warp_args(img, torch.zeros(3, 2, device="meta"))
