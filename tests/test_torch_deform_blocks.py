"""The deform-block variants (``fami_pose_torch/models/deform_blocks.py``)
against the JAX package's (``fami_pose_tpu/models/deform_blocks.py``) with
the same random flax variables carried over by
``models.bridge.block_state_dict_from_flax``: ``AdaptBlock``,
``AdaptBlockV2`` (2 offset groups, masks) and ``DeformBlock``, at JAX's test
width (6) and at 16, with and without the downsample shortcut, f32.

Eval mode: the forward. Train mode: the forward, the running statistics,
and every gradient (each parameter and the input) of ``sum(out * cot)``.
Both packages run the exact (unclamped) DCN here; the port's plain backward
differs from autodiff of JAX's gather only where an offset is an integer,
which random f32 offsets never are.

Tolerance: 1e-5 of each tensor's largest magnitude (f32 sums in another
order; train-mode BatchNorm is two-pass in the port, flax's fast variance
in JAX); for ``adapt_conv.bias`` in train mode, whose gradient a
BatchNorm makes zero up to rounding, 1e-5 of the block's largest
parameter gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.models import deform_blocks as jax_blocks
from fami_pose_torch.models import deform_blocks as blocks
from fami_pose_torch.models.bridge import block_state_dict_from_flax
from fami_pose_torch.models.fami_pose import DeformConv
from fami_pose_torch.ops.deform_conv import (
    _check_backward_args, _check_kernel_args, dcn_bwd_smem, dcn_fwd_smem,
    SMEM_PER_BLOCK,
)
from torch_port_helpers import nchw, nhwc, random_variables

RTOL = 1e-5

VARIANTS = {
    "adapt": (jax_blocks.AdaptBlock, blocks.AdaptBlock, {}),
    "adapt_v2": (jax_blocks.AdaptBlockV2, blocks.AdaptBlockV2,
                 {"deformable_groups": 2}),
    "deform": (jax_blocks.DeformBlock, blocks.DeformBlock, {}),
}


def _close(got, ref, what, scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max()) if scale is None else scale
    assert err <= RTOL * max(scale, 1e-30), (what, err)


def _pair(name, width, downsample, cin=None):
    jcls, pcls, kw = VARIANTS[name]
    cin = width if cin is None else cin
    rs = np.random.RandomState(width)
    x = rs.randn(2, 9, 7, cin).astype(np.float32)
    jm = jcls(features=width, has_downsample=downsample, **kw)
    variables = random_variables(
        lambda k: jm.init(k, jnp.asarray(x), train=False), seed=width + 1)
    pm = pcls(cin, width, has_downsample=downsample, **kw)
    pm.load_state_dict(block_state_dict_from_flax(variables))
    return jm, pm, variables, x


@pytest.mark.parametrize("width", [6, 16])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_eval_forward_matches_jax(name, width):
    jm, pm, variables, x = _pair(name, width, downsample=False)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm.eval()(nchw(x))
    _close(nhwc(got), ref, "out")


@pytest.mark.parametrize("width,downsample", [(6, False), (16, True)])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_step_gradients_match_jax(name, width, downsample):
    """Train mode: the output, the updated running statistics and the
    gradient of every parameter and of the input."""
    cin = width + 2 if downsample else width
    jm, pm, variables, x = _pair(name, width, downsample, cin=cin)
    cot = np.random.RandomState(9).randn(2, 9, 7, width).astype(np.float32)

    def loss(params, xin):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xin, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    (_, (ref_out, upd)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                           jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    out = pm.train()(xt)
    (out * nchw(cot)).sum().backward()
    _close(nhwc(out.detach()), ref_out, "out")
    _close(nhwc(xt.grad), g_x, "dx")
    want = block_state_dict_from_flax({"params": jax.tree.map(np.asarray,
                                                              g_params)})
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert set(grads) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for n, g in grads.items():
        # the DCN's bias feeds a train-mode BatchNorm, which takes any
        # per-channel constant out: its gradient is zero up to rounding
        _close(g, want[n], n, largest if n == "adapt_conv.bias" else None)
    stats = block_state_dict_from_flax({"batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    state = pm.state_dict()
    for k, v in stats.items():
        _close(state[k], v, k)


def test_names_follow_the_jax_blocks():
    """Submodules keep JAX's names, leaves are torch's, and every flax leaf
    has a port key (``load_state_dict`` is strict)."""
    _, pm, variables, _ = _pair("adapt_v2", 16, downsample=True, cin=18)
    keys = set(pm.state_dict())
    for want in ("transform_matrix_conv0.weight", "translation_conv1.bias",
                 "mask_conv1.weight", "adapt_conv.weight", "adapt_conv.bias",
                 "norm.running_var", "downsample.0.weight",
                 "downsample.1.running_mean"):
        assert want in keys, want
    _, pm, _, _ = _pair("deform", 6, downsample=False)
    assert "offset_conv.weight" in pm.state_dict()
    assert "offset_conv.bias" not in pm.state_dict()


@pytest.mark.parametrize("groups,with_mask", [(1, False), (2, True)])
def test_modulated_deform_conv_matches_jax(groups, with_mask):
    """The functional exact DCN at dilation 2, offsets far past the image
    (~N(0, 8) px), DCNv1 without a mask."""
    rs = np.random.RandomState(groups)
    x = rs.randn(2, 8, 9, 4).astype(np.float32)
    off = (rs.randn(2, 8, 9, 18 * groups) * 8).astype(np.float32)
    mask = rs.rand(2, 8, 9, 9 * groups).astype(np.float32) if with_mask \
        else None
    w = (rs.randn(3, 3, 4, 16) * 0.2).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    ref = jax_blocks.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(off),
        None if mask is None else jnp.asarray(mask), jnp.asarray(w),
        jnp.asarray(b), padding=2, dilation=2, offset_groups=groups)
    got = blocks.modulated_deform_conv(
        nchw(x), nchw(off), None if mask is None else nchw(mask),
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), padding=2, dilation=2, offset_groups=groups)
    _close(nhwc(got), ref, "out")


def test_deform_conv_defaults_are_the_models():
    """``DeformConv``'s new ``padding`` / ``dilation`` default to the
    model's 3 and its mask to None (DCNv1); FAMIPose's four stages are
    built as before."""
    conv = DeformConv(8, 16, offset_groups=2)
    assert (conv.padding, conv.dilation, conv.max_offset) == (3, 3, 6)
    x = torch.randn(1, 8, 6, 5)
    off = torch.randn(1, 36, 6, 5)
    a = conv(x, off)
    b = conv(x, off, torch.ones(1, 18, 6, 5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("c,c_out,msg", [
    (64, 6, "C_out in 16/32/48/64"), (96, 64, "C <= 64")])
def test_widths_outside_the_kernels_are_refused_by_name(c, c_out, msg):
    """On the card a block's DCN runs the kernels. These widths (C_out = 6,
    C = 96), which the kernels' checks once refused by the name ``msg``, are
    now taken: the checks they run first (here on CPU tensors: the same
    checks, without the launch) pass, within a block's shared memory."""
    x = torch.zeros(1, c, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(c_out, c, 3, 3, dtype=torch.bfloat16)
    off = torch.zeros(1, 18, 8, 8, dtype=torch.bfloat16)
    gout = torch.zeros(1, c_out, 8, 8, dtype=torch.bfloat16)
    assert _check_backward_args(x, off, None, w, gout, 1, 1, 1) == (8, 8)
    assert _check_kernel_args(x, off, None, w, 1, 1, 1) == (8, 8)
    for dtype in (torch.float32, torch.bfloat16):
        assert dcn_fwd_smem(dtype, c, c_out, 9, 1) <= SMEM_PER_BLOCK
        assert dcn_bwd_smem(dtype, c, c_out, 1) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("groups", [1, 2])
def test_the_blocks_widest_settings_on_the_kernels(groups):
    """C = C_out = 64, dilation 1, one or two groups: both kernels fit a
    block's shared memory in both types; the f32 forward (297,216 B in the
    whole-W layout, once refused) takes its chunked form, 65,536 B."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 64, 8, 8, dtype=dtype)
        w = torch.zeros(64, 64, 3, 3, dtype=dtype)
        off = torch.zeros(1, 18 * groups, 8, 8, dtype=dtype)
        mask = torch.zeros(1, 9 * groups, 8, 8, dtype=dtype)
        gout = torch.zeros(1, 64, 8, 8, dtype=dtype)
        assert dcn_bwd_smem(dtype, 64, 64, groups) <= SMEM_PER_BLOCK
        assert _check_backward_args(x, off, mask, w, gout, 1, 1, groups) \
            == (8, 8)
        assert _check_kernel_args(x, off, None, w, 1, 1, groups) == (8, 8)
        assert dcn_fwd_smem(dtype, 64, 64, 9, groups) <= SMEM_PER_BLOCK
    assert dcn_fwd_smem(torch.float32, 64, 64, 9, groups) == 65536
