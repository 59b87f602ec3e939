"""Deformable residual block variants (reference ``posetimation/layers/
basic_model.py:151-349``), NCHW; port of
``fami_pose_tpu/models/deform_blocks.py``.

``modulated_deform_conv`` (the functional DCN), ``AdaptBlock``
(affine-matrix-parameterized offsets), ``AdaptBlockV2`` (+ per-group
masks) and ``DeformBlock`` (offset-conv driven). Present but unused by the
shipped FAMI-Pose model; kept for experiment configs.

Every block runs the DCN in its exact mode (``max_offset=None``, no clamp)
with dilation and padding ``dilation`` (1 by default), 1 or G offset groups,
and no mask (DCNv1) except ``AdaptBlockV2``'s. On a CUDA tensor that is
``ops/cuda/csrc/dcn_fwd.cu`` forward and ``dcn_bwd.cu`` backward
(``ops.deform_conv.deform_conv2d_windowed``, counted in its launch
counters) at any width, as a CPU tensor runs the plain versions: the
kernels take any C and C_out (HRNet-W48's branches put blocks at 48, 96,
192 and 384 channels).

Blocks compute in their input's dtype (the weights are cast to it, as the
port's ``Conv2d`` does); the affine offsets are formed in float32 and cast
to it, as in the JAX blocks. Submodule names are the JAX ones
(``transform_matrix_conv``, ``translation_conv``, ``transform_matrix_conv{i}``,
``translation_conv{i}``, ``mask_conv{i}``, ``offset_conv``, ``adapt_conv``,
``norm``, ``downsample``); ``models.bridge.block_state_dict_from_flax``
carries a block's flax variables over.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed

from .fami_pose import DeformConv
from .layers import BatchNorm, Conv2d, Downsample, activation

# 3x3 grid coordinates, (dy; dx) rows (basic_model.py:193-194)
_REGULAR = (
    (-1, -1, -1, 0, 0, 0, 1, 1, 1),
    (-1, 0, 1, -1, 0, 1, -1, 0, 1),
)


def _affine_offsets(transform, translation):
    """(N, 4, H, W) 2x2 matrices + (N, 2, H, W) translations -> (N, 18, H, W)
    offsets in (dy, dx) interleaved order (AdaptBlock semantics): tap k of
    the regular grid r_k moves by T r_k - r_k + t."""
    n, _, h, w = transform.shape
    t = transform.reshape(n, 2, 2, h, w)
    reg = torch.tensor(_REGULAR, dtype=transform.dtype,
                       device=transform.device)  # (2, 9)
    off = torch.einsum("nijhw,jk->nikhw", t, reg) - reg[None, :, :, None, None]
    off = off + translation[:, :, None]  # broadcast (dy, dx) translation
    # (N, 2, 9, H, W) -> (N, 9, 2, H, W) -> interleaved 18
    return off.transpose(1, 2).reshape(n, 18, h, w)


class _Block(nn.Module):
    """The residual tail the three blocks share: ``adapt_conv`` (the DCN),
    ``norm``, the optional ``downsample`` shortcut."""

    def _tail(self, cin, features, dilation, groups, has_downsample):
        self.adapt_conv = DeformConv(cin, features, offset_groups=groups,
                                     max_offset=None, padding=dilation,
                                     dilation=dilation)
        self.norm = BatchNorm(features)
        self.downsample = (Downsample(cin, features) if has_downsample
                           else None)

    def _residual(self, x, offset, mask):
        out = self.norm(self.adapt_conv(x, offset, mask))
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


class AdaptBlock(_Block):
    """Affine-parameterized deformable residual block
    (``basic_model.py:187-233``)."""

    def __init__(self, cin, features, dilation=1, act="ReLU",
                 has_downsample=False):
        super().__init__()
        self.transform_matrix_conv = Conv2d(cin, 4, 3, padding=1)
        self.translation_conv = Conv2d(cin, 2, 3, padding=1)
        self._tail(cin, features, dilation, 1, has_downsample)
        self.act = activation(act)

    def forward(self, x):
        offset = _affine_offsets(
            self.transform_matrix_conv(x).to(torch.float32),
            self.translation_conv(x).to(torch.float32),
        ).to(x.dtype)
        return self.act(self._residual(x, offset, None))


class AdaptBlockV2(_Block):
    """AdaptBlock + per-group modulation masks (``basic_model.py:236-303``)."""

    def __init__(self, cin, features, dilation=1, deformable_groups=1,
                 act="ReLU", has_downsample=False):
        super().__init__()
        self.deformable_groups = int(deformable_groups)
        for i in range(self.deformable_groups):
            self.add_module(f"transform_matrix_conv{i}",
                            Conv2d(cin, 4, 3, padding=1))
            self.add_module(f"translation_conv{i}",
                            Conv2d(cin, 2, 3, padding=1))
            self.add_module(f"mask_conv{i}", Conv2d(cin, 9, 3, padding=1))
        self._tail(cin, features, dilation, self.deformable_groups,
                   has_downsample)
        self.act = activation(act)

    def forward(self, x):
        offsets, masks = [], []
        for i in range(self.deformable_groups):
            offsets.append(_affine_offsets(
                getattr(self, f"transform_matrix_conv{i}")(x).to(torch.float32),
                getattr(self, f"translation_conv{i}")(x).to(torch.float32),
            ).to(x.dtype))
            masks.append(getattr(self, f"mask_conv{i}")(x))
        return self.act(self._residual(x, torch.cat(offsets, dim=1),
                                       torch.cat(masks, dim=1)))


class DeformBlock(_Block):
    """Offset-conv-driven deformable residual block
    (``basic_model.py:305-349``)."""

    def __init__(self, cin, features, dilation=1, has_downsample=False):
        super().__init__()
        self.offset_conv = Conv2d(cin, 18, 3, padding=dilation,
                                  dilation=dilation, bias=False)
        self._tail(cin, features, dilation, 1, has_downsample)

    def forward(self, x):
        return F.relu(self._residual(x, self.offset_conv(x), None))


def modulated_deform_conv(x, offset, mask, weight, bias=None, *, padding=1,
                          dilation=1, offset_groups=1):
    """Functional exact DCN, stride 1 (reference ``modulated_deform_conv`` /
    ``DeformableCONV``, ``basic_model.py:151-184``); ``mask`` None is DCNv1.
    The kernels on a CUDA tensor, the plain versions on a CPU one;
    ``offset``, ``mask``, ``weight`` and ``bias`` are cast to ``x``'s
    dtype."""
    dt = x.dtype
    return deform_conv2d_windowed(
        x, offset.to(dt), None if mask is None else mask.to(dt),
        weight.to(dt), None if bias is None else bias.to(dt),
        padding=padding, dilation=dilation, offset_groups=offset_groups,
        max_offset=None,
    )
