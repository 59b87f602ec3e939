"""FAMIPose eval forward (NCHW); counterpart of
``fami_pose_tpu/models/fami_pose.py`` (``FAMIPose.__call__`` mode ``"full"``
followed by ``_head`` with ``train=False``).

  * The key frame and its N supporting frames are folded into the batch and
    pushed through one HRNet pass.
  * Global alignment: the ``feat_global_offset_layers`` head reads the
    feature differences of all N*B supporting frames at once (eval BatchNorm
    uses running statistics, so folding them is exact) and predicts one
    translation each; one warp (``ops.warp.warp_translate``) applies them.
  * Local alignment: four modulated deformable-conv stages (3x3, dilation 3,
    ``dcn_offset_groups`` groups, offsets clamped to ±``dcn_max_offset``),
    through ``ops.deform_conv.deform_conv2d_windowed``.
  * Fusion + a 3x3 conv to NUM_JOINTS heatmaps.

Parameter names are the reference ``Alignment_V15`` ones (``hrnet.*``,
``feat_global_offset_layers.{0..9}``, ``sup_agg_block``,
``combined_feat_layers``, ``dcn_offset_i.conv``, ``dcn_mask_i.conv``,
``dcn_i.weight/bias``, ``init_feature_agg_block``, ``agg_final_layer``).
The offset and mask convs emit the canonical ``[g][k][(dy, dx)]`` /
``[g][k]`` channel order, which the DCN reads.
"""

import math

import torch
import torch.nn as nn

from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed
from fami_pose_torch.ops.warp import warp_translate

from .hrnet import HRNet, W48_EXTRA
from .layers import ChainOfBasicBlocks, Conv2d, ConvBnAct, Linear

DCN_KERNEL = 3
DCN_DILATION = 3
DCN_OFFSET_GROUPS = 12
OFFSET_HEAD_CHANNELS = 16


def _compute_dtype(name):
    return torch.bfloat16 if str(name) in ("bfloat16", "bf16") else torch.float32


class DeformConv(nn.Module):
    """Learnable-weight modulated deformable conv (torchvision
    ``DeformConv2d`` parameters: ``weight`` (Cout, Cin, 3, 3) and ``bias``;
    offsets and mask are inputs)."""

    def __init__(self, cin, cout, offset_groups=DCN_OFFSET_GROUPS,
                 max_offset=6):
        super().__init__()
        k = DCN_KERNEL
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.offset_groups = offset_groups
        self.max_offset = max_offset
        # flax variance_scaling(1/3, fan_in, uniform): U(-1/sqrt(fan), ...)
        bound = 1.0 / math.sqrt(cin * k * k)
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x, offset, mask):
        dt = x.dtype
        return deform_conv2d_windowed(
            x, offset.to(dt), mask.to(dt), self.weight.to(dt),
            self.bias.to(dt), padding=DCN_DILATION, dilation=DCN_DILATION,
            offset_groups=self.offset_groups, max_offset=self.max_offset,
        )


def _head_spatial(size):
    """Spatial size after the offset head's five stride-2 3x3 convs."""
    for _ in range(5):
        size = (size - 1) // 2 + 1
    return size


class FAMIPose(nn.Module):
    """The flagship model, eval mode. Inputs are NCHW: key frame (B, 3, H, W)
    and supporting frames (B, 3N, H, W) stacked on the channel axis.

    ``feat_hw`` is the (h, w) of the backbone's 1/4-resolution features (the
    heatmap size), which sizes the offset head's first linear layer.
    """

    def __init__(self, extra=W48_EXTRA, num_joints=17, num_sup=4,
                 feat_channels=48, feat_hw=(96, 72),
                 dcn_offset_groups=DCN_OFFSET_GROUPS, dcn_max_offset=6,
                 warp_max_shift=26, compute_dtype=torch.float32):
        super().__init__()
        c = int(feat_channels)
        g = int(dcn_offset_groups)
        if dcn_max_offset is not None and int(dcn_max_offset) <= 0:
            dcn_max_offset = None  # <= 0 selects the exact DCN, as None
        self.num_sup = int(num_sup)
        self.warp_max_shift = int(warp_max_shift)
        self.compute_dtype = compute_dtype
        self.hrnet = HRNet(extra, num_joints)
        hc = OFFSET_HEAD_CHANNELS
        flat = hc * _head_spatial(feat_hw[0]) * _head_spatial(feat_hw[1])
        self.feat_global_offset_layers = nn.Sequential(
            ChainOfBasicBlocks(c, hc, 1),
            *[ConvBnAct(hc, hc, 3, stride=2, padding=1) for _ in range(5)],
            nn.Flatten(),
            Linear(flat, 64), Linear(64, 64), Linear(64, 2),
        )
        self.sup_agg_block = ChainOfBasicBlocks(c * self.num_sup, c, 2)
        self.combined_feat_layers = ChainOfBasicBlocks(2 * c, c, 1)
        taps = DCN_KERNEL * DCN_KERNEL
        for i in range(1, 5):
            aux = dict(kernel_size=3, padding=DCN_DILATION,
                       dilation=DCN_DILATION, has_bn=False, has_act=False)
            setattr(self, f"dcn_offset_{i}", ConvBnAct(c, 2 * taps * g, **aux))
            setattr(self, f"dcn_mask_{i}", ConvBnAct(c, taps * g, **aux))
            setattr(self, f"dcn_{i}", DeformConv(c, c, g, dcn_max_offset))
        self.init_feature_agg_block = ChainOfBasicBlocks(2 * c, c, 3)
        self.agg_final_layer = Conv2d(c, num_joints, 3, padding=1, bias=True)

    @classmethod
    def from_config(cls, cfg):
        extra = cfg.MODEL.EXTRA
        extra = extra._to_plain() if hasattr(extra, "_to_plain") else dict(extra)
        if "STAGE2" not in extra:
            extra = dict(W48_EXTRA)
        max_off = cfg.TPU.DCN_MAX_OFFSET
        if max_off is not None and int(max_off) <= 0:
            max_off = None
        warp_impl = str(cfg.TPU.WARP_IMPL)
        hm_w, hm_h = (int(v) for v in cfg.MODEL.HEATMAP_SIZE)
        return cls(
            extra=extra,
            num_joints=int(cfg.MODEL.NUM_JOINTS),
            num_sup=2 * (int(cfg.DISTANCE) - 1),
            feat_channels=int(extra["STAGE2"]["NUM_CHANNELS"][0]),
            feat_hw=(hm_h, hm_w),
            dcn_offset_groups=int(cfg.TPU.DCN_OFFSET_GROUPS),
            dcn_max_offset=max_off,
            # the JAX "slice" warp clamps at its default 32
            warp_max_shift=32 if warp_impl == "slice"
            else int(cfg.TPU.WARP_MAX_SHIFT),
            compute_dtype=_compute_dtype(cfg.TPU.COMPUTE_DTYPE),
        )

    def _dcn_stage(self, idx, feat_in, target):
        off = getattr(self, f"dcn_offset_{idx}")(feat_in)
        msk = getattr(self, f"dcn_mask_{idx}")(feat_in)
        return getattr(self, f"dcn_{idx}")(target, off, msk)

    def forward(self, kf_x, sup_x):
        """Returns ``(final_hm, kf_bb_hm)``, (B, J, h, w) each, in the
        compute dtype."""
        b = kf_x.shape[0]
        n = sup_x.shape[1] // 3
        if n != self.num_sup:
            raise ValueError(f"model built for {self.num_sup} supporting "
                             f"frames, got {n}")
        x = torch.cat([kf_x] + list(torch.split(sup_x, 3, dim=1)), dim=0)
        bb_hm, feats = self.hrnet(x.to(self.compute_dtype))
        return self.head(feats[0], b), bb_hm[:b]

    def head(self, feat, b):
        """Alignment and fusion (the JAX ``_head``): ``feat`` holds the
        backbone's 1/4-resolution features of the ``b`` key frames followed
        by those of the supporting frames, frame-major; returns final_hm."""
        n = self.num_sup
        kf_feat = feat[:b]
        all_sup = feat[b:]
        diffs = all_sup - kf_feat.repeat(n, 1, 1, 1)
        offs = self.feat_global_offset_layers(diffs)  # (N*B, 2) = (tx, ty)
        ga_all = warp_translate(all_sup, offs, max_shift=self.warp_max_shift)
        aligned = [ga_all[i * b:(i + 1) * b] for i in range(n)]

        agg_sup = self.sup_agg_block(torch.cat(aligned, dim=1))
        combined = self.combined_feat_layers(torch.cat([agg_sup, kf_feat], 1))
        # stages 1-2 refine the combined features; stages 3-4 align the
        # aggregated supporting features conditioned on them
        combined = self._dcn_stage(1, combined, combined)
        combined = self._dcn_stage(2, combined, combined)
        aligned_sup = self._dcn_stage(3, combined, agg_sup)
        aligned_sup = self._dcn_stage(4, aligned_sup, aligned_sup)

        fused = self.init_feature_agg_block(
            torch.cat([kf_feat, aligned_sup], dim=1)
        )
        return self.agg_final_layer(fused)
