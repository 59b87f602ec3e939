"""FAMIPose forward, eval and train (NCHW); counterpart of
``fami_pose_tpu/models/fami_pose.py`` (``FAMIPose.__call__`` mode ``"full"``
followed by ``_head``, and the serving split of modes ``"features"`` and
``"head"``: :meth:`FAMIPose.features` and :meth:`FAMIPose.head_eval`, whose
composition is the eval forward).

  * The key frame and its N supporting frames are folded into the batch and
    pushed through one HRNet pass.
  * Global alignment: the ``feat_global_offset_layers`` head reads the
    difference between a supporting frame's features and the key frame's and
    predicts one translation; ``ops.warp.warp_translate`` applies it. In eval
    mode all N*B supporting frames go through the head and one warp at once
    (BatchNorm uses running statistics, so folding them is exact). In
    training the head and the warp run once per supporting frame, so
    BatchNorm's batch statistics are per supporting frame and the head's
    running statistics take N updates per step, and each warped feature map
    also gives an auxiliary heatmap through the shared ``hrnet.final_layer``.
  * Local alignment: four modulated deformable-conv stages (3x3, dilation 3,
    ``dcn_offset_groups`` groups, offsets clamped to ±``dcn_max_offset``),
    through ``ops.deform_conv.deform_conv2d_windowed``.
  * Fusion + a 3x3 conv to NUM_JOINTS heatmaps.
  * Training adds the six mutual-information terms of the loss (softmax-KL
    estimates at temperature 0.05, the estimator side detached, in float32).

Parameter names are the reference ``Alignment_V15`` ones (``hrnet.*``,
``feat_global_offset_layers.{0..9}``, ``sup_agg_block``,
``combined_feat_layers``, ``dcn_offset_i.conv``, ``dcn_mask_i.conv``,
``dcn_i.weight/bias``, ``init_feature_agg_block``, ``agg_final_layer``).
The offset and mask convs emit the canonical ``[g][k][(dy, dx)]`` /
``[g][k]`` channel order, which the DCN reads.

``backbone_quant`` (``models/quant.py``, ``TPU.INT8_EVAL`` in eval phases)
sets the mode of every backbone conv and of the head's three residual chains
(``sup_agg_block``, ``combined_feat_layers``, ``init_feature_agg_block``), as
the JAX model passes its ``backbone_quant`` to them; the offset head, the DCN
offset and mask convs, ``agg_final_layer`` and ``hrnet.final_layer`` stay in
float.

``remat_backbone`` (``TPU.REMAT_BACKBONE``) rematerializes the backbone's
stage modules in training (``models/hrnet.py``). The model is registered in
``MODEL_REGISTRY`` as ``FAMIPose`` and ``Alignment_V15``
(``models/build.py``).
"""

import math

import torch
import torch.nn as nn

from fami_pose_torch.ops.deform_conv import deform_conv2d_windowed
from fami_pose_torch.ops.warp import warp_translate
from fami_pose_torch.utils.registry import MODEL_REGISTRY, TRAIN_PHASE

from .hrnet import HRNet, W48_EXTRA
from .layers import ChainOfBasicBlocks, Conv2d, ConvBnAct, Linear
from .quant import QUANT_INT8, QUANT_OFF

DCN_KERNEL = 3
DCN_DILATION = 3
DCN_OFFSET_GROUPS = 12
OFFSET_HEAD_CHANNELS = 16
MI_TEMPERATURE = 0.05


def _compute_dtype(name):
    return torch.bfloat16 if str(name) in ("bfloat16", "bf16") else torch.float32


class DeformConv(nn.Module):
    """Learnable-weight modulated deformable conv (torchvision
    ``DeformConv2d`` parameters: ``weight`` (Cout, Cin, 3, 3) and ``bias``;
    offsets and mask are inputs, the mask optional: None is DCNv1, every
    sample weighted 1). ``padding`` and ``dilation`` default to the
    model's 3; ``max_offset`` None (or <= 0) is the exact, unclamped DCN."""

    def __init__(self, cin, cout, offset_groups=DCN_OFFSET_GROUPS,
                 max_offset=6, padding=DCN_DILATION, dilation=DCN_DILATION):
        super().__init__()
        k = DCN_KERNEL
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.offset_groups = offset_groups
        self.max_offset = max_offset
        self.padding = int(padding)
        self.dilation = int(dilation)
        # flax variance_scaling(1/3, fan_in, uniform): U(-1/sqrt(fan), ...)
        bound = 1.0 / math.sqrt(cin * k * k)
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x, offset, mask=None):
        dt = x.dtype
        return deform_conv2d_windowed(
            x, offset.to(dt), None if mask is None else mask.to(dt),
            self.weight.to(dt), self.bias.to(dt), padding=self.padding,
            dilation=self.dilation, offset_groups=self.offset_groups,
            max_offset=self.max_offset,
        )


def _head_spatial(size):
    """Spatial size after the offset head's five stride-2 3x3 convs."""
    for _ in range(5):
        size = (size - 1) // 2 + 1
    return size


def _softmax_kl(logits_p, logits_q):
    """mean(q * log q - q * p) over rows of logits: the reference's
    ``kl_div(input=softmax(p), target=softmax(q))`` with a probability, not
    a log-probability, as its input. ``q * log q`` goes through
    ``log_softmax``, which stays finite where q underflows to 0."""
    p = torch.softmax(logits_p, dim=1)
    q = torch.softmax(logits_q, dim=1)
    log_q = torch.log_softmax(logits_q, dim=1)
    return torch.mean(q * log_q - q * p)


class FAMIPose(nn.Module):
    """The flagship model. Inputs are NCHW: key frame (B, 3, H, W) and
    supporting frames (B, 3N, H, W) stacked on the channel axis.

    ``feat_hw`` is the (h, w) of the backbone's 1/4-resolution features (the
    heatmap size), which sizes the offset head's first linear layer.
    """

    def __init__(self, extra=W48_EXTRA, num_joints=17, num_sup=4,
                 feat_channels=48, feat_hw=(96, 72),
                 dcn_offset_groups=DCN_OFFSET_GROUPS, dcn_max_offset=6,
                 warp_max_shift=26, compute_dtype=torch.float32,
                 warp_impl="matmul", backbone_quant=QUANT_OFF,
                 remat_backbone=False):
        super().__init__()
        c = int(feat_channels)
        g = int(dcn_offset_groups)
        if dcn_max_offset is not None and int(dcn_max_offset) <= 0:
            dcn_max_offset = None  # <= 0 selects the exact DCN, as None
        self.num_sup = int(num_sup)
        self.warp_max_shift = int(warp_max_shift)
        self.warp_impl = str(warp_impl)  # where a bf16 warp rounds
        self.compute_dtype = compute_dtype
        self.backbone_quant = str(backbone_quant)
        q = self.backbone_quant
        self.hrnet = HRNet(extra, num_joints, quant=q, remat=remat_backbone)
        hc = OFFSET_HEAD_CHANNELS
        flat = hc * _head_spatial(feat_hw[0]) * _head_spatial(feat_hw[1])
        self.feat_global_offset_layers = nn.Sequential(
            ChainOfBasicBlocks(c, hc, 1),
            *[ConvBnAct(hc, hc, 3, stride=2, padding=1) for _ in range(5)],
            nn.Flatten(),
            Linear(flat, 64), Linear(64, 64), Linear(64, 2),
        )
        self.sup_agg_block = ChainOfBasicBlocks(c * self.num_sup, c, 2, q)
        self.combined_feat_layers = ChainOfBasicBlocks(2 * c, c, 1, q)
        taps = DCN_KERNEL * DCN_KERNEL
        for i in range(1, 5):
            aux = dict(kernel_size=3, padding=DCN_DILATION,
                       dilation=DCN_DILATION, has_bn=False, has_act=False)
            setattr(self, f"dcn_offset_{i}", ConvBnAct(c, 2 * taps * g, **aux))
            setattr(self, f"dcn_mask_{i}", ConvBnAct(c, taps * g, **aux))
            setattr(self, f"dcn_{i}", DeformConv(c, c, g, dcn_max_offset))
        self.init_feature_agg_block = ChainOfBasicBlocks(2 * c, c, 3, q)
        self.agg_final_layer = Conv2d(c, num_joints, 3, padding=1, bias=True)

    @classmethod
    def from_config(cls, cfg, phase=TRAIN_PHASE):
        """The model of ``cfg`` for ``phase``: ``TPU.INT8_EVAL`` gives an
        int8 backbone in the eval phases only (training stays float)."""
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
            warp_impl=warp_impl,
            backbone_quant=(
                QUANT_INT8 if bool(getattr(cfg.TPU, "INT8_EVAL", False))
                and phase != TRAIN_PHASE else QUANT_OFF),
            remat_backbone=bool(getattr(cfg.TPU, "REMAT_BACKBONE", False)),
        )

    def _dcn_stage(self, idx, feat_in, target):
        off = getattr(self, f"dcn_offset_{idx}")(feat_in)
        msk = getattr(self, f"dcn_mask_{idx}")(feat_in)
        return getattr(self, f"dcn_{idx}")(target, off, msk)

    def forward(self, kf_x, sup_x, train=None):
        """Eval (``module.eval()``): returns ``(final_hm, kf_bb_hm)``,
        (B, J, h, w) each, in the compute dtype: :meth:`features` on the
        folded frames, then :meth:`head_eval`. Training
        (``module.train()``): returns ``(final_hm, sup_warped_hms, kf_bb_hm,
        mi)`` with one auxiliary heatmap per supporting frame and the six
        float32 MI terms. ``train`` defaults to ``self.training`` and must
        agree with it, since BatchNorm follows the module's mode."""
        train = self.training if train is None else bool(train)
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a module in "
                f"{'train' if self.training else 'eval'} mode: call "
                f".train() or .eval() first"
            )
        b = kf_x.shape[0]
        n = sup_x.shape[1] // 3
        if n != self.num_sup:
            raise ValueError(f"model built for {self.num_sup} supporting "
                             f"frames, got {n}")
        x = torch.cat([kf_x] + list(torch.split(sup_x, 3, dim=1)), dim=0)
        if not train:
            bb_hm, feat = self.features(x)
            return self.head_eval(feat, bb_hm[:b])
        bb_hm, feats = self.hrnet(x.to(self.compute_dtype))
        final_hm, sup_hms, mi = self.head(feats[0], b)
        return final_hm, sup_hms, bb_hm[:b], mi

    def _serving_only(self, name):
        if self.training:
            raise ValueError(f"{name} is a serving (eval-only) path: call "
                             ".eval() first")

    def features(self, frames):
        """The serving split's first half (JAX mode ``"features"``): a flat
        (M, 3, H, W) frame batch through the backbone, returning ``(bb_hm,
        feat)``, the backbone's heatmaps (M, J, h, w) and its 1/4-resolution
        features (M, C, h, w), in the compute dtype. In video serving these
        are computed once a frame and cached across the 1 + num_sup sliding
        windows each frame appears in (``engine/streaming.py``). Eval only:
        in eval mode BatchNorm uses its running statistics, so a frame's
        features do not depend on the rest of its batch (up to the order
        in which a library convolution sums at another batch size)."""
        self._serving_only("features")
        bb_hm, feats = self.hrnet(frames.to(self.compute_dtype))
        return bb_hm, feats[0]

    def head_eval(self, fold, kf_bb_hm):
        """The serving split's second half (JAX mode ``"head"``): ``fold``
        holds the backbone features of ``[key, sup1, ...]``, frame-major,
        ((1 + num_sup) * B, C, h, w); ``kf_bb_hm`` is the key frames'
        backbone heatmap (B, J, h, w). Returns ``(final_hm, kf_bb_hm)``.
        Eval only."""
        self._serving_only("head_eval")
        b = kf_bb_hm.shape[0]
        if fold.shape[0] != (1 + self.num_sup) * b:
            raise ValueError(f"a fold of (1 + {self.num_sup}) x {b} frames "
                             f"expected, got {fold.shape[0]}")
        return self.head(fold, b), kf_bb_hm

    def _feat_label_mi(self, feat_in, y):
        """I(features; labels) estimate: the shared heatmap head's prediction
        from ``feat_in``, detached, against the heatmaps ``y``. The JAX
        package flattens its (B, h, w, J) heatmaps to (B*J, h*w) rows without
        moving the joints first; the rows here are cut the same way."""
        rows = y.shape[0] * y.shape[1]
        pred = self.hrnet.final_layer(feat_in).detach()

        def logits(t):
            t = t.to(torch.float32).permute(0, 2, 3, 1)
            return t.reshape(rows, -1) / MI_TEMPERATURE

        return _softmax_kl(logits(pred), logits(y))

    @staticmethod
    def _feat_feat_mi(f1, f2):
        """I(features; features) estimate over per-channel maps, ``f1``
        detached."""
        rows = f1.shape[0] * f1.shape[1]
        return _softmax_kl(
            f1.detach().to(torch.float32).reshape(rows, -1) / MI_TEMPERATURE,
            f2.to(torch.float32).reshape(rows, -1) / MI_TEMPERATURE,
        )

    def head(self, feat, b):
        """Alignment and fusion (the JAX ``_head``): ``feat`` holds the
        backbone's 1/4-resolution features of the ``b`` key frames followed
        by those of the supporting frames, frame-major. Returns final_hm in
        eval mode and ``(final_hm, sup_warped_hms, mi)`` in training."""
        n = self.num_sup
        kf_feat = feat[:b]
        sup_hms = []
        if self.training:
            aligned = []
            for i in range(n):
                sup_feat = feat[(i + 1) * b:(i + 2) * b]
                off = self.feat_global_offset_layers(sup_feat - kf_feat)
                ga = warp_translate(sup_feat, off,
                                    max_shift=self.warp_max_shift,
                                    impl=self.warp_impl)
                aligned.append(ga)
                sup_hms.append(self.hrnet.final_layer(ga))
        else:
            all_sup = feat[b:]
            diffs = all_sup - kf_feat.repeat(n, 1, 1, 1)
            offs = self.feat_global_offset_layers(diffs)  # (N*B, 2): tx, ty
            ga_all = warp_translate(all_sup, offs,
                                    max_shift=self.warp_max_shift,
                                    impl=self.warp_impl)
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
        final_hm = self.agg_final_layer(fused)
        if not self.training:
            return final_hm
        return final_hm, sup_hms, self.mi_terms(kf_feat, agg_sup, fused,
                                                final_hm)

    def mi_terms(self, kf_feat, agg_sup, fused, final_hm):
        """The six MI estimates of a train-mode forward, from the key
        frame's backbone features, the aggregated supporting features, the
        fused features and the final heatmap."""
        return [
            self._feat_label_mi(fused, final_hm),    # I(y_t ; z~)
            self._feat_feat_mi(kf_feat, fused),      # I(z_t ; z~)
            self._feat_label_mi(agg_sup, final_hm),  # I(y_t ; z_sup)
            self._feat_feat_mi(agg_sup, fused),      # I(z_sup ; z~)
            self._feat_label_mi(kf_feat, final_hm),  # I(y_t ; z_t)
            self._feat_feat_mi(kf_feat, fused),      # I(z_t ; z~), as term 2
        ]


def init_weights_reference(model, seed=0, std=0.001):
    """Re-sample the head's conv and linear weights ~ N(0, std), zero its
    biases and set its BatchNorm scales to one, as the reference's
    ``init_weights`` does (``MODEL.INIT_WEIGHTS``). The backbone (``hrnet.*``
    except the shared ``hrnet.final_layer``, which the JAX package scopes
    outside the backbone) and the deformable convs' weights stay as they
    are; the deformable convs' biases are zeroed."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "hrnet" and parts[1] != "final_layer":
                continue
            module = model.get_submodule(".".join(parts[:-1]))
            if parts[-1] == "bias":
                p.zero_()
            elif isinstance(module, DeformConv):
                continue
            elif p.dim() == 1:  # BatchNorm scale
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


MODEL_REGISTRY.register(FAMIPose, name="FAMIPose")
MODEL_REGISTRY.register(FAMIPose, name="Alignment_V15")
