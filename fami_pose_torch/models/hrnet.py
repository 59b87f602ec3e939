"""HRNet backbone (NCHW); counterpart of ``fami_pose_tpu/models/hrnet.py``.

Same multi-resolution topology, from ``cfg.MODEL.EXTRA``: a stem of two
stride-2 3x3 convs to 1/4 resolution, ``layer1`` of 4 Bottlenecks, stages
2/3/4 of parallel-branch modules with sum fusion (1x1 conv + nearest
upsampling coarse->fine, strided 3x3 conv chains fine->coarse), transitions
that grow a new branch from the coarsest previous one, and a ``final_layer``
conv to NUM_JOINTS heatmaps. Module names are the official PyTorch HRNet's
(``conv1``, ``bn1``, ``layer1.N``, ``transitionT.I``, ``stageS.M.branches``,
``stageS.M.fuse_layers``, ``final_layer``).

``forward`` returns ``(heatmaps, features)`` where ``features[0]`` is the
1/4-resolution map of width ``STAGE2.NUM_CHANNELS[0]`` (48 for W48).
Only the int8-free (``quant="off"``) path exists in the port so far.
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import BasicBlock, BatchNorm, Bottleneck, Conv2d, Interpolate, conv3x3

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(cin, cout, k, stride, relu):
    mods = [
        Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False),
        BatchNorm(cout),
    ]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class HighResolutionModule(nn.Module):
    """Parallel branches + all-to-all sum fusion."""

    def __init__(self, num_branches, block, num_blocks, num_channels,
                 in_channels, multi_scale_output=True):
        super().__init__()
        blk = BLOCKS[block]
        outs = [c * blk.expansion for c in num_channels]
        branches = []
        for i in range(num_branches):
            layers = [blk(in_channels[i], num_channels[i],
                          has_downsample=in_channels[i] != outs[i])]
            layers += [blk(outs[i], num_channels[i])
                       for _ in range(1, num_blocks[i])]
            branches.append(nn.Sequential(*layers))
        self.branches = nn.ModuleList(branches)
        self.fuse_layers = None
        if num_branches > 1:
            n_out = num_branches if multi_scale_output else 1
            fuse = []
            for i in range(n_out):
                row = []
                for j in range(num_branches):
                    if j > i:
                        row.append(nn.Sequential(
                            Conv2d(outs[j], outs[i], 1, bias=False),
                            BatchNorm(outs[i]),
                            Interpolate(2 ** (j - i)),
                        ))
                    elif j == i:
                        row.append(None)
                    else:
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            steps.append(_conv_bn(
                                outs[j], outs[i] if last else outs[j], 3, 2,
                                relu=not last,
                            ))
                        row.append(nn.Sequential(*steps))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for row in self.fuse_layers:
            y = None
            for j, layer in enumerate(row):
                t = xs[j] if layer is None else layer(xs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class HRNet(nn.Module):
    """Config-driven HRNet with heatmap head (``extra`` is
    ``cfg.MODEL.EXTRA`` as a dict)."""

    def __init__(self, extra, num_joints=17):
        super().__init__()
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = BatchNorm(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = BatchNorm(64)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, has_downsample=True),
            *[Bottleneck(256, 64) for _ in range(3)],
        )
        prev = [256]
        stages = ["STAGE2", "STAGE3", "STAGE4"]
        for si, name in enumerate(stages):
            s = extra[name]
            n_mod, n_br = int(s["NUM_MODULES"]), int(s["NUM_BRANCHES"])
            block = str(s["BLOCK"])
            n_blocks = [int(b) for b in s["NUM_BLOCKS"]]
            chans = [int(c) for c in s["NUM_CHANNELS"]]
            outs = [c * BLOCKS[block].expansion for c in chans]
            setattr(self, f"transition{si + 1}", self._transition(prev, outs))
            mods = []
            for m in range(n_mod):
                multi = not (name == stages[-1] and m == n_mod - 1)
                mods.append(HighResolutionModule(
                    n_br, block, n_blocks, chans, outs, multi_scale_output=multi,
                ))
            setattr(self, f"stage{si + 2}", nn.Sequential(*mods))
            prev = outs
        k = int(extra.get("FINAL_CONV_KERNEL", 1))
        self.final_layer = Conv2d(
            prev[0], num_joints, k, padding=1 if k == 3 else 0, bias=True
        )

    @staticmethod
    def _transition(prev, new):
        layers = []
        for i, c in enumerate(new):
            if i < len(prev):
                layers.append(
                    _conv_bn(prev[i], c, 3, 1, relu=True) if c != prev[i]
                    else None
                )
            else:
                steps = []
                for k in range(i + 1 - len(prev)):
                    last = k == i - len(prev)
                    steps.append(_conv_bn(
                        prev[-1], c if last else prev[-1], 3, 2, relu=True
                    ))
                layers.append(nn.Sequential(*steps))
        return nn.ModuleList(layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t in (1, 2, 3):
            trans = getattr(self, f"transition{t}")
            xs = [
                (xs[i] if layer is None else layer(xs[i])) if i < len(xs)
                else layer(xs[-1])
                for i, layer in enumerate(trans)
            ]
            for module in getattr(self, f"stage{t + 1}"):
                xs = module(xs)
        return self.final_layer(xs[0]), xs


# Standard W48 EXTRA tree (``configs/base_posetrack17.yaml``).
W48_EXTRA = {
    "FINAL_CONV_KERNEL": 1,
    "STAGE2": {
        "NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
        "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [48, 96], "FUSE_METHOD": "SUM",
    },
    "STAGE3": {
        "NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
        "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [48, 96, 192],
        "FUSE_METHOD": "SUM",
    },
    "STAGE4": {
        "NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
        "NUM_BLOCKS": [4, 4, 4, 4], "NUM_CHANNELS": [48, 96, 192, 384],
        "FUSE_METHOD": "SUM",
    },
}

# A tiny topology for fast CPU tests.
TINY_EXTRA = {
    "FINAL_CONV_KERNEL": 1,
    "STAGE2": {
        "NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
        "NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [8, 16], "FUSE_METHOD": "SUM",
    },
    "STAGE3": {
        "NUM_MODULES": 1, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
        "NUM_BLOCKS": [1, 1, 1], "NUM_CHANNELS": [8, 16, 32],
        "FUSE_METHOD": "SUM",
    },
    "STAGE4": {
        "NUM_MODULES": 1, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
        "NUM_BLOCKS": [1, 1, 1, 1], "NUM_CHANNELS": [8, 16, 32, 64],
        "FUSE_METHOD": "SUM",
    },
}
