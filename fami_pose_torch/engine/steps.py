"""Eval step (``fami_pose_tpu/engine/steps.py::make_eval_step``): the
forward, plus flip-test averaging behind ``flip_test``."""

import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS
from fami_pose_torch.ops.pose import flip_back


def make_eval_step(model, flip_test=False, flip_pairs=None):
    """Returns ``eval_fn(kf, sup) -> (final_hm, kf_bb_hm)``: NCHW inputs,
    float32 (B, J, h, w) heatmaps. With ``flip_test`` a second forward runs
    on the mirrored inputs, is flipped back (left/right joints swapped) and
    averaged into ``final_hm``, as the JAX eval step does."""
    pairs = flip_pairs if flip_pairs is not None else COCO_FLIP_PAIRS

    @torch.inference_mode()
    def step(kf, sup):
        final, kf_bb = model(kf, sup)
        if flip_test:
            f_final, _ = model(torch.flip(kf, dims=(3,)),
                               torch.flip(sup, dims=(3,)))
            final = (final + flip_back(f_final, pairs)) * 0.5
        return final.to(torch.float32), kf_bb.to(torch.float32)

    return step
