"""Optional losses the reference references but does not ship; port of
``fami_pose_tpu/losses/optional.py`` on the port's (B, J, H, W) heatmaps.

``posetimation/loss/base.py:11`` imports a missing ``integral_loss`` module
whose classes (``IntegralL1Loss``, ``StructureCosineSimilarity``) the core
function constructs (``alignment_mi_function_term6_1.py:61-62``). The JAX
package re-derives them from their standard formulations and leaves them
unwired: the ``LOSS.INTEGRAL_L1`` / ``LOSS.STRUCTURE_COSINE`` flags exist in
both packages' defaults and nothing reads them. So here.
"""

from typing import Sequence

import torch

# COCO-17 limb segments for the structure loss
COCO_LIMBS = (
    (5, 7), (7, 9), (6, 8), (8, 10), (11, 13), (13, 15), (12, 14), (14, 16),
    (5, 6), (11, 12), (5, 11), (6, 12),
)


def soft_argmax(heatmaps, temperature: float = 1.0):
    """Differentiable heatmap -> normalized (x, y) in [0, 1].

    heatmaps: (B, J, H, W). Returns (B, J, 2) float32.
    """
    b, j, h, w = heatmaps.shape
    flat = heatmaps.to(torch.float32).reshape(b, j, h * w) / temperature
    p = torch.softmax(flat, dim=-1).reshape(b, j, h, w)
    ys = (torch.arange(h, dtype=torch.float32, device=p.device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=p.device) + 0.5) / w
    ey = torch.einsum("bjhw,h->bj", p, ys)
    ex = torch.einsum("bjhw,w->bj", p, xs)
    return torch.stack([ex, ey], dim=-1)


def _targets(target_joints, image_size, device):
    t = torch.as_tensor(target_joints, device=device).to(torch.float32)
    if image_size is not None:
        t = t / torch.as_tensor(image_size, dtype=torch.float32, device=device)
    return t


def integral_l1_loss(pred_hm, target_joints, target_weight=None,
                     image_size=None):
    """Integral-regression L1: soft-argmax coords vs GT joints.

    pred_hm: (B, J, H, W); target_joints: (B, J, 2) in input-image pixels;
    target_weight: (B, J); image_size: (w, h) to normalize the targets.
    """
    coords = soft_argmax(pred_hm)
    err = (coords - _targets(target_joints, image_size, coords.device)).abs()
    if target_weight is not None:
        err = err * torch.as_tensor(target_weight, device=err.device).to(
            torch.float32)[..., None]
    return err.mean()


def structure_cosine_loss(pred_hm, target_joints, target_weight=None,
                          limbs: Sequence = COCO_LIMBS, image_size=None):
    """Limb-direction cosine similarity between predicted and GT skeletons.

    Penalizes 1 - cos(angle) per limb, weighted by both endpoint weights.
    """
    coords = soft_argmax(pred_hm)
    t = _targets(target_joints, image_size, coords.device)
    la = torch.as_tensor([a for a, _ in limbs], device=coords.device)
    lb = torch.as_tensor([b for _, b in limbs], device=coords.device)
    vp = coords[:, lb] - coords[:, la]  # (B, L, 2)
    vt = t[:, lb] - t[:, la]
    eps = 1e-6
    cos = (vp * vt).sum(-1) / (
        torch.linalg.norm(vp, dim=-1) * torch.linalg.norm(vt, dim=-1) + eps
    )
    loss = 1.0 - cos
    if target_weight is not None:
        w = torch.as_tensor(target_weight, device=loss.device).to(torch.float32)
        loss = loss * w[:, la] * w[:, lb]
    return loss.mean()
