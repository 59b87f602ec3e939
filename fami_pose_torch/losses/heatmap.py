"""Training losses (``fami_pose_tpu/losses/heatmap.py``), NCHW.

``joint_mse_loss`` is the reference ``JointMSELoss``: per-joint MSE over the
flattened heatmaps, optional per-joint target weights, optional division by
the joint count. ``fami_total_loss`` is the loss of the training loop: the
weighted final-heatmap MSE, one MSE per warped supporting-frame heatmap, and
the 6-term MI combination ``alpha * (-beta*mi1 + beta*mi2 + mi3 - mi4 + mi5
- mi6)`` with alpha = 0.5 and beta = 0.1.
"""

import torch

MI_ALPHA = 0.5
MI_BETA = 0.1


def joint_mse_loss(pred, target, target_weight=None, use_target_weight=True,
                   divide_num_joints=True):
    """Heatmap MSE: ``pred``/``target`` (B, J, H, W), ``target_weight``
    (B, J) or (B, J, 1). The mean over (B, H*W) per joint, summed over the
    joints (and divided by their count), in float32."""
    b, j = pred.shape[:2]
    p = pred.to(torch.float32).reshape(b, j, -1)
    t = target.to(torch.float32).reshape(b, j, -1)
    if use_target_weight and target_weight is not None:
        w = target_weight.to(torch.float32).reshape(b, j, 1)
        p = p * w
        t = t * w
    loss = ((p - t) ** 2).mean(dim=(0, 2)).sum()
    return loss / j if divide_num_joints else loss


def fami_total_loss(final_hm, sup_hms, mi_list, target, target_weight,
                    mse_weight=1.0, mi_alpha=MI_ALPHA, mi_beta=MI_BETA):
    """Full FAMI-Pose training loss; returns ``(total, per-term dict)``."""
    loss_mse = joint_mse_loss(final_hm, target, target_weight) * mse_weight
    loss_sup = loss_mse.new_zeros(())
    for hm in sup_hms:
        loss_sup = loss_sup + joint_mse_loss(hm, target, target_weight) * mse_weight
    coeffs = (-mi_beta, mi_beta, 1.0, -1.0, 1.0, -1.0)
    loss_mi = loss_mse.new_zeros(())
    for coeff, mi in zip(coeffs, mi_list):
        loss_mi = loss_mi + coeff * mi
    loss_mi = mi_alpha * loss_mi
    total = loss_mse + loss_sup + loss_mi
    aux = {"loss": total, "loss_mse": loss_mse, "loss_sup_mse": loss_sup,
           "loss_mi": loss_mi}
    for i, mi in enumerate(mi_list):
        aux[f"loss_mi_{i + 1}"] = mi
    return total, aux


def build_loss(cfg):
    """Heatmap-MSE loss from ``cfg.LOSS.HEATMAP_MSE`` (its ``WEIGHT`` and
    ``DIVIDED_NUM_JOINTS``)."""
    node = cfg.LOSS.HEATMAP_MSE
    weight = float(node.WEIGHT)
    divide = bool(getattr(node, "DIVIDED_NUM_JOINTS", True))

    def fn(pred, target, target_weight=None):
        return weight * joint_mse_loss(
            pred, target, target_weight, divide_num_joints=divide
        )

    return fn
