"""Train and eval steps (``fami_pose_tpu/engine/steps.py``).

The train step does forward, loss, backward, optimizer and scheduler step
and returns its metrics as device tensors: nothing in it waits for the
device, so the caller fetches them only when it prints. The eval step is
the forward, plus flip-test averaging behind ``flip_test``."""

import torch

from fami_pose_torch.data.keypoints import COCO_FLIP_PAIRS
from fami_pose_torch.losses import fami_total_loss
from fami_pose_torch.ops.pose import flip_back


def heatmap_pck_accuracy(pred, target, thr=0.5):
    """Train-time PCK from the heatmaps' argmax, with the reference's
    semantics: a (sample, joint) pair is valid iff BOTH argmax coordinates
    of the target exceed 1 (an all-zero target decodes to (0, 0) and fails);
    x distances are normalized by h/10 and y distances by w/10 (the
    reference's axis swap); per-joint accuracies are taken over the valid
    pairs and averaged, unweighted, over the joints that have one.

    pred/target: (B, J, H, W). Returns ``(avg_acc, counted_joints)`` as
    tensors on their device.
    """
    b, j, h, w = pred.shape

    def argmax_xy(hm):
        flat = hm.to(torch.float32).reshape(b, j, h * w)
        maxv, idx = flat.max(dim=2)  # the first maximum, as jnp.argmax
        vis = (maxv > 0).to(torch.float32)
        return (idx % w).to(torch.float32) * vis, (idx // w).to(torch.float32) * vis

    px, py = argmax_xy(pred)
    tx, ty = argmax_xy(target)
    d = torch.sqrt(((px - tx) / (h / 10.0)) ** 2 + ((py - ty) / (w / 10.0)) ** 2)
    valid = (tx > 1) & (ty > 1)
    correct = (d < thr) & valid
    cnt_j = valid.sum(dim=0)
    acc_j = correct.sum(dim=0) / cnt_j.clamp(min=1)
    has = cnt_j > 0
    n_counted = has.sum()
    acc = torch.where(
        n_counted > 0,
        (acc_j * has).sum() / n_counted.clamp(min=1),
        torch.zeros((), device=pred.device),
    )
    return acc, n_counted


def make_train_step(mse_weight=1.0, mi_alpha=0.5, mi_beta=0.1):
    """Returns ``step_fn(state, batch) -> (state, metrics)``: ``state`` is a
    ``TrainState`` (updated in place) whose model is in training mode
    (``model.train()``), ``batch`` a dict with ``kf``
    (B, 3, H, W), ``sup`` (B, 3N, H, W), ``target`` (B, J, h, w) and
    ``target_weight`` (B, J) on the model's device. ``metrics`` holds the
    loss terms and the PCK accuracies as detached device tensors."""

    def step(state, batch):
        model = state.model
        final, sup_hms, kf_bb, mi = model(batch["kf"], batch["sup"], train=True)
        total, aux = fami_total_loss(
            final, sup_hms, mi, batch["target"], batch["target_weight"],
            mse_weight=mse_weight, mi_alpha=mi_alpha, mi_beta=mi_beta,
        )
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in aux.items()}
            metrics["acc"], _ = heatmap_pck_accuracy(final, batch["target"])
            metrics["acc_kf_backbone"], _ = heatmap_pck_accuracy(
                kf_bb, batch["target"])
            for i, hm in enumerate(sup_hms):
                metrics[f"acc_sup{i + 1}"], _ = heatmap_pck_accuracy(
                    hm, batch["target"])
        return state, metrics

    return step


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
