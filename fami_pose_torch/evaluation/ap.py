"""Per-joint AP / precision / recall (``poseval/py/evaluateAP.py:8-47``)."""

import numpy as np

from .assign import assign_gt_multi


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-style AP: monotone precision envelope integrated over recall
    (``eval_helpers.py:212-228``)."""
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.flatnonzero(mrec[1:] != mrec[:-1]) + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def compute_rpc(scores, labels, total_pos):
    """Precision/recall curves over score-sorted predictions
    (``eval_helpers.py:192-208``)."""
    order = np.asarray(scores).argsort()[::-1]
    labels_sorted = np.asarray(labels)[order]
    tp = np.cumsum(labels_sorted == 1)
    n = len(order)
    recall = tp / total_pos if total_pos > 0 else np.zeros(n)
    precision = tp / np.arange(1, n + 1)
    return precision, recall, order


def compute_metrics(scores_all, labels_all, n_gt_all):
    """Per-joint AP/prec/rec (+ mean in the last slot)
    (``evaluateAP.py:8-34``)."""
    j_total = n_gt_all.shape[0]
    ap = np.full((j_total + 1, 1), np.nan)
    pre = np.full((j_total + 1, 1), np.nan)
    rec = np.full((j_total + 1, 1), np.nan)
    for j in range(j_total):
        scores = np.concatenate(scores_all[j]) if scores_all[j] else np.zeros(0)
        labels = np.concatenate(labels_all[j]) if labels_all[j] else np.zeros(0)
        n_gt = n_gt_all[j].sum()
        precision, recall, _ = compute_rpc(scores, labels, n_gt)
        if len(precision) > 0:
            ap[j] = voc_ap(recall, precision) * 100
            pre[j] = precision[-1] * 100
            rec[j] = recall[-1] * 100
        else:
            ap[j] = pre[j] = rec[j] = 0.0
    for arr in (ap, pre, rec):
        vals = arr[:j_total, 0]
        arr[j_total] = np.nanmean(vals[~np.isnan(vals)]) if (~np.isnan(vals)).any() else np.nan
    return ap, pre, rec


def evaluate_ap(gt_frames, pr_frames, dist_thresh: float = 0.5):
    scores_all, labels_all, n_gt_all, _ = assign_gt_multi(
        gt_frames, pr_frames, dist_thresh
    )
    return compute_metrics(scores_all, labels_all, n_gt_all)
