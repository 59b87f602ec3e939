"""PCKh evaluation (``poseval/py/evaluatePCKh.py``).

Head-size-normalized distances between matched GT/prediction joints,
thresholded at 0.5 (the same matching as the AP path: each prediction keeps
its best-PCK GT, each GT keeps its best prediction).
"""

import numpy as np

from .assign import _frame_arrays
from .poseval_data import N_JOINTS, get_head_size


def compute_dist(gt_frames, pr_frames):
    """Per-frame matched distance matrices; returns a list of
    (dists (P, J) normalized or inf, hasPr) pairs."""
    out = []
    for gt_f, pr_f in zip(gt_frames, pr_frames):
        pr_f["annorect"] = [
            r for r in pr_f["annorect"]
            if r.get("annopoints") and r["annopoints"][0].get("point")
        ]
        gxy, ghas, _, _ = _frame_arrays(gt_f)
        pxy, phas, _, _ = _frame_arrays(pr_f)
        n_gt, n_pr = ghas.shape[0], phas.shape[0]
        if not (n_gt and n_pr):
            out.append((np.full((n_pr, N_JOINTS), np.inf), phas))
            continue
        head = np.array(
            [
                get_head_size(r["x1"][0], r["y1"][0], r["x2"][0], r["y2"][0])
                for r in gt_f["annorect"]
            ]
        )
        diff = pxy[:, None, :, :] - gxy[None, :, :, :]
        dist = np.linalg.norm(diff, axis=-1) / head[None, :, None]
        both = phas[:, None, :] & ghas[None, :, :]
        dist = np.where(both, dist, np.inf)
        # greedy best-GT per prediction (PCK count at 0.5)
        pck = (dist <= 0.5).sum(axis=2).astype(float)
        n_gt_joints = np.maximum(ghas.sum(axis=1), 1)
        pck = pck / n_gt_joints[None, :]
        best_gt = np.argmax(pck, axis=1)
        d = dist[np.arange(n_pr), best_gt]  # (P, J)
        out.append((d, phas))
    return out


def evaluate_pckh(gt_frames, pr_frames, thresh: float = 0.5):
    """Returns per-joint PCKh (+ mean in the last slot), in percent."""
    total = np.zeros(N_JOINTS)
    correct = np.zeros(N_JOINTS)
    # GT joint counts come from the GT side (misses count against recall)
    for gt_f in gt_frames:
        _, ghas, _, _ = _frame_arrays(gt_f)
        total += ghas.sum(axis=0)
    for d, phas in compute_dist(gt_frames, pr_frames):
        correct += ((d <= thresh) & phas).sum(axis=0)
    pckh = np.full(N_JOINTS + 1, np.nan)
    nz = total > 0
    pckh[:N_JOINTS][nz] = 100.0 * correct[nz] / total[nz]
    vals = pckh[:N_JOINTS]
    pckh[N_JOINTS] = np.nanmean(vals[~np.isnan(vals)]) if (~np.isnan(vals)).any() else np.nan
    return pckh
