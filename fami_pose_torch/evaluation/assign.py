"""Greedy PCKh assignment of predicted poses to GT poses.

Protocol-equivalent to ``poseval/py/eval_helpers.py:453-668``
(``assignGTmulti``): per frame, joint-level matches are PCKh hits
(distance / head size <= thresh); each prediction picks its best-PCK GT,
each GT keeps its best prediction; matched predictions contribute their
per-joint scores with hit labels, unmatched ones with all-false labels.
Also emits the per-joint MOT containers used by the tracking metric.
"""

from typing import Dict

import numpy as np

from .poseval_data import N_JOINTS, MIN_SCORE, get_head_size


def _frame_arrays(frame, n_joints=N_JOINTS):
    """annorect list -> (xy (R,J,2), has (R,J), score (R,J), track (R,))."""
    rects = frame["annorect"]
    r = len(rects)
    xy = np.zeros((r, n_joints, 2))
    has = np.zeros((r, n_joints), bool)
    score = np.full((r, n_joints), np.nan)
    track = np.zeros(r, int)
    for ridx, rect in enumerate(rects):
        if "track_id" in rect:
            track[ridx] = rect["track_id"][0]
        pts = rect["annopoints"][0]["point"] if rect.get("annopoints") else []
        for p in pts:
            pid = p["id"][0]
            if pid is None or pid >= n_joints:
                continue
            xy[ridx, pid] = (p["x"][0], p["y"][0])
            has[ridx, pid] = True
            score[ridx, pid] = (
                p["score"][0] if "score" in p else MIN_SCORE
            )
    return xy, has, score, track


def assign_gt_multi(gt_frames, pr_frames, dist_thresh: float = 0.5):
    """Returns (scores_all, labels_all, n_gt_all, mot_all).

    scores_all/labels_all: [joint][frame] -> 1-D arrays.
    n_gt_all: (J, n_frames) GT joint counts.
    mot_all: [frame][joint] -> dict(trackidxGT, trackidxPr, ridxsGT,
             ridxsPr, dist) for the tracking metric.
    """
    assert len(gt_frames) == len(pr_frames)
    n_frames = len(gt_frames)
    scores_all = [[np.zeros(0, np.float32) for _ in range(n_frames)] for _ in range(N_JOINTS)]
    labels_all = [[np.zeros(0, np.int8) for _ in range(n_frames)] for _ in range(N_JOINTS)]
    n_gt_all = np.zeros((N_JOINTS, n_frames))
    mot_all: Dict[int, Dict[int, dict]] = {}

    for imgidx in range(n_frames):
        # predictions must have annopoints (eval_helpers.py:496-501)
        pr_frames[imgidx]["annorect"] = [
            r for r in pr_frames[imgidx]["annorect"]
            if r.get("annopoints") and r["annopoints"][0].get("point")
        ]
        gxy, ghas, _, gtrack = _frame_arrays(gt_frames[imgidx])
        pxy, phas, pscore, ptrack = _frame_arrays(pr_frames[imgidx])
        n_gt, n_pr = ghas.shape[0], phas.shape[0]
        n_gt_all[:, imgidx] += ghas.sum(axis=0)

        if n_gt and n_pr:
            head = np.array(
                [
                    get_head_size(
                        r["x1"][0], r["y1"][0], r["x2"][0], r["y2"][0]
                    )
                    for r in gt_frames[imgidx]["annorect"]
                ]
            )
            # dist (P, G, J), inf where either side missing
            diff = pxy[:, None, :, :] - gxy[None, :, :, :]
            dist = np.linalg.norm(diff, axis=-1) / head[None, :, None]
            both = phas[:, None, :] & ghas[None, :, :]
            dist = np.where(both, dist, np.inf)
            match = dist <= dist_thresh

            n_gt_joints = ghas.sum(axis=1)  # (G,)
            pck = match.sum(axis=2).astype(np.float64)  # (P, G)
            nz = n_gt_joints > 0
            pck[:, nz] = pck[:, nz] / n_gt_joints[nz]

            # each prediction keeps only its best GT...
            best_gt = np.argmax(pck, axis=1)
            keep = np.zeros_like(pck)
            keep[np.arange(n_pr), best_gt] = pck[np.arange(n_pr), best_gt]
            # ...then each GT takes its best prediction
            pr_to_gt = np.argmax(keep, axis=0)
            pr_to_gt[keep.max(axis=0) == 0] = -1

            # MOT containers
            mot = {}
            for j in range(N_JOINTS):
                ridxs_gt = np.flatnonzero(ghas[:, j])
                ridxs_pr = np.flatnonzero(phas[:, j])
                d = np.full((len(ridxs_gt), len(ridxs_pr)), np.nan)
                for ig, rg in enumerate(ridxs_gt):
                    for ip, rp in enumerate(ridxs_pr):
                        if match[rp, rg, j]:
                            d[ig, ip] = dist[rp, rg, j]
                mot[j] = {
                    "trackidxGT": gtrack[ridxs_gt].tolist(),
                    "trackidxPr": ptrack[ridxs_pr].tolist(),
                    "ridxsGT": ridxs_gt,
                    "ridxsPr": ridxs_pr,
                    "dist": d,
                }

            matched_prs = set(int(g) for g in pr_to_gt if g >= 0)
            for ridx_pr in range(n_pr):
                if ridx_pr in matched_prs:
                    ridx_gt = int(np.flatnonzero(pr_to_gt == ridx_pr)[0])
                    m = match[ridx_pr, ridx_gt]
                else:
                    m = np.zeros(N_JOINTS, bool)
                for j in range(N_JOINTS):
                    if phas[ridx_pr, j]:
                        scores_all[j][imgidx] = np.append(
                            scores_all[j][imgidx], pscore[ridx_pr, j]
                        )
                        labels_all[j][imgidx] = np.append(
                            labels_all[j][imgidx], m[j]
                        )
        else:
            if n_gt == 0:
                # all predictions are false positives
                for ridx_pr in range(n_pr):
                    for j in range(N_JOINTS):
                        if phas[ridx_pr, j]:
                            scores_all[j][imgidx] = np.append(
                                scores_all[j][imgidx], pscore[ridx_pr, j]
                            )
                            labels_all[j][imgidx] = np.append(
                                labels_all[j][imgidx], 0
                            )
            # degenerate MOT container (eval_helpers.py:648-659)
            mot = {
                j: {
                    "trackidxGT": [0],
                    "trackidxPr": [0],
                    "ridxsGT": np.array([0]),
                    "ridxsPr": np.array([0]),
                    "dist": np.full((1, 1), np.nan),
                }
                for j in range(N_JOINTS)
            }
        mot_all[imgidx] = mot

    return scores_all, labels_all, n_gt_all, mot_all
