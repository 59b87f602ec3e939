"""Per-joint MOTA/MOTP tracking metrics.

Protocol-equivalent to ``poseval/py/evaluateTracking.py:14-222`` with a
self-contained CLEAR-MOT accumulator replacing the vendored ``py-motmetrics``
(``motmetrics/mot.py:14-230``): per frame, (1) carry forward previous
object->hypothesis pairings when still feasible, (2) Kuhn-Munkres on the
remaining distance matrix (NaN = forbidden), (3) MISS / FP for the leftovers;
SWITCH when an object re-pairs with a different hypothesis. MOTA/MOTP/prec/
rec are computed from the accumulated counts exactly as motmetrics defines
them (``metrics.py:200-267``).
"""

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from .poseval_data import N_JOINTS


class MOTAccumulatorLite:
    """CLEAR-MOT event counting (MATCH/SWITCH/MISS/FP + distance sum)."""

    def __init__(self):
        self.pairings: Dict[int, int] = {}
        self.num_misses = 0
        self.num_switches = 0
        self.num_false_positives = 0
        self.num_matches = 0
        self.num_objects = 0
        self.sum_d = 0.0

    def update(self, oids: List[int], hids: List[int], dists: np.ndarray):
        oids = list(oids)
        hids = list(hids)
        dists = np.atleast_2d(np.asarray(dists, float)).reshape(
            len(oids), len(hids)
        )
        self.num_objects += len(oids)

        o_free = np.ones(len(oids), bool)
        h_free = np.ones(len(hids), bool)

        # sanitize: NaN/inf -> forbidden marker (mot.py:214-229)
        valid = dists[np.isfinite(dists)]
        invdist = 2 * valid.max() + 1 if valid.size else 1.0
        d = np.where(np.isfinite(dists), dists, invdist)

        if len(oids) and len(hids):
            # 1. carry forward previous pairings
            for i, o in enumerate(oids):
                h_prev = self.pairings.get(o)
                if h_prev is None or h_prev not in hids:
                    continue
                j = hids.index(h_prev)
                if not h_free[j]:
                    continue
                if d[i, j] != invdist:
                    o_free[i] = False
                    h_free[j] = False
                    self.num_matches += 1
                    self.sum_d += d[i, j]

            # 2. Kuhn-Munkres on the rest
            dd = d.copy()
            dd[~o_free, :] = invdist
            dd[:, ~h_free] = invdist
            rows, cols = linear_sum_assignment(dd)
            for i, j in zip(rows, cols):
                if dd[i, j] == invdist:
                    continue
                o, h = oids[i], hids[j]
                if o in self.pairings and self.pairings[o] != h:
                    self.num_switches += 1
                else:
                    self.num_matches += 1
                self.sum_d += dd[i, j]
                self.pairings[o] = h
                o_free[i] = False
                h_free[j] = False

        # 3/4. misses and false positives
        self.num_misses += int(o_free.sum())
        self.num_false_positives += int(h_free.sum())

    @property
    def num_detections(self):
        return self.num_matches + self.num_switches


def evaluate_tracking(gt_frames, mot_all):
    """Per-joint (+ total) MOTA/MOTP/precision/recall over all sequences.

    ``mot_all`` comes from :func:`assign.assign_gt_multi`. Like the vendored
    script, the last frame of each sequence is excluded
    (``evaluateTracking.py:72``).
    """
    seq_ids = np.array([f["seq_id"] for f in gt_frames])
    totals = {
        k: np.zeros(N_JOINTS)
        for k in ("num_misses", "num_switches", "num_false_positives",
                  "num_objects", "num_detections", "sum_d")
    }
    for seq in np.unique(seq_ids):
        img_idxs = np.flatnonzero(seq_ids == seq)[:-1]
        accs = [MOTAccumulatorLite() for _ in range(N_JOINTS)]
        for imgidx in img_idxs:
            mot = mot_all[imgidx]
            for j in range(N_JOINTS):
                accs[j].update(
                    mot[j]["trackidxGT"], mot[j]["trackidxPr"], mot[j]["dist"]
                )
        for j, acc in enumerate(accs):
            totals["num_misses"][j] += acc.num_misses
            totals["num_switches"][j] += acc.num_switches
            totals["num_false_positives"][j] += acc.num_false_positives
            totals["num_objects"][j] += acc.num_objects
            totals["num_detections"][j] += acc.num_detections
            totals["sum_d"][j] += acc.sum_d

    mota = np.full(N_JOINTS + 1, np.nan)
    motp = np.full(N_JOINTS + 1, np.nan)
    pre = np.full(N_JOINTS + 1, np.nan)
    rec = np.full(N_JOINTS + 1, np.nan)
    for j in range(N_JOINTS):
        n_obj = totals["num_objects"][j]
        n_det = totals["num_detections"][j]
        if n_obj > 0:
            mota[j] = 100.0 * (
                1.0
                - (totals["num_misses"][j] + totals["num_switches"][j]
                   + totals["num_false_positives"][j]) / n_obj
            )
            rec[j] = 100.0 * n_det / n_obj
        # reference sets MOTP to 0.0 (not NaN) when nothing was detected
        # (evaluateTracking.py:171-174)
        motp[j] = (
            100.0 * (1.0 - totals["sum_d"][j] / n_det) if n_det > 0 else 0.0
        )
        denom = n_det + totals["num_false_positives"][j]
        if denom > 0:
            pre[j] = 100.0 * n_det / denom
    for arr in (mota, motp, pre, rec):
        vals = arr[:N_JOINTS]
        arr[N_JOINTS] = np.nanmean(vals) if (~np.isnan(vals)).any() else np.nan
    return {"mota": mota, "motp": motp, "pre": pre, "rec": rec}
