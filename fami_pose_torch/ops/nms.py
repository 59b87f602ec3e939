"""Box-IoU and OKS (keypoint-similarity) non-maximum suppression.

Port of ``fami_pose_tpu/ops/nms.py``, which replaces the reference's
Cython/CUDA box NMS (``thirdparty/nms/``) and numpy OKS-NMS
(``datasets/process/nms.py:9-192``) with a matrix formulation: the whole
pairwise similarity matrix is computed at once, and greedy suppression is a
scan over the detections in score order.

* Host (numpy, float64): :func:`nms`, :func:`oks_iou`, :func:`oks_nms` and
  :func:`soft_oks_nms`, a copy of the JAX package's, for the host-side
  detection pre-processing. ``native/nms.py`` has the same functions in C++.
* Device (torch, float32, any device): :func:`oks_nms_device` and
  :func:`box_nms_device` on a fixed number N of slots with a ``valid`` mask,
  returning the keep mask. The similarity matrix is one batched expression;
  the greedy scan is N steps of tensor operations with no host
  synchronisation (no ``.item()``, no ``bool()`` of a device tensor), the
  counterpart of JAX's ``jit`` + ``fori_loop`` (XLA there, not Pallas; stock
  torch operations here).
"""

import numpy as np
import torch

from fami_pose_torch.data.keypoints import COCO_OKS_SIGMAS


# -- host (numpy) API ----------------------------------------------------------

def _box_iou_matrix_np(boxes):
    """boxes (N, 4) xyxy -> (N, N) IoU with the +1 extent convention."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
    return inter / (areas[:, None] + areas[None, :] - inter)


def _oks_matrix_np(kpts, areas, sigmas):
    """kpts (N, J, 3), areas (N,) -> (N, N) object-keypoint-similarity."""
    var = (sigmas * 2.0) ** 2  # (J,)
    dx = kpts[:, None, :, 0] - kpts[None, :, :, 0]
    dy = kpts[:, None, :, 1] - kpts[None, :, :, 1]
    mean_area = (areas[:, None] + areas[None, :]) / 2.0 + np.spacing(1)
    e = (dx * dx + dy * dy) / var[None, None, :] / mean_area[..., None] / 2.0
    return np.mean(np.exp(-e), axis=-1)


def _greedy_suppress_np(sim, scores, thr):
    """Greedy NMS on a precomputed similarity matrix."""
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(scores), dtype=bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= sim[i] > thr
        suppressed[i] = True  # self-similarity must not drop the kept item twice
    return keep


def nms(dets, thr):
    """Greedy box NMS. dets: (N, 5) [x1 y1 x2 y2 score]. Returns kept indices."""
    dets = np.asarray(dets, dtype=np.float64)
    if len(dets) == 0:
        return []
    sim = _box_iou_matrix_np(dets[:, :4])
    return _greedy_suppress_np(sim, dets[:, 4], thr)


def oks_iou(g, d, a_g, a_d, sigmas=None, vis_thr=None):
    """OKS of one pose ``g`` (J*3 flat) against each row of ``d`` (N, J*3)."""
    sigmas = COCO_OKS_SIGMAS if sigmas is None else np.asarray(sigmas)
    g = np.asarray(g, np.float64).reshape(-1, 3)
    d = np.asarray(d, np.float64).reshape(len(d), -1, 3)
    var = (sigmas * 2.0) ** 2
    mean_area = (a_g + np.asarray(a_d, np.float64)) / 2.0 + np.spacing(1)
    e = ((d[:, :, 0] - g[None, :, 0]) ** 2 + (d[:, :, 1] - g[None, :, 1]) ** 2)
    e = e / var[None, :] / mean_area[:, None] / 2.0
    if vis_thr is not None:
        mask = (g[None, :, 2] > vis_thr) & (d[:, :, 2] > vis_thr)
        num = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        cnt = mask.sum(axis=1)
        return np.where(cnt > 0, num / np.maximum(cnt, 1), 0.0).astype(np.float32)
    return np.exp(-e).mean(axis=1).astype(np.float32)


def _pose_arrays(kpts_db):
    scores = np.array([k["score"] for k in kpts_db], dtype=np.float64)
    kpts = np.stack([np.asarray(k["keypoints"], np.float64).reshape(-1, 3)
                     for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db], dtype=np.float64)
    return scores, kpts, areas


def oks_nms(kpts_db, thr, sigmas=None, vis_thr=None):
    """Greedy OKS NMS over a list of {'score', 'keypoints' (J,3), 'area'}."""
    if len(kpts_db) == 0:
        return []
    sigmas = COCO_OKS_SIGMAS if sigmas is None else np.asarray(sigmas)
    scores, kpts, areas = _pose_arrays(kpts_db)
    if vis_thr is None:
        sim = _oks_matrix_np(kpts, areas, sigmas)
        return np.array(_greedy_suppress_np(sim, scores, thr))
    # the visibility-gated variant goes through pairwise oks_iou rows
    n = len(kpts_db)
    sim = np.zeros((n, n))
    flat = kpts.reshape(n, -1)
    for i in range(n):
        sim[i] = oks_iou(flat[i], flat, areas[i], areas, sigmas, vis_thr)
    return np.array(_greedy_suppress_np(sim, scores, thr))


def soft_oks_nms(kpts_db, thr, max_dets=20, sigmas=None, vis_thr=None):
    """Soft OKS NMS with Gaussian rescoring (reference ``nms.py:150-192``).
    As in the JAX package, ``vis_thr`` is accepted and not used."""
    if len(kpts_db) == 0:
        return []
    sigmas = COCO_OKS_SIGMAS if sigmas is None else np.asarray(sigmas)
    scores, kpts, areas = _pose_arrays(kpts_db)
    sim = _oks_matrix_np(kpts, areas, sigmas)

    order = list(np.argsort(-scores, kind="stable"))
    cur_scores = scores[order].copy()
    keep = []
    while order and len(keep) < max_dets:
        i = order.pop(0)
        keep.append(int(i))
        rest_scores = cur_scores[1:] * np.exp(-sim[i, order] ** 2 / thr)
        resort = np.argsort(-rest_scores, kind="stable")
        order = [order[j] for j in resort]
        cur_scores = rest_scores[resort]
    return np.array(keep)


# -- device (torch) API: fixed N, no host synchronisation -----------------------

def box_iou_matrix(boxes):
    """boxes (N, 4) xyxy float32 -> (N, N) IoU, +1 extent convention."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (xx2 - xx1 + 1).clamp_min(0.0) * (yy2 - yy1 + 1).clamp_min(0.0)
    return inter / (areas[:, None] + areas[None, :] - inter)


def oks_matrix(kpts, areas, sigmas=None):
    """kpts (N, J, 3), areas (N,) float32 -> (N, N) OKS, one batched
    expression."""
    sigmas = torch.as_tensor(COCO_OKS_SIGMAS if sigmas is None else sigmas,
                             dtype=kpts.dtype, device=kpts.device)
    var = (sigmas * 2.0) ** 2
    dx = kpts[:, None, :, 0] - kpts[None, :, :, 0]
    dy = kpts[:, None, :, 1] - kpts[None, :, :, 1]
    mean_area = (areas[:, None] + areas[None, :]) / 2.0 + float(np.spacing(1))
    e = (dx * dx + dy * dy) / var / mean_area[..., None] / 2.0
    return torch.exp(-e).mean(dim=-1)


def greedy_suppress(sim, scores, valid, thr):
    """The keep mask (N,) of greedy NMS on ``sim`` (N, N): slots visited in
    descending score (stable), invalid slots last and never kept; a live
    slot is kept and suppresses every slot whose similarity to it exceeds
    ``thr``. N steps of tensor operations on ``sim``'s device, reading no
    value back to the host."""
    n = scores.shape[0]
    valid = valid.to(torch.bool)
    key = torch.where(valid, scores.to(torch.float32),
                      torch.full_like(scores, -float("inf"),
                                      dtype=torch.float32))
    order = torch.sort(-key, stable=True).indices
    # row k: the similarities of the k-th slot visited, and its one-hot
    above = sim.index_select(0, order) > thr
    onehot = order[:, None] == torch.arange(n, device=sim.device)[None, :]
    alive = torch.ones(n, dtype=torch.bool, device=sim.device)
    keep = torch.zeros(n, dtype=torch.bool, device=sim.device)
    for k in range(n):
        hit = onehot[k]
        live = (alive & valid & hit).any()
        keep = keep | (hit & live)
        alive = torch.where(live, alive & ~above[k], alive) & ~hit
    return keep


def oks_nms_device(kpts, scores, areas, valid, thr=0.9):
    """Greedy OKS NMS on the device of ``kpts``.

    Args:
      kpts: (N, J, 3) poses (a fixed N; pad unused slots).
      scores: (N,), areas: (N,), valid: (N,) bool for the real entries.
      thr: suppression threshold.

    Returns:
      keep: (N,) bool mask of the survivors.
    """
    sim = oks_matrix(kpts.to(torch.float32), areas.to(torch.float32))
    return greedy_suppress(sim, scores, valid, thr)


def box_nms_device(boxes, scores, valid, thr=0.6):
    """Greedy box NMS on the device of ``boxes`` (N, 4) xyxy; the keep
    mask (N,)."""
    sim = box_iou_matrix(boxes.to(torch.float32))
    return greedy_suppress(sim, scores, valid, thr)
