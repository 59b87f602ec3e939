"""The batch protocol against crop-locked streaming and the auto re-prime
policy, through poseval AP, on a trained checkpoint of
``tools/sustained_train.py``.

    python -m fami_pose_torch.tools.streaming_ab --ckpt <epoch_46_state.ckpt> \\
        --motion drift --occlude 0.4 [--reprime-iou 0.9 0.7 0.5] [--tiny] \\
        [--image-size 96 128] [--device cuda]

The counterpart of the JAX repository's ``tools/streaming_ab.py``.
Streaming (``engine/streaming.py``) reuses each frame's backbone features
across the sliding windows it appears in, which is exact only while the
person crop is held fixed ("crop-locked"); the batch protocol re-crops
every window frame under the key frame's box. The tool writes the
checkpoint's own fixture again (seed 3, joint markers; ``--motion`` and
``--occlude`` must be the run's; 2 videos x 5 frames x 2 people, 20
emissions) and serves it three ways, with no flip-test:

  * ``batch``: each key frame's window cropped under that key frame's box,
    one forward, the DARK decode;
  * ``locked``: one stream a (video, track slot), locked at its first box
    and fed through the streaming step (``init_state``, ``make_step``),
    decoded under the locked affine;
  * ``reprime@iou`` for each ``--reprime-iou``: the locked stream with the
    auto re-prime policy (``StreamingPosePredictor.prime``,
    ``boxes_moved``, ``maybe_reprime``). The trigger and the re-crop use
    the box at the emission horizon, the key frame fed ``distance - 1``
    steps earlier; the history is the frames already fed, re-cropped
    under the new boxes, steps before 0 clamped to the prime frame.

Boundary key frames use the streaming clamp and are scored too: that is
what a server emits. Crops are ``dark_get_affine_transform`` +
``cv2.warpAffine`` + the host normalisation. The tool prints each
variant's per-joint AP and its delta against batch, the drift of the
locked keypoints against batch's (mean, p95, max, image px), each re-prime
row's re-primes and their rate per emission, each variant's seconds and
kernel launches, then one JSON line with all of it.

The re-prime counts depend on the boxes only (``boxes_moved`` compares the
fixture's GT boxes with the locked ones), not on the weights: on the drift
fixture they are 14 / 8 / 4 of 20 at IoU 0.9 / 0.7 / 0.5, as in the JAX
repository's ``docs/STREAMING_AB.md``.

``--tiny`` reads a ``sustained_train.py --tiny`` checkpoint. Runs on
``--device`` (default ``cuda``, the hand-written kernels; ``cpu`` runs
their plain versions).
"""

import argparse
import json
import os.path as osp
import shutil
import tempfile
import time

import cv2
import numpy as np
import torch

from fami_pose_torch.data.posetrack import read_image, support_frame_paths
from fami_pose_torch.data.video_dataset import normalize_image_uint8
from fami_pose_torch.engine.checkpoints import load_variables
from fami_pose_torch.engine.streaming import (
    StreamingPosePredictor, init_state, make_step,
)
from fami_pose_torch.models.build import build_model
from fami_pose_torch.ops import launch_counts, launches_since
from fami_pose_torch.ops.affine import dark_get_affine_transform
from fami_pose_torch.ops.heatmap import dark_get_final_preds
from fami_pose_torch.utils.registry import DATASET_REGISTRY, VAL_PHASE

from .ab_dcn_bound import eval_cfg
from .sustained_train import write_fixture

DEFAULT_IOUS = (0.9, 0.7, 0.5)


class Fixture:
    """The fixture's eval rows grouped into streams, and its crops."""

    def __init__(self, cfg, dataset):
        self.db = db = dataset.data
        self.w, self.h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
        self.image_size = cfg.MODEL.IMAGE_SIZE
        self.distance = int(cfg.DISTANCE)
        self.num_joints = int(cfg.MODEL.NUM_JOINTS)
        self._images = {}
        # (video, track slot) streams; the fixture's tracks are the
        # per-frame annotation order within a video
        self.streams = {}
        for i, item in enumerate(db):
            vid, fid = item["video_name"], int(item["frame_id"])
            slot = sum(1 for it in db[:i] if it["video_name"] == vid
                       and int(it["frame_id"]) == fid)
            self.streams.setdefault((vid, slot), {})[fid] = i
        self.keys = sorted(self.streams)
        self.frame_ids = sorted({int(it["frame_id"]) for it in db})
        first = [db[self.streams[k][min(self.streams[k])]] for k in self.keys]
        self.lock_c = np.stack([it["center"] for it in first]).astype(
            np.float32)
        self.lock_s = np.stack([it["scale"] for it in first]).astype(
            np.float32)

    def image(self, path):
        if path not in self._images:
            self._images[path] = cv2.cvtColor(read_image(path),
                                              cv2.COLOR_BGR2RGB)
        return self._images[path]

    def crop(self, path, center, scale):
        """(H, W, 3) float32, normalised as the model's input."""
        trans = dark_get_affine_transform(center, scale, 0.0, self.image_size)
        out = cv2.warpAffine(self.image(path), trans, (self.w, self.h),
                             flags=cv2.INTER_LINEAR)
        return normalize_image_uint8(out)

    def frame_path(self, key, fid):
        any_item = self.db[self.streams[key][min(self.streams[key])]]
        stem = osp.basename(any_item["image"])
        return osp.join(osp.dirname(any_item["image"]),
                        str(fid).zfill(len(stem) - 4) + ".jpg")

    def gt_box(self, key, fid):
        """The stream's tracker box at ``fid`` (the fixture's GT box)."""
        if fid in self.streams[key]:
            it = self.db[self.streams[key][fid]]
            return it["center"], it["scale"]
        return None

    def crops(self, fid, centers, scales):
        """Every stream's frame ``fid`` under its box: (B, H, W, 3)."""
        return np.stack([self.crop(self.frame_path(k, fid), centers[i],
                                   scales[i])
                         for i, k in enumerate(self.keys)])


def nchw(frames, device):
    """(..., H, W, 3) numpy -> (..., 3, H, W) float32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(frames)).to(
        device).movedim(-1, -3)


def decode(hm, centers, scales):
    """DARK decode of (B, J, h, w) heatmaps: (B, J, 3) numpy, xy + score."""
    p, m = dark_get_final_preds(hm.float(), centers, scales)
    return np.concatenate([p.cpu().numpy(), m.cpu().numpy()], axis=-1)


@torch.inference_mode()
def serve_batch(model, fx, device):
    """The batch protocol: (N, J, 3) predictions."""
    kfs, sups = [], []
    for item in fx.db:
        c, s = item["center"], item["scale"]
        kfs.append(fx.crop(item["image"], c, s))
        sups.append(np.concatenate(
            [fx.crop(p, c, s) for p in support_frame_paths(
                item["image"], item["nframes"], fx.distance)], axis=-1))
    hm, _ = model(nchw(np.stack(kfs), device), nchw(np.stack(sups), device))
    return decode(hm, np.stack([it["center"] for it in fx.db]),
                  np.stack([it["scale"] for it in fx.db]))


def emit(fx, preds, key_t, hm, centers, scales):
    """Write the streams' emission for key frame index ``key_t`` into
    ``preds``; returns how many rows it wrote."""
    fid = fx.frame_ids[key_t]
    p = decode(hm, centers, scales)
    n = 0
    for k, key in enumerate(fx.keys):
        if fid in fx.streams[key]:
            preds[fx.streams[key][fid]] = p[k]
            n += 1
    return n


@torch.inference_mode()
def serve_locked(model, fx, device):
    """Crop-locked streaming: ``(preds, locked crops (T, B, H, W, 3), the
    emitted heatmaps (T, B, J, h, w))``."""
    frames = np.stack([fx.crops(fid, fx.lock_c, fx.lock_s)
                       for fid in fx.frame_ids])
    step = make_step(model, fx.distance)
    state = init_state(model, nchw(frames[0], device), fx.distance)
    lat, n_t = fx.distance - 1, len(fx.frame_ids)
    preds = np.zeros((len(fx.db), fx.num_joints, 3), np.float32)
    hms, emitted = [], 0
    for t in range(n_t + lat):
        state, (hm, _) = step(state, nchw(frames[min(t, n_t - 1)], device))
        if t >= lat:
            hms.append(hm.cpu().numpy())
            emitted += emit(fx, preds, t - lat, hm, fx.lock_c, fx.lock_s)
    if emitted != len(fx.db):
        raise AssertionError(f"{emitted} emissions for {len(fx.db)} rows")
    return preds, frames, np.stack(hms)


@torch.inference_mode()
def serve_reprime(model, fx, device, iou):
    """Crop-locked streaming with the auto re-prime policy at ``iou``:
    ``(preds, re-primes)``."""
    pred = StreamingPosePredictor(model, fx.distance, reprime_iou=iou)
    cur_c, cur_s = fx.lock_c.copy(), fx.lock_s.copy()
    ids = fx.frame_ids
    n_t, lat = len(ids), fx.distance - 1
    w_buf = 2 * fx.distance - 1
    pred.prime(nchw(fx.crops(ids[0], cur_c, cur_s), device), cur_c, cur_s)
    preds = np.zeros((len(fx.db), fx.num_joints, 3), np.float32)
    reprimed = 0
    for t in range(n_t + lat):
        # the box at the emission horizon: the key frame fed lat steps ago
        kf_fid = ids[min(max(t - lat, 0), n_t - 1)]
        boxes = [fx.gt_box(key, kf_fid) for key in fx.keys]
        new_c = np.stack([b[0] if b else cur_c[k]
                          for k, b in enumerate(boxes)]).astype(np.float32)
        new_s = np.stack([b[1] if b else cur_s[k]
                          for k, b in enumerate(boxes)]).astype(np.float32)
        mask = pred.boxes_moved(new_c, new_s)
        if mask.any():
            # the frames already fed (steps t - W .. t - 1, clamped to the
            # prime frame), re-cropped under the new boxes
            hist = np.stack([fx.crops(ids[min(max(t - d, 0), n_t - 1)],
                                      new_c, new_s)
                             for d in range(w_buf, 0, -1)])
            pred.maybe_reprime(new_c, new_s, nchw(hist, device))
            cur_c[mask], cur_s[mask] = new_c[mask], new_s[mask]
            reprimed += int(mask.sum())
        hm, _ = pred(nchw(fx.crops(ids[min(t, n_t - 1)], cur_c, cur_s),
                          device))
        if t >= lat:
            emit(fx, preds, t - lat, hm, cur_c, cur_s)
    return preds, reprimed


def drift(a, b):
    d = np.linalg.norm(a[:, :, :2] - b[:, :, :2], axis=-1)
    return dict(mean=float(d.mean()), p95=float(np.percentile(d, 95)),
                max=float(d.max()))


def run(ckpt, motion=None, occlude=0.0, reprime_ious=DEFAULT_IOUS,
        tiny=False, image_size=(96, 128), device="cuda", root=None):
    """The A/B on ``ckpt`` (a checkpoint path, or a model ``state_dict``),
    with the fixture under ``root`` (default: a temporary directory,
    removed afterwards); returns ``(report, extras)``: the JSON line's dict,
    and ``extras``: the locked variant's crops (T, B, H, W, 3), emitted
    heatmaps (T, B, J, h, w), predictions (N, J, 3) and boxes, and the
    batch variant's predictions."""
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="stream_ab_")
    try:
        write_fixture(root, motion, occlude)
        cfg = eval_cfg(root, tiny=tiny, image_size=image_size)
        dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, VAL_PHASE)
        fx = Fixture(cfg, dataset)
        model = build_model(cfg, VAL_PHASE)
        model.load_state_dict(ckpt if isinstance(ckpt, dict)
                              else load_variables(ckpt))
        model.to(device).eval()
        n = len(fx.db)
        boxes = np.zeros((n, 6), np.float32)
        img_path_map = {}
        for i, item in enumerate(fx.db):
            img_path_map.setdefault(item["image"], []).append(i)
            boxes[i, 0:2] = item["center"]
            boxes[i, 2:4] = item["scale"]
            boxes[i, 4] = np.prod(item["scale"] * 200)
            boxes[i, 5] = item["score"]

        def timed(fn, *args):
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            return out, time.perf_counter() - t0, launches_since(before)

        variants = []
        preds, secs, launched = timed(serve_batch, model, fx, device)
        variants.append(dict(variant="batch", preds=preds, seconds=secs,
                             launches=launched, reprimes=None))
        (preds, frames, hms), secs, launched = timed(serve_locked, model, fx,
                                                     device)
        locked = preds
        variants.append(dict(variant="locked", preds=preds, seconds=secs,
                             launches=launched, reprimes=0))
        for iou in reprime_ious:
            (preds, reprimed), secs, launched = timed(serve_reprime, model,
                                                      fx, device, iou)
            variants.append(dict(variant=f"reprime@{iou}", iou=float(iou),
                                 preds=preds, seconds=secs, launches=launched,
                                 reprimes=reprimed))
        rows = []
        for v in variants:
            name_value, _ = dataset.evaluate(
                cfg, v["preds"], osp.join(root, f"eval_{v['variant']}"),
                boxes, img_path_map)
            row = {k: v[k] for k in v if k != "preds"}
            row["ap"] = {k: float(x) for k, x in dict(name_value).items()}
            if v["reprimes"] is not None:
                row["reprime_rate"] = v["reprimes"] / n
            rows.append(row)
            print(f"[{v['variant']}] " + ", ".join(
                f"{k}={x:.2f}" for k, x in row["ap"].items())
                + (f"  (re-primes: {v['reprimes']}, rate "
                   f"{v['reprimes'] / n:.2f}/emission)"
                   if v["variant"].startswith("reprime") else ""), flush=True)
        ref = rows[0]["ap"]
        for r in rows[1:]:
            r["ap_delta"] = {k: r["ap"][k] - ref[k] for k in ref}
        report = dict(tool="fami_pose_torch.tools.streaming_ab",
                      ckpt=ckpt if isinstance(ckpt, str) else "state_dict",
                      motion=motion, occlude=occlude, tiny=tiny,
                      device=str(device), emissions=n, streams=len(fx.keys),
                      drift_px=drift(variants[0]["preds"], locked),
                      rows=rows)
        extras = dict(frames=frames, hms=hms, preds=locked,
                      batch_preds=variants[0]["preds"], lock_center=fx.lock_c,
                      lock_scale=fx.lock_s, distance=fx.distance)
        return report, extras
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)


def reprime_counts(report):
    """{iou: re-primes} of the report's re-prime rows."""
    return {r["iou"]: r["reprimes"] for r in report["rows"] if "iou" in r}


def print_tables(report):
    rows = report["rows"]
    d = report["drift_px"]
    print(f"\nkeypoint drift batch-vs-locked (px, original image coords): "
          f"mean {d['mean']:.3f}  p95 {d['p95']:.3f}  max {d['max']:.3f}")
    joints = list(rows[0]["ap"])
    print("\n== per-joint AP, delta vs batch, re-primes / "
          f"{report['emissions']} emissions ==")
    print(f"{'variant':14s} " + " ".join(f"{j:>9s}" for j in joints)
          + f" {'reprimes':>8s} {'rate':>5s} {'secs':>7s}")
    for r in rows:
        rep = "" if r["reprimes"] is None else str(r["reprimes"])
        rate = f"{r['reprime_rate']:.2f}" if "reprime_rate" in r else ""
        print(f"{r['variant']:14s} " + " ".join(f"{r['ap'][j]:9.3f}"
                                                for j in joints)
              + f" {rep:>8s} {rate:>5s} {r['seconds']:7.2f}")
    for r in rows[1:]:
        print(f"{'d ' + r['variant']:14s} " + " ".join(
            f"{r['ap_delta'][j]:+9.3f}" for j in joints))
    for r in rows:
        launched = ", ".join(f"{k} {v}" for k, v in r["launches"].items()
                             if v) or "none (plain versions)"
        print(f"launches {r['variant']}: {launched}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a tools/sustained_train.py checkpoint")
    p.add_argument("--reprime-iou", type=float, nargs="*",
                   default=list(DEFAULT_IOUS),
                   help="IoU thresholds of the re-prime rows")
    p.add_argument("--motion", default=None,
                   choices=[None, "drift", "articulated"],
                   help="the fixture's motion: the checkpoint's own")
    p.add_argument("--occlude", type=float, default=0.0,
                   help="the fixture's occlusion rate: the checkpoint's own")
    p.add_argument("--tiny", action="store_true",
                   help="a sustained_train.py --tiny checkpoint")
    p.add_argument("--image-size", type=int, nargs=2, default=[96, 128],
                   metavar=("W", "H"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    report, _ = run(args.ckpt, args.motion, args.occlude,
                    args.reprime_iou or (), args.tiny, args.image_size,
                    args.device)
    print_tables(report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
