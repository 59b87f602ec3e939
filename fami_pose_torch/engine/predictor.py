"""Clip + person boxes -> keypoints: the serving entry point of the port.

The non-streaming loop of ``tools/demo.py`` (reference batch protocol): for
every box of every frame, the key frame and its ``2 * (DISTANCE - 1)``
supporting frames (clamp-to-edge neighbours ``fi - span .. fi + span``) are
cropped on the device with the box's DARK affine, normalized, run through
the eval step (with flip-test if asked) and decoded with
``get_final_preds``. Requests are batched ``batch_size`` at a time; in eval
mode every request is independent of the others in its batch.

A config with ``TPU.INT8_EVAL`` is refused: int8 needs a calibration pass
over data, which the serving entry points do not have (neither has the JAX
package's demo). ``python -m fami_pose_torch.run --val`` calibrates and
scores such a config; a model calibrated with ``models.quant.calibrate``
streams int8 through ``engine/streaming.py``.
"""

import numpy as np
import torch

from fami_pose_torch.data.loader import prepare_eval_inputs_device_crop
from fami_pose_torch.models.bridge import calibrate_batch_norm, init_weights
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.ops.heatmap import get_final_preds
from fami_pose_torch.utils.bbox import box2cs

from .steps import make_eval_step


def serving_model(cfg, state_dict=None, device="cuda", seed=0):
    """The FAMIPose of ``cfg`` in eval mode on ``device``, with the weights
    of ``state_dict``, or, for None, the seeded random weights of
    ``models.bridge.init_weights(seed)`` with BatchNorm statistics
    calibrated on seeded random frames. Raises ``NotImplementedError`` for
    a config with ``TPU.INT8_EVAL`` (module docstring)."""
    if bool(getattr(cfg.TPU, "INT8_EVAL", False)):
        raise NotImplementedError(
            "TPU.INT8_EVAL: the predictor and the demo serve no int8 model "
            "(int8 needs a calibration pass over data); score the config "
            "with `python -m fami_pose_torch.run --val`, or calibrate a "
            "model with models.quant.calibrate and serve it through "
            "engine.streaming")
    dev = torch.device(device)
    model = FAMIPose.from_config(cfg).to(dev).eval()
    if state_dict is not None:
        model.load_state_dict(state_dict)
        return model
    init_weights(model, seed)
    w, h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    gen = torch.Generator().manual_seed(int(seed))
    frames = torch.randn(2, 3 * (1 + model.num_sup), h, w,
                         generator=gen).to(dev)
    calibrate_batch_norm(model, frames[:, :3], frames[:, 3:])
    return model


class PosePredictor:
    """Serve a FAMIPose model.

    Args:
      cfg: a merged config (``fami_pose_torch.config``).
      state_dict: port weights (e.g. from ``models.bridge``); None gives the
        seeded random weights of ``models.bridge.init_weights(seed)``, with
        BatchNorm statistics calibrated on seeded random frames.
      device: where the model, the crops and the decode run.
      flip_test: average in the flipped forward (off, as in the demo).
      batch_size: requests per forward batch.
    """

    def __init__(self, cfg, state_dict=None, device="cuda", flip_test=False,
                 batch_size=8, seed=0):
        self.device = torch.device(device)
        self.image_size = (int(cfg.MODEL.IMAGE_SIZE[0]),
                           int(cfg.MODEL.IMAGE_SIZE[1]))  # (w, h)
        self.model = serving_model(cfg, state_dict, device, seed)
        self.eval_step = make_eval_step(self.model, flip_test=flip_test)
        self.aspect = self.image_size[0] / self.image_size[1]
        self.enlarge = float(cfg.DATASET.BBOX_ENLARGE_FACTOR)
        self.span = int(cfg.DISTANCE) - 1
        self.batch_size = int(batch_size)

    def window(self, fi, n_frames):
        """Frame indices [key, sup...] of key frame ``fi`` (clamp to edge)."""
        sup = [fi - d for d in range(self.span, 0, -1)]
        sup += [fi + d for d in range(1, self.span + 1)]
        return [fi] + [min(max(s, 0), n_frames - 1) for s in sup]

    @torch.inference_mode()
    def crop(self, frames, requests):
        """Crop and normalize the inputs of one batch on the device.

        Args:
          frames: (T, 3, H, W) uint8 clip on ``self.device``.
          requests: list of (frame_index, bbox xywh).

        Returns:
          kf (B, 3, h, w), sup (B, 3N, h, w) float32, and the boxes' center
          and scale (B, 2).
        """
        t, _, h, w = frames.shape
        cs = [box2cs(bbox, self.aspect, self.enlarge) for _, bbox in requests]
        center = torch.as_tensor(np.stack([c for c, _ in cs]),
                                 device=self.device)
        scale = torch.as_tensor(np.stack([s for _, s in cs]),
                                device=self.device)
        idx = torch.as_tensor(
            [self.window(fi, t) for fi, _ in requests], device=self.device
        )  # (B, 1 + N)
        b = idx.shape[0]
        kf_raw = frames[idx[:, 0]]
        sup_raw = frames[idx[:, 1:].reshape(-1)].reshape(b, -1, h, w)
        kf, sup = prepare_eval_inputs_device_crop(
            kf_raw, sup_raw, center, scale,
            torch.zeros(b, device=self.device), self.image_size,
        )
        return kf, sup, center, scale

    @torch.inference_mode()
    def predict_batch(self, frames, requests):
        """Run one batch: :meth:`crop`, the eval step, the decode.

        Returns final_hm (B, J, h, w) float32, preds (B, J, 2) image pixels
        and maxvals (B, J, 1), all on ``self.device``.
        """
        kf, sup, center, scale = self.crop(frames, requests)
        final_hm, _ = self.eval_step(kf, sup)
        preds, maxvals = get_final_preds(final_hm, center, scale)
        return final_hm, preds, maxvals

    def __call__(self, frames, boxes_by_frame=None, frame_names=None):
        """Predict every box of a clip.

        Args:
          frames: (T, H, W, 3) uint8 RGB frames (array or list of arrays).
          boxes_by_frame: {frame index: [(bbox xywh, score), ...]}; None
            gives one full-frame box per frame.
          frame_names: names for the records (default: the indices).

        Returns the records of ``tools/demo.py``'s ``keypoints.json``:
        ``{"frame", "bbox", "bbox_score", "keypoints": [[x, y, score]] * J}``
        in frame order.
        """
        clip = np.ascontiguousarray(np.stack(frames))
        t, h, w = clip.shape[:3]
        if boxes_by_frame is None:
            boxes_by_frame = {i: [([0, 0, w, h], 1.0)] for i in range(t)}
        names = frame_names if frame_names is not None else list(range(t))
        dev_frames = torch.from_numpy(clip).to(self.device).permute(0, 3, 1, 2)
        reqs = [(fi, bbox, score) for fi in sorted(boxes_by_frame)
                for bbox, score in boxes_by_frame[fi]]
        records = []
        for start in range(0, len(reqs), self.batch_size):
            chunk = reqs[start:start + self.batch_size]
            _, preds, maxvals = self.predict_batch(
                dev_frames, [(fi, bbox) for fi, bbox, _ in chunk]
            )
            pose = torch.cat([preds, maxvals], dim=-1).cpu().numpy()
            for (fi, bbox, score), p in zip(chunk, pose):
                records.append({
                    "frame": names[fi],
                    "bbox": [float(v) for v in bbox],
                    "bbox_score": float(score),
                    "keypoints": p.tolist(),
                })
        return records
