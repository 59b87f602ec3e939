"""Evaluator: checkpoint sweep + eval loop + protocol scoring
(``fami_pose_tpu/engine/evaluator.py``).

Enumerate checkpoints (explicit ``MODEL_FILE``, every checkpoint >= an id, or
the latest), run the eval step over the padded eval loader, decode the
heatmaps on the device (argmax + gradient sign, or DARK under
``POST_PROCESS``), map back to image coordinates through the inverse affine,
accumulate the flat prediction arrays, and hand them to ``dataset.evaluate``
(the poseval AP protocol). Both the final aligned heatmaps and the
backbone-only heatmaps are scored.

Heatmaps are (B, J, h, w) throughout the port, the layout the decode reads,
so nothing is transposed between the eval step and the decode.

``TPU.INT8_EVAL`` builds the model with an int8 backbone
(``models/quant.py``); each checkpoint is calibrated afresh on the first
``TPU.INT8_CALIB_BATCHES`` eval batches after it is loaded and before the
DCN window is chosen (``TPU.DCN_AUTO_WINDOW``), so the window is measured on
the int8 numerics, the order of the JAX evaluator.

The model comes from ``MODEL_REGISTRY`` (``models/build.py``) and the eval
step from the core function of ``cfg.CORE_FUNCTION``
(``engine/core_functions.py``).

``TPU.MESH_SHAPE`` lays the data axis over the ranks of the process group
(``parallel/mesh.py``): each rank loads its data index's slice of every
global batch, runs the eval step and the decode on it, and the decoded
predictions are gathered by rows (one rank of each data index), so that
every rank holds the global predictions. Each rank calibrates and measures
the DCN window on its own slice; rank 0's int8 scales and window are
broadcast to every rank, so every rank runs the same model. Only rank 0
scores (``dataset.evaluate``); the others return ``{}`` for each
checkpoint.

``DEBUG.VIS_SKELETON`` / ``DEBUG.VIS_BBOX`` draw the first 50 predictions
onto their source frames under ``<output>/<phase>_vis``
(:meth:`Evaluator._vis_hook`, ``visualization/draw.py``), the box from
``cs2box(..., "xyxy")`` under ``VIS_BBOX``: the JAX evaluator's overlays.
Over several ranks rank 0 alone draws, after the predictions are gathered,
and writes the files the JAX evaluator writes.
"""

import logging
import os.path as osp
import time
from collections import OrderedDict

import numpy as np
import torch

import fami_pose_torch.data.jhmdb  # noqa: F401  (dataset registration)
import fami_pose_torch.data.posetrack  # noqa: F401
from fami_pose_torch.data.loader import (
    build_eval_loader, prepare_eval_inputs, prepare_eval_inputs_device_crop,
)
from fami_pose_torch.models.build import build_model
from fami_pose_torch.models.fami_pose import DeformConv
from fami_pose_torch.models.quant import (
    QUANT_INT8, calibrate, set_quant_scales,
)
from fami_pose_torch.ops.heatmap import dark_get_final_preds, get_final_preds
from fami_pose_torch.parallel.mesh import all_gather_rows, broadcast_tensors
from fami_pose_torch.utils.bbox import cs2box
from fami_pose_torch.utils.registry import DATASET_REGISTRY, VAL_PHASE
from fami_pose_torch.visualization import draw_skeleton_in_origin_image

from . import checkpoints
from .core_functions import build_core_function
# the evaluator refuses what the trainer refuses: a mesh the process group
# cannot hold, an unregistered core function or model
from .trainer import check_supported, config_mesh  # noqa: F401


class Evaluator:
    """Score checkpoints of a FAMIPose model on a dataset.

    Args:
      cfg: a merged config (``fami_pose_torch.config``).
      phase: ``"validate"`` (reads ``cfg.VAL``) or ``"test"`` (``cfg.TEST``).
      output_dirs: ``{"checkpoints": dir, "results": dir}``; defaults under
        ``cfg.OUTPUT_DIR``.
      dataset: an eval dataset; None builds ``DATASET.NAME``'s class from the
        registry for ``phase``.
      from_checkpoint_id: >= 0 evaluates every checkpoint from that epoch on.
      device: where the model, the batches and the decode live (this
        rank's device).
    """

    def __init__(self, cfg, phase=VAL_PHASE, output_dirs=None, dataset=None,
                 from_checkpoint_id=-1, device="cuda"):
        check_supported(cfg)
        self.mesh = config_mesh(cfg)
        self.cfg = cfg
        self.phase = phase
        self.device = torch.device(device)
        self.logger = logging.getLogger(__name__)
        dirs = output_dirs or {}
        self.checkpoints_dir = dirs.get(
            "checkpoints", osp.join(cfg.OUTPUT_DIR or ".", "checkpoints")
        )
        self.output_dir = dirs.get("results", cfg.OUTPUT_DIR or ".")
        self.from_checkpoint_id = int(from_checkpoint_id)
        self.sub = cfg.VAL if phase == VAL_PHASE else cfg.TEST
        # POST_PROCESS selects the DARK (blur + log + Taylor) decode
        self._decode = (dark_get_final_preds if bool(self.sub.POST_PROCESS)
                        else get_final_preds)

        if dataset is None:
            dataset = DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, phase)
        self.dataset = dataset
        if self.mesh.sharded and getattr(dataset, "data", None) is None:
            raise ValueError(
                "an eval dataset over several ranks needs an index (`data`: "
                "center, scale, score and image of every sample) for the "
                "global rows of each batch")
        self.loader = build_eval_loader(
            cfg, dataset, phase=phase, mesh=self.mesh)
        self.model = build_model(cfg, phase).to(self.device).eval()
        flip_key = "FLIP_VAL" if phase == VAL_PHASE else "FLIP_TEST"
        self._flip_test = bool(getattr(self.sub, flip_key, False)
                               or self.sub.FLIP)
        self._flip_pairs = getattr(dataset, "flip_pairs", None)
        self.core_function = build_core_function(cfg)
        self.eval_step = self.core_function.build_eval_step(
            self.model, flip_pairs=self._flip_pairs, flip_test=self._flip_test,
            mesh=self.mesh,
        )
        # seconds of the last eval loop, by part (the loader's wait, the
        # forward with its input preparation, the decode)
        self.timings = {}

    def list_model_files(self):
        """Explicit MODEL_FILE > all checkpoints >= an id > latest."""
        if self.sub.MODEL_FILE:
            return [self.sub.MODEL_FILE]
        if self.from_checkpoint_id >= 0:
            return checkpoints.get_all_checkpoints(
                self.checkpoints_dir, min_epoch=self.from_checkpoint_id
            )
        latest = checkpoints.get_latest_checkpoint(self.checkpoints_dir)
        return [latest] if latest else []

    def load_variables(self, path):
        """The model's ``state_dict`` of a checkpoint, on the CPU."""
        return checkpoints.load_variables(path)

    def _prepare(self, raw):
        """Raw loader batch -> (kf, sup) inputs on the device."""
        if "crop_center" in raw:  # TPU.DEVICE_CROP: raw person windows
            def dev(a, dtype=None):
                return torch.as_tensor(a).to(self.device, dtype=dtype)

            return prepare_eval_inputs_device_crop(
                dev(raw["kf"]).permute(0, 3, 1, 2),
                dev(raw["sup"]).permute(0, 3, 1, 2),
                dev(raw["crop_center"], torch.float32),
                dev(raw["scale"], torch.float32),
                dev(raw["rotation"], torch.float32),
                image_size=(int(self.cfg.MODEL.IMAGE_SIZE[0]),
                            int(self.cfg.MODEL.IMAGE_SIZE[1])),
            )
        return prepare_eval_inputs(raw["kf"], raw["sup"], device=self.device)

    def _set_dcn_window(self, d):
        """Point the four DCN stages at window ``d`` (None: the exact,
        unclamped mode of the kernel). The window is an argument of the
        kernel's launch, so nothing is rebuilt."""
        for module in self.model.modules():
            if isinstance(module, DeformConv):
                module.max_offset = d

    @property
    def dcn_max_offset(self):
        return self.model.dcn_1.max_offset

    @torch.inference_mode()
    def _maybe_auto_window(self):
        """TPU.DCN_AUTO_WINDOW: calibrate the DCN window to the loaded
        checkpoint.

        The windowed DCN is exact for every offset the window covers, and a
        window below the trained offset distribution costs accuracy, so the
        window is a per-checkpoint quantity: measure the offset convolutions'
        outputs (before any clamp) on the first ``TPU.INT8_CALIB_BATCHES``
        eval batches and pick the smallest integer D whose exceeded fraction
        is <= ``TPU.DCN_AUTO_WINDOW_EPS`` (0 = strict cover). Distributions
        hotter than ``TPU.DCN_AUTO_WINDOW_MAX`` get the exact mode.

        Over several ranks each measures its own slices, and rank 0's choice
        is broadcast, so that every rank runs the same model.
        """
        tpu = self.cfg.TPU
        if not bool(getattr(tpu, "DCN_AUTO_WINDOW", False)):
            return
        n_batches = max(1, int(getattr(tpu, "INT8_CALIB_BATCHES", 2)))
        offs = []
        hooks = [
            getattr(self.model, f"dcn_offset_{i}").register_forward_hook(
                lambda _m, _in, out: offs.append(
                    out.detach().to(torch.float32).abs().flatten()))
            for i in range(1, 5)
        ]
        seen = 0
        try:
            for raw in self.loader:
                self.model(*self._prepare(raw))
                seen += 1
                if seen >= n_batches:
                    break
        finally:
            for h in hooks:
                h.remove()
        allo = (torch.cat(offs) if offs
                else torch.zeros(1, device=self.device))
        cap = int(getattr(tpu, "DCN_AUTO_WINDOW_MAX", 8))
        eps = float(getattr(tpu, "DCN_AUTO_WINDOW_EPS", 1e-3))
        d = None  # the exact unbounded mode (always correct)
        for cand in range(1, cap + 1):
            if float((allo > cand).to(torch.float32).mean()) <= eps:
                d = cand
                break
        if self.mesh.distributed:
            (d0,) = broadcast_tensors(
                [torch.tensor([-1.0 if d is None else d], device=self.device)])
            d = None if int(d0) < 0 else int(d0)
        p99 = float(np.percentile(allo.cpu().numpy(), 99))
        self.logger.info(
            f"DCN auto-window: |offset| max={float(allo.max()):.3f} "
            f"p99={p99:.3f} px over {seen} calibration "
            f"batches -> window D = {d if d else 'exact'} "
            f"(eps={eps:g}, cap={cap})"
        )
        if d != self.dcn_max_offset:
            self._set_dcn_window(d)

    @torch.inference_mode()
    def _maybe_calibrate_int8(self):
        """TPU.INT8_EVAL: calibrate the activation scales of the loaded
        checkpoint on the first ``TPU.INT8_CALIB_BATCHES`` eval batches
        (unflipped forwards, ``TPU.INT8_CALIB_MARGIN``). Over several ranks
        each calibrates on its own slices, and rank 0's scales are
        broadcast to every rank in one float32 bucket."""
        if self.model.backbone_quant != QUANT_INT8:
            return
        tpu = self.cfg.TPU
        n_batches = max(1, int(getattr(tpu, "INT8_CALIB_BATCHES", 2)))
        margin = float(getattr(tpu, "INT8_CALIB_MARGIN", 1.0))
        batches = []
        for raw in self.loader:
            batches.append(self._prepare(raw))
            if len(batches) >= n_batches:
                break
        self.logger.info(f"int8 PTQ calibration on {len(batches)} eval "
                         f"batches (margin {margin})")
        scales = calibrate(self.model, batches, margin=margin)
        if self.mesh.distributed:
            names = list(scales)
            set_quant_scales(self.model, dict(zip(names, broadcast_tensors(
                [scales[k] for k in names]))))
            self.logger.info(f"int8 PTQ scales broadcast from rank 0 to "
                             f"{self.mesh.size} ranks")

    @torch.inference_mode()
    def eval_checkpoint(self, variables):
        """Run the full eval loop on a model ``state_dict``; returns
        ``{"final": (name_value, mean), "backbone": (name_value, mean)}`` on
        rank 0 and ``{}`` on the other ranks of a mesh."""
        cfg = self.cfg
        # loading clears the int8 scales: each checkpoint is calibrated
        # afresh, and before the window, which is then measured on the int8
        # numerics
        self.model.load_state_dict(variables)
        self.model.to(self.device).eval()
        self._maybe_calibrate_int8()
        self._maybe_auto_window()
        n = len(self.dataset)
        num_joints = int(cfg.MODEL.NUM_JOINTS)
        all_preds = np.zeros((n, num_joints, 3), np.float32)
        all_preds_bb = np.zeros((n, num_joints, 3), np.float32)
        all_boxes = np.zeros((n, 6), np.float32)
        img_path_map = OrderedDict()
        idx = 0
        on_card = self.device.type == "cuda"

        def clock():
            if on_card:
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        spent = {"loader_s": 0.0, "forward_s": 0.0, "decode_s": 0.0}
        t0 = t_prev = clock()
        for raw in self.loader:
            t_loaded = clock()
            valid = int(raw.get("valid", raw["kf"].shape[0]))
            kf, sup = self._prepare(raw)
            final_hm, bb_hm = self.eval_step(kf, sup)
            t_forward = clock()
            if "global_meta" in raw:
                # this rank's rows of the global batch: decode them all (a
                # slice may be all padding), then gather every rank's
                preds, maxvals = self._decode(final_hm, raw["center"],
                                              raw["scale"])
                preds_bb, maxvals_bb = self._decode(bb_hm, raw["center"],
                                                    raw["scale"])
                rows = all_gather_rows(torch.cat(
                    [preds, maxvals, preds_bb, maxvals_bb], dim=-1),
                    self.mesh)[:valid]
                preds, maxvals, preds_bb, maxvals_bb = rows.split(
                    [2, 1, 2, 1], dim=-1)
                meta = raw["global_meta"]
                center = meta["center"][:valid]
                scale = meta["scale"][:valid]
                score = meta["score"][:valid]
                image_paths = meta["image_path"]
            else:
                center = raw["center"][:valid]
                scale = raw["scale"][:valid]
                score = raw["score"][:valid]
                image_paths = raw["image_path"]
                preds, maxvals = self._decode(final_hm[:valid], center, scale)
                preds_bb, maxvals_bb = self._decode(bb_hm[:valid], center,
                                                    scale)
            rows = slice(idx, idx + valid)
            all_preds[rows, :, :2] = preds.cpu().numpy()
            all_preds[rows, :, 2:3] = maxvals.cpu().numpy()
            all_preds_bb[rows, :, :2] = preds_bb.cpu().numpy()
            all_preds_bb[rows, :, 2:3] = maxvals_bb.cpu().numpy()
            all_boxes[rows, 0:2] = center
            all_boxes[rows, 2:4] = scale
            all_boxes[rows, 4] = np.prod(scale * 200, axis=1)
            all_boxes[rows, 5] = score
            for b in range(valid):
                img_path_map.setdefault(image_paths[b], []).append(idx + b)
            idx += valid
            t_decoded = clock()
            spent["loader_s"] += t_loaded - t_prev
            spent["forward_s"] += t_forward - t_loaded
            spent["decode_s"] += t_decoded - t_forward
            t_prev = t_decoded
        self.timings = dict(spent, samples=idx, batches=len(self.loader),
                            loop_s=t_prev - t0)
        self.logger.info(
            f"eval forward done: {idx} samples in {t_prev - t0:.1f}s"
        )
        self.all_preds, self.all_preds_bb = all_preds, all_preds_bb
        self.all_boxes, self.img_path_map = all_boxes, img_path_map
        if self.mesh.rank == 0 and (bool(cfg.DEBUG.VIS_SKELETON)
                                    or bool(cfg.DEBUG.VIS_BBOX)):
            self._vis_hook(all_preds, all_boxes, img_path_map)
        if self.mesh.rank != 0:
            # every rank holds the global predictions; scoring writes files
            # and runs the protocol once, on rank 0
            return {}

        results = {}
        for tag, preds in (("final", all_preds), ("backbone", all_preds_bb)):
            out_dir = osp.join(self.output_dir, f"{self.phase}_{tag}_json")
            name_value, mean = self.dataset.evaluate(
                cfg, preds, out_dir, all_boxes, img_path_map,
                eval_track=bool(getattr(self.sub, "EVAL_TRACK", False)),
            )
            self.logger.info(f"[{tag}] AP: {dict(name_value)}")
            results[tag] = (name_value, mean)
        return results

    def _vis_hook(self, all_preds, all_boxes, img_path_map, limit=50):
        """Skeleton / box overlays of the first ``limit`` predictions
        (reference ``vis_helper.draw_skeleton_in_origin_image`` +
        ``alignment_mi_function_term6_1.py:362-375``); a frame that cannot
        be read is skipped."""
        out_dir = osp.join(self.output_dir, f"{self.phase}_vis")
        n = 0
        for path, idxs in img_path_map.items():
            for i in idxs:
                bbox = None
                if bool(self.cfg.DEBUG.VIS_BBOX):
                    bbox = cs2box(all_boxes[i, 0:2], all_boxes[i, 2:4],
                                  pattern="xyxy")
                try:
                    draw_skeleton_in_origin_image(path, all_preds[i], out_dir,
                                                  bbox=bbox)
                except IOError:
                    continue
                n += 1
                if n >= limit:
                    self.logger.info(f"vis overlays -> {out_dir}")
                    return
        if n:
            self.logger.info(f"vis overlays -> {out_dir}")

    def eval(self):
        out = {}
        for path in self.list_model_files():
            self.logger.info(f"evaluating {path}")
            out[path] = self.eval_checkpoint(self.load_variables(path))
        return out
