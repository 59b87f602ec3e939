"""Runner: experiment identity + phase dispatch
(``fami_pose_tpu/engine/runner.py``).

The output directory is derived from the config's content
(``OUTPUT_DIR/EXPERIMENT_NAME/<dataset-tag>/<model-hyperparameter-string>``),
the checkpoint, log and result subdirectories are created, and the requested
phases (train -> val -> test) run in order, each with its own timestamped
log file. ``args.device`` (default ``"cuda"``) says where they run; in a
process a launcher started, ``"cuda"`` is this rank's ``cuda:LOCAL_RANK``.
"""

import logging
import os
import os.path as osp
import time

from fami_pose_torch.models import get_model_hyperparameter
from fami_pose_torch.parallel.mesh import (
    local_device, process_count, process_index,
)
from fami_pose_torch.utils.registry import TEST_PHASE, VAL_PHASE


def dataset_tag(cfg):
    name = cfg.DATASET.NAME or "dataset"
    if name == "PoseTrack":
        name += "18" if cfg.DATASET.IS_POSETRACK18 else "17"
    return name


class Runner:
    def __init__(self, cfg, args=None):
        self.cfg = cfg
        self.args = args
        self.device = local_device(getattr(args, "device", None) or "cuda")
        self.logger = logging.getLogger(__name__)
        # the evaluator of the last val or test phase: its flat predictions
        # (``all_preds``, ``all_boxes``) and its loop's ``timings``
        self.evaluator = None
        self.setup_cfg()

    def setup_cfg(self):
        cfg = self.cfg
        hyper = get_model_hyperparameter(cfg)
        root = cfg.OUTPUT_DIR or "./output"
        exp = cfg.EXPERIMENT_NAME or cfg.MODEL.NAME
        out = osp.join(root, exp, dataset_tag(cfg))
        if hyper:
            out = osp.join(out, hyper)
        cfg.OUTPUT_DIR = out
        self.dirs = {
            "checkpoints": osp.join(out, "checkpoints"),
            "log": osp.join(out, "log"),
            "results": osp.join(out, "results"),
        }
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)

    def _phase_log_file(self, phase):
        """Attach a per-phase timestamped log file to the root logger (one a
        rank over several processes)."""
        name = f"{phase}-{time.strftime('%Y%m%d_%H%M%S')}"
        if process_count() > 1:
            name += f"-rank{process_index()}"
        path = osp.join(self.dirs["log"], name + ".log")
        handler = logging.FileHandler(path)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        logging.getLogger().addHandler(handler)
        return handler

    def _evaluate(self, phase, log_name, **kwargs):
        from fami_pose_torch.engine.evaluator import Evaluator

        handler = self._phase_log_file(log_name)
        try:
            self.evaluator = Evaluator(self.cfg, phase, output_dirs=self.dirs,
                                       device=self.device, **kwargs)
            return self.evaluator.eval()
        finally:
            logging.getLogger().removeHandler(handler)
            handler.close()

    def launch(self, train=False, val=False, test=False):
        results = {}
        if train:
            from fami_pose_torch.engine.trainer import Trainer

            handler = self._phase_log_file("train")
            try:
                trainer = Trainer(self.cfg, output_dirs=self.dirs,
                                  device=self.device)
                results["train"] = trainer.train()
            finally:
                logging.getLogger().removeHandler(handler)
                handler.close()
        if val:
            # 0 is a valid epoch id: only a missing value means "latest"
            from_id = getattr(self.args, "val_from_checkpoint", None)
            from_id = -1 if from_id is None else int(from_id)
            results["val"] = self._evaluate(
                VAL_PHASE, "validate", from_checkpoint_id=from_id)
        if test:
            results["test"] = self._evaluate(TEST_PHASE, "test")
        return results
