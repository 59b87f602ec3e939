"""Metric logging: a JSONL file always, TensorBoard when it imports
(``fami_pose_tpu/engine/metrics_writer.py``).

Every scalar goes to ``metrics.jsonl`` in the log directory as one record
``{"tag", "value", "step", "time"}``, and to ``torch.utils.tensorboard``'s
``SummaryWriter`` when that imports (it needs the ``tensorboard`` package).
"""

import json
import os
import os.path as osp
import time


class MetricWriter:
    def __init__(self, log_dir, use_tensorboard=True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = osp.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:
                self._tb = None

    def add_scalar(self, tag, value, step):
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
