"""Profiling hooks (``fami_pose_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block, and a host-side step timer.

Set ``TPU.PROFILE_DIR`` to trace the first ``TPU.PROFILE_STEPS`` train steps
of epoch 0 (``engine/trainer.py``), or call :func:`trace` directly.
"""

import contextlib
import logging
import os
import os.path as osp
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace,
    ``trace_<pid>_<ms>.json``, into ``log_dir``; nothing at all when
    ``log_dir`` is falsy. The card is synchronised before the trace stops,
    so that the block's kernels are in it."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir,
                    f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    logging.getLogger(__name__).info(f"profiler trace -> {path}")


class StepTimer:
    """Host-side step timing with an exponential moving average; cheap
    enough to run always."""

    def __init__(self, ema=0.9):
        self.ema = ema
        self.avg = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        return dt
