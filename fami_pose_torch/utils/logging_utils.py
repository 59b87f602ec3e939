"""Phase-scoped logging (reference surface: ``utils/utils_logger.py:16-40`` and
``engine/defaults/base.py:18-59``): a per-phase log file plus a console
handler; a copy of ``fami_pose_tpu/utils/logging_utils.py``.

``engine/runner.py`` keeps its own per-phase (and, over several processes,
per-rank) log files and does not call these."""

import logging
import os
import sys
import time


def create_folder(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def reset_logger(log_file: str | None = None, level=logging.INFO) -> logging.Logger:
    """Reset the root logger: console handler + optional file handler."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(level)

    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S"
    )
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(fmt)
    root.addHandler(console)

    if log_file:
        create_folder(os.path.dirname(log_file) or ".")
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def phase_log_file(log_dir: str, phase: str) -> str:
    stamp = time.strftime("%Y-%m-%d-%H-%M")
    return os.path.join(log_dir, f"{phase}-{stamp}.log")
