"""ctypes bindings for the native NMS library (``native/nms.cpp`` beside
this file), the port of ``fami_pose_tpu/native/nms.py``.

The library is compiled from the port's own copy of the C++ source with
``g++ -O3 -fPIC -shared -std=c++17`` at first use, into ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the source and the
flags. It is never taken prebuilt: a library built with ``-march=native`` on
another host may stop the process with an illegal instruction, which no
``try`` catches. A failed build raises ``RuntimeError`` with the compiler's
output; there is no silent numpy fallback (the numpy versions,
``fami_pose_torch.ops.nms``, stay callable by name).
"""

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from fami_pose_torch.data.keypoints import COCO_OKS_SIGMAS

HERE = osp.dirname(osp.abspath(__file__))
SOURCE = osp.join(HERE, "nms.cpp")
BUILD_DIR = osp.join(HERE, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libfami_nms_{h.hexdigest()[:16]}.so")


def build():
    """Compile the library if it is not built yet; returns its path. Raises
    ``RuntimeError`` naming the compiler's error."""
    so_path = library_path()
    if osp.exists(so_path):
        return so_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native NMS: no C++ compiler (g++ not on PATH, "
                           "CXX unset); the library is built from source")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp")
    try:
        tmp_so = osp.join(tmp, "lib.so")
        try:
            run = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_so, SOURCE],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native NMS: {cxx} did not run: {e}") from e
        if run.returncode != 0:
            raise RuntimeError(f"native NMS: {cxx} failed on {SOURCE}:\n"
                               f"{run.stdout}")
        os.replace(tmp_so, so_path)  # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.fami_cpu_nms.restype = ctypes.c_int
        lib.fami_cpu_nms.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_float, i32p,
        ]
        lib.fami_oks_nms.restype = ctypes.c_int
        lib.fami_oks_nms.argtypes = [
            f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            f32p, ctypes.c_float, i32p,
        ]
        lib.fami_soft_oks_nms.restype = ctypes.c_int
        lib.fami_soft_oks_nms.argtypes = [
            f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            f32p, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            i32p, f32p,
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def cpu_nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy box NMS; ``dets`` is (N, 5) [x1, y1, x2, y2, score]."""
    dets = np.ascontiguousarray(dets, np.float32)
    n = len(dets)
    if n == 0:
        return []
    lib = _load()
    boxes = np.ascontiguousarray(dets[:, :4], np.float32)
    scores = np.ascontiguousarray(dets[:, 4], np.float32)
    keep = np.zeros(n, np.int32)
    cnt = lib.fami_cpu_nms(boxes, scores, n, float(thresh), keep)
    return keep[:cnt].tolist()


def _default_sigmas(nj: int) -> np.ndarray:
    if nj == len(COCO_OKS_SIGMAS):
        return np.asarray(COCO_OKS_SIGMAS, np.float32)
    return np.full(nj, 0.05, np.float32)


def _pose_arrays(kpts_db, sigmas):
    nj = np.asarray(kpts_db[0]["keypoints"]).shape[0]
    kpts = np.ascontiguousarray(
        np.stack([np.asarray(d["keypoints"], np.float32) for d in kpts_db])
    )
    scores = np.ascontiguousarray(
        [float(d["score"]) for d in kpts_db], np.float32
    )
    areas = np.ascontiguousarray([float(d["area"]) for d in kpts_db],
                                 np.float32)
    sig = np.ascontiguousarray(
        sigmas if sigmas is not None else _default_sigmas(nj), np.float32
    )
    return nj, kpts, scores, areas, sig


def oks_nms_native(kpts_db, thresh, sigmas=None, in_vis_thre=None) -> list:
    """Greedy OKS NMS over a list of dicts with 'keypoints' (J, 3), 'score',
    'area' (reference ``nms.py:59-92`` contract)."""
    n = len(kpts_db)
    if n == 0:
        return []
    lib = _load()
    nj, kpts, scores, areas, sig = _pose_arrays(kpts_db, sigmas)
    keep = np.zeros(n, np.int32)
    cnt = lib.fami_oks_nms(
        kpts, scores, areas, n, nj, float(thresh), sig,
        float(in_vis_thre or 0.0), keep,
    )
    return keep[:cnt].tolist()


def soft_oks_nms_native(
    kpts_db, thresh, sigmas=None, in_vis_thre=None, method: int = 2,
    soft_sigma: float = 0.5, max_dets: int = 20,
):
    """Soft OKS NMS; returns (keep_indices, rescored_scores)."""
    n = len(kpts_db)
    if n == 0:
        return [], []
    lib = _load()
    nj, kpts, scores, areas, sig = _pose_arrays(kpts_db, sigmas)
    keep = np.zeros(n, np.int32)
    out_scores = np.zeros(n, np.float32)
    cnt = lib.fami_soft_oks_nms(
        kpts, scores, areas, n, nj, float(thresh), sig,
        float(in_vis_thre or 0.0), int(method), float(soft_sigma),
        int(max_dets), keep, out_scores,
    )
    return keep[:cnt].tolist(), out_scores[:cnt].tolist()
