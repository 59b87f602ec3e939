"""NMS in the port (``fami_pose_torch/ops/nms.py``,
``fami_pose_torch/native/nms.py``) against the JAX package's
(``fami_pose_tpu.ops.nms``, ``fami_pose_tpu.native.nms``) on the same
seeded detections (``chip_smoke.nms_boxes`` / ``nms_poses``, which phase
``remainder`` also runs on the card): clustered boxes and poses, so that
suppression happens, with padded slots for the fixed-N device versions.

Tolerance: none for what is kept. Keep lists (host numpy, native) and keep
masks (device) are identical; the soft-NMS rescored scores of the native
library are float32 arithmetic of the same C++ source built without
``-march=native`` against a build with it, held to 1e-6 relative.
"""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nms_boxes, nms_poses
from fami_pose_tpu.native import nms as jax_native
from fami_pose_tpu.ops import nms as jax_nms
from fami_pose_torch.native import nms as native
from fami_pose_torch.ops import nms


_boxes, _poses = nms_boxes, nms_poses


# -- host (numpy) ------------------------------------------------------------------

@pytest.mark.parametrize("seed,thr", [(0, 0.3), (1, 0.6), (2, 0.9)])
def test_host_box_nms_matches_jax(seed, thr):
    dets = _boxes(seed)
    got = nms.nms(dets, thr)
    assert got == jax_nms.nms(dets, thr) and 0 < len(got) < len(dets)
    assert nms.nms(np.zeros((0, 5)), thr) == jax_nms.nms(np.zeros((0, 5)),
                                                         thr) == []


@pytest.mark.parametrize("vis_thr", [None, 0.3])
@pytest.mark.parametrize("seed,thr", [(0, 0.5), (3, 0.9)])
def test_host_oks_nms_matches_jax(seed, thr, vis_thr):
    db = _poses(seed)
    got = nms.oks_nms(db, thr, vis_thr=vis_thr)
    ref = jax_nms.oks_nms(db, thr, vis_thr=vis_thr)
    assert np.array_equal(got, ref) and 0 < len(got) < len(db)
    flat = np.stack([d["keypoints"].reshape(-1) for d in db])
    areas = np.array([d["area"] for d in db])
    for v in (None, vis_thr):
        assert np.array_equal(
            nms.oks_iou(flat[0], flat, areas[0], areas, vis_thr=v),
            jax_nms.oks_iou(flat[0], flat, areas[0], areas, vis_thr=v))


@pytest.mark.parametrize("seed,thr,max_dets", [(0, 0.3, 20), (4, 0.5, 7)])
def test_host_soft_oks_nms_matches_jax(seed, thr, max_dets):
    db = _poses(seed)
    got = nms.soft_oks_nms(db, thr, max_dets=max_dets)
    assert np.array_equal(got, jax_nms.soft_oks_nms(db, thr,
                                                    max_dets=max_dets))
    assert len(got) == max_dets
    assert nms.oks_nms([], 0.5) == nms.soft_oks_nms([], 0.5) == []


# -- device (torch on the CPU) against JAX's jitted scans ---------------------------

def _valid(n, pad, seed):
    valid = np.ones(n, bool)
    valid[np.random.RandomState(seed).choice(n, pad, replace=False)] = False
    return valid


@pytest.mark.parametrize("seed,thr,pad", [(0, 0.9, 0), (1, 0.5, 9),
                                          (2, 0.3, 63)])
def test_device_oks_nms_matches_jax(seed, thr, pad):
    """64 poses, ``pad`` of them invalid: the same keep mask as JAX's
    ``oks_nms_device``; with no padding, the mask of the host keep list."""
    db = _poses(seed)
    kpts = np.stack([d["keypoints"] for d in db])
    scores = np.array([d["score"] for d in db], np.float32)
    areas = np.array([d["area"] for d in db], np.float32)
    valid = _valid(len(db), pad, seed)
    got = nms.oks_nms_device(torch.from_numpy(kpts), torch.from_numpy(scores),
                             torch.from_numpy(areas), torch.from_numpy(valid),
                             thr=thr)
    ref = np.asarray(jax_nms.oks_nms_device(
        jnp.asarray(kpts), jnp.asarray(scores), jnp.asarray(areas),
        jnp.asarray(valid), thr=thr))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    assert not got.numpy()[~valid].any() and got.any()
    if pad == 0:
        host = np.zeros(len(db), bool)
        host[nms.oks_nms(db, thr)] = True
        assert np.array_equal(got.numpy(), host)


@pytest.mark.parametrize("seed,thr,pad", [(0, 0.6, 0), (5, 0.3, 40)])
def test_device_box_nms_matches_jax(seed, thr, pad):
    dets = _boxes(seed)
    valid = _valid(len(dets), pad, seed)
    got = nms.box_nms_device(torch.from_numpy(dets[:, :4]),
                             torch.from_numpy(dets[:, 4]),
                             torch.from_numpy(valid), thr=thr)
    ref = np.asarray(jax_nms.box_nms_device(
        jnp.asarray(dets[:, :4]), jnp.asarray(dets[:, 4]), jnp.asarray(valid),
        thr=thr))
    assert np.array_equal(got.numpy(), ref) and got.any()
    if pad == 0:
        host = np.zeros(len(dets), bool)
        host[nms.nms(dets, thr)] = True
        assert np.array_equal(got.numpy(), host)


def test_device_scan_reads_nothing_back(monkeypatch):
    """The greedy scan never synchronises with the host: it calls neither
    ``Tensor.item`` nor ``Tensor.__bool__`` (made to raise here)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the device scan")

    dets = _boxes(6, n=32)
    want = nms.box_nms_device(torch.from_numpy(dets[:, :4]),
                              torch.from_numpy(dets[:, 4]),
                              torch.ones(32, dtype=torch.bool))
    for name in ("item", "__bool__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = nms.box_nms_device(torch.from_numpy(dets[:, :4]),
                             torch.from_numpy(dets[:, 4]),
                             torch.ones(32, dtype=torch.bool))
    monkeypatch.undo()
    assert torch.equal(got, want)


# -- native -------------------------------------------------------------------------

def test_native_builds_from_the_port_source():
    """The library is compiled from the port's copy of ``nms.cpp`` into the
    port's git-ignored build directory, never the committed
    ``native/libfami_nms.so``."""
    assert native.is_available()
    assert osp.dirname(native.library_path()) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(osp.join("fami_pose_torch", "native",
                                              "_build"))
    assert osp.exists(native.build())
    assert "-march=native" not in native.CXX_FLAGS


@pytest.mark.parametrize("seed,thr", [(0, 0.3), (1, 0.7)])
def test_native_box_nms_matches_jax_and_numpy(seed, thr):
    dets = _boxes(seed)
    got = native.cpu_nms(dets, thr)
    assert got == jax_native.cpu_nms(dets, thr) == nms.nms(dets, thr)
    assert native.cpu_nms(np.zeros((0, 5)), thr) == []


@pytest.mark.parametrize("in_vis", [None, 0.3])
@pytest.mark.parametrize("seed,thr", [(0, 0.5), (3, 0.9)])
def test_native_oks_nms_matches_jax(seed, thr, in_vis):
    db = _poses(seed)
    got = native.oks_nms_native(db, thr, in_vis_thre=in_vis)
    assert got == jax_native.oks_nms_native(db, thr, in_vis_thre=in_vis)
    assert got == list(nms.oks_nms(db, thr, vis_thr=in_vis))


@pytest.mark.parametrize("method", [1, 2])
def test_native_soft_oks_nms_matches_jax(method):
    db = _poses(7)
    keep, scores = native.soft_oks_nms_native(db, 0.3, method=method,
                                              max_dets=12)
    ref_keep, ref_scores = jax_native.soft_oks_nms_native(
        db, 0.3, method=method, max_dets=12)
    assert keep == ref_keep and len(keep) == 12
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-6)
    if method == 2:  # gaussian rescoring: numpy's with thr = soft_sigma
        assert keep == list(nms.soft_oks_nms(db, 0.5, max_dets=12))
    assert native.soft_oks_nms_native([], 0.3) == ([], [])


def test_a_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """No numpy fallback: a source the compiler refuses raises
    ``RuntimeError`` with the compiler's message; ``is_available`` reports
    False; the numpy versions stay callable."""
    bad = tmp_path / "nms.cpp"
    bad.write_text("int fami_cpu_nms( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on .*nms.cpp:\n.*error"):
        native.cpu_nms(_boxes(0, n=8), 0.5)
    assert not native.is_available()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not run"):
        native.oks_nms_native(_poses(0, n=4), 0.5)
    assert len(nms.nms(_boxes(0, n=8), 0.5)) > 0
