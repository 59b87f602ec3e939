"""The port's copy of the poseval-equivalent protocol
(``fami_pose_torch/evaluation``, ``fami_pose_torch/data/keypoints.py``)
against ``fami_pose_tpu.evaluation`` on the same annolist directories:
perfect, noisy, missing-frame and tracking scenarios give identical AP and
MOTA tables; the writers, the keypoint re-orderings, the PCKh helper and the
PoseTrack18 id codec give identical outputs. Everything is numpy on the
host, so "identical" is exact equality (NaN equal to NaN)."""

import json
import os

import numpy as np
import pytest

import fami_pose_tpu.data.keypoints as jax_kp
import fami_pose_tpu.evaluation as jax_ev
import fami_pose_torch.data.keypoints as port_kp
import fami_pose_torch.evaluation as port_ev
from fami_pose_tpu.evaluation import convert as jax_convert
from fami_pose_tpu.evaluation import pckh as jax_pckh
from fami_pose_tpu.evaluation import poseval_data as jax_data
from fami_pose_tpu.evaluation import seq_ids as jax_seq
from fami_pose_torch.evaluation import convert as port_convert
from fami_pose_torch.evaluation import pckh as port_pckh
from fami_pose_torch.evaluation import poseval_data as port_data
from fami_pose_torch.evaluation import seq_ids as port_seq

N_VIDEOS, N_FRAMES, N_PEOPLE = 2, 5, 2


def _coco_pose(rs, cx, cy):
    xy = np.array([cx, cy]) + rs.uniform(-40, 40, size=(17, 2))
    return np.concatenate([xy, np.ones((17, 1))], axis=1)


def _gt_rect(pose17, track_id):
    pt15 = jax_kp.coco2posetrack_ord_infer(pose17)
    pts = [{"id": [j], "x": [float(x)], "y": [float(y)]}
           for j, (x, y, _) in enumerate(pt15)]
    x0, y0 = pose17[:, :2].min(0)
    return {"x1": [float(x0)], "y1": [float(y0)], "x2": [float(x0) + 25.0],
            "y2": [float(y0) + 25.0], "track_id": [track_id], "score": [1.0],
            "annopoints": [{"point": pts}]}


def _scenario(root, kind, seed=0):
    """Write GT annolists and the prediction inputs of one scenario.
    Returns (gt_dir, preds_by_frame, frames_by_video)."""
    rs = np.random.RandomState(seed)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir)
    preds_by_frame, frames_by_video = {}, {}
    for v in range(N_VIDEOS):
        video = f"video_{v:04d}"
        frames = [f"images/{video}/{i:08d}.jpg" for i in range(1, N_FRAMES + 1)]
        frames_by_video[video] = frames
        annolist = []
        centers = rs.uniform(100, 500, size=(N_PEOPLE, 2))
        for fi, fp in enumerate(frames):
            rects, poses, tracks, boxes = [], [], [], []
            for p in range(N_PEOPLE):
                pose = _coco_pose(rs, *(centers[p] + 6.0 * fi))
                rects.append(_gt_rect(pose, p))
                pred = pose.copy()
                if kind in ("noisy", "tracking_noisy"):
                    pred[:, :2] += rs.uniform(-12, 12, size=(17, 2))
                    pred[:, 2] = rs.uniform(0.1, 1.0, size=17)
                arr = np.zeros((4, 17))
                arr[0], arr[1], arr[2], arr[3] = (pred[:, 0], pred[:, 1],
                                                  pred[:, 2], pred[:, 2])
                poses.append(arr)
                # a track switch in the noisy tracking scenario
                swap = kind == "tracking_noisy" and fi == 2
                tracks.append((N_PEOPLE - 1 - p) if swap else p)
                boxes.append(np.array([[0, 0, 0, 0, 0, rs.uniform(0.5, 1)]]))
            annolist.append({"image": [{"name": fp}], "annorect": rects})
            if kind == "missing" and fi % 2 == 1:
                continue  # no prediction for this frame: the writer fills it
            preds_by_frame[fp] = {"poses": poses, "tracks": tracks,
                                  "boxes": boxes}
        with open(os.path.join(gt_dir, f"{video}.json"), "w") as f:
            json.dump({"annolist": annolist}, f)
    return gt_dir, preds_by_frame, frames_by_video


def _assert_same(a, b, path="result"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), path
    else:
        assert a == b, path


@pytest.mark.parametrize("kind,eval_track", [
    ("perfect", False), ("noisy", False), ("missing", False),
    ("perfect", True), ("tracking_noisy", True),
])
def test_ap_and_mota_tables_identical(tmp_path, kind, eval_track):
    gt_dir, preds, frames = _scenario(str(tmp_path), kind)
    out = {}
    for name, ev in (("jax", jax_ev), ("port", port_ev)):
        pred_dir = str(tmp_path / f"pred_{name}")
        written = ev.write_video_annolists(preds, frames, pred_dir)
        assert len(written) == N_VIDEOS
        out[name] = ev.evaluate(gt_dir, pred_dir, eval_pose=True,
                                eval_track=eval_track)
    _assert_same(out["port"], out["jax"])
    table = out["port"]["ap_table"]
    assert list(table) == ["Head", "Shou", "Elb", "Wri", "Hip", "Knee",
                           "Ankl", "Mean"]
    if kind == "perfect":
        assert table["Mean"] == pytest.approx(100.0)
        if eval_track:
            assert out["port"]["mota_table"]["Mean"] == pytest.approx(100.0)
    elif kind == "missing":
        assert 0.0 < table["Mean"] < 100.0
    elif kind == "tracking_noisy":
        assert out["port"]["mota_table"]["Mean"] < 100.0
    # the written annolist files are the same bytes
    for video in frames:
        a = open(tmp_path / "pred_jax" / f"{video}.json").read()
        b = open(tmp_path / "pred_port" / f"{video}.json").read()
        assert a == b


def test_evaluate_ap_files_and_loaders_identical(tmp_path):
    gt_dir, preds, frames = _scenario(str(tmp_path), "noisy", seed=3)
    pred_dir = str(tmp_path / "pred")
    port_ev.write_video_annolists(preds, frames, pred_dir)
    _assert_same(port_ev.evaluate_ap_files(gt_dir, pred_dir),
                 jax_ev.evaluate_ap_files(gt_dir, pred_dir))
    _assert_same(port_data.video2filenames(gt_dir),
                 jax_data.video2filenames(gt_dir))
    gt_p, pr_p = port_data.load_data_dir(gt_dir, pred_dir)
    gt_j, pr_j = jax_data.load_data_dir(gt_dir, pred_dir)
    _assert_same(gt_p, gt_j)
    _assert_same(pr_p, pr_j)
    _assert_same(port_pckh.evaluate_pckh(gt_p, pr_p),
                 jax_pckh.evaluate_pckh(gt_j, pr_j))
    assert (port_data.JOINT_NAMES, port_data.N_JOINTS) == (
        jax_data.JOINT_NAMES, jax_data.N_JOINTS)


def test_annorect_struct_and_dummy_identical():
    rs = np.random.RandomState(1)
    pose = np.zeros((4, 17))
    pose[:2] = rs.uniform(0, 300, size=(2, 17))
    pose[2:] = rs.uniform(0, 1, size=17)
    boxes = [np.array([[0, 0, 0, 0, 0, 0.7]])]
    _assert_same(port_ev.convert_data_to_annorect_struct([pose], [4], boxes),
                 jax_ev.convert_data_to_annorect_struct([pose], [4], boxes))
    dummy = port_ev.convert_data_to_annorect_struct([], [], [])
    _assert_same(dummy, jax_ev.convert_data_to_annorect_struct([], [], []))
    assert dummy[0]["annopoints"][0]["point"][0]["score"] == [-100.0]


def test_keypoint_tables_and_reorderings_identical():
    for name in ("COCO_JOINTS", "COCO_FLIP_PAIRS", "COCO_UPPER_BODY_IDS",
                 "COCO_LOWER_BODY_IDS", "POSETRACK_JOINTS", "JHMDB_JOINTS"):
        assert getattr(port_kp, name) == getattr(jax_kp, name), name
    for name in ("COCO_JOINTS_WEIGHT", "COCO_OKS_SIGMAS"):
        np.testing.assert_array_equal(getattr(port_kp, name),
                                      getattr(jax_kp, name))
    rs = np.random.RandomState(2)
    pose = rs.uniform(0, 200, size=(17, 3))
    for fn in ("coco2posetrack_ord_infer", "coco2jhmdb_ord_infer"):
        for fmt in (False, True):
            _assert_same(
                getattr(port_kp, fn)(pose, 0.8, output_posetrack_format=fmt),
                getattr(jax_kp, fn)(pose, 0.8, output_posetrack_format=fmt))
    _assert_same(port_kp.coco2posetrack_ord(pose.T, 0.6),
                 jax_kp.coco2posetrack_ord(pose.T, 0.6))


def test_posetrack18_id_codec_and_converter_identical(tmp_path):
    for image_id in (10001220000, 10234560017, 20000010099):
        try:
            want = jax_seq.posetrack18_id2fname(image_id)
        except Exception as e:  # unknown sequence: the same error type
            with pytest.raises(type(e)):
                port_seq.posetrack18_id2fname(image_id)
            continue
        assert port_seq.posetrack18_id2fname(image_id) == want
        assert port_seq.posetrack18_fname2id(*want) == \
            jax_seq.posetrack18_fname2id(*want)
    for idx in (0, 1, 2):
        try:
            want = jax_seq.idx2seqtype(idx)
        except Exception as e:
            with pytest.raises(type(e)):
                port_seq.idx2seqtype(idx)
            continue
        assert port_seq.idx2seqtype(idx) == want
    # old (annolist) -> new (COCO-style) conversion of one sequence, and back
    point = lambda pid, x, y, sc: {
        "id": [pid], "x": [x], "y": [y], "score": [sc], "is_visible": [1]}
    person = {"track_id": [7], "x1": [10.0], "x2": [30.0], "y1": [5.0],
              "y2": [25.0], "score": [0.9],
              "annopoints": [{"point": [point(0, 100.0, 200.0, 0.5),
                                        point(13, 110.0, 120.0, 0.8),
                                        point(14, 112.0, 100.0, 0.7)]}]}
    old = {"annolist": [
        {"image": [{"name": "images/val/000043_mpii_train/000000.jpg"}],
         "annorect": [person],
         "ignore_regions": [{"point": [{"x": [1], "y": [2]},
                                       {"x": [3], "y": [4]},
                                       {"x": [5], "y": [6]}]}]},
        {"image": [{"name": "images/val/000043_mpii_train/000001.jpg"}],
         "annorect": []},
    ]}
    src = tmp_path / "old"
    src.mkdir()
    with open(src / "000043_mpii_train.json", "w") as f:
        json.dump(old, f)
    outs = {}
    for name, conv in (("jax", jax_convert), ("port", port_convert)):
        new_dir = str(tmp_path / f"new_{name}")
        back_dir = str(tmp_path / f"back_{name}")
        files = conv.convert_dir(str(src), new_dir)
        files += conv.convert_dir(new_dir, back_dir)
        outs[name] = [(os.path.basename(p), open(p).read()) for p in files]
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2
    assert port_convert.PT18_NAMES_COCO_ORDER == jax_convert.PT18_NAMES_COCO_ORDER
    assert port_convert.PT_CANONICAL_NAMES == jax_convert.PT_CANONICAL_NAMES
