"""The port's dataset classes (``fami_pose_torch/data``: ``PoseTrackDataset``,
``JHMDBDataset``, the COCO-json reader, the eval loader) and the host
helpers they use against the JAX package's on ``make_posetrack_fixture``.

Both sides run numpy and cv2 on the host, so sample arrays are compared
bitwise and metadata for equality; augmentation draws come from
``np.random`` / ``random``, seeded the same way before each sample on both
sides. ``prepare_eval_inputs`` (normalization on the device) is held to
1e-6 (one float32 division and subtraction in another order).
"""

import json
import os
import os.path as osp
import random
from collections import OrderedDict

import numpy as np
import pytest
import torch

from fami_pose_tpu.data import loader as jax_loader
from fami_pose_tpu.data.jhmdb import JHMDBDataset as JaxJHMDB
from fami_pose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrack
from fami_pose_tpu.data import posetrack as jax_pt
from fami_pose_tpu.data.video_dataset import (
    normalize_image_uint8 as jax_normalize_u8,
)
from fami_pose_tpu.ops import affine as jax_affine
from fami_pose_tpu.ops import pose as jax_pose
from fami_pose_tpu.utils import bbox as jax_bbox
from fami_pose_torch.data import loader as port_loader
from fami_pose_torch.data import posetrack as port_pt
from fami_pose_torch.data.jhmdb import JHMDBDataset
from fami_pose_torch.data.posetrack import PoseTrackDataset
from fami_pose_torch.data.video_dataset import normalize_image_uint8
from fami_pose_torch.ops import affine as port_affine
from fami_pose_torch.ops import pose as port_pose
from fami_pose_torch.utils import bbox as port_bbox
from fami_pose_torch.utils.registry import DATASET_REGISTRY
from fixtures import make_cfg, make_posetrack_fixture
from test_end_to_end import _write_gt_annolists
from torch_port_helpers import make_port_cfg


@pytest.fixture(scope="module", params=[False, True], ids=["pt17", "pt18"])
def fixture(request, tmp_path_factory):
    """(root, img_dir, posetrack18) of a 2-video, 5-frame, 2-person fixture."""
    root = str(tmp_path_factory.mktemp("pt18" if request.param else "pt17"))
    _, img_dir = make_posetrack_fixture(root, posetrack18=request.param)
    return root, img_dir, request.param


def _cfgs(fixture, **kw):
    root, img_dir, pt18 = fixture
    jdir = osp.join(root, "json")
    return (make_cfg(jdir, img_dir, posetrack18=pt18, **kw),
            make_port_cfg(jdir, img_dir, posetrack18=pt18, **kw))


def _assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray) or isinstance(r, np.generic):
            assert g.dtype == r.dtype and g.shape == r.shape, k
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert g == r, k


def _sample(ds, i, seed):
    np.random.seed(seed)
    random.seed(seed)
    return ds[i]


def _assert_index_equal(got, ref):
    assert len(got.data) == len(ref.data)
    for a, b in zip(got.data, ref.data):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert ({v: dict(f) for v, f in got.video_image_index.items()}
            == {v: dict(f) for v, f in ref.video_image_index.items()})


def test_registered():
    for name in ("PoseTrack", "JHMDB", "Jhmdb"):
        assert name in DATASET_REGISTRY
    assert DATASET_REGISTRY.get("PoseTrack") is PoseTrackDataset


@pytest.mark.parametrize("phase", ["train", "validate", "test"])
def test_index_and_samples_match(fixture, phase):
    """GT-box index and every sample: eval phases as they are, the train
    phase with scale, rotation and flip augmentation from seeded draws."""
    jcfg, pcfg = _cfgs(fixture)
    for cfg in (jcfg, pcfg):
        cfg.TEST.USE_GT_BBOX = True
    ref, got = JaxPoseTrack(jcfg, phase), PoseTrackDataset(pcfg, phase)
    assert len(got) == len(ref) == 20
    _assert_index_equal(got, ref)
    assert got.flip_pairs == ref.flip_pairs
    np.testing.assert_array_equal(got.joints_weight, ref.joints_weight)
    rotated = flipped = 0
    for i in range(len(ref)):
        r, g = _sample(ref, i, 100 + i), _sample(got, i, 100 + i)
        _assert_samples_equal(g, r)
        rotated += float(r["rotation"]) != 0.0
        flipped += bool(r["center"][0] != ref.data[i]["center"][0])
    if phase == "train":
        assert rotated > 3 and flipped > 3  # the draws did reach both branches
    else:
        assert rotated == 0 and flipped == 0


def test_half_body_and_single_ref_frame_draws_match(fixture):
    jcfg, pcfg = _cfgs(fixture)
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.PROB_HALF_BODY = 1.0
        cfg.TRAIN.NUM_JOINTS_HALF_BODY = 8
        cfg.DATASET.INPUT_TYPE = "single_ref_frame"
        cfg.DATASET.RANDOM_AUX_FRAME = True
    ref, got = JaxPoseTrack(jcfg, "train"), PoseTrackDataset(pcfg, "train")
    changed = 0
    for i in range(0, len(ref), 3):
        r, g = _sample(ref, i, 7 + i), _sample(got, i, 7 + i)
        _assert_samples_equal(g, r)
        # the flip leaves the centre's y alone; a half-body crop moves it
        changed += abs(float(r["center"][1] - ref.data[i]["center"][1])) > 1e-3
    assert changed > 0  # the half-body crop replaced some boxes


def test_single_frame_input_type_matches(fixture):
    jcfg, pcfg = _cfgs(fixture, distance=2)
    for cfg in (jcfg, pcfg):
        cfg.DATASET.INPUT_TYPE = "single_frame"
    ref, got = JaxPoseTrack(jcfg, "validate"), PoseTrackDataset(pcfg, "validate")
    g = got[4]
    _assert_samples_equal(g, ref[4])
    np.testing.assert_array_equal(g["sup"][..., :3], g["kf"])


def test_detection_boxes_match(fixture):
    root, img_dir, pt18 = fixture
    fill, start = (6, 0) if pt18 else (8, 1)
    dets = []
    for f in range(start, start + 5):
        name = f"video_0000/{str(f).zfill(fill)}.jpg"
        common = dict(image_name=name, nframes=5, frame_id=f)
        dets += [dict(common, category_id=1, score=0.9,
                      bbox=[40.0, 30.0, 60.0, 80.0]),
                 dict(common, category_id=1, score=0.05,
                      bbox=[10.0, 10.0, 30.0, 40.0]),
                 dict(common, category_id=2, score=0.95,
                      bbox=[1.0, 1.0, 20.0, 20.0])]
    det_path = osp.join(root, "dets.json")
    with open(det_path, "w") as fh:
        json.dump(dets, fh)
    jcfg, pcfg = _cfgs(fixture)
    for cfg in (jcfg, pcfg):
        cfg.VAL.USE_GT_BBOX = False
        cfg.VAL.COCO_BBOX_FILE = det_path
        cfg.VAL.IMAGE_THRE = 0.2
    ref, got = JaxPoseTrack(jcfg, "validate"), PoseTrackDataset(pcfg, "validate")
    assert len(got) == len(ref) == 5
    _assert_index_equal(got, ref)
    for i in range(5):
        _assert_samples_equal(got[i], ref[i])
    assert float(got[0]["score"]) == pytest.approx(0.9)


@pytest.mark.parametrize("phase", ["train", "validate"])
def test_device_crop_windows_match(fixture, phase):
    """TPU.DEVICE_CROP: raw person-centered windows and ``crop_center``."""
    jcfg, pcfg = _cfgs(fixture)
    for cfg in (jcfg, pcfg):
        cfg.TPU.DEVICE_CROP = True
        cfg.TPU.DEVICE_CROP_CANVAS = [160, 192]
    ref, got = JaxPoseTrack(jcfg, phase), PoseTrackDataset(pcfg, phase)
    for i in (0, 7, 19):
        r, g = _sample(ref, i, 3 + i), _sample(got, i, 3 + i)
        assert g["kf"].shape == (160, 192, 3) and "crop_center" in g
        _assert_samples_equal(g, r)
    img = np.arange(96 * 128 * 3, dtype=np.uint8).reshape(96, 128, 3)
    for center in ([5.0, 90.0], [64.0, 48.0], [300.0, -40.0]):
        a, oa = got._extract_window(img, np.asarray(center))
        b, ob = ref._extract_window(img, np.asarray(center))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(oa, ob)


@pytest.mark.parametrize("is_pt18", [False, True])
def test_window_logic_matches(is_pt18):
    for n in (1, 3, 7):
        for dist in (2, 3, 4):
            for cur in range(0 if is_pt18 else 1, n + (0 if is_pt18 else 1)):
                assert (port_pt.support_frame_deltas(cur, n, dist, is_pt18)
                        == jax_pt.support_frame_deltas(cur, n, dist, is_pt18))
    fill = 6 if is_pt18 else 8
    path = f"/d/video/{'3'.zfill(fill)}.jpg"
    assert (port_pt.support_frame_paths(path, 5, 3)
            == jax_pt.support_frame_paths(path, 5, 3))


def _gt_predictions(ds):
    preds = np.zeros((len(ds), ds.num_joints, 3), np.float32)
    boxes = np.zeros((len(ds), 6), np.float32)
    img_path_map = OrderedDict()
    for i, item in enumerate(ds.data):
        preds[i, :, :2] = item["joints_3d"][:, :2]
        preds[i, :, 2] = 0.9
        boxes[i, 0:2], boxes[i, 2:4] = item["center"], item["scale"]
        boxes[i, 4] = np.prod(item["scale"] * 200)
        boxes[i, 5] = 1.0
        img_path_map.setdefault(item["image"], []).append(i)
    return preds, boxes, img_path_map


@pytest.mark.parametrize("eval_track", [False, True])
def test_evaluate_gt_as_predictions_gives_100(fixture, tmp_path, eval_track):
    """The fixture's GT keypoints, fed as predictions, meet the GT annolist
    of their video (8-digit names from 1 for PoseTrack17, 6 digits from 0
    for PoseTrack18) and score Mean 100 on both sides, with equal tables
    and the same annolist files."""
    root, img_dir, _ = fixture
    jcfg, pcfg = _cfgs(fixture)
    annot_dir = _write_gt_annolists(root, img_dir, jcfg)
    tables = {}
    for name, cfg, cls in (("jax", jcfg, JaxPoseTrack),
                           ("port", pcfg, PoseTrackDataset)):
        cfg.VAL.ANNOT_DIR = annot_dir
        ds = cls(cfg, "validate")
        preds, boxes, img_path_map = _gt_predictions(ds)
        out_dir = str(tmp_path / name)
        tables[name] = ds.evaluate(cfg, preds, out_dir, boxes, img_path_map,
                                   eval_track=eval_track)
        assert sorted(os.listdir(out_dir)) == ["video_0000.json",
                                               "video_0001.json"]
    assert tables["port"] == tables["jax"]
    name_value, mean = tables["port"]
    assert mean == pytest.approx(100.0)
    assert list(name_value)[:8] == ["Head", "Shoulder", "Elbow", "Wrist",
                                    "Hip", "Knee", "Ankle", "Mean"]
    if eval_track:
        assert name_value["MOTA_Mean"] == pytest.approx(100.0)
    for video in ("video_0000.json", "video_0001.json"):
        assert (open(tmp_path / "jax" / video).read()
                == open(tmp_path / "port" / video).read())


def test_evaluate_missing_frames_get_dummies(fixture, tmp_path):
    root, img_dir, _ = fixture
    jcfg, pcfg = _cfgs(fixture)
    annot_dir = _write_gt_annolists(root, img_dir, jcfg)
    tables = {}
    for name, cfg, cls in (("jax", jcfg, JaxPoseTrack),
                           ("port", pcfg, PoseTrackDataset)):
        cfg.VAL.ANNOT_DIR = annot_dir
        ds = cls(cfg, "validate")
        preds, boxes, img_path_map = _gt_predictions(ds)
        keep = OrderedDict(list(img_path_map.items())[::2])  # every other frame
        tables[name] = ds.evaluate(cfg, preds, str(tmp_path / name), boxes,
                                   keep)
    assert tables["port"] == tables["jax"]
    assert 0.0 < tables["port"][1] < 100.0
    with open(tmp_path / "port" / "video_0000.json") as fh:
        written = json.load(fh)["annolist"]
    assert len(written) == 5
    dummies = [fr for fr in written if fr["annorect"][0]["annopoints"][0]
               ["point"][0].get("score") == [-100.0]]
    assert len(dummies) == 2


@pytest.fixture()
def jhmdb_cfgs(tmp_path):
    root = str(tmp_path)
    _, img_dir = make_posetrack_fixture(root, n_videos=1, n_frames=4,
                                        people_per_frame=1)
    jdir = osp.join(root, "json")
    for split in ("train", "val"):
        with open(osp.join(jdir, f"posetrack_{split}.json")) as f:
            data = json.load(f)
        for ann in data["annotations"]:
            ann["keypoints"] = ann["keypoints"][:15 * 3]
        with open(osp.join(jdir, f"jhmdb_{split}.json"), "w") as f:
            json.dump(data, f)
    cfgs = (make_cfg(jdir, img_dir, distance=2),
            make_port_cfg(jdir, img_dir, distance=2))
    for cfg in cfgs:
        cfg.DATASET.NAME = "JHMDB"
        cfg.MODEL.NUM_JOINTS = 15
    return cfgs


@pytest.mark.parametrize("phase", ["train", "validate"])
def test_jhmdb_samples_match(jhmdb_cfgs, phase):
    jcfg, pcfg = jhmdb_cfgs
    ref, got = JaxJHMDB(jcfg, phase), JHMDBDataset(pcfg, phase)
    assert len(got) == len(ref) == 4
    _assert_index_equal(got, ref)
    assert got.flip_pairs == ref.flip_pairs
    assert got.upper_body_ids == ref.upper_body_ids
    for i in range(4):
        r, g = _sample(ref, i, 50 + i), _sample(got, i, 50 + i)
        assert g["joints"].shape == (15, 2) and g["sup"].shape[-1] == 6
        _assert_samples_equal(g, r)


def test_jhmdb_evaluate_gt_gives_100(jhmdb_cfgs):
    tables = {}
    for name, cfg, cls in zip(("jax", "port"), jhmdb_cfgs,
                              (JaxJHMDB, JHMDBDataset)):
        ds = cls(cfg, "validate")
        preds, boxes, img_path_map = _gt_predictions(ds)
        tables[name] = ds.evaluate(cfg, preds, ".", boxes, img_path_map)
        far = np.full_like(preds, 1e4)
        assert ds.evaluate(cfg, far, ".", boxes, img_path_map)[1] == 0.0
    assert tables["port"] == tables["jax"]
    assert tables["port"][1] == pytest.approx(100.0)
    assert set(tables["port"][0]) == {"Head", "Shoulder", "Elbow", "Wrist",
                                      "Hip", "Knee", "Ankle", "Mean"}


def test_eval_loader_and_prepare_eval_inputs_match(fixture):
    """The padded eval loader gives the JAX loader's batches (20 samples in
    batches of 8: two full ones and a padded one of 4), and the device-side
    normalization agrees with the JAX one to 1e-6."""
    jcfg, pcfg = _cfgs(fixture)
    for cfg in (jcfg, pcfg):
        cfg.VAL.BATCH_SIZE_PER_GPU = 8
        cfg.WORKERS = 2
    ref = jax_loader.build_eval_loader(jcfg, JaxPoseTrack(jcfg, "validate"),
                                       num_devices=1)
    got = port_loader.build_eval_loader(pcfg, PoseTrackDataset(pcfg, "validate"))
    batches_ref, batches = list(ref), list(got)
    assert len(got) == len(ref) == len(batches) == 3
    assert [b["valid"] for b in batches] == [8, 8, 4]
    for g, r in zip(batches, batches_ref):
        assert g["image_path"] == r["image_path"] and g["valid"] == r["valid"]
        for k in ("kf", "sup", "joints", "joints_vis", "center", "scale",
                  "rotation", "score"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    raw = batches[-1]
    kf, sup = port_loader.prepare_eval_inputs(raw["kf"], raw["sup"])
    kf_ref, sup_ref = jax_loader.prepare_eval_inputs(raw["kf"], raw["sup"])
    assert kf.dtype == torch.float32 and tuple(kf.shape) == (8, 3, 128, 96)
    np.testing.assert_allclose(kf.permute(0, 2, 3, 1).numpy(),
                               np.asarray(kf_ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sup.permute(0, 2, 3, 1).numpy(),
                               np.asarray(sup_ref), atol=1e-6, rtol=0)


def test_host_helpers_match():
    rs = np.random.RandomState(0)
    joints = rs.uniform(0, 90, size=(17, 3)).astype(np.float32)
    vis = (rs.rand(17, 1) > 0.3).astype(np.float32).repeat(3, 1)
    for pairs in (None, jax_pt.POSETRACK_FLIP_PAIRS):
        a = port_pose.fliplr_joints(joints, vis, 96, pairs)
        b = jax_pose.fliplr_joints(joints, vis, 96, pairs)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for seed in range(6):
        np.random.seed(seed)
        a = port_pose.half_body_transform(joints, vis, 17)
        np.random.seed(seed)
        b = jax_pose.half_body_transform(joints, vis, 17)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    few = np.zeros_like(vis)
    few[0] = 1
    assert port_pose.half_body_transform(joints, few, 17) == (None, None)
    trans = port_affine.dark_get_affine_transform(
        np.array([50.0, 40.0]), np.array([0.6, 0.8]), 15.0, (96, 128))
    ref_trans = jax_affine.dark_get_affine_transform(
        np.array([50.0, 40.0]), np.array([0.6, 0.8]), 15.0, (96, 128))
    np.testing.assert_allclose(trans, ref_trans, atol=1e-5)
    np.testing.assert_array_equal(
        port_affine.exec_affine_transform(joints[3, :2], ref_trans),
        jax_affine.exec_affine_transform(joints[3, :2], ref_trans))
    c, s = np.array([70.0, 60.0]), np.array([0.5, 0.9])
    for pattern in ("xywh", "xyxy"):
        assert (port_bbox.cs2box(c, s, pattern=pattern)
                == jax_bbox.cs2box(c, s, pattern=pattern))
    img = rs.randint(0, 256, size=(8, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(normalize_image_uint8(img),
                                  jax_normalize_u8(img))
