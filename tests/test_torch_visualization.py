"""The port's visualisation (``fami_pose_torch/visualization/``), the
evaluator's overlays (``DEBUG.VIS_SKELETON`` / ``DEBUG.VIS_BBOX``) and
``demo --vis`` against the JAX package's numpy functions on the same
inputs, made from a seed.

Tolerance: none. Image arrays and the files written are equal bit for bit:
the drawing is the same numpy + cv2 code, and the debug dumps are the same
float32 numpy arithmetic on the NCHW -> NHWC transpose of the port's
tensors. The evaluator test is port-only (a tiny model, no JAX compile);
its overlays are held against the JAX evaluator's hook
(``fami_pose_tpu.engine.evaluator.Evaluator._vis_hook``, numpy only) run
on the port's predictions.
"""

import json
import logging
import os
import os.path as osp
import types

import cv2
import numpy as np
import pytest
import torch

from fami_pose_tpu.engine.evaluator import Evaluator as JaxEvaluator
from fami_pose_tpu.visualization import debug as jax_debug
from fami_pose_tpu.visualization import draw as jax_draw
from fami_pose_torch.engine.evaluator import Evaluator
from fami_pose_torch.models.bridge import init_weights
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.parallel.mesh import Mesh
from fami_pose_torch.visualization import debug, draw
from fixtures import make_cfg, make_posetrack_fixture
from test_end_to_end import _write_gt_annolists
from torch_port_helpers import make_port_cfg, tiny_model_cfg


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tree(root):
    """{relative path: file bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = osp.join(d, n)
            with open(p, "rb") as f:
                out[osp.relpath(p, root)] = f.read()
    return out


# -- draw -----------------------------------------------------------------------

@pytest.mark.parametrize("with_vis", [False, True])
def test_draw_skeleton_and_bbox_match_jax(with_vis):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, size=(60, 80, 3)).astype(np.uint8)
    joints = rs.rand(17, 2).astype(np.float32) * [80, 60]
    vis = (rs.rand(17) > 0.3).astype(np.float32) if with_vis else None
    got = draw.draw_skeleton(img, joints, vis)
    ref = jax_draw.draw_skeleton(img, joints, vis)
    assert np.array_equal(got, ref) and not np.array_equal(got, img)
    box = [5.5, 7.2, 50.9, 44.0]
    assert np.array_equal(draw.draw_bbox(got, box), jax_draw.draw_bbox(ref, box))


def test_draw_in_origin_image_matches_jax(tmp_path):
    rs = np.random.RandomState(1)
    src = tmp_path / "frames" / "video_a"
    src.mkdir(parents=True)
    path = str(src / "000003.jpg")
    cv2.imwrite(path, rs.randint(0, 256, size=(48, 64, 3)).astype(np.uint8))
    preds = np.concatenate([rs.rand(17, 2) * [64, 48], rs.rand(17, 1)],
                           axis=1).astype(np.float32)
    for sub, mod in (("port", draw), ("jax", jax_draw)):
        out = mod.draw_skeleton_in_origin_image(
            path, preds, str(tmp_path / sub), bbox=[3, 4, 40, 30],
            vis_thre=0.4)
        assert out == str(tmp_path / sub / "video_a" / "000003.jpg")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    with pytest.raises(IOError, match="Fail to read"):
        draw.draw_skeleton_in_origin_image(str(tmp_path / "no.jpg"), preds,
                                           str(tmp_path / "port"))


# -- debug dumps ------------------------------------------------------------------

def _nhwc(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))


@pytest.mark.parametrize("highlight,per_channel,cap", [
    (True, False, None), (True, True, 3), (False, False, 2)])
def test_save_featuremaps_matches_jax(tmp_path, highlight, per_channel, cap):
    """The port's (N, C, H, W) tensor against JAX's (N, H, W, C) array:
    the same count and the same jpg files, byte for byte."""
    gen = torch.Generator().manual_seed(2)
    fm = torch.randn(2, 5, 8, 6, generator=gen) * 40
    kw = dict(highlight=highlight, per_channel=per_channel, file_prefix="f",
              file_postfix="p", max_channels=cap)
    n = debug.save_featuremaps(fm, str(tmp_path / "port"), **kw)
    ref = jax_debug.save_featuremaps(_nhwc(fm), str(tmp_path / "jax"), **kw)
    assert n == ref == 2 * (cap or 5)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    with pytest.raises(ValueError, match="expected"):
        debug.save_featuremaps(fm[0], str(tmp_path))


def test_gradient_images_match_jax():
    """(C, H, W) gradients, as float32, bfloat16 tensors and numpy: the
    element-wise maps in the port's layout equal JAX's transposed; the gray
    image equals JAX's."""
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(3, 9, 7, generator=gen)
    for x in (g, g.to(torch.bfloat16), g.numpy()):
        ref_in = np.ascontiguousarray(
            torch.as_tensor(x).float().numpy().transpose(1, 2, 0))
        color = debug.gradient_color_image(x)
        assert color.shape == (3, 9, 7) and color.dtype == np.uint8
        assert np.array_equal(color.transpose(1, 2, 0),
                              jax_debug.gradient_color_image(ref_in))
        assert np.array_equal(debug.gradient_gray_image(x),
                              jax_debug.gradient_gray_image(ref_in))
        for got, ref in zip(debug.positive_negative_saliency(x),
                            jax_debug.positive_negative_saliency(ref_in)):
            assert np.array_equal(got.transpose(1, 2, 0), ref)


@pytest.mark.parametrize("n,c,nrow", [(5, 3, 3), (4, 1, 4), (1, 3, 2)])
def test_grids_match_jax(tmp_path, n, c, nrow):
    gen = torch.Generator().manual_seed(4)
    imgs = torch.rand(n, c, 16, 12, generator=gen)
    assert np.array_equal(debug.make_grid(imgs, nrow, 8),
                          jax_debug.make_grid(_nhwc(imgs), nrow, 8))
    joints = torch.rand(n, 4, 2, generator=gen) * 12
    vis = (torch.rand(n, 4, 1, generator=gen) > 0.3).float()
    for v in (vis, None):
        got = debug.save_batch_image_with_joints(
            imgs, joints, v, str(tmp_path / "port" / "g.jpg"), nrow=nrow)
        ref = jax_debug.save_batch_image_with_joints(
            _nhwc(imgs), joints.numpy(), None if v is None else v.numpy(),
            str(tmp_path / "jax" / "g.jpg"), nrow=nrow)
        assert np.array_equal(got, ref) and got.shape[-1] == 3
        assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_denormalize_matches_jax():
    gen = torch.Generator().manual_seed(5)
    img = torch.randn(3, 6, 5, generator=gen)
    ref = jax_debug.denormalize_image(img.numpy().transpose(1, 2, 0))
    assert np.array_equal(debug.denormalize_image(img), ref)
    m, s = [0.5, 0.4, 0.3], [0.2, 0.2, 0.3]
    assert np.array_equal(
        debug.denormalize_image(img.numpy(), m, s),
        jax_debug.denormalize_image(img.numpy().transpose(1, 2, 0), m, s))


# -- the evaluator's overlays -------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vis_eval"))
    _, img_dir = make_posetrack_fixture(root, n_videos=2, n_frames=3,
                                        people_per_frame=2)
    annot_dir = _write_gt_annolists(
        root, img_dir, make_cfg(osp.join(root, "json"), img_dir))
    return dict(root=root, img_dir=img_dir, annot_dir=annot_dir)


def _port_cfg(world, out, skeleton=True, bbox=True):
    cfg = tiny_model_cfg(make_port_cfg(osp.join(world["root"], "json"),
                                       world["img_dir"]),
                         osp.join(world["root"], out))
    cfg.VAL.ANNOT_DIR = world["annot_dir"]
    cfg.DEBUG.VIS_SKELETON = skeleton
    cfg.DEBUG.VIS_BBOX = bbox
    return cfg


def _seeded_state(cfg):
    model = FAMIPose.from_config(cfg)
    return init_weights(model, seed=0).state_dict()


def _jax_hook(ev, out_dir, limit=50):
    """The JAX evaluator's hook on the port evaluator's predictions."""
    host = types.SimpleNamespace(output_dir=out_dir, phase=ev.phase,
                                 cfg=ev.cfg, logger=logging.getLogger("jax"))
    JaxEvaluator._vis_hook(host, ev.all_preds, ev.all_boxes, ev.img_path_map,
                           limit=limit)


@pytest.mark.parametrize("bbox", [False, True], ids=["skeleton", "bbox"])
def test_evaluator_overlays_match_the_jax_hook(world, bbox):
    """``--val`` with ``DEBUG.VIS_SKELETON`` (and ``VIS_BBOX``): an overlay
    drawn for each of the 12 predictions (under 50) under
    ``<output>/validate_vis``, one file a frame (the 2 people of a frame
    are drawn onto its file in turn, the last one standing, as JAX's hook
    does), each the file JAX's hook writes from the same predictions, byte
    for byte; the AP tables are still scored."""
    cfg = _port_cfg(world, f"out_vis_{bbox}", bbox=bbox)
    ev = Evaluator(cfg, device="cpu")
    results = ev.eval_checkpoint(_seeded_state(cfg))
    assert set(results) == {"final", "backbone"}
    got = _tree(osp.join(ev.output_dir, "validate_vis"))
    assert len(ev.all_preds) == 12
    assert len(got) == len(ev.img_path_map) == 6
    ref_dir = osp.join(world["root"], f"jax_vis_{bbox}")
    _jax_hook(ev, ref_dir)
    assert got == _tree(osp.join(ref_dir, "validate_vis"))
    for rel, data in got.items():
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is not None, rel


def test_overlays_stop_at_fifty_and_skip_unreadable_frames(world, tmp_path):
    """The hook draws at most 50 overlays, skips a frame it cannot read
    (the JAX hook's ``IOError``), and writes the files the JAX hook
    writes."""
    cfg = _port_cfg(world, "out_vis_limit")
    ev = Evaluator(cfg, device="cpu")
    frame = ev.dataset.data[0]["image"]
    os.makedirs(tmp_path / "v")
    path_map = {str(tmp_path / "v" / "missing.jpg"): [0]}
    for i in range(1, 60):
        path = str(tmp_path / "v" / f"{i:03d}.jpg")
        os.link(frame, path)
        path_map[path] = [i]
    rs = np.random.RandomState(6)
    ev.all_preds = np.concatenate(
        [rs.rand(60, 17, 2) * 100, rs.rand(60, 17, 1)], axis=2).astype(
            np.float32)
    ev.all_boxes = np.zeros((60, 6), np.float32)
    ev.all_boxes[:, 0:2], ev.all_boxes[:, 2:4] = [120, 90], [0.5, 0.6]
    ev.img_path_map = path_map
    ev.output_dir = str(tmp_path / "port")
    ev._vis_hook(ev.all_preds, ev.all_boxes, path_map)
    out_dir = osp.join(ev.output_dir, "validate_vis")
    assert sorted(_tree(out_dir)) == [osp.join("v", f"{i:03d}.jpg")
                                      for i in range(1, 51)]
    _jax_hook(ev, str(tmp_path / "jax"))
    assert _tree(out_dir) == _tree(tmp_path / "jax" / "validate_vis")


def test_only_rank_zero_draws(world):
    """Over several ranks rank 0 alone draws (after the gather); another
    rank returns ``{}`` and writes nothing under ``<output>/validate_vis``."""
    cfg = _port_cfg(world, "out_vis_rank1")
    ev = Evaluator(cfg, device="cpu")
    ev.mesh = Mesh(data=1, model=2, rank=1)
    assert ev.eval_checkpoint(_seeded_state(cfg)) == {}
    assert not osp.exists(osp.join(ev.output_dir, "validate_vis"))
    assert ev.all_preds.shape == (12, 17, 3)


# -- demo --vis -------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True], ids=["batch", "streaming"])
def test_demo_vis_draws_each_pose(tmp_path, streaming):
    """``python -m fami_pose_torch.demo --vis --device cpu`` (batch and
    ``--streaming``): one overlay per emitted pose under ``<out>/vis``, each
    the image JAX's ``draw_skeleton_in_origin_image`` draws from the
    record's keypoints."""
    from fami_pose_torch.demo import main

    rs = np.random.RandomState(7)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    n = 3
    for i in range(n):
        cv2.imwrite(str(frames_dir / f"{i:04d}.png"),
                    rs.randint(0, 256, size=(40, 52, 3)).astype(np.uint8))
    out = tmp_path / "out"
    main(["--cfg", "configs/posetrack17/fami_pose.yaml", "--frames",
          str(frames_dir), "--out", str(out), "--device", "cpu", "--vis"]
         + (["--streaming"] if streaming else [])
         + ["MODEL.IMAGE_SIZE", "[32,32]", "MODEL.HEATMAP_SIZE", "[8,8]"])
    records = json.loads((out / "keypoints.json").read_text())
    assert len(records) == n
    got = _tree(out / "vis")
    assert sorted(got) == [osp.join("frames", r["frame"]) for r in records]
    for r in records:
        jax_draw.draw_skeleton_in_origin_image(
            str(frames_dir / r["frame"]),
            np.asarray(r["keypoints"], np.float32), str(tmp_path / "ref"))
    assert got == _tree(tmp_path / "ref")
